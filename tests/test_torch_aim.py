"""AIM drift correction of the port (picasso_torch.aim) held against
picasso_tpu.aim on the CPU.

Tolerance: none. The intersection counts are integers, so the count
maps equal JAX's exactly; the phase peaks, the relative drift's sum and
the splines are the same numpy code on the same numbers, so the drifts
and the undrifted locs equal JAX's bit for bit, in f32 as JAX returns
them.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import aim as jaim
from picasso_torch import aim as taim

N_FRAMES, SIZE = 600, 64
INTERSECT_D, ROI_R = 20 / 130, 60 / 130


def _info(frames=N_FRAMES, size=SIZE):
    return [{"Frames": frames, "Width": size, "Height": size,
             "Pixelsize": 130}]


def _injected(frames):
    """+0.8 px linear in x, a 0.5 px sine in y, a 40 nm sine in z."""
    t = np.asarray(frames, np.float64) / (N_FRAMES - 1)
    return 0.8 * t, 0.5 * np.sin(2 * np.pi * t), 40 * np.sin(2 * np.pi * t)


def _locs(z: bool = False, seed: int = 0, skip=None) -> np.ndarray:
    """DNA-PAINT-like locs: 300 sites, ~5 locs a frame, 0.05 px
    precision, with the drift of :func:`_injected`; frames in ``skip``
    hold no locs."""
    rng = np.random.default_rng(seed)
    sites = rng.uniform(2, SIZE - 2, (300, 2))
    site_z = rng.uniform(-300, 300, 300)
    frame = np.repeat(np.arange(N_FRAMES), 5)
    if skip is not None:
        frame = frame[(frame < skip[0]) | (frame >= skip[1])]
    s = rng.integers(0, len(sites), len(frame))
    dx, dy, dz = _injected(frame)
    names = ["frame", "x", "y", "lpx", "lpy"] + (["z"] if z else [])
    locs = np.zeros(len(frame), [(n, np.uint32 if n == "frame" else
                                  np.float32) for n in names])
    locs["frame"] = frame
    locs["x"] = sites[s, 0] + dx + rng.normal(0, 0.05, len(frame))
    locs["y"] = sites[s, 1] + dy + rng.normal(0, 0.05, len(frame))
    locs["lpx"] = locs["lpy"] = 0.05
    if z:
        locs["z"] = site_z[s] + dz + rng.normal(0, 10, len(frame))
    return locs


@pytest.mark.parametrize("z", [False, True])
def test_aim_matches_jax_bit_for_bit(z):
    locs = _locs(z)
    lj, ij, dj = jaim.aim(pd.DataFrame.from_records(locs), _info(),
                          segmentation=50)
    lt, it, dt = taim.aim(locs, _info(), segmentation=50, device="cpu")
    rj = lj.to_records(index=False)
    assert lt.dtype == rj.dtype
    cols = ("x", "y", "z") if z else ("x", "y")
    assert dt.dtype.names == cols and len(dt) == N_FRAMES
    for c in cols:
        assert lt.dtype[c] == dt.dtype[c] == np.float32
        np.testing.assert_array_equal(dt[c], dj[c].to_numpy())
    for name in lt.dtype.names:
        np.testing.assert_array_equal(lt[name], rj[name])
    assert it == ij
    assert it[-1] == {"Generated by": "Picasso v0.1.0 AIM",
                      "Intersect distance (nm)": 20.0, "Segmentation": 50,
                      "Search regions radius (nm)": 60.0}
    # the drift is the injected one, up to its mean
    inj = dict(zip(("x", "y", "z"), _injected(np.arange(N_FRAMES))))
    for c, bound in (("x", 0.1), ("y", 0.1), ("z", 10.0)):
        if c in cols:
            r = dt[c] - inj[c]
            assert np.sqrt(np.mean((r - r.mean()) ** 2)) < bound


def test_empty_segment_repeats_the_drift_and_f64_locs_match_jax():
    """Frames 300-349 hold no locs, so a segment is empty; the locs are
    f64 as a drift correction leaves them."""
    locs = _locs(seed=1, skip=(300, 350))
    locs64 = locs.astype([(n, np.float64 if n in ("x", "y") else
                           locs.dtype[n]) for n in locs.dtype.names])
    lj, _, dj = jaim.aim(pd.DataFrame.from_records(locs64), _info(),
                         segmentation=50)
    lt, _, dt = taim.aim(locs64, _info(), segmentation=50, device="cpu")
    for c in ("x", "y"):
        np.testing.assert_array_equal(dt[c], dj[c].to_numpy())
        np.testing.assert_array_equal(lt[c], lj[c].to_numpy())
        assert lt[c].dtype == np.float32


def _grid(locs, stride):
    ux = np.round(locs["x"].astype(np.float64) / INTERSECT_D).astype(np.int64)
    uy = np.round(locs["y"].astype(np.float64) / INTERSECT_D).astype(np.int64)
    return np.unique(ux + uy * stride, return_counts=True)


def test_count_maps_and_aliases_match_jax():
    locs = _locs()
    width_units = SIZE / INTERSECT_D
    stride = jaim._grid_stride(width_units)
    assert taim._grid_stride(width_units) == stride
    assert taim._grid_stride(10.5) == jaim._grid_stride(10.5)
    ref, seg = locs[locs["frame"] < 50], locs[locs["frame"] >= 550]
    l0, c0 = _grid(ref, stride)
    steps = np.arange(-3, 4)
    shifts = (steps[:, None] + steps[None, :] * stride).reshape(-1)
    x1 = seg["x"].astype(np.float64) + 0.3
    y1 = seg["y"].astype(np.float64) - 0.2
    args = (l0, c0, x1, y1, INTERSECT_D, width_units, shifts, 7)
    want = jaim.point_intersect_2d(*args)
    np.testing.assert_array_equal(
        taim.point_intersect_2d(*args, device="cpu"), want)
    assert want.sum() > 0
    l1, c1 = _grid(seg, stride)
    np.testing.assert_array_equal(
        taim.run_intersections(l0, c0, l1, c1, shifts, 7, device="cpu"),
        jaim.run_intersections(l0, c0, l1, c1, shifts, 7))
    assert taim.run_intersections_multithread is taim.run_intersections
    assert (taim.count_intersections(l0, c0, l1, c1, device="cpu")
            == jaim.count_intersections(l0, c0, l1, c1))
    for a, b in zip(taim.intersect1d(l0, l1), jaim.intersect1d(l0, l1)):
        np.testing.assert_array_equal(a, b)
    z1 = np.linspace(-2.0, 2.0, len(x1))
    shifts_z = np.arange(-3, 4) * stride * stride
    args3 = (l0 + 3 * stride * stride, c0, x1, y1, z1, INTERSECT_D,
             width_units, width_units, shifts_z)
    np.testing.assert_array_equal(
        taim.point_intersect_3d(*args3, device="cpu"),
        jaim.point_intersect_3d(*args3))
    rng = np.random.default_rng(3)
    cc = rng.integers(0, 50, (7, 7))
    assert taim.get_fft_peak(cc, 2 * ROI_R) == jaim.get_fft_peak(cc, 2 * ROI_R)
    assert taim.get_fft_peak_z(cc[0], 1.0) == jaim.get_fft_peak_z(cc[0], 1.0)


def test_intersection_max_public_entry_points_match_jax():
    locs = _locs(z=True, seed=2)
    frame = locs["frame"].astype(np.int64) + 1
    bounds = np.concatenate((np.arange(0, N_FRAMES, 100), [N_FRAMES]))
    first = frame <= 100
    kw = dict(intersect_d=INTERSECT_D, roi_r=ROI_R, width=SIZE)
    for aim_round in (1, 2):
        j = jaim.intersection_max(locs["x"], locs["y"], locs["x"][first],
                                  locs["y"][first], frame, bounds,
                                  aim_round=aim_round, **kw)
        t = taim.intersection_max(locs["x"], locs["y"], locs["x"][first],
                                  locs["y"][first], frame, bounds,
                                  aim_round=aim_round, device="cpu", **kw)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    zkw = dict(kw, height=SIZE, pixelsize=130)
    x64, y64 = locs["x"].astype(np.float64), locs["y"].astype(np.float64)
    j = jaim.intersection_max_z(x64, y64, locs["z"], x64[first], y64[first],
                                locs["z"][first], frame, bounds, **zkw)
    t = taim.intersection_max_z(x64, y64, locs["z"], x64[first], y64[first],
                                locs["z"][first], frame, bounds,
                                device="cpu", **zkw)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_aim_raises_without_a_card():
    with pytest.raises(RuntimeError, match="cuda"):
        taim.aim(_locs(), _info(), segmentation=50)
    with pytest.raises(RuntimeError, match="cuda"):
        taim.run_intersections(np.zeros(1, np.int64), np.ones(1, np.int64),
                               np.zeros(1, np.int64), np.ones(1, np.int64),
                               np.zeros(1, np.int64), 1)
