"""3D particle averaging of the port held against picasso_tpu.average3 on
the CPU: rotate_axis, the histogram stack, the group centring, the scan
window and angles, one rotation-scan pass around each axis, average3 end
to end with JAX's two gates (tests/test_average3.py), and
prepare_locs_for_save.

Inputs: tests/test_average3.py's dataset (14 groups of an L-shaped 3D
template at random turns about z, 60 locs each) and, for the pass
around every axis, the same dataset turned about x and y as well.

Tolerances:
- rotate_axis, _hist_stack, the centring, the window and the angles:
  equal (JAX's numpy code, the pandas means written out);
- a pass: each group's moved x, y, z equal to JAX's, except where the
  group's best and second-best correlation lie within
  torch_parity.AVERAGE3_TIE_REL of each other (compare_average3: the
  port's torch.fft and JAX's numpy FFT differ in their last bits);
  measured: no group differs;
- end to end: JAX's gates, and x, y, z equal to JAX's where no pass had
  a near tie (measured: none had).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import average3 as ja
from picasso_torch import average3 as ta
from test_average3 import INFO, _dataset, _group_spread
from torch_parity import AVERAGE3_TIE_REL, compare_average3

PIXELSIZE = 130


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _locs(seed=2, tilt=False) -> np.ndarray:
    """tests/test_average3.py's dataset as a structured array; with
    ``tilt`` each group also turned about x and y by up to 0.4 rad."""
    locs = np.asarray(_dataset(seed=seed).to_records(index=False))
    if tilt:
        rng = np.random.default_rng(seed + 10)
        for g in np.unique(locs["group"]):
            m = locs["group"] == g
            x, y, z = (locs[c][m].astype(np.float64) for c in "xyz")
            for axis in ("x", "y"):
                x, y, z = ta.rotate_axis(axis, x, y, z,
                                         rng.uniform(-0.4, 0.4), PIXELSIZE)
            locs["x"][m], locs["y"][m], locs["z"][m] = x, y, z
    return locs


def _df(locs):
    return pd.DataFrame.from_records(locs)


def _equal(got: np.ndarray, want: pd.DataFrame):
    want = want.to_records(index=False)
    assert got.dtype == want.dtype
    for n in got.dtype.names:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_rotate_axis_and_hist_stack_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.normal(0, 0.5, (2, 50)).astype(np.float32)
    z = rng.normal(0, 60, 50).astype(np.float32)
    angles = np.arange(0, 2 * np.pi, np.arcsin(np.float32(1 / 9.5)))
    for axis in ("x", "y", "z"):
        got = ta.rotate_axis(axis, x[None], y[None], z[None],
                             angles[:, None], PIXELSIZE)
        want = ja.rotate_axis(axis, x[None], y[None], z[None],
                              angles[:, None], PIXELSIZE)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        plane = ta.ROT_PLANES[axis]
        rows, cols = ta._plane_coords(got[0], got[1], got[2] / PIXELSIZE,
                                      plane)
        h = ta._hist_stack(rows, cols, 10.0, np.float32(-1.3),
                           np.float32(1.3))
        np.testing.assert_array_equal(h, ja._hist_stack(
            rows, cols, 10.0, np.float32(-1.3), np.float32(1.3)))
        assert h.dtype == np.float32 and h.sum() > 0
    with pytest.raises(ValueError):
        ta.rotate_axis("w", x, y, z, 0.1, PIXELSIZE)


def test_centring_window_and_angles_match_jax():
    locs = _locs()
    locs = locs[np.random.default_rng(1).permutation(len(locs))]
    got = ta._com_align3(locs)
    want = ja._com_align3(_df(locs))
    _equal(got, want)
    for over, rng_ in ((10.0, None), (8.0, 0.5)):
        t_min, t_max, angles = ta._workspace(got, PIXELSIZE, over, rng_)
        r = 2 * np.sqrt((want["x"] ** 2 + want["y"] ** 2
                         + (want["z"] / PIXELSIZE) ** 2).mean())
        assert t_max == r and t_min == -r and t_max.dtype == r.dtype
        a_step = np.arcsin(1 / (over * r))
        ref = (np.arange(0, 2 * np.pi, a_step) if rng_ is None
               else np.arange(-rng_, rng_, a_step))
        assert angles.dtype == ref.dtype == np.float64
        np.testing.assert_array_equal(angles, ref)


@pytest.mark.parametrize("axis", ["z", "x", "y"])
def test_one_pass_matches_jax(axis):
    """One pass around each axis from the same centred locs: groups whose
    x, y or z differ from JAX's must be near ties (compare_average3)."""
    locs = ta._com_align3(_locs(tilt=True))
    t_min, t_max, angles = ta._workspace(locs, PIXELSIZE, 10.0, None)
    _, rows = _rows(locs)
    picks = []
    got = ta._align_rotation_axis(locs, rows, axis, angles, 10.0, t_min,
                                  t_max, PIXELSIZE, "cpu", picks=picks)
    want = ja._align_rotation_axis(
        _df(locs), ja.build_group_index(_df(locs)), axis, angles, 10.0,
        t_min, t_max, PIXELSIZE).to_records(index=False)
    differ = np.array([any(not np.array_equal(got[c][r], want[c][r])
                           for c in "xyz") for r in rows])
    best, val, second = (np.concatenate(p) for p in zip(*picks))
    stats = compare_average3(differ, [(best, val, second)],
                             what=f"pass about {axis} vs JAX")
    print(f"pass about {axis}: {stats}")
    assert len(best) == len(rows) == 14
    assert (best < len(angles) * ta._n_pixel(10.0, t_min, t_max) ** 2).all()
    moved = [not np.array_equal(got[c], locs[c]) for c in "xyz"]
    assert moved == [axis != "x", axis != "y", axis != "z"]


def _rows(locs):
    from picasso_torch import lib

    return lib.group_rows(locs["group"])


def test_average3_passes_jaxs_gates_and_matches_jax():
    """tests/test_average3.py's recipe (2 iterations, oversampling 8,
    the z axis): the histogram entropy falls by more than 0.3 and the
    std of the groups' z means is below 10 nm; x, y, z equal to JAX's
    when no pass had a near tie. Then the defaults (3 iterations,
    oversampling 10, axes z, x, y) on the tilted dataset, with the
    walls a pass."""
    locs = _locs()
    calls = []
    out = ta.average3(locs, INFO, iterations=2, oversampling=8,
                      rot_axes=("z",), device="cpu",
                      progress_callback=lambda *a: calls.append(a))
    assert calls == [(1, 2), (2, 2)]
    assert _group_spread(_df(out)) < _group_spread(_df(locs)) - 0.3
    assert _df(out).groupby("group")["z"].mean().std() < 10.0
    want = ja.average3(_df(locs), INFO, iterations=2, oversampling=8,
                       rot_axes=("z",))
    _equal(out, want)
    tilted = _locs(seed=4, tilt=True)
    walls = []
    out = ta.average3(tilted, INFO, device="cpu", walls=walls)
    want = ja.average3(_df(tilted), INFO)
    _equal(out, want)
    assert [w["axis"] for w in walls] == ["z", "x", "y"] * 3
    assert all(w["total"] >= w["rotate_hist"] + w["fft"] for w in walls)


def test_prepare_locs_for_save_matches_jax():
    locs = _locs()
    info = [dict(INFO[0], Width=40, Height=30)]
    for params in (None, {"Iterations": 3}):
        got = ta.prepare_locs_for_save(locs, info, params)
        want = ja.prepare_locs_for_save(_df(locs), info, params)
        _equal(got[0], want[0])
        assert got[1] == want[1]


def test_average3_needs_groups_z_and_the_card():
    locs = _locs()
    no_z = np.asarray(_dataset().drop(columns=["z"]).to_records(index=False))
    with pytest.raises(AssertionError):
        ta.average3(no_z, INFO, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ta.average3(locs, INFO)


def test_near_ties_are_recorded_not_hidden():
    """compare_average3 passes a differing group only at a near tie."""
    val = np.array([10.0, 10.0, 10.0])
    second = np.array([10.0 - 5e-5, 9.0, 9.0])
    compare_average3([True, False, False], [(None, val, second)])
    with pytest.raises(AssertionError):
        compare_average3([False, True, False], [(None, val, second)])
    assert AVERAGE3_TIE_REL < 1e-4
