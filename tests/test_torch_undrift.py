"""RCC drift correction of the port (picasso_torch.render,
imageprocess, lib.minimize_shifts, postprocess, io.save_drift and the
CLI's default ``-d 1000``) held against picasso_tpu on the CPU.

Tolerances, with the spread measured on the CPU (numpy 2, torch 2.13):
- histograms equal; Gaussian-blurred images within rtol 1e-5 + atol
  1e-6 (the splat sums its f32 windows in another order; measured max
  2.4e-7 absolute on peaks of ~1.9);
- correlations of f64 images within 1e-12 (measured 1.1e-14); of an
  f32 image, which numpy 2 transforms in complex64 and the port in f64,
  within rtol 1e-7 (measured 3.9e-9); minimize_shifts equal;
- image shifts within 1e-3 px: scipy's curve_fit stops on the broad
  correlation peak of noise images where a 1e-14 change of its input
  moves it (measured 1.0e-4 px on f64 images, 4.6e-4 px with an f32
  one);
- drifts within 1e-5 px (measured 3e-8 px on the 16-segment movie
  below), and both recover the injected drift to a residual RMS of
  0.1 px after removing the constant offset (measured 0.03 px).
"""

from __future__ import annotations

import os
import subprocess
import sys

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import imageprocess as jimage
from picasso_tpu import io as jio
from picasso_tpu import lib as jlib
from picasso_tpu import postprocess as jpost
from picasso_tpu import render as jrender
from picasso_torch import imageprocess as timage
from picasso_torch import io as tio
from picasso_torch import lib as tlib
from picasso_torch import localize as tloc
from picasso_torch import postprocess as tpost
from picasso_torch import render as trender
from torch_data import make_bench_movie

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
PARAMS = {"Min. Net Gradient": 4000, "Box Size": 7}
N_FRAMES, SIZE = 128, 64
XCORR_AGREE = 1e-12
XCORR_F32_RTOL = 1e-7
SHIFT_AGREE = 1e-3  # px
DRIFT_AGREE = 1e-5  # px
DRIFT_RESID = 0.1  # px


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _info(frames, size):
    return [{"Byte Order": "<", "Data Type": "uint16", "Frames": frames,
             "Height": size, "Width": size}]


def _injected(frames):
    """The drift added to the locs: +0.8 px linear in x, a 0.5 px sine
    in y."""
    f = np.asarray(frames, np.float64)
    return 0.8 * f / (N_FRAMES - 1), 0.5 * np.sin(2 * np.pi * f /
                                                  (N_FRAMES - 1))


@pytest.fixture(scope="module")
def drifted_locs():
    """Port-localized locs of a 128-frame 64x64 movie, with the drift
    of :func:`_injected` added."""
    movie = make_bench_movie(N_FRAMES, SIZE, 60, 0.5,
                             np.random.default_rng(5))
    locs = tloc.localize(movie, dict(CAMERA), PARAMS,
                         fitting_method="gaussmle", device="cpu")
    dx, dy = _injected(locs["frame"])
    locs["x"] += dx.astype(np.float32)
    locs["y"] += dy.astype(np.float32)
    assert len(locs) > 2000
    return locs


def _random_locs(n, size, seed):
    rng = np.random.default_rng(seed)
    locs = np.zeros(n, [("frame", np.uint32), ("x", np.float32),
                        ("y", np.float32), ("lpx", np.float32),
                        ("lpy", np.float32)])
    locs["frame"] = rng.integers(0, 100, n)
    locs["x"] = rng.uniform(-1, size + 1, n)
    locs["y"] = rng.uniform(-1, size + 1, n)
    locs["lpx"] = rng.uniform(0.02, 3.0, n)
    locs["lpy"] = rng.uniform(0.02, 3.0, n)
    return locs


@pytest.mark.parametrize("blur", [None, "gaussian"])
@pytest.mark.parametrize("oversampling,viewport",
                         [(1.0, None), (2.5, ((5, 3), (40, 50)))])
def test_render_matches_jax(blur, oversampling, viewport):
    locs = _random_locs(5000, 48, seed=3)
    info = _info(100, 48)
    kw = dict(oversampling=oversampling, viewport=viewport,
              blur_method=blur, min_blur_width=0.5)
    n_j, img_j = jrender.render(pd.DataFrame.from_records(locs), info, **kw)
    n_t, img_t = trender.render(locs, info, **kw, device="cpu")
    assert n_t == n_j and img_t.shape == img_j.shape
    assert img_t.dtype == np.float32
    if blur is None:
        np.testing.assert_array_equal(img_t, img_j)
    else:
        np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-6)


def test_render_unported_blur_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trender.render(_random_locs(10, 8, 0), _info(100, 8),
                       blur_method="smooth", device="cpu")


def test_xcorr_image_shift_and_minimize_shifts_match_jax():
    rng = np.random.default_rng(9)
    a = rng.random((40, 48))
    b = np.roll(a, (3, -2), axis=(0, 1)) + 0.1 * rng.random((40, 48))
    np.testing.assert_allclose(timage.xcorr(a, b), jimage.xcorr(a, b),
                               rtol=0, atol=XCORR_AGREE)
    # numpy 2 transforms an f32 image in complex64, the port in f64
    a32 = a.astype(np.float32)
    np.testing.assert_allclose(timage.xcorr(a32, b), jimage.xcorr(a32, b),
                               rtol=XCORR_F32_RTOL, atol=0)
    for roi in (None, 16):
        t = timage.get_image_shift(a, b, 5, roi)
        j = jimage.get_image_shift(a, b, 5, roi)
        np.testing.assert_allclose(t, j, rtol=0, atol=SHIFT_AGREE)
        assert abs(t[0] - 3) < 0.01 and abs(t[1] + 2) < 0.01
    assert timage.get_image_shift(np.zeros_like(a), b, 5) == (0, 0)
    sx, sy = rng.normal(size=(2, 6, 6))
    for t, j in zip(tlib.minimize_shifts(sx, sy),
                    jlib.minimize_shifts(sx, sy)):
        np.testing.assert_array_equal(t, j)


def test_segment_and_undrift_match_jax_and_recover_the_drift(drifted_locs):
    info = _info(N_FRAMES, SIZE)
    df = pd.DataFrame.from_records(drifted_locs)
    blur = {"blur_method": "gaussian", "min_blur_width": 1}
    b_t, s_t = tpost.segment(drifted_locs, info, 8, blur, device="cpu")
    b_j, s_j = jpost.segment(df, info, 8, blur, lambda i: None)
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-5, atol=1e-6)

    d_t, l_t = tpost.undrift(drifted_locs, info, 8, device="cpu")
    d_j, l_j = jpost.undrift(df, info, 8)
    assert d_t.dtype.names == ("x", "y") and len(d_t) == N_FRAMES
    inj_x, inj_y = _injected(np.arange(N_FRAMES))
    for c, inj in (("x", inj_x), ("y", inj_y)):
        np.testing.assert_allclose(d_t[c], d_j[c].to_numpy(), rtol=0,
                                   atol=DRIFT_AGREE)
        for got in (d_t[c], d_j[c].to_numpy()):
            r = got - inj
            assert np.sqrt(np.mean((r - r.mean()) ** 2)) < DRIFT_RESID
    rec = l_j.to_records(index=False)
    assert l_t.dtype == rec.dtype
    for c in ("x", "y"):
        np.testing.assert_allclose(l_t[c], rec[c], rtol=0, atol=DRIFT_AGREE)
    np.testing.assert_array_equal(l_t["photons"], rec["photons"])


def test_n_segments_needs_two():
    with pytest.raises(ValueError, match="at least 2"):
        tpost.n_segments(_info(1400, 8), 1000)
    assert tpost.n_segments(_info(1500, 8), 1000) == 2


def test_apply_drift_and_save_drift_byte_compatible(tmp_path):
    locs = _random_locs(300, 32, seed=4)
    rng = np.random.default_rng(1)
    drift = np.zeros(100, tpost.DRIFT_DTYPE)
    drift["x"], drift["y"] = rng.normal(size=(2, 100))
    drift_df = pd.DataFrame({"x": drift["x"], "y": drift["y"]})
    info = _info(100, 32)
    t = tpost.apply_drift(locs, info, drift=drift)
    j = jpost.apply_drift(pd.DataFrame.from_records(locs), info,
                          drift=drift_df).to_records(index=False)
    assert t.dtype == j.dtype
    for name in t.dtype.names:
        np.testing.assert_array_equal(t[name], j[name])
    t2 = tpost.apply_drift(locs, info, drift=np.column_stack(
        [drift["x"], drift["y"]]))
    np.testing.assert_array_equal(t2, t)
    tio.save_drift(str(tmp_path / "t.txt"), drift)
    jio.save_drift(str(tmp_path / "j.txt"), drift_df)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt"
                                                 ).read_bytes()
    assert b"\r\n" in (tmp_path / "t.txt").read_bytes()


def _run_cli(module, tmp_path, *extra):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", module, "localize", "x.raw", "-g", "4000",
         *extra], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _read(path):
    with h5py.File(path, "r") as f:
        return f["locs"][()]


def test_cli_default_drift_matches_the_jax_cli(tmp_path):
    """``localize x.raw`` with the default -d 1000 on a 1500-frame movie
    (two segments): _locs.hdf5, _locs_drift.txt and _locs_undrift.hdf5
    agree with the JAX CLI's."""
    movie = make_bench_movie(1500, 24, 4, 0.3, np.random.default_rng(2))
    for d in ("t", "j"):
        (tmp_path / d).mkdir()
        jio.save_raw(str(tmp_path / d / "x.raw"), movie,
                     _info(1500, 24))
    out = _run_cli("picasso_torch", tmp_path / "t", "--device", "cpu")
    assert "Undrifted" in out
    _run_cli("picasso_tpu", tmp_path / "j")
    t, j = tmp_path / "t", tmp_path / "j"
    lt, lj = _read(t / "x_locs.hdf5"), _read(j / "x_locs.hdf5")
    assert lt.dtype == lj.dtype and len(lt) == len(lj) > 1000
    dt = np.loadtxt(t / "x_locs_drift.txt")
    dj = np.loadtxt(j / "x_locs_drift.txt")
    assert dt.shape == dj.shape == (1500, 2)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=DRIFT_AGREE)
    ut, uj = _read(t / "x_locs_undrift.hdf5"), _read(j / "x_locs_undrift.hdf5")
    assert ut.dtype == uj.dtype and len(ut) == len(uj)
    order = lambda r: r[np.lexsort((r["x"], r["y"], r["frame"]))]  # noqa: E731
    ut, uj = order(ut), order(uj)
    np.testing.assert_array_equal(ut["frame"], uj["frame"])
    for c in ("x", "y"):
        np.testing.assert_allclose(ut[c], uj[c], rtol=0, atol=1e-3)
    info_t = tio.load_info(str(t / "x_locs_undrift.hdf5"))
    info_j = tio.load_info(str(j / "x_locs_undrift.hdf5"))
    assert info_t[-1] == info_j[-1] == {
        "Generated by": "Picasso Undrift RCC", "Segmentation": 1000}
