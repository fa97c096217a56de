"""Drift correction of the port held against picasso_tpu on the CPU:
RCC (picasso_torch.render, imageprocess, lib.minimize_shifts,
postprocess, io.save_drift and the CLI's default ``-d 1000``), drift
files (io.load_drift), apply_drift over many record layouts and every
drift form (byte for byte), picks and fiducials (postprocess.picked_locs,
undrift_from_picked, undrift_from_fiducials, imageprocess.find_fiducials,
localize.identify_in_image), and the CLI verbs ``undrift``, ``aim``,
``undrift_fiducials`` and ``render`` against the JAX CLI.

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
  0.1 px after removing the constant offset (measured 0.03 px);
- picks and fiducial drifts equal (numpy on the same numbers); the
  positions of identify_in_image equal and its net gradients within
  rtol 1e-5, as everywhere for identify (JAX's XLA program and K4 fuse
  multiply-adds, the plain version rounds each product); picks compare
  rows within a frame as sets (the port sorts stably, JAX with pandas'
  quicksort); the fiducials sit apart from other locs, since JAX's drift
  of a frame with two locs in a pick depends on that order;
- the PNGs of the render verb equal pixel for pixel, for every blur (the
  Gaussian splats differ from JAX's by a few f32 ulps, which no 8-bit
  level of these images straddles).
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
from picasso_tpu import localize as jloc
from picasso_tpu import postprocess as jpost
from picasso_tpu import render as jrender
from picasso_torch import imageprocess as timage
from picasso_torch import io as tio
from picasso_torch import lib as tlib
from picasso_torch import localize as tloc
from picasso_torch import postprocess as tpost
from picasso_torch import render as trender
from torch_data import make_bench_movie
from torch_native import loaded_native
from torch_records_data import DRIFT_FORMS, DTYPES
from torch_records_data import MLE as RECORDS_MLE
from torch_records_data import N_FRAMES as RECORDS_FRAMES
from torch_records_data import make_drift, make_locs, same_bytes

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


@pytest.fixture(scope="module", autouse=True)
def _native_loaded():
    """picasso_tpu.localize.get_spots (and fit2D, fit and localize through
    it) converts a C-contiguous u16 movie with one factor only while
    picasso_tpu.native is loaded, and in three roundings otherwise; the
    port mirrors the one-factor route. A test process that lost the
    native library's build race would hold the port to the other route:
    load the library first (torch_native.loaded_native)."""
    loaded_native()


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
    """Rotated views (ang=), the last part of render to be ported, no
    longer raise: a tilted gaussian view equals JAX's within the splat
    tolerance (tests/test_torch_render3d.py holds every blur)."""
    locs = _random_locs(2000, 48, seed=5)
    kw = dict(blur_method="gaussian", min_blur_width=0.05,
              ang=(0.1, 0.2, 0.0), oversampling=2.0)
    n_j, img_j = jrender.render(pd.DataFrame.from_records(locs),
                                _info(100, 48), **kw)
    n_t, img_t = trender.render(locs, _info(100, 48), **kw, device="cpu")
    assert n_t == n_j > 1000
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-6)


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
    t = tpost.apply_drift(locs, info, drift=drift, device="cpu")
    j = jpost.apply_drift(pd.DataFrame.from_records(locs), info,
                          drift=drift_df).to_records(index=False)
    assert t.dtype == j.dtype
    for name in t.dtype.names:
        np.testing.assert_array_equal(t[name], j[name])
    t2 = tpost.apply_drift(locs, info, drift=np.column_stack(
        [drift["x"], drift["y"]]), device="cpu")
    np.testing.assert_array_equal(t2, t)
    tio.save_drift(str(tmp_path / "t.txt"), drift)
    jio.save_drift(str(tmp_path / "j.txt"), drift_df)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt"
                                                 ).read_bytes()
    assert b"\r\n" in (tmp_path / "t.txt").read_bytes()


def _jax_apply_drift(locs, drift):
    """picasso_tpu's apply_drift of ``locs`` (a structured array) as a
    plain structured array: pandas' columns, the drift as a DataFrame
    or an (n, 2 or 3) array."""
    if drift.dtype.names is not None:
        drift = pd.DataFrame.from_records(drift)
    out = jpost.apply_drift(pd.DataFrame.from_records(locs), [{}],
                            drift=drift).to_records(index=False)
    return np.asarray(out, np.dtype(out.dtype.descr))


@pytest.mark.parametrize("form", DRIFT_FORMS)
@pytest.mark.parametrize("kind", list(DTYPES))
def test_apply_drift_matches_jax_on_every_record_layout(kind, form):
    """The plain version of the record rewrite (the CPU's apply_drift)
    against JAX's pandas columns byte for byte: the MLE, LQ and 3D
    dtypes, int64 frames, a padded and aligned dtype with y already f64,
    fields at odd and even offsets, × every drift form."""
    locs = make_locs(DTYPES[kind], 1000, seed=len(kind))
    drift = make_drift(form, seed=3)
    want = _jax_apply_drift(locs, drift)
    same_bytes(tpost.apply_drift(locs, [{}], drift=drift, device="cpu"),
               want)
    moved = {"x", "y"} | ({"z"} if form in ("rec3", "array3")
                          and "z" in locs.dtype.names else set())
    assert {n for n in want.dtype.names
            if want.dtype[n] == np.float64} >= moved


@pytest.mark.parametrize("case", ["non-contiguous", "negative-frames",
                                  "one", "empty"])
def test_apply_drift_matches_jax_on_odd_inputs(case):
    if case == "non-contiguous":
        locs = make_locs(RECORDS_MLE, 3000, seed=1)[::3]
        assert not locs.flags.c_contiguous
    elif case == "negative-frames":
        locs = make_locs(DTYPES["mle-int64-frame"], 1000, seed=2,
                         negative_frames=True)
        assert (locs["frame"] < 0).any()
    elif case == "one":
        locs = make_locs(DTYPES["packed-odd"], 1, seed=3)
    else:
        locs = make_locs(RECORDS_MLE, 0, seed=3)
    drift = make_drift("rec2", seed=4)
    same_bytes(tpost.apply_drift(locs, [{}], drift=drift, device="cpu"),
               _jax_apply_drift(locs, drift))


@pytest.mark.parametrize("kind,frame", [
    ("mle", RECORDS_FRAMES), ("mle-int64-frame", RECORDS_FRAMES),
    ("mle-int64-frame", -RECORDS_FRAMES - 1)])
def test_apply_drift_raises_index_error_for_a_frame_outside_as_jax(kind,
                                                                    frame):
    locs = make_locs(DTYPES[kind], 50, seed=5)
    locs["frame"][17] = frame
    drift = make_drift("rec2", seed=6)
    with pytest.raises(IndexError):
        _jax_apply_drift(locs, drift)
    with pytest.raises(IndexError, match="out of bounds"):
        tpost.apply_drift(locs, [{}], drift=drift, device="cpu")


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


# ---------------------------------------------------------------------------
# drift files, picks, fiducials and the post-localize verbs
# ---------------------------------------------------------------------------

FID_FRAMES, FID_SIZE = 400, 64


def _fiducial_locs(seed: int = 0, n_fid: int = 4) -> np.ndarray:
    """DNA-PAINT-like locs of 150 sites (3 locs a frame, 0.05 px) and
    ``n_fid`` fiducials (one loc a frame, 0.01 px) 6 px or more from any
    site, with the drift of :func:`_injected` over FID_FRAMES frames."""
    rng = np.random.default_rng(seed)
    span = FID_SIZE - 16
    fid = np.array([[8.3 + span * (i % 2), 8.6 + span * (i // 2 % 2)]
                    for i in range(n_fid)])
    sites = rng.uniform(3, FID_SIZE - 3, (600, 2))
    far = np.hypot(*(sites[:, None] - fid[None]).transpose(2, 0, 1)).min(1)
    sites = sites[far > 6][:150]
    f1 = np.repeat(np.arange(FID_FRAMES), 3)
    s = rng.integers(0, len(sites), len(f1))
    f2 = np.tile(np.arange(FID_FRAMES), n_fid)
    k = np.repeat(np.arange(n_fid), FID_FRAMES)
    frame = np.concatenate([f1, f2])
    x = np.concatenate([sites[s, 0], fid[k, 0]])
    y = np.concatenate([sites[s, 1], fid[k, 1]])
    lp = np.concatenate([np.full(len(f1), 0.05), np.full(len(f2), 0.01)])
    t = frame / (FID_FRAMES - 1)
    x = x + 0.8 * t + rng.normal(0, 1, len(x)) * lp
    y = y + 0.5 * np.sin(2 * np.pi * t) + rng.normal(0, 1, len(x)) * lp
    o = np.argsort(frame, kind="stable")
    locs = np.zeros(len(x), [("frame", np.uint32), ("x", np.float32),
                             ("y", np.float32), ("photons", np.float32),
                             ("lpx", np.float32), ("lpy", np.float32)])
    locs["frame"], locs["x"], locs["y"] = frame[o], x[o], y[o]
    locs["photons"] = 1000
    locs["lpx"] = locs["lpy"] = lp[o]
    return locs


def _fid_info():
    return [{"Byte Order": "<", "Data Type": "uint16",
             "Frames": FID_FRAMES, "Height": FID_SIZE, "Width": FID_SIZE,
             "Pixelsize": 130}]


def _as_set(rec: np.ndarray) -> np.ndarray:
    """Rows sorted by every field: rows within a frame as a set."""
    return rec[np.lexsort([rec[n] for n in rec.dtype.names[::-1]])]


def test_load_drift_matches_jax_and_rejects_other_files(tmp_path):
    rng = np.random.default_rng(8)
    for cols in (2, 3):
        path = str(tmp_path / f"d{cols}.txt")
        np.savetxt(path, rng.normal(size=(50, cols)), newline="\r\n")
        t, j = tio.load_drift(path), jio.load_drift(path)
        assert t.dtype.names == tuple(j.columns) == ("x", "y", "z")[:cols]
        for c in t.dtype.names:
            assert t.dtype[c] == np.float64
            np.testing.assert_array_equal(t[c], j[c].to_numpy())
    with pytest.raises(ValueError, match=".txt"):
        tio.load_drift(str(tmp_path / "d2.csv"))
    for shape in ((50, 1), (50, 4), (2,)):
        path = str(tmp_path / "bad.txt")
        np.savetxt(path, np.ones(shape))
        with pytest.raises(ValueError, match="2 or 3 columns"):
            tio.load_drift(path)
        with pytest.raises(AssertionError):
            jio.load_drift(path)


@pytest.mark.parametrize("shape", ["Circle", "Rectangle", "Polygon",
                                   "Square"])
def test_picked_locs_match_jax(shape):
    locs = _random_locs(6000, 40, seed=11)
    locs["frame"] = locs["frame"] // 4
    info = _info(100, 40)
    picks, size = {
        "Circle": ([(10.5, 12.25), (30.0, 5.0), (0.4, 39.5)], 2.5),
        "Rectangle": ([((5.0, 5.0), (20.0, 30.0)), ((30.5, 10.0),
                                                    (30.5, 35.0))], 3.0),
        "Polygon": ([[(5, 5), (20, 8), (12, 25), (5, 5)],
                     [(30, 30), (35, 30), (33, 38)],
                     [(20.5, 20.5), (38, 21), (30, 39), (20.5, 20.5)]], None),
        "Square": ([(10.0, 10.0), (25.5, 30.25)], 4.0),
    }[shape]
    df = pd.DataFrame.from_records(locs)
    for add_group in (True, False):
        t = tpost.picked_locs(locs, info, picks, shape, pick_size=size,
                              add_group=add_group)
        j = jpost.picked_locs(df, info, picks, shape, pick_size=size,
                              add_group=add_group)
        assert len(t) == len(j) == (2 if shape == "Polygon" else len(picks))
        for pt, pj in zip(t, j):
            rj = pj.to_records(index=False)
            assert pt.dtype == rj.dtype and len(pt) == len(rj) > 10
            assert np.all(np.diff(pt["frame"].astype(np.int64)) >= 0)
            np.testing.assert_array_equal(_as_set(pt), _as_set(
                np.asarray(rj, pt.dtype)))
            if shape == "Rectangle":
                assert "x_pick_rot" in pt.dtype.names


def test_undrift_from_picked_fills_frames_no_pick_covers():
    """Two picks (with z) that miss frames 40-59 and 90-99: those drifts
    are interpolated, and the last frames take the last value."""
    rng = np.random.default_rng(12)
    picked = []
    for k in range(2):
        frames = np.array([f for f in range(100)
                           if not 40 <= f < 60 and f < 90 and f % (k + 2)])
        p = np.zeros(len(frames), [("frame", np.uint32), ("x", np.float32),
                                   ("y", np.float32), ("z", np.float32)])
        p["frame"] = frames
        for c in ("x", "y", "z"):
            p[c] = 5 + 3 * k + rng.normal(0, 0.1, len(frames))
        picked.append(p)
    info = _info(100, 16)
    t = tpost.undrift_from_picked(picked, info)
    j = jpost.undrift_from_picked(
        [pd.DataFrame.from_records(p) for p in picked], info)
    assert t.dtype.names == tuple(j.columns) == ("x", "y", "z")
    for c in t.dtype.names:
        np.testing.assert_array_equal(t[c], j[c].to_numpy())
        assert np.isfinite(t[c]).all()


def test_identify_in_image_matches_jax():
    rng = np.random.default_rng(13)
    image = rng.normal(10, 2, (64, 80)).astype(np.float32)
    for yc, xc in ((10, 12), (40, 60), (30, 30)):
        image[yc - 2:yc + 3, xc - 2:xc + 3] += 300
    t = tloc.identify_in_image(image, 500.0, 7, device="cpu")
    j = jloc.identify_in_image(image, 500.0, 7)
    assert len(t[0]) == 3
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_allclose(t[2], j[2], rtol=1e-5, atol=0)
    ts = tloc.identify_in_image(torch.from_numpy(image), 500.0, 7)
    for a, b in zip(ts, t):
        np.testing.assert_array_equal(a, b)


def test_fiducials_match_jax_and_recover_the_drift():
    locs = _fiducial_locs(n_fid=4)
    info = _fid_info()
    df = pd.DataFrame.from_records(locs)
    picks_t, box_t = timage.find_fiducials(locs, info, device="cpu")
    picks_j, box_j = jimage.find_fiducials(df, info)
    assert picks_t == picks_j and box_t == box_j == 7 and len(picks_t) == 4
    lt, it, dt = tpost.undrift_from_fiducials(locs, info, device="cpu")
    lj, ij, dj = jpost.undrift_from_fiducials(df, info)
    assert it == ij and dt.dtype.names == tuple(dj.columns) == ("x", "y")
    rj = lj.to_records(index=False)
    assert lt.dtype == rj.dtype
    for name in lt.dtype.names:
        np.testing.assert_array_equal(lt[name], rj[name])
    inj = (0.8 * np.arange(FID_FRAMES) / (FID_FRAMES - 1),
           0.5 * np.sin(2 * np.pi * np.arange(FID_FRAMES) / (FID_FRAMES - 1)))
    for c, want in zip(("x", "y"), inj):
        np.testing.assert_array_equal(dt[c], dj[c].to_numpy())
        r = dt[c] - want
        assert np.sqrt(np.mean((r - r.mean()) ** 2)) < 0.05
    with pytest.raises(ValueError, match="pick_size"):
        tpost.undrift_from_fiducials(locs, info, picks=picks_t, device="cpu")
    given = tpost.undrift_from_fiducials(locs, info, picks=picks_t,
                                         pick_size=3.5, device="cpu")
    np.testing.assert_array_equal(given[2], dt)


def _verb_files(tmp_path, locs, info):
    """The same _locs.hdf5 (+ .yaml) in t/ (port) and j/ (JAX)."""
    paths = {}
    for d in ("t", "j"):
        (tmp_path / d).mkdir()
        paths[d] = str(tmp_path / d / "x_locs.hdf5")
        jio.save_locs(paths[d], pd.DataFrame.from_records(locs), info)
    return paths


def _outputs(folder):
    return sorted(p.name for p in folder.iterdir())


_VERBS = {
    "undrift-s": (["undrift", "{f}", "-s", "100"], ["x_locs_undrift.hdf5",
                                                     "x_locs_drift.txt"]),
    "undrift-f": (["undrift", "{f}", "-f", "{drift}", "-d"],
                  ["x_locs_undrift.hdf5"]),
    "aim": (["aim", "{f}", "-s", "50"], ["x_locs_aim.hdf5",
                                         "x_locs_aimdrift.txt"]),
    "undrift_fiducials": (["undrift_fiducials", "{f}"],
                          ["x_locs_undrift.hdf5", "x_locs_fiducialdrift.txt"]),
    "render": (["render", "{f}"], ["x_locs.png"]),
    "render-gaussian": (["render", "{f}", "-b", "gaussian", "-o", "5"],
                        ["x_locs.png"]),
    "render-none": (["render", "{f}", "-b", "none", "-o", "2.5", "-c",
                     "viridis"], ["x_locs.png"]),
    "render-iso": (["render", "{f}", "-b", "gaussian_iso", "-o", "3"],
                   ["x_locs.png"]),
    "render-smooth": (["render", "{f}", "-b", "smooth"], ["x_locs.png"]),
}


@pytest.mark.parametrize("verb", list(_VERBS))
def test_cli_verbs_match_the_jax_cli(tmp_path, verb):
    """The port's verb (--device cpu) and the JAX CLI's on the same
    _locs.hdf5: the same files; HDF5 fields and YAML equal (RCC's drift
    within DRIFT_AGREE); the PNG's pixels equal."""
    import matplotlib.image as mpimg

    from picasso_torch import __main__ as tmain
    from picasso_tpu import __main__ as jmain

    locs = _fiducial_locs(seed=3)
    paths = _verb_files(tmp_path, locs, _fid_info())
    drift = tmp_path / "drift.txt"
    np.savetxt(drift, np.random.default_rng(4).normal(
        size=(FID_FRAMES, 2)), newline="\r\n")
    argv, produced = _VERBS[verb]
    for d, main, extra in (("t", tmain.main, ["--device", "cpu"]),
                           ("j", jmain.main, [])):
        main([a.format(f=paths[d], drift=drift) for a in argv] + extra)
    t, j = tmp_path / "t", tmp_path / "j"
    assert _outputs(t) == _outputs(j)
    assert set(produced) <= set(_outputs(t))
    for name in produced:
        if name.endswith(".hdf5"):
            lt, lj = _read(t / name), _read(j / name)
            assert lt.dtype == lj.dtype and len(lt) == len(lj)
            for c in lt.dtype.names:
                tol = DRIFT_AGREE if verb == "undrift-s" else 0
                np.testing.assert_allclose(lt[c], lj[c], rtol=0, atol=tol)
            assert tio.load_info(str(t / name)) == tio.load_info(
                str(j / name))
        elif name.endswith(".txt"):
            tol = DRIFT_AGREE if verb == "undrift-s" else 0
            np.testing.assert_allclose(np.loadtxt(t / name),
                                       np.loadtxt(j / name), rtol=0,
                                       atol=tol)
        else:
            np.testing.assert_array_equal(mpimg.imread(t / name),
                                          mpimg.imread(j / name))


def test_cli_verbs_report_no_files(tmp_path, capsys):
    from picasso_torch import __main__ as tmain

    tmain.main(["aim", str(tmp_path / "*.hdf5"), "--device", "cpu"])
    assert f"No files matching {tmp_path}" in capsys.readouterr().out
