"""Astigmatic 3D in the port (picasso_torch.zfit, localize.localize_3D)
held against picasso_tpu on the CPU.

The z fit rounds every step as XLA does on the CPU (zfit.py's module
docstring), so on the same locs z, d_zcalib, lpz and the filter's
decision equal picasso_tpu's bit for bit. End to end, the 2D fits agree
within tests/torch_parity.py, and z then agrees bit for bit wherever sx
and sy do, and within Z_DIFF_NM elsewhere; lpz within rtol 1e-3."""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import gaussmle as jg
from picasso_tpu import localize as jl
from picasso_tpu import simulate
from picasso_tpu import zfit as jz
from picasso_torch import gaussmle as tg
from picasso_torch import localize as tl
from picasso_torch import zfit as tz
from torch_data import CALIB_3D, make_astig_movie
from torch_native import loaded_native

#: z of the port against picasso_tpu end to end, where the 2D fit's sx or
#: sy differs in the last ulps (measured: max 0.18 nm on the simulated
#: movie below, a 1e-7 change of a width moves the parabolic step)
Z_DIFF_NM = 1.0
CAMERA = {"Baseline": 100, "Sensitivity": 0.45, "Gain": 7, "Pixelsize": 130}
INFO = [{"Frames": 64, "Height": 96, "Width": 96, "Pixelsize": 130}]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
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


@pytest.fixture(scope="module")
def astig():
    return make_astig_movie(64, 96, 40, 0.5, np.random.default_rng(3))


@pytest.fixture(scope="module")
def locs2d(astig):
    cam = dict(CAMERA, Baseline=0, Sensitivity=1, Gain=1)
    return {m: tl.localize(astig[0], dict(cam), {"Min. Net Gradient": 4000,
                                                  "Box Size": 7},
                           fitting_method=m, device="cpu")
            for m in ("gaussmle", "gausslq")}


def _records(df):
    return df.to_records(index=False)


@pytest.mark.parametrize("method", ["gaussmle", "gausslq"])
@pytest.mark.parametrize("filt", [0, 2])
def test_zfit_equals_jax(locs2d, method, filt):
    locs = locs2d[method]
    assert len(locs) > 500
    ref, ref_info = jz.zfit(pd.DataFrame(locs), INFO, calibration=CALIB_3D,
                            fitting_method=method, filter=filt)
    got, got_info = tz.zfit(locs, INFO, calibration=CALIB_3D,
                            fitting_method=method, filter=filt, device="cpu")
    assert got_info == ref_info
    ref = _records(ref)
    assert got.dtype == ref.dtype
    assert got.dtype.names[-3:] == ("z", "d_zcalib", "lpz")
    for name in got.dtype.names:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    if filt:
        assert len(got) < len(locs)  # the filter decided something


def test_zfit_mle_without_sigma_uncertainties_equals_jax(locs2d):
    """MLE locs without sx_unc/sy_unc take gaussmle.sigma_uncertainty."""
    keep = [n for n in locs2d["gaussmle"].dtype.names
            if n not in ("sx_unc", "sy_unc")]
    locs = np.ascontiguousarray(locs2d["gaussmle"][keep])
    ref = _records(jz.zfit(pd.DataFrame(locs), INFO, calibration=CALIB_3D,
                           fitting_method="gaussmle", filter=0)[0])
    got = tz.zfit(locs, INFO, calibration=CALIB_3D, fitting_method="gaussmle",
                  filter=0, device="cpu")[0]
    np.testing.assert_array_equal(got["lpz"], ref["lpz"])
    s = [locs[c] for c in ("sx", "sy", "photons", "bg")]
    np.testing.assert_array_equal(tg.sigma_uncertainty(*s),
                                  jg.sigma_uncertainty(*s))


def test_grid_rows_and_odd_widths_equal_jax():
    """Blocks of any row count give the same z; NaN, negative, tiny and
    huge widths end as in picasso_tpu (all-infinite cost rows too)."""
    rng = np.random.default_rng(0)
    sx = rng.uniform(0.8, 3.0, 3000).astype(np.float32)
    sy = rng.uniform(0.8, 3.0, 3000).astype(np.float32)
    sx[:6] = [np.nan, -1.0, 0.0, 1e-3, 50.0, np.inf]
    sy[6:9] = [np.nan, -2.0, 1e4]
    z, d = tz.fit_z_grid(sx, sy, CALIB_3D, device="cpu")
    z7, d7 = tz.fit_z_grid(sx, sy, CALIB_3D, device="cpu", rows=7)
    np.testing.assert_array_equal(z, z7)
    np.testing.assert_array_equal(d, d7)
    locs = np.zeros(3000, [("frame", np.uint32), ("x", np.float32),
                           ("y", np.float32), ("photons", np.float32),
                           ("sx", np.float32), ("sy", np.float32),
                           ("bg", np.float32)])
    locs["sx"], locs["sy"] = sx, sy
    locs["x"] = locs["y"] = 10
    locs["photons"], locs["bg"] = 3000, 20
    ref = _records(jz.zfit(pd.DataFrame(locs), INFO, calibration=CALIB_3D,
                           filter=0)[0])
    got = tz.zfit(locs, INFO, calibration=CALIB_3D, filter=0, device="cpu")[0]
    assert len(got) == len(ref) < 3000
    for name in ("z", "d_zcalib", "lpz"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def test_calibrate_z_matches_jax(tmp_path):
    """A z-stepped stack drawn from the calibration's curves: the port's
    numpy group statistics against picasso_tpu's pandas groupby give the
    same curves (coefficients of the f32 column means, to 1e-6 px over
    the range) and the same YAML keys."""
    rng = np.random.default_rng(3)
    n_frames, d = 201, 5.0
    cx = np.asarray(CALIB_3D["X Coefficients"])
    cy = np.asarray(CALIB_3D["Y Coefficients"])
    frame = np.repeat(np.arange(n_frames), 20)
    frame = frame[rng.random(len(frame)) > 0.02]  # some frames thinner
    frame = frame[(frame < 50) | (frame > 52)]  # three frames empty
    z = ((n_frames - 1) / 2 - frame) * d
    locs = np.zeros(len(frame), [("frame", np.uint32), ("x", np.float32),
                                 ("y", np.float32), ("sx", np.float32),
                                 ("sy", np.float32)])
    locs["frame"] = frame
    locs["sx"] = np.polyval(cx, z) + rng.normal(0, 0.01, len(z))
    locs["sy"] = np.polyval(cy, z) + rng.normal(0, 0.01, len(z))
    info = [{"Frames": n_frames, "Height": 64, "Width": 64}]
    for bounds in (None, (20, 180)):
        ref = jz.calibrate_z(pd.DataFrame(locs), info, d, 0.79,
                             frame_bounds=bounds)
        got = tz.calibrate_z(locs, info, d, 0.79, frame_bounds=bounds,
                             path=str(tmp_path / "calib.yaml"))
        assert got.keys() == ref.keys()
        zz = np.linspace(-400, 400, 81)
        for key in ("X Coefficients", "Y Coefficients"):
            np.testing.assert_allclose(np.polyval(got[key], zz),
                                       np.polyval(ref[key], zz), rtol=0,
                                       atol=1e-6)
        assert {k: v for k, v in got.items() if "Coeff" not in k and
                k != "Path"} == {k: v for k, v in ref.items()
                                 if "Coeff" not in k and k != "Path"}
    import yaml

    with open(tmp_path / "calib.yaml") as f:
        assert yaml.full_load(f)["X Coefficients"] == got["X Coefficients"]


def test_zfit_arguments_and_aliases(locs2d):
    locs = locs2d["gausslq"][:200]
    with pytest.raises(AssertionError):
        tz.zfit(locs, INFO, calibration=CALIB_3D, fitting_method="avg",
                device="cpu")
    with pytest.raises(AssertionError):
        tz.zfit(locs, INFO, calibration=CALIB_3D, filter=-1, device="cpu")
    with pytest.raises(AssertionError):
        tz.zfit(locs, INFO, calibration=[1, 2], device="cpu")
    with pytest.raises(KeyError, match="Pixelsize"):
        tz.zfit(locs, [{"Frames": 64, "Height": 96, "Width": 96}],
                calibration=CALIB_3D, device="cpu")
    assert tz.zfit(locs, INFO, calibration=CALIB_3D, device="cpu",
                   abort_callback=lambda: True) == (None, None)
    a = tz.zfit(locs, INFO, calibration=CALIB_3D, filter=0, device="cpu")[0]
    b = tz.zfit(locs, INFO, calibration=CALIB_3D, filter=0,
                magnification_factor=1.0, device="cpu")[0]
    np.testing.assert_allclose(b["z"] * 0.79, a["z"], rtol=1e-6, atol=1e-6)
    c = tz.fit_z(locs, INFO, CALIB_3D, 0.79, 130, filter=0, device="cpu")
    np.testing.assert_array_equal(c, a)
    fut = tz.fit_z_parallel(locs, INFO, CALIB_3D, 0.79, 130, filter=0,
                            asynch=True, device="cpu")
    np.testing.assert_array_equal(tz.locs_from_futures(fut, filter=0), a)
    np.testing.assert_array_equal(
        tz.axial_localization_precision(a, INFO, CALIB_3D).astype(
            np.float32), a["lpz"])
    np.testing.assert_array_equal(
        tz.axial_localization_precision(a, INFO, CALIB_3D),
        jz.axial_localization_precision(pd.DataFrame(a), INFO, CALIB_3D))
    assert tz.filter_z_fits(locs, 2) is locs  # no d_zcalib: unchanged


def _simulated_astig_movie(seed=21, n_sites=15, size=48, frames=40):
    """An astigmatic movie of picasso_tpu.simulate: sites at z uniform
    in +-300 nm, photons spread by the calibration's widths."""
    np.random.seed(seed)
    sites = simulate.generatePositions(n_sites, size, 5, 0)
    n = len(sites)
    z = np.random.uniform(-300, 300, n)
    structures = np.array([sites[:, 0], sites[:, 1], np.ones(n),
                           np.arange(n), z])
    photons, _, _ = simulate.distphotons(structures, 300, frames, 1500, 500,
                                         70, 10, 1.5e6)
    movie = np.stack([simulate.convertMovie(
        f, photons, structures, size, frames, 0.82, 70, 1, 0, True,
        CALIB_3D["X Coefficients"], CALIB_3D["Y Coefficients"])
        for f in range(frames)])
    return simulate.check_type(simulate.noisy_p(movie, 1)) + 100


@pytest.mark.parametrize("method", ["gaussmle", "gausslq"])
def test_localize_3d_matches_jax(method):
    movie = _simulated_astig_movie()
    info = [{"Frames": len(movie), "Height": 48, "Width": 48,
             "Data Type": "uint16", "Byte Order": "<"}]
    kw = dict(movie_info=info, box=7, minimum_ng=3000,
              calibration_3d=CALIB_3D, fitting_method=method)
    ref, ref_info = jl.localize_3D(movie, camera_info=dict(CAMERA), **kw)
    got, got_info = tl.localize_3D(movie, camera_info=dict(CAMERA),
                                   device="cpu", **kw)
    assert got_info == ref_info
    ref = _records(ref)
    assert got.dtype == ref.dtype and len(got) == len(ref) > 100
    order = lambda r: r[np.lexsort((r["x"], r["y"], r["frame"]))]  # noqa
    ref, got = order(ref), order(got)
    np.testing.assert_array_equal(got["frame"], ref["frame"])
    same = (got["sx"] == ref["sx"]) & (got["sy"] == ref["sy"])
    assert same.any()
    for name in ("z", "d_zcalib"):
        np.testing.assert_array_equal(got[name][same], ref[name][same])
    assert np.abs(got["z"] - ref["z"]).max() <= Z_DIFF_NM
    # lpz also reads photons and bg (and MLE's sx_unc), which agree to
    # compare_fits' photons rtol 2e-4
    np.testing.assert_allclose(got["lpz"], ref["lpz"], rtol=1e-3)


@pytest.mark.parametrize("method,kept,rms", [("gaussmle", 0.88, 60.0),
                                             ("gausslq", 0.97, 95.0)])
def test_localize_3d_recovers_z(astig, tmp_path, method, kept, rms):
    """On the astigmatic recipe of tests/torch_data.py (64 frames of
    96x96 px, 40 sites) the z fit keeps >= ``kept`` of the 2D locs, and
    z of the locs within 1 px of a site lies within ``rms`` nm RMS and
    8 nm median of its truth (measured: MLE 91.3%, 47.8 nm, median 5.5;
    LQ 99.7%, 78.8 nm, median 5.1; overlapping wide spots make the
    tail); the calibration may come as a YAML path."""
    import yaml

    movie, sites, z_true = astig
    path = str(tmp_path / "calib.yaml")
    with open(path, "w") as f:
        yaml.dump(CALIB_3D, f)
    cam = dict(CAMERA, Baseline=0, Sensitivity=1, Gain=1)
    locs, info = tl.localize_3D(movie, movie_info=INFO, camera_info=cam,
                                box=7, minimum_ng=4000, calibration_3d=path,
                                fitting_method=method, device="cpu")
    n2d = len(tl.localize(movie, dict(cam), {"Min. Net Gradient": 4000,
                                             "Box Size": 7},
                          fitting_method=method, device="cpu"))
    assert info[-1]["Generated by"] == "Picasso v0.1.0 Fit Z"
    assert len(locs) >= kept * n2d
    d2 = ((locs["y"][:, None] - sites[None, :, 0]) ** 2
          + (locs["x"][:, None] - sites[None, :, 1]) ** 2)
    k = d2.argmin(1)
    near = d2[np.arange(len(k)), k] < 1
    assert near.mean() > 0.9
    err = locs["z"][near] - z_true[k[near]]
    assert np.sqrt(np.mean(err**2)) < rms
    assert np.median(np.abs(err)) < 8
