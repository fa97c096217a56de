"""The port's localize slice (identify -> cut -> MLE fit -> locs -> HDF5)
held against picasso_tpu.localize on the same movie (CPU), plus the
``python -m picasso_torch localize`` CLI.

Hit lists and fits are held to the tolerances of tests/torch_parity.py.
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

from torch_data import make_bench_movie
from torch_native import loaded_native
from picasso_tpu import io as jio
from picasso_tpu import lib as jlib
from picasso_tpu import localize as jloc
from picasso_tpu.ops import fused as jfused
from picasso_torch import __main__ as cli
from picasso_torch import io as tio
from picasso_torch import localize as tloc
from picasso_torch.ops import fused as tfused
from torch_parity import compare_fits, compare_hits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
MIN_NG = 4000
PARAMS = {"Min. Net Gradient": MIN_NG, "Box Size": 7}


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


@pytest.fixture(scope="module")
def movie():
    return make_bench_movie(32, 64, 40, 0.5, np.random.default_rng(7))


def _movie_info(movie):
    return [{"Byte Order": "<", "Data Type": "uint16",
             "Frames": movie.shape[0], "Height": movie.shape[1],
             "Width": movie.shape[2]}]


@pytest.fixture(scope="module")
def jax_localized(movie):
    return jloc.localize(movie, dict(CAMERA), PARAMS,
                         movie_info=_movie_info(movie),
                         fitting_method="gaussmle", return_info=True)


def _by_position(locs: np.ndarray) -> np.ndarray:
    """Rows ordered by (frame, y, x): pandas' quicksort in the JAX
    package may permute the locs of one frame."""
    return locs[np.lexsort((locs["x"], locs["y"], locs["frame"]))]


def test_localize_fused_matches_jax(movie):
    j_ids, j_fits = jfused.localize_fused(movie, MIN_NG, 7, dict(CAMERA))
    t_ids, t_fits = tfused.localize_fused(movie, MIN_NG, 7, dict(CAMERA),
                                          device="cpu")
    ref = [j_ids[c].to_numpy() for c in ("frame", "y", "x", "net_gradient")]
    got = [t_ids[c] for c in ("frame", "y", "x", "net_gradient")]
    assert len(ref[0]) > 300
    compare_hits(ref, got, MIN_NG)
    assert len(ref[0]) == len(got[0])
    for c in ("frame", "y", "x"):
        np.testing.assert_array_equal(ref[("frame", "y", "x").index(c)],
                                      got[("frame", "y", "x").index(c)])
    theta_j, crlb_j, ll_j, it_j = j_fits
    theta_t, crlb_t, ll_t, it_t = t_fits
    compare_fits((theta_j.T, crlb_j.T, ll_j, it_j),
                 (theta_t.T, crlb_t.T, ll_t, it_t))


def test_localize_matches_jax(movie, jax_localized):
    j_locs, j_info = jax_localized
    t_locs, t_info = tloc.localize(movie, dict(CAMERA), PARAMS,
                                   movie_info=_movie_info(movie),
                                   fitting_method="gaussmle",
                                   return_info=True, device="cpu")
    assert t_info == j_info
    j_rec = j_locs.to_records(index=False)
    assert t_locs.dtype == j_rec.dtype
    assert np.all(np.diff(t_locs["frame"].astype(np.int64)) >= 0)
    j_rec, t_sorted = _by_position(j_rec), _by_position(t_locs)
    np.testing.assert_array_equal(t_sorted["frame"], j_rec["frame"])
    same = (j_rec["iterations"] == t_sorted["iterations"]) & (
        j_rec["iterations"] < 100
    )
    assert same.mean() >= 0.95
    for c in ("x", "y"):
        np.testing.assert_allclose(t_sorted[c][same], j_rec[c][same],
                                   rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_sorted["net_gradient"],
                               j_rec["net_gradient"], rtol=1e-5)


def test_save_locs_byte_compatible(tmp_path, jax_localized):
    """The same table written by both packages gives identical files."""
    j_locs, j_info = jax_localized
    rec = np.asarray(j_locs.to_records(index=False))
    tio.save_locs(str(tmp_path / "t_locs.hdf5"), rec, j_info)
    jio.save_locs(str(tmp_path / "j_locs.hdf5"), pd.DataFrame(rec), j_info)
    for ext in (".hdf5", ".yaml"):
        assert (tmp_path / f"t_locs{ext}").read_bytes() == (
            tmp_path / f"j_locs{ext}"
        ).read_bytes()


def _write_raw(path, movie):
    jio.save_raw(str(path), movie, _movie_info(movie))


def test_cli_localize_writes_the_jax_locs_layout(tmp_path, movie,
                                                 jax_localized):
    _write_raw(tmp_path / "x.raw", movie)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "picasso_torch", "localize", "x.raw",
         "-d", "0", "-g", str(MIN_NG), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    with h5py.File(tmp_path / "x_locs.hdf5", "r") as f:
        t_rec = f["locs"][()]
    j_locs, j_info = jax_localized
    j_rec = j_locs.to_records(index=False)
    assert t_rec.dtype == j_rec.dtype
    assert t_rec.dtype.names == tuple(j_locs.columns)
    assert len(t_rec) == len(jlib.ensure_sanity(j_locs, j_info))
    t_info = tio.load_info(str(tmp_path / "x_locs.hdf5"))
    assert [d.get("Generated by") for d in t_info[1:]] == [
        "Picasso: v0.1.0 Identify", "Picasso: v0.1.0 Fit 2D",
    ]
    assert t_info[2]["Fit method"] == "gaussmle"
    assert t_info[1]["Min. Net Gradient"] == MIN_NG


def test_cli_undrift_exits_2_before_any_work(tmp_path, movie, capsys):
    """A movie shorter than two segments at the default -d 1000: the
    undrift is refused with the JAX CLI's message before any of its work,
    the locs stay and the run ends normally, with no drift written."""
    _write_raw(tmp_path / "x.raw", movie[:2])
    cli.main(["localize", str(tmp_path / "x.raw"), "--device", "cpu"])
    assert "RCC undrift failed: Segmentation 1000 gives 0 segment(s)" in (
        capsys.readouterr().out)
    assert (tmp_path / "x_locs.hdf5").exists()
    assert not (tmp_path / "x_locs_drift.txt").exists()
    assert not (tmp_path / "x_locs_undrift.hdf5").exists()


def test_cli_profile_writes_a_trace(tmp_path, movie):
    _write_raw(tmp_path / "x.raw", movie[:4])
    cli.main(["localize", str(tmp_path / "x.raw"), "-d", "0", "--device",
              "cpu", "--profile", str(tmp_path / "prof")])
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert (tmp_path / "x_locs.hdf5").exists()


@pytest.mark.parametrize("method", ["lq-3d", "avg"])
def test_cli_unported_fit_methods_exit_2(tmp_path, method):
    """Both methods run now (test_cli_avg_and_3d_match_the_jax_cli), and
    so does -db (tests/test_torch_db.py); what stays refused exits 2
    before any work: a -3d method without a calibration (-zc), and a
    call without a movie (here with -db)."""
    movie = [] if method == "avg" else [str(tmp_path / "x.raw")]
    args = ["-zc", ""] if method.endswith("-3d") else ["-db"]
    with pytest.raises(SystemExit) as exc:
        cli.main(["localize", *movie, "-d", "0", "-a", method, "--device",
                  "cpu", *args])
    assert exc.value.code == 2


def test_cuda_without_a_card_raises(tmp_path, movie):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _write_raw(tmp_path / "x.raw", movie[:2])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["localize", str(tmp_path / "x.raw"), "-d", "0"])
    with pytest.raises(RuntimeError, match="cuda"):
        tloc.localize(movie[:2], dict(CAMERA), PARAMS,
                      fitting_method="gaussmle")


def test_localize_unported_methods_raise(movie):
    """A per-pixel (H, W) camera calibration is refused where the JAX
    package refuses it: numpy's ValueError when the map meets the (N,
    box, box) ROIs, by localize for every fitter (avg included) and by
    fit2D (cameras whose values are arrays that broadcast run:
    tests/test_torch_localize_api.py)."""
    per_pixel = dict(CAMERA, Baseline=np.zeros(movie.shape[1:]))
    for method in ("gaussmle", "avg"):
        with pytest.raises(ValueError, match="broadcast"):
            tloc.localize(movie, dict(per_pixel), PARAMS,
                          fitting_method=method, device="cpu")
    ids = tloc.identify(movie[:2], MIN_NG, 7, device="cpu")
    with pytest.raises(ValueError, match="broadcast"):
        tloc.fit2D(movie, _movie_info(movie), dict(per_pixel), ids, 7,
                   device="cpu")


@pytest.mark.parametrize("key", ["frame", "n_id"])
def test_locs_from_fits_matches_jax(key):
    """Columns, dtypes, values and order; unique keys, so the JAX
    package's unstable quicksort and the port's stable sort agree."""
    from picasso_torch import gaussmle as tg
    from picasso_tpu import gaussmle as jg

    n = 3000
    rng = np.random.default_rng(11)
    fields = [("frame", np.int64), ("x", np.int64), ("y", np.int64),
              ("net_gradient", np.float32)]
    if key == "n_id":
        fields.append(("n_id", np.int64))
    ids = np.zeros(n, dtype=fields)
    ids["frame"] = rng.integers(0, 50, n)
    ids[key] = rng.permutation(n)
    ids["x"] = rng.integers(3, 60, n)
    ids["y"] = rng.integers(3, 60, n)
    ids["net_gradient"] = rng.random(n) * 1e4
    theta = (rng.random((n, 6)) + 0.5).astype(np.float32)
    crlb = (rng.random((n, 6)) - 0.1).astype(np.float32)  # some NaN lp
    ll = -rng.random(n).astype(np.float32) * 50
    iters = rng.integers(1, 101, n).astype(np.int32)
    t = tg.locs_from_fits(ids, theta, crlb, ll, iters, 7)
    j = jg.locs_from_fits(pd.DataFrame(ids), theta, crlb, ll, iters,
                          7).to_records(index=False)
    assert t.dtype == j.dtype
    for name in t.dtype.names:
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)


def test_chunk_prefetcher_order_errors_and_close():
    from picasso_torch.stream import ChunkPrefetcher

    movie = np.arange(40, dtype=np.uint16).reshape(10, 2, 2)
    p = ChunkPrefetcher(movie, [(0, 4), (4, 8), (8, 10)])
    got = list(p)
    p.close()
    assert [lo for lo, _ in got] == [0, 4, 8]
    np.testing.assert_array_equal(np.concatenate([c for _, c in got]), movie)
    assert all(c.flags.writeable for _, c in got)

    class Broken:
        def __getitem__(self, s):
            raise OSError("unreadable frame")

    p = ChunkPrefetcher(Broken(), [(0, 1)])
    with pytest.raises(OSError, match="unreadable"):
        list(p)
    p.close()

    p = ChunkPrefetcher(movie, [(i, i + 1) for i in range(10)], depth=1)
    next(iter(p))
    p.close()
    assert not p.thread.is_alive()


# --- identify, get_spots, fit2D, localize(avg), the CLI's other methods ---

# sensitivity / gain differs from f32 sensitivity / f32 gain in the last
# bit (0.45 / 7), so a photon conversion on the wrong route shows
CAM2 = {"Baseline": 100, "Sensitivity": 0.45, "Gain": 7, "Pixelsize": 130}


@pytest.fixture(scope="module")
def movie2(movie):
    return movie + np.uint16(100)


@pytest.fixture(scope="module")
def tiff_series(movie2, tmp_path_factory):
    """movie2 as a two-file MicroManager series (16 + 16 frames)."""
    from torch_data import write_tiff

    d = tmp_path_factory.mktemp("series")
    write_tiff(str(d / "m.ome.tif"), movie2[:16])
    write_tiff(str(d / "m_1.ome.tif"), movie2[16:])
    return str(d / "m.ome.tif")


def _ids_equal(ref, got):
    """picasso_tpu's identifications (DataFrame) against the port's:
    frame/x/y equal in order, ng within compare_hits' rtol 1e-5."""
    assert got.dtype.names == tuple(ref.columns)
    for c in ("frame", "x", "y"):
        np.testing.assert_array_equal(got[c], ref[c].to_numpy())
    np.testing.assert_allclose(got["net_gradient"],
                               ref["net_gradient"].to_numpy(), rtol=1e-5)


@pytest.mark.parametrize("lazy", [False, True])
def test_identify_matches_jax(movie2, tiff_series, lazy):
    src = tio.load_movie(tiff_series)[0] if lazy else movie2
    ref, ref_info = jloc.identify(movie2, MIN_NG, 7, return_info=True)
    got, got_info = tloc.identify(src, MIN_NG, 7, return_info=True,
                                  device="cpu")
    assert got_info == ref_info and len(got) > 300
    _ids_equal(ref, got)
    kw = dict(roi=((5, 3), (60, 50)), frame_bounds=(3, 20))
    _ids_equal(jloc.identify(movie2, MIN_NG, 7, **kw),
               tloc.identify(src, MIN_NG, 7, device="cpu", **kw))
    assert len(tloc.identify(src, MIN_NG, 7, frame_bounds=(40, 50),
                             device="cpu")) == 0
    seen = []
    tloc.identify(src, MIN_NG, 7, device="cpu", progress_callback=seen.append)
    assert seen == [32]
    assert tloc.identify(src, MIN_NG, 7, device="cpu",
                         abort_callback=lambda: True) is None


def test_identify_and_cut_equals_identify_and_get_spots_raw(movie2,
                                                            tiff_series):
    from picasso_torch import stream

    lazy = tio.load_movie(tiff_series)[0]
    ids, spots = stream.identify_and_cut(lazy, MIN_NG, 7, device="cpu",
                                         frame_chunk=10)
    ref = jloc.identify(movie2, MIN_NG, 7)
    _ids_equal(ref, ids)
    assert spots.dtype == np.uint16
    np.testing.assert_array_equal(
        spots, jloc.get_spots_raw(movie2, ref, 7))
    kw = dict(roi=((5, 3), (60, 50)), frame_bounds=(3, 20))
    ids, spots = stream.identify_and_cut(lazy, MIN_NG, 7, device="cpu", **kw)
    ref = jloc.identify(movie2, MIN_NG, 7, **kw)
    _ids_equal(ref, ids)
    np.testing.assert_array_equal(spots, jloc.get_spots_raw(movie2, ref, 7))
    assert stream.identify_and_cut(lazy, MIN_NG, 7, device="cpu",
                                   abort_callback=lambda: True) == (None,
                                                                   None)


@pytest.mark.parametrize("route", ["u16", "f32", "lazy", "strided"])
def test_get_spots_match_jax_per_route(movie2, tiff_series, route):
    """The device cut of an in-RAM movie and the host cut of a lazy one
    equal picasso_tpu's ROIs, and each route converts photons as
    picasso_tpu's does (one factor for a C-contiguous u16 array, three
    roundings otherwise) bit for bit."""
    src = {"u16": movie2, "f32": movie2.astype(np.float32),
           "lazy": tio.load_movie(tiff_series)[0],
           "strided": np.asarray(movie2[:, :, ::-1]).copy()[:, :, ::-1]}[route]
    jsrc = jio.load_movie(tiff_series)[0] if route == "lazy" else src
    ids = tloc.identify(movie2, MIN_NG, 7, device="cpu")
    ids_df = pd.DataFrame(ids)
    raw = tloc.get_spots_raw(src, ids, 7, device="cpu")
    ref_raw = jloc.get_spots_raw(jsrc, ids_df, 7)
    assert raw.dtype == (np.float32 if route == "f32" else np.uint16)
    np.testing.assert_array_equal(raw, ref_raw)
    np.testing.assert_array_equal(
        tloc.get_spots(src, ids, 7, dict(CAM2), device="cpu"),
        jloc.get_spots(jsrc, ids_df, 7, dict(CAM2)))


def test_get_spots_follows_jaxs_native_route(movie2, monkeypatch):
    """picasso_tpu's get_spots converts a C-contiguous u16 movie with a
    scalar camera in one factor when picasso_tpu.native is loaded and in
    three roundings when it is not, and the two differ on CAM2; the
    port's get_spots equals the native route bit for bit, which is why
    the JAX side of these tests must have the library loaded
    (_native_loaded)."""
    from picasso_tpu import native

    ids = tloc.identify(movie2, MIN_NG, 7, device="cpu")
    ids_df = pd.DataFrame(ids)
    assert native.AVAILABLE
    one_factor = jloc.get_spots(movie2, ids_df, 7, dict(CAM2))
    monkeypatch.setattr(native, "AVAILABLE", False)
    three_roundings = jloc.get_spots(movie2, ids_df, 7, dict(CAM2))
    monkeypatch.undo()
    assert native.AVAILABLE
    assert one_factor.shape == three_roundings.shape == (len(ids), 7, 7)
    assert not np.array_equal(one_factor, three_roundings)
    np.testing.assert_allclose(one_factor, three_roundings, rtol=1e-6)
    np.testing.assert_array_equal(
        tloc.get_spots(movie2, ids, 7, dict(CAM2), device="cpu"), one_factor)


def test_identify_never_needs_the_cut_clamp(movie2):
    """winfit_cuda.cut_rois_t clamps centres into the frame and
    picasso_tpu's cut_spots_numpy does not; they agree because identify
    yields no centre within box // 2 of an edge (its eligibility, even at
    a hit in the last eligible row and column)."""
    from picasso_torch.ops.identify import cut_spots_numpy

    for box in (5, 7, 9):
        ids = tloc.identify(movie2, 2000, box, device="cpu")
        r = box // 2
        assert ids["y"].min() >= r and ids["y"].max() <= 64 - r - 2
        assert ids["x"].min() >= r and ids["x"].max() <= 64 - r - 2
        np.testing.assert_array_equal(
            tloc.get_spots_raw(movie2, ids, box, device="cpu"),
            cut_spots_numpy(movie2, ids["frame"], ids["x"], ids["y"], box))
    edge = np.zeros(1, ids.dtype)
    edge["frame"], edge["x"], edge["y"] = 0, 63, 0
    clamped = tloc.get_spots_raw(movie2, edge, 7, device="cpu")[0]
    np.testing.assert_array_equal(clamped, movie2[0, 0:7, 57:64])


def _fit_cols(locs, ids, method):
    """theta (6, n) [x, y, photons, bg, sx, sy] relative to the box
    centre, and for MLE crlb, ll and iters, from a locs table."""
    theta = np.stack([locs["x"] - ids["x"], locs["y"] - ids["y"],
                      locs["photons"], locs["bg"], locs["sx"], locs["sy"]])
    if method != "gaussmle":
        return theta.astype(np.float32)
    crlb = np.stack([locs[c] ** 2 for c in ("lpx", "lpy", "photons_unc",
                                             "bg_unc", "sx_unc", "sy_unc")])
    return (theta.astype(np.float32), crlb, locs["log_likelihood"],
            locs["iterations"].astype(np.int32))


@pytest.mark.parametrize("method", ["gausslq", "gausslq-gpu", "gaussmle",
                                    "avg"])
@pytest.mark.parametrize("route", ["movie", "spots", "lazy"])
def test_fit2D_matches_jax(movie2, tiff_series, method, route):
    """fit2D from the movie in RAM, from pre-cut raw spots and from a lazy
    TIFF series, at a camera whose photon routes round differently:
    avg photons within compare_avg_photons, MLE fits within compare_fits,
    LM fits within compare_lq_fits, every other column equal."""
    from torch_parity import compare_avg_photons, compare_lq_fits

    ids = tloc.identify(movie2, MIN_NG, 7, device="cpu")
    ids_df = pd.DataFrame(ids)
    jsrc = tsrc = movie2
    spots = None
    if route == "lazy":
        tsrc = tio.load_movie(tiff_series)[0]
        jsrc = jio.load_movie(tiff_series)[0]
    elif route == "spots":
        spots = jloc.get_spots_raw(movie2, ids_df, 7)
    info = _movie_info(movie2)
    ref, ref_info = jloc.fit2D(jsrc, info, dict(CAM2), ids_df, 7,
                               fitting_method=method, spots=spots)
    got, got_info = tloc.fit2D(tsrc, info, dict(CAM2), ids, 7,
                               fitting_method=method, spots=spots,
                               device="cpu")
    ref = ref.to_records(index=False)
    assert got_info == ref_info and got.dtype == ref.dtype
    # rows in hit order: frames are unique per hit's key, so compare the
    # JAX rows by position
    ref = ref[np.lexsort((ref["x"], ref["y"], ref["frame"]))]
    order = np.lexsort((got["x"], got["y"], got["frame"]))
    got, ids = got[order], ids[order]
    np.testing.assert_array_equal(got["frame"], ref["frame"])
    np.testing.assert_array_equal(got["net_gradient"], ref["net_gradient"])
    if method == "avg":
        photons = jloc.get_spots(jsrc, pd.DataFrame(ids), 7, dict(CAM2))
        compare_avg_photons(ref["photons"], got["photons"], photons)
        for c in ("x", "y", "sx", "sy"):
            np.testing.assert_array_equal(got[c], ref[c])
    elif method == "gaussmle":
        compare_fits(_fit_cols(ref, ids, method), _fit_cols(got, ids, method))
    else:
        spots_t = jloc.get_spots(movie2, pd.DataFrame(ids), 7,
                                 dict(CAM2)).transpose(1, 2, 0)
        compare_lq_fits(_fit_cols(ref, ids, method),
                        _fit_cols(got, ids, method), spots_t)


@pytest.mark.parametrize("lazy", [False, True])
def test_localize_avg_matches_jax(movie2, tiff_series, lazy):
    from torch_parity import compare_avg_photons

    src = (tio.load_movie(tiff_series)[0], jio.load_movie(tiff_series)[0]) \
        if lazy else (movie2, movie2)
    info = _movie_info(movie2)
    ref, ref_info = jloc.localize(src[1], dict(CAM2), PARAMS, movie_info=info,
                                  fitting_method="avg", return_info=True)
    got, got_info = tloc.localize(src[0], dict(CAM2), PARAMS,
                                  movie_info=info, fitting_method="avg",
                                  return_info=True, device="cpu")
    assert got_info == ref_info
    ref = _by_position(ref.to_records(index=False))
    got = _by_position(got)
    assert got.dtype == ref.dtype and len(got) == len(ref) > 300
    for c in ("frame", "x", "y"):
        np.testing.assert_array_equal(got[c], ref[c])
    np.testing.assert_allclose(got["net_gradient"], ref["net_gradient"],
                               rtol=1e-5)
    ids = np.zeros(len(got), [("frame", np.int64), ("x", np.int64),
                              ("y", np.int64)])
    for c in ids.dtype.names:
        ids[c] = got[c]
    photons = jloc.get_spots(src[1], pd.DataFrame(ids), 7, dict(CAM2))
    compare_avg_photons(ref["photons"], got["photons"], photons)


def test_new_entry_points_need_the_card_or_cpu(movie2, tiff_series):
    """Without device="cpu" and without a card each entry point raises;
    none falls back to the CPU."""
    from picasso_torch import avgroi, stream, zfit
    from torch_data import CALIB_3D

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ids = tloc.identify(movie2[:2], MIN_NG, 7, device="cpu")
    info = _movie_info(movie2)
    calls = [
        lambda: tloc.identify(movie2, MIN_NG, 7),
        lambda: tloc.get_spots_raw(movie2, ids, 7),
        lambda: tloc.fit2D(movie2, info, dict(CAM2), ids, 7),
        lambda: tloc.localize(movie2, dict(CAM2), PARAMS,
                              fitting_method="avg"),
        lambda: tloc.localize_3D(movie2, movie_info=info,
                                 camera_info=dict(CAM2), box=7,
                                 minimum_ng=MIN_NG, calibration_3d=CALIB_3D),
        lambda: stream.identify_and_cut(tio.load_movie(tiff_series)[0],
                                        MIN_NG, 7),
        lambda: avgroi.fit_spots(np.zeros((2, 7, 7), np.float32)),
        lambda: zfit.fit_z_grid(np.ones(3), np.ones(3), CALIB_3D),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def _run_clis(tmp_path, movie, name, args, jax_args=None):
    """The port's CLI (--device cpu) and the JAX CLI on copies of one
    movie in two folders; returns the two folders."""
    from picasso_tpu import __main__ as jcli

    dirs = []
    for d in ("t", "j"):
        (tmp_path / d).mkdir(parents=True)
        if name.endswith(".raw"):
            jio.save_raw(str(tmp_path / d / name), movie, _movie_info(movie))
        else:
            from torch_data import write_tiff

            half = len(movie) // 2
            write_tiff(str(tmp_path / d / name), movie[:half])
            write_tiff(str(tmp_path / d / name.replace(".ome", "_1.ome")),
                       movie[half:])
        dirs.append(tmp_path / d)
    cli.main(["localize", str(dirs[0] / name), *args, "--device", "cpu"])
    jcli.main(["localize", str(dirs[1] / name),
               *(args if jax_args is None else jax_args)])
    return dirs


def _same_locs_files(t, j, base, tol_cols=()):
    t_rec = tio.load_locs(str(t / f"{base}.hdf5"))[0]
    j_rec = tio.load_locs(str(j / f"{base}.hdf5"))[0]
    assert t_rec.dtype == j_rec.dtype and len(t_rec) == len(j_rec) > 100
    t_rec, j_rec = _by_position(t_rec), _by_position(j_rec)
    tol_cols = {"net_gradient": dict(rtol=1e-5), **tol_cols}
    for c in t_rec.dtype.names:
        if c in tol_cols:
            np.testing.assert_allclose(t_rec[c], j_rec[c], **tol_cols[c],
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(t_rec[c], j_rec[c], err_msg=c)
    t_info = tio.load_info(str(t / f"{base}.hdf5"))
    j_info = tio.load_info(str(j / f"{base}.hdf5"))
    for block in t_info + j_info:
        block.pop("File", None)
    assert t_info == j_info
    return t_rec


def test_cli_tiff_series_mle_matches_the_jax_cli(tmp_path, movie2):
    """localize movie.ome.tif (two files) -a mle: rows, columns and info
    as the JAX CLI writes them, fits within compare_fits' bounds."""
    t, j = _run_clis(tmp_path, movie2, "m.ome.tif", ["-a", "mle", "-d", "0",
                                                     "-g", str(MIN_NG),
                                                     "-bl", "100"])
    xy = dict(rtol=0, atol=1e-3)
    _same_locs_files(t, j, "m.ome_locs", {
        "x": xy, "y": xy, "photons": dict(rtol=2e-3), "sx": xy, "sy": xy,
        "bg": dict(rtol=1e-2, atol=1e-2), "lpx": dict(rtol=2e-3),
        "lpy": dict(rtol=2e-3), "ellipticity": dict(rtol=0, atol=2e-3),
        "log_likelihood": dict(rtol=1e-3, atol=5e-2),
        "iterations": dict(rtol=0, atol=3), "photons_unc": dict(rtol=2e-3),
        "bg_unc": dict(rtol=2e-3), "sx_unc": dict(rtol=2e-3),
        "sy_unc": dict(rtol=2e-3)})


def test_cli_avg_and_3d_match_the_jax_cli(tmp_path):
    """-a avg and -a mle-3d -zc calib.yaml (an astigmatic movie, camera
    constants whose photon routes round differently): the same files as
    the JAX CLI's, avg photons within compare_avg_photons' bound, z
    within Z_DIFF_NM of the z fit's end-to-end agreement (equal where
    sx and sy are)."""
    import yaml

    from test_torch_zfit import Z_DIFF_NM
    from torch_data import CALIB_3D, make_astig_movie

    movie = make_astig_movie(32, 64, 20, 0.5,
                             np.random.default_rng(5))[0] + np.uint16(100)
    cam = ["-bl", "100", "-s", "0.45", "-ga", "7", "-g", str(MIN_NG)]
    t, j = _run_clis(tmp_path / "avg", movie, "x.raw",
                     ["-a", "avg", "-d", "0", *cam])
    _same_locs_files(t, j, "x_locs", {"photons": dict(rtol=1e-6),
                                      "bg": dict(rtol=1e-6),
                                      "lpx": dict(rtol=1e-5),
                                      "lpy": dict(rtol=1e-5)})
    calib = str(tmp_path / "calib.yaml")
    with open(calib, "w") as f:
        yaml.dump(CALIB_3D, f)
    t, j = _run_clis(tmp_path / "3d", movie, "x.raw",
                     ["-a", "mle-3d", "-zc", calib, "-d", "0", *cam])
    rel = dict(rtol=2e-3)
    xy = dict(rtol=0, atol=1e-3)
    rec = _same_locs_files(t, j, "x_locs", {
        "x": xy, "y": xy, "photons": rel, "sx": xy, "sy": xy,
        "bg": dict(rtol=1e-2, atol=1e-2), "lpx": rel, "lpy": rel,
        "ellipticity": dict(rtol=0, atol=2e-3),
        "log_likelihood": dict(rtol=1e-3, atol=5e-2),
        "iterations": dict(rtol=0, atol=3), "photons_unc": rel,
        "bg_unc": rel, "sx_unc": rel, "sy_unc": rel,
        "z": dict(rtol=0, atol=Z_DIFF_NM), "d_zcalib": dict(rtol=0, atol=1e-3),
        "lpz": dict(rtol=1e-3)})
    assert rec.dtype.names[-3:] == ("z", "d_zcalib", "lpz")


def test_cli_3d_undrift_keeps_z(tmp_path):
    """RCC after a 3D run (-d 16 on a 32-frame movie, two segments):
    _locs_undrift.hdf5 keeps z, d_zcalib and lpz of every loc."""
    import yaml

    from torch_data import CALIB_3D, make_astig_movie

    movie = make_astig_movie(32, 64, 20, 0.5, np.random.default_rng(6))[0]
    jio.save_raw(str(tmp_path / "x.raw"), movie, _movie_info(movie))
    with open(tmp_path / "calib.yaml", "w") as f:
        yaml.dump(CALIB_3D, f)
    cli.main(["localize", str(tmp_path / "x.raw"), "-a", "lq-3d", "-zc",
              str(tmp_path / "calib.yaml"), "-d", "16", "--device", "cpu"])
    locs = tio.load_locs(str(tmp_path / "x_locs.hdf5"))[0]
    und = tio.load_locs(str(tmp_path / "x_locs_undrift.hdf5"))[0]
    assert len(und) == len(locs) > 100
    for c in ("frame", "z", "d_zcalib", "lpz"):
        np.testing.assert_array_equal(und[c], locs[c])
