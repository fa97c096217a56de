"""The rest of the port's localize API held against picasso_tpu on the
CPU: the legacy identification API (identify_in_frame,
identify_by_frame_number, local_maxima, gradient_at, net_gradient,
picks_to_identifications, locs_to_identifications, identify_async and
identifications_from_futures), the legacy fit API (fit, fit_async,
locs_from_fits), the gaussmle and gausslq shims, cameras whose values
are arrays, and localize_fused's frame_chunk, abort_callback and perf.

Inputs: tests/torch_data.make_bench_movie(32, 64, 40, 0.5, rng(7)), the
movie of tests/test_torch_localize.py.

Tolerances:
- hit lists against JAX's within tests/torch_parity.compare_hits (equal
  but at near-threshold ties, net gradients within 1e-5 relative: another
  summation order), and equal to the port's own ``identify``;
- identifications of picks and locs, gradients, the legacy tables of the
  same fits, the shims and the photon conversion: equal (the same numpy
  code, or integer work);
- MLE fits: tests/torch_parity.compare_fits; LQ locs within LQ_XY px for
  LQ_SHARE of the spots (the bound of tests/test_torch_localize_lq.py,
  whose tight bounds need the ROIs); avg photons within
  compare_avg_photons;
- the legacy fit against fit2D of the same package: the relation of
  ROADMAP queue 3 (the x/y in-box offsets swapped, box // 2 added, sx/sy
  swapped) within OFFSET_ABS px, two f32 ulps at 64 px.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import gausslq as jlq
from picasso_tpu import gaussmle as jmle
from picasso_tpu import localize as jloc
from picasso_tpu.ops import fused as jfused
from picasso_torch import gausslq as tlq
from picasso_torch import gaussmle as tmle
from picasso_torch import localize as tloc
from picasso_torch.ops import fused as tfused
from picasso_torch.ops.identify import to_photons
from test_localize import _oracle_local_maxima, _oracle_net_gradient
from torch_data import make_bench_movie
from torch_native import loaded_native
from torch_parity import compare_avg_photons, compare_fits, compare_hits

CAMERA = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
MIN_NG = 4000
BOX = 7
PARAMS = {"Min. Net Gradient": MIN_NG, "Box Size": BOX}
OFFSET_ABS = 1e-5
LQ_XY, LQ_SHARE = 1e-3, 0.99


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


@pytest.fixture(scope="module")
def ids(movie):
    return tloc.identify(movie, MIN_NG, BOX, device="cpu")


def _info(movie):
    return [{"Byte Order": "<", "Data Type": "uint16",
             "Frames": movie.shape[0], "Height": movie.shape[1],
             "Width": movie.shape[2]}]


def _assert_table(got: np.ndarray, want: pd.DataFrame):
    want = want.to_records(index=False)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    for n in got.dtype.names:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def _assert_hits(got: np.ndarray, want: pd.DataFrame):
    want = want.to_records(index=False)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    compare_hits([want[c] for c in ("frame", "y", "x", "net_gradient")],
                 [got[c] for c in ("frame", "y", "x", "net_gradient")],
                 MIN_NG)


def _mle_fits(locs, order=None) -> tuple:
    """compare_fits' (theta, crlb, ll, iters) of a fit2D MLE table: theta
    (x, y, photons, bg, sx, sy), the CRLB diagonal from the columns'
    uncertainties."""
    if order is not None:
        locs = locs[order]
    theta = np.stack([locs[c] for c in ("x", "y", "photons", "bg", "sx",
                                        "sy")])
    crlb = np.stack([locs[c] for c in ("lpx", "lpy", "photons_unc", "bg_unc",
                                       "sx_unc", "sy_unc")]) ** 2
    return theta, crlb, locs["log_likelihood"], locs["iterations"]


# --- the legacy identification API ------------------------------------


@pytest.mark.parametrize("roi", [None, ((5, 9), (50, 60))])
def test_identify_in_frame_matches_jax(movie, ids, roi):
    for f in (0, 7):
        got = tloc.identify_in_frame(movie[f], MIN_NG, BOX, roi, device="cpu")
        want = jloc.identify_in_frame(movie[f], MIN_NG, BOX, roi)
        assert [a.dtype for a in got] == [b.dtype for b in want]
        zeros = np.zeros(len(got[0]), int), np.zeros(len(want[0]), int)
        compare_hits([zeros[1], *want], [zeros[0], *got], MIN_NG)
        if roi is None:
            rows = ids[ids["frame"] == f]
            np.testing.assert_array_equal(got[0], rows["y"])
            np.testing.assert_array_equal(got[1], rows["x"])
        assert len(got[0])


@pytest.mark.parametrize("bounds", [None, (2, 9), (None, 5), (3, None)])
def test_identify_by_frame_number_matches_jax(movie, ids, bounds):
    """Frames inside and outside the bounds (inclusive upper bound): the
    rows of identify for that frame, or none, in JAX's dtypes."""
    for f in (0, 4, 9, 12):
        got = tloc.identify_by_frame_number(movie, MIN_NG, BOX, f,
                                            frame_bounds=bounds,
                                            device="cpu")
        want = jloc.identify_by_frame_number(movie, MIN_NG, BOX, f,
                                             frame_bounds=bounds)
        _assert_hits(got, want)
        if len(got):
            np.testing.assert_array_equal(got, ids[ids["frame"] == f])
    roi = ((8, 8), (40, 56))
    _assert_hits(
        tloc.identify_by_frame_number(movie, MIN_NG, BOX, 3, roi=roi,
                                      device="cpu"),
        jloc.identify_by_frame_number(movie, MIN_NG, BOX, 3, roi=roi))
    empty = tloc.identify_by_frame_number(movie, MIN_NG, BOX, 20,
                                          frame_bounds=(0, 10), device="cpu")
    assert len(empty) == 0 and empty.dtype == ids.dtype


def test_local_maxima_matches_jax_and_the_oracle(movie):
    for f in (0, 5):
        frame = movie[f]
        got = tloc.local_maxima(frame, BOX, device="cpu")
        want = jloc.local_maxima(frame, BOX)
        oracle = _oracle_local_maxima(frame.astype(np.float32), BOX)
        for a, b, c in zip(got, want, oracle):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        # every maximum, below any threshold: more than the frame's hits
        assert len(got[0]) > 2 * len(tloc.identify_in_frame(
            frame, MIN_NG, BOX, device="cpu")[0])


def test_net_gradient_and_gradient_at_match_jax(movie):
    from picasso_torch.ops.identify import _unit_vector_masks

    frame = movie[3]
    y, x = tloc.local_maxima(frame, BOX, device="cpu")
    uy, ux = _unit_vector_masks(BOX)
    got = tloc.net_gradient(frame, y, x, BOX, uy, ux)
    want = jloc.net_gradient(frame, y, x, BOX, uy, ux)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, _oracle_net_gradient(frame, y, x, BOX),
                               rtol=1e-5, atol=1e-2)
    for yi, xi in zip(y[:20], x[:20]):
        assert tloc.gradient_at(frame, yi, xi, 0) == jloc.gradient_at(
            frame, yi, xi, 0)


@pytest.mark.parametrize("drifted", [False, True])
def test_picks_to_identifications_matches_jax(drifted):
    picks = [(10.3, 20.7), (30.5, 5.49), (2.5, 2.5)]
    rng = np.random.default_rng(1)
    drift = None
    if drifted:
        drift = np.zeros(12, [("x", np.float32), ("y", np.float32)])
        drift["x"], drift["y"] = rng.normal(0, 1.5, (2, 12))
    got = tloc.picks_to_identifications(picks, n_frames=None if drifted
                                        else 9, drift=drift)
    want = jloc.picks_to_identifications(
        picks, n_frames=None if drifted else 9,
        drift=None if drift is None else pd.DataFrame(drift))
    _assert_table(got, want)
    with pytest.raises(ValueError):
        tloc.picks_to_identifications(picks)


def test_locs_to_identifications_matches_jax(movie):
    """JAX's code as it is: a loc within n_frames of either end of the
    movie is dropped (ROADMAP queue 3), every kept loc spans 2 n + 1
    frames at its rounded pixel."""
    locs = tloc.localize(movie, dict(CAMERA), PARAMS, device="cpu",
                         fitting_method="gaussmle")
    info = _info(movie)
    for n in (0, 2, 5):
        got = tloc.locs_to_identifications(locs, info, n)
        want = jloc.locs_to_identifications(pd.DataFrame(locs), info, n)
        _assert_table(got, want)
        f = locs["frame"].astype(int)
        assert len(got) == (2 * n + 1) * np.sum((f > n) & (f < 32 - n))


def test_identify_async_and_futures_match_jax(movie, ids):
    current, futures = tloc.identify_async(movie, MIN_NG, BOX,
                                           frame_bounds=(2, 20), device="cpu")
    j_current, j_futures = jloc.identify_async(movie, MIN_NG, BOX,
                                               frame_bounds=(2, 20))
    assert current == j_current == [len(movie)]
    assert all(f.done() for f in futures)
    got = tloc.identifications_from_futures(futures)
    _assert_hits(got, jloc.identifications_from_futures(j_futures))
    np.testing.assert_array_equal(
        got, ids[(ids["frame"] >= 2) & (ids["frame"] <= 20)])
    # two futures out of frame order come back sorted stably by frame
    halves = [type(futures[0])(got[got["frame"] > 9]),
              type(futures[0])(got[got["frame"] <= 9])]
    np.testing.assert_array_equal(tloc.identifications_from_futures(halves),
                                  got)


def test_save_file_summary_is_the_alias(monkeypatch):
    rows = []
    monkeypatch.setattr(tloc, "_save_file_summary", rows.append)
    tloc.save_file_summary({"a": 1})
    assert rows == [{"a": 1}]


# --- the legacy fit API -------------------------------------------------


@pytest.fixture(scope="module")
def legacy_fits(movie, ids):
    sub = ids[:200]
    got = tloc.fit(movie, dict(CAMERA), sub, BOX, device="cpu")
    want = jloc.fit(movie, dict(CAMERA), pd.DataFrame(sub), BOX)
    return sub, got, want


def test_fit_matches_jax(legacy_fits):
    """The legacy table against JAX's: frames equal, the MLE fits within
    compare_fits (rows in hit order: JAX's quicksort may permute a
    frame's rows, its index keeps the hit order)."""
    sub, got, want = legacy_fits
    want = want.sort_index().to_records(index=False)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got["frame"], want["frame"])
    np.testing.assert_array_equal(got["net_gradient"], want["net_gradient"])

    def fits(t):
        theta = np.stack([t[c] for c in ("x", "y", "photons", "bg", "sx",
                                         "sy")])
        crlb = np.stack([t["lpx"] ** 2, t["lpy"] ** 2, *np.ones((4, len(t)))])
        return theta, crlb, t["likelihood"], t["iterations"]

    compare_fits(fits(want), fits(got), what="legacy fit vs JAX")


def test_locs_from_fits_matches_jax(ids):
    """The same fits through both legacy assemblies: equal tables."""
    sub = ids[:300]
    spots = tloc.get_spots(np.asarray(make_bench_movie(
        32, 64, 40, 0.5, np.random.default_rng(7))), sub, BOX, CAMERA,
        device="cpu")
    fits = tmle.gaussmle(spots, 1e-3, 100, device="cpu")
    got = tloc.locs_from_fits(sub, *fits, BOX)
    want = jloc.locs_from_fits(pd.DataFrame(sub), *fits, BOX)
    _assert_table(got, want.sort_index())


def test_fit_async_matches_fit(movie, ids, capsys):
    sub = ids[:50]
    out = tloc.fit_async(movie, dict(CAMERA), sub, BOX, device="cpu")
    assert "Deprecation warning" in capsys.readouterr().out
    assert out[0] == [50]
    spots = tloc.get_spots(movie, sub, BOX, CAMERA, device="cpu")
    for a, b in zip(out[1:], tmle.gaussmle(spots, 1e-3, 100, device="cpu")):
        np.testing.assert_array_equal(a, b)
    j_out = jloc.fit_async(movie, dict(CAMERA), pd.DataFrame(sub), BOX)
    assert j_out[0] == out[0]
    compare_fits([j_out[1].T, j_out[2].T, j_out[3], j_out[4]],
                 [out[1].T, out[2].T, out[3], out[4]])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_fit_relates_to_fit2d_by_the_known_offsets(movie, ids, legacy_fits,
                                                   package):
    """Both packages' legacy fit against their own fit2D on the same ids
    (ROADMAP queue 3): x = fit2D's y offset + x pixel + box // 2, y =
    fit2D's x offset + y pixel + box // 2, sx = fit2D's sy, sy = its
    sx."""
    sub, got, want = legacy_fits
    h = BOX // 2
    if package == "port":
        legacy = got
        ref, _ = tloc.fit2D(movie, _info(movie), dict(CAMERA), sub, BOX,
                            fitting_method="gaussmle", device="cpu")
        px = sub
    else:
        legacy = want.sort_index().to_records(index=False)
        ref, _ = jloc.fit2D(movie, _info(movie), dict(CAMERA),
                            pd.DataFrame(sub), BOX, fitting_method="gaussmle")
        ref = ref.sort_index().to_records(index=False)
        px = sub
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    np.testing.assert_allclose(
        f64(legacy["x"]), f64(ref["y"]) - px["y"] + px["x"] + h,
        rtol=0, atol=OFFSET_ABS)
    np.testing.assert_allclose(
        f64(legacy["y"]), f64(ref["x"]) - px["x"] + px["y"] + h,
        rtol=0, atol=OFFSET_ABS)
    np.testing.assert_array_equal(legacy["sx"], ref["sy"])
    np.testing.assert_array_equal(legacy["sy"], ref["sx"])
    np.testing.assert_array_equal(legacy["photons"], ref["photons"])
    # not a fit2D table: some locs lie more than a pixel apart
    assert np.abs(f64(legacy["x"]) - f64(ref["x"])).max() > 1


def test_gaussmle_and_gausslq_shims_match_jax(capsys):
    rng = np.random.default_rng(2)
    spot = rng.random((7, 7)) * 100
    for size in (5, 7):
        np.testing.assert_array_equal(
            tmle._mean_filter(spot[:size, :size], size),
            jmle._mean_filter(spot[:size, :size], size))
    np.testing.assert_array_equal(tmle.mean_filter(spot, 7),
                                  jmle.mean_filter(spot, 7))
    assert capsys.readouterr().out.count("mean_filter is deprecated") == 2
    spots = (rng.random((12, 7, 7)) * 50).astype(np.float32)
    got = tlq.initial_parameters_gpufit(spots, 7)
    want = jlq.initial_parameters_gpufit(spots, 7)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tlq._initial_parameters_gpufit(spots, 7),
                                  want)
    assert capsys.readouterr().out.count("Deprecation warning") == 2
    from torch_data import make_spots

    spots = make_spots(64, 7, seed=3)
    got = tmle.gaussmle_async(spots, 1e-3, 100, device="cpu")
    want = jmle.gaussmle_async(spots, 1e-3, 100)
    assert got[0] == want[0] == [64]
    compare_fits([want[1].T, want[2].T, want[3], want[4]],
                 [got[1].T, got[2].T, got[3], got[4]])


# --- cameras whose values are arrays ------------------------------------

ARRAY_CAMERA = {"Baseline": np.array(20), "Sensitivity": np.array(0.45),
                "Gain": np.array(1), "Pixelsize": 130}


@pytest.mark.parametrize("method", ["gaussmle", "gausslq", "avg"])
def test_localize_with_a_0d_camera_matches_jax(movie, ids, method):
    """0-d arrays take identify + fit2D with the ROIs converted on the
    host in both packages: the same ids, the info chain, and the fits
    within their tolerances."""
    t_locs, t_info = tloc.localize(movie, dict(ARRAY_CAMERA), PARAMS,
                                   movie_info=_info(movie),
                                   fitting_method=method, return_info=True,
                                   device="cpu")
    j_locs, j_info = jloc.localize(movie, dict(ARRAY_CAMERA), PARAMS,
                                   movie_info=_info(movie),
                                   fitting_method=method, return_info=True)
    assert t_info == j_info
    j_rec = j_locs.sort_index().to_records(index=False)
    assert t_locs.dtype == j_rec.dtype
    np.testing.assert_array_equal(t_locs["frame"], j_rec["frame"])
    np.testing.assert_allclose(t_locs["net_gradient"], j_rec["net_gradient"],
                               rtol=1e-5)
    if method == "gaussmle":
        compare_fits(_mle_fits(j_rec), _mle_fits(t_locs),
                     what="0-d camera MLE")
    elif method == "gausslq":
        d = np.maximum(np.abs(t_locs["x"] - j_rec["x"]),
                       np.abs(t_locs["y"] - j_rec["y"]))
        assert np.mean(d <= LQ_XY) >= LQ_SHARE
    else:
        np.testing.assert_array_equal(t_locs["x"], j_rec["x"])
        np.testing.assert_array_equal(t_locs["y"], j_rec["y"])
        spots = tloc.get_spots(movie, ids, BOX, ARRAY_CAMERA, device="cpu")
        compare_avg_photons(j_rec["photons"], t_locs["photons"], spots)


@pytest.mark.parametrize("method", ["gaussmle", "gausslq", "avg"])
def test_fit2d_with_a_0d_camera_matches_jax(movie, ids, method):
    sub = ids[:150]
    t_locs, t_info = tloc.fit2D(movie, _info(movie), dict(ARRAY_CAMERA), sub,
                                BOX, fitting_method=method, device="cpu")
    j_locs, j_info = jloc.fit2D(movie, _info(movie), dict(ARRAY_CAMERA),
                                pd.DataFrame(sub), BOX, fitting_method=method)
    assert t_info == j_info
    j_rec = j_locs.sort_index().to_records(index=False)
    assert t_locs.dtype == j_rec.dtype
    np.testing.assert_array_equal(t_locs["frame"], j_rec["frame"])
    if method == "gaussmle":
        compare_fits(_mle_fits(j_rec), _mle_fits(t_locs))
    elif method == "avg":
        spots = tloc.get_spots(movie, sub, BOX, ARRAY_CAMERA, device="cpu")
        compare_avg_photons(j_rec["photons"], t_locs["photons"], spots)
    else:
        d = np.maximum(np.abs(t_locs["x"] - j_rec["x"]),
                       np.abs(t_locs["y"] - j_rec["y"]))
        assert np.mean(d <= LQ_XY) >= LQ_SHARE


def test_get_spots_with_array_cameras_match_jax(movie, ids):
    """The host conversion with numpy's broadcasting: a 0-d camera (f64
    photons, as numpy promotes), a (box, box) map, and the scalar
    camera's one-factor conversion of a u16 array, each equal to JAX's."""
    sub = ids[:40]
    for cam in (ARRAY_CAMERA, dict(CAMERA, Baseline=np.full((BOX, BOX), 7.0)),
                dict(CAMERA, Sensitivity=0.45, Baseline=20)):
        got = tloc.get_spots(movie, sub, BOX, cam, device="cpu")
        want = jloc.get_spots(movie, pd.DataFrame(sub), BOX, cam)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    raw = tloc.get_spots_raw(movie, sub, BOX, device="cpu")
    np.testing.assert_array_equal(
        tloc.get_spots(movie, sub, BOX, ARRAY_CAMERA, device="cpu"),
        to_photons(raw, ARRAY_CAMERA))


def test_unit_0d_camera_equals_the_fused_slice(movie):
    """With the unit camera as 0-d arrays the MLE locs (identify + fit2D,
    host conversion) equal the scalar camera's fused slice bit for bit:
    both convert exactly."""
    unit = {k: np.array(v) for k, v in CAMERA.items()}
    a = tloc.localize(movie, unit, PARAMS, fitting_method="gaussmle",
                      device="cpu")
    b = tloc.localize(movie, dict(CAMERA), PARAMS, fitting_method="gaussmle",
                      device="cpu")
    assert a.dtype == b.dtype
    for c in a.dtype.names:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)


def test_a_camera_map_raises_as_in_jax(movie, ids):
    """A (H, W) map does not broadcast against the (N, box, box) ROIs:
    numpy's ValueError in both packages, from localize (every fitter)
    and fit2D."""
    per_pixel = dict(CAMERA, Baseline=np.zeros(movie.shape[1:]))
    for method in ("gaussmle", "avg"):
        for loc, kw in ((tloc, {"device": "cpu"}), (jloc, {})):
            with pytest.raises(ValueError, match="broadcast"):
                loc.localize(movie, dict(per_pixel), PARAMS,
                             fitting_method=method, **kw)
    with pytest.raises(ValueError, match="broadcast"):
        tloc.fit2D(movie, _info(movie), dict(per_pixel), ids[:10], BOX,
                   device="cpu")
    with pytest.raises(ValueError, match="broadcast"):
        jloc.fit2D(movie, _info(movie), dict(per_pixel),
                   pd.DataFrame(ids[:10]), BOX)


# --- localize_fused's arguments -----------------------------------------


@pytest.mark.parametrize("method", ["gaussmle", "gausslq"])
def test_frame_chunk_gives_the_same_locs(movie, method):
    """A given frame_chunk (and prefetch depth) gives the default's hits
    and fits bit for bit; perf has JAX's keys and chunk geometry."""
    perf = {}
    base = tfused.localize_fused(movie, MIN_NG, BOX, dict(CAMERA),
                                 fitting_method=method, device="cpu")
    got = tfused.localize_fused(movie, MIN_NG, BOX, dict(CAMERA),
                                fitting_method=method, frame_chunk=5,
                                prefetch_depth=1, perf=perf, device="cpu")
    np.testing.assert_array_equal(got[0], base[0])
    for a, b in zip(got[1], base[1]):
        np.testing.assert_array_equal(a, b)
    assert perf["n_chunks"] == 7 and perf["frame_chunk"] == 5


def test_perf_has_jaxs_keys(movie):
    j_perf, t_perf = {}, {}
    jfused.localize_fused(movie[:8], MIN_NG, BOX, dict(CAMERA), perf=j_perf)
    tfused.localize_fused(movie[:8], MIN_NG, BOX, dict(CAMERA), perf=t_perf,
                          device="cpu")
    assert list(t_perf) == list(j_perf) + ["upload_bytes"]
    assert t_perf["n_chunks"] == j_perf["n_chunks"] == 1
    assert t_perf["frame_chunk"] == j_perf["frame_chunk"] == 8
    parts = sum(t_perf[k] for k in ("decode_wait_s", "upload_dispatch_s",
                                    "chain_dispatch_s", "drain_s",
                                    "other_s"))
    assert abs(parts - t_perf["total_s"]) <= 0.003
    assert t_perf["chain_dispatch_s"] > 0
    p = {}
    locs = tloc.localize(movie[:8], dict(CAMERA), PARAMS, perf=p,
                         fitting_method="gaussmle", device="cpu")
    assert list(p) == list(t_perf) and len(locs)


def test_the_default_chunks_follow_jaxs_rule():
    """Round up to a multiple of 32 frames when there is more than one
    chunk (picasso_tpu/ops/fused.py:1190-1195)."""
    from picasso_torch.stream import frame_chunk_for

    for n, size in ((40, 64), (1000, 256), (2048, 256), (300, 2048),
                    (5, 512)):
        chunk = frame_chunk_for(n, size, size)
        base = tloc._id_frame_chunk(size, size)
        n_chunks = max(1, -(-n // base))
        want = -(-n // n_chunks)
        if n_chunks > 1:
            want = -(-want // 32) * 32
        assert chunk == want, (n, size)


def test_abort_callback_stops_the_chain(movie, monkeypatch):
    """abort_callback is polled before each chunk: (None, None) when it
    fires at the second, and localize returns None when the chain was
    aborted."""
    calls = []

    def abort():
        calls.append(1)
        return len(calls) >= 2

    assert tfused.localize_fused(movie, MIN_NG, BOX, dict(CAMERA),
                                 frame_chunk=8, abort_callback=abort,
                                 device="cpu") == (None, None)
    assert len(calls) == 2
    assert jfused.localize_fused(movie, MIN_NG, BOX, dict(CAMERA),
                                 frame_chunk=8,
                                 abort_callback=lambda: True) == (None, None)
    monkeypatch.setattr(tfused, "localize_fused",
                        lambda *a, **k: (None, None))
    assert tloc.localize(movie, dict(CAMERA), PARAMS,
                         fitting_method="gaussmle", device="cpu") is None


def test_legacy_entry_points_need_the_card(movie, ids):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    calls = [
        lambda: tloc.identify_in_frame(movie[0], MIN_NG, BOX),
        lambda: tloc.identify_by_frame_number(movie, MIN_NG, BOX, 0),
        lambda: tloc.local_maxima(movie[0], BOX),
        lambda: tloc.identify_async(movie, MIN_NG, BOX),
        lambda: tloc.fit(movie, dict(CAMERA), ids[:4], BOX),
        lambda: tloc.fit_async(movie, dict(CAMERA), ids[:4], BOX),
        lambda: tmle.gaussmle_async(np.ones((2, 7, 7)), 1e-3, 10),
        lambda: tloc.localize(movie, dict(ARRAY_CAMERA), PARAMS),
        lambda: tfused.localize_fused(movie, MIN_NG, BOX, dict(CAMERA),
                                      frame_chunk=8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
