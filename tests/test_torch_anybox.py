"""The port's plain path held to picasso_tpu at boxes outside the
templated CUDA kernels' set: boxes 1 and 2, box 3 (where the MLE runs to
max_it), an even box (8) and the large boxes 17 and 21, on the CPU.

The JAX package fits any box > 0. On the card the port routes these
boxes to the any-box kernels (csrc/*_anybox.cu), held to the plain
versions checked here by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances (tests/torch_parity.py): MLE fits by compare_fits at boxes 8
and 17 (max_it 100); at box 3, where most fits never converge and their
f32 paths drift apart step by step, by compare_fits_max_it at max_it 5
(x/y by compare_fits' max_it branch; photons, bg, sx, sy, ll by their
p99; the CRLB is not held). LM fits by compare_lq_fits (at box 3 with
its box-3 bounds of the final cost's and bg's p99). Hit lists by
compare_hits. picasso_tpu's identify raises at an even box (its maps
come out (Y + 1, X + 1)), so box 8 is held in the fits, and in fit2D on
the port's identifications, not in identify or localize. fit2D and
localize take make_wide_movie's wide spots at 8 and 17 and the narrow
spots of make_bench_movie at 3 (a wide spot's LM widths leave a 3 x 3
box, where compare_lq_fits holds only fits that stay in it), and at 1
and 2 the identifications found at 3.

Boxes 1 and 2 (six parameters on one or four pixels): at box 1 the MLE
is held by compare_fits_max_it at max_it 5 and the LM bit for bit (no LM
step is finite there, so each fit is its initialiser; compare_lq_fits
holds only fits with widths in (0, box), and these have none). At box 2
f32 rounding alone leaves those bounds: the port's plain MLE (sigmaxy)
in f32 against the same fit in f64 is at rel p99 0.17 and x/y p99
9.9e-3 px at max_it 5, its LM at photons rel p99 2.0e-2, so box 2 is
held twice: the two packages' fits in f64 by compare_fits_max_it and
compare_lq_fits (their bounds unchanged: the same algebra, x/y within
7.6e-11 px), and the f32
fits through the public entries by compare_fits_rounding /
compare_lq_fits_rounding against picasso_tpu's fit in f64 (the port's
f32 fit no further from it than twice JAX's, or within the f32 bounds).
Identify raises at boxes 1 and 2 on both packages
(test_identify_refuses_boxes_1_and_2).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
import picasso_tpu.gausslq as jq
import picasso_tpu.gaussmle as jg
from picasso_tpu import localize as jloc
from picasso_tpu.ops import identify as jidentify
from picasso_tpu.ops import lq as jlq
from picasso_tpu.ops import mle as jmle
from picasso_torch import gausslq as tq
from picasso_torch import gaussmle as tg
from picasso_torch import localize as tloc
from picasso_torch.ops import (
    identify, identify_cuda, lq_cuda, mle_cuda, winfit_cuda,
)
from picasso_torch.ops._fit_common import SHARED_LIMIT
from torch_data import make_bench_movie, make_spots, make_wide_movie
from torch_native import loaded_native
from torch_parity import (
    LQ_SANE_ONE_SIDE, compare_avg_photons, compare_fits, compare_fits_max_it,
    compare_fits_rounding, compare_hits, compare_lq_fits,
    compare_lq_fits_rounding, lq_sane,
)

CAMERA = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
EPS = 1e-3
# max_it of the box-3 MLE comparisons (compare_fits_max_it), and of boxes
# 1 and 2
BOX3_MAX_IT = 5
# the boxes below identify's (picasso_tpu's identify raises there)
SMALL_BOXES = (1, 2)
# make_spots a box-2 fit is held on by the rounding comparisons: their
# bounds are tail statistics of the spread (x/y p99, the largest), whose
# ratio between two f32 fits settles with a few thousand spots
BOX2_SPOTS = 4096
# the LM's steps at which the two packages' box-2 fits in f64 are held by
# compare_lq_fits: the f64 cost has not yet fallen to ~0 (four pixels,
# six parameters: from 5 steps on its relative distance is one of two
# vanishing numbers)
BOX2_LQ_F64_IT = 3
# min. net gradient a box on make_wide_movie: its spots' ng is 550-990 at
# box 3 and ~11,000-11,800 at 17 and 21, the background maxima's below
# 250; on make_bench_movie at box 3 (fit2D, localize) the suite's 4000
MIN_NG = {3: 400, 17: 5000, 21: 5000}
# the least share of converged MLE fits of make_spots at a box (0.95
# elsewhere): in a 21 x 21 box 15-20% of its ~1 px spots' sigmaxy fits
# reach max_it 100 (80% of 96 and 85% of 256 converge; sigma all), and
# compare_fits holds those by its max_it branch
CONVERGED = {21: 0.75}
BENCH_MIN_NG = 4000


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
def wide_movie():
    """16 frames of 64 x 64 of wide spots (5 sites, ~40 spots)."""
    return make_wide_movie(16, 64, 5, 0.5, np.random.default_rng(23))


@pytest.fixture(scope="module")
def narrow_movie():
    """16 frames of 64 x 64 of make_bench_movie's 7 x 7 spots."""
    return make_bench_movie(16, 64, 40, 0.5, np.random.default_rng(7))


def _fit_movie(box, wide_movie, narrow_movie):
    """(movie, min. net gradient, identify box) of fit2D and localize."""
    if box <= 3:
        return narrow_movie, BENCH_MIN_NG, 3
    return wide_movie, MIN_NG[17], 17


def _movie_info(movie):
    return [{"Byte Order": "<", "Data Type": "uint16",
             "Frames": movie.shape[0], "Height": movie.shape[1],
             "Width": movie.shape[2]}]


def _hold_mle(ref, got, box, max_it, what, exact=None):
    """(theta, crlb, ll, iters) rows-first, by the box's comparison (at
    box 2 against ``exact``, picasso_tpu's fit in f64)."""
    if box == 2:
        return compare_fits_rounding(exact, ref, got, max_it, what)
    if box <= 3:
        return compare_fits_max_it(ref, got, max_it, what)
    return compare_fits(ref, got, max_it, what)


def _f64(spots_t) -> np.ndarray:
    return np.asarray(spots_t, np.float64)


def _jax_mle_f64(spots_t, max_it: int, method: str = "sigmaxy") -> list:
    """picasso_tpu's plain MLE (ops/mle._fit_core) of lanes-last spots in
    f64, numpy (theta, crlb, ll, iters)."""
    with jax.enable_x64():
        return [np.asarray(a) for a in jmle._fit_core(
            jnp.asarray(_f64(spots_t)), EPS, max_it, method)]


def _jax_lq_f64(spots_t, max_it: int = 30) -> np.ndarray:
    """picasso_tpu's plain LM (ops/lq._lm_core) of lanes-last spots in
    f64, theta (6, N)."""
    with jax.enable_x64():
        return np.asarray(jlq._lm_core(jnp.asarray(_f64(spots_t)), max_it,
                                       1e-6))


@pytest.mark.parametrize("method", ["sigmaxy", "sigma"])
@pytest.mark.parametrize("box", [1, 2, 3, 8, 17, 21])
def test_gaussmle_matches_jax_at_any_box(box, method):
    """gaussmle against picasso_tpu's. Boxes 1-3 at max_it 5 (box 1:
    every fit stops after one step, x/y equal, rel p99 2.1e-7, the CRLB
    NaN on both sides: one pixel's Fisher matrix is singular); at box 2
    the f32 fits by compare_fits_rounding against JAX's fit in f64
    (measured on these 4096 spots, JAX / the port against it: sigmaxy
    x/y p99 1.05e-2 / 9.9e-3 px, max 8.2 / 6.7 px, rel p99 0.33 / 0.17,
    iters equal 98.6% / 99.2% of spots; sigma x/y p99 7.5e-4 / 6.8e-4
    px), and the two packages' fits in f64 by compare_fits_max_it (x/y
    within 7.6e-11 px sigmaxy, 1.1e-12 sigma)."""
    n = {21: 96, 2: BOX2_SPOTS}.get(box, 256)
    spots = make_spots(n, box, seed=box)
    max_it = BOX3_MAX_IT if box <= 3 else 100
    j = jg.gaussmle(spots, EPS, max_it, method)
    t = tg.gaussmle(spots, EPS, max_it, method, device="cpu")
    ref = [np.asarray(j[0]).T, np.asarray(j[1]).T, np.asarray(j[2]),
           np.asarray(j[3])]
    got = [t[0].T, t[1].T, t[2], t[3]]
    exact = None
    if box == 2:
        spots_t = spots.transpose(1, 2, 0)
        exact = _jax_mle_f64(spots_t, max_it, method)
        compare_fits_max_it(exact, [a.numpy() for a in mle_cuda._mle._fit_core(
            torch.from_numpy(_f64(spots_t)), EPS, max_it, method)], max_it,
            f"box 2 {method} in f64")
    stats = _hold_mle(ref, got, box, max_it, f"box {box} {method}", exact)
    if box > 3:
        assert stats["converged"] >= CONVERGED.get(box, 0.95)


def _fold_widths(theta: np.ndarray) -> np.ndarray:
    """theta with the widths of each fit whose sx and sy are both negative
    made positive: the LQ model, photons * gx * gy + bg with each axis
    factor divided by its width, is the same at (-sx, -sy), a fit the LM
    reaches on wide boxes."""
    theta = np.array(theta, copy=True)
    both = (theta[4] < 0) & (theta[5] < 0)
    theta[4:, both] *= -1
    return theta


# the box at which the LM leaves the box on a share of make_spots, and its
# spots
WIDE_LQ_BOX, WIDE_LQ_SPOTS = 45, 32


def _hold_lq(ref, got, spots_t, box, what, exact=None):
    """LQ theta (6, N) by the box's comparison: at box 1 bit for bit
    (each fit is its initialiser, widths 0), at box 2 against ``exact``,
    picasso_tpu's fit in f64."""
    if box == 1:
        np.testing.assert_array_equal(got, ref)
        assert not lq_sane(ref, box).any()
        return None
    if box == 2:
        return compare_lq_fits_rounding(exact, ref, got, spots_t, what)
    return compare_lq_fits(ref, got, spots_t, what, box == 3)


@pytest.mark.parametrize("box", [1, 2, 3, 8, 16, 17, WIDE_LQ_BOX])
def test_gausslq_matches_jax_at_any_box(box):
    """The plain LM fit, which the card's any-box LM kernels are held to
    bit for bit there, against JAX's on the CPU. At box 45 both packages'
    LM ends 2 of these 32 spots far outside the box (|x| of hundreds to
    thousands of pixels) and others at negated widths (the same model:
    :func:`_fold_widths`), so compare_lq_fits' share of sane fits
    cannot hold over all spots there: the widths are folded on both
    sides, both packages must leave the box on the same spots, at most
    an eighth of them, and compare_lq_fits (its bounds unchanged) holds
    the spots both keep in the box. At box 1 the single pixel gives the
    initialiser widths of 0, every LM step is non-finite and dropped, and
    the fits are equal bit for bit. At box 2 the f32 fits by
    compare_lq_fits_rounding against JAX's in f64 (measured on these
    4096 spots, JAX / the port against it: x/y p99 3.6e-3 / 5.5e-3 px,
    photons rel p99 1.4e-2 / 2.0e-2, sx 2.9e-2 / 4.9e-2, 97.9% of fits
    sane on both sides), and the two packages' fits in f64 at
    BOX2_LQ_F64_IT steps by compare_lq_fits on the spots both keep in
    the box (98.2% of them; as at box 45 the spots that leave it are
    held, here to compare_lq_fits' share sane on one side only, 1 of the
    4096): x/y within 1.7e-11 px, cost rel p99 2.1e-10."""
    wide = box == WIDE_LQ_BOX
    n = {WIDE_LQ_BOX: WIDE_LQ_SPOTS, 2: BOX2_SPOTS}.get(box, 256)
    spots = make_spots(n, box, seed=box + 1)
    spots_t = np.ascontiguousarray(spots.transpose(1, 2, 0))
    ref = np.asarray(jq.fit_spots(spots)).T
    got = tq.fit_spots(spots, device="cpu").T
    if box in SMALL_BOXES:
        exact = None
        if box == 2:
            exact = _jax_lq_f64(spots_t)
            f64_ref = _jax_lq_f64(spots_t, BOX2_LQ_F64_IT)
            f64_got = lq_cuda._lq._lm_core(torch.from_numpy(_f64(spots_t)),
                                           BOX2_LQ_F64_IT, 1e-6).numpy()
            sane = lq_sane(f64_ref, box), lq_sane(f64_got, box)
            assert np.mean(sane[0] ^ sane[1]) <= LQ_SANE_ONE_SIDE
            inside = sane[0] & sane[1]
            assert inside.mean() >= 7 / 8
            compare_lq_fits(f64_ref[:, inside], f64_got[:, inside],
                            spots_t[..., inside], "box 2 in f64", True)
        _hold_lq(ref, got, _f64(spots_t), box, f"box {box}", exact)
        return
    if wide:
        ref, got = _fold_widths(ref), _fold_widths(got)
        inside = lq_sane(ref, box)
        np.testing.assert_array_equal(lq_sane(got, box), inside)
        assert inside.mean() >= 7 / 8
        ref, got, spots_t = ref[:, inside], got[:, inside], spots_t[...,
                                                                    inside]
    compare_lq_fits(ref, got, spots_t, f"box {box}", box == 3)


@pytest.mark.parametrize("box", [3, 17, 21])
def test_identify_matches_jax_at_any_box(wide_movie, box):
    j = jloc.identify(wide_movie, MIN_NG[box], box)
    t = tloc.identify(wide_movie, MIN_NG[box], box, device="cpu")
    ref = [j[c].to_numpy() for c in ("frame", "y", "x", "net_gradient")]
    got = [t[c] for c in ("frame", "y", "x", "net_gradient")]
    assert len(ref[0]) >= 30
    compare_hits(ref, got, MIN_NG[box], f"box {box}")
    assert len(ref[0]) == len(got[0])


@pytest.mark.parametrize("box", SMALL_BOXES)
def test_identify_refuses_boxes_1_and_2(narrow_movie, box):
    """Identify below box 3: picasso_tpu's raises a TypeError (its box-1
    maxima come out (B, 0, 0), its box-2 net gradient (B, Y + 1, X + 1)),
    the port's a ValueError, at each entry point, on the CPU as on the
    card (tests/test_torch_cuda.py); where JAX's returns without
    identifying (no frame within the bounds) so does the port's, and
    local_maxima and identify_maps, which read only the maxima at box 2,
    give JAX's maxima there and raise at box 1 as JAX's do."""
    movie = narrow_movie[:4]
    frame = movie[1]
    calls = {
        "identify": (lambda m: m.identify(movie, BENCH_MIN_NG, box),
                     lambda m: m.identify(movie, BENCH_MIN_NG, box,
                                          device="cpu")),
        "identify_in_image": (
            lambda m: m.identify_in_image(frame, BENCH_MIN_NG, box),
            lambda m: m.identify_in_image(frame, BENCH_MIN_NG, box,
                                          device="cpu")),
        "identify_in_frame": (
            lambda m: m.identify_in_frame(frame, BENCH_MIN_NG, box,
                                          ((4, 4), (40, 48))),
            lambda m: m.identify_in_frame(frame, BENCH_MIN_NG, box,
                                          ((4, 4), (40, 48)), device="cpu")),
        "identify_by_frame_number": (
            lambda m: m.identify_by_frame_number(movie, BENCH_MIN_NG, box, 1),
            lambda m: m.identify_by_frame_number(movie, BENCH_MIN_NG, box, 1,
                                                 device="cpu")),
        "identify_async": (
            lambda m: m.identify_async(movie, BENCH_MIN_NG, box),
            lambda m: m.identify_async(movie, BENCH_MIN_NG, box,
                                       device="cpu")),
    }
    for name, (j, t) in calls.items():
        with pytest.raises(TypeError):
            j(jloc)
        with pytest.raises(ValueError, match="boxes >= 3"):
            t(tloc)
    frames = torch.from_numpy(movie.astype(np.float32))
    with pytest.raises(ValueError, match="boxes >= 3"):
        identify.identify_tiles_plain(frames, BENCH_MIN_NG, box)
    with pytest.raises(TypeError):
        jidentify.identify_frames(movie, BENCH_MIN_NG, box)
    # no frame within the bounds: neither package identifies, neither
    # raises
    assert len(jloc.identify(movie, BENCH_MIN_NG, box,
                             frame_bounds=(10, 20))) == 0
    assert len(tloc.identify(movie, BENCH_MIN_NG, box, frame_bounds=(10, 20),
                             device="cpu")) == 0
    assert len(jloc.identify_by_frame_number(
        movie, BENCH_MIN_NG, box, 3, frame_bounds=(0, 1))) == 0
    assert len(tloc.identify_by_frame_number(
        movie, BENCH_MIN_NG, box, 3, frame_bounds=(0, 1), device="cpu")) == 0
    # the maxima alone
    if box == 1:
        with pytest.raises(TypeError):
            jloc.local_maxima(frame, box)
        with pytest.raises(ValueError, match="boxes >= 2"):
            tloc.local_maxima(frame, box, device="cpu")
        with pytest.raises(ValueError, match="boxes >= 2"):
            identify.identify_maps(frames, box)
        return
    ref = jloc.local_maxima(frame, box)
    got = tloc.local_maxima(frame, box, device="cpu")
    assert len(ref[0]) > 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        identify.identify_maps(frames, box)[0].numpy(),
        np.asarray(jidentify.identify_maps(jnp.asarray(frames.numpy()),
                                           box)[0]))


def _mle_fields(locs):
    """(theta, crlb, ll, iters) rows-first from an MLE locs table: x/y in
    the frame (both sides share the identifications), the CRLB from the
    uncertainties."""
    theta = np.stack([locs[c] for c in ("x", "y", "photons", "bg", "sx",
                                        "sy")])
    crlb = np.stack([locs[c] for c in ("lpx", "lpy", "photons_unc",
                                       "bg_unc", "sx_unc", "sy_unc")]) ** 2
    return theta, crlb, locs["log_likelihood"], locs["iterations"]


@pytest.mark.parametrize("fitting_method", ["gaussmle", "gausslq", "avg"])
@pytest.mark.parametrize("box", [1, 2, 3, 8, 17])
def test_fit2d_matches_jax_at_any_box(wide_movie, narrow_movie, box,
                                     fitting_method):
    """fit2D of the same identifications (at box 8 the port's at box 17,
    at boxes 1 and 2 those at 3, as picasso_tpu's identify raises at an
    even box and below 3), MLE sigmaxy, LQ or avg; at an even box the
    ROIs start box // 2 before the centre on both sides (picasso_tpu's
    native cut). Boxes 1-3 as in test_gaussmle_matches_jax_at_any_box and
    test_gausslq_matches_jax_at_any_box, box 2 against JAX's fit of the
    ROIs in f64 (on these 296 ROIs, JAX / the port against it: MLE x/y
    p99 3.3e-3 / 3.2e-3 px, LQ x/y p99 5.9e-4 / 1.0e-3 px, sx rel p99
    3.5e-3 / 6.5e-3); avg photons
    within compare_avg_photons and its other columns equal."""
    movie, min_ng, find = _fit_movie(box, wide_movie, narrow_movie)
    found = tloc.identify(movie, min_ng, find, device="cpu")
    # an n_id a row: both sides' locs then come in the rows' order
    ids = np.empty(len(found), found.dtype.descr + [("n_id", "<u4")])
    for name in found.dtype.names:
        ids[name] = found[name]
    ids["n_id"] = np.arange(len(found))
    max_it = BOX3_MAX_IT if box == 3 else 100
    kw = dict(fitting_method=fitting_method, max_it=max_it)
    j, _ = jloc.fit2D(movie, _movie_info(movie), dict(CAMERA),
                      pd.DataFrame(ids), box, **kw)
    t, _ = tloc.fit2D(movie, _movie_info(movie), dict(CAMERA), ids, box,
                      device="cpu", **kw)
    j = j.to_records(index=False)
    assert len(t) == len(j) == len(ids) >= 30
    np.testing.assert_array_equal(t["frame"], j["frame"])
    # the ROIs, and x/y relative to the identification (the box centre)
    spots = tloc.get_spots(movie, ids, box, dict(CAMERA), device="cpu")
    assert spots.shape[1:] == (box, box)
    spots_t = np.ascontiguousarray(spots.transpose(1, 2, 0))
    if fitting_method == "avg":
        compare_avg_photons(j["photons"], t["photons"], spots)
        for c in ("x", "y", "sx", "sy"):
            np.testing.assert_array_equal(t[c], j[c])
        return
    if fitting_method == "gaussmle":
        exact = None
        if box == 2:  # in the locs' fields: x/y in the frame
            th, cr, ll, it = _jax_mle_f64(spots_t, max_it)
            th = th.copy()
            th[0] += ids["x"] - box // 2
            th[1] += ids["y"] - box // 2
            exact = [th, cr, ll, it]
        _hold_mle(_mle_fields(j), _mle_fields(t), box, max_it, f"box {box}",
                  exact)
        return

    def theta(locs):
        return np.stack([locs["x"] - ids["x"], locs["y"] - ids["y"],
                         locs["photons"], locs["bg"], locs["sx"],
                         locs["sy"]]).astype(np.float32)

    if box in SMALL_BOXES:
        _hold_lq(theta(j), theta(t), _f64(spots_t), box, f"box {box}",
                 _jax_lq_f64(spots_t) if box == 2 else None)
        return
    compare_lq_fits(theta(j), theta(t), spots_t, f"box {box}", box == 3)


def _by_position(locs: np.ndarray) -> np.ndarray:
    return locs[np.lexsort((locs["x"], locs["y"], locs["frame"]))]


@pytest.mark.parametrize("box", [3, 17])
def test_localize_slice_matches_jax_at_any_box(wide_movie, narrow_movie,
                                               box):
    """localize (MLE sigmaxy, the fused chain)."""
    movie, min_ng, _ = _fit_movie(box, wide_movie, narrow_movie)
    params = {"Min. Net Gradient": min_ng, "Box Size": box}
    max_it = BOX3_MAX_IT if box == 3 else 100
    kw = dict(movie_info=_movie_info(movie), fitting_method="gaussmle",
              max_it=max_it)
    j = jloc.localize(movie, dict(CAMERA), params, **kw)
    t = tloc.localize(movie, dict(CAMERA), params, device="cpu", **kw)
    j = _by_position(j.to_records(index=False))
    t = _by_position(t)
    assert len(t) == len(j) >= 30
    np.testing.assert_array_equal(t["frame"], j["frame"])
    _hold_mle(_mle_fields(j), _mle_fields(t), box, max_it, f"box {box}")


@pytest.mark.parametrize("box", [1, 2, 3, 8, 17])
def test_plain_versions_take_any_box(box):
    """The plain versions of the any-box kernels on the CPU: the K5 cut
    equals the gather route, and each fit wrapper is its plain fit,
    uncounted; K4's plain version and wrappers raise at boxes 1 and 2,
    as picasso_tpu's identify does."""
    spots = make_spots(64, box, seed=7)
    sp = torch.from_numpy(np.ascontiguousarray(spots.transpose(1, 2, 0)))
    # each spot a frame (one pixel wider at an even box, which the centre
    # clamp needs), its window the spot
    f = torch.arange(64)
    c = torch.full((64,), box // 2)
    w = 2 * (box // 2) + 1
    frames = torch.zeros((64, w, w))
    frames[:, :box, :box] = torch.from_numpy(spots)
    rois = winfit_cuda.cut_anybox_t(frames, f, c, c, box, 1.5, 0.8)
    np.testing.assert_array_equal(
        rois, winfit_cuda.photons_t(frames, f, c, c, box, 1.5, 0.8))
    np.testing.assert_array_equal(
        rois, winfit_cuda.cut_anybox_direct_t(frames, f, c, c, box, 1.5, 0.8))
    np.testing.assert_array_equal(rois, (sp - 1.5) * 0.8)
    fits = (mle_cuda.fit_anybox_t, mle_cuda.fit_anybox_one_pass_t,
            lq_cuda.fit_anybox_t, lq_cuda.fit_anybox_one_pass_t,
            winfit_cuda.cut_anybox_t, winfit_cuda.cut_anybox_direct_t,
            identify_cuda.identify_tiles_anybox,
            identify_cuda.identify_tiles_anybox_direct)
    counts = [f.launches for f in fits]
    for fit in (mle_cuda.fit_t, mle_cuda.fit_anybox_t,
                mle_cuda.fit_anybox_one_pass_t):
        a = fit(sp, EPS, 20)
        for x, y in zip(a, mle_cuda._mle._fit_core(sp, EPS, 20, "sigmaxy")):
            np.testing.assert_array_equal(x, y)
    for fit in (lq_cuda.fit_anybox_t, lq_cuda.fit_anybox_one_pass_t):
        np.testing.assert_array_equal(fit(sp, 20), lq_cuda.fit_t(sp, 20))
    k4s = (identify_cuda.identify_tiles_anybox,
           identify_cuda.identify_tiles_anybox_direct)
    if box < identify.MIN_BOX:
        for k4 in (identify.identify_tiles_plain, *k4s):
            with pytest.raises(ValueError, match="boxes >= 3"):
                k4(frames, 100.0, box)
    else:
        plain = identify.identify_tiles_plain(frames, 100.0, box)
        for k4 in k4s:
            for x, y in zip(k4(frames, 100.0, box), plain):
                np.testing.assert_array_equal(x, y)
    assert counts == [f.launches for f in fits]


@pytest.mark.parametrize("box", [*range(1, 66), 95, 96, 97, 101, 255, 363,
                                 364])
def test_anybox_launch_configurations(box):
    """The launch arguments of the any-box kernels at every box from 1 to
    65 and at large boxes, from their pure-Python choosers: the MLE
    queue's (ops/mle_cuda.anybox_queue_config) and K4's output tile
    (ops/identify_cuda.anybox_tile_shape). A block's shared bytes stay
    within the 232,448 a block may hold; the queue's threads are a
    multiple of 32; the cooperative group is a power of two of 8 to 32
    lanes, >= box + 1, else a whole warp that loops over ceil(box / 32)
    rounds; the slots read the pixels from a stage in shared memory
    while one warp's fits (box <= 41), else from the batch; the column
    factors sit in shared memory where they fit beside it (all boxes
    but 40, 41 and those above 363). K4 takes ANYBOX_TILE where two
    blocks of it fit a SM, else its longer side halved until they do
    (one block where no tile of two fits); from box 96, where no tile
    fits, it has none and identify_tiles takes the direct kernel (K4 from
    box 3, the least identify takes)."""
    limit = SHARED_LIMIT
    assert mle_cuda.ANYBOX_THREADS % 32 == 0
    cfg = mle_cuda.anybox_queue_config(box)
    assert cfg["shared_bytes"] == mle_cuda.anybox_queue_smem(
        box, cfg["stage"], cfg["cols_shared"]) <= limit
    g = cfg["group"]
    assert g in (8, 16, 32)
    assert g >= box + 1 or (g == 32 and cfg["rounds"] == -(-box // 32))
    assert g == min(x for x in (8, 16, 32, 64) if x >= min(box + 1, 32))
    assert cfg["stage"] == ("shared" if box <= 41 else "batch")
    assert cfg["cols_shared"] == (box < 40 or 42 <= box <= 363)
    # the other place of the column factors passes the limit, or is the
    # global scratch
    assert not cfg["cols_shared"] or mle_cuda.anybox_queue_smem(
        box, cfg["stage"], False) < cfg["shared_bytes"]
    if box < identify.MIN_BOX:
        return
    assert identify_cuda.anybox_tile_fits(box) == (box < 96)
    if box >= 96:
        with pytest.raises(ValueError, match="no tile"):
            identify_cuda.anybox_tile_shape(box)
        return
    oy, ox = identify_cuda.anybox_tile_shape(box)
    assert ox in (32, 64, 128, 256) and oy >= 1
    budget = limit // 2
    if identify_cuda.anybox_tile_bytes(box, 1, 32) > budget:
        budget = limit
    assert identify_cuda.anybox_tile_bytes(box, oy, ox) <= budget
    toy, tox = identify_cuda.ANYBOX_TILE
    assert (oy, ox) == (toy, tox) or (
        identify_cuda.anybox_tile_bytes(box, toy, tox) > budget)
    assert oy <= toy and ox <= tox


@pytest.mark.parametrize("box", [*range(1, 66), 95, 96, 97, 101, 117, 118,
                                 255, 363, 364])
def test_lq_queue_and_cut_launch_configurations(box):
    """The launch arguments of the any-box LM queue
    (ops/lq_cuda.anybox_queue_config) and of the tiled cut
    (ops/winfit_cuda.anybox_cut_config) at every box from 1 to 65 and at
    large boxes, from their pure-Python choosers. The LM queue's group
    is ANYBOX_GROUP (8) lanes, whose lanes loop over ceil(box / 8)
    rounds (the group, and the claim of all a warp's free groups
    together, are compile-time constants of csrc/lq_anybox_queue.cu); a
    group
    reads its pixels from a stage in shared memory while a warp's groups'
    areas fit (box <= 117), else from the batch; its threads are the most
    of 128, 64 and 32 (at least one warp) whose areas fit, and a block's
    shared bytes stay within the 232,448 a block may hold. The cut takes
    32 hits a tile and bands of equal rows whose [pixel][hit] band fits a
    third of that, so that three blocks share an SM, with fewer hits only
    where a row of 32 does not fit."""
    cfg = lq_cuda.anybox_queue_config(box)
    g = cfg["group"]
    assert g == lq_cuda.ANYBOX_GROUP == 8
    assert set(cfg) == {"stage", "threads", "shared_bytes", "group",
                        "rounds"}
    assert cfg["rounds"] == -(-box // g)
    assert cfg["stage"] == ("shared" if box <= 117 else "batch")
    assert cfg["threads"] in lq_cuda.ANYBOX_THREADS
    assert cfg["threads"] % 32 == 0
    assert cfg["shared_bytes"] == lq_cuda.anybox_queue_smem(
        box, cfg["stage"], cfg["threads"]) <= SHARED_LIMIT
    area = lq_cuda.anybox_area(box, cfg["stage"])
    assert area == 7 * box + (box * (box | 1) if box <= 117 else 0)
    assert cfg["shared_bytes"] == 4 * area * cfg["threads"] // g
    more = [t for t in lq_cuda.ANYBOX_THREADS if t > cfg["threads"]]
    assert all(lq_cuda.anybox_queue_smem(box, cfg["stage"], t) >
               SHARED_LIMIT for t in more)
    if cfg["stage"] == "batch":
        assert lq_cuda.anybox_queue_smem(box, "shared", 32) > SHARED_LIMIT
    cut = winfit_cuda.anybox_cut_config(box)
    assert cut["hits"] == 32  # up to box 586
    assert cut["shared_bytes"] == winfit_cuda.anybox_cut_smem(
        box, 32, cut["rows"]) <= winfit_cuda.CUT_SHARED <= SHARED_LIMIT
    assert 1 <= cut["rows"] <= box
    assert cut["bands"] == -(-box // cut["rows"])
    assert cut["rows"] * (cut["bands"] - 1) < box
    if cut["bands"] > 1:  # the fewest bands whose rows fit
        rows = -(-box // (cut["bands"] - 1))
        assert winfit_cuda.anybox_cut_smem(box, 32, rows) > \
            winfit_cuda.CUT_SHARED
    assert (cut["bands"] == 1) == (box <= 24)


def test_the_cut_reads_the_hit_rows_in_place():
    """The any-box cut's hit rows (winfit_cuda._hit_rows): int64 rows go
    to the kernel as they are, strides included (the rows of an (N, 3)
    torch.nonzero list are views of stride 3; an expanded row has stride
    0), with no stack or cast before the launch; other integers become
    int64; rows of unequal length, a box below 1 and a frame narrower
    than the box raise."""
    frames = torch.zeros((4, 32, 32), dtype=torch.uint16)
    hits = torch.tensor([[0, 10, 12], [3, 20, 5], [1, 16, 16]])
    rows = hits.unbind(1)
    got = winfit_cuda._hit_rows(frames, *rows, 17)
    for g, r in zip(got, rows):
        assert g.dtype == torch.int64 and g.stride(0) == 3
        assert g.data_ptr() == r.data_ptr()
    zero = torch.zeros(1, dtype=torch.int64).expand(3)
    assert winfit_cuda._hit_rows(frames, zero, *rows[1:], 17)[0].stride(0) \
        == 0
    small = winfit_cuda._hit_rows(frames, *(r.to(torch.int32) for r in rows),
                                  17)
    assert all(g.dtype == torch.int64 for g in small)
    assert all(torch.equal(g, r) for g, r in zip(small, rows))
    with pytest.raises(ValueError, match="one length"):
        winfit_cuda._hit_rows(frames, rows[0][:2], *rows[1:], 17)
    with pytest.raises(ValueError, match="boxes >= 1"):
        winfit_cuda._hit_rows(frames, *rows, 0)
    for box in (1, 2):  # the fits take every box
        assert len(winfit_cuda._hit_rows(frames, *rows, box)) == 3
    with pytest.raises(ValueError, match="smaller than the box"):
        winfit_cuda._hit_rows(frames, *rows, 33)


@pytest.mark.parametrize("box", [587, 1140, 2152, 2153])
def test_the_cut_takes_fewer_hits_where_a_row_of_32_does_not_fit(box):
    """From box 587 a row of 32 hits passes the cut's shared budget and the
    tile takes 16 (from 1140, 8: a 32-B sector a store); from box 2153 no
    tile fits and the chooser raises, as the LM queue's does from box 2076
    (a warp's factor rows)."""
    if box == 2153:
        with pytest.raises(ValueError, match="no tile"):
            winfit_cuda.anybox_cut_config(box)
        with pytest.raises(ValueError, match="factor rows"):
            lq_cuda.anybox_queue_config(2076)
        assert lq_cuda.anybox_queue_config(2075)["threads"] == 32
        return
    cut = winfit_cuda.anybox_cut_config(box)
    assert cut["rows"] == 1 and cut["bands"] == box
    assert cut["hits"] == (16 if box < 1140 else 8)
    assert winfit_cuda.anybox_cut_smem(box, 2 * cut["hits"], 1) > \
        winfit_cuda.CUT_SHARED
