"""The port's plain path held to picasso_tpu at boxes outside the
templated CUDA kernels' set: box 3 (where the MLE runs to max_it), an
even box (8) and the large boxes 17 and 21, on the CPU.

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
box, where compare_lq_fits holds only fits that stay in it).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

import picasso_tpu.gausslq as jq
import picasso_tpu.gaussmle as jg
from picasso_tpu import localize as jloc
from picasso_torch import gausslq as tq
from picasso_torch import gaussmle as tg
from picasso_torch import localize as tloc
from picasso_torch.ops import (
    identify, identify_cuda, lq_cuda, mle_cuda, winfit_cuda,
)
from picasso_torch.ops._fit_common import SHARED_LIMIT
from torch_data import make_bench_movie, make_spots, make_wide_movie
from torch_parity import (
    compare_fits, compare_fits_max_it, compare_hits, compare_lq_fits,
)

CAMERA = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
EPS = 1e-3
# max_it of the box-3 MLE comparisons (compare_fits_max_it)
BOX3_MAX_IT = 5
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
    if box == 3:
        return narrow_movie, BENCH_MIN_NG, 3
    return wide_movie, MIN_NG[17], 17


def _movie_info(movie):
    return [{"Byte Order": "<", "Data Type": "uint16",
             "Frames": movie.shape[0], "Height": movie.shape[1],
             "Width": movie.shape[2]}]


def _hold_mle(ref, got, box, max_it, what):
    """(theta, crlb, ll, iters) rows-first, by the box's comparison."""
    if box == 3:
        return compare_fits_max_it(ref, got, max_it, what)
    return compare_fits(ref, got, max_it, what)


@pytest.mark.parametrize("method", ["sigmaxy", "sigma"])
@pytest.mark.parametrize("box", [3, 8, 17, 21])
def test_gaussmle_matches_jax_at_any_box(box, method):
    spots = make_spots(96 if box == 21 else 256, box, seed=box)
    max_it = BOX3_MAX_IT if box == 3 else 100
    j = jg.gaussmle(spots, EPS, max_it, method)
    t = tg.gaussmle(spots, EPS, max_it, method, device="cpu")
    ref = [np.asarray(j[0]).T, np.asarray(j[1]).T, np.asarray(j[2]),
           np.asarray(j[3])]
    got = [t[0].T, t[1].T, t[2], t[3]]
    stats = _hold_mle(ref, got, box, max_it, f"box {box} {method}")
    if box != 3:
        assert stats["converged"] >= CONVERGED.get(box, 0.95)


@pytest.mark.parametrize("box", [3, 8, 17])
def test_gausslq_matches_jax_at_any_box(box):
    spots = make_spots(256, box, seed=box + 1)
    ref = np.asarray(jq.fit_spots(spots)).T
    got = tq.fit_spots(spots, device="cpu").T
    compare_lq_fits(ref, got, np.ascontiguousarray(spots.transpose(1, 2, 0)),
                    f"box {box}", box == 3)


@pytest.mark.parametrize("box", [3, 17, 21])
def test_identify_matches_jax_at_any_box(wide_movie, box):
    j = jloc.identify(wide_movie, MIN_NG[box], box)
    t = tloc.identify(wide_movie, MIN_NG[box], box, device="cpu")
    ref = [j[c].to_numpy() for c in ("frame", "y", "x", "net_gradient")]
    got = [t[c] for c in ("frame", "y", "x", "net_gradient")]
    assert len(ref[0]) >= 30
    compare_hits(ref, got, MIN_NG[box], f"box {box}")
    assert len(ref[0]) == len(got[0])


def _mle_fields(locs):
    """(theta, crlb, ll, iters) rows-first from an MLE locs table: x/y in
    the frame (both sides share the identifications), the CRLB from the
    uncertainties."""
    theta = np.stack([locs[c] for c in ("x", "y", "photons", "bg", "sx",
                                        "sy")])
    crlb = np.stack([locs[c] for c in ("lpx", "lpy", "photons_unc",
                                       "bg_unc", "sx_unc", "sy_unc")]) ** 2
    return theta, crlb, locs["log_likelihood"], locs["iterations"]


@pytest.mark.parametrize("fitting_method", ["gaussmle", "gausslq"])
@pytest.mark.parametrize("box", [3, 8, 17])
def test_fit2d_matches_jax_at_any_box(wide_movie, narrow_movie, box,
                                     fitting_method):
    """fit2D of the same identifications (at box 8 the port's at box 17,
    as picasso_tpu's identify raises at an even box), MLE sigmaxy or LQ;
    at an even box the ROIs start box // 2 before the centre on both
    sides (picasso_tpu's native cut)."""
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
    if fitting_method == "gaussmle":
        _hold_mle(_mle_fields(j), _mle_fields(t), box, max_it, f"box {box}")
        return
    # LQ theta with x/y relative to the identification, and the ROIs
    spots = tloc.get_spots(movie, ids, box, dict(CAMERA), device="cpu")
    assert spots.shape[1:] == (box, box)

    def theta(locs):
        return np.stack([locs["x"] - ids["x"], locs["y"] - ids["y"],
                         locs["photons"], locs["bg"], locs["sx"],
                         locs["sy"]]).astype(np.float32)

    compare_lq_fits(theta(j), theta(t),
                    np.ascontiguousarray(spots.transpose(1, 2, 0)),
                    f"box {box}", box == 3)


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


@pytest.mark.parametrize("box", [3, 8, 17])
def test_plain_versions_take_any_box(box):
    """The plain versions of the any-box kernels on the CPU: the K5 cut
    equals the gather route, and each fit wrapper is its plain fit,
    uncounted."""
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
    np.testing.assert_array_equal(rois, (sp - 1.5) * 0.8)
    fits = (mle_cuda.fit_anybox_t, mle_cuda.fit_anybox_one_pass_t,
            lq_cuda.fit_anybox_t, identify_cuda.identify_tiles_anybox,
            identify_cuda.identify_tiles_anybox_direct)
    counts = [f.launches for f in fits]
    for fit in (mle_cuda.fit_t, mle_cuda.fit_anybox_t,
                mle_cuda.fit_anybox_one_pass_t):
        a = fit(sp, EPS, 20)
        for x, y in zip(a, mle_cuda._mle._fit_core(sp, EPS, 20, "sigmaxy")):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(lq_cuda.fit_anybox_t(sp, 20),
                                  lq_cuda.fit_t(sp, 20))
    plain = identify.identify_tiles_plain(frames, 100.0, box)
    for k4 in (identify_cuda.identify_tiles_anybox,
               identify_cuda.identify_tiles_anybox_direct):
        for x, y in zip(k4(frames, 100.0, box), plain):
            np.testing.assert_array_equal(x, y)
    assert counts == [f.launches for f in fits]


@pytest.mark.parametrize("box", [*range(3, 66), 95, 96, 97, 101, 255, 363,
                                 364])
def test_anybox_launch_configurations(box):
    """The launch arguments of the any-box kernels at every box from 3 to
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
    fits, it has none and identify_tiles takes the direct kernel."""
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
