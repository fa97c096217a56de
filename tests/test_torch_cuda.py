"""The CUDA kernels of picasso_torch against their plain PyTorch versions
on the card, at small shapes. Marked ``cuda``: they skip where no card
is visible.

This file imports no JAX (the machine with the card has none), so run it
without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: tests/torch_parity.py; chip_smoke.py repeats these checks
at the main path's full shapes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_data import (
    K4_SHAPES, make_bench_movie, make_spots, small_frames, spots_chunk,
)
from picasso_torch import imageprocess, localize, postprocess
from picasso_torch.ops import (
    fused, identify, identify_cuda, lq, lq_cuda, mle, mle_cuda, winfit_cuda,
)
from torch_parity import (
    compare_fits, compare_fits_max_it, compare_fits_rounding, compare_hits,
    compare_lq_fits, compare_lq_fits_rounding, compare_tiles,
)

pytestmark = pytest.mark.cuda
EPS, MAX_IT, FTOL = 1e-3, 100, 1e-6
BASELINE, FACTOR = 1.5, 0.8
# boxes 1 and 2 (below identify's 3): the MLE held at SMALL_MAX_IT (as
# box 3), the LM at fit2D's max_it, on SMALL_SPOTS spots (the rounding
# comparisons' tail statistics settle with a few thousand)
SMALL_MAX_IT, SMALL_LQ_IT, SMALL_SPOTS = 5, 30, 8192


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _np(out):
    return [a.cpu().numpy() for a in out]


@pytest.mark.parametrize("box", [5, 7, 9, 11, 13, 15])
def test_fit_kernel_matches_plain(dev, box):
    sp = torch.from_numpy(np.ascontiguousarray(
        make_spots(4096, box, seed=box).transpose(1, 2, 0)
    )).to(dev)
    plain = _np(mle._fit_core(sp, EPS, MAX_IT))
    k1 = _np(mle_cuda.fit_t(sp, EPS, MAX_IT))
    k2 = _np(mle_cuda.fit_boundary_t(sp, EPS, MAX_IT))
    compare_fits(plain, k1, MAX_IT)
    for other in (k2, _np(mle_cuda.fit_one_pass_t(sp, EPS, MAX_IT))):
        for a, b in zip(k1, other):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("box", [5, 7, 9, 11, 13, 15])
def test_sigma_fit_kernel_matches_plain(dev, box):
    sp = torch.from_numpy(np.ascontiguousarray(
        make_spots(4096, box, seed=box + 1).transpose(1, 2, 0)
    )).to(dev)
    plain = _np(mle._fit_core(sp, EPS, MAX_IT, "sigma"))
    k1 = _np(mle_cuda.fit_t(sp, EPS, MAX_IT, "sigma"))
    k2 = _np(mle_cuda.fit_boundary_t(sp, EPS, MAX_IT, "sigma"))
    compare_fits(plain, k1, MAX_IT)
    for other in (k2, _np(mle_cuda.fit_one_pass_t(sp, EPS, MAX_IT,
                                                  "sigma"))):
        for a, b in zip(k1, other):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(k1[0][5], k1[0][4])


@pytest.mark.parametrize("box", [5, 7, 9, 11, 13, 15])
def test_lq_kernel_matches_plain(dev, box):
    sp = torch.from_numpy(np.ascontiguousarray(
        make_spots(4096, box, seed=box + 2).transpose(1, 2, 0)
    )).to(dev)
    plain = lq._lm_core(sp, MAX_IT, FTOL).cpu().numpy()
    k3 = lq_cuda.fit_t(sp, MAX_IT, FTOL).cpu().numpy()
    k6 = lq_cuda.fit_boundary_t(sp, MAX_IT, FTOL).cpu().numpy()
    compare_lq_fits(plain, k3, sp.cpu().numpy())
    np.testing.assert_array_equal(k3, k6)


def test_lq_kernel_n_valid_and_resume(dev):
    """K6 with any boundaries is one launch of the LM work queue, counted
    on fit_boundary_t only, and equals the one pass bit for bit: the
    result does not depend on the boundaries; lanes at n_valid and
    beyond keep their initial parameters."""
    sp = torch.from_numpy(np.ascontiguousarray(
        make_spots(1000, seed=1).transpose(1, 2, 0)
    )).to(dev)
    sp[:, :, 900:] = 1.0  # degenerate: zero width, NaN cost
    a = lq_cuda.fit_t(sp, 12, FTOL, n_valid=900).cpu().numpy()
    for ends in ((3, 7), (), (1, 2, 5, 11), lq_cuda.default_boundaries(12)):
        before = (lq_cuda.fit_boundary_t.launches, lq_cuda.fit_queue_t.launches,
                  lq_cuda.fit_t.launches)
        b = lq_cuda._fit_phases(sp, 12, FTOL, 900, ends).cpu().numpy()
        assert (lq_cuda.fit_boundary_t.launches - before[0],
                lq_cuda.fit_queue_t.launches - before[1],
                lq_cuda.fit_t.launches - before[2]) == (1, 0, 0)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a[:, 900:], lq.initial_parameters_t(sp).cpu().numpy()[:, 900:])
    assert np.isfinite(a[:, :900]).all()


def _hold_small_mle(sp, got, method: str):
    """An MLE fit of the box-1 or box-2 batch ``sp`` (numpy theta, crlb,
    ll, iters at SMALL_MAX_IT) held to the plain fit: at box 1 by
    compare_fits_max_it, at box 2 by compare_fits_rounding against the
    plain fit in f64 (f32 rounding alone moves box-2 fits beyond
    compare_fits_max_it's bounds, tests/test_torch_anybox.py)."""
    plain = _np(mle._fit_core(sp, EPS, SMALL_MAX_IT, method))
    if sp.shape[0] == 1:
        return compare_fits_max_it(plain, got, SMALL_MAX_IT)
    exact = _np(mle._fit_core(sp.double(), EPS, SMALL_MAX_IT, method))
    return compare_fits_rounding(exact, plain, got, SMALL_MAX_IT)


def _hold_small_lq(sp, got):
    """An LM fit of the box-1 or box-2 batch ``sp`` (theta at SMALL_LQ_IT)
    held to the plain fit: at box 1 bit for bit (no step is finite, each
    fit is its initialiser), at box 2 by compare_lq_fits_rounding against
    the plain fit in f64."""
    plain = lq._lm_core(sp, SMALL_LQ_IT, FTOL).cpu().numpy()
    if sp.shape[0] == 1:
        return np.testing.assert_array_equal(got, plain)
    exact = lq._lm_core(sp.double(), SMALL_LQ_IT, FTOL).cpu().numpy()
    return compare_lq_fits_rounding(exact, plain, got,
                                    sp.double().cpu().numpy())


def test_fit_kernel_refuses_box3(dev):
    """The fit kernels take every box from 1 (box 3 templated since the
    any-box slice, test_box3_fits_equal_the_one_thread_pass; boxes 1 and
    2 in the any-box queue): at s = 1 and 2 every MLE wrapper fits
    through one launch of the any-box queue and is held to the plain fit
    (_hold_small_mle); a batch of box 0 raises."""
    for s in (1, 2):
        sp = _rois(SMALL_SPOTS, s, s + 80, dev)
        for method in ("sigmaxy", "sigma"):
            for fit in (mle_cuda.fit_t, mle_cuda.fit_one_pass_t,
                        mle_cuda.fit_boundary_t, mle_cuda.fit_anybox_t,
                        mle_cuda.fit_multiround_t):
                if fit is mle_cuda.fit_multiround_t and method == "sigma":
                    continue  # K7 fits sigmaxy only
                args = (() if fit is mle_cuda.fit_multiround_t
                        else (method,))
                before = _counts()
                got = _np(fit(sp, EPS, SMALL_MAX_IT, *args))
                assert _launched(before) == {"mle_cuda.fit_anybox_t": 1}
                _hold_small_mle(sp, got, method)
    sp = torch.ones((0, 0, 64), device=dev)
    for fit in (mle_cuda.fit_t, mle_cuda.fit_one_pass_t,
                mle_cuda.fit_boundary_t, mle_cuda.fit_multiround_t,
                mle_cuda.fit_anybox_t):
        with pytest.raises(ValueError, match="boxes"):
            fit(sp, EPS, MAX_IT)


def test_fit_kernel_n_valid_and_resume(dev):
    sp = torch.from_numpy(np.ascontiguousarray(
        make_spots(1000, seed=1).transpose(1, 2, 0)
    )).to(dev)
    sp[:, :, 900:] = 1.0
    a = _np(mle_cuda.fit_t(sp, EPS, 12, n_valid=900))
    b = _np(mle_cuda._fit_phases(sp, EPS, 12, "sigmaxy", 900, (3, 7)))
    c = _np(mle_cuda.fit_one_pass_t(sp, EPS, 12, n_valid=900))
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert a[3][900:].max() == 0


@pytest.mark.parametrize("box", [3, 5, 7, 9, 15])
def test_identify_kernel_matches_plain(dev, box):
    movie = make_bench_movie(16, 96, 60, 0.5, np.random.default_rng(3))
    movie = np.ascontiguousarray(movie[:, :82, :])  # Y not a multiple of T
    for frames in (movie, movie.astype(np.float32)):
        chunk = identify.upload_frames(frames, dev)
        p_t = identify.identify_tiles_plain(chunk, 3000.0, box)
        k_t = identify_cuda.identify_tiles(chunk, 3000.0, box)
        compare_tiles(_np(k_t), _np(p_t), f"box {box} {frames.dtype}")
        compare_hits(_np(identify.compact(*p_t, box)),
                     _np(identify.compact(*k_t, box)), 3000.0)


@pytest.mark.parametrize("box", [3, 5, 7, 9, 11, 13, 15])
def test_identify_kernel_at_any_shape(dev, box):
    """K4 against its plain version (compare_tiles) at every shape of
    K4_SHAPES, from u16 frames and from f32 frames with NaN pixels, one
    launch a call."""
    rng = np.random.default_rng(box)
    hits = 0
    for shape in K4_SHAPES:
        frames = small_frames(shape, rng, spots=3, nan=2e-3)
        for x in (np.nan_to_num(frames).astype(np.uint16), frames):
            chunk = identify.upload_frames(x, dev)
            before = identify_cuda.identify_tiles.launches
            k = _np(identify_cuda.identify_tiles(chunk, 3000.0, box))
            assert identify_cuda.identify_tiles.launches - before == 1
            compare_tiles(k, _np(identify.identify_tiles_plain(chunk, 3000.0,
                                                               box)),
                          f"box {box} {shape} {x.dtype}")
            hits += int(k[0].sum())
    assert hits > 50


def test_identify_kernel_blocks_are_whole_warps(dev):
    """Every instance: whole warps a block, strips and block columns of
    whole tiles, no spills."""
    for box in identify_cuda.BOXES:
        T = box // 2 + 1
        for dtype in (torch.uint16, torch.float32):
            info = identify_cuda.kernel_info(dtype, box)
            assert info["threads"] % 32 == 0
            assert info["rows"] % T == 0 and info["columns"] % T == 0
            assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1


def test_identify_kernel_refuses_other_inputs(dev):
    frames = torch.zeros((2, 32, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="uint16 or float32"):
        identify_cuda.identify_tiles(frames, 3000.0, 7)
    frames = torch.zeros((2, 32, 32), dtype=torch.uint16, device=dev)
    for box in (1, 2):
        with pytest.raises(ValueError, match="boxes"):
            identify_cuda.identify_tiles(frames, 3000.0, box)


def _fit_launches():
    return (mle_cuda.fit_t.launches, mle_cuda.fit_boundary_t.launches,
            lq_cuda.fit_t.launches, lq_cuda.fit_boundary_t.launches,
            winfit_cuda.fit_mle_t.launches,
            winfit_cuda.fit_mle_boundary_t.launches,
            winfit_cuda.fit_mle_queue_t.launches,
            winfit_cuda.fit_lq_queue_t.launches,
            mle_cuda.fit_one_pass_t.launches)


def test_chunk_without_hits_launches_no_fit(dev):
    before = _fit_launches()
    out = fused.identify_cut_fit(
        torch.zeros((4, 64, 64), dtype=torch.uint16, device=dev), 1000.0,
        0.0, 1.0, box=7, eps=EPS, max_it=MAX_IT,
    )
    assert out[0].numel() == 0 and out[4].shape == (6, 0)
    assert _fit_launches() == before


def test_chunk_without_hits_launches_no_lq_fit(dev):
    before = _fit_launches()
    out = fused.identify_cut_fit_packed(
        torch.zeros((4, 64, 64), dtype=torch.uint16, device=dev), 1000.0,
        0.0, 1.0, box=7, eps=EPS, max_it=MAX_IT, method="lq",
    )
    assert out.shape == (10, 0)
    assert _fit_launches() == before


def _chunk(spots, dtype, dev):
    frames, hits = spots_chunk(spots, dtype)
    return (torch.from_numpy(frames).to(dev),
            [torch.from_numpy(h).to(dev) for h in hits])


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("box", [5, 7, 9, 11, 13, 15])
def test_winfit_kernel_matches_plain_and_the_gather_route(dev, box, dtype):
    """K5 (MLE sigmaxy and sigma, one pass and phases; LM) from a u16 or
    f32 chunk against its plain version (cut, photons, plain fit) within
    the tolerances, and equal to cut + photons + the one-thread pass
    (K1's first port), K2 and K3 bit for bit."""
    frames, hits = _chunk(make_spots(2048, box, seed=box + 3), dtype, dev)
    rois = winfit_cuda.photons_t(frames, *hits, box, BASELINE, FACTOR)
    for method in ("sigmaxy", "sigma"):
        kw = dict(box=box, eps=EPS, max_it=MAX_IT, method=method)
        k5 = _np(winfit_cuda.fit_mle_t(frames, *hits, BASELINE, FACTOR, **kw))
        compare_fits(_np(mle._fit_core(rois, EPS, MAX_IT, method)), k5,
                     MAX_IT)
        for other in (
            winfit_cuda.fit_mle_boundary_t(frames, *hits, BASELINE, FACTOR,
                                           **kw),
            mle_cuda.fit_one_pass_t(rois, EPS, MAX_IT, method),
            mle_cuda.fit_boundary_t(rois, EPS, MAX_IT, method),
        ):
            for a, b in zip(k5, _np(other)):
                np.testing.assert_array_equal(a, b)
    k5lq = winfit_cuda.fit_lq_queue_t(frames, *hits, BASELINE, FACTOR,
                                      box=box, max_it=MAX_IT,
                                      ftol=FTOL).cpu().numpy()
    compare_lq_fits(lq._lm_core(rois, MAX_IT, FTOL).cpu().numpy(), k5lq,
                    rois.cpu().numpy())
    np.testing.assert_array_equal(
        k5lq, lq_cuda.fit_t(rois, MAX_IT, FTOL).cpu().numpy())


def test_winfit_kernel_clamps_the_centre(dev):
    """Hits on and beyond the border read the window of the clamped
    centre, as the plain cut does."""
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.poisson(
        50, (3, 40, 48)).astype(np.uint16)).to(dev)
    f, y, x = (torch.tensor(v, device=dev) for v in (
        [0, 2, 1, -1, 5, 1], [0, 39, 2, 20, 50, -4], [0, 47, 46, -3, 9, 30]))
    kw = dict(box=7, max_it=20, ftol=FTOL)
    got = winfit_cuda.fit_lq_queue_t(frames, f, y, x, BASELINE, FACTOR, **kw)
    clamped = winfit_cuda.fit_lq_queue_t(frames, f.clamp(0, 2),
                                         y.clamp(3, 36), x.clamp(3, 44),
                                         BASELINE, FACTOR, **kw)
    gather = lq_cuda.fit_t(winfit_cuda.photons_t(frames, f, y, x, 7,
                                                 BASELINE, FACTOR), 20, FTOL)
    np.testing.assert_array_equal(got.cpu().numpy(), clamped.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), gather.cpu().numpy())


def test_winfit_kernel_refuses_other_dtypes(dev):
    frames = torch.zeros((2, 32, 32), dtype=torch.int32, device=dev)
    hit = torch.zeros(1, dtype=torch.int64, device=dev) + 10
    with pytest.raises(ValueError, match="u16 or f32"):
        winfit_cuda.fit_mle_t(frames, hit, hit, hit, 0.0, 1.0, box=7,
                              eps=EPS, max_it=10)


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("box", [5, 7, 9, 11, 13, 15])
def test_queue_kernel_equals_k1(dev, box, dtype):
    """K5's work queue (both methods) from a u16 or f32 chunk equals the
    one-thread pass (K1's first port) on the gather route's ROIs and
    K5's single pass bit for bit."""
    frames, hits = _chunk(make_spots(2048, box, seed=box + 5), dtype, dev)
    rois = winfit_cuda.photons_t(frames, *hits, box, BASELINE, FACTOR)
    for method in ("sigmaxy", "sigma"):
        kw = dict(box=box, eps=EPS, max_it=MAX_IT, method=method)
        q = _np(winfit_cuda.fit_mle_queue_t(frames, *hits, BASELINE, FACTOR,
                                            **kw))
        _assert_same(q, _np(mle_cuda.fit_one_pass_t(rois, EPS, MAX_IT,
                                                    method)))
        _assert_same(q, _np(winfit_cuda.fit_mle_t(frames, *hits, BASELINE,
                                                  FACTOR, **kw)))


@pytest.mark.parametrize("n", [0, 1, 31, 33, 131072])
def test_queue_kernel_at_any_hit_count(dev, n):
    """Fewer hits than a warp, one more than a warp, and the smoke's
    131,072: the queue kernel equals the one-thread pass; no hit launches
    nothing."""
    frames, hits = _chunk(make_spots(max(n, 1), 7, seed=n), np.uint16, dev)
    hits = [h[:n] for h in hits]
    before = winfit_cuda.fit_mle_queue_t.launches
    q = _np(winfit_cuda.fit_mle_queue_t(frames, *hits, BASELINE, FACTOR,
                                        box=7, eps=EPS, max_it=MAX_IT))
    assert q[0].shape == (6, n) and q[3].dtype == np.int32
    assert winfit_cuda.fit_mle_queue_t.launches - before == (2 if n else 0)
    rois = winfit_cuda.photons_t(frames, *hits, 7, BASELINE, FACTOR)
    if n:
        _assert_same(q, _np(mle_cuda.fit_one_pass_t(rois, EPS, MAX_IT)))


@pytest.mark.parametrize("max_it", [12, MAX_IT])
def test_queue_kernel_with_max_it_stragglers(dev, max_it):
    """A dense chunk where spots run to max_it (many at 12): the queue
    equals cut + photons + K2 and the one-thread pass bit for bit, both
    methods, at two camera-constant pairs."""
    movie = make_bench_movie(48, 128, 300, 0.5, np.random.default_rng(13))
    chunk = identify.upload_frames(movie, dev)
    f, y, x, _ = identify.compact(
        *identify_cuda.identify_tiles(chunk, 4000.0, 7), 7)
    for method in ("sigmaxy", "sigma"):
        for b, c in ((0.0, 1.0), (BASELINE, FACTOR)):
            q = _np(winfit_cuda.fit_mle_queue_t(chunk, f, y, x, b, c, box=7,
                                                eps=EPS, max_it=max_it,
                                                method=method))
            rois = winfit_cuda.photons_t(chunk, f, y, x, 7, b, c)
            _assert_same(q, _np(mle_cuda.fit_boundary_t(rois, EPS, max_it,
                                                        method)))
            _assert_same(q, _np(mle_cuda.fit_one_pass_t(rois, EPS, max_it,
                                                        method)))
            if max_it == 12:
                assert (q[3] == max_it).any() and (q[3] < max_it).any()


def test_queue_kernel_repeats_and_launches_twice(dev):
    """Two calls in a row give equal results (the counter starts at 0
    each time); each call is the queue launch and the CRLB/LL pass."""
    frames, hits = _chunk(make_spots(5000, 7, seed=21), np.uint16, dev)
    kw = dict(box=7, eps=EPS, max_it=MAX_IT)
    before = winfit_cuda.fit_mle_queue_t.launches
    a = _np(winfit_cuda.fit_mle_queue_t(frames, *hits, 0.0, 1.0, **kw))
    assert winfit_cuda.fit_mle_queue_t.launches - before == 2
    b = _np(winfit_cuda.fit_mle_queue_t(frames, *hits, 0.0, 1.0, **kw))
    assert winfit_cuda.fit_mle_queue_t.launches - before == 4
    _assert_same(a, b)


def test_queue_kernel_refuses_other_dtypes_and_boxes(dev):
    hit = torch.zeros(1, dtype=torch.int64, device=dev) + 10
    kw = dict(eps=EPS, max_it=10)
    frames = torch.zeros((2, 32, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="u16 or f32"):
        winfit_cuda.fit_mle_queue_t(frames, hit, hit, hit, 0.0, 1.0, box=7,
                                    **kw)
    frames = torch.zeros((2, 32, 32), dtype=torch.uint16, device=dev)
    with pytest.raises(ValueError, match="boxes"):
        winfit_cuda.fit_mle_queue_t(frames, hit, hit, hit, 0.0, 1.0, box=0,
                                    **kw)
    with pytest.raises(ValueError, match="smaller than the box"):
        winfit_cuda.fit_mle_queue_t(frames, hit, hit, hit, 0.0, 1.0, box=33,
                                    **kw)
    # boxes 1 and 2 fit: the any-box cut and MLE queue, equal to the
    # queue on the cut's ROIs bit for bit
    for box in (1, 2):
        frames, hits = _chunk(make_spots(64, box, seed=box), np.uint16, dev)
        before = _counts()
        got = _np(winfit_cuda.fit_mle_queue_t(frames, *hits, 0.0, 1.0,
                                              box=box, **kw))
        assert _launched(before) == {"winfit_cuda.cut_anybox_t": 1,
                                     "mle_cuda.fit_anybox_t": 1}
        _assert_same(got, _np(mle_cuda.fit_anybox_t(winfit_cuda.photons_t(
            frames, *hits, box, 0.0, 1.0), EPS, 10)))


def test_queue_kernel_at_box_7_does_not_spill(dev):
    for method in ("sigmaxy", "sigma"):
        for dtype in (torch.uint16, torch.float32):
            info = winfit_cuda.queue_info(dtype, 7, method)
            assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2


def _lq_all(frames, hits, box, b, c, max_it, coop=None):
    """K5 LM's queue, and K3 and K6 on the gather route's ROIs, as
    numpy."""
    kw = dict(box=box, max_it=max_it, ftol=FTOL)
    rois = winfit_cuda.photons_t(frames, *hits, box, b, c)
    return [t.cpu().numpy() for t in (
        winfit_cuda.fit_lq_queue_t(frames, *hits, b, c, coop_steps=coop,
                                   **kw),
        lq_cuda.fit_t(rois, max_it, FTOL),
        lq_cuda.fit_boundary_t(rois, max_it, FTOL))]


def _assert_lq_equal(outs):
    for other in outs[1:]:
        np.testing.assert_array_equal(outs[0], other)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("box", [5, 7, 9, 11, 13, 15])
def test_lq_queue_kernel_equals_k3(dev, box, dtype):
    """K5 LM's work queue from a u16 or f32 chunk equals K3 on the gather
    route's ROIs and K6 bit for bit; its last spots run in the
    cooperative tail."""
    frames, hits = _chunk(make_spots(2048, box, seed=box + 7), dtype, dev)
    coop = torch.zeros(1, dtype=torch.int32, device=dev)
    _assert_lq_equal(_lq_all(frames, hits, box, BASELINE, FACTOR, MAX_IT,
                             coop))
    assert coop.item() > 0


@pytest.mark.parametrize("n", [0, 1, 31, 33, 131072])
def test_lq_queue_kernel_at_any_hit_count(dev, n):
    """Fewer hits than a warp (its lanes go cooperative at once), one more
    than a warp, and the smoke's 131,072: the queue equals K3; one
    launch a fit, none without hits."""
    frames, hits = _chunk(make_spots(max(n, 1), 7, seed=n), np.uint16, dev)
    hits = [h[:n] for h in hits]
    before = winfit_cuda.fit_lq_queue_t.launches
    q = winfit_cuda.fit_lq_queue_t(frames, *hits, BASELINE, FACTOR, box=7,
                                   max_it=MAX_IT, ftol=FTOL)
    assert q.shape == (6, n)
    assert winfit_cuda.fit_lq_queue_t.launches - before == (1 if n else 0)
    if n:
        rois = winfit_cuda.photons_t(frames, *hits, 7, BASELINE, FACTOR)
        np.testing.assert_array_equal(
            q.cpu().numpy(), lq_cuda.fit_t(rois, MAX_IT, FTOL).cpu().numpy())


def _dense_hits(dev):
    movie = make_bench_movie(48, 128, 300, 0.5, np.random.default_rng(13))
    chunk = identify.upload_frames(movie, dev)
    f, y, x, _ = identify.compact(
        *identify_cuda.identify_tiles(chunk, 4000.0, 7), 7)
    return chunk, [f, y, x]


@pytest.mark.parametrize("max_it", [12, MAX_IT])
def test_lq_queue_kernel_with_max_it_stragglers(dev, max_it):
    """A dense chunk where spots run to max_it: the queue equals K3 and
    K6 bit for bit at two camera-constant pairs, from u16 and f32
    frames, with steps taken in the cooperative tail."""
    chunk, hits = _dense_hits(dev)
    for b, c in ((0.0, 1.0), (BASELINE, FACTOR)):
        rois = winfit_cuda.photons_t(chunk, *hits, 7, b, c)
        carry = lq._lm_rounds(rois, *lq._lm_init(rois), max_it, FTOL)
        running = (carry[3][0] < 0.5).cpu().numpy()
        assert running.any() and not running.all()
        for src in (chunk, chunk.to(torch.float32)):
            coop = torch.zeros(1, dtype=torch.int32, device=dev)
            _assert_lq_equal(_lq_all(src, hits, 7, b, c, max_it, coop))
            assert coop.item() > 0


def test_lq_queue_kernel_when_every_hit_runs_to_max_it(dev):
    """Only hits that are still running after max_it steps: every slot
    ends at max_it (slots claimed together end together, so a warp may
    drain without a cooperative step), and the queue still equals K3 and
    K6."""
    chunk, hits = _dense_hits(dev)
    rois = winfit_cuda.photons_t(chunk, *hits, 7, 0.0, 1.0)
    carry = lq._lm_rounds(rois, *lq._lm_init(rois), 3, FTOL)
    keep = carry[3][0] < 0.5
    long_hits = [h[keep] for h in hits]
    assert len(long_hits[0]) > 1000
    _assert_lq_equal(_lq_all(chunk, long_hits, 7, 0.0, 1.0, 3))


def test_lq_queue_kernel_repeats_and_launches_once(dev):
    """Two calls in a row give equal results (the counter starts at 0
    each time); each call is one launch."""
    frames, hits = _chunk(make_spots(5000, 7, seed=21), np.uint16, dev)
    kw = dict(box=7, max_it=MAX_IT, ftol=FTOL)
    before = winfit_cuda.fit_lq_queue_t.launches
    a = winfit_cuda.fit_lq_queue_t(frames, *hits, 0.0, 1.0, **kw)
    b = winfit_cuda.fit_lq_queue_t(frames, *hits, 0.0, 1.0, **kw)
    assert winfit_cuda.fit_lq_queue_t.launches - before == 2
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_lq_queue_kernel_refuses_other_dtypes_and_boxes(dev):
    hit = torch.zeros(1, dtype=torch.int64, device=dev) + 10
    frames = torch.zeros((2, 32, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="u16 or f32"):
        winfit_cuda.fit_lq_queue_t(frames, hit, hit, hit, 0.0, 1.0, box=7,
                                   max_it=10)
    frames = torch.zeros((2, 32, 32), dtype=torch.uint16, device=dev)
    with pytest.raises(ValueError, match="boxes"):
        winfit_cuda.fit_lq_queue_t(frames, hit, hit, hit, 0.0, 1.0, box=0,
                                   max_it=10)
    with pytest.raises(ValueError, match="smaller than the box"):
        winfit_cuda.fit_lq_queue_t(frames, hit, hit, hit, 0.0, 1.0, box=33,
                                   max_it=10)
    # boxes 1 and 2 fit: the any-box cut and LM queue, equal to the queue
    # on the cut's ROIs bit for bit
    for box in (1, 2):
        frames, hits = _chunk(make_spots(64, box, seed=box), np.uint16, dev)
        before = _counts()
        got = winfit_cuda.fit_lq_queue_t(frames, *hits, 0.0, 1.0, box=box,
                                         max_it=10)
        assert _launched(before) == {"winfit_cuda.cut_anybox_t": 1,
                                     "lq_cuda.fit_anybox_t": 1}
        np.testing.assert_array_equal(
            got.cpu().numpy(), lq_cuda.fit_anybox_t(winfit_cuda.photons_t(
                frames, *hits, box, 0.0, 1.0), 10).cpu().numpy())


def test_lq_queue_kernel_at_box_7_does_not_spill(dev):
    for dtype in (torch.uint16, torch.float32):
        info = winfit_cuda.lq_queue_info(dtype, 7)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2
        assert info["group"] >= 7


def _rois(n, box, seed, dev):
    """n make_spots as a lanes-last (S, S, n) f32 batch on the card."""
    return torch.from_numpy(np.ascontiguousarray(
        make_spots(max(n, 1), box, seed=seed)[:n].transpose(1, 2, 0))).to(dev)


def _roi_mle_all(sp, max_it, method, eps=EPS, n_valid=None, coop=None):
    """K1 (the work queue with the CRLB/LL in it), the one-thread pass
    and K2's phases on the ROI batch sp."""
    return [_np(f(sp, eps, max_it, method, n_valid, **kw)) for f, kw in (
        (mle_cuda.fit_t, dict(coop_steps=coop)),
        (mle_cuda.fit_one_pass_t, {}), (mle_cuda.fit_boundary_t, {}))]


def _roi_lq_all(sp, max_it, n_valid=None, coop=None):
    """K3 as a work queue, K3 and K6 on the ROI batch sp."""
    return [f(sp, max_it, FTOL, n_valid, **kw).cpu().numpy() for f, kw in (
        (lq_cuda.fit_queue_t, dict(coop_steps=coop)), (lq_cuda.fit_t, {}),
        (lq_cuda.fit_boundary_t, {}))]


def _assert_all_same(outs):
    for other in outs[1:]:
        _assert_same(outs[0], other)


@pytest.mark.parametrize("box", [5, 7, 9, 11, 13, 15])
def test_roi_queue_kernels_equal_k1_k2_and_k3_k6(dev, box):
    """K1's work queue (sigmaxy and sigma) equals the one-thread pass and
    K2's phases, and K3 as a work queue equals K3 and K6, bit for bit on
    make_spots; the last spots of each warp run in the cooperative
    tail."""
    sp = _rois(2048, box, box + 9, dev)
    for method in ("sigmaxy", "sigma"):
        coop = torch.zeros(1, dtype=torch.int32, device=dev)
        _assert_all_same(_roi_mle_all(sp, MAX_IT, method, coop=coop))
        assert coop.item() > 0
    coop = torch.zeros(1, dtype=torch.int32, device=dev)
    _assert_lq_equal(_roi_lq_all(sp, MAX_IT, coop=coop))
    assert coop.item() > 0


@pytest.mark.parametrize("n", [0, 1, 31, 33, 262145])
def test_roi_queue_kernels_at_any_spot_count(dev, n):
    """Fewer spots than a warp (its lanes go cooperative at once), one
    more than a warp, and one more than fit2D's block of 262,144: the
    queues equal the one-thread kernels; K1 is 1 launch a fit, the LM
    queue 1, and no spot launches nothing."""
    sp = _rois(n, 7, n + 1, dev)
    before = (mle_cuda.fit_t.launches, lq_cuda.fit_queue_t.launches)
    outs = _roi_mle_all(sp, MAX_IT, "sigmaxy")
    lq_outs = _roi_lq_all(sp, MAX_IT)
    assert outs[0][0].shape == (6, n) and outs[0][3].dtype == np.int32
    assert lq_outs[0].shape == (6, n)
    assert (mle_cuda.fit_t.launches - before[0],
            lq_cuda.fit_queue_t.launches - before[1]) == ((1, 1) if n
                                                          else (0, 0))
    _assert_all_same(outs)
    _assert_lq_equal(lq_outs)


@pytest.mark.parametrize("max_it", [12, MAX_IT])
def test_roi_queue_kernels_on_a_dense_chunk(dev, max_it):
    """The ROIs of a dense chunk, where spots run to max_it (many at 12):
    both queues equal the one-thread kernels bit for bit, both MLE
    methods, at two camera-constant pairs, with cooperative steps."""
    chunk, hits = _dense_hits(dev)
    for b, c in ((0.0, 1.0), (BASELINE, FACTOR)):
        rois = winfit_cuda.photons_t(chunk, *hits, 7, b, c)
        for method in ("sigmaxy", "sigma"):
            coop = torch.zeros(1, dtype=torch.int32, device=dev)
            outs = _roi_mle_all(rois, max_it, method, coop=coop)
            _assert_all_same(outs)
            assert coop.item() > 0
            if max_it == 12:
                assert (outs[0][3] == 12).any() and (outs[0][3] < 12).any()
        coop = torch.zeros(1, dtype=torch.int32, device=dev)
        _assert_lq_equal(_roi_lq_all(rois, max_it, coop=coop))
        assert coop.item() > 0


def test_roi_queue_kernels_when_every_spot_runs_to_max_it(dev):
    """At eps 0 no MLE fit converges, so every spot runs to max_it; with
    2051 spots the last warp to claim holds 3 of them, whose lanes go
    cooperative at once: K1's queue equals the one-thread pass and K2's
    phases, with cooperative steps. The LM queue likewise on the chunk's
    spots still running after 3 steps."""
    sp = _rois(2051, 7, 40, dev)
    for method in ("sigmaxy", "sigma"):
        coop = torch.zeros(1, dtype=torch.int32, device=dev)
        outs = _roi_mle_all(sp, 20, method, eps=0.0, coop=coop)
        _assert_all_same(outs)
        assert (outs[0][3] == 20).all() and coop.item() >= 3 * 20
    chunk, hits = _dense_hits(dev)
    rois = winfit_cuda.photons_t(chunk, *hits, 7, 0.0, 1.0)
    carry = lq._lm_rounds(rois, *lq._lm_init(rois), 3, FTOL)
    keep = (carry[3][0] < 0.5).nonzero()[:, 0]
    _assert_lq_equal(_roi_lq_all(rois[:, :, keep].contiguous(), 3))


def test_roi_queue_kernels_n_valid_and_nan(dev):
    """Spots at or above n_valid start converged (their initial theta,
    0 iterations), and a NaN ROI gives the one-thread kernels' NaNs:
    K1's queue equals the one-thread pass and K2's phases, and K3's
    queue K3 and K6, bit for bit."""
    sp = _rois(500, 7, 41, dev)
    sp[:, :, 17] = float("nan")
    sp[3, 2, 250] = float("nan")
    for method in ("sigmaxy", "sigma"):
        outs = _roi_mle_all(sp, MAX_IT, method, n_valid=300)
        _assert_all_same(outs)
        assert (outs[0][3][300:] == 0).all() and np.isnan(outs[0][0][:, 17]).all()
    _assert_lq_equal(_roi_lq_all(sp, MAX_IT, n_valid=300))


def test_roi_queue_kernels_refuse_other_boxes_and_dtypes(dev):
    """K1's and K3's queue wrappers refuse a batch of box 0, of another
    dtype, not contiguous or not (S, S, N); a (2, 2, 8) batch fits,
    through the any-box queues, equal to their one-thread passes."""
    sp = _rois(8, 2, 3, dev)
    before = _counts()
    _assert_same(_np(mle_cuda.fit_t(sp, EPS, 10)),
                 _np(mle_cuda.fit_anybox_one_pass_t(sp, EPS, 10)))
    np.testing.assert_array_equal(
        lq_cuda.fit_queue_t(sp, 10).cpu().numpy(),
        lq_cuda.fit_anybox_one_pass_t(sp, 10).cpu().numpy())
    assert _launched(before) == {"mle_cuda.fit_anybox_t": 1,
                                 "mle_cuda.fit_anybox_one_pass_t": 1,
                                 "lq_cuda.fit_anybox_t": 1,
                                 "lq_cuda.fit_anybox_one_pass_t": 1}
    for bad, match in ((torch.zeros((0, 0, 8), device=dev), "boxes"),
                       (torch.zeros((7, 7, 8), dtype=torch.float64,
                                    device=dev), "float32"),
                       (torch.zeros((7, 8, 7), device=dev).transpose(1, 2),
                        "contiguous"),
                       (torch.zeros((7, 5, 8), device=dev), "S, S, N")):
        with pytest.raises(ValueError, match=match):
            mle_cuda.fit_t(bad, EPS, 10)
        with pytest.raises(ValueError, match=match):
            lq_cuda.fit_queue_t(bad, 10)


def test_roi_queue_kernels_at_box_7_do_not_spill(dev):
    for method in ("sigmaxy", "sigma"):
        info = mle_cuda.queue_info(7, method)
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2
        assert info["group"] == 8
    info = lq_cuda.queue_info(7)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2
    assert info["group"] >= 7


def test_lq_one_thread_kernels_equal_after_the_split(dev):
    """K3 and K6 (the fit_lq.cuh body with the normal equations reused
    after a rejected step, one thread a spot) equal each other bit for
    bit on a dense chunk whose spots run to max_it, and the plain version
    within compare_lq_fits."""
    chunk, hits = _dense_hits(dev)
    outs = _lq_all(chunk, hits, 7, BASELINE, FACTOR, MAX_IT)
    _assert_lq_equal(outs[1:])
    rois = winfit_cuda.photons_t(chunk, *hits, 7, BASELINE, FACTOR)
    compare_lq_fits(lq._lm_core(rois, MAX_IT, FTOL).cpu().numpy(), outs[1],
                    rois.cpu().numpy())


def test_multiround_schedule_equals_the_single_pass(dev):
    """K7 (rounds of 4 over 20 iterations, some spots still running at
    each boundary) is one launch of K1's work queue on the card and
    equals the one-thread pass bit for bit."""
    sp = torch.from_numpy(np.ascontiguousarray(
        make_spots(4096, seed=12).transpose(1, 2, 0))).to(dev)
    before = mle_cuda.fit_multiround_t.launches
    k7 = _np(mle_cuda.fit_multiround_t(sp, EPS, 20, round_it=4))
    assert mle_cuda.fit_multiround_t.launches - before == 1
    k1 = _np(mle_cuda.fit_one_pass_t(sp, EPS, 20))
    assert (k1[3] > 4).any() and (k1[3] <= 4).any()
    for a, b in zip(k7, k1):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_it", [0, 1, 2])
def test_k1_queue_at_small_max_it(dev, max_it):
    """K1's work queue at max_it 0 (every spot's CRLB at its initial
    theta), 1 and 2, with spots padded past n_valid: equal to the
    one-thread pass bit for bit, both methods, one launch a fit, and K7
    likewise; an empty batch launches nothing."""
    sp = _rois(3000, 7, 60 + max_it, dev)
    for method in ("sigmaxy", "sigma"):
        for n_valid in (None, 2900):
            before = mle_cuda.fit_t.launches
            got = _np(mle_cuda.fit_t(sp, EPS, max_it, method, n_valid))
            assert mle_cuda.fit_t.launches - before == 1
            _assert_same(got, _np(mle_cuda.fit_one_pass_t(sp, EPS, max_it,
                                                          method, n_valid)))
            assert (got[3] <= max_it).all()
    before = mle_cuda.fit_multiround_t.launches
    _assert_same(_np(mle_cuda.fit_multiround_t(sp, EPS, max_it)),
                 _np(mle_cuda.fit_one_pass_t(sp, EPS, max_it)))
    assert mle_cuda.fit_multiround_t.launches - before == 1
    empty = sp[:, :, :0].contiguous()
    before = mle_cuda.fit_t.launches, mle_cuda.fit_multiround_t.launches
    assert _np(mle_cuda.fit_t(empty, EPS, max_it))[0].shape == (6, 0)
    assert _np(mle_cuda.fit_multiround_t(empty, EPS, max_it))[3].shape == (0,)
    assert (mle_cuda.fit_t.launches,
            mle_cuda.fit_multiround_t.launches) == before


def test_undrift_on_the_card_matches_the_cpu(dev):
    movie = make_bench_movie(128, 64, 60, 0.5, np.random.default_rng(5))
    cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    par = {"Min. Net Gradient": 4000, "Box Size": 7}
    locs = localize.localize(movie, dict(cam), par, fitting_method="gaussmle",
                             device="cpu")
    f = locs["frame"].astype(np.float64)
    locs["x"] += (0.8 * f / 127).astype(np.float32)
    locs["y"] += (0.5 * np.sin(2 * np.pi * f / 127)).astype(np.float32)
    info = [{"Frames": 128, "Height": 64, "Width": 64}]
    d_g, l_g = postprocess.undrift(locs, info, 16, device=dev)
    d_c, l_c = postprocess.undrift(locs, info, 16, device="cpu")
    for c in ("x", "y"):
        np.testing.assert_allclose(d_g[c], d_c[c], rtol=0, atol=1e-3)
        np.testing.assert_allclose(l_g[c], l_c[c], rtol=0, atol=1e-3)


def test_slice_on_the_card_matches_the_cpu(dev):
    movie = make_bench_movie(32, 64, 40, 0.5, np.random.default_rng(7))
    cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    par = {"Min. Net Gradient": 4000, "Box Size": 7}
    before = _fit_launches()
    g = localize.localize(movie, dict(cam), par, fitting_method="gaussmle",
                          device=dev)
    # the chain's route: K5's work queue, no other fit
    after = _fit_launches()
    assert after[6] > before[6]
    assert after[:6] + after[7:] == before[:6] + before[7:]
    c = localize.localize(movie, dict(cam), par, fitting_method="gaussmle",
                          device="cpu")
    np.testing.assert_array_equal(g["frame"], c["frame"])
    same = (g["iterations"] == c["iterations"]) & (c["iterations"] < MAX_IT)
    assert same.mean() >= 0.95
    for name in ("x", "y"):
        np.testing.assert_allclose(g[name][same], c[name][same], atol=1e-3)


def test_sigma_slice_on_the_card_matches_the_cpu(dev):
    movie = make_bench_movie(32, 64, 40, 0.5, np.random.default_rng(7))
    cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    par = {"Min. Net Gradient": 4000, "Box Size": 7}
    before = _fit_launches()
    g = localize.localize(movie, dict(cam), par, fitting_method="gaussmle",
                          mle_method="sigma", device=dev)
    # the chain's route (fused.MLE_FITS): K5's work queue or its phases,
    # no other fit
    i = 6 if fused.MLE_FITS["sigma"] is winfit_cuda.fit_mle_queue_t else 5
    after = _fit_launches()
    assert after[i] > before[i]
    assert after[:i] + after[i + 1:] == before[:i] + before[i + 1:]
    c = localize.localize(movie, dict(cam), par, fitting_method="gaussmle",
                          mle_method="sigma", device="cpu")
    np.testing.assert_array_equal(g["frame"], c["frame"])
    np.testing.assert_array_equal(g["sx"], g["sy"])
    same = (g["iterations"] == c["iterations"]) & (c["iterations"] < MAX_IT)
    assert same.mean() >= 0.95
    for name in ("x", "y", "sx"):
        np.testing.assert_allclose(g[name][same], c[name][same], atol=1e-3)


def test_lq_slice_on_the_card_matches_the_cpu(dev):
    movie = make_bench_movie(32, 64, 40, 0.5, np.random.default_rng(7))
    cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    par = {"Min. Net Gradient": 4000, "Box Size": 7}
    before = _fit_launches()
    g = localize.localize(movie, dict(cam), par, fitting_method="gausslq",
                          device=dev)
    # the chain's route: K5 LM's work queue, no other fit
    after = _fit_launches()
    assert after[7] > before[7]
    assert after[:7] == before[:7]
    c = localize.localize(movie, dict(cam), par, fitting_method="gausslq",
                          device="cpu")
    np.testing.assert_array_equal(g["frame"], c["frame"])
    np.testing.assert_allclose(g["net_gradient"], c["net_gradient"],
                               rtol=1e-5)
    d = np.maximum(np.abs(g["x"] - c["x"]), np.abs(g["y"] - c["y"]))
    assert np.mean(d <= 1e-3) >= 0.99


# --- the rest of the localize verb: TIFF, identify + fit2D, avg, 3D ------

CAM = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
PAR = {"Min. Net Gradient": 4000, "Box Size": 7}


@pytest.fixture
def tiff_movie(tmp_path):
    """A 64-frame bench movie in RAM and as a two-file TIFF series."""
    from picasso_torch import io
    from torch_data import write_tiff

    movie = make_bench_movie(64, 64, 40, 0.5, np.random.default_rng(9))
    write_tiff(str(tmp_path / "m.ome.tif"), movie[:32])
    write_tiff(str(tmp_path / "m_1.ome.tif"), movie[32:])
    return movie, io.load_movie(str(tmp_path / "m.ome.tif"))[0]


@pytest.mark.parametrize("method", ["gaussmle", "gausslq", "avg"])
def test_tiff_slice_equals_the_ram_slice(dev, tiff_movie, method):
    movie, lazy = tiff_movie
    ram = localize.localize(movie, dict(CAM), PAR, fitting_method=method,
                            device=dev)
    tif = localize.localize(lazy, dict(CAM), PAR, fitting_method=method,
                            device=dev)
    assert len(ram) > 300
    for name in ram.dtype.names:
        np.testing.assert_array_equal(tif[name], ram[name], err_msg=name)


def test_identify_and_fit2d_run_k2_and_k3(dev):
    """identify on the card == the fused slice's hit list; fit2D's MLE
    (K2 on its route, mle_cuda.ROI_FITS) == the fused slice's fits (K5's
    queue) bit for bit; fit2D's LM (K3 on its route, lq_cuda.ROI_FIT,
    max_it 30) == K5's LM queue at max_it 30 bit for bit."""
    movie = make_bench_movie(32, 64, 40, 0.5, np.random.default_rng(7))
    ids = localize.identify(movie, 4000, 7, device=dev)
    f_ids, fits = fused.localize_fused(movie, 4000, 7, dict(CAM),
                                       device=dev)
    for name in ids.dtype.names:
        np.testing.assert_array_equal(ids[name], f_ids[name])
    info = [{"Frames": 32, "Height": 64, "Width": 64}]
    k2 = mle_cuda.ROI_FITS["sigmaxy"].launches
    k3 = lq_cuda.ROI_FIT.launches
    mle_locs, _ = localize.fit2D(movie, info, dict(CAM), ids, 7,
                                 fitting_method="gaussmle", device=dev)
    assert mle_cuda.ROI_FITS["sigmaxy"].launches > k2
    from picasso_torch import gaussmle, gausslq

    ref = gaussmle.locs_from_fits(f_ids, *fits, 7)
    for name in ref.dtype.names:
        np.testing.assert_array_equal(mle_locs[name], ref[name], err_msg=name)
    lq_locs, _ = localize.fit2D(movie, info, dict(CAM), ids, 7,
                                fitting_method="gausslq", device=dev)
    assert lq_cuda.ROI_FIT.launches > k3
    chunk = identify.upload_frames(movie, dev)
    hits = [torch.from_numpy(np.ascontiguousarray(ids[c])).to(dev)
            for c in ("frame", "y", "x")]
    theta = winfit_cuda.fit_lq_queue_t(chunk, *hits, 0.0, 1.0, box=7,
                                       max_it=30, ftol=FTOL).cpu().numpy()
    ref = gausslq.locs_from_fits(ids, theta.T, 7, False)
    for name in ref.dtype.names:
        np.testing.assert_array_equal(lq_locs[name], ref[name], err_msg=name)


def test_avg_and_cut_on_the_card_equal_the_cpu(dev):
    movie = make_bench_movie(32, 64, 40, 0.5, np.random.default_rng(7))
    cam = {"Baseline": 100, "Sensitivity": 0.45, "Gain": 7, "Pixelsize": 130}
    g = localize.localize(movie + np.uint16(100), dict(cam), PAR,
                          fitting_method="avg", device=dev)
    c = localize.localize(movie + np.uint16(100), dict(cam), PAR,
                          fitting_method="avg", device="cpu")
    np.testing.assert_array_equal(g["frame"], c["frame"])
    for name in ("x", "y", "photons", "bg", "lpx"):
        np.testing.assert_array_equal(g[name], c[name], err_msg=name)
    ids = localize.identify(movie, 4000, 7, device="cpu")
    np.testing.assert_array_equal(
        localize.get_spots_raw(movie, ids, 7, device=dev),
        localize.get_spots_raw(movie, ids, 7, device="cpu"))


@pytest.mark.parametrize("method", ["gaussmle", "gausslq"])
def test_zfit_on_the_card_equals_the_cpu(dev, method):
    """The z-grid scan rounds every step alike on the card and the CPU:
    z, d_zcalib and lpz equal bit for bit on the same locs."""
    from picasso_torch import zfit
    from torch_data import CALIB_3D, make_astig_movie

    movie = make_astig_movie(64, 96, 40, 0.5, np.random.default_rng(3))[0]
    locs = localize.localize(movie, dict(CAM), PAR, fitting_method=method,
                             device="cpu")
    info = [{"Frames": 64, "Height": 96, "Width": 96, "Pixelsize": 130}]
    g = zfit.zfit(locs, info, calibration=CALIB_3D, fitting_method=method,
                  filter=0, device=dev)[0]
    c = zfit.zfit(locs, info, calibration=CALIB_3D, fitting_method=method,
                  filter=0, device="cpu")[0]
    for name in g.dtype.names:
        np.testing.assert_array_equal(g[name], c[name], err_msg=name)
    z_g = zfit.fit_z_grid(locs["sx"], locs["sy"], CALIB_3D, device=dev,
                          rows=100)
    z_c = zfit.fit_z_grid(locs["sx"], locs["sy"], CALIB_3D, device="cpu")
    for a, b in zip(z_g, z_c):
        np.testing.assert_array_equal(a, b)


def _drifted_locs(seed: int, n_frames: int = 300, size: int = 64,
                  n_fid: int = 3):
    """Locs of 60 sites (4 a frame, 0.05 px) and ``n_fid`` fiducial
    tracks away from them, all with +0.8 px linear drift in x and a 0.5
    px sine in y, frame-sorted; and the info."""
    from torch_data import FIDUCIAL_DTYPE, fiducial_tracks, free_positions

    rng = np.random.default_rng(seed)
    sites = rng.uniform(4, size - 4, (60, 2))
    frame = np.repeat(np.arange(n_frames), 4)
    s = rng.integers(0, len(sites), len(frame))
    locs = np.zeros(len(frame), FIDUCIAL_DTYPE)
    locs["frame"] = frame
    locs["x"] = sites[s, 0] + rng.normal(0, 0.05, len(frame))
    locs["y"] = sites[s, 1] + rng.normal(0, 0.05, len(frame))
    locs["lpx"] = locs["lpy"] = 0.05
    fid = fiducial_tracks(free_positions(sites[:, 0], sites[:, 1], size,
                                         n_fid, 6.0), n_frames, rng)
    locs = np.concatenate([locs, fid])
    locs = locs[np.argsort(locs["frame"], kind="stable")]
    t = locs["frame"] / (n_frames - 1)
    locs["x"] += (0.8 * t).astype(np.float32)
    locs["y"] += (0.5 * np.sin(2 * np.pi * t)).astype(np.float32)
    info = [{"Frames": n_frames, "Height": size, "Width": size,
             "Pixelsize": 130}]
    return locs, info


@pytest.mark.parametrize("z", [False, True])
def test_aim_on_the_card_equals_the_cpu(dev, z):
    """The count maps are integers and every division takes a tensor,
    so the drift and the locs equal the CPU's bit for bit."""
    from numpy.lib import recfunctions

    from picasso_torch import aim

    locs, info = _drifted_locs(4)
    if z:
        rng = np.random.default_rng(5)
        zc = rng.uniform(-300, 300, len(locs))
        locs = recfunctions.append_fields(locs, "z", zc.astype(np.float32),
                                          usemask=False)
    g = aim.aim(locs, info, segmentation=50, device=dev)
    c = aim.aim(locs, info, segmentation=50, device="cpu")
    for a, b in ((g[0], c[0]), (g[2], c[2])):
        for name in a.dtype.names:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert g[1] == c[1]


@pytest.mark.parametrize("n", [20_000, 80_000])
@pytest.mark.parametrize("blur", [None, "gaussian", "gaussian_iso", "smooth",
                                  "convolve"])
def test_render_on_the_card_matches_the_cpu(dev, blur, n):
    """Histogram, smooth and convolve equal (counts, and the filter's
    f64 terms in one order); the splats within 1e-5 of the image max
    (atomic sums in any order, the card's exp), on both routes."""
    from picasso_torch import render

    rng = np.random.default_rng(6)
    locs = np.zeros(n, [("frame", np.uint32), ("x", np.float64),
                        ("y", np.float64), ("lpx", np.float32),
                        ("lpy", np.float32)])
    locs["x"], locs["y"] = rng.uniform(-1, 65, (2, n))
    locs["lpx"], locs["lpy"] = rng.uniform(0.02, 0.3, (2, n))
    info = [{"Frames": 10, "Height": 64, "Width": 64}]
    kw = dict(oversampling=7.3, viewport=((3.3, 2.7), (60.1, 61.9)),
              blur_method=blur)
    ng, g = render.render(locs, info, device=dev, **kw)
    nc, c = render.render(locs, info, device="cpu", **kw)
    assert ng == nc
    if blur in (None, "smooth", "convolve"):
        np.testing.assert_array_equal(g, c)
    else:
        assert np.abs(g - c).max() <= 1e-5 * c.max()


def test_identify_in_image_runs_k4(dev):
    """On a tensor on the card identify_in_image launches K4 once; its
    hits equal the plain version's, ng within compare_tiles' rtol."""
    rng = np.random.default_rng(7)
    image = rng.normal(10, 2, (96, 128)).astype(np.float32)
    for yc, xc in ((10, 12), (40, 60), (30, 100), (80, 20)):
        image[yc - 2:yc + 3, xc - 2:xc + 3] += rng.uniform(200, 400)
    before = identify_cuda.identify_tiles.launches
    g = localize.identify_in_image(torch.from_numpy(image).to(dev), 500.0, 7)
    assert identify_cuda.identify_tiles.launches == before + 1
    c = localize.identify_in_image(image, 500.0, 7, device="cpu")
    assert len(g[0]) == 4
    np.testing.assert_array_equal(g[0], c[0])
    np.testing.assert_array_equal(g[1], c[1])
    np.testing.assert_allclose(g[2], c[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("box", [1, 2])
def test_identify_refuses_boxes_1_and_2_on_the_card(dev, box):
    """Every identify entry point raises a ValueError at boxes 1 and 2 on
    the card, as on the CPU (tests/test_torch_anybox.py, where
    picasso_tpu's raises too), launching no kernel; local_maxima raises
    at box 1 and gives the CPU's maxima at box 2."""
    movie = make_bench_movie(4, 64, 6, 0.5, np.random.default_rng(box))
    frame = movie[1]
    frames = identify.upload_frames(movie, dev)
    before = _counts()
    for call in (
            lambda: localize.identify(movie, 100.0, box, device="cuda"),
            lambda: localize.identify_in_image(frame, 100.0, box,
                                               device="cuda"),
            lambda: localize.identify_in_frame(frame, 100.0, box,
                                               ((4, 4), (40, 48)),
                                               device="cuda"),
            lambda: localize.identify_by_frame_number(movie, 100.0, box, 1,
                                                      device="cuda"),
            lambda: localize.identify_async(movie, 100.0, box,
                                            device="cuda"),
            lambda: identify_cuda.identify_tiles(frames, 100.0, box),
            lambda: identify_cuda.identify_tiles_anybox(frames, 100.0, box),
            lambda: identify_cuda.identify_tiles_anybox_direct(frames, 100.0,
                                                               box)):
        with pytest.raises(ValueError, match="boxes >= 3"):
            call()
    assert _launched(before) == {}
    if box == 1:
        with pytest.raises(ValueError, match="boxes >= 2"):
            localize.local_maxima(frame, box, device="cuda")
        return
    for a, b in zip(localize.local_maxima(frame, box, device="cuda"),
                    localize.local_maxima(frame, box, device="cpu")):
        np.testing.assert_array_equal(a, b)


def test_fiducials_on_the_card_equal_the_cpu(dev):
    locs, info = _drifted_locs(8)
    picks_g, box = imageprocess.find_fiducials(locs, info, device=dev)
    picks_c, _ = imageprocess.find_fiducials(locs, info, device="cpu")
    assert picks_g == picks_c and len(picks_g) == 3 and box == 7
    g = postprocess.undrift_from_fiducials(locs, info, device=dev)
    c = postprocess.undrift_from_fiducials(locs, info, device="cpu")
    for name in g[2].dtype.names:
        assert np.abs(g[2][name] - c[2][name]).max() <= 1e-9


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("d_max,tol", [(1.0, 1), (0.05, 3)])
def test_link_and_dark_on_the_card_equal_the_cpu(dev, d_max, tol):
    """Chain ids equal (the same CSR walked by the library and by its
    Python twin); the events within one f32 ulp (f64 atomic sums), the
    dark times equal."""
    from picasso_torch.ops import link
    from torch_data import make_event_locs
    from torch_parity import compare_tables_ulps

    locs, info = make_event_locs(3, n_sites=60, frames=2000)
    args = (locs["frame"], locs["x"], locs["y"], locs["group"], d_max, tol)
    before = link.walk.launches
    ids_g = postprocess.link_groups(*args, device=dev)
    assert link.walk.launches == before + 1
    np.testing.assert_array_equal(ids_g,
                                  postprocess.link_groups(*args, device="cpu"))
    g = postprocess.link(locs, info, r_max=d_max, max_dark_time=tol,
                         device=dev)
    c = postprocess.link(locs, info, r_max=d_max, max_dark_time=tol,
                         device="cpu")
    compare_tables_ulps(g, c, 1, "link")
    np.testing.assert_array_equal(postprocess.dark_times(c, device=dev),
                                  postprocess.dark_times(c, device="cpu"))


def test_link_walk_library_equals_its_python_twin(dev):
    from picasso_torch.ops import link
    from torch_data import make_event_locs

    locs, _ = make_event_locs(4, n_sites=80, frames=1000)
    off, succ = link.successors(*(_t(a).to(dev) for a in (
        locs["frame"].astype(np.int64), locs["x"], locs["y"],
        locs["group"].astype(np.int64))), 2.0, 4)
    off_c, succ_c = link.successors(*(_t(a) for a in (
        locs["frame"].astype(np.int64), locs["x"], locs["y"],
        locs["group"].astype(np.int64))), 2.0, 4)
    np.testing.assert_array_equal(off.cpu().numpy(), off_c.numpy())
    np.testing.assert_array_equal(succ.cpu().numpy(), succ_c.numpy())
    o, s = off_c.numpy(), succ_c.numpy()
    np.testing.assert_array_equal(link.walk_host(o, s), link.walk_plain(o, s))


def test_statistics_on_the_card_equal_the_cpu(dev):
    """NeNA's histogram, the density, the pair histogram, the nearest
    neighbours and cluster_combine_dist equal; groupprops and
    cluster_combine within one f32 ulp (f64 atomic sums); the FRC curve
    within 1e-9 (cuFFT against torch's CPU FFT)."""
    from torch_data import make_event_locs
    from torch_parity import compare_tables_ulps

    locs, info = make_event_locs(5, n_sites=60, frames=2000, size=48)
    for f in (postprocess._next_frame_neighbor_distance_histogram,):
        np.testing.assert_array_equal(f(locs, device=dev)[1],
                                      f(locs, device="cpu")[1])
    np.testing.assert_array_equal(
        postprocess.compute_local_density(locs, info, 0.5, device=dev),
        postprocess.compute_local_density(locs, info, 0.5, device="cpu"))
    np.testing.assert_array_equal(
        postprocess.distance_histogram(locs, info, 0.1, 5.0, device=dev),
        postprocess.distance_histogram(locs, info, 0.1, 5.0, device="cpu"))
    X = np.stack([locs["x"], locs["y"]], 1)[:3000]
    np.testing.assert_array_equal(postprocess.nn_analysis(X, X, 2, device=dev),
                                  postprocess.nn_analysis(X, X, 2,
                                                          device="cpu"))
    linked = postprocess.link(locs, info, r_max=1.0, max_dark_time=1,
                              device="cpu")
    dark = postprocess.compute_dark_times(linked, device="cpu")
    compare_tables_ulps(postprocess.groupprops(dark, device=dev),
                        postprocess.groupprops(dark, device="cpu"), 1,
                        "groupprops")
    clusters = dark.copy()
    clusters["group"] = clusters["group"] % 5
    cl = np.empty(len(clusters), clusters.dtype.descr + [("cluster", "<i4")])
    for n in clusters.dtype.names:
        cl[n] = clusters[n]
    cl["cluster"] = dark["group"]
    comb = postprocess.cluster_combine(cl, device="cpu")
    compare_tables_ulps(postprocess.cluster_combine(cl, device=dev), comb, 1,
                        "cluster_combine")
    np.testing.assert_array_equal(
        postprocess.cluster_combine_dist(comb, device=dev),
        postprocess.cluster_combine_dist(comb, device="cpu"))
    vp = ((4.0, 4.0), (36.0, 36.0))
    fg = postprocess.frc(locs, info, vp, device=dev)
    fc = postprocess.frc(locs, info, vp, device="cpu")
    np.testing.assert_allclose(fg["frc_curve"], fc["frc_curve"], rtol=0,
                               atol=1e-9)
    assert abs(fg["resolution"] / fc["resolution"] - 1) <= 1e-6


def test_cluster_sweep_library_equals_its_python_twin(dev):
    """csrc/cluster_sweep.cu (host code in the kernel library) == its
    Python twin on random maxima with overlapping neighbourhoods, one
    launch counted."""
    from picasso_torch.ops import cluster

    rng = np.random.default_rng(5)
    n, m = 2000, 300
    lm = np.sort(rng.choice(n, m, replace=False)).astype(np.int64)
    sizes = rng.integers(0, 60, m)
    stops = np.cumsum(sizes).astype(np.int64)
    starts = stops - sizes
    cols = rng.integers(0, n, int(sizes.sum())).astype(np.int64)
    before = cluster.sweep.launches
    got = cluster.sweep(*(_t(a).to(dev) for a in (lm, starts, stops, cols)),
                        n)
    assert cluster.sweep.launches == before + 1
    np.testing.assert_array_equal(
        got, cluster.sweep_plain(lm, starts, stops, cols, n))


@pytest.mark.parametrize("what", ["smlm 2d", "smlm 3d", "dbscan", "dbscan 3d",
                                  "hdbscan"])
def test_clusterers_on_the_card_equal_the_cpu(dev, what):
    """The clustered locs on the card equal the CPU's (the SMLM sweep in
    the library, once a run); the SMLM centers within CENTERS_ULPS."""
    from picasso_torch import clusterer
    from picasso_torch.ops import cluster
    from torch_data import make_event_locs
    from torch_parity import CENTERS_ULPS, compare_tables_ulps

    locs, _ = make_event_locs(9, n_sites=60, frames=1500, size=32)
    if what.endswith("3d"):
        z = np.random.default_rng(1).normal(0, 40, len(locs))
        locs = postprocess._with_fields(locs, [("z", z.astype(np.float32))])
    run = {
        "smlm 2d": lambda d: clusterer.cluster(locs, 0.1, 5, True, device=d),
        "smlm 3d": lambda d: clusterer.cluster(
            locs, 0.1, 5, True, radius_z=0.3, pixelsize=130, device=d),
        "dbscan": lambda d: clusterer.dbscan(locs, 0.08, 8, device=d),
        "dbscan 3d": lambda d: clusterer.dbscan(locs, 0.08, 8, pixelsize=130,
                                                radius_z=0.3, device=d),
        "hdbscan": lambda d: clusterer.hdbscan(locs[:4000], 10, 10,
                                               device=d),
    }[what]
    before = cluster.sweep.launches
    card = run(dev)
    assert cluster.sweep.launches == before + what.startswith("smlm")
    cpu = run("cpu")
    assert card.dtype == cpu.dtype and len(card) > 0
    for n in card.dtype.names:
        np.testing.assert_array_equal(card[n], cpu[n], err_msg=n)
    if what.startswith("smlm"):
        px = 130 if what.endswith("3d") else None
        compare_tables_ulps(
            clusterer.find_cluster_centers(card, px, device=dev),
            clusterer.find_cluster_centers(card, px, device="cpu"),
            CENTERS_ULPS, "centers")


def test_g5m_on_the_card_matches_the_cpu(dev):
    """G5M's batched route on 16 origami: the card held to the CPU by
    torch_parity.compare_g5m (molecules per cluster equal but at BIC near
    ties, a cluster fit alike within G5M_SAME_ULPS f32 ulps, another fit
    only at an EM near tie); the host route (4 origami) equal bit for
    bit."""
    from picasso_torch import clusterer, g5m
    from torch_data import make_origami_locs
    from torch_parity import compare_g5m

    locs, info, _ = make_origami_locs(16, 2)
    grouped = clusterer.dbscan(locs, 0.1, 10, device="cpu")
    rec_card, rec_cpu = {}, {}
    card = g5m.g5m(grouped, info, postprocess=False, device=dev,
                   record=rec_card)[0]
    cpu = g5m.g5m(grouped, info, postprocess=False, device="cpu",
                  record=rec_cpu)[0]
    assert card.dtype == cpu.dtype and len(card) >= 16 * 10
    compare_g5m(card, rec_card, cpu, rec_cpu, grouped)
    few = grouped[grouped["group"] < 4]
    for a, b in zip(g5m.g5m(few, info, device=dev)[:2],
                    g5m.g5m(few, info, device="cpu")[:2]):
        for n in a.dtype.names:
            np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_average_on_the_card_matches_the_cpu(dev):
    """Averaging's device route on 64 origami: the first iteration's picks
    on the card equal the CPU's but for near ties (1e-5 relative), and
    x, y after two iterations within 1e-3 px."""
    from picasso_torch import average
    from torch_data import make_origami_locs, origami_groups

    locs, info, truth = make_origami_locs(64, 1)
    locs = origami_groups(locs, truth)
    x, y, rows, angles, ov, t_min, t_max = average._workspace(
        average.com_align(locs), info, 5.0)
    _, image = average._render_hist_square(x, y, ov, t_min, t_max)
    picks = {}
    for d in (dev, "cpu"):
        picks[str(d)] = []
        average._align_groups_device(x.copy(), y.copy(), rows, angles, ov,
                                     t_min, t_max, image,
                                     image.shape[0] / 2, d,
                                     picks=picks[str(d)])
    (bc, vc, sc), (bp, vp, sp) = ((np.concatenate(p) for p in zip(*v))
                                  for v in picks.values())
    for g in np.nonzero(bc != bp)[0]:
        assert (vc[g] - sc[g] <= 1e-5 * abs(vc[g])
                or vp[g] - sp[g] <= 1e-5 * abs(vp[g]))
    a = average.average(locs, info, iterations=2, device=dev)
    b = average.average(locs, info, iterations=2, device="cpu")
    for c in ("x", "y"):
        np.testing.assert_allclose(a[c], b[c], rtol=0, atol=1e-3)


@pytest.mark.parametrize("kw", [{}, {"depth": 500.0,
                                      "random_rot_mode": "3D"}])
def test_spinna_scores_on_the_card_match_the_cpu(dev, kw):
    """SPINNA's batched scorer on 8 candidates of a tenth of the smoke's
    cell-scale field (2D; and 3D with 3D rotations), one seed: the same
    keep masks, coordinates within an f32 ulp, the scores within
    torch_parity.compare_spinna_scores."""
    from picasso_torch import spinna
    from torch_data import spinna_cell
    from torch_parity import compare_spinna_scores, spinna_sample_sizes

    mixer, gt = spinna_cell(spinna, 0.1, **kw)
    space = mixer.convert_N_structures_to_array(spinna.generate_N_structures(
        mixer.structures, {"A": 500}, 21))
    rows = space[::29][:8]
    out = {}
    for d in (dev, "cpu"):
        sp = spinna.SPINNA(mixer, gt, N_sim=1, device=d)
        scorer = sp._get_batched_scorer(space)
        coords, masks = scorer.simulate(rows, seed=5)
        out[str(d)] = (scorer.score(rows, seed=5), coords, masks)
    (sc, cc, mc), (sp_, cp, mp) = out[str(dev)], out["cpu"]
    for t in mc:
        np.testing.assert_array_equal(mc[t].cpu().numpy(), mp[t].numpy())
        np.testing.assert_allclose(cc[t].cpu().numpy(), cp[t].numpy(),
                                   rtol=2**-23, atol=1e-3)
    compare_spinna_scores(sc, sp_, spinna_sample_sizes(scorer, mp))


def test_legacy_api_and_camera_arrays_on_the_card(dev):
    """The legacy identification and fit on the card: identify_by_frame_
    number == identify's rows, the legacy fit through the fit2D route's
    kernel (mle_cuda.ROI_FITS) related to fit2D as ROADMAP queue 3
    records, the unit camera as 0-d arrays == the scalar camera's fused
    slice bit for bit, and frame_chunk == the default bit for bit."""
    cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    params = {"Min. Net Gradient": 4000, "Box Size": 7}
    movie = make_bench_movie(96, 64, 40, 0.5, np.random.default_rng(21))
    ids = localize.identify(movie, 4000, 7, device="cuda")
    for f in (0, 50, 95):
        np.testing.assert_array_equal(localize.identify_by_frame_number(
            movie, 4000, 7, f, device="cuda"), ids[ids["frame"] == f])
    fit = mle_cuda.ROI_FITS["sigmaxy"]
    fit.launches = 0
    legacy = localize.fit(movie, dict(cam), ids, 7, device="cuda")
    assert fit.launches > 0
    ref, _ = localize.fit2D(movie, [{}], dict(cam), ids, 7,
                            fitting_method="gaussmle", device="cuda")
    np.testing.assert_allclose(
        legacy["x"].astype(np.float64),
        ref["y"].astype(np.float64) - ids["y"] + ids["x"] + 3, rtol=0,
        atol=2e-5)
    np.testing.assert_array_equal(legacy["sx"], ref["sy"])
    scalar = localize.localize(movie, dict(cam), params,
                               fitting_method="gaussmle", device="cuda")
    zero_d = localize.localize(movie, {k: np.array(v) for k, v in
                                       cam.items()}, params,
                               fitting_method="gaussmle", device="cuda")
    for c in scalar.dtype.names:
        np.testing.assert_array_equal(zero_d[c], scalar[c], err_msg=c)
    perf = {}
    a = fused.localize_fused(movie, 4000, 7, cam, device="cuda")
    b = fused.localize_fused(movie, 4000, 7, cam, frame_chunk=32, perf=perf,
                             device="cuda")
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    assert perf["n_chunks"] == 3 and perf["drain_s"] >= 0


def test_simulate_then_localize_on_the_card(dev):
    from scipy.spatial import cKDTree

    from picasso_torch import simulate

    movie, sites, info = simulate.simulate_movie(
        n_sites=16, imagesize=32, frames=400, taud=3000, photonrate=60,
        seed=7)
    locs = localize.localize(
        movie, {"Baseline": 0, "Sensitivity": 1, "Gain": 1,
                "Pixelsize": 130}, {"Min. Net Gradient": 3000, "Box Size": 7},
        movie_info=[info], fitting_method="gaussmle", device="cuda")
    d, _ = cKDTree(sites).query(np.column_stack([locs["x"], locs["y"]]))
    assert len(locs) > 50 and np.median(d) < 1.0


def test_nanotron_on_the_card_matches_the_cpu(dev):
    """Two origami designs, 24 picks each: the renders card vs CPU
    within 1e-6 of their maximum, and 5 epochs from the same weights on
    each within torch_parity.compare_mlp."""
    from picasso_torch import nanotron
    from torch_data import (make_origami_locs, origami_groups,
                            origami_rows_template)
    from torch_parity import compare_mlp

    data = {"cuda": [], "cpu": []}
    for label, tmpl, seed in ((0, None, 31), (1, origami_rows_template(), 32)):
        locs, _, truth = make_origami_locs(24, seed, template=tmpl)
        picks = origami_groups(locs, truth)
        for d in data:
            data[d] += nanotron.prepare_data(picks, label, 0.5, 40,
                                             device=d)[0]
    X = np.stack(data["cpu"])
    np.testing.assert_allclose(np.stack(data["cuda"]), X, rtol=0,
                               atol=1e-6 * X.max())
    y = np.repeat([0, 1], 96)
    init = nanotron.init_params([1600, 100, 2], seed=0)
    models = {d: nanotron.MLPClassifier(max_iter=5, batch_size=32,
                                        device=d).fit(X, y, params=init)
              for d in ("cuda", "cpu")}
    compare_mlp(models["cuda"].loss_curve_, models["cpu"].loss_curve_,
                models["cuda"].predict(X), models["cpu"].predict(X),
                what="nanotron card vs CPU")


def test_average3_on_the_card_matches_the_cpu(dev):
    """JAX's recipe at 64 groups and 24 3D origami at the defaults: every
    pass's picks card vs CPU within torch_parity.compare_average3."""
    from picasso_torch import average3
    from torch_data import make_average3_locs, make_origami3d_locs
    from torch_parity import compare_average3_passes

    info = [{"Frames": 100, "Height": 64, "Width": 64, "Pixelsize": 130}]
    origami, info_o, _ = make_origami3d_locs(24, 0)
    for locs, inf, kw in (
            (make_average3_locs(64), info,
             dict(iterations=2, oversampling=8, rot_axes=("z",))),
            (origami, info_o, {})):
        picks = {}
        for d in ("cuda", "cpu"):
            picks[d] = []
            average3.average3(locs, inf, device=d, picks=picks[d], **kw)
        compare_average3_passes(picks["cuda"], picks["cpu"],
                                "average3 card vs CPU")


def test_similar_picks_on_the_card_match_the_cpu(dev):
    """pick_similar on 64 origami from 20 seed picks: the card's walks
    against the CPU's under torch_parity.compare_similar_picks, every pick
    within 0.05 px of a true centre."""
    from scipy.spatial import cKDTree

    from torch_data import make_origami_locs
    from torch_parity import compare_similar_picks

    locs, info, truth = make_origami_locs(64, 0)
    seeds = [tuple(c) for c in truth["centers"][:20]]
    runs = {}
    for d in ("cuda", "cpu"):
        rec = {}
        runs[d] = postprocess.pick_similar(locs, info, seeds, 1.0, device=d,
                                           record=rec), rec
    out = compare_similar_picks(*runs["cuda"], *runs["cpu"],
                                what="pick_similar card vs CPU")
    assert out["matched"] > 10
    got = np.array(runs["cuda"][0], np.float64)
    assert cKDTree(truth["centers"]).query(got)[0].max() < 0.05


def test_picks_kinetics_and_properties_on_the_card_match_the_cpu(dev):
    """pick_properties, evaluate_picks, pick_kinetics and
    combine_locs_in_picks on 64 origami's picks: the card equals the CPU,
    the events' and the group statistics' floats within one f32 ulp (f64
    atomics), the kinetic fits and counts bit for bit."""
    from torch_data import make_origami_locs
    from torch_parity import compare_tables_ulps

    locs, info, truth = make_origami_locs(64, 1)
    picks = [tuple(map(float, c)) for c in truth["centers"]]
    picked = postprocess.picked_locs(locs, info, picks, "Circle", 0.5)
    props = {d: postprocess.pick_properties(picked, info, device=d)
             for d in ("cuda", "cpu")}
    stats = [n for n in props["cpu"].dtype.names if n not in (
        "n_units", "locs", "length_cdf", "dark_cdf", "qpaint_idx_cdf")]
    compare_tables_ulps(props["cuda"][stats], props["cpu"][stats], 1,
                        "pick_properties card vs CPU")
    for n in ("n_units", "locs", "length_cdf", "dark_cdf"):
        np.testing.assert_array_equal(props["cuda"][n], props["cpu"][n])
    ev = {d: postprocess.evaluate_picks(picked, info, device=d)
          for d in ("cuda", "cpu")}
    for a, b in zip(ev["cuda"][:6], ev["cpu"][:6]):
        np.testing.assert_array_equal(a, b)
    compare_tables_ulps(ev["cuda"][6], ev["cpu"][6], 1, "evaluate_picks")
    kin = {d: postprocess.pick_kinetics(picked, info, device=d)
           for d in ("cuda", "cpu")}
    for a, b in zip(kin["cuda"][:3], kin["cpu"][:3]):
        np.testing.assert_array_equal(a, b)
    kw = dict(picks=picks, pick_shape="Circle", pick_size=1.0)
    compare_tables_ulps(
        postprocess.combine_locs_in_picks(locs, info, device="cuda", **kw),
        postprocess.combine_locs_in_picks(locs, info, device="cpu", **kw), 1,
        "combine_locs_in_picks card vs CPU")


def test_mask_on_the_card_equals_the_cpu(dev):
    """generate_image renders on the card the CPU's image bit for bit;
    mask_image of it by every method, and mask_locs, are the CPU's."""
    from picasso_torch import masking
    from torch_data import make_origami_locs

    locs, info, _ = make_origami_locs(64, 2)
    image = {d: masking.generate_image(locs, info, 65.0, 100.0, device=d)
             for d in ("cuda", "cpu")}
    np.testing.assert_array_equal(image["cuda"], image["cpu"])
    for method in masking.THRESHOLD_METHODS:
        mask = masking.mask_image(image["cuda"], method)
        np.testing.assert_array_equal(
            mask, masking.mask_image(image["cpu"], method))
    inside, outside = masking.mask_locs(locs, mask, info=info)
    assert len(inside) + len(outside) == len(locs)


def _locs3d(n, seed):
    """3D locs over a 64 px field, z and lpz in camera pixels."""
    rng = np.random.default_rng(seed)
    locs = np.zeros(n, [("frame", np.uint32), ("x", np.float32),
                        ("y", np.float32), ("z", np.float32),
                        ("lpx", np.float32), ("lpy", np.float32),
                        ("lpz", np.float32)])
    locs["x"], locs["y"] = rng.uniform(-1, 65, (2, n))
    locs["z"] = rng.uniform(-3, 3, n)
    locs["lpx"], locs["lpy"] = rng.uniform(0.02, 0.3, (2, n))
    locs["lpz"] = rng.uniform(0.05, 0.6, n)
    return locs, [{"Frames": 10, "Height": 64, "Width": 64,
                   "Pixelsize": 130}]


@pytest.mark.parametrize("blur", [None, "gaussian", "gaussian_iso", "smooth",
                                  "convolve"])
@pytest.mark.parametrize("device_route", [False, True])
def test_render3d_rotated_view_on_the_card_matches_the_cpu(
        dev, blur, device_route, monkeypatch):
    """A tilted view of every blur on both of JAX's routes: histograms,
    smooth and convolve equal (the rotation in f64 on either side), the
    covariance splats within 1e-5 of the image max."""
    from picasso_torch import render
    from picasso_torch.ops import render_ops

    if device_route:
        monkeypatch.setattr(render_ops, "DEVICE_MIN_LOCS", 0)
    locs, info = _locs3d(6000, 8)
    kw = dict(oversampling=5.3, viewport=((3.3, 2.7), (60.1, 61.9)),
              blur_method=blur, ang=(0.3, 0.5, 0.2), min_blur_width=0.01)
    ng, g = render.render(locs, info, device=dev, **kw)
    nc, c = render.render(locs, info, device="cpu", **kw)
    assert ng == nc > 4000
    if blur in (None, "smooth", "convolve"):
        np.testing.assert_array_equal(g, c)
    else:
        assert np.abs(g - c).max() <= 1e-5 * c.max()


def test_render3d_hist3d_on_the_card_equals_the_cpu(dev, monkeypatch):
    from picasso_torch import render
    from picasso_torch.ops import render_ops

    locs, _ = _locs3d(20000, 9)
    args = (locs["x"], locs["y"], locs["z"] * 130, 3.0, 2.0, 1.0, 60.0, 62.0,
            -300.0, 320.0, 130)
    for threshold in (render_ops.DEVICE_MIN_LOCS, 0):
        monkeypatch.setattr(render_ops, "DEVICE_MIN_LOCS", threshold)
        ng, g = render.render_hist3d(*args, device=dev)
        nc, c = render.render_hist3d(*args, device="cpu")
        assert ng == nc == g.sum() and g.shape == c.shape
        np.testing.assert_array_equal(g, c)


def test_scene_on_the_card_matches_the_cpu(dev):
    """Two channels with LUT colours and one with a LUT colormap, as the
    card's machine (no matplotlib) renders them: within one level."""
    from picasso_torch import render

    chans = [_locs3d(4000, s) for s in (10, 11)]
    # LUTs that rise by less than a level an index
    luts = [render.solid_to_lut((1, 0.4, 0)), render.stops_to_lut(
        [(0, 0, 0, 0), (0.5, 0.2, 0.4, 0.45), (1, 0.65, 0.85, 0.9)])]
    for locs, info, kw in (
            ([c[0] for c in chans], [c[1] for c in chans],
             dict(colors=luts)),
            (chans[0][0], chans[0][1],
             dict(single_channel_colormap=luts[1]))):
        kw.update(disp_px_size=20.0, blur_method="gaussian")
        g = render.render_scene(locs, info, device=dev, **kw)
        c = render.render_scene(locs, info, device="cpu", **kw)
        assert g[1] == c[1] and g[0].shape == c[0].shape
        assert np.abs(g[0].astype(int) - c[0]).max() <= 1


def _mesh(n=4):
    from picasso_torch.parallel import mesh as pmesh

    if torch.cuda.device_count() > 1:
        return pmesh.default_mesh()
    return pmesh.Mesh(["cuda:0"] * n)


@pytest.mark.parametrize("method", ["sigmaxy", "sigma", "lq"])
def test_mesh_localize_equals_one_card(dev, method):
    """localize_fused over a mesh (logical shards on one card, in
    turns) == on one card, hits and fits bit for bit; each shard
    launched K4 once a chunk and its fit."""
    mesh = _mesh()
    movie = make_bench_movie(48, 128, 300, 0.5, np.random.default_rng(13))
    cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1}
    kw = dict(fitting_method="gausslq" if method == "lq" else "gaussmle",
              mle_method="sigmaxy" if method == "lq" else method,
              frame_chunk=16, max_it=MAX_IT)
    one = fused.localize_fused(movie, 4000, 7, cam, device="cuda:0", **kw)
    mesh.reset_launches()
    got = fused.localize_fused(movie, 4000, 7, cam, device=mesh, **kw)
    for name in one[0].dtype.names:
        np.testing.assert_array_equal(got[0][name], one[0][name])
    for a, b in zip(got[1], one[1]):
        np.testing.assert_array_equal(a, b)
    fit = ("fit_lq_queue_t" if method == "lq" else "fit_mle_queue_t")
    for d in mesh.launches:
        counts = {k.rsplit(".", 1)[1]: v for k, v in d.items()}
        assert counts["identify_tiles"] == 3
        assert counts[fit] == 3 * (1 if method == "lq" else 2)


def test_mesh_fits_equal_the_routes(dev):
    from picasso_torch import gaussmle
    from picasso_torch.parallel import mesh as pmesh

    mesh = _mesh()
    spots = make_spots(4000, 7, seed=5)
    for method in ("sigmaxy", "sigma"):
        got = pmesh.fit_mle_sharded(spots, EPS, MAX_IT, method, mesh)
        ref = gaussmle.gaussmle(spots, EPS, MAX_IT, method, device="cuda:0")
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        pmesh.fit_lq_sharded(spots, 30, FTOL, mesh),
        lq.fit_spots_batched(spots, 30, device="cuda:0"))


def test_mesh_dryrun_on_the_card(dev):
    from picasso_torch.parallel.dryrun import dryrun_multichip

    mesh = _mesh()
    assert "OK" in dryrun_multichip(mesh.size, devices=list(mesh.devices))


# --- every box: box 3 templated, the any-box kernels elsewhere ----------


def _counts():
    return {f: f.launches for f in (
        mle_cuda.fit_anybox_t, mle_cuda.fit_anybox_one_pass_t,
        lq_cuda.fit_anybox_t, lq_cuda.fit_anybox_one_pass_t,
        winfit_cuda.cut_anybox_t, winfit_cuda.cut_anybox_direct_t,
        identify_cuda.identify_tiles_anybox,
        identify_cuda.identify_tiles_anybox_direct, mle_cuda.fit_t,
        mle_cuda.fit_one_pass_t, mle_cuda.fit_boundary_t,
        mle_cuda.fit_multiround_t, lq_cuda.fit_t, lq_cuda.fit_queue_t,
        lq_cuda.fit_boundary_t, identify_cuda.identify_tiles,
        winfit_cuda.fit_mle_queue_t, winfit_cuda.fit_lq_queue_t)}


def _launched(before):
    """{"module.wrapper": launches} of the wrappers counted since
    ``before`` (:func:`_counts`)."""
    return {f"{f.__module__.rsplit('.', 1)[1]}.{f.__name__}": f.launches - n
            for f, n in before.items() if f.launches - n}


@pytest.mark.parametrize("box", [5, 7, 9, 11, 13, 15])
def test_anybox_fits_equal_the_templated_kernels(dev, box):
    """The any-box MLE queue and one-thread pass (both methods, with the
    CRLB/LL) and the any-box LM body at the templated boxes equal the
    one-thread passes bit for bit: their rounding order is the templated
    body's."""
    sp = _rois(2048, box, box + 40, dev)
    for method in ("sigmaxy", "sigma"):
        one = _np(mle_cuda.fit_one_pass_t(sp, EPS, MAX_IT, method))
        _assert_same(_np(mle_cuda.fit_anybox_t(sp, EPS, MAX_IT, method)), one)
        _assert_same(_np(mle_cuda.fit_anybox_one_pass_t(sp, EPS, MAX_IT,
                                                        method)), one)
    np.testing.assert_array_equal(
        lq_cuda.fit_anybox_t(sp, MAX_IT).cpu().numpy(),
        lq_cuda.fit_t(sp, MAX_IT).cpu().numpy())


def test_box3_fits_equal_the_one_thread_pass(dev):
    """Box 3 in the templated kernels: K1's queue, K2's phases, K7 and the
    any-box body == the one-thread pass, the LM queue == K3's one pass,
    bit for bit; against the plain fit by compare_fits_max_it (max_it 5)
    and compare_lq_fits' box-3 bounds."""
    sp = _rois(8192, 3, 3, dev)
    for method in ("sigmaxy", "sigma"):
        one = _np(mle_cuda.fit_one_pass_t(sp, EPS, MAX_IT, method))
        for fit in (mle_cuda.fit_t, mle_cuda.fit_boundary_t,
                    mle_cuda.fit_anybox_t):
            _assert_same(_np(fit(sp, EPS, MAX_IT, method)), one)
        compare_fits_max_it(_np(mle._fit_core(sp, EPS, 5, method)),
                            _np(mle_cuda.fit_t(sp, EPS, 5, method)), 5)
    _assert_same(_np(mle_cuda.fit_multiround_t(sp, EPS, MAX_IT)),
                 _np(mle_cuda.fit_one_pass_t(sp, EPS, MAX_IT)))
    k3 = lq_cuda.fit_t(sp, 30).cpu().numpy()
    np.testing.assert_array_equal(lq_cuda.fit_queue_t(sp, 30).cpu().numpy(),
                                  k3)
    compare_lq_fits(lq._lm_core(sp, 30, FTOL).cpu().numpy(), k3,
                    sp.cpu().numpy(), "box 3", box3=True)


# launch arguments of the any-box MLE queue beside its default: every
# place of the pixels with the column factors in shared and in global
# memory
ANYBOX_VARIANTS = ({}, *({"stage": st, "cols_shared": co}
                         for st in ("batch", "shared") for co in (True, False)))


@pytest.mark.parametrize("box", [1, 2, 4, 8, 16, 17, 21, 45])
def test_anybox_queue_equals_the_one_thread_pass(dev, box):
    """The any-box MLE work queue (both methods) with its default launch
    arguments and the variants of ANYBOX_VARIANTS (those whose shared
    bytes fit) equals the any-box one-thread pass bit for bit; lanes at
    n_valid and beyond start converged; at box 45 a stage in shared
    memory does not fit, and the tail's lanes loop over two rounds; at
    boxes 1 and 2 every pixel lies on the border (at box 1 the CRLB is
    NaN, one pixel's Fisher matrix singular, in both)."""
    n = 512 if box == 45 else 2048
    sp = _rois(n, box, box + 60, dev)
    lib = mle_cuda._build.library()
    for method in ("sigmaxy", "sigma"):
        one = _np(mle_cuda.fit_anybox_one_pass_t(sp, EPS, MAX_IT, method))
        for kw in ANYBOX_VARIANTS:
            cfg = dict(mle_cuda.anybox_queue_config(box), **kw)
            if mle_cuda.anybox_queue_smem(box, cfg["stage"],
                                          cfg["cols_shared"]) > \
                    mle_cuda.SHARED_LIMIT:
                continue
            coop = torch.zeros(1, dtype=torch.int32, device=dev)
            _assert_same(_np(mle_cuda._launch_anybox(
                lib, sp, EPS, MAX_IT, method, None, cfg, coop)), one)
        before = _counts()
        _assert_same(_np(mle_cuda.fit_anybox_t(sp, EPS, MAX_IT, method)), one)
        assert _launched(before) == {"mle_cuda.fit_anybox_t": 1}
        n_valid = n - 64
        one = _np(mle_cuda.fit_anybox_one_pass_t(sp, EPS, MAX_IT, method,
                                                 n_valid))
        assert one[3][n_valid:].max() == 0
        _assert_same(_np(mle_cuda.fit_anybox_t(sp, EPS, MAX_IT, method,
                                               n_valid)), one)
    _assert_lq_queue_equals_the_one_pass(sp, box, lib)


# launch arguments of the any-box LM queue beside its default: every
# place of the pixels and threads a block (its group and claim are
# compile-time constants; tests/torch_anybox_sweep.py holds their -D
# builds to the one-thread pass)
LQ_ANYBOX_VARIANTS = ({}, *({"stage": st, "threads": t}
                            for st in ("batch", "shared")
                            for t in (32, 64, 128)))


def _assert_lq_queue_equals_the_one_pass(sp, box, lib):
    """The any-box LM queue with its default launch arguments and the
    variants of LQ_ANYBOX_VARIANTS (those whose shared bytes fit) equals
    the any-box one-thread pass bit for bit, also with lanes at n_valid
    and beyond starting done; counted on its own counter."""
    n = sp.shape[-1]
    for n_valid in (None, n - 64):
        one = lq_cuda.fit_anybox_one_pass_t(sp, MAX_IT, FTOL,
                                            n_valid).cpu().numpy()
        for kw in LQ_ANYBOX_VARIANTS:
            cfg = dict(lq_cuda.anybox_queue_config(box), **kw)
            if lq_cuda.anybox_queue_smem(box, cfg["stage"], cfg["threads"]) \
                    > lq_cuda.SHARED_LIMIT:
                continue
            np.testing.assert_array_equal(lq_cuda._launch_anybox(
                lib, sp, MAX_IT, FTOL, n_valid, cfg).cpu().numpy(), one)
        before = _counts()
        np.testing.assert_array_equal(
            lq_cuda.fit_anybox_t(sp, MAX_IT, FTOL, n_valid).cpu().numpy(),
            one)
        assert _launched(before) == {"lq_cuda.fit_anybox_t": 1}


def test_lq_anybox_queue_reads_the_batch_where_no_stage_fits(dev):
    """At box 120 a warp's group stages pass the shared bytes a block may
    hold: the LM queue's groups read the pixels from the batch (15
    rounds of 8 points and rows a lane) and still equal the one-thread
    pass bit for bit."""
    box = 120
    assert lq_cuda.anybox_queue_config(117)["stage"] == "shared"
    assert lq_cuda.anybox_queue_config(box)["stage"] == "batch"
    sp = _rois(96, box, 11, dev)
    lib = mle_cuda._build.library()
    _assert_lq_queue_equals_the_one_pass(sp, box, lib)


def test_anybox_queue_refuses_what_it_does_not_take(dev):
    """The any-box queue's entry refuses launch arguments outside its
    range (a group below box + 1 short of a warp, shared bytes above the
    card's limit), and reports its compile-time threads a block."""
    lib = mle_cuda._build.library()
    for box, kw in ((17, {"group": 16}), (45, {"stage": "shared"}),
                    (40, {"cols_shared": True})):
        sp = _rois(256, box, 3, dev)
        with pytest.raises(RuntimeError, match="CUDA error"):
            mle_cuda._launch_anybox(lib, sp, EPS, MAX_IT, "sigmaxy", None,
                                    dict(mle_cuda.anybox_queue_config(box),
                                         **kw))
    assert mle_cuda.anybox_queue_info(17)["threads"] == \
        mle_cuda.ANYBOX_THREADS
    # the LM queue's entry: a stage above the card's limit, threads it
    # is not built for
    for box, kw in ((120, {"stage": "shared"}), (17, {"threads": 96}),
                    (17, {"threads": 256})):
        sp = _rois(256, box, 3, dev)
        with pytest.raises(RuntimeError, match="CUDA error"):
            lq_cuda._launch_anybox(lib, sp, MAX_IT, FTOL, None, dict(
                lq_cuda.anybox_queue_config(box), **kw))
    info = lq_cuda.anybox_queue_info(17)
    assert info["threads"] == lq_cuda.anybox_queue_config(17)["threads"]
    assert info["group"] == lq_cuda.ANYBOX_GROUP
    assert info["shared_bytes"] == \
        lq_cuda.anybox_queue_config(17)["shared_bytes"]
    # the tiled cut's entry: a tile that is not a power of two up to 32,
    # a band of more rows than the box
    frames, hits = _chunk(make_spots(64, 17, seed=3), np.uint16, dev)
    for cfg in ({"hits": 3, "rows": 17}, {"hits": 64, "rows": 17},
                {"hits": 32, "rows": 18}, {"hits": 32, "rows": 0}):
        with pytest.raises(RuntimeError, match="CUDA error"):
            winfit_cuda._launch_cut(lib, frames, hits, 17, 0.0, 1.0, cfg)


@pytest.mark.parametrize("box", [1, 2, 8, 17, 21])
def test_anybox_fits_route_count_and_match_plain(dev, box):
    """At a box without a templated kernel every fit wrapper goes to the
    any-box kernel (one launch, counted there, none of its own) and
    matches the plain fit (at boxes 1 and 2 by _hold_small_mle /
    _hold_small_lq). The fused chain at that box runs K4 any-box, the
    cut and the fit; at boxes 1 and 2 its identify raises, as
    picasso_tpu's, and nothing is launched."""
    small = box < identify.MIN_BOX
    sp = _rois(SMALL_SPOTS if small else 1024, box, box, dev)
    max_it = SMALL_MAX_IT if small else MAX_IT
    for method in ("sigmaxy", "sigma"):
        plain = _np(mle._fit_core(sp, EPS, max_it, method))
        for fit in (mle_cuda.fit_t, mle_cuda.fit_one_pass_t,
                    mle_cuda.fit_boundary_t):
            before = _counts()
            got = _np(fit(sp, EPS, max_it, method))
            assert _launched(before) == {"mle_cuda.fit_anybox_t": 1}
            if small:
                _hold_small_mle(sp, got, method)
            else:
                compare_fits(plain, got, MAX_IT)
    before = _counts()
    mle_cuda.fit_multiround_t(sp, EPS, max_it)
    assert _launched(before) == {"mle_cuda.fit_anybox_t": 1}
    lq_it = SMALL_LQ_IT if small else MAX_IT
    plain = lq._lm_core(sp, lq_it, FTOL).cpu().numpy()
    for fit in (lq_cuda.fit_t, lq_cuda.fit_queue_t, lq_cuda.fit_boundary_t,
                lq_cuda.fit_anybox_t):
        before = _counts()
        got = fit(sp, lq_it).cpu().numpy()
        assert _launched(before) == {"lq_cuda.fit_anybox_t": 1}
        if small:
            _hold_small_lq(sp, got)
        else:
            compare_lq_fits(plain, got, sp.cpu().numpy())
    # the fused chain at this box: K4 any-box, the tiled cut and the
    # any-box fit once each, the first forms not at all
    movie = make_bench_movie(4, 2 * box + 24, 6, 0.5,
                             np.random.default_rng(box))
    frames = identify.upload_frames(movie, dev)
    if small:
        for method in ("lq", "sigmaxy"):
            before = _counts()
            with pytest.raises(ValueError, match="boxes >= 3"):
                fused.identify_cut_fit(frames, 100.0, 0.0, 1.0, box=box,
                                       eps=EPS, max_it=MAX_IT, method=method)
            assert _launched(before) == {}
        return
    for method in ("lq", "sigmaxy"):
        before = _counts()
        out = fused.identify_cut_fit(frames, 100.0, 0.0, 1.0, box=box,
                                     eps=EPS, max_it=MAX_IT, method=method)
        fit = "lq_cuda" if method == "lq" else "mle_cuda"
        k4 = ("identify_cuda.identify_tiles_anybox" if box not in
              identify_cuda.BOXES else "identify_cuda.identify_tiles")
        want = {k4: 1, "winfit_cuda.cut_anybox_t": 1,
                f"{fit}.fit_anybox_t": 1} if len(out[0]) else {k4: 1}
        assert _launched(before) == want


# output tiles of the any-box K4 beside its default
K4_ANY_TILES = ((1, 32), (7, 32), (32, 64), (64, 128), (16, 256))


@pytest.mark.parametrize("box", [3, 5, 7, 9, 11, 13, 15, 17, 21, 31, 8, 4])
def test_identify_anybox_kernel(dev, box):
    """K4 at any box: == the templated K4 bit for bit at 3-15 and == the
    direct kernel bit for bit at every box, in its default tile and those
    of K4_ANY_TILES, == the plain version (compare_tiles), on small
    frames at the K4 shapes, u16 and f32 with NaN pixels; counted on its
    own counter, and identify_tiles routes boxes without a template to
    it."""
    rng = np.random.default_rng(box)
    for shape in K4_SHAPES:
        frames = small_frames(shape, rng)
        nan = frames.astype(np.float32)
        nan[:, ::7, ::5] = np.nan
        got = []
        for x in (torch.from_numpy(frames.astype(np.uint16)).to(dev),
                  torch.from_numpy(nan).to(dev)):
            before = _counts()
            k = _np(identify_cuda.identify_tiles_anybox(x, 3000.0, box))
            got.append(k)
            assert _launched(before) == {
                "identify_cuda.identify_tiles_anybox": 1}
            compare_tiles(k, _np(identify.identify_tiles_plain(x, 3000.0,
                                                               box)),
                          f"box {box} {shape}")
            _assert_same(k, _np(identify_cuda.identify_tiles_anybox_direct(
                x, 3000.0, box)))
            for tile in K4_ANY_TILES:  # those whose shared bytes fit
                if identify_cuda.anybox_tile_bytes(box, *tile) <= \
                        identify_cuda.SHARED_LIMIT:
                    _assert_same(_np(identify_cuda._anybox_launch(
                        x, 3000.0, box, tile)), k)
        x = torch.from_numpy(frames.astype(np.uint16)).to(dev)
        before = _counts()
        routed = _np(identify_cuda.identify_tiles(x, 3000.0, box))
        templated = box in identify_cuda.BOXES
        assert _launched(before) == {"identify_cuda." + (
            "identify_tiles" if templated else "identify_tiles_anybox"): 1}
        _assert_same(routed, got[0])


@pytest.mark.parametrize("box", [96, 101])
def test_identify_routes_a_box_without_a_tile_to_the_direct_kernel(dev, box):
    """At a box where no tile of the any-box K4 fits in a block's shared
    memory (96 and above), identify_tiles launches the direct kernel
    (counted there) and matches the plain version, and
    identify_tiles_anybox raises; the fused chain at that box (K4, the
    any-box cut and MLE queue) finds the CPU's hits, a bright centre
    pixel among them."""
    assert not identify_cuda.anybox_tile_fits(box)
    rng = np.random.default_rng(box)
    frames = small_frames((3, box + 40, box + 57), rng, spots=3)
    # a bright pixel at each frame's centre, a local maximum that the
    # border admits whatever the spots
    frames[:, frames.shape[1] // 2, frames.shape[2] // 2] += 5000
    x = torch.from_numpy(frames.astype(np.uint16)).to(dev)
    before = _counts()
    got = _np(identify_cuda.identify_tiles(x, 100.0, box))
    assert _launched(before) == {
        "identify_cuda.identify_tiles_anybox_direct": 1}
    compare_tiles(got, _np(identify.identify_tiles_plain(x, 100.0, box)),
                  f"box {box}")
    with pytest.raises(ValueError, match="no tile"):
        identify_cuda.identify_tiles_anybox(x, 100.0, box)
    kw = dict(box=box, eps=EPS, max_it=MAX_IT)
    before = _counts()
    out = fused.identify_cut_fit(x, float("-inf"), 0.0, 1.0, **kw)
    assert set(_launched(before)) == {
        "identify_cuda.identify_tiles_anybox_direct",
        "winfit_cuda.cut_anybox_t", "mle_cuda.fit_anybox_t"}
    ref = fused.identify_cut_fit(x.cpu(), float("-inf"), 0.0, 1.0, **kw)
    compare_hits([a.cpu().numpy() for a in ref[:4]],
                 [a.cpu().numpy() for a in out[:4]], float("-inf"))
    assert len(out[0]) > 0 and np.isfinite(out[4].cpu().numpy()).all()


# launch arguments of the tiled cut beside its default: fewer hits a
# tile, the window in bands of rows
CUT_VARIANTS = ({"hits": 8, "rows": 1}, {"hits": 16, "rows": 3},
                {"hits": 32, "rows": 5}, {"hits": 1, "rows": 2})


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("box", [1, 2, 4, 7, 8, 15, 17, 21])
def test_cut_anybox_and_the_fused_fits_at_any_box(dev, box, dtype):
    """The tiled any-box cut (its default tile and those of CUT_VARIANTS,
    a last tile short of hits; on int64 hit rows as compaction gives
    them, one of them strided, on int32 rows, and on rows of stride 0) ==
    its direct kernel == the gather route's ROIs bit for bit, each
    counted on its own counter; K5's wrappers at a
    box without a template = cut + any-box fit (counted there), equal to
    the any-box fits of those ROIs; at 7 and 15 the cut feeds the any-box
    bodies to the templated K5's numbers; at box 2 a window starts one
    pixel before its centre (picasso_tpu's native cut), at box 1 it is
    the centre pixel."""
    spots = make_spots(2045, box, seed=box + 5)
    frames, hits = _chunk(spots, dtype, dev)
    rois = winfit_cuda.photons_t(frames, *hits, box, BASELINE, FACTOR)
    before = _counts()
    cut = winfit_cuda.cut_anybox_t(frames, *hits, box, BASELINE, FACTOR)
    assert _launched(before) == {"winfit_cuda.cut_anybox_t": 1}
    np.testing.assert_array_equal(cut.cpu().numpy(), rois.cpu().numpy())
    before = _counts()
    direct = winfit_cuda.cut_anybox_direct_t(frames, *hits, box, BASELINE,
                                             FACTOR)
    assert _launched(before) == {"winfit_cuda.cut_anybox_direct_t": 1}
    np.testing.assert_array_equal(direct.cpu().numpy(), rois.cpu().numpy())
    lib = winfit_cuda._build.library()
    assert all(h.dtype == torch.int64 for h in hits)
    for cfg in CUT_VARIANTS:
        cfg = dict(cfg, rows=min(cfg["rows"], box))
        np.testing.assert_array_equal(winfit_cuda._launch_cut(
            lib, frames, hits, box, BASELINE, FACTOR, cfg).cpu().numpy(),
            rois.cpu().numpy())
    # rows of an (N, 3) list (torch.nonzero's, stride 3), int32 rows, and
    # every hit in one frame as an expanded row (stride 0)
    strided = torch.stack(hits, 1).unbind(1)
    assert strided[0].stride(0) == 3
    zero = torch.zeros(1, dtype=torch.int64, device=dev).expand(
        len(hits[0]))
    for rows in (strided, [h.to(torch.int32) for h in hits],
                 (zero, hits[1], hits[2])):
        np.testing.assert_array_equal(
            winfit_cuda.cut_anybox_t(frames, *rows, box, BASELINE,
                                     FACTOR).cpu().numpy(),
            winfit_cuda.photons_t(frames, *rows, box, BASELINE,
                                  FACTOR).cpu().numpy())
    for method in ("sigmaxy", "sigma"):
        kw = dict(box=box, eps=EPS, max_it=MAX_IT, method=method)
        want = _np(mle_cuda.fit_anybox_t(cut, EPS, MAX_IT, method))
        for fit in (winfit_cuda.fit_mle_queue_t, winfit_cuda.fit_mle_t,
                    winfit_cuda.fit_mle_boundary_t):
            got = _np(fit(frames, *hits, BASELINE, FACTOR, **kw))
            _assert_same(got, want)
    lq_want = lq_cuda.fit_anybox_t(cut, 30, FTOL).cpu().numpy()
    before = _counts()
    got = winfit_cuda.fit_lq_queue_t(frames, *hits, BASELINE, FACTOR,
                                     box=box, max_it=30)
    templated = box in identify_cuda.BOXES
    assert _launched(before) == ({"winfit_cuda.fit_lq_queue_t": 1}
                                 if templated else
                                 {"winfit_cuda.cut_anybox_t": 1,
                                  "lq_cuda.fit_anybox_t": 1})
    np.testing.assert_array_equal(got.cpu().numpy(), lq_want)


@pytest.mark.parametrize("method", ["gaussmle", "gausslq"])
def test_localize_at_box_17_on_the_card_matches_the_cpu(dev, method):
    """localize at box 17 (make_wide_movie): hits equal, fits within the
    tolerances of the plain path, through K4 any-box, the any-box cut
    and fit."""
    from torch_data import make_wide_movie

    movie = make_wide_movie(32, 96, 12, 0.5, np.random.default_rng(23))
    cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1}
    kw = dict(fitting_method=method, max_it=MAX_IT)
    before = _counts()
    ids, fits = fused.localize_fused(movie, 5000, 17, cam, device="cuda",
                                     **kw)
    launched = _launched(before)
    ref_ids, ref = fused.localize_fused(movie, 5000, 17, cam, device="cpu",
                                        **kw)
    fit = "mle_cuda" if method == "gaussmle" else "lq_cuda"
    assert set(launched) == {"identify_cuda.identify_tiles_anybox",
                             "winfit_cuda.cut_anybox_t", f"{fit}.fit_anybox_t"}
    cols = ("frame", "y", "x", "net_gradient")
    compare_hits([ref_ids[c] for c in cols], [ids[c] for c in cols], 5000)
    assert len(ids) == len(ref_ids) >= 100
    if method == "gaussmle":
        compare_fits([ref[0].T, ref[1].T, ref[2], ref[3]],
                     [fits[0].T, fits[1].T, fits[2], fits[3]], MAX_IT)
    else:  # compare_lq_fits' x/y percentiles
        dxy = np.abs(fits[0][:, :2] - ref[0][:, :2]).max(axis=1)
        assert np.percentile(dxy, 99) <= 2e-3 and dxy.max() <= 1.0
