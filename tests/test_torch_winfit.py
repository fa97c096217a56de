"""K5, the fused cut + photon conversion + fit (picasso_torch/ops/
winfit_cuda.py), in its plain version on the CPU, held against the JAX
package's winfit Pallas kernels (picasso_tpu/ops/winfit_pallas.py) run in
the Pallas interpreter on gather_wincols rows, and the chunk chain
against picasso_tpu's chain routed through winfit
(PICASSO_TPU_ROI_CUT=winfit).

The frames and camera constants (baseline 1.5, factor 0.8) are those of
tests/test_fused.py::test_chain_parity_winfit_fused_cut_fit. Tolerances:
tests/torch_parity.py (compare_fits, compare_lq_fits).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picasso_tpu.ops import fused as jfused
from picasso_tpu.ops import winfit_pallas
from picasso_torch.ops import fused as tfused
from picasso_torch.ops import identify, lq, mle, mle_cuda, winfit_cuda
from picasso_torch.ops._fit_common import default_boundaries
from torch_parity import compare_fits, compare_hits, compare_lq_fits

BOX, EPS, MIN_NG = 7, 1e-3, 2000.0
BASELINE, FACTOR = 1.5, 0.8
LANES = 512  # the JAX kernels' tile: pad the hit list to it


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(27)
    frames = rng.poisson(30, (8, 64, 64)).astype(np.uint16)
    yy, xx = np.mgrid[-3:4, -3:4]
    psf = np.exp(-(yy**2 + xx**2) / 2.4)
    for i in range(8):
        for cy, cx in ((10, 10), (30, 20), (50, 40), (20, 50)):
            frames[i, cy - 3:cy + 4, cx - 3:cx + 4] += rng.poisson(
                psf * 600).astype(np.uint16)
    return frames


@pytest.fixture(scope="module")
def hits(frames):
    tiles = identify.identify_tiles_plain(torch.from_numpy(frames), MIN_NG,
                                          BOX)
    f, y, x, _ = identify.compact(*tiles, BOX)
    assert 8 < len(f) < LANES
    return f, y, x


def _jax_rows(frames, f, y, x):
    """picasso_tpu's gather_wincols rows of the hits padded to LANES."""
    pad = lambda a: jnp.asarray(np.pad(a.numpy(), (0, LANES - len(a))))  # noqa: E731
    cols, xoff = jfused.gather_wincols(jnp.asarray(frames), pad(f), pad(y),
                                       pad(x), BOX)
    return cols, xoff[None, :]


def _np(out):
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("method", ["sigmaxy", "sigma"])
def test_plain_k5_mle_matches_jax_winfit(frames, hits, method):
    n = len(hits[0])
    cols, xoff = _jax_rows(frames, *hits)
    j = _np(winfit_pallas.fit_mle_t(cols, xoff, BASELINE, FACTOR, box=BOX,
                                    eps=EPS, max_it=100, method=method,
                                    interpret=True, n_valid=n))
    t = _np(winfit_cuda.fit_mle_t(torch.from_numpy(frames), *hits, BASELINE,
                                  FACTOR, box=BOX, eps=EPS, max_it=100,
                                  method=method))
    compare_fits([j[0][:, :n], j[1][:, :n], j[2][:n], j[3][:n]], t, 100)


def test_plain_k5_lq_matches_jax_winfit(frames, hits):
    n = len(hits[0])
    cols, xoff = _jax_rows(frames, *hits)
    j = np.asarray(winfit_pallas.fit_lq_t(cols, xoff, BASELINE, FACTOR,
                                          box=BOX, max_it=100, interpret=True,
                                          n_valid=n))[:, :n]
    frames_t = torch.from_numpy(frames)
    t = winfit_cuda.fit_lq_queue_t(frames_t, *hits, BASELINE, FACTOR,
                                   box=BOX, max_it=100).numpy()
    spots = winfit_cuda.photons_t(frames_t, *hits, BOX, BASELINE,
                                  FACTOR).numpy()
    compare_lq_fits(j, t, spots)


def test_plain_k5_lq_queue_matches_jax_winfit(frames, hits):
    """K5 LM's work queue on the CPU (its plain version) from an f32
    chunk against JAX's LM winfit kernel in the interpreter on the f32
    rows."""
    n = len(hits[0])
    f32 = frames.astype(np.float32)
    cols, xoff = _jax_rows(f32, *hits)
    j = np.asarray(winfit_pallas.fit_lq_t(cols, xoff, BASELINE, FACTOR,
                                          box=BOX, max_it=100, interpret=True,
                                          n_valid=n))[:, :n]
    frames_t = torch.from_numpy(f32)
    t = winfit_cuda.fit_lq_queue_t(frames_t, *hits, BASELINE, FACTOR,
                                   box=BOX, max_it=100).numpy()
    spots = winfit_cuda.photons_t(frames_t, *hits, BOX, BASELINE,
                                  FACTOR).numpy()
    compare_lq_fits(j, t, spots)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("max_it", [3, 100])
def test_lq_queue_plain_route_is_the_gather_route(frames, hits, dtype,
                                                  max_it):
    """On the CPU the LM queue is cut, photons, lq._lm_core, bit for bit,
    from a u16 and an f32 chunk; at max_it 3 some spots stop at
    max_it."""
    frames_t = torch.from_numpy(frames.astype(dtype))
    kw = dict(box=BOX, max_it=max_it)
    got = winfit_cuda.fit_lq_queue_t(frames_t, *hits, BASELINE, FACTOR, **kw)
    want = lq._lm_core(winfit_cuda.photons_t(frames_t, *hits, BOX, BASELINE,
                                             FACTOR), max_it, 1e-6)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_lq_queue_without_hits_returns_empty():
    f = torch.zeros(0, dtype=torch.int64)
    out = winfit_cuda.fit_lq_queue_t(torch.zeros((2, 32, 32),
                                                 dtype=torch.uint16),
                                     f, f, f, 0.0, 1.0, box=BOX, max_it=10)
    assert out.shape == (6, 0) and out.dtype == torch.float32


def test_plain_k5_f32_chunk_matches_jax_winfit(frames, hits):
    """An f32 chunk (upload_frames' other dtype) gives the u16 chunk's
    photons, so the same fit; JAX's kernel reads the f32 rows too."""
    n = len(hits[0])
    f32 = frames.astype(np.float32)
    cols, xoff = _jax_rows(f32, *hits)
    j = _np(winfit_pallas.fit_mle_t(cols, xoff, BASELINE, FACTOR, box=BOX,
                                    eps=EPS, max_it=100, interpret=True,
                                    n_valid=n))
    kw = dict(box=BOX, eps=EPS, max_it=100)
    t32 = _np(winfit_cuda.fit_mle_t(torch.from_numpy(f32), *hits, BASELINE,
                                    FACTOR, **kw))
    t16 = _np(winfit_cuda.fit_mle_t(torch.from_numpy(frames), *hits,
                                    BASELINE, FACTOR, **kw))
    compare_fits([j[0][:, :n], j[1][:, :n], j[2][:n], j[3][:n]], t32, 100)
    for a, b in zip(t32, t16):
        np.testing.assert_array_equal(a, b)
    lq32 = winfit_cuda.fit_lq_queue_t(torch.from_numpy(f32), *hits,
                                      BASELINE, FACTOR, box=BOX, max_it=100)
    lq16 = winfit_cuda.fit_lq_queue_t(torch.from_numpy(frames), *hits,
                                      BASELINE, FACTOR, box=BOX, max_it=100)
    np.testing.assert_array_equal(lq32.numpy(), lq16.numpy())


@pytest.mark.parametrize("method", ["sigmaxy", "sigma"])
def test_k5_phase_schedule_equals_one_pass_and_the_gather_route(
        frames, hits, method):
    """The K5 phase schedule (hit list and carry reordered between
    phases, each phase cutting anew) equals K5 in one pass and the gather
    route (cut, photons, K2 schedule) bit for bit. max_it is chosen so
    that the first phase ends (sigmaxy: at 4 of 12, sigma: at 2 of 5)
    with some spots converged and some not."""
    frames_t = torch.from_numpy(frames)
    max_it = {"sigmaxy": 12, "sigma": 5}[method]
    kw = dict(box=BOX, eps=EPS, max_it=max_it, method=method)
    one = _np(winfit_cuda.fit_mle_t(frames_t, *hits, BASELINE, FACTOR, **kw))
    phases = _np(winfit_cuda.fit_mle_boundary_t(frames_t, *hits, BASELINE,
                                                FACTOR, **kw))
    gather = _np(mle_cuda.fit_boundary_t(
        winfit_cuda.photons_t(frames_t, *hits, BOX, BASELINE, FACTOR), EPS,
        max_it, method))
    first = default_boundaries(max_it)[0]
    assert (one[3] <= first).any() and (one[3] > first).any()
    for a, b, c in zip(one, phases, gather):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("method", ["sigmaxy", "sigma"])
def test_queue_equals_phases_and_one_pass(frames, hits, method, dtype):
    """K5's work queue, the chain's MLE route, equals K5 in phases and in
    one pass bit for bit on the CPU (all three are the gather route
    there), from a u16 and an f32 chunk. max_it is cut so that some
    spots run to it and some converge before."""
    frames_t = torch.from_numpy(frames.astype(dtype))
    max_it = {"sigmaxy": 8, "sigma": 3}[method]
    kw = dict(box=BOX, eps=EPS, max_it=max_it, method=method)
    queue = _np(winfit_cuda.fit_mle_queue_t(frames_t, *hits, BASELINE,
                                            FACTOR, **kw))
    assert (queue[3] == max_it).any() and (queue[3] < max_it).any()
    for other in (winfit_cuda.fit_mle_boundary_t, winfit_cuda.fit_mle_t):
        for a, b in zip(queue, _np(other(frames_t, *hits, BASELINE, FACTOR,
                                         **kw))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["sigmaxy", "sigma"])
def test_queue_matches_jax_winfit(frames, hits, method):
    n = len(hits[0])
    cols, xoff = _jax_rows(frames, *hits)
    j = _np(winfit_pallas.fit_mle_t(cols, xoff, BASELINE, FACTOR, box=BOX,
                                    eps=EPS, max_it=100, method=method,
                                    interpret=True, n_valid=n))
    t = _np(winfit_cuda.fit_mle_queue_t(torch.from_numpy(frames), *hits,
                                        BASELINE, FACTOR, box=BOX, eps=EPS,
                                        max_it=100, method=method))
    compare_fits([j[0][:, :n], j[1][:, :n], j[2][:n], j[3][:n]], t, 100)


def test_cut_clamps_the_centre_as_gather_wincols(frames):
    """Hits on and beyond the border: the window is the one
    gather_wincols gives (centre clamped into the frame), and no index
    wraps."""
    f = torch.tensor([0, 7, 3, -1, 8, 2])
    y = torch.tensor([0, 63, 1, 30, 70, -5])
    x = torch.tensor([0, 63, 62, -2, 5, 40])
    got = winfit_cuda.cut_rois_t(torch.from_numpy(frames), f, y, x,
                                 BOX).numpy()
    cols, xoff = jfused.gather_wincols(jnp.asarray(frames), jnp.asarray(f),
                                       jnp.asarray(y), jnp.asarray(x), BOX)
    rows = np.asarray(cols).reshape(BOX, frames.shape[2], -1)
    want = np.stack([rows[:, o:o + BOX, i]
                     for i, o in enumerate(np.asarray(xoff))], axis=-1)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    # the fit reads the same clamped windows
    fit = winfit_cuda.fit_lq_queue_t(torch.from_numpy(frames), f, y, x,
                                     BASELINE, FACTOR, box=BOX, max_it=20)
    ref = winfit_cuda.fit_lq_queue_t(
        torch.from_numpy(frames), f.clamp(0, 7), y.clamp(3, 60),
        x.clamp(3, 60), BASELINE, FACTOR, box=BOX, max_it=20)
    np.testing.assert_array_equal(fit.numpy(), ref.numpy())


@pytest.mark.parametrize("method", ["sigmaxy", "lq"])
def test_chain_matches_jax_winfit_chain(monkeypatch, frames, method):
    """The port's identify_cut_fit on the CPU against picasso_tpu's
    identify_cut_fit with its Pallas kernels in the interpreter, routed
    through winfit."""
    kw = dict(box=BOX, size=LANES, eps=EPS, max_it=30, method=method,
              use_pallas=True, pallas_interpret=True)
    monkeypatch.setenv("PICASSO_TPU_ROI_CUT", "winfit")
    jfused.identify_cut_fit.clear_cache()
    try:
        j = _np(jfused.identify_cut_fit(
            jnp.asarray(frames), jnp.float32(MIN_NG), jnp.float32(BASELINE),
            jnp.float32(FACTOR), **kw))
    finally:
        monkeypatch.undo()
        jfused.identify_cut_fit.clear_cache()
    n = int(j[0])
    t = _np(tfused.identify_cut_fit(torch.from_numpy(frames), MIN_NG,
                                    BASELINE, FACTOR, box=BOX, eps=EPS,
                                    max_it=30, method=method))
    pairs = compare_hits([a[:n] for a in j[1:5]], t[:4], MIN_NG)
    assert len(pairs) == n == len(t[0])
    for a, b in zip(j[1:4], t[:3]):
        np.testing.assert_array_equal(a[:n], b)
    if method == "lq":
        spots = winfit_cuda.photons_t(
            torch.from_numpy(frames), *map(torch.from_numpy, t[:3]), BOX,
            BASELINE, FACTOR).numpy()
        compare_lq_fits(j[5][:, :n], t[4], spots)
    else:
        compare_fits([j[5][:, :n], j[6][:, :n], j[7][:n], j[8][:n]], t[4:],
                     30)


def test_chain_without_hits_cuts_nothing():
    out = tfused.identify_cut_fit(torch.zeros((2, 32, 32),
                                              dtype=torch.uint16),
                                  1000.0, 0.0, 1.0, box=BOX, eps=EPS,
                                  max_it=10)
    assert out[0].numel() == 0 and out[4].shape == (6, 0)
    assert out[7].dtype == torch.int32


def test_plain_fit_equals_the_fit_of_the_cut(frames, hits):
    """The plain K5 is the gather route: cut, photons, mle._fit_core."""
    frames_t = torch.from_numpy(frames)
    spots = winfit_cuda.photons_t(frames_t, *hits, BOX, BASELINE, FACTOR)
    want = _np(mle._fit_core(spots, EPS, 50))
    got = _np(winfit_cuda.fit_mle_t(frames_t, *hits, BASELINE, FACTOR,
                                    box=BOX, eps=EPS, max_it=50))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
