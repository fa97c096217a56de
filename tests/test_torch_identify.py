"""picasso_torch identify (plain version of the CUDA kernel K4) held
against the JAX package on the same movies (CPU).

Tolerances: hit lists as in tests/torch_parity.py (ng is summed as
direct shifted sums here and as a convolution in JAX); tile mask and
loc equal, tile ng within rtol 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_data import make_bench_movie
from picasso_tpu.ops import identify as jid
from picasso_tpu.ops import identify_pallas as jidp
from picasso_torch.ops import identify as tid
from torch_parity import compare_hits

MIN_NG = 2000.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _movie(B, Y, X, seed=0):
    """A u16 DNA-PAINT-like movie plus planted cases: bright spots
    touching row 0 / col 0 and the last row/col (the gradient at row/col
    0 wraps to Y-1/X-1), and a plateau of two equal neighbouring maxima
    (first-argmax tie-break)."""
    size = max(Y, X)
    movie = make_bench_movie(B, size, 30, 0.5, np.random.default_rng(seed))
    movie = np.ascontiguousarray(movie[:, :Y, :X])
    movie[0, 0, 10:14] = 3000
    movie[1, 5:9, 0] = 3000
    movie[2, Y - 1, 20:26] = 4000
    movie[3, 12:18, X - 1] = 4000
    movie[4, 20, 20:22] = 2500  # equal pair: the left one is the maximum
    movie[4, 19:22, 19] += 300
    return movie


def _jax_hits(movie, box):
    count, f, y, x, ng = jid._identify_compact(
        jnp.asarray(movie), jnp.float32(MIN_NG), box, 4096
    )
    n = int(count)
    return [np.asarray(a)[:n] for a in (f, y, x, ng)]


def _port_hits(movie, box):
    out = tid.compact(
        *tid.identify_tiles_plain(torch.from_numpy(movie), MIN_NG, box), box
    )
    return [a.numpy() for a in out]


def assert_hits_equal(ref, got, thresh=MIN_NG):
    compare_hits(ref, got, thresh)


SHAPES = [(8, 64, 64), (8, 40, 72)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("box", [5, 7])
def test_hits_match_jax_identify_compact(shape, box):
    movie = _movie(*shape)
    ref, got = _jax_hits(movie, box), _port_hits(movie, box)
    assert len(ref[0]) > 20
    assert_hits_equal(ref, got)


@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_match_pallas_kernel(shape):
    """K4 in the Pallas interpreter against the plain version's tiles."""
    movie = _movie(*shape, seed=1)
    tm, tl, tn = (np.asarray(a) for a in jidp.identify_tiles_pallas(
        jnp.asarray(movie), MIN_NG, 7, interpret=True
    ))
    pm, pl_, pn = (a.numpy() for a in tid.identify_tiles_plain(
        torch.from_numpy(movie), MIN_NG, 7
    ))
    np.testing.assert_array_equal(tm > 0.5, pm)
    np.testing.assert_array_equal(np.round(tl).astype(np.int32), pl_)
    np.testing.assert_allclose(pn, tn, rtol=1e-5, atol=0)


def test_maps_match_jax_on_eligible_pixels():
    movie = _movie(6, 40, 72, seed=2)
    jmax, jng = (np.asarray(a) for a in jid.identify_maps(
        jnp.asarray(movie), 7
    ))
    tmax, tng = (a.numpy() for a in tid.identify_maps(
        torch.from_numpy(movie), 7
    ))
    np.testing.assert_array_equal(tmax, jmax)
    h = 3
    inner = (slice(None), slice(h, 40 - h - 1), slice(h, 72 - h - 1))
    scale = np.abs(jng[inner]).max()
    np.testing.assert_allclose(tng[inner], jng[inner], rtol=1e-5,
                               atol=1e-6 * scale)


def test_wrap_quirk_reaches_first_eligible_row():
    """Row 0's gradient reads row Y-1 (numba negative indexing): a
    bright last row changes ng at the first eligible row, in both."""
    movie = np.full((1, 32, 32), 100, np.uint16)
    base = tid.identify_maps(torch.from_numpy(movie), 7)[1][0, 3, 10]
    movie[0, 31, :] = 5000
    bright = tid.identify_maps(torch.from_numpy(movie), 7)[1][0, 3, 10]
    jng = np.asarray(jid.identify_maps(jnp.asarray(movie), 7)[1])[0, 3, 10]
    assert float(bright) != float(base)
    np.testing.assert_allclose(float(bright), jng, rtol=1e-5)


def test_first_argmax_tie_break():
    movie = np.zeros((1, 24, 24), np.uint16)
    movie[0, 10, 10] = movie[0, 10, 11] = 500
    maxima = tid.identify_maps(torch.from_numpy(movie), 5)[0][0].numpy()
    jmax = np.asarray(jid.identify_maps(jnp.asarray(movie), 5)[0])[0]
    np.testing.assert_array_equal(maxima, jmax)
    assert maxima[10, 10] and not maxima[10, 11]


def test_identify_frames_roi_and_offset_match_jax():
    movie = _movie(6, 64, 64, seed=3)
    roi = ((4, 8), (60, 56))
    ref = jid.identify_frames(movie, MIN_NG, 7, frame_offset=100, roi=roi)
    got = tid.identify_frames(movie, MIN_NG, 7, frame_offset=100, roi=roi,
                              device="cpu")
    assert_hits_equal(ref, got)
    assert got[0].dtype == np.int64 and got[3].dtype == np.float32


def test_float_frames_match_u16_frames():
    movie = _movie(6, 48, 48, seed=4)
    a = _port_hits(movie, 7)
    b = _port_hits(movie.astype(np.float32), 7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("box", [5, 7])
def test_nan_pixels_match_jax(box):
    """f32 frames with NaN pixels: a NaN in a window means "not a
    maximum" in both, so the maxima are equal, and so are the hits; a
    hit's ng is its own, also where a NaN net gradient shares its tile
    (the tile reduction selects the hit, it does not multiply)."""
    movie = _movie(8, 64, 64, seed=5).astype(np.float32)
    rng = np.random.default_rng(6)
    movie[rng.random(movie.shape) < 2e-3] = np.nan
    jmax, jng = (np.asarray(a) for a in jid.identify_maps(
        jnp.asarray(movie), box))
    tmax, tng = (a.numpy() for a in tid.identify_maps(
        torch.from_numpy(movie), box))
    np.testing.assert_array_equal(tmax, jmax)
    assert np.isnan(tng).sum() > 50 and np.isnan(jng).sum() > 50
    ref, got = _jax_hits(movie, box), _port_hits(movie, box)
    assert len(ref[0]) > 20
    assert_hits_equal(ref, got)
    # hits whose tile holds a NaN net gradient elsewhere
    T = box // 2 + 1
    f, y, x = (np.asarray(a) for a in got[:3])
    nan_ng = np.isnan(tng)
    shared = [nan_ng[b, y0 // T * T:y0 // T * T + T,
                     x0 // T * T:x0 // T * T + T].any()
              for b, y0, x0 in zip(f, y, x)]
    assert sum(shared) >= 3


@pytest.mark.parametrize("shape,n_hits", [
    ((2, 6, 40), 0), ((2, 1, 40), 0), ((2, 9, 9), 0), ((2, 40, 7), 0),
    ((2, 10, 13), 1),
])
def test_frames_smaller_than_the_window(shape, n_hits):
    """At box 7 a frame needs 8 rows and columns for an eligible centre
    (h <= y < Y-h-1): smaller frames give no hits in both; a 10x13 frame
    with one planted spot gives one."""
    B, Y, X = shape
    movie = np.random.default_rng(7).poisson(30, shape).astype(np.uint16)
    if n_hits:
        yy, xx = np.mgrid[-3:4, -3:4]
        movie[0, 1:8, 3:10] += (900 * np.exp(-(yy**2 + xx**2) / 2.42)
                                ).astype(np.uint16)
    ref, got = _jax_hits(movie, 7), _port_hits(movie, 7)
    assert len(ref[0]) == len(got[0]) == n_hits
    if n_hits:
        assert_hits_equal(ref, got)
