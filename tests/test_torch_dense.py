"""The MLE fit on dense ROIs: picasso_tpu's gaussmle (JAX on the CPU)
against the port's plain fit (ops/mle._fit_core) on the ROIs of two
small dense DNA-PAINT movies (two seeds) cut as fit2D cuts them, both
methods, held to torch_parity.compare_fits_dense; and the gate itself.

Tolerance: compare_fits_dense (its docstring gives the measured JAX vs
plain maxima on fit2D's first 262,144 ROIs and the margin of 2), the
gate chip_smoke.py holds the card's sigma fits to on that block.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from picasso_torch import localize
from picasso_torch.ops import mle
from picasso_tpu import gaussmle as jmle
from torch_data import make_bench_movie
from torch_parity import (
    DENSE_FITS, compare_fits, compare_fits_dense, fit_stats,
)

BOX, EPS, MAX_IT, MIN_NG = 7, 1e-3, 100, 4000


def _dense_rois(seed):
    """The ROIs of a 64-frame 64x64 movie at the smoke movie's site
    density (1200 sites on 256x256), cut as fit2D cuts them (raw counts,
    camera baseline 0, factor 1, as f32)."""
    movie = make_bench_movie(64, 64, 75, 0.5, np.random.default_rng(seed))
    ids = localize.identify(movie, MIN_NG, BOX, device="cpu")
    return localize.get_spots_raw(movie, ids, BOX,
                                  device="cpu").astype(np.float32)


@pytest.fixture(scope="module")
def dense_spots():
    return _dense_rois(13)


@pytest.fixture(scope="module")
def second_dense_spots():
    return _dense_rois(29)


@pytest.mark.parametrize("method", ["sigmaxy", "sigma"])
def test_jax_and_the_plain_fit_agree_on_dense_rois(dense_spots, method):
    _hold_jax_and_plain(dense_spots, method)


@pytest.mark.parametrize("method", ["sigmaxy", "sigma"])
def test_jax_and_the_plain_fit_agree_on_a_second_dense_movie(
        second_dense_spots, method):
    """The same on a movie of another seed."""
    _hold_jax_and_plain(second_dense_spots, method)


def _hold_jax_and_plain(dense_spots, method):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batch = torch.from_numpy(np.ascontiguousarray(
            dense_spots.transpose(1, 2, 0)))
        plain = [a.numpy() for a in mle._fit_core(batch, EPS, MAX_IT,
                                                  method)]
    finally:
        torch.set_num_threads(n)
    theta, crlb, ll, iters = jmle.gaussmle(dense_spots, EPS, MAX_IT, method)
    ref = [np.asarray(theta).T, np.asarray(crlb).T, np.asarray(ll),
           np.asarray(iters)]
    assert len(dense_spots) > 1000
    stats = compare_fits_dense(ref, plain, MAX_IT, f"JAX vs plain {method}")
    assert stats["n_stuck"] > 0  # some fits run to max_it on dense ROIs


def test_dense_gate_loosens_compare_fits_only_where_measured():
    """compare_fits_dense admits what compare_fits admits, and refuses a
    same-step shift of x beyond its bound."""
    rng = np.random.default_rng(3)
    n = 500
    theta = rng.uniform(1, 5, (6, n)).astype(np.float32)
    theta[2] *= 300
    crlb = rng.uniform(0.01, 0.1, (6, n)).astype(np.float32)
    ll = rng.uniform(-200, -100, n).astype(np.float32)
    iters = np.full(n, 9, np.int32)
    ref = [theta, crlb, ll, iters]
    near = [theta.copy(), crlb, ll, iters]
    near[0][0, 7] += 1.5e-4  # within compare_fits' 2e-4
    compare_fits(ref, near)
    assert compare_fits_dense(ref, near)["xy_max"] == pytest.approx(
        fit_stats(ref, near)["xy_max"])
    for key, v in DENSE_FITS.items():
        assert v >= {"xy_max": 2e-4, "sxy_max": 5e-4, "crlb_rel": 2e-3,
                     "photons_rel": 2e-4}.get(key, 0.0)
    far = [theta.copy(), crlb, ll, iters]
    far[0][0, 7] += 1.5 * DENSE_FITS["xy_max"]
    with pytest.raises(AssertionError, match="dense tolerance"):
        compare_fits_dense(ref, far)
