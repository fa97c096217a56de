"""The port's plain MLE fit held against the JAX package's Pallas fit
kernels K1 (fit_pallas_t), K2 (fit_pallas_boundary_t) and K7
(fit_pallas_multiround), run in the Pallas interpreter on the CPU, on
tests/torch_data.make_spots(1024).

Tolerances: tests/torch_parity.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_data import make_spots
from picasso_tpu.ops import mle_pallas
from picasso_torch.ops import mle as tmle
from picasso_torch.ops import mle_cuda
from torch_parity import compare_fits

EPS, MAX_IT = 1e-3, 100


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(out):
    return [np.asarray(a) for a in out]


@pytest.fixture(scope="module")
def spots_t():
    return np.ascontiguousarray(make_spots(1024).transpose(1, 2, 0))


@pytest.fixture(scope="module")
def plain_fit(spots_t):
    return _np(tmle._fit_core(torch.from_numpy(spots_t), EPS, MAX_IT))


def test_plain_fit_matches_pallas_tile_kernel(spots_t, plain_fit):
    """K1 in the Pallas interpreter (bit-identical to _fit_core)."""
    p = _np(mle_pallas.fit_pallas_t(
        jnp.asarray(spots_t), EPS, MAX_IT, interpret=True
    ))
    compare_fits(p, plain_fit, MAX_IT)


def test_plain_schedule_matches_pallas_boundary_kernels(spots_t, plain_fit):
    """K2 (phase kernels 16/50/100) in the Pallas interpreter against the
    port's K2 schedule over the plain phases."""
    p = _np(mle_pallas.fit_pallas_boundary_t(
        jnp.asarray(spots_t), EPS, MAX_IT, interpret=True
    ))
    t = _np(mle_cuda.fit_boundary_t(torch.from_numpy(spots_t), EPS, MAX_IT))
    compare_fits(p, t, MAX_IT)
    for a, b in zip(t, plain_fit):
        np.testing.assert_array_equal(a, b)


def test_multiround_schedule_equals_the_single_pass(spots_t, plain_fit):
    """K7 as the port's schedule (rounds of 8, stable argsort of done
    between them, 13 phases at max_it 100) over the plain phases equals
    mle._fit_core bit for bit."""
    t = _np(mle_cuda.fit_multiround_t(torch.from_numpy(spots_t), EPS, MAX_IT))
    for a, b in zip(t, plain_fit):
        np.testing.assert_array_equal(a, b)


def test_multiround_schedule_matches_pallas_multiround(spots_t):
    """K7 (fit_pallas_multiround) in the Pallas interpreter, at max_it 16
    (two rounds of 8, the size tests/test_mle_pallas.py runs it at)."""
    p = _np(mle_pallas.fit_pallas_multiround(
        jnp.asarray(spots_t.transpose(2, 0, 1)), EPS, 16, round_it=8,
        interpret=True,
    ))
    t = _np(mle_cuda.fit_multiround_t(torch.from_numpy(spots_t), EPS, 16,
                                      round_it=8))
    compare_fits([p[0].T, p[1].T, p[2], p[3]], t, 16)
