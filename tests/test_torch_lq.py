"""The port's plain LM fit (ops/lq.py) and its K6 phase schedule
(ops/lq_cuda.py) held against the JAX package's Pallas LQ kernels K3
(fit_pallas_t) and K6 (fit_pallas_boundary_t), run in the Pallas
interpreter on the CPU, on 1024 spots of tests/torch_data.make_spots (two
512-spot tiles), plus the pieces of the fit (initial parameters, the
6x6 SPD solve, the resumable carry).

Tolerances: tests/torch_parity.compare_lq_fits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picasso_tpu.ops import linalg as jlinalg
from picasso_tpu.ops import lq as jlq
from picasso_tpu.ops import lq_pallas
from picasso_torch.ops import linalg as tlinalg
from picasso_torch.ops import lq as tlq
from picasso_torch.ops import lq_cuda
from torch_data import make_spots
from torch_parity import compare_lq_fits

FTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spots_t():
    return np.ascontiguousarray(make_spots(1024).transpose(1, 2, 0))


@pytest.fixture(scope="module")
def plain_fits(spots_t):
    sp = torch.from_numpy(spots_t)
    return {m: tlq._lm_core(sp, m, FTOL).numpy() for m in (30, 100)}


@pytest.mark.parametrize("max_it", [30, 100])
def test_plain_fit_matches_pallas_tile_kernel(spots_t, plain_fits, max_it):
    """K3 in the Pallas interpreter (bit-identical to _lm_core)."""
    p = np.asarray(lq_pallas.fit_pallas_t(jnp.asarray(spots_t), max_it, FTOL,
                                          interpret=True))
    compare_lq_fits(p, plain_fits[max_it], spots_t)


@pytest.mark.parametrize("max_it", [30, 100])
def test_plain_schedule_matches_pallas_boundary_kernels(spots_t, plain_fits,
                                                        max_it):
    """K6 (phases at 5/15 for max_it 30, 16/50 for 100) in the Pallas
    interpreter against the port's K6 schedule over the plain phases,
    which equals the plain single-pass fit bit for bit."""
    p = np.asarray(lq_pallas.fit_pallas_boundary_t(
        jnp.asarray(spots_t), max_it, FTOL, interpret=True))
    t = lq_cuda.fit_boundary_t(torch.from_numpy(spots_t), max_it).numpy()
    compare_lq_fits(p, t, spots_t)
    np.testing.assert_array_equal(t, plain_fits[max_it])


def _poisoned(n_real, seed=3):
    sp = np.ascontiguousarray(make_spots(1024, seed=seed).transpose(1, 2, 0))
    sp[:, :, n_real:] = 1.0  # flat spots: zero width, NaN cost
    return torch.from_numpy(sp)


@pytest.mark.parametrize("boundaries", [(2, 6), (5,), (1, 2, 3, 4, 8)])
def test_schedule_bit_identical_to_single_pass(boundaries):
    """The schedule (stragglers-first permutes between phases) equals the
    single pass bit for bit for every lane, the n_valid tail included."""
    n_real = 801
    sp = _poisoned(n_real, seed=5)
    a = lq_cuda.fit_t(sp, 12, FTOL, n_valid=n_real).numpy()
    b = lq_cuda._fit_phases(sp, 12, FTOL, n_real, boundaries).numpy()
    np.testing.assert_array_equal(a, b)


def test_n_valid_lanes_start_done():
    n_real = 700
    sp = _poisoned(n_real)
    base = lq_cuda.fit_t(sp[:, :, :n_real].contiguous(), 30).numpy()
    hint = lq_cuda.fit_t(sp, 30, n_valid=n_real).numpy()
    np.testing.assert_array_equal(hint[:, :n_real], base)
    np.testing.assert_array_equal(
        hint[:, n_real:], tlq.initial_parameters_t(sp).numpy()[:, n_real:])


def test_degenerate_tile_does_not_poison_real_lanes(spots_t):
    """An all-ones tile of degenerate spots (zero width, NaN cost) beside
    a real one, as in tests/test_lq_pallas.py: the real lanes fit as they
    do alone, finite, and agree with the Pallas kernel on the same
    batch."""
    real = np.ascontiguousarray(spots_t[:, :, :512])
    padded = np.concatenate([real, np.ones((7, 7, 512), np.float32)], axis=2)
    t = lq_cuda.fit_t(torch.from_numpy(padded), 30).numpy()
    alone = lq_cuda.fit_t(torch.from_numpy(real), 30).numpy()
    np.testing.assert_array_equal(t[:, :512], alone)
    assert np.isfinite(t[:, :512]).all()
    p = np.asarray(lq_pallas.fit_pallas_t(jnp.asarray(padded), 30, FTOL,
                                          interpret=True))
    compare_lq_fits(p[:, :512], t[:, :512], real)
    np.testing.assert_array_equal(np.isnan(p[:, 512:]), np.isnan(t[:, 512:]))


def test_initial_parameters_match_jax(spots_t):
    j = np.asarray(jax.jit(jlq.initial_parameters_t)(jnp.asarray(spots_t)))
    t = tlq.initial_parameters_t(torch.from_numpy(spots_t)).numpy()
    np.testing.assert_allclose(t, j, rtol=2e-6, atol=2e-6)


def test_cost_and_normal_equations_match_jax(spots_t):
    sp = torch.from_numpy(spots_t)
    theta = tlq.initial_parameters_t(sp)
    jt = jnp.asarray(theta.numpy())
    np.testing.assert_allclose(
        tlq._cost(theta, sp, 7).numpy(),
        np.asarray(jax.jit(lambda t, s: jlq._cost(t, s, 7))(
            jt, jnp.asarray(spots_t))), rtol=1e-5)
    JtJ, Jtr = tlq._normal_equations(theta, sp, 7)
    jJtJ, jJtr, _ = jax.jit(lambda t, s: jlq._normal_equations(t, s, 7))(
        jt, jnp.asarray(spots_t))
    # off-diagonal entries such as sum(dgx/dx * gx) cancel by symmetry:
    # compare the matrix scaled to a unit diagonal
    jJtJ = np.asarray(jJtJ)
    d = np.sqrt(np.abs(np.stack([jJtJ[p, p] for p in range(6)])))
    np.testing.assert_allclose(JtJ.numpy() / (d[:, None] * d[None, :]),
                               jJtJ / (d[:, None] * d[None, :]), atol=1e-5)
    # J^T r is a sum of residuals that cancel near the optimum
    scale = np.abs(np.asarray(jJtr)).max(axis=1, keepdims=True)
    np.testing.assert_allclose(Jtr.numpy() / scale,
                               np.asarray(jJtr) / scale, atol=1e-5)


def test_spd_solve_matches_jax_and_f64():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(512, 6, 6))
    m = a @ a.transpose(0, 2, 1) + 6 * np.eye(6)
    A = np.ascontiguousarray(m.transpose(1, 2, 0)).astype(np.float32)
    b = rng.normal(size=(6, 512)).astype(np.float32)
    t = tlinalg.spd_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    j = np.asarray(jax.jit(jlinalg.spd_solve)(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    ref = np.linalg.solve(m, b.T.astype(np.float64)[:, :, None])[:, :, 0].T
    np.testing.assert_allclose(t, ref, rtol=1e-4, atol=1e-5)


def test_state_from_numpy_resumes_a_jax_carry(spots_t, plain_fits):
    """An LM fit started in JAX (_lm_init + 5 iterations) and resumed in
    the port agrees with the fit of all 30."""
    sp = jnp.asarray(spots_t)
    carry = jax.jit(lambda s: jlq._lm_rounds(s, *jlq._lm_init(s), 5, FTOL))(sp)
    theta, lam, cost, done = tlq.state_from_numpy(*(np.asarray(c)
                                                    for c in carry))
    assert theta.shape == (6, 1024) and lam.shape == (1, 1024)
    out = tlq._lm_rounds(torch.from_numpy(spots_t), theta, lam, cost, done,
                         25, FTOL)[0].numpy()
    compare_lq_fits(plain_fits[30], out, spots_t)
