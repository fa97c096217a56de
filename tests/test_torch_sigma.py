"""The ``sigma`` MLE method of the port (the 5-parameter isotropic fit)
held against the JAX package: the plain fit against the Pallas fit
kernels K1 (fit_pallas_t) and K2 (fit_pallas_boundary_t) run in the
Pallas interpreter on 1024 spots of tests/torch_data.make_spots, the
reference's two quirks of the Newton step against JAX's
_newton_step_sigma, and the carry.

Tolerances: tests/torch_parity.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picasso_tpu.ops import mle as jmle
from picasso_tpu.ops import mle_pallas
from picasso_torch.ops import gaussian as tgauss
from picasso_torch.ops import mle as tmle
from picasso_torch.ops import mle_cuda
from torch_data import make_spots
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
    return np.ascontiguousarray(make_spots(1024, seed=4).transpose(1, 2, 0))


@pytest.fixture(scope="module")
def plain_fit(spots_t):
    return _np(tmle._fit_core(torch.from_numpy(spots_t), EPS, MAX_IT,
                              "sigma"))


def test_plain_fit_matches_pallas_tile_kernel(spots_t, plain_fit):
    p = _np(mle_pallas.fit_pallas_t(jnp.asarray(spots_t), EPS, MAX_IT,
                                    method="sigma", interpret=True))
    compare_fits(p, plain_fit, MAX_IT)
    # theta and CRLB padded to 6 rows by repeating sigma
    for a in plain_fit[:2]:
        np.testing.assert_array_equal(a[5], a[4])


def test_plain_schedule_matches_pallas_boundary_kernels(spots_t, plain_fit):
    p = _np(mle_pallas.fit_pallas_boundary_t(
        jnp.asarray(spots_t), EPS, MAX_IT, method="sigma", interpret=True))
    t = _np(mle_cuda.fit_boundary_t(torch.from_numpy(spots_t), EPS, MAX_IT,
                                    "sigma"))
    compare_fits(p, t, MAX_IT)
    for a, b in zip(t, plain_fit):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("boundaries", [(3, 7), (5,)])
def test_schedule_bit_identical_to_single_pass(boundaries):
    sp = np.ascontiguousarray(make_spots(1024, seed=6).transpose(1, 2, 0))
    sp[:, :, 800:] = 1.0
    sp = torch.from_numpy(sp)
    a = _np(mle_cuda.fit_t(sp, EPS, 12, "sigma", n_valid=800))
    b = _np(mle_cuda._fit_phases(sp, EPS, 12, "sigma", 800, boundaries))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[3][800:].max() == 0


def test_iso_axis_terms_match_jax():
    from picasso_tpu.ops import gaussian as jgauss

    rng = np.random.default_rng(1)
    mu = rng.uniform(-1.0, 7, 256).astype(np.float32)
    sigma = rng.uniform(0.3, 3.0, 256).astype(np.float32)[None, :]
    d = (np.arange(7, dtype=np.float32)[:, None] - mu[None, :])
    j = jax.jit(jgauss.fused_axis_terms_iso)(jnp.asarray(d),
                                              jnp.asarray(sigma))
    t = tgauss.fused_axis_terms_iso(torch.from_numpy(d),
                                    torch.from_numpy(sigma))
    for a, b in zip(j, t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                   atol=1e-6 * np.abs(a).max())


def _step_inputs(seed=0, n=256):
    """A crafted sigma-method state: theta near the truth of make_spots
    spots, with max_step wide enough that no update is clipped."""
    spots = np.ascontiguousarray(make_spots(n, seed=seed).transpose(1, 2, 0))
    rng = np.random.default_rng(seed)
    theta = np.stack([
        3 + rng.uniform(-0.4, 0.4, n), 3 + rng.uniform(-0.4, 0.4, n),
        rng.uniform(3000, 6000, n), rng.uniform(8, 25, n),
        rng.uniform(1.0, 1.3, n),
    ]).astype(np.float32)
    max_step = np.full((5, n), 1e6, np.float32)
    return spots, theta, max_step


def _steps(spots, theta, max_step):
    j = np.asarray(jax.jit(jmle._newton_step_sigma)(
        jnp.asarray(theta), jnp.asarray(spots), jnp.asarray(max_step)))
    t = tmle._newton_step_sigma(torch.from_numpy(theta),
                                torch.from_numpy(spots),
                                torch.from_numpy(max_step)).numpy()
    return j, t


def test_quirk_zero_denominator_steps_by_one():
    """Where a denominator is 0, the sigma method steps by
    sign(num * max_step) = +-1, not by max_step. All-zero data under a
    valid model gives cf = -1, df = 0: the photons and bg denominators
    vanish and their numerators do not."""
    _, theta, _ = _step_inputs()
    spots = np.zeros((7, 7, theta.shape[1]), np.float32)
    max_step = np.full_like(theta, 0.3)
    j, t = _steps(spots, theta, max_step)
    np.testing.assert_array_equal(t[2:4], theta[2:4] + 1.0)
    np.testing.assert_array_equal(t[2:4], j[2:4])
    np.testing.assert_allclose(t, j, rtol=1e-5)
    nan_num = theta.copy()
    nan_num[2, :4] = np.nan  # the sign propagates NaN like jnp.sign
    j, t = _steps(spots, nan_num, max_step)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))


def test_quirk_photons_only_on_the_first_term():
    """d2udt2_sigma = photons * PSFy (x) d2PSFx + 2 dPSFy (x) dPSFx +
    d2PSFy (x) PSFx (photons on the first term only, as the reference
    writes it). The port's sigma update matches JAX's, and differs from
    the update with photons on all three terms by far more than the f32
    spread."""
    spots, theta, max_step = _step_inputs(seed=2)
    j, t = _steps(spots, theta, max_step)
    np.testing.assert_allclose(t, j, rtol=2e-5, atol=1e-5)
    # the update of sigma with photons on all three terms, in f64
    x, y, ph, bg, sg = (theta[k].astype(np.float64) for k in range(5))
    f = jax.jit(jmle._axis_factors_sigma, static_argnums=3)
    psf_x, psf_y, _, _, _, _, dpx, d2px, dpy, d2py = (
        np.asarray(a, np.float64) for a in f(
            jnp.asarray(theta[0]), jnp.asarray(theta[1]),
            jnp.asarray(theta[4]), 7))
    data = spots.transpose(1, 0, 2).astype(np.float64)  # [x, y, n]
    model = ph * psf_x[:, None] * psf_y[None, :] + bg
    cf = data / model - 1.0
    df = data / model**2
    du = ph * (psf_y[None] * dpx[:, None] + dpy[None] * psf_x[:, None])
    d2u = ph * (psf_y[None] * d2px[:, None] + 2 * dpy[None] * dpx[:, None]
                + d2py[None] * psf_x[:, None])
    num = (cf * du).sum((0, 1))
    den = (cf * d2u - df * du * du).sum((0, 1))
    fixed = np.clip(sg - num / den, 0.01, 7)
    gap = np.abs(fixed - t[4])
    assert np.median(gap) > 100 * np.median(np.abs(t[4] - j[4]) + 1e-7)


def test_state_from_numpy_resumes_a_jax_sigma_carry(spots_t, plain_fit):
    carry = _np(jax.jit(lambda s: jmle._fit_start(s, EPS, 16, "sigma"))(
        jnp.asarray(spots_t)))
    theta, old, done, iters, ms = tmle.state_from_numpy(*carry)
    assert theta.shape == (5, 1024) and ms.shape == (5, 1024)
    sp = torch.from_numpy(spots_t)
    carry_t = tmle._fit_resume(sp, theta, old, done, iters, ms, EPS, 34,
                               "sigma")
    out = _np(tmle._fit_finish(sp, *carry_t, EPS, 50, "sigma"))
    compare_fits(plain_fit, out, MAX_IT)
