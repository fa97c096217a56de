"""picasso_torch gaussian, linalg and plain MLE fit held against the JAX
package on the same inputs (CPU). The comparisons with the Pallas
kernels in the interpreter are in tests/test_torch_mle_pallas.py.

Tolerances: tests/torch_parity.py (the same ones chip_smoke.py holds
the CUDA kernels to on the card).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_data import make_spots
from picasso_tpu.ops import gaussian as jgauss
from picasso_tpu.ops import linalg as jlinalg
from picasso_tpu.ops import mle as jmle
from picasso_torch.ops import gaussian as tgauss
from picasso_torch.ops import linalg as tlinalg
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


def assert_fits_close(ref, got, max_it=MAX_IT):
    compare_fits(_np(ref), _np(got), max_it)


def _np(out):
    return [np.asarray(a) for a in out]


@pytest.fixture(scope="module")
def spots_t():
    """make_spots(1024) in the lanes-last (7, 7, N) layout."""
    return np.ascontiguousarray(make_spots(1024).transpose(1, 2, 0))


@pytest.fixture(scope="module")
def jax_fit(spots_t):
    fit = jax.jit(lambda s: jmle._fit_core(s, EPS, MAX_IT))
    return _np(fit(jnp.asarray(spots_t)))


@pytest.fixture(scope="module")
def plain_fit(spots_t):
    return _np(tmle._fit_core(torch.from_numpy(spots_t), EPS, MAX_IT))


# --- gaussian -------------------------------------------------------------


def _offsets(seed=0, s=7, n=256):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-1.0, s, n).astype(np.float32)
    sigma = rng.uniform(0.3, 3.0, n).astype(np.float32)
    d = (np.arange(s, dtype=np.float32)[:, None] - mu[None, :])
    return d.astype(np.float32), sigma[None, :]


def test_erf_matches_jax():
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    np.testing.assert_allclose(
        tgauss.erf(torch.from_numpy(x)).numpy(),
        np.asarray(jgauss.erf(jnp.asarray(x))), rtol=0, atol=2e-7,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_axis_terms_match_jax(seed):
    d, sigma = _offsets(seed)
    j = jax.jit(jgauss.fused_axis_terms)(jnp.asarray(d), jnp.asarray(sigma))
    t = tgauss.fused_axis_terms(torch.from_numpy(d), torch.from_numpy(sigma))
    for a, b in zip(j, t):
        a = np.asarray(a)
        # expf differs by an ulp between XLA and PyTorch; the factors are
        # otherwise the same f32 expressions in the same order
        np.testing.assert_allclose(
            b.numpy(), a, rtol=1e-5, atol=1e-6 * np.abs(a).max()
        )


def test_psf_tail_stays_relative():
    """The complement form keeps dim pixels of far tails nonzero (the
    naive erf difference cancels to 0 in f32 past ~5 sigma)."""
    d = torch.arange(7.0)[:, None] - 0.2  # pixels 0..6 from a spot at 0.2
    psf = tgauss.fused_axis_terms(d, torch.tensor([[0.8]]))[0]
    assert bool((psf > 0).all())
    naive = 0.5 * (tgauss.erf((d + 0.5) / (2**0.5 * 0.8))
                   - tgauss.erf((d - 0.5) / (2**0.5 * 0.8)))
    assert float(naive[-1, 0]) == 0.0
    j = jax.jit(jgauss.fused_axis_terms)(
        jnp.asarray(d.numpy()), jnp.float32(0.8)
    )[0]
    np.testing.assert_allclose(psf.numpy(), np.asarray(j), rtol=1e-5)


# --- linalg ---------------------------------------------------------------


def _spd(seed=0, p=6, n=512):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, p, p))
    m = a @ a.transpose(0, 2, 1) + p * np.eye(p)
    return np.ascontiguousarray(m.transpose(1, 2, 0)).astype(np.float32)


@pytest.mark.parametrize("p", [5, 6])
def test_spd_inv_diag_matches_jax_and_f64(p):
    A = _spd(p=p)
    t = tlinalg.spd_inv_diag(torch.from_numpy(A)).numpy()
    j = np.asarray(jax.jit(jlinalg.spd_inv_diag)(jnp.asarray(A)))
    # the same unrolled f32 recurrences; XLA contracts some products
    # into FMAs, so the two differ by a few ulp
    np.testing.assert_allclose(t, j, rtol=2e-6)
    ref = np.stack([
        np.diag(np.linalg.inv(A[:, :, i].astype(np.float64)))
        for i in range(A.shape[2])
    ], axis=1)
    np.testing.assert_allclose(t, ref, rtol=1e-4)


def test_chol_factor_matches_jax():
    A = _spd(seed=1)
    t = tlinalg.chol_factor(torch.from_numpy(A))
    j = jax.jit(jlinalg.chol_factor)(jnp.asarray(A))
    for i in range(6):
        for k in range(i + 1):
            np.testing.assert_allclose(
                t[i][k].numpy(), np.asarray(j[i][k]), rtol=1e-6, atol=1e-6
            )


# --- plain MLE fit --------------------------------------------------------


def test_initial_theta_matches_jax(spots_t):
    j = jax.jit(jmle.initial_theta_sigmaxy_t)(jnp.asarray(spots_t))
    t = tmle.initial_theta_sigmaxy_t(torch.from_numpy(spots_t))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_plain_fit_matches_jax_fit_core(jax_fit, plain_fit):
    assert_fits_close(jax_fit, plain_fit)


def _poisoned(n_real, seed=3):
    sp = np.ascontiguousarray(make_spots(1024, seed=seed).transpose(1, 2, 0))
    sp[:, :, n_real:] = 1.0  # flat junk never converges under Newton
    return torch.from_numpy(sp)


def test_n_valid_tail_starts_converged():
    n_real = 700
    sp = _poisoned(n_real)
    base = _np(mle_cuda.fit_t(sp, EPS, 12))
    hint = _np(mle_cuda.fit_t(sp, EPS, 12, n_valid=n_real))
    for a, b in zip(base, hint):
        np.testing.assert_array_equal(a[..., :n_real], b[..., :n_real])
    assert hint[3][n_real:].max() == 0
    assert base[3][n_real:].min() >= 1


@pytest.mark.parametrize("boundaries", [None, (3, 7), (5,)])
def test_schedule_bit_identical_to_single_pass(boundaries):
    """K2's schedule (stragglers-first permutes between phases) equals
    K1 bit for bit for every lane, junk tail included."""
    n_real = 801
    sp = _poisoned(n_real, seed=5)
    max_it = 12 if boundaries else MAX_IT
    a = _np(mle_cuda.fit_t(sp, EPS, max_it, n_valid=n_real))
    if boundaries is None:
        b = _np(mle_cuda.fit_boundary_t(sp, EPS, max_it, n_valid=n_real))
    else:
        b = _np(mle_cuda._fit_phases(sp, EPS, max_it, "sigmaxy", n_real,
                                     boundaries))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_state_from_numpy_resumes_a_jax_carry(spots_t, jax_fit):
    """A fit started in JAX (_fit_start, 16 iterations) and resumed and
    finished in the port agrees with the JAX fit of all 100."""
    carry = _np(jax.jit(lambda s: jmle._fit_start(s, EPS, 16, "sigmaxy"))(
        jnp.asarray(spots_t)
    ))
    theta, old, done, iters, ms = tmle.state_from_numpy(*carry)
    assert theta.shape == (6, 1024) and done.shape == (1, 1024)
    sp = torch.from_numpy(spots_t)
    carry_t = tmle._fit_resume(sp, theta, old, done, iters, ms, EPS, 34,
                               "sigmaxy")
    out = _np(tmle._fit_finish(sp, *carry_t, EPS, 50, "sigmaxy"))
    assert_fits_close(jax_fit, out)


def test_sigma_method_not_ported():
    """The sigma method is ported now (tests/test_torch_sigma.py): both
    entries take it and pad its theta/CRLB to 6 rows. A method that
    neither package has still raises."""
    sp = torch.from_numpy(np.ascontiguousarray(
        make_spots(8, seed=2).transpose(1, 2, 0)))
    theta, crlb, _, _ = mle_cuda.fit_boundary_t(sp, EPS, MAX_IT,
                                                method="sigma")
    assert theta.shape == crlb.shape == (6, 8)
    for fn in (mle_cuda.fit_boundary_t, tmle._fit_core):
        with pytest.raises(ValueError, match="Method not available"):
            fn(sp, EPS, MAX_IT, method="sigmaz")


@pytest.mark.parametrize("raw", [False, True])
def test_gaussmle_matches_jax(raw):
    """The public fit API, with and without the photon conversion of raw
    u16 camera counts (raw - baseline) * factor on the device."""
    from picasso_torch import gaussmle as tg
    from picasso_tpu import gaussmle as jg

    spots = make_spots(512, seed=9)
    conv = None
    if raw:
        spots = (spots * 2 + 100).astype(np.uint16)
        conv = (100.0, 0.5)
    j = jg.gaussmle(spots, EPS, MAX_IT, photon_conversion=conv)
    t = tg.gaussmle(spots, EPS, MAX_IT, photon_conversion=conv,
                    device="cpu")
    assert t[0].shape == (512, 6) and t[3].dtype == np.int32
    compare_fits((j[0].T, j[1].T, j[2], j[3]), (t[0].T, t[1].T, t[2], t[3]))
