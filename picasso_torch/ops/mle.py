"""Batched MLE Gaussian fitting (Smith et al., Nat. Methods 2010): the
plain PyTorch version of the fit that csrc/mle_fit.cu runs on the card.

Counterpart of picasso_tpu/ops/mle.py: the same moment initialiser,
the same Newton update on the integrated-Gaussian pixel model with a
Poisson likelihood, and the CRLB from the equilibrated Fisher matrix,
for both methods: ``sigmaxy`` (six parameters [x, y, photons, bg, sx,
sy], convergence on rows (0, 1, 4, 5)) and ``sigma`` (five, [x, y,
photons, bg, sigma], convergence on rows (0, 1); its theta and CRLB are
padded to six rows by repeating sigma). Layouts match the JAX package:
spots lanes-last (S, S, N) f32 indexed [y, x, n]; theta, crlb (6, N);
the carry's theta, old and max_step (R, N) with R = 6 or 5; done and
iters (1, N) f32.

Every sum over a box axis is written out as a sequential sum of rows.
That keeps each spot's arithmetic independent of where its lane sits
in the batch, so the phase schedule (ops/mle_cuda.fit_boundary_t), which
permutes lanes between phases, reproduces :func:`_fit_core` bit for bit,
and it is the order in which the CUDA kernel sums.
"""

from __future__ import annotations

import numpy as np
import torch

from picasso_torch.ops.gaussian import fused_axis_terms, fused_axis_terms_iso
from picasso_torch.ops.linalg import spd_inv_diag

_CONV_ROWS = {"sigmaxy": (0, 1, 4, 5), "sigma": (0, 1)}


def _check_method(method: str) -> None:
    if method not in _CONV_ROWS:
        raise ValueError("Method not available.")


def _rowsum(a: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0, row by row in order."""
    acc = a[0]
    for r in range(1, a.shape[0]):
        acc = acc + a[r]
    return acc


def _rowdot(A: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    acc = A[0] * T[0]
    for r in range(1, A.shape[0]):
        acc = acc + A[r] * T[r]
    return acc


def _nan_sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: 0 at zero, NaN at NaN (torch.sign maps NaN to 0)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


# ---------------------------------------------------------------------------
# Initial parameters (picasso/gaussmle.py:28-168)
# ---------------------------------------------------------------------------


def _mean_filter_min(spots_t: torch.Tensor) -> torch.Tensor:
    """Min over the 3x3 edge-clipped mean filter of each spot — the
    background initialiser. spots_t is (S, S, N); returns (N,)."""
    s = spots_t.shape[0]
    zrow = torch.zeros_like(spots_t[:1])
    padded = torch.cat([zrow, spots_t, zrow], dim=0)
    rows = padded[0:s] + padded[1:s + 1] + padded[2:s + 2]
    zcol = torch.zeros_like(rows[:, :1])
    padded = torch.cat([zcol, rows, zcol], dim=1)
    summed = padded[:, 0:s] + padded[:, 1:s + 1] + padded[:, 2:s + 2]
    c = torch.full((s,), 3.0, dtype=spots_t.dtype, device=spots_t.device)
    c[0] = c[-1] = 2.0
    filtered = summed / (c[:, None, None] * c[None, :, None])
    return torch.amin(filtered.reshape(s * s, -1), dim=0)


def initial_theta_sigmaxy_t(spots_t: torch.Tensor):
    """Per-spot [x, y, photons, bg, sx, sy] from a (S, S, N) batch
    (picasso/gaussmle.py:128-168). Returns six (N,) tensors."""
    s = spots_t.shape[0]
    grid = torch.arange(s, dtype=spots_t.dtype, device=spots_t.device)
    flat = spots_t.reshape(s * s, -1)
    total = _rowsum(flat)
    y_com = _rowsum((spots_t * grid[:, None, None]).reshape(s * s, -1))
    x_com = _rowsum((spots_t * grid[None, :, None]).reshape(s * s, -1))
    y_com = y_com / total
    x_com = x_com / total
    degenerate = total <= 0.0
    center = (s - 1) / 2.0
    total = torch.where(degenerate, 0.01, total)
    y_com = torch.where(degenerate, center, y_com)
    x_com = torch.where(degenerate, center, x_com)

    bg = _mean_filter_min(spots_t)
    photons = torch.clamp(total - s * s * bg, min=1.0)

    # second moments of the centre column (along y) and row (along x)
    half = s // 2
    d2 = (grid - half) ** 2
    col = spots_t[:, half, :] - bg[None, :]
    row = spots_t[half, :, :] - bg[None, :]
    sy = torch.sqrt(_rowdot(d2[:, None].expand_as(col), col) / _rowsum(col))
    sx = torch.sqrt(_rowdot(d2[:, None].expand_as(row), row) / _rowsum(row))
    sy = torch.where(torch.isfinite(sy) & (sy != 0), sy, 0.01)
    sx = torch.where(torch.isfinite(sx) & (sx != 0), sx, 0.01)
    return x_com, y_com, photons, bg, sx, sy


# ---------------------------------------------------------------------------
# Newton step (picasso/gaussmle.py:793-841)
# ---------------------------------------------------------------------------


def _axis_factors_sigmaxy(x, y, sx, sy, s: int):
    """Per-axis (S, N) factors of the 6-parameter model."""
    idx = torch.arange(s, dtype=x.dtype, device=x.device)[:, None]
    psf_x, dmu_x, d2mu_x, dsig_x, d2sig_x = fused_axis_terms(
        idx - x[None, :], sx[None, :]
    )
    psf_y, dmu_y, d2mu_y, dsig_y, d2sig_y = fused_axis_terms(
        idx - y[None, :], sy[None, :]
    )
    return (
        psf_x, psf_y, dmu_x, d2mu_x, dmu_y, d2mu_y,
        dsig_x, d2sig_x, dsig_y, d2sig_y,
    )


def _newton_step_sigmaxy(theta, spots_t, max_step):
    """One Newton update of all six parameters for every spot. theta is
    (6, N). Single pass over the spot columns: each column's C/D terms
    fold into per-row accumulators (the JAX package's "rowacc" form)."""
    s = spots_t.shape[0]
    x, y, photons, bg, sx, sy = theta
    (
        psf_x, psf_y, dmu_x, d2mu_x, dmu_y, d2mu_y,
        dsig_x, d2sig_x, dsig_y, d2sig_y,
    ) = _axis_factors_sigmaxy(x, y, sx, sy, s)
    ph = photons
    ph2 = photons * photons

    cf_cols = (dmu_x, psf_x, dsig_x, d2mu_x, d2sig_x)
    df_cols = (dmu_x, psf_x, dsig_x)  # squared below
    Tc: list = [None] * 6  # 5 factors + plain sum
    Td: list = [None] * 4  # 3 squared factors + plain sum
    for i in range(s):
        data_i = spots_t[:, i, :]  # (S_y, N): column x = i
        model_i = ph[None, :] * psf_y * psf_x[i][None, :] + bg[None, :]
        valid = model_i > 10e-3
        r_i = 1.0 / model_i
        dr_i = data_i * r_i
        cf_i = torch.clamp(torch.where(valid, dr_i - 1.0, 0.0), max=10e4)
        df_i = torch.clamp(torch.where(valid, dr_i * r_i, 0.0), max=10e4)
        for k, B in enumerate(cf_cols):
            v = cf_i * B[i][None, :]
            Tc[k] = v if Tc[k] is None else Tc[k] + v
        Tc[5] = cf_i if Tc[5] is None else Tc[5] + cf_i
        for k, B in enumerate(df_cols):
            b = B[i][None, :]
            v = df_i * (b * b)
            Td[k] = v if Td[k] is None else Td[k] + v
        Td[3] = df_i if Td[3] is None else Td[3] + df_i

    psf_y2 = psf_y * psf_y
    num = torch.stack(
        [
            ph * _rowdot(psf_y, Tc[0]),
            ph * _rowdot(dmu_y, Tc[1]),
            _rowdot(psf_y, Tc[1]),
            _rowsum(Tc[5]),
            ph * _rowdot(psf_y, Tc[2]),
            ph * _rowdot(dsig_y, Tc[1]),
        ]
    )
    den = torch.stack(
        [
            ph * _rowdot(psf_y, Tc[3]) - ph2 * _rowdot(psf_y2, Td[0]),
            ph * _rowdot(d2mu_y, Tc[1])
            - ph2 * _rowdot(dmu_y * dmu_y, Td[1]),
            -_rowdot(psf_y2, Td[1]),
            -_rowsum(Td[3]),
            ph * _rowdot(psf_y, Tc[4]) - ph2 * _rowdot(psf_y2, Td[2]),
            ph * _rowdot(d2sig_y, Tc[1])
            - ph2 * _rowdot(dsig_y * dsig_y, Td[1]),
        ]
    )
    update = torch.where(
        den == 0.0,
        _nan_sign(num) * max_step,
        torch.minimum(torch.maximum(num / den, -max_step), max_step),
    )
    theta = theta - update
    # constraints (picasso/gaussmle.py:880-884)
    return torch.stack(
        [
            theta[0],
            theta[1],
            torch.clamp(theta[2], min=1.0),
            torch.clamp(theta[3], min=0.01),
            torch.clamp(theta[4], min=0.01),
            torch.clamp(theta[5], min=0.01),
        ]
    )


def _axis_factors_sigma(x, y, sigma, s: int):
    """Per-axis (S, N) factors of the 5-parameter isotropic model."""
    idx = torch.arange(s, dtype=x.dtype, device=x.device)[:, None]
    sg = sigma[None, :]
    psf_x, dmu_x, d2mu_x, dpsf_x, d2psf_x = fused_axis_terms_iso(
        idx - x[None, :], sg
    )
    psf_y, dmu_y, d2mu_y, dpsf_y, d2psf_y = fused_axis_terms_iso(
        idx - y[None, :], sg
    )
    return (
        psf_x, psf_y, dmu_x, d2mu_x, dmu_y, d2mu_y,
        dpsf_x, d2psf_x, dpsf_y, d2psf_y,
    )


def _newton_step_sigma(theta, spots_t, max_step):
    """One Newton update of the five parameters [x, y, photons, bg,
    sigma] (picasso/gaussmle.py:574-670), in the JAX package's "rowacc"
    form. Two quirks of the reference are kept: a zero denominator steps
    by sign(num * max_step), i.e. +-1, and photons multiply only the
    first term of d2udt2_sigma."""
    s = spots_t.shape[0]
    x, y, photons, bg, sigma = theta
    (
        psf_x, psf_y, dmu_x, d2mu_x, dmu_y, d2mu_y,
        dpsf_x, d2psf_x, dpsf_y, d2psf_y,
    ) = _axis_factors_sigma(x, y, sigma, s)
    ph = photons
    ph2 = photons * photons

    cf_cols = (dmu_x, psf_x, dpsf_x, d2mu_x, d2psf_x)
    Tc: list = [None] * 6  # 5 factors + plain sum
    Td: list = [None] * 5  # dmu_x^2, psf_x^2, dpsf_x^2, dpsf_x*psf_x, plain
    for i in range(s):
        data_i = spots_t[:, i, :]
        model_i = ph[None, :] * psf_y * psf_x[i][None, :] + bg[None, :]
        valid = model_i > 10e-3
        r_i = 1.0 / model_i
        dr_i = data_i * r_i
        cf_i = torch.clamp(torch.where(valid, dr_i - 1.0, 0.0), max=10e4)
        df_i = torch.clamp(torch.where(valid, dr_i * r_i, 0.0), max=10e4)
        for k, B in enumerate(cf_cols):
            v = cf_i * B[i][None, :]
            Tc[k] = v if Tc[k] is None else Tc[k] + v
        Tc[5] = cf_i if Tc[5] is None else Tc[5] + cf_i
        dsq = (
            df_i * (dmu_x[i] * dmu_x[i])[None, :],
            df_i * (psf_x[i] * psf_x[i])[None, :],
            df_i * (dpsf_x[i] * dpsf_x[i])[None, :],
            df_i * (dpsf_x[i] * psf_x[i])[None, :],
            df_i,
        )
        for k, v in enumerate(dsq):
            Td[k] = v if Td[k] is None else Td[k] + v

    psf_y2 = psf_y * psf_y
    num_sigma = ph * (_rowdot(psf_y, Tc[2]) + _rowdot(dpsf_y, Tc[1]))
    den_sigma_cf = (
        ph * _rowdot(psf_y, Tc[4])
        + 2 * _rowdot(dpsf_y, Tc[2])
        + _rowdot(d2psf_y, Tc[1])
    )
    den_sigma_df = ph2 * (
        _rowdot(psf_y2, Td[2])
        + 2 * _rowdot(psf_y * dpsf_y, Td[3])
        + _rowdot(dpsf_y * dpsf_y, Td[1])
    )
    num = torch.stack(
        [
            ph * _rowdot(psf_y, Tc[0]),
            ph * _rowdot(dmu_y, Tc[1]),
            _rowdot(psf_y, Tc[1]),
            _rowsum(Tc[5]),
            num_sigma,
        ]
    )
    den = torch.stack(
        [
            ph * _rowdot(psf_y, Tc[3]) - ph2 * _rowdot(psf_y2, Td[0]),
            ph * _rowdot(d2mu_y, Tc[1])
            - ph2 * _rowdot(dmu_y * dmu_y, Td[1]),
            -_rowdot(psf_y2, Td[1]),
            -_rowsum(Td[4]),
            den_sigma_cf - den_sigma_df,
        ]
    )
    update = torch.where(
        den == 0.0,
        _nan_sign(num * max_step),
        torch.minimum(torch.maximum(num / den, -max_step), max_step),
    )
    theta = theta - update
    return torch.stack(
        [
            theta[0],
            theta[1],
            torch.clamp(theta[2], min=1.0),
            torch.clamp(theta[3], min=0.01),
            torch.clamp(theta[4], min=0.01, max=float(s)),
        ]
    )


_STEPS = {"sigmaxy": _newton_step_sigmaxy, "sigma": _newton_step_sigma}


# ---------------------------------------------------------------------------
# CRLB + log-likelihood
# ---------------------------------------------------------------------------


def _fisher_terms_sigmaxy(theta, s: int):
    """Per-parameter first-derivative factors [(scale, A, B)] of the
    Fisher matrix; dudt_p = scale * A (x) B."""
    x, y, photons, bg, sx, sy = theta
    (
        psf_x, psf_y, dmu_x, _, dmu_y, _,
        dsig_x, _, dsig_y, _,
    ) = _axis_factors_sigmaxy(x, y, sx, sy, s)
    ones = torch.ones_like(psf_x)
    ph = photons
    one = torch.ones_like(ph)
    terms = [
        [(ph, psf_y, dmu_x)],
        [(ph, dmu_y, psf_x)],
        [(one, psf_y, psf_x)],
        [(one, ones, ones)],
        [(ph, psf_y, dsig_x)],
        [(ph, dsig_y, psf_x)],
    ]
    return terms, psf_x, psf_y


def _fisher_terms_sigma(theta, s: int):
    """As :func:`_fisher_terms_sigmaxy` for the isotropic model, whose
    sigma derivative is the sum of two separable terms."""
    x, y, photons, bg, sigma = theta
    (
        psf_x, psf_y, dmu_x, _, dmu_y, _,
        dpsf_x, _, dpsf_y, _,
    ) = _axis_factors_sigma(x, y, sigma, s)
    ones = torch.ones_like(psf_x)
    ph = photons
    one = torch.ones_like(ph)
    terms = [
        [(ph, psf_y, dmu_x)],
        [(ph, dmu_y, psf_x)],
        [(one, psf_y, psf_x)],
        [(one, ones, ones)],
        [(ph, psf_y, dpsf_x), (ph, dpsf_y, psf_x)],
    ]
    return terms, psf_x, psf_y


def _crlb_and_likelihood(terms, psf_x, psf_y, photons, bg, spots_t):
    """Fisher-matrix CRLBs + Poisson log-likelihood with the Stirling
    approximation (picasso/gaussmle.py:684-742/898-954). One pass over
    the spot columns; the f32 inverse runs on the diagonally
    equilibrated matrix."""
    P = len(terms)
    s = spots_t.shape[0]

    # distinct column-factor (B) vectors across all terms, by identity
    b_list: list = []
    b_ids: dict[int, int] = {}
    for plist in terms:
        for (_, _, B) in plist:
            if id(B) not in b_ids:
                b_ids[id(B)] = len(b_list)
                b_list.append(B)
    nB = len(b_list)

    T: dict[tuple[int, int], torch.Tensor] = {}
    ll_acc = None
    for i in range(s):
        data_i = spots_t[:, i, :]
        model_i = (
            photons[None, :] * psf_y * psf_x[i][None, :] + bg[None, :]
        )
        W_i = 1.0 / model_i  # model >= bg >= 0.01 after constraints
        for a in range(nB):
            Ba_i = b_list[a][i][None, :]
            for b in range(a, nB):
                v = W_i * (Ba_i * b_list[b][i][None, :])
                T[(a, b)] = v if (a, b) not in T else T[(a, b)] + v
        ll_pos = (
            data_i * torch.log(model_i)
            - model_i
            - data_i * torch.log(data_i)
            + data_i
        )
        ll_i = torch.where(data_i > 0, ll_pos, -model_i)
        ll_i = torch.where(model_i > 0, ll_i, 0.0)
        ll_acc = ll_i if ll_acc is None else ll_acc + ll_i

    def _T(Bp, Bq):
        a, b = b_ids[id(Bp)], b_ids[id(Bq)]
        return T[(min(a, b), max(a, b))]

    entries: dict[tuple[int, int], torch.Tensor] = {}
    for p in range(P):
        for q in range(p, P):
            acc = None
            for (sp, Ap, Bp) in terms[p]:
                for (sq, Aq, Bq) in terms[q]:
                    v = sp * sq * _rowdot(Ap * Aq, _T(Bp, Bq))
                    acc = v if acc is None else acc + v
            entries[(p, q)] = entries[(q, p)] = acc
    M = torch.stack(
        [torch.stack([entries[(p, q)] for q in range(P)]) for p in range(P)]
    )
    diag = torch.stack([M[p, p] for p in range(P)])
    d_inv = torch.where(diag > 0, 1.0 / torch.sqrt(diag), 1.0)
    M_eq = M * d_inv[:, None, :] * d_inv[None, :, :]
    crlb = spd_inv_diag(M_eq) * (d_inv * d_inv)
    return crlb, _rowsum(ll_acc)


# ---------------------------------------------------------------------------
# Full fit program and its resumable phases
# ---------------------------------------------------------------------------


def _init_state(spots_t: torch.Tensor, method: str):
    """Initial carry (theta, old, done, iters, max_step), theta/old/
    max_step with 6 rows (sigmaxy) or 5 (sigma). max_step comes from the
    INITIAL parameters (picasso/gaussmle.py:770-773), so it is carried
    across resumed phases."""
    _check_method(method)
    x0, y0, ph0, bg0, sx0, sy0 = initial_theta_sigmaxy_t(spots_t)
    if method == "sigmaxy":
        theta0 = torch.stack([x0, y0, ph0, bg0, sx0, sy0])
        max_step = torch.stack(
            [sx0, sx0, 0.1 * ph0, 0.1 * bg0, 0.2 * sx0, 0.2 * sy0]
        )
    else:
        s0 = (sx0 + sy0) / 2
        theta0 = torch.stack([x0, y0, ph0, bg0, s0])
        max_step = torch.stack([s0, s0, 0.1 * ph0, 0.1 * bg0, 0.2 * s0])
    zero = torch.zeros_like(theta0[:1])
    return theta0, theta0, zero, zero.clone(), max_step


def _run_newton_rounds(
    spots_t, theta, old, done, iters, max_step, eps: float,
    n_iters: int, method: str,
):
    """Up to ``n_iters`` Newton iterations from a carried state, leaving
    early once every spot has converged. Calling it twice with a and b
    iterations equals one call with a + b. A converged spot's theta and
    ``old`` freeze; ``iters`` counts the steps each spot took."""
    _check_method(method)
    step = _STEPS[method]
    eps = float(eps)
    kk = 0
    while kk < n_iters and bool((done < 0.5).any()):
        kk += 1
        frozen = done > 0.5
        new_theta = step(theta, spots_t, max_step)
        theta = torch.where(frozen, theta, new_theta)
        iters = iters + (1.0 - done)
        conv = torch.ones_like(done)
        for r in _CONV_ROWS[method]:
            conv = conv * (
                torch.abs(old[r:r + 1] - theta[r:r + 1]) < eps
            )
        done = torch.maximum(done, conv)
        old = torch.where(done > 0.5, old, theta)
    return theta, old, done, iters


def _crlb_ll_for(theta, spots_t, method: str):
    """CRLB and log-likelihood at theta; for ``sigma`` theta and CRLB
    are padded to 6 rows by repeating sigma (gaussmle.py:641-642)."""
    _check_method(method)
    s = spots_t.shape[0]
    if method == "sigmaxy":
        terms, fpx, fpy = _fisher_terms_sigmaxy(theta, s)
    else:
        terms, fpx, fpy = _fisher_terms_sigma(theta, s)
    crlb, ll = _crlb_and_likelihood(
        terms, fpx, fpy, theta[2], theta[3], spots_t
    )
    if method == "sigma":
        theta = torch.cat([theta, theta[4:5]])
        crlb = torch.cat([crlb, crlb[4:5]])
    return theta, crlb, ll


def _freeze_tail(done0: torch.Tensor, n_valid):
    """Lanes at index >= n_valid start converged."""
    lane = torch.arange(done0.shape[-1], device=done0.device)
    return torch.maximum(done0, (lane >= n_valid).to(done0.dtype))


def _fit_start(spots_t, eps, k, method, n_valid=None):
    """Phase entry: init + up to ``k`` Newton iterations. Returns the
    resumable carry (theta, old, done, iters, max_step)."""
    theta0, old0, done0, iters0, max_step = _init_state(spots_t, method)
    if n_valid is not None:
        done0 = _freeze_tail(done0, n_valid)
    theta, old, done, iters = _run_newton_rounds(
        spots_t, theta0, old0, done0, iters0, max_step, eps, k, method,
    )
    return theta, old, done, iters, max_step


def _fit_resume(spots_t, theta, old, done, iters, max_step, eps, k,
                method):
    """Continue a carried fit for up to ``k`` more iterations."""
    theta, old, done, iters = _run_newton_rounds(
        spots_t, theta, old, done, iters, max_step, eps, k, method
    )
    return theta, old, done, iters, max_step


def _fit_finish(spots_t, theta, old, done, iters, max_step, eps, k,
                method):
    """Last phase: up to ``k`` more iterations, then CRLB and
    log-likelihood. Returns (theta (6, N), crlb (6, N), ll (N,),
    iters (N,) i32)."""
    theta, _, _, iters = _run_newton_rounds(
        spots_t, theta, old, done, iters, max_step, eps, k, method
    )
    theta6, crlb6, ll = _crlb_ll_for(theta, spots_t, method)
    return theta6, crlb6, ll, iters[0].to(torch.int32)


def _fit_phase(mode: int, spots_t, eps, k, method, n_valid=None,
               carry=None):
    """One phase of a phase schedule, the plain version of one phase
    launch of the fit kernel: ``mode`` 1 :func:`_fit_start`, 2
    :func:`_fit_resume`, 3 :func:`_fit_finish` (the kernels' mode
    numbers)."""
    if mode == 1:
        return _fit_start(spots_t, eps, k, method, n_valid)
    if mode == 2:
        return _fit_resume(spots_t, *carry, eps, k, method)
    return _fit_finish(spots_t, *carry, eps, k, method)


def _fit_core(spots_t, eps: float, max_it: int, method: str = "sigmaxy",
              n_valid=None):
    """Fit a (S, S, N) f32 spot batch. Returns (theta (6, N),
    crlb (6, N), ll (N,), iters (N,) i32)."""
    carry = _fit_start(spots_t, eps, max_it, method, n_valid)
    return _fit_finish(spots_t, *carry, eps, 0, method)


def state_from_numpy(theta, old, done, iters, max_step, device="cpu"):
    """The fit's resumable carry as returned (converted to numpy) by
    ``picasso_tpu.ops.mle._fit_start``, as the port's f32 tensors:
    theta/old/max_step (R, N) with R = 6 (sigmaxy) or 5 (sigma),
    done/iters (1, N)."""
    r = np.shape(theta)[0]
    out = []
    for a, rows in ((theta, r), (old, r), (done, 1), (iters, 1),
                    (max_step, r)):
        a = np.asarray(a, dtype=np.float32).reshape(rows, -1)
        out.append(torch.from_numpy(a.copy()).to(device))
    return tuple(out)
