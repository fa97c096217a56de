"""Batched least-squares fit of the plain elliptic 2D Gaussian by
Levenberg–Marquardt: the plain PyTorch version of the fit that
csrc/lq_fit.cu and the LM work queues (csrc/lq_queue.cuh) run on the
card.

Counterpart of picasso_tpu/ops/lq.py (the reference's scipy leastsq and
Gpufit GAUSS_2D_ELLIPTIC paths, picasso/gausslq.py:206-395). Parameters
are [x, y, photons, bg, sx, sy] with x/y relative to the box centre; the
model is the normalised (not integrated) Gaussian plus background.
Layouts match the JAX package: spots lanes-last (S, S, N) f32 indexed
[y, x, n]; theta (6, N); the LM carry lam, cost and done (1, N) f32.

Each Jacobian column is separable into a row factor (over y) times a
column factor (over x), so J^T J needs only 1D dot products and J^T r
one pass over the spot. Every sum over a box axis is a sequential sum
in the JAX order (columns i folded into per-row accumulators, then the
rows), so a lane's result does not depend on where it sits in the batch
and the phase schedule (ops/lq_cuda.fit_boundary_t on the CPU)
reproduces :func:`_lm_core` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from picasso_torch.ops.linalg import spd_solve
from picasso_torch.ops.mle import _rowdot, _rowsum

_NORM = 0.3989422804014327  # 1 / sqrt(2 pi)


def initial_parameters_t(spots_t: torch.Tensor) -> torch.Tensor:
    """theta (6, N) = [x, y, photons, bg, sx, sy] from the moments of
    the background-subtracted spot, x/y relative to the box centre
    (picasso/gausslq.py:95-112). spots_t is (S, S, N)."""
    s = spots_t.shape[0]
    half = s // 2
    flat = spots_t.reshape(s * s, -1)
    bg = torch.amin(flat, dim=0)
    nobg = spots_t - bg[None, None, :]
    grid = torch.arange(s, dtype=spots_t.dtype, device=spots_t.device)
    yi = grid[:, None, None]
    xi = grid[None, :, None]
    total = _rowsum(nobg.reshape(s * s, -1))
    y_com = _rowsum((nobg * yi).reshape(s * s, -1)) / total
    x_com = _rowsum((nobg * xi).reshape(s * s, -1)) / total
    degenerate = total <= 0.0
    center = (s - 1) / 2.0
    total_d = torch.where(degenerate, 0.01, total)
    y_com = torch.where(degenerate, center, y_com)
    x_com = torch.where(degenerate, center, x_com)
    photons = torch.clamp(total_d, min=1.0)
    dy = yi - y_com[None, None, :]
    dx = xi - x_com[None, None, :]
    sy = torch.sqrt(_rowsum((nobg * (dy * dy)).reshape(s * s, -1)) / total_d)
    sx = torch.sqrt(_rowsum((nobg * (dx * dx)).reshape(s * s, -1)) / total_d)
    return torch.stack([x_com - half, y_com - half, photons, bg, sx, sy])


def _axis_factors(theta: torch.Tensor, s: int):
    """Per-axis (S, N) model factors gx, gy and their derivatives
    d/dx, d/dy, d/dsx, d/dsy."""
    half = s // 2
    grid = (torch.arange(s, dtype=theta.dtype, device=theta.device)
            - half)[:, None]
    x, y, _, _, sx, sy = theta
    dx = grid - x[None, :]
    dy = grid - y[None, :]
    inv_sx = 1.0 / sx[None, :]
    inv_sy = 1.0 / sy[None, :]
    ux = dx * inv_sx
    uy = dy * inv_sy
    gx = _NORM * inv_sx * torch.exp(-0.5 * (ux * ux))
    gy = _NORM * inv_sy * torch.exp(-0.5 * (uy * uy))
    dgx_dx = gx * dx * inv_sx * inv_sx
    dgy_dy = gy * dy * inv_sy * inv_sy
    dgx_dsx = gx * inv_sx * (ux * ux - 1.0)
    dgy_dsy = gy * inv_sy * (uy * uy - 1.0)
    return gx, gy, dgx_dx, dgy_dy, dgx_dsx, dgy_dsy


def _cost(theta: torch.Tensor, spots_t: torch.Tensor, s: int) -> torch.Tensor:
    """Sum of squared residuals per spot (N,): per-row sums over the
    columns i, then over the rows."""
    gx, gy, *_ = _axis_factors(theta, s)
    ph, bg = theta[2], theta[3]
    acc = None
    for i in range(s):
        r_i = spots_t[:, i, :] - (ph[None, :] * gy * gx[i][None, :]
                                  + bg[None, :])
        v = r_i * r_i
        acc = v if acc is None else acc + v
    return _rowsum(acc)


def _normal_equations(theta: torch.Tensor, spots_t: torch.Tensor, s: int):
    """J^T J (6, 6, N) and J^T r (6, N) from the separable axis
    factors; no Jacobian tensor is formed."""
    gx, gy, dgx_dx, dgy_dy, dgx_dsx, dgy_dsy = _axis_factors(theta, s)
    ph, bg = theta[2], theta[3]
    ones = torch.ones_like(gx)
    one = torch.ones_like(ph)
    # (scale, row factor a over y, column factor b over x)
    terms = [
        (ph, gy, dgx_dx),
        (ph, dgy_dy, gx),
        (one, gy, gx),
        (one, ones, ones),
        (ph, gy, dgx_dsx),
        (ph, dgy_dsy, gx),
    ]
    b_cols = (dgx_dx, gx, dgx_dsx)
    Tc: list = [None] * 4  # 3 column factors + the plain sum (bg)
    for i in range(s):
        r_i = spots_t[:, i, :] - (ph[None, :] * gy * gx[i][None, :]
                                  + bg[None, :])
        for k, B in enumerate(b_cols):
            v = r_i * B[i][None, :]
            Tc[k] = v if Tc[k] is None else Tc[k] + v
        Tc[3] = r_i if Tc[3] is None else Tc[3] + r_i
    Jtr = torch.stack([
        ph * _rowdot(gy, Tc[0]),
        ph * _rowdot(dgy_dy, Tc[1]),
        _rowdot(gy, Tc[1]),
        _rowsum(Tc[3]),
        ph * _rowdot(gy, Tc[2]),
        ph * _rowdot(dgy_dsy, Tc[1]),
    ])
    entries: dict[tuple[int, int], torch.Tensor] = {}
    for p in range(6):
        sp, ap, bp = terms[p]
        for q in range(p, 6):
            sq, aq, bq = terms[q]
            entries[(p, q)] = entries[(q, p)] = (
                sp * sq * _rowsum(ap * aq) * _rowsum(bp * bq)
            )
    JtJ = torch.stack([
        torch.stack([entries[(p, q)] for q in range(6)]) for p in range(6)
    ])
    return JtJ, Jtr


def _lm_init(spots_t: torch.Tensor, n_valid=None):
    """Initial LM carry (theta (6, N), lam (1, N), cost (1, N), done
    (1, N)). Lanes at index >= ``n_valid`` start done."""
    s = spots_t.shape[0]
    theta0 = initial_parameters_t(spots_t)
    cost0 = _cost(theta0, spots_t, s)[None, :]
    done0 = torch.zeros_like(cost0)
    if n_valid is not None:
        lane = torch.arange(cost0.shape[1], device=cost0.device)
        done0 = (lane >= n_valid).to(cost0.dtype)[None, :]
    lam0 = torch.full_like(cost0, 1e-3)
    return theta0, lam0, cost0, done0


def _lm_step(spots_t, theta, lam, cost, done, ftol: float):
    """One LM iteration for every lane. A done lane keeps its theta,
    lam and cost. A damped matrix that is not SPD gives a non-finite
    step, which is dropped; the lane's damping then grows x10 until
    lam >= 1e7 marks it done."""
    s = spots_t.shape[0]
    JtJ, Jtr = _normal_equations(theta, spots_t, s)
    damped = [JtJ[p, p] * (1.0 + lam[0]) for p in range(6)]
    A = torch.stack([
        torch.stack([damped[p] if p == q else JtJ[p, q] for q in range(6)])
        for p in range(6)
    ])
    delta = spd_solve(A, Jtr)
    finite = torch.isfinite(delta).all(dim=0, keepdim=True).to(theta.dtype)
    delta = torch.where(finite > 0.5, delta, 0.0)
    trial = theta + delta
    trial_cost = _cost(trial, spots_t, s)[None, :]
    improved = finite * (trial_cost < cost) * (1.0 - done)
    rel = torch.abs(cost - trial_cost) / torch.clamp(cost, min=1e-20)
    conv = improved * (rel < ftol)
    imp = improved > 0.5
    theta = torch.where(imp, trial, theta)
    cost = torch.where(imp, trial_cost, cost)
    lam = torch.where(
        imp, torch.clamp(lam * 0.1, min=1e-9),
        torch.where(done > 0.5, lam, torch.clamp(lam * 10.0, max=1e7)),
    )
    done = torch.maximum(
        done, torch.maximum(conv, (lam >= 1e7).to(done.dtype))
    )
    return theta, lam, cost, done


def _lm_rounds(spots_t, theta, lam, cost, done, max_it: int, ftol: float):
    """Up to ``max_it`` LM iterations from a carried state, leaving
    early once every lane is done. Two calls of a and b iterations equal
    one of a + b."""
    ftol = float(ftol)
    kk = 0
    while kk < max_it and bool((done < 0.5).any()):
        kk += 1
        theta, lam, cost, done = _lm_step(spots_t, theta, lam, cost, done,
                                          ftol)
    return theta, lam, cost, done


def _lm_core(spots_t: torch.Tensor, max_it: int, ftol: float,
             n_valid=None) -> torch.Tensor:
    """LM fit of a (S, S, N) f32 batch; returns theta (6, N)."""
    carry = _lm_init(spots_t, n_valid)
    return _lm_rounds(spots_t, *carry, max_it, ftol)[0]


def state_from_numpy(theta, lam, cost, done, device="cpu"):
    """The LM carry as returned (converted to numpy) by
    ``picasso_tpu.ops.lq._lm_init``/``_lm_rounds``, as the port's f32
    tensors: theta (6, N), lam/cost/done (1, N)."""
    out = []
    for a, rows in ((theta, 6), (lam, 1), (cost, 1), (done, 1)):
        a = np.asarray(a, dtype=np.float32).reshape(rows, -1)
        out.append(torch.from_numpy(a.copy()).to(device))
    return tuple(out)


_CHUNK = 262144


def fit_spots_batched(spots: np.ndarray, max_it: int = 30,
                      progress_callback=None,
                      photon_conversion: tuple[float, float] | None = None,
                      device="cuda") -> np.ndarray:
    """LM-fit (N, S, S) spots on ``device`` in chunks; returns theta
    (N, 6) [x, y, photons, bg, sx, sy], x/y relative to the box centre.
    ``photon_conversion=(baseline, factor)`` converts raw counts as
    (raw - baseline) * factor on the device."""
    from picasso_torch import lib
    from picasso_torch.ops import lq_cuda
    from picasso_torch.ops.identify import as_float32

    device = lib.resolve_device(device)
    spots = np.asarray(spots)
    n = len(spots)
    out = []
    for start in range(0, n, _CHUNK):
        part = spots[start:start + _CHUNK]
        if photon_conversion is None:
            part = part.astype(np.float32)
        t = as_float32(torch.from_numpy(np.ascontiguousarray(part)).to(device))
        if photon_conversion is not None:
            baseline, factor = photon_conversion
            t = (t - float(np.float32(baseline))) * float(np.float32(factor))
        theta = lq_cuda.ROI_FIT(t.permute(1, 2, 0).contiguous(), max_it,
                                1e-6)
        out.append(theta.cpu().numpy().T)
        if callable(progress_callback):
            progress_callback(start + len(part))
    if not n:
        return np.zeros((0, 6), np.float32)
    return np.concatenate(out)
