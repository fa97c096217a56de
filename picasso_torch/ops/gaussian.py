"""Integrated-Gaussian PSF math (Smith et al., Nature Methods 2010
supplement) on torch tensors.

Counterpart of picasso_tpu/ops/gaussian.py: the rational A&S erf, the
erfc-complement PSF assembly and the row-shared axis factors of the
MLE fit. Arrays hold pixel offsets ``d = x_k - mu`` with the spot index
on the last axis. The CUDA fit kernel (csrc/mle_fit.cu) evaluates the
same expressions in the same order per spot.
"""

from __future__ import annotations

import torch

_SQRT_2PI = 2.5066282746310002
_INV_SQRT2 = 0.70710678118654757
_SQRT_PI = 1.7724538509055159

# Abramowitz & Stegun 7.1.26 coefficients
_P = 0.3275911
_A1, _A2, _A3, _A4, _A5 = (
    0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429,
)


def _poly(t: torch.Tensor) -> torch.Tensor:
    return t * (_A1 + t * (_A2 + t * (_A3 + t * (_A4 + t * _A5))))


def erf(x: torch.Tensor) -> torch.Tensor:
    """Branchless rational erf (A&S 7.1.26, |error| <= 1.5e-7), the same
    form the JAX package uses on every backend."""
    ax = torch.abs(x)
    t = 1.0 / (1.0 + _P * ax)
    return torch.sign(x) * (1.0 - _poly(t) * torch.exp(-ax * ax))


def _erfc_from_exp(a: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """erfc(|a|/sqrt(2)) given e == exp(-(a/sqrt(2))^2). The complement
    form keeps relative accuracy deep in the tail."""
    x = torch.abs(a) * _INV_SQRT2
    t = 1.0 / (1.0 + _P * x)
    return _poly(t) * e


def _psf_from_erfc(ap, am, qa, qb):
    """0.5*(erf(ap/sqrt2) - erf(am/sqrt2)) from the complements, per
    sign region: right tail, left tail, straddling."""
    return torch.where(
        am >= 0,
        0.5 * (qb - qa),
        torch.where(ap <= 0, 0.5 * (qa - qb), 0.5 * (2.0 - qa - qb)),
    )


def _shared_exp_erfc(d: torch.Tensor, inv_s: torch.Tensor):
    """Exponentials and erfc complements over the extended half-offset
    grid: consecutive rows of ``d`` (d[i] = i - x0) share them, so S+1
    values replace 2·S. Returns (ap, am, ea, eb, qa, qb) as (S, N)
    views of the (S+1, N) shared rows."""
    am8 = (d - 0.5) * inv_s
    top = (d[-1:] + 0.5) * inv_s
    a8 = torch.cat([am8, top], dim=0)
    e8 = torch.exp(-0.5 * a8 * a8)
    q8 = _erfc_from_exp(a8, e8)
    return a8[1:], a8[:-1], e8[1:], e8[:-1], q8[1:], q8[:-1]


def fused_axis_terms(d: torch.Tensor, sigma: torch.Tensor):
    """(psf, dmu, d2mu, dsig, d2sig) per-axis factors from the shared
    exponentials. ``d``'s rows must be a consecutive-integer grid
    (d[i] = i - x0), as every fit caller builds it."""
    inv_s = 1.0 / sigma
    ap, am, ea, eb, qa, qb = _shared_exp_erfc(d, inv_s)
    psf = _psf_from_erfc(ap, am, qa, qb)
    norm = inv_s / _SQRT_2PI
    dmu = (eb - ea) * norm
    dm, dp = d - 0.5, d + 0.5
    g1 = (dm * eb - dp * ea) * norm
    d2mu = g1 * inv_s * inv_s
    dsig = g1 * inv_s
    g3 = (dm * dm * dm * eb - dp * dp * dp * ea) * norm
    d2sig = (g3 * inv_s * inv_s - 2.0 * g1) * inv_s * inv_s
    return psf, dmu, d2mu, dsig, d2sig


def fused_axis_terms_iso(d: torch.Tensor, sigma: torch.Tensor):
    """(psf, dmu, d2mu, dPSF, d2PSF) per-axis factors of the isotropic
    model from the same shared exponentials: with a = (d +- 0.5)/sigma,
    exp(-a^2/2) is e (picasso/gaussmle.py:339). Same grid contract as
    :func:`fused_axis_terms`."""
    inv_s = 1.0 / sigma
    ap, am, ea, eb, qa, qb = _shared_exp_erfc(d, inv_s)
    psf = _psf_from_erfc(ap, am, qa, qb)
    norm = inv_s / _SQRT_2PI
    dmu = (eb - ea) * norm
    d2mu = ((d - 0.5) * eb - (d + 0.5) * ea) * norm * inv_s * inv_s
    F = (am * eb - ap * ea) * _INV_SQRT2
    dpsf = F / (_SQRT_PI * sigma)
    dF = (ap * ea * (1.0 - ap * ap) - am * eb * (1.0 - am * am)) \
        * _INV_SQRT2 * inv_s
    d2psf = (1.0 / _SQRT_PI) * (-F * inv_s * inv_s + dF * inv_s)
    return psf, dmu, d2mu, dpsf, d2psf
