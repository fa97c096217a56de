"""MLE fit of an integrated 2D Gaussian with a Poisson likelihood (Smith
et al., Nat. Methods 7, 373 (2010)), as Picasso's ``gaussmle`` runs it
for ``sigmaxy`` (parameters x, y, photons, bg, sx, sy):

- start: the centre of mass, the least 3 x 3 mean (edge-clipped) as the
  background, the photons above it (at least 1), and sx / sy from the
  second moments of the centre row / column above the background;
- step: each parameter moves by its own Newton step, the first
  derivative of the log-likelihood over its second, clipped to a maximum
  step set from the start (sx, sx, photons / 10, bg / 10, sx / 5,
  sy / 5); photons stay >= 1, bg and the widths >= 0.01;
- stop: once x, y, sx and sy all moved by less than ``eps``, or after
  ``max_it`` steps;
- then the Cramer-Rao bounds (the diagonal of the inverse Fisher
  matrix; NaN where that matrix is singular, as for a fit that ran
  off) and the log-likelihood with Stirling's approximation.

Every quantity is computed in the given dtype on the full pixel grid.
"""

from __future__ import annotations

import math

import torch

_SQRT_2PI = math.sqrt(2.0 * math.pi)
#: spots a block of the fit
BLOCK = 65536


def initial(spots: torch.Tensor):
    """(theta (N, 6), max_step (N, 6)) of (N, S, S) spots."""
    N, S, _ = spots.shape
    grid = torch.arange(S, dtype=spots.dtype, device=spots.device)
    total = spots.sum((1, 2))
    ycom = (spots * grid[None, :, None]).sum((1, 2)) / total
    xcom = (spots * grid[None, None, :]).sum((1, 2)) / total
    bad = total <= 0
    centre = (S - 1) / 2.0
    ycom = torch.where(bad, torch.full_like(ycom, centre), ycom)
    xcom = torch.where(bad, torch.full_like(xcom, centre), xcom)
    total = torch.where(bad, torch.full_like(total, 0.01), total)
    # 3 x 3 mean over the pixels inside the spot
    ones = torch.ones((1, 1, 3, 3), dtype=spots.dtype, device=spots.device)
    sums = torch.nn.functional.conv2d(spots[:, None], ones, padding=1)[:, 0]
    inside = torch.nn.functional.conv2d(torch.ones_like(spots[:1, None]),
                                        ones, padding=1)[:, 0]
    bg = (sums / inside).amin((1, 2))
    photons = torch.clamp(total - S * S * bg, min=1.0)
    half = S // 2
    d2 = (grid - half) ** 2
    col = spots[:, :, half] - bg[:, None]
    row = spots[:, half, :] - bg[:, None]
    sy = torch.sqrt((d2 * col).sum(1) / col.sum(1))
    sx = torch.sqrt((d2 * row).sum(1) / row.sum(1))
    sy = torch.where(torch.isfinite(sy) & (sy != 0), sy, 0.01)
    sx = torch.where(torch.isfinite(sx) & (sx != 0), sx, 0.01)
    theta = torch.stack([xcom, ycom, photons, bg, sx, sy], 1)
    max_step = torch.stack([sx, sx, 0.1 * photons, 0.1 * bg, 0.2 * sx,
                            0.2 * sy], 1)
    return theta, max_step


def axis_terms(centre: torch.Tensor, sigma: torch.Tensor, S: int):
    """Along one axis (N, S): the pixel integral of the unit Gaussian,
    and its first and second derivatives by the centre and by sigma."""
    k = torch.arange(S, dtype=centre.dtype, device=centre.device)
    s = sigma[:, None]
    am = (k[None, :] - centre[:, None] - 0.5) / s
    ap = (k[None, :] - centre[:, None] + 0.5) / s
    ea = torch.exp(-0.5 * am * am)
    eb = torch.exp(-0.5 * ap * ap)
    psf = 0.5 * (torch.erf(ap / math.sqrt(2.0)) - torch.erf(am / math.sqrt(2.0)))
    dmu = (ea - eb) / (_SQRT_2PI * s)
    d2mu = (am * ea - ap * eb) / (_SQRT_2PI * s * s)
    dsig = (am * ea - ap * eb) / (_SQRT_2PI * s)
    d2sig = ((am ** 3 - 2 * am) * ea - (ap ** 3 - 2 * ap) * eb) / (
        _SQRT_2PI * s * s)
    return psf, dmu, d2mu, dsig, d2sig


def model_terms(theta: torch.Tensor, S: int):
    """(model, first derivatives (6, N, S, S), second derivatives (6, N,
    S, S)) of the pixel model photons * psf_y psf_x + bg."""
    x, y, ph, bg, sx, sy = theta.unbind(1)
    px, dmx, d2mx, dsx, d2sx = axis_terms(x, sx, S)
    py, dmy, d2my, dsy, d2sy = axis_terms(y, sy, S)
    ph3 = ph[:, None, None]

    def outer(a, b):
        return a[:, :, None] * b[:, None, :]

    model = ph3 * outer(py, px) + bg[:, None, None]
    one = torch.ones_like(model)
    zero = torch.zeros_like(model)
    d1 = torch.stack([ph3 * outer(py, dmx), ph3 * outer(dmy, px),
                      outer(py, px), one, ph3 * outer(py, dsx),
                      ph3 * outer(dsy, px)])
    d2 = torch.stack([ph3 * outer(py, d2mx), ph3 * outer(d2my, px), zero,
                      zero, ph3 * outer(py, d2sx), ph3 * outer(d2sy, px)])
    return model, d1, d2


def newton_step(theta, spots, max_step):
    S = spots.shape[-1]
    model, d1, d2 = model_terms(theta, S)
    valid = model > 0.01
    ratio = spots / model
    cf = torch.clamp(torch.where(valid, ratio - 1.0, 0.0), max=1e5)
    df = torch.clamp(torch.where(valid, ratio / model, 0.0), max=1e5)
    num = (cf[None] * d1).sum((2, 3)).T
    den = ((cf[None] * d2).sum((2, 3)) - (df[None] * d1 * d1).sum((2, 3))).T
    step = torch.where(den == 0, torch.sign(num) * max_step,
                       torch.clamp(num / den, -max_step, max_step))
    new = theta - step
    lo = torch.tensor([-math.inf, -math.inf, 1.0, 0.01, 0.01, 0.01],
                      dtype=theta.dtype, device=theta.device)
    return torch.maximum(new, lo)


def crlb_and_ll(theta, spots):
    S = spots.shape[-1]
    model, d1, _ = model_terms(theta, S)
    fisher = torch.einsum("pnij,qnij->npq", d1 / model[None], d1)
    diag = torch.diagonal(fisher, dim1=1, dim2=2)
    scale = torch.where(diag > 0, 1.0 / torch.sqrt(diag), 1.0)
    eq = fisher * scale[:, :, None] * scale[:, None, :]
    work = torch.float64 if theta.dtype == torch.float64 else torch.float32
    inv, info = torch.linalg.inv_ex(eq.to(work))
    inv = torch.where((info == 0)[:, None, None], inv, math.nan)
    inv = inv.to(theta.dtype)
    crlb = torch.diagonal(inv, dim1=1, dim2=2) * scale * scale
    pos = spots * torch.log(model) - model - spots * torch.log(spots) + spots
    ll = torch.where(spots > 0, pos, -model)
    ll = torch.where(model > 0, ll, torch.zeros_like(ll)).sum((1, 2))
    return crlb, ll


def fit(spots: torch.Tensor, eps: float, max_it: int):
    """(theta (N, 6), crlb (N, 6), ll (N,), iterations (N,)) of (N, S, S)
    photon spots, in their dtype, in blocks of :data:`BLOCK`."""
    outs = [fit_block(spots[i:i + BLOCK], eps, max_it)
            for i in range(0, max(len(spots), 1), BLOCK)]
    return tuple(torch.cat(o) for o in zip(*outs))


def fit_block(spots, eps: float, max_it: int):
    theta, max_step = initial(spots)
    old = theta.clone()
    done = torch.zeros(len(spots), dtype=torch.bool, device=spots.device)
    iters = torch.zeros(len(spots), dtype=torch.int64, device=spots.device)
    conv_rows = [0, 1, 4, 5]
    for _ in range(max_it):
        if bool(done.all()):
            break
        new = newton_step(theta, spots, max_step)
        theta = torch.where(done[:, None], theta, new)
        iters = iters + (~done).to(torch.int64)
        moved = (old[:, conv_rows] - theta[:, conv_rows]).abs() < eps
        done = done | moved.all(1)
        old = torch.where(done[:, None], old, theta)
    crlb, ll = crlb_and_ll(theta, spots)
    return theta, crlb, ll, iters
