"""RCC drift correction (Wang, Schnitzbauer et al., Opt. Express 22,
15982 (2014)) as Picasso's ``undrift`` runs it:

- segments: bounds linspace(0, frames - 1, n + 1) truncated to integers,
  n = round(frames / segmentation); segment i holds bounds[i] <= frame <
  bounds[i + 1];
- each segment rendered at one pixel a camera pixel, each loc inside the
  field a normalised Gaussian of widths max(lpx, 1), max(lpy, 1) drawn
  over rows [int(y - 3 sy), int(y + 3 sy + 1)) and columns
  [int(x - 3 sx), int(x + 3 sx) + 1) at pixel centres;
- every pair's cross-correlation by FFT, its central 32 x 32 searched for
  the maximum and a Gaussian with offset fitted by least squares to the
  5 x 5 around it; the pair's shift is minus the fitted centre;
- per-segment shifts by least squares over all pairs, then an
  interpolating cubic spline (order min(3, n - 1)) through the segment
  centres gives each frame's drift; the locs lose the drift of their
  frame.

The render is taken in the given dtype; correlations and fits in
float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.interpolate import make_interp_spline

MAX_SHIFT = 32
PEAK_BOX = 5
#: locs a block of the render
BLOCK = 1 << 20


def segment_bounds(n_frames: int, segmentation: int) -> np.ndarray:
    n = int(np.round(n_frames / segmentation))
    return np.linspace(0, n_frames - 1, n + 1).astype(np.uint32)


def render(x, y, lpx, lpy, height: int, width: int, dtype,
           device) -> torch.Tensor:
    """The Gaussian render of one segment's locs (f64 tensors)."""
    img = torch.zeros(height * width + 1, dtype=torch.float64, device=device)
    inside = (x > 0) & (y > 0) & (x < width) & (y < height)
    x, y, lpx, lpy = (t[inside] for t in (x, y, lpx, lpy))
    for lo in range(0, len(x), BLOCK):
        xs, ys = x[lo:lo + BLOCK], y[lo:lo + BLOCK]
        sx = torch.clamp(lpx[lo:lo + BLOCK], min=1.0)
        sy = torch.clamp(lpy[lo:lo + BLOCK], min=1.0)
        r0 = torch.floor(ys - 3 * sy).clamp(min=0).long()
        r1 = torch.floor(ys + 3 * sy + 1).clamp(max=height).long()
        c0 = torch.floor(xs - 3 * sx).clamp(min=0).long()
        c1 = (torch.floor(xs + 3 * sx) + 1).clamp(max=width).long()
        W = int(max((r1 - r0).max(), (c1 - c0).max(), 1))
        k = torch.arange(W, device=device)
        rows = r0[:, None] + k[None, :]
        cols = c0[:, None] + k[None, :]
        gy = torch.exp(-0.5 * ((rows + 0.5 - ys[:, None]) / sy[:, None]) ** 2)
        gx = torch.exp(-0.5 * ((cols + 0.5 - xs[:, None]) / sx[:, None]) ** 2)
        gy = torch.where(rows < r1[:, None], gy, 0.0)
        gx = torch.where(cols < c1[:, None], gx, 0.0)
        w = gy[:, :, None] * gx[:, None, :] / (
            2 * math.pi * sx * sy)[:, None, None]
        ok = (rows < r1[:, None])[:, :, None] & (cols < c1[:, None])[:, None, :]
        flat = torch.where(ok, rows[:, :, None] * width + cols[:, None, :],
                           height * width)
        img.index_add_(0, flat.reshape(-1), w.reshape(-1))
    return img[:-1].view(height, width).to(dtype).to(torch.float64)


def gauss_peak(z: np.ndarray, iters: int = 200):
    """Least-squares fit of a exp(-((x - xc)^2 + (y - yc)^2) / (2 s^2)) + b
    to (P, 5, 5) patches (x along columns, both from -2 to 2), by
    Levenberg-Marquardt from (max, 0, 0, 1, min). Returns (xc, yc)."""
    g = np.arange(PEAK_BOX) - PEAK_BOX // 2
    yy, xx = np.meshgrid(g, g, indexing="ij")
    xx, yy = xx.ravel().astype(float), yy.ravel().astype(float)
    z = z.reshape(len(z), -1)
    p = np.stack([z.max(1), np.zeros(len(z)), np.zeros(len(z)),
                  np.ones(len(z)), z.min(1)], 1)
    lam = np.full(len(z), 1e-3)

    def residual(p):
        a, xc, yc, s, b = (p[:, i:i + 1] for i in range(5))
        e = np.exp(-0.5 * ((xx - xc) ** 2 + (yy - yc) ** 2) / s ** 2)
        return a * e + b - z, e

    r, e = residual(p)
    cost = (r * r).sum(1)
    for _ in range(iters):
        a, xc, yc, s = (p[:, i:i + 1] for i in range(4))
        dx, dy = xx - xc, yy - yc
        J = np.stack([e, a * e * dx / s ** 2, a * e * dy / s ** 2,
                      a * e * (dx ** 2 + dy ** 2) / s ** 3,
                      np.ones_like(e)], 2)
        JtJ = np.einsum("pki,pkj->pij", J, J)
        g_ = np.einsum("pki,pk->pi", J, r)
        A = JtJ + lam[:, None, None] * np.eye(5) * np.diagonal(
            JtJ, axis1=1, axis2=2)[:, :, None]
        step = np.linalg.solve(A, -g_[:, :, None])[:, :, 0]
        trial = p + step
        r_t, e_t = residual(trial)
        cost_t = (r_t * r_t).sum(1)
        better = cost_t < cost
        p = np.where(better[:, None], trial, p)
        r = np.where(better[:, None], r_t, r)
        e = np.where(better[:, None], e_t, e)
        small = np.abs(cost - cost_t) <= 1e-15 * np.maximum(cost, 1e-300)
        cost = np.where(better, cost_t, cost)
        lam = np.where(better, lam / 10, lam * 10)
        if np.all(small | (np.abs(step).max(1) < 1e-13)):
            break
    return p[:, 1], p[:, 2]


def pair_shifts(segments: torch.Tensor):
    """(shift_y, shift_x) (n, n) of every pair i < j of (n, Y, X) float64
    segments."""
    n, Y, X = segments.shape
    F = torch.fft.fft2(segments)
    ii, jj = np.triu_indices(n, 1)
    xc = torch.fft.ifft2(F[ii] * torch.conj(F[jj])).real / math.sqrt(Y * X)
    xc = torch.fft.fftshift(xc, dim=(1, 2))
    y0, x0 = max((Y - MAX_SHIFT) // 2, 0), max((X - MAX_SHIFT) // 2, 0)
    crop = xc[:, y0:Y - y0, x0:X - x0].cpu().numpy()
    empty = (segments.sum((1, 2)) == 0).cpu().numpy()
    h = PEAK_BOX // 2
    k = len(ii)
    arg = crop.reshape(k, -1).argmax(1)
    ym, xm = np.unravel_index(arg, crop.shape[1:])
    fits = (ym >= h) & (xm >= h) & (ym < crop.shape[1] - h) & (
        xm < crop.shape[2] - h) & ~empty[ii] & ~empty[jj]
    sy, sx = np.zeros(k), np.zeros(k)
    if fits.any():
        idx = np.nonzero(fits)[0]
        patches = np.stack([crop[p, ym[p] - h:ym[p] + h + 1,
                                 xm[p] - h:xm[p] + h + 1] for p in idx])
        fx, fy = gauss_peak(patches)
        sx[idx] = -(fx + x0 + xm[idx] - np.floor(X / 2))
        sy[idx] = -(fy + y0 + ym[idx] - np.floor(Y / 2))
    shift_y, shift_x = np.zeros((n, n)), np.zeros((n, n))
    shift_y[ii, jj], shift_x[ii, jj] = sy, sx
    return shift_y, shift_x


def per_segment(shift: np.ndarray) -> np.ndarray:
    """Per-segment shifts from all pair shifts (n, n) by least squares:
    shift[i, j] = sum of the intervals i .. j - 1, the first segment at
    0."""
    n = len(shift)
    ii, jj = np.triu_indices(n, 1)
    A = np.zeros((len(ii), n - 1))
    for k, (i, j) in enumerate(zip(ii, jj)):
        A[k, i:j] = 1.0
    d, *_ = np.linalg.lstsq(A, shift[ii, jj], rcond=None)
    return np.concatenate([[0.0], np.cumsum(d)])


def undrift(locs: np.ndarray, info: list[dict], segmentation: int,
            dtype=torch.float64, device="cpu"):
    """(drift (frames, 2) as x, y, undrifted x, undrifted y) of locs,
    rendered in ``dtype``."""
    n_frames, Y, X = (info[0][k] for k in ("Frames", "Height", "Width"))
    bounds = segment_bounds(n_frames, segmentation)
    n = len(bounds) - 1
    f64 = dict(dtype=torch.float64, device=device)
    frame = torch.as_tensor(locs["frame"].astype(np.int64), device=device)
    cols = {c: torch.as_tensor(locs[c].astype(np.float64), **f64)
            for c in ("x", "y", "lpx", "lpy")}
    segments = torch.stack([
        render(*(cols[c][sel] for c in ("x", "y", "lpx", "lpy")), Y, X,
               dtype, device)
        for sel in ((frame >= int(bounds[i])) & (frame < int(bounds[i + 1]))
                    for i in range(n))])
    shift_y, shift_x = pair_shifts(segments)
    t = (bounds[1:].astype(np.float64) + bounds[:-1]) / 2
    k = min(3, n - 1)
    frames = np.arange(n_frames)
    drift = np.stack([make_interp_spline(t, per_segment(s), k=k)(frames)
                      for s in (shift_x, shift_y)], 1)
    f = locs["frame"].astype(np.int64)
    return (drift, locs["x"].astype(np.float64) - drift[f, 0],
            locs["y"].astype(np.float64) - drift[f, 1])
