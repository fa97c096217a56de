"""Rendering primitives of the port on the device: the 2D and 3D
histogram scatter-adds, the per-loc Gaussian splats (separable, and of a
general 2x2 covariance for rotated views) and the separable Gaussian
filter of the ``smooth`` and ``convolve`` blurs, in plain PyTorch.

Counterpart of picasso_tpu/ops/render_ops.py (hist2d :40, hist3d :73,
gaussian_splat_cov :227 with its host loop _splat_cov_host :202 and its
bucketed _splat_cov_bucket_device :157, gaussian_splat :289 with its
host loop _splat_bucket_host :138, its tile splat _splat_tiles_kernel
:437 and its bucketed _splat_bucket_device :97) and
of the filter that picasso_tpu/render.py:269 (_fftconvolve) takes from
scipy.ndimage. Every window follows the reference's _draw_gaussian_loc
(picasso/render.py:495): rows [int(y - 3 sy), int(y + 3 sy + 1)) and
columns [int(x - 3 sx), int(x + 3 sx) + 1), clamped to the image, pixel
centres at +0.5, weight gy * gx with the norm 1 / (2 pi sx sy).

JAX takes one of two routes by the number of locs in view, and so does
the port, on its device, so that each pixel gets the same roundings:
- below :data:`DEVICE_MIN_LOCS`, JAX's host route: coordinates keep the
  dtype the locs carry (f64 after a drift correction) when they are
  truncated to a pixel and when they bound a window; a window's weights
  are formed in f64 (f32 sigmas and norm) and its whole extent drawn;
- from :data:`DEVICE_MIN_LOCS` on, JAX's device route: coordinates are
  cast to f32 first and everything is f32, the window bounds rounded
  once as XLA's fused multiply-adds round them; a window wider than
  :data:`TILE` pixels is cut to ±(TILE - 2) / 2 pixels, as JAX's
  fallback bucket cuts it.
The JAX package wrote no Pallas kernel here; the splats are
``index_add_`` calls, one per window-size bucket and batch. Outputs are
(ny, nx) f32 tensors on the inputs' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# Max sigma (display px) from the mean to render (picasso/render.py:32)
DRAW_MAX_SIGMA = 3.0
# locs in view from which JAX renders on its device in f32
# (picasso_tpu/ops/render_ops.py:27)
DEVICE_MIN_LOCS = 50_000
# JAX's splat tile (render_ops.py:430): wider windows are cut
TILE = 128
# window pixels per index_add_ batch (bounds the temporaries)
_BATCH_PIXELS = 1 << 24
# the Gaussian filter's reach in sigmas (picasso_tpu/render.py:269)
FILTER_TRUNCATE = 5.0


def hist2d(x: torch.Tensor, y: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Counts of the locs per pixel of a (ny, nx) image; coordinates are
    truncated toward zero (numpy's astype(int32)), in their own dtype
    below :data:`DEVICE_MIN_LOCS` locs and from f32 above, and those
    outside the image dropped."""
    if len(x) >= DEVICE_MIN_LOCS:
        x, y = x.to(torch.float32), y.to(torch.float32)
    xi = x.to(torch.int64)
    yi = y.to(torch.int64)
    ok = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
    flat = torch.where(ok, yi * nx + xi, ny * nx)  # the last slot drops
    img = torch.zeros(ny * nx + 1, dtype=torch.float32, device=x.device)
    img.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                       device=x.device))
    return img[:-1].view(ny, nx)


def hist3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, ny: int,
           nx: int, nz: int) -> torch.Tensor:
    """Counts of the locs per voxel of a (ny, nx, nz) volume, truncated
    as :func:`hist2d` truncates (f32 from :data:`DEVICE_MIN_LOCS` locs
    on). z keeps the reference's quirk that JAX reproduces: its bins are
    shifted up by their own minimum (picasso/render.py:490)."""
    if len(x) >= DEVICE_MIN_LOCS:
        x, y, z = (t.to(torch.float32) for t in (x, y, z))
    xi, yi, zi = (t.to(torch.int64) for t in (x, y, z))
    if len(zi):
        zi = zi + zi.min()
    ok = ((xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny) & (zi >= 0)
          & (zi < nz))
    size = ny * nx * nz
    flat = torch.where(ok, (yi * nx + xi) * nz + zi, size)
    img = torch.zeros(size + 1, dtype=torch.float32, device=x.device)
    img.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                       device=x.device))
    return img[:-1].view(ny, nx, nz)


def _windows(x, y, ox, oy, ny: int, nx: int):
    """The reference's window of each loc for the offsets (ox, oy):
    (i_min, i_max, j_min, j_max), int64, clamped to the image."""
    return _clamped(y - oy, y + oy + 1, x - ox, x + ox, ny, nx)


def _fused_windows(x, y, sx, sy, ny: int, nx: int):
    """:func:`_windows` at offsets 3 sigma as JAX's device route forms
    them on the CPU: XLA fuses y -+ 3 sy and x -+ 3 sx into FMAs, one
    rounding each, which f64 forms exactly (then + 1 in f32)."""
    y64, x64 = y.to(torch.float64), x.to(torch.float64)
    oy = DRAW_MAX_SIGMA * sy.to(torch.float64)
    ox = DRAW_MAX_SIGMA * sx.to(torch.float64)
    f32 = torch.float32
    return _clamped((y64 - oy).to(f32), (y64 + oy).to(f32) + 1,
                    (x64 - ox).to(f32), (x64 + ox).to(f32), ny, nx)


def _clamped(y_lo, y_hi, x_lo, x_hi, ny: int, nx: int):
    """Rows [int(y_lo), int(y_hi)) and columns [int(x_lo), int(x_hi) +
    1), truncated toward zero and clamped to the image."""
    return (y_lo.to(torch.int64).clamp(min=0),
            y_hi.to(torch.int64).clamp(max=ny),
            x_lo.to(torch.int64).clamp(min=0),
            (x_hi.to(torch.int64) + 1).clamp(max=nx))


def _splat_bucket(img, x, y, sx, sy, win, W: int, nx: int, f32) -> None:
    """Add the Gaussians of locs whose windows ``win`` fit (W, W) to the
    flat image ``img`` (ny * nx + 1 slots, the last one dropped), their
    weights formed in f32 if ``f32`` (JAX's device route), else in f64
    from the coordinates (JAX's host route)."""
    i_min, i_max, j_min, j_max = win
    k = torch.arange(W, device=x.device)
    rows = i_min[:, None] + k[None, :]  # (n, W)
    cols = j_min[:, None] + k[None, :]
    ft = torch.float32 if f32 else torch.float64
    dy = (rows.to(ft) + 0.5) - y.to(ft)[:, None]
    dx = (cols.to(ft) + 0.5) - x.to(ft)[:, None]
    norm = 1.0 / (2.0 * math.pi * sx * sy)
    row_ok = rows < i_max[:, None]
    col_ok = cols < j_max[:, None]
    gy = norm.to(ft)[:, None] * torch.exp(
        -(dy * dy) / (2 * (sy * sy)).to(ft)[:, None])
    gx = torch.exp(-(dx * dx) / (2 * (sx * sx)).to(ft)[:, None])
    gy = torch.where(row_ok, gy, 0.0)
    gx = torch.where(col_ok, gx, 0.0)
    ok = row_ok[:, :, None] & col_ok[:, None, :]
    flat = torch.where(ok, rows[:, :, None] * nx + cols[:, None, :],
                       img.numel() - 1)
    img.index_add_(0, flat.reshape(-1),
                   (gy[:, :, None] * gx[:, None, :]).reshape(-1)
                   .to(img.dtype))


def gaussian_splat(x: torch.Tensor, y: torch.Tensor, sx: torch.Tensor,
                   sy: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Each loc as a separable 2D Gaussian with its own f32 sigmas, on
    the route of the module docstring. Locs are bucketed by their
    window's extent into power-of-two window sizes from 8 pixels."""
    n = len(x)
    device_route = n >= DEVICE_MIN_LOCS
    if device_route:
        x, y = x.to(torch.float32), y.to(torch.float32)
    ox, oy = DRAW_MAX_SIGMA * sx, DRAW_MAX_SIGMA * sy
    win = (_fused_windows(x, y, sx, sy, ny, nx) if device_route
           else _windows(x, y, ox, oy, ny, nx))
    extent = torch.maximum(win[1] - win[0], win[3] - win[2])
    if device_route:
        # a window wider than a tile is cut as JAX's fallback bucket
        # (W = TILE) cuts it, unfused
        cut = extent > TILE
        if bool(cut.any()):
            cap = (TILE - 2) / 2.0
            cwin = _windows(x, y, ox.clamp(max=cap), oy.clamp(max=cap),
                            ny, nx)
            win = tuple(torch.where(cut, c, w) for c, w in zip(cwin, win))
            extent = torch.where(cut, TILE, extent)
    # JAX's host route adds each loc's f64 window to the f32 image; the
    # port sums the f64 weights and rounds once
    img = torch.zeros(ny * nx + 1, device=x.device,
                      dtype=torch.float32 if device_route else torch.float64)
    W, lo = 8, 0
    top = int(extent.max()) if n else 0
    while lo < top:
        sel = torch.nonzero((extent > lo) & (extent <= W)).squeeze(1)
        step = max(1, _BATCH_PIXELS // (W * W))
        for s in range(0, len(sel), step):
            i = sel[s:s + step]
            _splat_bucket(img, x[i], y[i], sx[i], sy[i],
                          tuple(w[i] for w in win), W, nx, device_route)
        lo, W = W, 2 * W
    return img[:-1].view(ny, nx).to(torch.float32)


def _splat_cov_bucket(img, x, y, inv, norm, win, W: int, nx: int) -> None:
    """Add the Gaussians of inverse covariances ``inv`` (inv00, inv01,
    inv11) of locs whose windows ``win`` fit (W, W) to the flat image
    ``img`` (ny * nx + 1 slots, the last one dropped), in the dtype of
    ``x``, the quadratic form in the order of JAX's device route."""
    i_min, i_max, j_min, j_max = win
    inv00, inv01, inv11 = (v[:, None, None] for v in inv)
    k = torch.arange(W, device=x.device)
    rows = i_min[:, None] + k[None, :]  # (n, W)
    cols = j_min[:, None] + k[None, :]
    dy = (rows.to(x.dtype) + 0.5) - y[:, None]
    dx = (cols.to(x.dtype) + 0.5) - x[:, None]
    q = (inv00 * (dx * dx)[:, None, :]
         + 2.0 * inv01 * dy[:, :, None] * dx[:, None, :]
         + inv11 * (dy * dy)[:, :, None])
    ok = (rows < i_max[:, None])[:, :, None] & (cols < j_max[:, None])[:,
                                                                      None]
    vals = torch.where(ok, norm[:, None, None] * torch.exp(-0.5 * q), 0.0)
    flat = torch.where(ok, rows[:, :, None] * nx + cols[:, None, :],
                       img.numel() - 1)
    img.index_add_(0, flat.reshape(-1), vals.reshape(-1).to(img.dtype))


def gaussian_splat_cov(x: torch.Tensor, y: torch.Tensor, covs: torch.Tensor,
                       ny: int, nx: int) -> torch.Tensor:
    """Each loc as a 2D Gaussian of its own (2, 2) covariance ``covs``
    (n, 2, 2): the splat of rotated views, whose 3D covariances are
    rotated and projected to 2D (picasso/render.py:579-680). The inverse,
    the norm 1 / (2 pi sqrt(det)) and the window offsets 3 sqrt(c00), 3
    sqrt(c11) are formed in f64, as JAX forms them; a covariance whose
    determinant is not above 0 renders nothing. Below
    :data:`DEVICE_MIN_LOCS` locs JAX's host route: f64 coordinates, rows
    [int(y - ey), int(y + ey + 1)) and columns [int(x - ex), int(x + ex)
    + 1) clamped to the image, each window whole, the weights summed in
    f64 and rounded once (JAX rounds after each loc). From it JAX's
    device route, all in f32: the locs in buckets of W = 8, 16, ..., TILE
    pixels by 2 max(ex, ey) + 2, the offsets clamped to (W - 2) / 2, the
    last bucket taking the rest; each bucket in batches of about
    ``_BATCH_PIXELS`` window pixels."""
    f64 = torch.float64
    c00, c01, c11 = (covs[:, i, j].to(f64) for i, j in ((0, 0), (0, 1),
                                                         (1, 1)))
    det = c00 * c11 - c01 * c01
    ok = det > 0
    d = torch.where(ok, det, 1.0)
    inv = (torch.where(ok, c11 / d, 0.0), torch.where(ok, -c01 / d, 0.0),
           torch.where(ok, c00 / d, 0.0))
    norm = torch.where(ok, 1.0 / (2 * math.pi * torch.sqrt(
        det.clamp(min=1e-30))), 0.0)
    ex = DRAW_MAX_SIGMA * torch.sqrt(c00.clamp(min=0))
    ey = DRAW_MAX_SIGMA * torch.sqrt(c11.clamp(min=0))
    device_route = len(x) >= DEVICE_MIN_LOCS
    ft = torch.float32 if device_route else f64
    x, y, norm, ox, oy = (t.to(ft) for t in (x, y, norm, ex, ey))
    inv = tuple(v.to(ft) for v in inv)
    img = torch.zeros(ny * nx + 1, dtype=ft, device=x.device)

    def splat(sel, W, win):
        """The locs ``sel`` in batches; ``win`` holds their windows."""
        step = max(1, _BATCH_PIXELS // (W * W))
        for s in range(0, len(sel), step):
            i = sel[s:s + step]
            _splat_cov_bucket(img, x[i], y[i], tuple(v[i] for v in inv),
                              norm[i], tuple(w[s:s + step] for w in win), W,
                              nx)

    if device_route:
        need = 2 * torch.maximum(ex, ey) + 2
        left = ok
        for W in (8, 16, 32, 64, TILE):
            take = left & (need <= W) if W < TILE else left
            left = left & ~take
            sel = torch.nonzero(take).squeeze(1)
            cap = (W - 2) / 2.0
            xs, ys = x[sel], y[sel]
            oxs, oys = ox[sel].clamp(max=cap), oy[sel].clamp(max=cap)
            splat(sel, W, _clamped(ys - oys, ys + oys + 1, xs - oxs,
                                   xs + oxs, ny, nx))
    else:
        win = _clamped(y - oy, y + oy + 1, x - ox, x + ox, ny, nx)
        extent = torch.where(ok, torch.maximum(win[1] - win[0],
                                               win[3] - win[2]), 0)
        W, lo = 8, 0
        top = int(extent.max()) if len(x) else 0
        while lo < top:
            sel = torch.nonzero((extent > lo) & (extent <= W)).squeeze(1)
            splat(sel, W, tuple(w[sel] for w in win))
            lo, W = W, 2 * W
    return img[:-1].view(ny, nx).to(torch.float32)


def gaussian_weights(sigma, truncate: float = FILTER_TRUNCATE) -> np.ndarray:
    """The normalised f64 kernel of scipy.ndimage.gaussian_filter1d
    (scipy/ndimage/_filters.py, _gaussian_kernel1d at order 0): radius
    int(truncate * sigma + 0.5), exp(-0.5 / sigma**2 * x**2) with sigma
    in its own type (an f32 median stays f32), divided by its sum."""
    radius = int(truncate * float(sigma) + 0.5)
    sigma2 = sigma * sigma
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / sigma2 * x ** 2)
    return phi / phi.sum()


def _filter_axis(image: torch.Tensor, weights: np.ndarray, axis: int):
    """One pass of scipy's correlate1d with a symmetric kernel, zero
    padding: out = w0 x[i] + sum over k = r..1 of (x[i - k] + x[i + k])
    w_k in f64, term by term in scipy's order (ni_filters.c), rounded to
    f32 at the end as scipy stores its f32 output."""
    r = len(weights) // 2
    n = image.shape[axis]
    pad = (0, 0, r, r) if axis == 0 else (r, r)
    xp = F.pad(image.to(torch.float64), pad)

    def at(k):
        return xp.narrow(axis, r + k, n)

    out = at(0) * float(weights[r])
    for k in range(r, 0, -1):
        out = out + (at(-k) + at(k)) * float(weights[r - k])
    return out.to(torch.float32)


def gaussian_filter(image: torch.Tensor, sigma_y, sigma_x) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter(image, sigma=(sigma_y, sigma_x),
    output=f32, mode="constant", cval=0, truncate=5) on the image's
    device: axis 0 first, the f32 result of the first pass read by the
    second; an axis whose sigma is not above 1e-15 is skipped, as in
    scipy."""
    out = image.to(torch.float32)
    for axis, sigma in ((0, sigma_y), (1, sigma_x)):
        if sigma > 1e-15:
            out = _filter_axis(out, gaussian_weights(sigma), axis)
    return out
