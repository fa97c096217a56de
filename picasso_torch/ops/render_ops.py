"""Rendering primitives of the port on the device: the histogram
scatter-add and the per-loc Gaussian splat, in plain PyTorch.

Counterpart of picasso_tpu/ops/render_ops.py (hist2d :40, gaussian_splat
:289), with the window rules of its _splat_bucket_host :138 and
_splat_bucket_device :97, which are the reference's _draw_gaussian_loc
(picasso/render.py:495): rows [int(y - 3 sy), int(y + 3 sy + 1)) and
columns [int(x - 3 sx), int(x + 3 sx) + 1), clamped to the image, pixel
centres at +0.5, weight gy * gx with the norm 1 / (2 pi sx sy). The JAX
package wrote no Pallas kernel here; these are ``index_add_`` calls on
the tensors' device, one per window-size bucket and batch. Inputs are
f32 tensors of display coordinates; outputs (ny, nx) f32 tensors on the
same device.
"""

from __future__ import annotations

import math

import torch

# Max sigma (display px) from the mean to render (picasso/render.py:32)
DRAW_MAX_SIGMA = 3.0
# window sizes (px) of the splat; locs wider than the last are cut to it
_BUCKETS = (8, 16, 32, 64, 128)
# window pixels per index_add_ batch (bounds the temporaries)
_BATCH_PIXELS = 1 << 24


def hist2d(x: torch.Tensor, y: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Counts of the locs per pixel of a (ny, nx) image; coordinates are
    truncated toward zero (numpy's astype(int32)) and those outside the
    image dropped."""
    xi = x.to(torch.int64)
    yi = y.to(torch.int64)
    ok = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
    flat = torch.where(ok, yi * nx + xi, ny * nx)  # the last slot drops
    img = torch.zeros(ny * nx + 1, dtype=torch.float32, device=x.device)
    img.index_add_(0, flat, torch.ones_like(x, dtype=torch.float32))
    return img[:-1].view(ny, nx)


def _splat_bucket(img, x, y, sx, sy, W: int, ny: int, nx: int) -> None:
    """Add the Gaussians of locs whose windows fit (W, W) to the flat
    image ``img`` (ny * nx + 1 slots, the last one dropped)."""
    off_y = torch.clamp(DRAW_MAX_SIGMA * sy, max=(W - 2) / 2.0)
    off_x = torch.clamp(DRAW_MAX_SIGMA * sx, max=(W - 2) / 2.0)
    i_min = (y - off_y).to(torch.int64).clamp(min=0)
    i_max = (y + off_y + 1).to(torch.int64).clamp(max=ny)
    j_min = (x - off_x).to(torch.int64).clamp(min=0)
    j_max = ((x + off_x).to(torch.int64) + 1).clamp(max=nx)
    k = torch.arange(W, device=x.device)
    rows = i_min[:, None] + k[None, :]  # (n, W)
    cols = j_min[:, None] + k[None, :]
    dy = rows.to(torch.float32) + 0.5 - y[:, None]
    dx = cols.to(torch.float32) + 0.5 - x[:, None]
    norm = 1.0 / (2.0 * math.pi * sx * sy)
    row_ok = rows < i_max[:, None]
    col_ok = cols < j_max[:, None]
    gy = torch.where(row_ok, norm[:, None] * torch.exp(
        -dy * dy / (2.0 * sy[:, None] ** 2)), 0.0)
    gx = torch.where(col_ok, torch.exp(-dx * dx / (2.0 * sx[:, None] ** 2)),
                     0.0)
    ok = row_ok[:, :, None] & col_ok[:, None, :]
    flat = torch.where(ok, rows[:, :, None] * nx + cols[:, None, :], ny * nx)
    img.index_add_(0, flat.reshape(-1),
                   (gy[:, :, None] * gx[:, None, :]).reshape(-1))


def gaussian_splat(x: torch.Tensor, y: torch.Tensor, sx: torch.Tensor,
                   sy: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Each loc as a separable 2D Gaussian with its own sigmas. Locs are
    bucketed by their largest sigma into the window sizes of
    :data:`_BUCKETS` (a window covers 2 * 3 sigma + 2 pixels)."""
    img = torch.zeros(ny * nx + 1, dtype=torch.float32, device=x.device)
    need = 2 * DRAW_MAX_SIGMA * torch.maximum(sx, sy) + 2
    assigned = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for W in _BUCKETS:
        sel = ~assigned if W == _BUCKETS[-1] else ~assigned & (need <= W)
        assigned |= sel
        idx = torch.nonzero(sel).squeeze(1)
        step = max(1, _BATCH_PIXELS // (W * W))
        for s in range(0, len(idx), step):
            i = idx[s:s + step]
            _splat_bucket(img, x[i], y[i], sx[i], sy[i], W, ny, nx)
    return img[:-1].view(ny, nx)
