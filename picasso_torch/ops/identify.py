"""Spot identification: local maxima + net gradient + threshold, reduced
onto (T, T) tiles and compacted into a hit list.

Counterpart of picasso_tpu/ops/identify.py (identify_maps :50, the tile
stage of _identify_compact :569-616, identify_frames :625). Semantics
matched to the reference (picasso/localize.py:98/:203):
- a pixel is a local maximum iff it is the FIRST argmax (row-major) of
  its (box, box) window: strictly greater than every earlier pixel and
  >= every later one;
- only pixels with h <= y < Y-h-1 and h <= x < X-h-1 are eligible
  (note the extra -1 on the high side);
- the net gradient sums the central-difference gradient over the window
  dotted with unit vectors pointing at the centre; row/col -1 wraps to
  Y-1/X-1 (numba negative indexing).
Hits are at least h+1 apart, so each aligned (T, T) tile, T = h+1, holds
at most one. The net gradient is one form only: direct shifted sums.

Identify takes boxes >= :data:`MIN_BOX` (3), as the JAX package's does:
below it picasso_tpu's maps come out of shape (its box-1 maxima (B, 0,
0), its box-2 net gradient (B, Y + 1, X + 1)) and its identify raises a
TypeError. Here :func:`identify_tiles_plain` and the CUDA kernels raise
a ValueError there, and :func:`identify_maps`, whose maxima alone JAX's
local_maxima reads, raises at box 1 as JAX's maps do and gives box 2's
maxima (equal to JAX's).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: the least box identify takes on either device (ops/identify_cuda.py)
MIN_BOX = 3


def check_box(box: int) -> None:
    """Raise for a box below :data:`MIN_BOX`, where the JAX package's
    identify fails too."""
    if box < MIN_BOX:
        raise ValueError(f"identify takes boxes >= {MIN_BOX}, got {box}")


def _unit_vector_masks(box: int) -> tuple[np.ndarray, np.ndarray]:
    """(uy, ux) of shape (box, box), f32: unit vectors from each window
    position toward the centre; the centre itself is 0."""
    half = box // 2
    val = half - np.arange(box, dtype=np.float32)
    ux = np.tile(val, (box, 1))
    uy = ux.T.copy()
    norm = np.sqrt(ux**2 + uy**2)
    with np.errstate(invalid="ignore", divide="ignore"):
        ux = ux / norm
        uy = uy / norm
    ux[half, half] = 0.0
    uy[half, half] = 0.0
    return uy, ux


def as_float32(frames: torch.Tensor) -> torch.Tensor:
    """Frames as f32 (exact for u16). torch.uint16 has few kernels, so
    it is read through an int16 view."""
    if frames.dtype == torch.uint16:
        return (frames.view(torch.int16).to(torch.int32) & 0xFFFF).to(
            torch.float32
        )
    return frames.to(torch.float32)


def identify_maps(frames: torch.Tensor, box: int):
    """(maxima, ng) maps of a (B, Y, X) batch: maxima (B, Y, X) bool
    (eligibility applied), ng (B, Y, X) f32 at every pixel. Raises below
    box 2, where JAX's maps do (a box-1 window has no neighbours)."""
    if box < 2:
        raise ValueError(f"the identify maps take boxes >= 2, got {box}")
    f = as_float32(frames)
    B, Y, X = f.shape
    h = box // 2
    padded = F.pad(f, (h, h, h, h), value=float("-inf"))
    is_max = torch.ones((B, Y, X), dtype=torch.bool, device=f.device)
    for dy in range(-h, h + 1):
        for dx in range(-h, h + 1):
            if dy == 0 and dx == 0:
                continue
            w = padded[:, h + dy:h + dy + Y, h + dx:h + dx + X]
            earlier = dy < 0 or (dy == 0 and dx < 0)
            is_max &= (f > w) if earlier else (f >= w)
    yy = torch.arange(Y, device=f.device)[:, None]
    xx = torch.arange(X, device=f.device)[None, :]
    eligible = (yy >= h) & (yy < Y - h - 1) & (xx >= h) & (xx < X - h - 1)
    maxima = is_max & eligible

    gy = torch.roll(f, -1, dims=1) - torch.roll(f, 1, dims=1)
    gx = torch.roll(f, -1, dims=2) - torch.roll(f, 1, dims=2)
    gyp = F.pad(gy, (h, h, h, h))
    gxp = F.pad(gx, (h, h, h, h))
    uy, ux = _unit_vector_masks(box)
    ng = torch.zeros((B, Y, X), dtype=torch.float32, device=f.device)
    for i in range(box):
        for j in range(box):
            if i == h and j == h:
                continue
            ng = ng + gyp[:, i:i + Y, j:j + X] * float(uy[i, j])
            ng = ng + gxp[:, i:i + Y, j:j + X] * float(ux[i, j])
    return maxima, ng


def tile_reduce(mask: torch.Tensor, ng: torch.Tensor, box: int):
    """Reduce (B, Y, X) hit mask and net gradient onto (T, T) tiles:
    (tile_mask bool, tile_loc i32 = ly*T + lx, tile_ng f32), each
    (B, ceil(Y/T), ceil(X/T))."""
    T = box // 2 + 1
    B, Y, X = mask.shape
    Ty, Tx = -(-Y // T), -(-X // T)
    pad = (0, Tx * T - X, 0, Ty * T - Y)
    m = F.pad(mask, pad).reshape(B, Ty, T, Tx, T)
    g = F.pad(ng, pad).reshape(B, Ty, T, Tx, T)
    loc = (
        torch.arange(T, device=mask.device)[:, None] * T
        + torch.arange(T, device=mask.device)[None, :]
    )
    tile_mask = m.any(dim=4).any(dim=2)
    tile_loc = (m * loc[None, None, :, None, :]).sum(dim=(2, 4))
    # a select, not m * g: a NaN net gradient beside a hit (from a NaN
    # pixel near it) must not reach the hit's tile (XLA rewrites JAX's
    # mask product into this select)
    tile_ng = torch.where(m, g, 0.0).sum(dim=(2, 4))
    return tile_mask, tile_loc.to(torch.int32), tile_ng


def identify_tiles_plain(frames: torch.Tensor, minimum_ng, box: int):
    """Plain version of the identify kernel (csrc/identify.cu); raises
    below :data:`MIN_BOX`."""
    check_box(box)
    maxima, ng = identify_maps(frames, box)
    return tile_reduce(maxima & (ng > float(np.float32(minimum_ng))), ng, box)


def compact(tile_mask, tile_loc, tile_ng, box: int):
    """Hit list (frame, y, x, ng) of the tiles, in (frame, tile-row,
    tile-col) order — torch.nonzero's row-major order."""
    T = box // 2 + 1
    b, ty, tx = torch.nonzero(tile_mask).unbind(1)
    li = tile_loc[b, ty, tx].to(torch.int64)
    return b, ty * T + li // T, tx * T + li % T, tile_ng[b, ty, tx]


def identify_frames(
    frames: np.ndarray,
    minimum_ng: float,
    box: int,
    frame_offset: int = 0,
    roi: tuple[tuple[int, int], tuple[int, int]] | None = None,
    device="cuda",
):
    """Identify spots in a batch of frames on ``device``; returns numpy
    (frame, y, x, net_gradient). ROI crops before identification and
    offsets coordinates back."""
    from picasso_torch.lib import resolve_device
    from picasso_torch.ops.identify_cuda import identify_tiles

    frames = np.asarray(frames)
    if roi is not None:
        (y0, x0), (y1, x1) = roi
        frames = frames[:, y0:y1, x0:x1]
    dev = upload_frames(frames, resolve_device(device))
    f, y, x, ng = compact(*identify_tiles(dev, minimum_ng, box), box)
    f, y, x = (a.cpu().numpy().astype(np.int64) for a in (f, y, x))
    ng = ng.cpu().numpy().astype(np.float32)
    if roi is not None:
        y = y + roi[0][0]
        x = x + roi[0][1]
    return f + frame_offset, y, x, ng


def host_frames(frames: np.ndarray) -> np.ndarray:
    """A (B, Y, X) numpy chunk, contiguous, in a dtype the identify
    kernel reads: u16 stays u16, anything else becomes f32 (exact for
    integers below 2^24)."""
    frames = np.ascontiguousarray(frames)
    if frames.dtype != np.uint16:
        frames = frames.astype(np.float32)
    return frames


def upload_frames(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """:func:`host_frames` of a (B, Y, X) numpy chunk on ``device``."""
    return torch.from_numpy(host_frames(frames)).to(device)


def cut_spots_numpy(movie, ids_frame: np.ndarray, ids_x: np.ndarray,
                    ids_y: np.ndarray, box: int) -> np.ndarray:
    """(N, box, box) ROIs around the centres on the host, in the movie's
    dtype (picasso_tpu/ops/identify.py:732): one fancy-index gather from
    an array, frame by frame from a lazy movie. A ROI starts box // 2
    pixels before its centre, so at an even box it ends box // 2 - 1
    after it, as picasso_tpu's native cut and its fused chain's row
    gather take it. Centres are not clamped; identify never yields one
    within box // 2 of an edge."""
    r = box // 2
    if isinstance(movie, np.ndarray) or hasattr(movie, "__array__"):
        offs = np.arange(box) - r
        yy = ids_y[:, None, None] + offs[None, :, None]
        xx = ids_x[:, None, None] + offs[None, None, :]
        return np.asarray(movie)[ids_frame[:, None, None], yy, xx]
    n = len(ids_frame)
    spots = np.zeros((n, box, box), dtype=movie.dtype)
    order = np.argsort(ids_frame, kind="stable")
    frames, starts = np.unique(ids_frame[order], return_index=True)
    for frame_number, lo, hi in zip(frames, starts, [*starts[1:], n]):
        frame = np.asarray(movie[int(frame_number)])
        for k in order[lo:hi]:
            yc, xc = ids_y[k], ids_x[k]
            spots[k] = frame[yc - r:yc - r + box, xc - r:xc - r + box]
    return spots


def to_photons(spots: np.ndarray, camera_info: dict) -> np.ndarray:
    """(raw - baseline) * sensitivity / gain in f32, rounded after each
    step (picasso_tpu/ops/identify.py:769)."""
    spots = np.float32(spots)
    return ((spots - camera_info["Baseline"]) * camera_info["Sensitivity"]
            / camera_info["Gain"])


def to_photons_one_factor(spots: np.ndarray, camera_info: dict) -> np.ndarray:
    """(raw - baseline) * (sensitivity / gain) in f32, the factor from
    the f32 sensitivity and gain: picasso_tpu's native cut of u16 arrays
    (native.cut_spots_to_photons, picasso_native.cpp:140)."""
    scale = (np.float32(camera_info["Sensitivity"])
             / np.float32(camera_info["Gain"]))
    return (np.float32(spots) - np.float32(camera_info["Baseline"])) * scale
