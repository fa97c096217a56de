"""Multi-resolution Morton-order render index for O(viewport) pan and
zoom queries, on the host.

Counterpart of picasso_tpu/spatial_index.py (RenderIndexPyramid :23,
build_render_index :71, query_viewport :136; picasso/spatial_index.py
:46, :147, :265): three grid levels share one permutation sorted by
Morton key at the finest level, so a coarse block is a contiguous range
of the same ``perm``. Vectorized numpy, as in JAX, on locs as numpy
structured arrays; ``perm`` and the block ranges equal JAX's bit for
bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_TARGET_BLOCKS_PER_EDGE = 64
_BYPASS_COVERAGE_RATIO = 0.1


@dataclass
class RenderIndexPyramid:
    """Shared-permutation block pyramid; see module docstring."""

    perm: np.ndarray
    block_sizes: tuple[float, ...]
    block_starts: list[np.ndarray]
    block_ends: list[np.ndarray]
    width: float
    height: float


def _base_block_size(width: float, height: float) -> float:
    """Finest block size targeting ~256k blocks over the FOV, floored
    at one camera pixel."""
    return float(max(1.0, np.ceil(np.sqrt(width * height / 256_000.0))))


def _morton_encode_2d(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Vectorized bit interleave of 32-bit block coords into uint64
    Z-order keys."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
        v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
        return v

    return spread(x) | (spread(y) << np.uint64(1))


def _block_ranges(bx, by, K: int, L: int):
    """Start/end grids from Morton-sorted per-loc block coords: each
    occupied block is one contiguous run of the sorted permutation."""
    starts = np.zeros((K, L), np.uint32)
    ends = np.zeros((K, L), np.uint32)
    flat = by.astype(np.int64) * L + bx.astype(np.int64)
    change = np.nonzero(np.diff(flat))[0] + 1
    run_starts = np.concatenate([[0], change])
    run_ends = np.concatenate([change, [len(flat)]])
    ids = flat[run_starts]
    starts.reshape(-1)[ids] = run_starts
    ends.reshape(-1)[ids] = run_ends
    return starts, ends


def build_render_index(
    locs: np.ndarray, info: list[dict], n_levels: int = 3
) -> RenderIndexPyramid:
    """Build the pyramid for one channel
    (cf. picasso/spatial_index.py:147)."""
    width = float(info[0]["Width"])
    height = float(info[0]["Height"])
    base = _base_block_size(width, height)
    block_sizes = tuple(base * (4**lvl) for lvl in range(n_levels))
    x = locs["x"]
    y = locs["y"]
    n = len(x)
    if n == 0:
        block_starts, block_ends = [], []
        for size in block_sizes:
            K = max(1, int(np.ceil(height / size)))
            L = max(1, int(np.ceil(width / size)))
            block_starts.append(np.zeros((K, L), np.uint32))
            block_ends.append(np.zeros((K, L), np.uint32))
        return RenderIndexPyramid(
            perm=np.empty(0, np.uint32),
            block_sizes=block_sizes,
            block_starts=block_starts,
            block_ends=block_ends,
            width=width,
            height=height,
        )
    nbx0 = max(1, int(np.ceil(width / base)))
    nby0 = max(1, int(np.ceil(height / base)))
    bx0 = np.clip(np.floor(x / base), 0, nbx0 - 1).astype(np.uint32)
    by0 = np.clip(np.floor(y / base), 0, nby0 - 1).astype(np.uint32)
    keys = _morton_encode_2d(bx0, by0)
    perm = np.argsort(keys, kind="stable").astype(np.uint32)
    block_starts, block_ends = [], []
    for size in block_sizes:
        K = max(1, int(np.ceil(height / size)))
        L = max(1, int(np.ceil(width / size)))
        bx = np.clip(np.floor(x[perm] / size), 0, L - 1).astype(np.uint32)
        by = np.clip(np.floor(y[perm] / size), 0, K - 1).astype(np.uint32)
        bs, be = _block_ranges(bx, by, K, L)
        block_starts.append(bs)
        block_ends.append(be)
    return RenderIndexPyramid(
        perm=perm,
        block_sizes=block_sizes,
        block_starts=block_starts,
        block_ends=block_ends,
        width=width,
        height=height,
    )


def _select_level(pyramid: RenderIndexPyramid, viewport) -> int:
    """Finest level keeping blocks per viewport edge <= target
    (cf. picasso/spatial_index.py:223)."""
    (y_min, x_min), (y_max, x_max) = viewport
    edge = max(y_max - y_min, x_max - x_min)
    for lvl, size in enumerate(pyramid.block_sizes):
        if edge / size <= _TARGET_BLOCKS_PER_EDGE:
            return lvl
    return len(pyramid.block_sizes) - 1


def query_viewport(
    pyramid: RenderIndexPyramid, viewport
) -> np.ndarray | None:
    """Original-locs indices intersecting the viewport, or None to
    signal full-render bypass for near-full-FOV viewports
    (cf. picasso/spatial_index.py:265)."""
    (y_min, x_min), (y_max, x_max) = viewport
    area = max(0.0, (y_max - y_min)) * max(0.0, (x_max - x_min))
    fov_area = pyramid.width * pyramid.height
    if fov_area > 0 and area / fov_area >= _BYPASS_COVERAGE_RATIO:
        return None
    if len(pyramid.perm) == 0:
        return np.empty(0, np.uint32)
    lvl = _select_level(pyramid, viewport)
    size = pyramid.block_sizes[lvl]
    bs = pyramid.block_starts[lvl]
    be = pyramid.block_ends[lvl]
    K, L = bs.shape
    bx_lo = max(0, int(np.floor(x_min / size)))
    bx_hi = min(L - 1, int(np.floor(x_max / size)))
    by_lo = max(0, int(np.floor(y_min / size)))
    by_hi = min(K - 1, int(np.floor(y_max / size)))
    if bx_hi < bx_lo or by_hi < by_lo:
        return np.empty(0, np.uint32)
    sub_s = bs[by_lo:by_hi + 1, bx_lo:bx_hi + 1].reshape(-1)
    sub_e = be[by_lo:by_hi + 1, bx_lo:bx_hi + 1].reshape(-1)
    occupied = sub_e > sub_s
    parts = [
        pyramid.perm[s:e]
        for s, e in zip(sub_s[occupied], sub_e[occupied])
    ]
    if not parts:
        return np.empty(0, np.uint32)
    return np.concatenate(parts)
