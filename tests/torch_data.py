"""Synthetic inputs of the port's tests and of chip_smoke.py, made from a
seed with numpy only: DNA-PAINT-like spots and movies, and spots laid out
as a frame chunk for the fused cut+fit.

Copies of bench.make_spots and bench.make_bench_movie (the JAX package's
benchmark, whose other functions reach JAX), so that the port's smoke
run imports nothing of the JAX side. tests/test_torch_package.py holds
them equal to bench's for the same seeds.
"""

from __future__ import annotations

import numpy as np


def make_spots(n: int, box: int = 7, seed: int = 0) -> np.ndarray:
    """(n, box, box) f32 Poisson samples of elliptic Gaussian spots:
    centre within +-0.5 px of the box centre, widths 0.9-1.4 px, 2000-8000
    photons over a background of 5-30 photons/pixel."""
    rng = np.random.default_rng(seed)
    half = box // 2
    grid = np.arange(-half, half + 1, dtype=np.float64)
    x0 = rng.uniform(-0.5, 0.5, n)
    y0 = rng.uniform(-0.5, 0.5, n)
    sx = rng.uniform(0.9, 1.4, n)
    sy = rng.uniform(0.9, 1.4, n)
    photons = rng.uniform(2000.0, 8000.0, n)
    bg = rng.uniform(5.0, 30.0, n)
    gx = np.exp(
        -0.5 * ((grid[None, :] - x0[:, None]) / sx[:, None]) ** 2
    ) / (sx[:, None] * np.sqrt(2 * np.pi))
    gy = np.exp(
        -0.5 * ((grid[None, :] - y0[:, None]) / sy[:, None]) ** 2
    ) / (sy[:, None] * np.sqrt(2 * np.pi))
    clean = (
        photons[:, None, None] * gy[:, :, None] * gx[:, None, :]
        + bg[:, None, None]
    )
    return rng.poisson(clean).astype(np.float32)


def make_bench_movie(n_frames, size, n_sites, p_on, rng):
    """(n_frames, size, size) u16 DNA-PAINT movie: Poisson(30) camera
    background, ``n_sites`` binding sites each on with probability
    ``p_on`` per frame, ~900-photon 7x7 spots of width 1.1 px."""
    movie = rng.poisson(
        30, (n_frames, size, size)
    ).astype(np.uint16)
    yy, xx = np.mgrid[-3:4, -3:4]
    psf = np.exp(-(yy**2 + xx**2) / (2 * 1.1**2))
    sites = rng.uniform(8, size - 8, (n_sites, 2)).astype(int)
    # a frame's spots in one draw: the generator fills the (k, 7, 7)
    # array in the order of k draws of 7x7, so the numbers are bench's;
    # np.add.at adds overlapping spots as bench's += does (mod 2^16)
    for fidx in range(n_frames):
        on = sites[rng.random(n_sites) < p_on]
        spots = rng.poisson(psf * 900, (len(on), 7, 7)).astype(np.uint16)
        np.add.at(movie[fidx], (on[:, :1, None] + yy, on[:, 1:, None] + xx),
                  spots)
    return movie


def spots_chunk(spots: np.ndarray, dtype, cells: int = 36):
    """The (n, S, S) spots laid out as S x S cells, ``cells`` x ``cells``
    a frame: a (B, cells * S, cells * S) chunk of ``dtype`` (zeros where
    no spot is) and the hit list (f, y, x) int64 of the cell centres, so
    that each hit's window is its spot."""
    n, s, _ = spots.shape
    per = cells * cells
    grid = np.zeros((-(-n // per) * per, s, s), np.float32)
    grid[:n] = spots
    frames = (grid.reshape(-1, cells, cells, s, s).transpose(0, 1, 3, 2, 4)
              .reshape(-1, cells * s, cells * s))
    i = np.arange(n)
    hits = (i // per, (i % per) // cells * s + s // 2, i % cells * s + s // 2)
    return np.ascontiguousarray(frames.astype(dtype)), hits


# frame shapes (B, Y, X) that hold K4 (csrc/identify.cu) to its plain
# version at its edges: Y and X off multiples of the tile, of the strip
# rows and of the block width; odd X; frames smaller than the halo, down
# to one row; B = 1 and 300
K4_SHAPES = [(1, 97, 131), (300, 20, 23), (2, 1, 40), (2, 6, 40), (2, 9, 9),
             (2, 40, 7), (3, 8, 300), (2, 10, 13), (1, 257, 255),
             (4, 130, 67)]


def small_frames(shape, rng, spots: int = 2, nan: float = 0.0) -> np.ndarray:
    """(B, Y, X) f32 frames of any size, down to one row: Poisson(30)
    background, ``spots`` ~900-photon spots of width 1.1 px a frame at
    uniform centres (cut at the frame's edges), and a share ``nan`` of
    the pixels set to NaN. Integer-valued apart from the NaNs."""
    B, Y, X = shape
    frames = rng.poisson(30, shape).astype(np.float32)
    yy, xx = np.mgrid[-3:4, -3:4]
    psf = np.exp(-(yy**2 + xx**2) / (2 * 1.1**2))
    for f in range(B):
        for cy, cx in zip(rng.integers(0, Y, spots), rng.integers(0, X, spots)):
            spot = rng.poisson(psf * 900).astype(np.float32)
            y0, x0 = max(cy - 3, 0), max(cx - 3, 0)
            y1, x1 = min(cy + 4, Y), min(cx + 4, X)
            frames[f, y0:y1, x0:x1] += spot[y0 - cy + 3:y1 - cy + 3,
                                            x0 - cx + 3:x1 - cx + 3]
    if nan:
        frames[rng.random(shape) < nan] = np.nan
    return frames


def tiled_chunk(chunk, frames: int = 32, k: int = 8):
    """A (frames, k*Y, k*X) torch chunk whose (i, j) tile of frame f is
    frame (f*k*k + i*k + j) mod B of the (B, Y, X) torch ``chunk``, on
    its device and in its dtype."""
    import torch

    B, Y, X = chunk.shape
    idx = torch.arange(frames * k * k, device=chunk.device) % B
    # torch.uint16 has few kernels: gather through a 16-bit integer view
    src = chunk.view(torch.int16) if chunk.dtype == torch.uint16 else chunk
    out = (src[idx].view(frames, k, k, Y, X).permute(0, 1, 3, 2, 4)
           .reshape(frames, k * Y, k * X).contiguous())
    return out.view(chunk.dtype)
