"""Linking of localizations into binding events: the candidate successors
of each loc on a torch device, and the greedy walk over them on the host.

Counterpart of picasso_tpu/native/picasso_native.cpp:38-80 (link_groups,
through picasso_tpu/native/__init__.py:90-115) and of its Python
fallback picasso_tpu/postprocess.py:875-917 (_get_link_groups). Those
scan, for each loc that extends a chain, every loc of the next
``max_dark_time + 1`` frames (some 900 locs of a 2-frame window at 959k
locs on 2048 frames); here the cell machinery of ops/neighbors.py finds
each loc's candidates once, on the device:

- :func:`window_pairs`: the pairs (i, j) of locs of one group with
  frame_i < frame_j <= frame_i + window whose cells (side a little over
  the radius) touch, keyed by (group, cell row, cell column, frame), so
  that each of the 3 x 3 cells around a loc gives one run of frames
  (:func:`window_ranges`): nine ranges a loc, whatever the window;
- :func:`successors`: of those, the pairs the native test accepts (x and
  y cast to f32 first, then in f64 dx^2 and dy^2 each against d_max^2
  and dx^2 + dy^2 <= d_max^2), as a CSR (offsets, successors) in index
  order;
- :func:`walk`: a loc without a chain starts one, and the chain claims
  the first successor that is still unclaimed, as the native loop does
  in its window. On a CUDA tensor the CSR is read back and walked by
  ``picasso_link_walk`` (csrc/link_walk.cu, host code built into the
  kernel library; a failed build raises); on a CPU tensor by its Python
  twin :func:`walk_plain`. ``walk.launches`` counts the library's walks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from picasso_torch import _build
from picasso_torch.ops.neighbors import (
    PAIR_BUDGET, CellIndex, cell_side, expand,
)


def window_ranges(frame: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  group: torch.Tensor, radius: float, window: int):
    """The candidates of :func:`window_pairs` as ranges: (lo, hi) (n, 9)
    int64 positions into ``order``, the locs sorted by the key (group,
    cell row, cell column, frame), with row k of (lo, hi) the ranges of
    loc order[k], and ``order`` itself. A loc's nine ranges hold the locs
    of the 3 x 3 cells around its own with frames in (frame, frame +
    window], one contiguous run of a cell's locs, which sort by frame.
    So the ranges a loc takes do not depend on ``window``, which is
    clipped to the frame span of the input (as is the key's frame field,
    so a window of 10**9 frames needs no more key bits than one of 1).
    The locs search in the key's order, so that neighbouring searches
    read neighbouring keys."""
    g = torch.unique(group, return_inverse=True)[1]
    f0 = int(frame.min())
    span = int(frame.max()) - f0 + 1
    window = min(int(window), span)
    fr = frame - f0
    cells = CellIndex(x, y, cell_side(radius),
                      lead=[(g, int(g.max()) + 1)], trail=[(fr, span)])
    _, m_row, m_col, _ = cells.mult
    fr = fr[cells.order]
    base = cells.sorted_key - fr
    first = fr + 1
    last = torch.clamp(fr + window, max=span - 1)
    lo, hi = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cell = base + dy * m_row + dx * m_col
            lo.append(torch.searchsorted(cells.sorted_key, cell + first,
                                         side="left"))
            hi.append(torch.searchsorted(cells.sorted_key, cell + last,
                                         side="right"))
    return torch.stack(lo, 1), torch.stack(hi, 1), cells.order


def window_pairs(frame: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 group: torch.Tensor, radius: float, window: int,
                 budget: int = PAIR_BUDGET):
    """Chunks (i, j) of every pair of locs of one group, j in the
    ``window`` frames after i's, whose cells of side
    :func:`~picasso_torch.ops.neighbors.cell_side` (``radius``) touch,
    expanded from :func:`window_ranges`. ``frame`` and ``group`` are
    int64, ``x`` and ``y`` f64."""
    if len(frame) == 0 or window < 1:
        return
    lo, hi, order = window_ranges(frame, x, y, group, radius, window)
    for k, pos in expand(lo, hi, budget):
        yield order[k], order[pos]


def successors(frame: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               group: torch.Tensor, d_max: float, max_dark_time: int,
               budget: int = PAIR_BUDGET):
    """(offsets (n + 1,), successors) int64 on the locs' device: for loc
    i, successors[offsets[i]:offsets[i + 1]] are the locs j of its group
    in frames (frame_i, frame_i + max_dark_time + 1] within ``d_max``
    by the native test, ascending. The locs are sorted by frame; x and
    y are cast to f32, then to f64."""
    n = len(frame)
    x = x.to(torch.float32).to(torch.float64)
    y = y.to(torch.float32).to(torch.float64)
    d2 = float(d_max) * float(d_max)
    keys = []
    for i, j in window_pairs(frame, x, y, group, d_max, max_dark_time + 1,
                             budget):
        dx = x[i] - x[j]
        dy = y[i] - y[j]
        dx2, dy2 = dx * dx, dy * dy
        ok = (dx2 <= d2) & (dy2 <= d2) & (dx2 + dy2 <= d2)
        keys.append(i[ok] * n + j[ok])
    key = (torch.sort(torch.cat(keys)).values if keys else
           torch.zeros(0, dtype=torch.int64, device=frame.device))
    i = torch.div(key, n, rounding_mode="floor") if n else key
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=frame.device)
    offsets[1:] = torch.cumsum(torch.bincount(i, minlength=n), 0)
    return offsets, key - i * n


def walk_plain(offsets: np.ndarray, succ: np.ndarray) -> np.ndarray:
    """The greedy walk in Python (the plain version of csrc/
    link_walk.cu): chain ids (n,) int32 in the order chains start."""
    off = np.asarray(offsets).tolist()
    nxt = np.asarray(succ).tolist()
    n = len(off) - 1
    out = [-1] * n
    current = -1
    for i in range(n):
        if out[i] != -1:
            continue
        current += 1
        out[i] = current
        ci = i
        while True:
            claim = -1
            for k in range(off[ci], off[ci + 1]):
                if out[nxt[k]] == -1:
                    claim = nxt[k]
                    break
            if claim < 0:
                break
            out[claim] = current
            ci = claim
    return np.array(out, np.int32)


def walk(offsets: torch.Tensor, succ: torch.Tensor) -> torch.Tensor:
    """Chain ids (n,) int32 of the CSR, on its device: a CPU tensor takes
    :func:`walk_plain`; a CUDA tensor is read back and walked by the
    built library's ``picasso_link_walk``."""
    if offsets.device.type == "cpu":
        return torch.from_numpy(walk_plain(offsets.numpy(), succ.numpy()))
    if offsets.device.type != "cuda":
        raise ValueError(f"no link walk for tensors on {offsets.device}")
    off = np.ascontiguousarray(offsets.cpu().numpy(), np.int64)
    nxt = np.ascontiguousarray(succ.cpu().numpy(), np.int64)
    return torch.from_numpy(walk_host(off, nxt)).to(offsets.device)


def walk_host(off: np.ndarray, nxt: np.ndarray) -> np.ndarray:
    """The library's walk over a CSR already on the host (int64
    contiguous arrays)."""
    n = len(off) - 1
    if n < 0 or off.dtype != np.int64 or nxt.dtype != np.int64:
        raise ValueError("the link walk takes int64 offsets (n + 1,) and "
                         "successors")
    if n and (off[0] != 0 or off[-1] != len(nxt)
              or (len(nxt) and (nxt.min() < 0 or nxt.max() >= n))):
        raise ValueError("malformed CSR for the link walk")
    out = np.empty(n, np.int32)
    lib = _build.library()
    status = lib.picasso_link_walk(
        off.ctypes.data_as(ctypes.c_void_p),
        nxt.ctypes.data_as(ctypes.c_void_p), n,
        out.ctypes.data_as(ctypes.c_void_p))
    _build.count_launch(walk)
    _build.check(status, "link_walk")
    return out


walk.launches = 0
