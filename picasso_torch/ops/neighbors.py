"""Pair search on a torch device: cell lists for the pairs within a
radius, blocked tiles for the k nearest neighbours.

Counterpart of picasso_tpu/ops/neighbors.py (knn :123,
pairwise_distance_histogram :324, radius_count :401), whose O(N^2)
distance tiles serve the TPU, and of the cKDTree route that
picasso_tpu/postprocess.py takes off a TPU (distance_histogram :540,
compute_local_density :600, nn_analysis :1661). The port holds to the
cKDTree route: distances in f64 from the input coordinates, compared as
squares against the squared radius (cKDTree tests d^2 <= r * r).

Cells: the points sorted by one packed int64 key, (lead fields such as
group and frame, cell row, cell column), with square cells of side a
little over the radius (:data:`CELL_MARGIN`), so that a neighbour lies
in the 3 x 3 cells around a point's own. For a fixed row those are one
index range of the sorted keys, found with ``torch.searchsorted``.
Candidate pairs are expanded from the ranges in chunks of about a pair
budget (``repeat_interleave`` over the range lengths) and tested
exactly; nothing of size N x M is made. The cells are only a filter.

k nearest neighbours: blocked brute-force tiles in the difference form
with a running ``torch.topk``, as JAX does; its inputs are cluster
centres or events (1e3 to 1e5 points). ``torch.cdist`` is not used: its
matmul mode loses precision on coordinates of 100s of px.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

#: cell side over the radius: a pair within the radius is never more than
#: one cell apart, whatever the rounding of floor(x / cell)
CELL_MARGIN = 1 + 2.0**-8
#: candidate pairs expanded at once (about; a chunk holds whole points)
PAIR_BUDGET = 1 << 24
#: cells are clamped to +-2^40, far beyond any field of view
_CELL_CLAMP = float(2**40)
A_CHUNK = 4096
B_BLOCK = 4096


def _cells(v: torch.Tensor, cell: float) -> torch.Tensor:
    """floor(v / cell) as int64; a non-finite value goes to cell 0 (it
    passes no exact test, so any cell will do)."""
    c = torch.floor(v.to(torch.float64) / cell)
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c))
    return c.clamp(-_CELL_CLAMP, _CELL_CLAMP).to(torch.int64)


def cell_side(radius: float) -> float:
    """The cell side for pairs within ``radius``; with radius 0 only
    equal points pair, and those share any cell."""
    radius = abs(float(radius))
    return radius * CELL_MARGIN if radius > 0 else 1.0


class CellIndex:
    """Points sorted by the packed key (lead..., cell row, cell column).

    ``lead`` holds (values, size) pairs of int64 fields with values in
    [0, size); the cell row and column are padded by one cell on either
    side, so a query one row or column beyond the points stays inside
    its own field."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, cell: float,
                 lead: Sequence[tuple[torch.Tensor, int]] = ()):
        if not cell > 0:
            raise ValueError(f"cell side must be > 0, got {cell}")
        n = len(x)
        cx, cy = _cells(x, cell), _cells(y, cell)
        fields = list(lead)
        for c in (cy, cx):
            lo = int(c.min()) if n else 0
            hi = int(c.max()) if n else 0
            fields.append((c - lo + 1, hi - lo + 3))
        bits = sum(np.log2(max(size, 1)) for _, size in fields)
        if bits > 62:
            raise ValueError(
                f"cell key needs {bits:.1f} bits (> 62): the radius is too "
                "small for the extent of the points")
        self.mult = []
        m = 1
        for _, size in reversed(fields):
            self.mult.append(m)
            m *= int(size)
        self.mult.reverse()
        key = torch.zeros(n, dtype=torch.int64, device=x.device)
        for (v, _), m in zip(fields, self.mult):
            key += v.to(torch.int64) * m
        self.key = key
        self.sorted_key, self.order = torch.sort(key, stable=True)

    def rank(self) -> torch.Tensor:
        """Each point's position in the sorted order."""
        rank = torch.empty_like(self.order)
        rank[self.order] = torch.arange(len(rank), device=rank.device)
        return rank

    def row_range(self, offsets: Sequence[int]):
        """(lo, hi) of the sorted positions in the three cells (column - 1
        .. column + 1) of the row a point's own fields plus ``offsets``
        (one per field but the column) name."""
        base = self.key.clone()
        for o, m in zip(offsets, self.mult[:-1]):
            if o:
                base += o * m
        lo = torch.searchsorted(self.sorted_key, base - 1, side="left")
        hi = torch.searchsorted(self.sorted_key, base + 1, side="right")
        return lo, hi


def expand(lo: torch.Tensor, hi: torch.Tensor,
           budget: int = PAIR_BUDGET) -> Iterator[tuple[torch.Tensor,
                                                        torch.Tensor]]:
    """The candidate pairs of (n, R) index ranges [lo, hi), in chunks of
    whole points of about ``budget`` pairs (a chunk exceeds it by at
    most one point's pairs): yields (point index, sorted position)."""
    n, R = lo.shape
    lens = (hi - lo).clamp_min(0)
    cum = torch.cumsum(lens.sum(1), 0)
    total = int(cum[-1]) if n else 0
    if total == 0:
        return
    targets = torch.arange(1, -(-total // budget), device=lo.device) * budget
    ends = torch.searchsorted(cum, targets, side="right").tolist() + [n]
    start, done = 0, 0
    for end in ends:
        if end <= start:
            continue
        upto = int(cum[end - 1])
        n_pairs = upto - done
        if n_pairs:
            lens_c = lens[start:end].reshape(-1)
            lo_c = lo[start:end].reshape(-1)
            rep = torch.repeat_interleave(
                torch.arange(len(lens_c), device=lo.device), lens_c,
                output_size=n_pairs)
            first = torch.cumsum(lens_c, 0) - lens_c
            pos = lo_c[rep] + (torch.arange(n_pairs, device=lo.device)
                               - first[rep])
            yield start + torch.div(rep, R, rounding_mode="floor"), pos
        start, done = end, upto


def half_pairs(x: torch.Tensor, y: torch.Tensor, radius: float,
               budget: int = PAIR_BUDGET):
    """Every unordered pair of points in neighbouring cells, once: the
    rest of a point's own row after it (its cell and the next), and the
    three cells of the next row. Yields (i, j) index chunks; the caller
    tests the distance."""
    cells = CellIndex(x, y, cell_side(radius))
    rank = cells.rank()
    _, hi0 = cells.row_range((0,))
    lo1, hi1 = cells.row_range((1,))
    lo = torch.stack([rank + 1, lo1], 1)
    hi = torch.stack([hi0, hi1], 1)
    order = cells.order
    for i, pos in expand(lo, hi, budget):
        yield i, order[pos]


def _d2(x, y, i, j) -> torch.Tensor:
    """Squared distances of the pairs in f64, (dx^2 + dy^2) as cKDTree
    sums them."""
    dx = x[i] - x[j]
    dy = y[i] - y[j]
    return dx * dx + dy * dy


def radius_count(x: torch.Tensor, y: torch.Tensor, radius: float,
                 budget: int = PAIR_BUDGET) -> torch.Tensor:
    """For each point, the other points within ``radius`` (d^2 <=
    radius^2 in f64, as cKDTree.query_ball_point less the point itself);
    int64 on the points' device."""
    x, y = x.to(torch.float64), y.to(torch.float64)
    counts = torch.zeros(len(x), dtype=torch.int64, device=x.device)
    r2 = float(radius) * float(radius)
    for i, j in half_pairs(x, y, radius, budget):
        ok = _d2(x, y, i, j) <= r2
        one = ok.to(torch.int64)
        counts.index_add_(0, i, one)
        counts.index_add_(0, j, one)
    return counts


def histogram_thresholds(bin_size: float, n_bins: int) -> np.ndarray:
    """The squared distances that close the bins: a pair is in bin k when
    T[k] < d^2 <= T[k + 1], T = nextafter(edges, -inf)^2 over the edges
    linspace(0, n_bins * bin_size, n_bins + 1), as the cKDTree route's
    count_neighbors sweep bins it."""
    edges = np.linspace(0, n_bins * bin_size, n_bins + 1)
    return np.nextafter(edges, -np.inf) ** 2


def pairwise_distance_histogram(x: torch.Tensor, y: torch.Tensor,
                                bin_size: float, n_bins: int,
                                budget: int = PAIR_BUDGET) -> torch.Tensor:
    """Histogram (n_bins,) int64 of the distances of every unordered pair
    below n_bins * bin_size, in the bins of
    :func:`histogram_thresholds`."""
    x, y = x.to(torch.float64), y.to(torch.float64)
    hist = torch.zeros(n_bins, dtype=torch.int64, device=x.device)
    if n_bins <= 0 or len(x) < 2:
        return hist
    thr = torch.from_numpy(histogram_thresholds(bin_size, n_bins)[1:]).to(
        x.device)
    for i, j in half_pairs(x, y, n_bins * bin_size, budget):
        b = torch.searchsorted(thr, _d2(x, y, i, j), side="left")
        b = b[b < n_bins]
        hist += torch.bincount(b, minlength=n_bins)
    return hist


def knn_d2(a: torch.Tensor, b: torch.Tensor, k: int, *,
           labels_a: torch.Tensor | None = None,
           labels_b: torch.Tensor | None = None,
           a_chunk: int = A_CHUNK, b_block: int = B_BLOCK) -> torch.Tensor:
    """The k smallest squared Euclidean distances (n, k) f64 from each row
    of ``a`` (n, D) into ``b`` (m, D), ascending, inf where fewer than k
    are there; the squares summed over the axes in order, as cKDTree sums
    them. Their roots are cKDTree(b).query(a, k)'s distances: the callers
    take them with numpy on the host (torch's f64 sqrt on the CPU goes
    through MKL and is not always correctly rounded; numpy's and the
    card's are). With ``labels_a`` and ``labels_b`` only pairs of equal
    labels count."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    n, m = a.shape[0], b.shape[0]
    out = torch.full((n, k), torch.inf, dtype=torch.float64, device=a.device)
    for s in range(0, n, a_chunk):
        aa = a[s:s + a_chunk]
        top = out[s:s + a_chunk]
        for t in range(0, m, b_block):
            bb = b[t:t + b_block]
            d2 = None
            for d in range(a.shape[1]):
                diff = aa[:, d, None] - bb[None, :, d]
                d2 = diff * diff if d2 is None else d2 + diff * diff
            if labels_a is not None:
                same = (labels_a[s:s + a_chunk, None]
                        == labels_b[None, t:t + b_block])
                d2 = torch.where(same, d2, torch.inf)
            top = torch.topk(torch.cat([top, d2], 1), k, dim=1,
                             largest=False, sorted=True).values
        out[s:s + a_chunk] = top
    return out
