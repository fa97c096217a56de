"""Pair search on a torch device: cell lists for the pairs within a
radius, blocked tiles for the k nearest neighbours.

Counterpart of picasso_tpu/ops/neighbors.py (knn :123,
pairwise_distance_histogram :324, radius_count :401, radius_max :474),
whose O(N^2) distance tiles serve the TPU, and of the cKDTree route that
picasso_tpu/postprocess.py takes off a TPU (distance_histogram :540,
compute_local_density :600, nn_analysis :1661). The port holds to the
cKDTree route: distances in f64 from the input coordinates, compared as
squares against the squared radius (cKDTree tests d^2 <= r * r). The
SMLM clusterer's passes (:func:`cluster_counts`, :func:`radius_max`,
:func:`neighbour_lists`) hold to the native core of
picasso_tpu/native/picasso_native.cpp:338-345 instead: f32 coordinates,
d^2 = dx*dx + dy*dy (+ dz*dz) summed in f32 and compared in f64 with
radius * radius (:func:`native_within`).

Cells: the points sorted by one packed int64 key, (lead fields such as
group and frame, cell row, cell column), with square cells of side a
little over the radius (:data:`CELL_MARGIN`), so that a neighbour lies
in the 3 x 3 cells around a point's own (3 x 3 x 3 in 3D, where the z
cell is a lead field). For a fixed row those are one index range of the
sorted keys, found with ``torch.searchsorted``.
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
    """Points sorted by the packed key (lead..., cell row, cell column,
    trail...).

    ``lead`` and ``trail`` hold (values, size) pairs of int64 fields with
    values in [0, size); the cell row and column are padded by one cell
    on either side, so a query one row or column beyond the points stays
    inside its own field. With ``trail`` fields the points of one cell
    are sorted by them (:func:`~picasso_torch.ops.link.window_ranges`);
    :meth:`row_range` takes an index without them."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, cell: float,
                 lead: Sequence[tuple[torch.Tensor, int]] = (),
                 trail: Sequence[tuple[torch.Tensor, int]] = ()):
        if not cell > 0:
            raise ValueError(f"cell side must be > 0, got {cell}")
        n = len(x)
        cx, cy = _cells(x, cell), _cells(y, cell)
        self.cell = cell
        self.grid = []
        fields = list(lead)
        for c in (cy, cx):
            lo = int(c.min()) if n else 0
            hi = int(c.max()) if n else 0
            self.grid.append((lo, hi - lo + 3))
            fields.append((c - lo + 1, hi - lo + 3))
        fields += list(trail)
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

    def key_of(self, qx: torch.Tensor, qy: torch.Tensor) -> torch.Tensor:
        """The keys of other points (qx, qy), for an index without lead or
        trail fields: their cells clamped to the padded grid, whose border
        rows and columns hold no point, so that a point beyond the grid
        still finds every indexed point within one cell of it through
        :meth:`row_range`."""
        key = torch.zeros(len(qx), dtype=torch.int64, device=qx.device)
        for q, (lo, size), m in zip((qy, qx), self.grid, self.mult):
            key += (_cells(q, self.cell) - lo + 1).clamp(0, size - 1) * m
        return key

    def row_range(self, offsets: Sequence[int], key=None):
        """(lo, hi) of the sorted positions in the three cells (column - 1
        .. column + 1) of the row a point's own fields plus ``offsets``
        (one per field but the column) name; for the points of ``key``
        (a subset of :attr:`key`) when given."""
        base = (self.key if key is None else key).clone()
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


def ball_pairs(cells: CellIndex, xs: torch.Tensor, ys: torch.Tensor,
               qx: torch.Tensor, qy: torch.Tensor, radius: float,
               budget: int = PAIR_BUDGET):
    """Chunks (centre index, position in the cells' order, d^2, within)
    of the candidate pairs of the f64 centres (qx, qy) and the points of
    ``cells`` (a :func:`grid` of ``radius``; ``xs``, ``ys`` their f64
    coordinates in its order): every point of the 3 x 3 cells around a
    centre's, ``within`` by cKDTree.query_ball_point's test, d^2 = dx*dx
    + dy*dy in f64 <= radius^2 (a point at exactly the radius counts)."""
    key = cells.key_of(qx, qy)
    ranges = [cells.row_range((dy,), key) for dy in (-1, 0, 1)]
    lo = torch.stack([r[0] for r in ranges], 1)
    hi = torch.stack([r[1] for r in ranges], 1)
    r2 = float(radius) * float(radius)
    for q, pos in expand(lo, hi, budget):
        dx = xs[pos] - qx[q]
        dy = ys[pos] - qy[q]
        d2 = dx * dx + dy * dy
        yield q, pos, d2, d2 <= r2


def grid(x: torch.Tensor, y: torch.Tensor, radius: float,
         z: torch.Tensor | None = None) -> CellIndex:
    """The cells of side :func:`cell_side` (``radius``) of the points, the
    z cell (when ``z`` is given) as their lead field."""
    cell = cell_side(radius)
    lead = []
    if z is not None:
        cz = _cells(z, cell)
        lo = int(cz.min()) if len(cz) else 0
        hi = int(cz.max()) if len(cz) else 0
        lead = [(cz - lo + 1, hi - lo + 3)]
    return CellIndex(x, y, cell, lead)


def _offsets(three_d: bool, half: bool) -> list[tuple[int, ...]]:
    """The rows (dz, dy) around a point's own to search: all of them, or
    for unordered pairs once, those after its own row in the key order."""
    rows = [(dz, dy) for dz in ((-1, 0, 1) if three_d else (0,))
            for dy in (-1, 0, 1)]
    if half:
        rows = [r for r in rows if r > (0, 0)]
    return [r[1:] if not three_d else r for r in rows]


def half_pairs(x: torch.Tensor, y: torch.Tensor, radius: float,
               budget: int = PAIR_BUDGET, z: torch.Tensor | None = None):
    """Every unordered pair of points in neighbouring cells, once: the
    rest of a point's own row after it (its cell and the next), and the
    three cells of each later row around it (the next row; in 3D also
    the three rows of the next z layer). Yields (i, j) index chunks; the
    caller tests the distance."""
    cells = grid(x, y, radius, z)
    own = (0, 0) if z is not None else (0,)
    _, hi0 = cells.row_range(own)
    ranges = [cells.row_range(o) for o in _offsets(z is not None, True)]
    lo = torch.stack([cells.rank() + 1] + [r[0] for r in ranges], 1)
    hi = torch.stack([hi0] + [r[1] for r in ranges], 1)
    order = cells.order
    for i, pos in expand(lo, hi, budget):
        yield i, order[pos]


def _columns(X: torch.Tensor):
    """(x, y, z or None) of an (n, 2) or (n, 3) coordinate tensor."""
    if X.ndim != 2 or X.shape[1] not in (2, 3):
        raise ValueError(f"coordinates must be (n, 2) or (n, 3), got "
                         f"{tuple(X.shape)}")
    return X[:, 0], X[:, 1], (X[:, 2] if X.shape[1] == 3 else None)


def pairs(X: torch.Tensor, radius: float, budget: int = PAIR_BUDGET):
    """:func:`half_pairs` of the 2 or 3 columns of ``X``."""
    x, y, z = _columns(X)
    yield from half_pairs(x, y, radius, budget, z)


def pair_d2(X: torch.Tensor, i: torch.Tensor, j: torch.Tensor
            ) -> torch.Tensor:
    """Squared distances of the pairs (i, j) of the points ``X`` in their
    dtype, (dx*dx + dy*dy) + dz*dz one op at a time (no fused
    multiply-add), as the native core, sklearn and cKDTree sum them."""
    d2 = None
    for c in range(X.shape[1]):
        d = X[i, c] - X[j, c]
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def native_within(X: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                  radius: float) -> torch.Tensor:
    """The pairs (i, j) of the f32 points ``X`` within ``radius`` by the
    native core's test: :func:`pair_d2` in f32 compared as f64 with
    radius * radius in f64 (picasso_native.cpp:338-345, :366)."""
    return pair_d2(X, i, j).to(torch.float64) <= float(radius) * float(radius)


def cluster_counts(X: torch.Tensor, radius: float,
                   budget: int = PAIR_BUDGET) -> torch.Tensor:
    """For each f32 point of ``X`` (n, 2|3), the points within ``radius``
    by :func:`native_within`, the point itself included; int64 on its
    device."""
    counts = torch.ones(len(X), dtype=torch.int64, device=X.device)
    for i, j in pairs(X, radius, budget):
        one = native_within(X, i, j, radius).to(torch.int64)
        counts.index_add_(0, i, one)
        counts.index_add_(0, j, one)
    return counts


def radius_max(X: torch.Tensor, radius: float, values: torch.Tensor,
               budget: int = PAIR_BUDGET) -> torch.Tensor:
    """For each f32 point of ``X``, the max of ``values`` over the points
    within ``radius`` by :func:`native_within`, the point itself
    included (the neighbourhood max of the SMLM clusterer)."""
    out = values.clone()
    for i, j in pairs(X, radius, budget):
        ok = native_within(X, i, j, radius)
        # a pair outside the radius offers the point's own value
        out.scatter_reduce_(0, i, torch.where(ok, values[j], values[i]),
                            "amax")
        out.scatter_reduce_(0, j, torch.where(ok, values[i], values[j]),
                            "amax")
    return out


def neighbour_lists(X: torch.Tensor, radius: float, rows: torch.Tensor,
                    budget: int = PAIR_BUDGET):
    """The neighbours of the points ``rows`` (int64 indices into ``X``)
    by :func:`native_within`, each point itself left out, as a CSR in the
    order of ``rows``: (starts, stops, cols) int64 on the device, the
    neighbours of rows[k] cols[starts[k]:stops[k]]. Only these rows'
    pairs are expanded."""
    x, y, z = _columns(X)
    cells = grid(x, y, radius, z)
    key = cells.key[rows]
    ranges = [cells.row_range(o, key) for o in _offsets(z is not None, False)]
    lo = torch.stack([r[0] for r in ranges], 1)
    hi = torch.stack([r[1] for r in ranges], 1)
    counts = torch.zeros(len(rows), dtype=torch.int64, device=X.device)
    cols = []
    for k, pos in expand(lo, hi, budget):
        i, j = rows[k], cells.order[pos]
        ok = native_within(X, i, j, radius) & (i != j)
        counts.index_add_(0, k[ok], torch.ones_like(k[ok]))
        cols.append(j[ok])
    stops = torch.cumsum(counts, 0)
    cols = (torch.cat(cols) if cols else
            torch.zeros(0, dtype=torch.int64, device=X.device))
    return stops - counts, stops, cols


def radius_count(x: torch.Tensor, y: torch.Tensor, radius: float,
                 budget: int = PAIR_BUDGET,
                 z: torch.Tensor | None = None) -> torch.Tensor:
    """For each point (2D, or 3D with ``z``), the other points within
    ``radius``: d^2 (:func:`pair_d2` in f64 from the coordinates) <=
    radius^2, as cKDTree.query_ball_point and sklearn's KDTree count
    them, less the point itself; int64 on the points' device."""
    X = torch.stack([c.to(torch.float64) for c in (x, y, z)
                     if c is not None], 1)
    counts = torch.zeros(len(X), dtype=torch.int64, device=X.device)
    r2 = float(radius) * float(radius)
    for i, j in pairs(X, radius, budget):
        one = (pair_d2(X, i, j) <= r2).to(torch.int64)
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
    X = torch.stack([x.to(torch.float64), y.to(torch.float64)], 1)
    hist = torch.zeros(n_bins, dtype=torch.int64, device=x.device)
    if n_bins <= 0 or len(x) < 2:
        return hist
    thr = torch.from_numpy(histogram_thresholds(bin_size, n_bins)[1:]).to(
        x.device)
    for i, j in pairs(X, n_bins * bin_size, budget):
        b = torch.searchsorted(thr, pair_d2(X, i, j), side="left")
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


#: scipy's ks_2samp takes its exact mode where both sizes are at most this
KS_EXACT_MAX = 10000


def knn_masked(a: torch.Tensor, b: torch.Tensor, a_mask: torch.Tensor,
               b_mask: torch.Tensor, k: int, exclude_self: bool = False,
               b_block: int | None = None) -> torch.Tensor:
    """Batched masked kNN (picasso_tpu/ops/neighbors.py:168, vmapped
    there): ``a`` (R, N, D) and ``b`` (R, M, D) f32 with validity masks
    (R, N) and (R, M). Returns (R, N, k) f32 distances, ascending, +inf
    where a row of ``a`` is masked or fewer than k valid neighbours are
    there; ``exclude_self`` leaves out index-equal pairs (``a`` is
    ``b``).

    The squares are summed per axis in the difference form, as JAX's
    _block_d2 (:50-61; the |a|^2 + |b|^2 - 2ab identity cancels in f32).
    ``b_block`` bounds the live (R, N, block) tile. A block's k smallest
    are taken by k min-extractions, as JAX's _merge_topk takes them (on
    the H100 2.8x faster than ``torch.topk`` of the block), and merged
    with the running k. The root is taken in f64 and rounded, which is
    the correctly rounded f32 root on every device (torch's f32 root on
    the CPU is not always)."""
    R, N, D = a.shape
    M = b.shape[1]
    if b_block is None or b_block >= M:
        b_block = M
    # a masked point of b lies at 1e30, so its squared distance is inf
    b = torch.where(b_mask[..., None], b, torch.full_like(b, 1e30))
    top = torch.full((R, N, k), torch.inf, dtype=torch.float32,
                     device=a.device)
    for t in range(0, M, b_block):
        bb = b[:, t:t + b_block]
        d2 = None
        for d in range(D):
            diff = a[:, :, d, None] - bb[:, None, :, d]
            diff.mul_(diff)
            d2 = diff if d2 is None else d2.add_(diff)
        if exclude_self and t < N:
            d2[:, t:t + b_block].diagonal(dim1=1, dim2=2).fill_(torch.inf)
        smallest = []
        for i in range(min(k, d2.shape[2])):
            v, j = d2.min(2)
            smallest.append(v)
            if i + 1 < k:
                d2.scatter_(2, j[..., None], torch.inf)
        top = torch.sort(torch.cat([top] + [v[..., None] for v in smallest],
                                   2), dim=2).values[..., :k]
    d = torch.sqrt(top.to(torch.float64)).to(torch.float32)
    return torch.where(a_mask[..., None], d, torch.inf)


def ks_2samp_masked(sample: torch.Tensor, sample_mask: torch.Tensor,
                    gt_sorted: torch.Tensor) -> torch.Tensor:
    """Batched two-sample KS statistic of masked samples against one
    sorted reference (picasso_tpu/ops/neighbors.py:213): ``sample`` (R,
    S) with ``sample_mask`` (R, S), ``gt_sorted`` (G,) ascending, all
    valid. Returns (R,) f64, equal to ``scipy.stats.ks_2samp(sample,
    gt).statistic`` for finite input; 1.0 where no valid finite sample
    is left.

    Sort-free on the sample, as JAX: the statistic needs, at each gt
    point g_j, the counts le_j and lt_j of the sample <= g_j and < g_j.
    Each sample value's rank among the gt points (``searchsorted``) is
    histogrammed and summed, so the counts are exact integers. Then as
    scipy: the largest of (j + 1)/n2 - le_j/n1 and lt_j/n1 - j/n2, with
    scipy's divisions in f64; where both sizes are at most
    KS_EXACT_MAX, scipy's exact mode rounds it to h / lcm(n1, n2), which
    is formed here from the integer differences."""
    valid = sample_mask & torch.isfinite(sample)
    s = torch.where(valid, sample, torch.inf).contiguous()
    R = s.shape[0]
    G = gt_sorted.shape[0]
    dev = s.device
    n1 = valid.sum(1)
    ones = torch.ones_like(s, dtype=torch.int64)

    def counts(side: str) -> torch.Tensor:
        # s <= g_j iff j >= #(g < s); s < g_j iff j >= #(g <= s)
        pos = torch.searchsorted(gt_sorted, s, side=side)
        hist = torch.zeros((R, G + 1), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, pos, ones)
        return torch.cumsum(hist, 1)[:, :G]

    le, lt = counts("left"), counts("right")
    j = torch.arange(G, dtype=torch.int64, device=dev)[None, :]
    n2 = torch.full((1, 1), G, dtype=torch.int64, device=dev)
    m1 = n1.clamp(min=1)[:, None]
    # asymptotic mode: the f64 differences of the f64 quotients
    f1, f2 = m1.to(torch.float64), n2.to(torch.float64)
    d = torch.maximum(((j + 1) / f2 - le / f1).amax(1),
                      (lt / f1 - j / f2).amax(1)).clamp(min=0.0)
    # exact mode: the integer differences over lcm(n1, n2)
    lcm = m1 // torch.gcd(m1, n2) * n2
    a1, a2 = lcm // m1, lcm // n2
    h = torch.maximum(((j + 1) * a2 - le * a1).amax(1),
                      (lt * a1 - j * a2).amax(1)).clamp(min=0)
    exact = torch.maximum(n1, n2[0]) <= KS_EXACT_MAX
    d = torch.where(exact, h.to(torch.float64) / lcm[:, 0].to(torch.float64),
                    d)
    return torch.where(n1 > 0, d, 1.0)
