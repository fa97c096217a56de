"""Clustering of localizations on a torch device: the SMLM local-maxima
clusterer, DBSCAN and HDBSCAN (without sklearn), cluster centers, areas
and the subclustering test.

Counterpart of picasso_tpu/clusterer.py (frame_analysis :30, _cluster
:72, cluster_2D :187, cluster_3D :197, extract_valid_labels :214,
cluster :224, _dbscan :280, dbscan :295, _hdbscan :346, hdbscan :364,
_count_binding_events :405, find_cluster_centers :437, _cluster_area
:571, cluster_areas :597, test_subclustering :638, cluster_center :673).
Locs are numpy structured arrays. The port follows the JAX package's
default route, its native core:

- SMLM: the neighbour counts, the neighbourhood max and the maxima's
  neighbour lists on ``device`` by cell lists with the native pair test
  (ops/neighbors.py), the sequential label sweep on the host
  (ops/cluster.sweep);
- DBSCAN: sklearn's labels from counts and connected components on
  ``device`` (ops/cluster.dbscan_labels);
- HDBSCAN: sklearn 1.9's labels: core distances (``ops/neighbors.knn_d2``)
  and Prim's tree over the mutual reachability (ops/cluster.prim_mst) on
  ``device``; the single linkage, the condensed tree, the stabilities,
  the excess-of-mass selection with ``cluster_selection_epsilon`` and
  the labels on the host, as sklearn's ``_linkage.pyx`` and
  ``_tree.pyx`` form them;
- centers: means and stds as f64 segment sums on ``device`` (within a
  few f32 ulps of pandas), the binding events as segment sums there, the
  convex hulls on the host (scipy);
- areas (histogram, Gaussian filter, Otsu) on the host, as in JAX; the
  subclustering test's nearest neighbours on ``device``, their roots on
  the host.

Roots that must equal numpy's are taken on the host or on the card
(torch's f64 sqrt on the CPU is not always correctly rounded).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from scipy.ndimage import gaussian_filter
from scipy.spatial import ConvexHull, QhullError

from picasso_torch import __version__, lib, masking
from picasso_torch.ops import cluster as cluster_ops
from picasso_torch.ops import neighbors
from picasso_torch.postprocess import _seg_moments, _segments


def _columns(locs: np.ndarray, names) -> np.ndarray:
    """The fields ``names`` as an (n, k) array of their common dtype, as
    ``DataFrame.to_numpy`` forms it (a copy)."""
    return np.column_stack([locs[n] for n in names]) if len(locs) else (
        np.zeros((0, len(names)), np.result_type(*(locs.dtype[n]
                                                    for n in names))))


# ---------------------------------------------------------------------------
# Frame analysis and the SMLM clusterer
# ---------------------------------------------------------------------------


def frame_analysis(labels: np.ndarray, frame: np.ndarray) -> np.ndarray:
    """Reject clusters whose mean frame lies outside [20, 80]% of the
    acquisition or with more than 80% of their locs in one 1/20 of it
    (picasso/clusterer.py:76). ``n_frames`` is the largest frame of all
    locs, unlabelled ones too, plus one, in the frame column's dtype; the
    means and bins in f64, as pandas forms them (a cluster's frame sum
    is exact in f64)."""
    labels = np.asarray(labels)
    frame = np.asarray(frame)
    valid = labels != -1
    if not valid.any():
        return labels
    n_frames = frame.max() + 1
    lab, frm = labels[valid], frame[valid]
    ids, inv, n_locs = np.unique(lab, return_inverse=True, return_counts=True)
    mean_frame = np.bincount(inv, frm.astype(np.float64)) / n_locs
    bins = np.clip((frm / n_frames * 20).astype(int), 0, 19)
    per_bin = np.bincount(inv * 20 + bins, minlength=20 * len(ids))
    busiest = per_bin.reshape(len(ids), 20).max(1)
    bad = ids[(mean_frame < 0.2 * n_frames) | (mean_frame > 0.8 * n_frames)
              | (busiest > 0.8 * n_locs)]
    labels = labels.copy()
    labels[np.isin(labels, bad)] = -1
    return labels


def _cluster(X: np.ndarray, radius: float, min_locs: int,
             frame: np.ndarray | None = None, *, device="cuda") -> np.ndarray:
    """Local-maxima clustering (Schlichthaerle et al., Nat. Comm. 2021;
    picasso/clusterer.py:114) of the points ``X`` (n, 2|3), cast to f32
    as the native core takes them: a point with more than ``min_locs``
    neighbours (itself included) and the most in its neighbourhood is a
    local maximum; the sweep labels each maximum's neighbourhood with the
    maximum's ordinal; clusters under ``min_locs`` locs are dropped
    without renumbering. int32 labels, -1 unclustered."""
    device = lib.resolve_device(device)
    n = len(X)
    labels = np.full(n, -1, np.int32)
    if n:
        Xt = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
        counts = neighbors.cluster_counts(Xt, radius)
        max_nb = neighbors.radius_max(Xt, radius, counts)
        lm_idx = torch.nonzero((counts > min_locs) & (counts == max_nb))[:, 0]
        starts, stops, cols = neighbors.neighbour_lists(Xt, radius, lm_idx)
        labels = cluster_ops.sweep(lm_idx, starts, stops, cols, n)
    values, sizes = np.unique(labels, return_counts=True)
    labels[np.isin(labels, values[sizes < min_locs])] = -1
    if frame is not None:
        labels = frame_analysis(labels, frame)
    return labels


def cluster_2D(locs: np.ndarray, radius: float, min_locs: int, fa: bool, *,
               device="cuda") -> np.ndarray:
    """2D SMLM clustering (picasso/clusterer.py:204)."""
    return _cluster(_columns(locs, ("x", "y")), radius, min_locs,
                    locs["frame"] if fa else None, device=device)


def cluster_3D(locs: np.ndarray, radius_xy: float, radius_z: float,
               min_locs: int, fa: bool, *, device="cuda") -> np.ndarray:
    """3D SMLM clustering: z (in camera px) scaled by radius_xy /
    radius_z, in the columns' dtype, so that the Euclidean search is an
    ellipsoid (picasso/clusterer.py:241)."""
    X = _columns(locs, ("x", "y", "z"))
    X[:, 2] *= radius_xy / radius_z
    return _cluster(X, radius_xy, min_locs, locs["frame"] if fa else None,
                    device=device)


def extract_valid_labels(locs: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """``locs`` with the field ``group`` (in place of one there, else
    appended) set to ``labels`` in their dtype, without the unclustered
    (-1) locs (picasso/clusterer.py:665)."""
    out = lib.append_to_rec(locs, labels, "group")
    return out[out["group"] != -1]


def cluster(locs: np.ndarray, radius_xy: float, min_locs: int,
            frame_analysis: bool, radius_z: float | None = None,
            pixelsize: float | None = None, return_info: bool = False, *,
            device="cuda"):
    """The SMLM clusterer (picasso/clusterer.py:291): 3D when ``locs``
    have a ``z`` field (nm; clustered in camera px, ``pixelsize`` and
    ``radius_z`` then required). The clustered locs' z is (z /
    pixelsize) * pixelsize in its dtype, as the JAX package returns it."""
    locs = locs.copy()
    n_raw = len(locs)
    has_z = "z" in locs.dtype.names
    if has_z:
        if pixelsize is None or radius_z is None:
            raise ValueError(
                "Camera pixel size and clustering radius in z must be"
                " specified for 3D clustering.")
        locs = lib.append_to_rec(locs, locs["z"] / pixelsize, "z")
        labels = cluster_3D(locs, radius_xy, radius_z, min_locs,
                            frame_analysis, device=device)
    else:
        labels = cluster_2D(locs, radius_xy, min_locs, frame_analysis,
                            device=device)
    locs = extract_valid_labels(locs, labels)
    if has_z:
        locs = lib.append_to_rec(locs, locs["z"] * pixelsize, "z")
    info = {
        "Generated by": f"Picasso v{__version__} SMLM clusterer",
        "Number of clusters": (len(np.unique(locs["group"])) if len(locs)
                               else 0),
        "Min. cluster size": min_locs,
        "Performed basic frame analysis": frame_analysis,
        "Fraction of rejected locs (%)": (
            100 * (n_raw - len(locs)) / n_raw if n_raw else 0.0),
    }
    unit = "nm" if pixelsize is not None else "px"
    scale = pixelsize if pixelsize is not None else 1
    if has_z:
        info[f"Clustering radius xy ({unit})"] = radius_xy * scale
        info[f"Clustering radius z ({unit})"] = radius_z * scale
    else:
        info[f"Clustering radius ({unit})"] = radius_xy * scale
    if return_info:
        return locs, info
    return locs


# ---------------------------------------------------------------------------
# DBSCAN
# ---------------------------------------------------------------------------


def _dbscan(X: np.ndarray, radius: float, min_density: int,
            min_locs: int = 0, *, device="cuda") -> np.ndarray:
    """sklearn.cluster.DBSCAN(eps=radius, min_samples=min_density)'s
    labels (int64) of the points ``X`` (distances in f64 from their
    values), then clusters under ``min_locs`` locs unclustered, not
    renumbered."""
    device = lib.resolve_device(device)
    Xt = torch.from_numpy(np.ascontiguousarray(X)).to(device, torch.float64)
    labels = cluster_ops.dbscan_labels(Xt, radius, min_density)[0]
    labels = labels.cpu().numpy()
    if min_locs > 0:
        values, counts = np.unique(labels[labels != -1], return_counts=True)
        labels[np.isin(labels, values[counts < min_locs])] = -1
    return labels


def dbscan(locs: np.ndarray, radius: float, min_density: int,
           pixelsize: float | None = None, return_info: bool = False,
           min_locs: int = 0, radius_z: float | None = None, *,
           device="cuda"):
    """DBSCAN (Ester et al. 1996; picasso/clusterer.py:448). With
    ``radius_z`` on 3D locs z is scaled by ``radius / radius_z``, so the
    search is an ellipsoid with semi-axes (radius, radius, radius_z);
    clusters under ``min_locs`` locs are dropped."""
    locs = locs.copy()
    n_raw = len(locs)
    is_3d = "z" in locs.dtype.names
    if is_3d:
        if pixelsize is None:
            raise ValueError(
                "Camera pixel size must be specified for 3D DBSCAN.")
        X = _columns(locs, ("x", "y", "z"))
        X[:, 2] /= pixelsize
        if radius_z is not None:
            X[:, 2] *= radius / radius_z
    else:
        X = _columns(locs, ("x", "y"))
    labels = _dbscan(X, radius, min_density, min_locs, device=device)
    locs = extract_valid_labels(locs, labels)
    info = {
        "Generated by": f"Picasso v{__version__} DBSCAN",
        "Number of clusters": (len(np.unique(locs["group"])) if len(locs)
                               else 0),
        "Radius (px)": radius,
        "Min. density": min_density,
        "Min. localizations per cluster": min_locs,
        "Fraction of rejected locs (%)": (
            100 * (n_raw - len(locs)) / n_raw if n_raw else 0.0),
    }
    if is_3d and radius_z is not None:
        info["Radius z (px)"] = radius_z
    if return_info:
        return locs, info
    return locs


# ---------------------------------------------------------------------------
# HDBSCAN: the device passes, then sklearn 1.9's tree on the host
# ---------------------------------------------------------------------------

#: sklearn's MST edge record (sklearn/cluster/_hdbscan/_linkage.pyx)
MST_DTYPE = np.dtype([("current_node", np.int64), ("next_node", np.int64),
                      ("distance", np.float64)])


def _single_linkage(mst: np.ndarray):
    """The single-linkage tree of the MST edges sorted by distance
    (``make_single_linkage``): (left, right, value, size) lists, the
    clusters of a union-find that names each merge n, n + 1, ..."""
    n = len(mst) + 1
    parent = [-1] * (2 * n - 1)
    size = [1] * n + [0] * (n - 1)

    def find(k):
        root = k
        while parent[root] != -1:
            root = parent[root]
        while k != root and parent[k] != root:
            parent[k], k = root, parent[k]
        return root

    left, right, size_out = [], [], []
    for step, (a, b) in enumerate(zip(mst["current_node"].tolist(),
                                      mst["next_node"].tolist())):
        a, b = find(a), find(b)
        left.append(a)
        right.append(b)
        merged = n + step
        parent[a] = parent[b] = merged
        size[merged] = size[a] + size[b]
        size_out.append(size[merged])
    return left, right, mst["distance"].tolist(), size_out


def _condense(left, right, value, size, min_cluster_size: int):
    """The condensed tree (``_condense_tree``): rows (parent, child,
    lambda, child size) in sklearn's order, the hierarchy walked breadth
    first from its root; a split into two parts of at least
    ``min_cluster_size`` makes two clusters, a smaller part leaves its
    cluster as single points."""
    n = len(left) + 1
    root = 2 * (n - 1)

    def count(node):
        return size[node - n] if node >= n else 1

    def bfs(start):
        out, queue = [], [start]
        while queue:
            out.extend(queue)
            queue = [c for q in queue if q >= n
                     for c in (left[q - n], right[q - n])]
        return out

    relabel = {root: n}
    next_label = n + 1
    ignore = bytearray(root + 1)
    rows = []
    for node in bfs(root):
        if ignore[node] or node < n:
            continue
        a, b = left[node - n], right[node - n]
        dist = value[node - n]
        lam = 1.0 / dist if dist > 0.0 else np.inf
        ca, cb = count(a), count(b)
        p = relabel[node]
        if ca >= min_cluster_size and cb >= min_cluster_size:
            for child, c in ((a, ca), (b, cb)):
                relabel[child] = next_label
                rows.append((p, next_label, lam, c))
                next_label += 1
            continue
        drops = [a, b] if ca < min_cluster_size and cb < min_cluster_size \
            else [a] if ca < min_cluster_size else [b]
        if len(drops) == 1:
            relabel[b if drops == [a] else a] = p
        for sub in (s for d in drops for s in bfs(d)):
            if sub < n:
                rows.append((p, sub, lam, 1))
            ignore[sub] = 1
    return rows


def _stability(rows) -> dict:
    """Each cluster's stability (``_compute_stability``): the sum over its
    rows, in their order, of (lambda - the cluster's birth lambda) x
    size."""
    parents = [r[0] for r in rows]
    first = min(parents)
    birth = {r[1]: r[2] for r in rows}
    birth[first] = 0.0
    result = [0.0] * (max(parents) - first + 1)
    for p, _, lam, c in rows:
        result[p - first] += (lam - birth[p]) * c
    return {k + first: v for k, v in enumerate(result)}


def _tree_labels(rows, min_cluster_size: int, cluster_eps: float
                 ) -> np.ndarray:
    """sklearn's ``_get_clusters`` (excess of mass, no single cluster) and
    ``_do_labelling``: labels (n,) int64 of the condensed tree's points,
    the selected clusters numbered in the order of their ids."""
    stability = _stability(rows)
    node_list = sorted(stability, reverse=True)[:-1]
    tree = [r for r in rows if r[3] > 1]
    kids: dict = {}
    parent_of, lam_of = {}, {}
    for p, c, lam, _ in tree:
        kids.setdefault(p, []).append(c)
        parent_of[c], lam_of[c] = p, lam

    def below(node):
        out, queue = [], [node]
        while queue:
            out.extend(queue)
            queue = [c for q in queue for c in kids.get(q, ())]
        return out

    is_cluster = {c: True for c in node_list}
    for node in node_list:
        sub = float(np.sum([stability[c] for c in kids.get(node, ())]))
        if sub > stability[node]:
            is_cluster[node] = False
            stability[node] = sub
        else:
            for s in below(node):
                if s != node:
                    is_cluster[s] = False
    if cluster_eps != 0.0 and tree:
        eom = [c for c in is_cluster if is_cluster[c]]
        top = min(p for p, _, _, _ in tree)
        selected = (set() if len(eom) == 1 and eom[0] == top else
                    _epsilon_search(set(eom), parent_of, lam_of, below, top,
                                    cluster_eps))
        is_cluster = {c: c in selected for c in is_cluster}
    chosen = sorted(c for c in is_cluster if is_cluster[c])
    number = {c: k for k, c in enumerate(chosen)}
    n = min(r[0] for r in rows)
    owner = {n: n}
    labels = np.full(n, -1, np.int64)
    for p, c, _, _ in rows:
        owner[c] = c if c in number else owner[p]
        if c < n and owner[c] != n:
            labels[c] = number[owner[c]]
    return labels


def _epsilon_search(leaves: set, parent_of, lam_of, below, top,
                    cluster_eps: float) -> set:
    """``epsilon_search`` of sklearn's ``_tree.pyx``: a selected cluster
    born below ``cluster_eps`` is replaced by its lowest ancestor born
    above it (or the root's child on its path), the leaves in the set's
    own order."""
    def upwards(leaf):
        parent = parent_of[leaf]
        if parent == top:
            return leaf
        if 1 / np.float64(lam_of[parent]) > cluster_eps:
            return parent
        return upwards(parent)

    selected, processed = [], set()
    for leaf in leaves:
        if 1 / np.float64(lam_of[leaf]) < cluster_eps:
            if leaf not in processed:
                up = upwards(leaf)
                selected.append(up)
                processed.update(s for s in below(up) if s != up)
        else:
            selected.append(leaf)
    return set(selected)


def _hdbscan_labels(X: np.ndarray, min_cluster_size: int, min_samples: int,
                    cluster_eps: float, device) -> tuple[np.ndarray, dict]:
    """sklearn 1.9's HDBSCAN labels of the finite f64 points ``X`` and the
    walls of its three parts (core distances, Prim, the host tree)."""
    walls = {}
    t0 = time.perf_counter()
    Xt = torch.from_numpy(np.ascontiguousarray(X)).to(device)
    d2 = neighbors.knn_d2(Xt, Xt, min_samples)[:, -1]
    core = torch.from_numpy(np.sqrt(d2.cpu().numpy())).to(device)
    t1 = time.perf_counter()
    src, node, dist = cluster_ops.prim_mst(Xt, core)
    t2 = time.perf_counter()
    mst = np.empty(len(src), MST_DTYPE)
    mst["current_node"], mst["next_node"], mst["distance"] = src, node, dist
    # sklearn's _process_mst: numpy's default (unstable) sort, as it calls it
    mst = mst[np.argsort(mst["distance"])]
    rows = _condense(*_single_linkage(mst), min_cluster_size)
    labels = _tree_labels(rows, min_cluster_size, cluster_eps)
    walls.update(core=t1 - t0, prim=t2 - t1, tree=time.perf_counter() - t2)
    return labels, walls


def _hdbscan(X, min_cluster_size: int, min_samples: int,
             cluster_eps: float = 0.0, *, device="cuda",
             walls: dict | None = None) -> np.ndarray:
    """sklearn.cluster.HDBSCAN(min_cluster_size, min_samples,
    cluster_selection_epsilon=cluster_eps)'s labels of ``X``, taken in
    f64: int64, -1 noise; rows with an inf are -2 and with a NaN -3
    (int32 then, as sklearn returns them)."""
    device = lib.resolve_device(device)
    X = np.asarray(X, np.float64)
    finite = np.isfinite(X).all(1)
    if finite.sum() == 1:
        raise ValueError(
            "n_samples=1 while HDBSCAN requires more than one sample")
    if min_samples > finite.sum():
        raise ValueError(f"min_samples ({min_samples}) must be at most the "
                         f"number of samples in X ({finite.sum()})")
    labels, parts = _hdbscan_labels(X[finite], min_cluster_size, min_samples,
                                     cluster_eps, device)
    if walls is not None:
        walls.update(parts)
    if finite.all():
        return labels
    out = np.empty(len(X), np.int32)
    out[finite] = labels
    row = X.sum(1)
    out[np.isinf(row)] = -2
    out[np.isnan(row)] = -3
    return out


def hdbscan(locs: np.ndarray, min_cluster_size: int, min_samples: int,
            pixelsize: float | None = None, cluster_eps: float = 0.0,
            return_info: bool = False, *, device="cuda"):
    """HDBSCAN (Campello et al. 2013; picasso/clusterer.py:585)."""
    locs = locs.copy()
    if "z" in locs.dtype.names:
        if pixelsize is None:
            raise ValueError(
                "Camera pixel size must be specified for 3D HDBSCAN.")
        X = _columns(locs, ("x", "y", "z"))
        X[:, 2] /= pixelsize
    else:
        X = _columns(locs, ("x", "y"))
    labels = _hdbscan(X, min_cluster_size, min_samples, cluster_eps,
                      device=device)
    locs = extract_valid_labels(locs, labels)
    info = {
        "Generated by": f"Picasso v{__version__} HDBSCAN",
        "Number of clusters": (len(np.unique(locs["group"])) if len(locs)
                               else 0),
        "Min. cluster size": min_cluster_size,
        "Min. samples": min_samples,
        "Intercluster distance": cluster_eps,
    }
    if return_info:
        return locs, info
    return locs


# ---------------------------------------------------------------------------
# Cluster centers
# ---------------------------------------------------------------------------


def _count_binding_events(group: np.ndarray, frame: np.ndarray, device):
    """Binding events per cluster (picasso/clusterer.py:728): the locs
    sorted by (group, frame) (``np.lexsort``, host), an event starting at
    every cluster's first loc and at every gap of more than 3 frames,
    counted per cluster as a segment sum on ``device``. Returns
    (n_events int64, the lexsort order, the sorted groups)."""
    order = np.lexsort((frame, group))
    group_s = group[order]
    if len(group_s) == 0:
        return np.zeros(0, np.int64), order, group_s
    g = torch.from_numpy(group_s.astype(np.int64)).to(device)
    f = torch.from_numpy(frame[order].astype(np.int64)).to(device)
    boundary = torch.ones_like(g, dtype=torch.bool)
    boundary[1:] = g[1:] != g[:-1]
    start = boundary.clone()
    start[1:] |= (f[1:] - f[:-1]) > 3
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    n_events = torch.zeros(int(seg[-1]) + 1, dtype=torch.int64,
                           device=device).index_add_(0, seg,
                                                     start.to(torch.int64))
    return n_events.cpu().numpy(), order, group_s


def find_cluster_centers(locs: np.ndarray, pixelsize: float | None = None, *,
                         device="cuda") -> np.ndarray:
    """Per-cluster centers in locs format (picasso/clusterer.py:803):
    means and stds (ddof 1), their standard errors, the lp-weighted z,
    binding events, convex hulls and the area or volume estimate, the
    clusters in sorted order. Means, stds and weighted sums are f64
    segment sums on ``device``, each rounded to its column's dtype as
    pandas returns it (pandas sums an f32 mean in f32 with Kahan
    compensation: a few f32 ulps apart)."""
    device = lib.resolve_device(device)
    names = locs.dtype.names
    has_z = "z" in names
    if has_z and pixelsize is None:
        raise ValueError("Camera pixel size must be specified for 3D cluster"
                         " centers calculation.")
    mean_cols = [c for c in ("frame", "x", "y", "photons", "sx", "sy", "bg",
                             "net_gradient") if c in names]
    std_cols = ["frame", "x", "y"]
    if has_z:
        mean_cols.append("z")
        std_cols.append("z")
    group = locs["group"]
    seg, n_seg, order, starts = _segments(group, device)
    srt = locs[order]
    cols = list(dict.fromkeys(mean_cols + std_cols))
    values = torch.from_numpy(np.stack(
        [srt[c].astype(np.float64) for c in cols], 1).reshape(len(srt),
                                                              len(cols))
    ).to(device)
    sums, cnt, var = _seg_moments(values, seg, n_seg)
    n_locs = cnt.cpu().numpy().astype(np.int64)

    def mean(c):
        # pandas: an integer column's mean in f64, a float one's in its dtype
        v = (sums[:, cols.index(c)] / cnt).cpu().numpy()
        kind = locs.dtype[c].kind
        return v if kind != "f" else v.astype(locs.dtype[c])

    def std(c):
        s = np.sqrt(var[:, cols.index(c)].cpu().numpy())
        kind = locs.dtype[c].kind
        return s if kind != "f" else s.astype(locs.dtype[c])

    unique_groups = srt["group"][starts]
    n_events, lex, group_s = _count_binding_events(group, locs["frame"],
                                                   device)
    coords = _columns(locs, ["x", "y", "z"] if has_z else ["x", "y"])
    coords = coords[lex].astype(np.float64, copy=True)
    if has_z:
        coords[:, 2] /= pixelsize
    bounds = np.append(np.searchsorted(group_s, unique_groups, "left"),
                       len(group_s))
    hull = np.zeros(n_seg)
    for k in range(n_seg):
        try:
            hull[k] = ConvexHull(coords[bounds[k]:bounds[k + 1]]).volume
        except QhullError:
            hull[k] = 0.0
    sx, sy = std("x"), std("y")
    out = {
        "frame": mean("frame").astype(np.float32),
        "std_frame": std("frame").astype(np.float32),
        "x": mean("x").astype(np.float32),
        "y": mean("y").astype(np.float32),
        "std_x": sx.astype(np.float32),
        "std_y": sy.astype(np.float32),
    }
    if has_z:
        if "lpx" in names and "lpy" in names:
            w = 1.0 / (locs["lpx"] + locs["lpy"]) ** 2
        else:  # imported data without precisions: the plain mean
            w = np.ones(len(locs))
        wz = locs["z"] * w
        ws = torch.from_numpy(np.stack([wz, w], 1).astype(np.float64)[
            order]).to(device)
        wsum = torch.zeros((n_seg, 2), dtype=torch.float64,
                           device=device).index_add_(0, seg, ws).cpu().numpy()
        out["z"] = (wsum[:, 0].astype(wz.dtype) / wsum[:, 1].astype(w.dtype)
                    ).astype(np.float32)
    for c in ("photons", "sx", "sy", "bg"):
        if c in mean_cols:
            out[c] = mean(c).astype(np.float32)
    out["lpx"] = (sx / np.sqrt(n_locs)).astype(np.float32)
    out["lpy"] = (sy / np.sqrt(n_locs)).astype(np.float32)
    if has_z:
        sz = std("z")
        out["lpz"] = (sz / np.sqrt(n_locs)).astype(np.float32)
        out["std_z"] = sz.astype(np.float32)
    out["ellipticity"] = (mean("sx") / mean("sy") if "sx" in mean_cols
                          and "sy" in mean_cols else np.ones(n_seg)
                          ).astype(np.float32)
    out["net_gradient"] = (mean("net_gradient") if "net_gradient" in mean_cols
                           else np.zeros(n_seg)).astype(np.float32)
    out["n_locs"] = n_locs.astype(np.uint32)
    out["n_events"] = n_events.astype(np.int32)
    if has_z:
        out["volume"] = (np.power((sx + sy + sz / pixelsize) / 3 * 2, 3)
                         * 4.18879).astype(np.float32)
    else:
        out["area"] = (np.power(sx + sy, 2) * np.pi).astype(np.float32)
    out["convexhull"] = hull.astype(np.float32)
    out["group"] = unique_groups.astype(np.int32)
    if "group_input" in names:
        # pandas' first: the first row of each group in the table's order
        out["group_input"] = srt["group_input"][starts].astype(np.int32)
    table = np.empty(n_seg, [(k, v.dtype) for k, v in out.items()])
    for k, v in out.items():
        table[k] = v
    return table


# ---------------------------------------------------------------------------
# Cluster areas and the subclustering test
# ---------------------------------------------------------------------------


def _cluster_area(X: np.ndarray, lp: float) -> float:
    """Otsu-thresholded rendered area (2D, in LP^2) or volume (3D, in
    LP^3) of one cluster (picasso/clusterer.py:1068), on the host."""
    bin_size = lp / 2
    steps = [bin_size, bin_size] + ([bin_size * 2.5] if X.shape[1] == 3
                                    else [])
    edges = [np.arange(X[:, k].min(), X[:, k].max() + s, s)
             for k, s in enumerate(steps)]
    image = gaussian_filter(np.histogramdd(X, bins=edges)[0], sigma=2)
    thresh = masking.threshold_otsu(image.reshape(-1))
    return np.sum(image >= thresh) / (16 / 5 if X.shape[1] == 3 else 4)


def cluster_areas(locs: np.ndarray, info: list[dict],
                  progress: Callable[[int], None] | None = None
                  ) -> np.ndarray:
    """Per-cluster areas (``Area (LP^2)``) or volumes (``Volume (LP^3)``)
    by Otsu thresholding of each cluster's render on a grid of half the
    median localization precision (picasso/clusterer.py:1112); the
    clusters in sorted order, on the host."""
    if "group" not in locs.dtype.names:
        raise ValueError("Localizations must contain 'group' column.")
    pixelsize = lib.get_from_metadata(info, "Pixelsize", raise_error=True)
    has_z = "z" in locs.dtype.names
    lp = float(np.median((locs["lpx"] + locs["lpy"]) / 2.0))
    order = np.argsort(locs["group"], kind="stable")
    srt = locs[order]
    ids, first = np.unique(srt["group"], return_index=True)
    bounds = np.append(first, len(srt))
    coords = _columns(srt, ["x", "y", "z"] if has_z else ["x", "y"]
                      ).astype(np.float64)
    if has_z:
        coords[:, 2] = coords[:, 2] / pixelsize
    values = []
    for k in range(len(ids)):
        values.append(_cluster_area(coords[bounds[k]:bounds[k + 1]], lp))
        if progress is not None:
            progress(k + 1)
    key = "Volume (LP^3)" if has_z else "Area (LP^2)"
    out = np.empty(len(ids), [("group", np.int32), (key, np.float32)])
    out["group"] = ids
    out[key] = values
    return out


def test_subclustering(mols: np.ndarray, info: list[dict],
                       clustering_dist: float = 25, sparse_dist: float = 80,
                       *, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """The binding events of clustered molecules (first neighbour closer
    than ``clustering_dist`` nm) and of sparse ones (at least
    ``sparse_dist`` nm), to detect subclustering (Kowalewski, Reinhardt
    et al.; picasso/clusterer.py:1172). The first-neighbour distances on
    ``device`` (``knn_d2``), their roots on the host."""
    if "n_events" not in mols.dtype.names:
        raise ValueError("The input molecules must have n_events attribute.")
    if not sparse_dist > clustering_dist:
        raise ValueError("The sparse distance must be larger than the "
                         "clustering distance.")
    device = lib.resolve_device(device)
    pixelsize = lib.get_from_metadata(info, "Pixelsize", raise_error=True)
    if "z" in mols.dtype.names:
        coords = _columns(mols, ("x", "y", "z"))
        coords[:, 2] /= pixelsize
    else:
        coords = _columns(mols, ("x", "y"))
    pts = torch.from_numpy(np.ascontiguousarray(coords)).to(device)
    nnd1 = np.sqrt(neighbors.knn_d2(pts, pts, 2)[:, 1].cpu().numpy())
    close = np.nonzero(nnd1 < clustering_dist / pixelsize)[0]
    far = np.nonzero(nnd1 >= sparse_dist / pixelsize)[0]
    return mols["n_events"][close], mols["n_events"][far]


test_subclustering.__test__ = False  # not a pytest test


def cluster_center(grouplocs: np.ndarray, pixelsize: float | None = None,
                   separate_lp: bool = False, *, device="cuda") -> list:
    """Deprecated single-group center (picasso/clusterer.py:900): the one
    row of :func:`find_cluster_centers` of ``grouplocs`` as one group, as
    a list of floats (pandas' row of mixed columns is f64)."""
    locs = lib.append_to_rec(grouplocs, np.zeros(len(grouplocs), np.int64),
                             "group")
    row = find_cluster_centers(locs, pixelsize, device=device)[0]
    return [float(row[n]) for n in row.dtype.names]
