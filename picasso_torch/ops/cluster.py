"""The clustering passes on a torch device: the SMLM clusterer's label
sweep, DBSCAN's connected components and HDBSCAN's minimum spanning tree.

Counterpart of picasso_tpu/native/picasso_native.cpp:392-417 and
:433-456 (the label sweep of cluster_smlm and cluster_label_sweep) and of
the sklearn calls of picasso_tpu/clusterer.py:283 (DBSCAN) and :350
(HDBSCAN), which the port does without:

- :func:`sweep`: maxima in ascending index; an unassigned maximum
  overwrites its neighbourhood with its number, an assigned one fills
  its unassigned neighbours. Sequential, so on a CUDA tensor the
  maxima's neighbour lists are read back and swept by
  ``picasso_cluster_sweep`` (csrc/cluster_sweep.cu, host code built into
  the kernel library); on a CPU tensor by its Python twin
  :func:`sweep_plain`. ``sweep.launches`` counts the library's sweeps.
- :func:`dbscan_labels`: sklearn's ``dbscan_inner`` labels: a point is
  core when its neighbours (itself included) number at least
  ``min_samples``; the core points' components by min-label propagation
  over core-core pairs with pointer jumping, to a fixed point; clusters
  numbered by the rank of their lowest core index (sklearn grows them
  from the lowest unlabelled core point up); a border point takes the
  lowest cluster among its core neighbours (the first cluster to reach
  it). Pairs are tested in f64 from the coordinates, d^2 <= eps^2, as
  sklearn's KDTree tests them.
- :func:`prim_mst`: sklearn's ``mst_from_data_matrix`` (Prim's algorithm
  over the mutual reachability max(core_i, core_j, d_ij)), one O(N)
  vector step a node on the device, the node that joins the first index
  among equal reachabilities, as that loop's strict ``<`` picks it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from picasso_torch import _build
from picasso_torch.ops.neighbors import (
    PAIR_BUDGET, pair_d2, pairs, radius_count,
)


def sweep_plain(lm_idx: np.ndarray, starts: np.ndarray, stops: np.ndarray,
                cols: np.ndarray, n: int) -> np.ndarray:
    """The label sweep in Python (the plain version of
    csrc/cluster_sweep.cu): labels (n,) int32, -1 where no maximum
    reached."""
    labels = np.full(n, -1, np.int32)
    for k, (i, lo, hi) in enumerate(zip(lm_idx.tolist(), starts.tolist(),
                                        stops.tolist())):
        nbrs = cols[lo:hi]
        if labels[i] == -1:
            labels[nbrs] = k
            labels[i] = k
        else:
            labels[nbrs[labels[nbrs] == -1]] = labels[i]
    return labels


def sweep(lm_idx: torch.Tensor, starts: torch.Tensor, stops: torch.Tensor,
          cols: torch.Tensor, n: int) -> np.ndarray:
    """Labels (n,) int32 of the sweep over the maxima ``lm_idx`` with
    their neighbour CSR, all int64 on one device: a CPU tensor takes
    :func:`sweep_plain`, a CUDA tensor is read back and swept by the
    built library's ``picasso_cluster_sweep``."""
    if lm_idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no cluster sweep for tensors on {lm_idx.device}")
    args = [np.ascontiguousarray(t.cpu().numpy(), np.int64)
            for t in (lm_idx, starts, stops, cols)]
    if lm_idx.device.type == "cpu":
        return sweep_plain(*args, n)
    lm, lo, hi, nb = args
    if len(lo) != len(lm) or len(hi) != len(lm) or (len(lm) and (
            lm.min() < 0 or lm.max() >= n or lo.min() < 0
            or hi.max() > len(nb) or (len(nb) and (
                nb.min() < 0 or nb.max() >= n)))):
        raise ValueError("malformed maxima or CSR for the cluster sweep")
    labels = np.full(n, -1, np.int32)
    status = _build.library().picasso_cluster_sweep(
        *(a.ctypes.data_as(ctypes.c_void_p) for a in args), len(lm),
        labels.ctypes.data_as(ctypes.c_void_p))
    _build.count_launch(sweep)
    _build.check(status, "cluster_sweep")
    return labels


sweep.launches = 0


def dbscan_labels(X: torch.Tensor, eps: float, min_samples: int,
                  budget: int = PAIR_BUDGET) -> tuple[torch.Tensor, int]:
    """sklearn's DBSCAN labels (n,) int64 of the f64 points ``X`` (n, 2|3)
    on their device, and the number of passes over the pairs that the
    components took to reach their fixed point."""
    n = len(X)
    r2 = float(eps) * float(eps)
    dev = X.device
    counts = 1 + radius_count(X[:, 0], X[:, 1], eps, budget,
                              X[:, 2] if X.shape[1] == 3 else None)
    core = counts >= min_samples
    label = torch.arange(n, device=dev)
    border = torch.full((n,), n, dtype=torch.int64, device=dev)
    passes = 0
    while True:
        passes += 1
        before = label.clone()
        border.fill_(n)
        for i, j in pairs(X, eps, budget):
            ok = pair_d2(X, i, j) <= r2
            ci, cj = core[i] & ok, core[j] & ok
            a, b = label[i], label[j]
            # hook the higher of two core labels onto the lower (pairs
            # whose labels agree have nothing to do: compacted away, so
            # that no address takes a blob's worth of atomics)
            hook = torch.nonzero(ci & cj & (a != b))[:, 0]
            low = torch.minimum(a[hook], b[hook])
            label.scatter_reduce_(0, a[hook], low, "amin")
            label.scatter_reduce_(0, b[hook], low, "amin")
            # a point in reach of a core point: the lowest core label
            edge = torch.nonzero(ci ^ cj)[:, 0]
            border.scatter_reduce_(0, torch.where(ci, j, i)[edge],
                                   torch.where(ci, a, b)[edge], "amin")
        while True:  # pointer jumping
            jumped = label[label]
            if torch.equal(jumped, label):
                break
            label = jumped
        if torch.equal(label, before):
            break
    ids = torch.unique(label[core])
    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    out[core] = torch.searchsorted(ids, label[core])
    reached = ~core & (border < n)
    out[reached] = torch.searchsorted(ids, border[reached])
    return out, passes


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f64 root that sklearn takes: the card's; on
    the CPU numpy's (torch's f64 sqrt on the CPU is not always correctly
    rounded)."""
    if t.device.type == "cpu":
        return torch.from_numpy(np.sqrt(t.numpy()))
    return torch.sqrt(t)


def prim_mst(X: torch.Tensor, core: torch.Tensor):
    """sklearn's ``mst_from_data_matrix`` of the f64 points ``X`` (n, D)
    and their f64 core distances ``core`` (n,), on their device: the
    edges (source, node, mutual reachability) in the order Prim's loop
    adds them, as numpy arrays int64, int64, f64. A node that joins the
    tree gets NaN coordinates, so its reachability is NaN and never
    updates again, and +inf as its own, so that the argmin passes over
    it."""
    n, D = X.shape
    dev = X.device
    P = torch.cat([X, core[:, None]], 1).to(torch.float64).contiguous()
    reach = torch.full((n,), torch.inf, dtype=torch.float64, device=dev)
    source = torch.zeros(n, dtype=torch.int64, device=dev)
    out_node = torch.zeros(max(n - 1, 0), dtype=torch.int64, device=dev)
    out_src = torch.zeros_like(out_node)
    out_d = torch.zeros(max(n - 1, 0), dtype=torch.float64, device=dev)
    cur = torch.zeros(1, dtype=torch.int64, device=dev)
    for step in range(n - 1):
        pc = P.index_select(0, cur)
        P.index_fill_(0, cur, torch.nan)
        reach.index_fill_(0, cur, torch.inf)
        d2 = None
        for c in range(D):
            d = P[:, c] - pc[:, c]
            d2 = d * d if d2 is None else d2 + d * d
        mrd = torch.maximum(torch.maximum(_sqrt(d2), pc[:, D]), P[:, D])
        source = torch.where(mrd < reach, cur, source)
        reach = torch.fmin(reach, mrd)
        cur = torch.argmin(reach, 0, keepdim=True)
        out_node[step:step + 1] = cur
        out_src[step:step + 1] = source[cur]
        out_d[step:step + 1] = reach[cur]
    return out_src.cpu().numpy(), out_node.cpu().numpy(), out_d.cpu().numpy()
