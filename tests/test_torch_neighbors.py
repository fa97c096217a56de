"""The port's pair search (picasso_torch/ops/neighbors.py, and the window
pairs of ops/link.py) held against scipy's cKDTree and against
picasso_tpu's cKDTree route on the CPU: compute_local_density,
distance_histogram, pair_correlation and nn_analysis.

Everything here is exact: the counts, the histograms and the
nearest-neighbour distances equal cKDTree's (distances in f64 from the
coordinates, compared as squares against the squared radius, the roots
by numpy). The inputs put points exactly on cell edges, at negative
coordinates, all in one cell, and split the candidates into chunks of a
few pairs.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial import cKDTree

from picasso_tpu import postprocess as jpost
from picasso_torch import postprocess as tpost
from picasso_torch.ops import link as link_ops
from picasso_torch.ops import neighbors
from torch_data import make_event_locs


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _edge_points(n: int, seed: int, step: float) -> tuple[np.ndarray, ...]:
    """f32 points on a lattice of ``step`` (the cell edges of a radius
    ``step``), some a float ulp off it, at negative and positive
    coordinates."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-6, 7, (n, 2)).astype(np.float32)
    x = k[:, 0] * np.float32(step)
    y = k[:, 1] * np.float32(step)
    nudge = rng.choice([0, 0, 1, -1], n)
    x = np.where(nudge == 1, np.nextafter(x, np.float32(np.inf)),
                 np.where(nudge == -1, np.nextafter(x, np.float32(-np.inf)),
                          x))
    return x.astype(np.float32), y.astype(np.float32)


def _scattered(n: int, seed: int, size: float = 20.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-size / 4, size, n).astype(np.float32),
            rng.uniform(-size / 4, size, n).astype(np.float32))


POINTS = {
    "edges": lambda: _edge_points(500, 0, 0.5),
    "scattered": lambda: _scattered(2000, 1),
    "one cell": lambda: tuple(a * np.float32(0.01) for a in _scattered(300, 2)),
}


@pytest.mark.parametrize("points", list(POINTS))
@pytest.mark.parametrize("radius,budget", [(0.5, 1 << 24), (0.5, 5),
                                           (1.3, 97), (0.0, 1 << 24)])
def test_radius_count_equals_query_ball_point(points, radius, budget):
    x, y = POINTS[points]()
    pts = np.column_stack([x, y])
    want = cKDTree(pts).query_ball_point(pts, radius, return_length=True) - 1
    got = neighbors.radius_count(_t(x), _t(y), radius, budget).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("points", list(POINTS))
@pytest.mark.parametrize("bin_size,r_max,budget", [(0.5, 2.0, 1 << 24),
                                                   (0.1, 3.3, 11),
                                                   (0.013, 1.0, 1000)])
def test_pair_histogram_equals_the_kdtree_route(points, bin_size, r_max,
                                                budget):
    """JAX's CPU route (count_neighbors just below each linspace edge)
    on the same points; every pair once."""
    x, y = POINTS[points]()
    locs = np.zeros(len(x), [("x", np.float32), ("y", np.float32)])
    locs["x"], locs["y"] = x, y
    n_bins = int(np.uint32(r_max / bin_size))
    info = [{"Width": 1e6, "Height": 1e6, "Frames": 1}]
    # the JAX route's sanity filter drops the negative coordinates
    want = jpost.distance_histogram(pd.DataFrame.from_records(locs), info,
                                    bin_size, r_max)
    sane = locs[(x >= 0) & (y >= 0)]
    got = neighbors.pairwise_distance_histogram(_t(sane["x"]), _t(sane["y"]),
                                                bin_size, n_bins, budget)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("blocks", [(4096, 4096), (7, 5)])
def test_knn_equals_kdtree_query(k, blocks):
    a_chunk, b_block = blocks
    x, y = _scattered(600, 3)
    pts = np.column_stack([x, y])
    b = pts[::3]
    d2 = neighbors.knn_d2(_t(pts), _t(b), k, a_chunk=a_chunk,
                          b_block=b_block).numpy()
    want = cKDTree(b).query(pts, k)[0].reshape(-1, k)
    np.testing.assert_array_equal(np.sqrt(d2), want)
    # fewer points than k: inf, as cKDTree
    few = neighbors.knn_d2(_t(pts[:4]), _t(b[:2]), 3).numpy()
    np.testing.assert_array_equal(np.sqrt(few),
                                  cKDTree(b[:2]).query(pts[:4], 3)[0])


def test_knn_with_labels_is_per_label():
    x, y = _scattered(400, 4)
    pts = np.column_stack([x, y, np.float32(0.1) * x])
    lab = np.random.default_rng(4).integers(0, 5, len(pts))
    d2 = neighbors.knn_d2(_t(pts), _t(pts), 2, labels_a=_t(lab),
                          labels_b=_t(lab), a_chunk=64, b_block=50).numpy()
    for g in range(5):
        sel = lab == g
        np.testing.assert_array_equal(
            np.sqrt(d2[sel]), cKDTree(pts[sel]).query(pts[sel], 2)[0])


def test_window_pairs_are_every_pair_of_touching_cells():
    """ops/link.window_pairs: the pairs of one group in the next
    ``window`` frames, a superset of those within the radius, no pair
    twice and none outside the window."""
    locs = make_event_locs(13, n_sites=12, frames=60, size=10)[0]
    frame = locs["frame"].astype(np.int64)
    g = locs["group"].astype(np.int64)
    x, y = locs["x"].astype(np.float64), locs["y"].astype(np.float64)
    pairs = np.concatenate([np.stack([i.numpy(), j.numpy()], 1) for i, j in
                            link_ops.window_pairs(_t(frame), _t(x), _t(y),
                                                  _t(g), 1.0, 2, budget=13)])
    assert len(np.unique(pairs, axis=0)) == len(pairs)
    i, j = pairs.T
    assert np.all((frame[j] > frame[i]) & (frame[j] <= frame[i] + 2)
                  & (g[i] == g[j]))
    for a in range(len(locs)):
        near = np.nonzero((frame > frame[a]) & (frame <= frame[a] + 2)
                          & (g == g[a]) & ((x - x[a]) ** 2 + (y - y[a]) ** 2
                                           <= 1.0))[0]
        assert set(near) <= set(j[i == a])


def test_cell_key_too_wide_raises():
    x = torch.tensor([0.0, 1e9])
    with pytest.raises(ValueError, match="bits"):
        neighbors.CellIndex(x, x, 1e-3, lead=[(torch.zeros(2, dtype=torch.int64),
                                                2**20)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("radius", [0.1, 0.5])
def test_local_density_matches_jax(dtype, radius):
    locs, info = make_event_locs(14, n_sites=40, size=24)
    locs = locs.astype([(n, dtype if n in ("x", "y") else locs.dtype[n])
                        for n in locs.dtype.names])
    locs["x"][:5] = -1.0  # dropped by the sanity filter on both sides
    got = tpost.compute_local_density(locs, info, radius, device="cpu")
    want = jpost.compute_local_density(pd.DataFrame.from_records(locs), info,
                                       radius).to_records(index=False)
    assert got.dtype.names == want.dtype.names
    for n in got.dtype.names:
        assert got.dtype[n] == want.dtype[n]
        np.testing.assert_array_equal(got[n], want[n])
    assert got["density"].max() > 10
    again = tpost.compute_local_density(got, info, radius, device="cpu")
    assert again.dtype.names == got.dtype.names


@pytest.mark.parametrize("bin_size,r_max", [(0.1, 10.0), (0.05, 3.3)])
def test_pair_correlation_matches_jax(bin_size, r_max):
    locs, info = make_event_locs(15, n_sites=40, size=24)
    df = pd.DataFrame.from_records(locs)
    np.testing.assert_array_equal(
        tpost.distance_histogram(locs, info, bin_size, r_max, device="cpu"),
        jpost.distance_histogram(df, info, bin_size, r_max))
    for a, b in zip(tpost.pair_correlation(locs, info, bin_size, r_max,
                                           device="cpu"),
                    jpost.pair_correlation(df, info, bin_size, r_max)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("k", [1, 2])
def test_nn_analysis_matches_jax(dims, k):
    rng = np.random.default_rng(16)
    X = rng.uniform(0, 50, (500, dims)).astype(np.float32)
    X[10] = X[11]  # a duplicate point
    for X1, X2 in ((X, X), (X[:120], X[60:])):
        got = tpost.nn_analysis(X1, X2, k, device="cpu")
        np.testing.assert_array_equal(got, jpost.nn_analysis(X1, X2, k))
    with pytest.raises(ValueError, match="dimensions"):
        tpost.nn_analysis(X[:, :2], X[:, :1], 1, device="cpu")
