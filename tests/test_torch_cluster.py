"""Clustering of the port held against picasso_tpu on the CPU: the SMLM
clusterer (picasso_torch.clusterer.cluster, frame_analysis, the label
sweep's Python twin, ops/neighbors.cluster_counts, radius_max and
neighbour_lists), DBSCAN and HDBSCAN (sklearn through JAX; the port has
no sklearn), find_cluster_centers, cluster_areas, test_subclustering,
cluster_center and postprocess.resi.

Inputs: tests/torch_data.make_event_locs (DNA-PAINT sites, precisions
0.03-0.1 px), with a z column (nm) for 3D.

Tolerances, with what was measured on the CPU (numpy 2, pandas 3,
sklearn 1.9, torch 2.13):
- labels, clustered tables and info blocks equal (SMLM on JAX's native
  route; DBSCAN and HDBSCAN on sklearn's). The native core may fuse
  dx*dx + dy*dy into a multiply-add where the port rounds the product
  first, so each SMLM case prints the pairs whose f32 d^2 lies within 4
  f32 ulps of r^2, where the two could part;
- cluster centers: integer columns equal, float columns within
  MEAN_ULPS f32 ulps (pandas sums an f32 mean in f32 with Kahan
  compensation, the port in f64 rounded once, as groupprops; measured 1
  over 16 tables); the lp-weighted z within CENTERS_ULPS ulps of the
  weighted mean of |z| (its sums cancel, as cluster_combine's weighted
  coordinates do in tests/test_torch_stats.py; measured 2); the
  ellipticity, a ratio of two means below 1 (where one ulp of a mean is
  two of the ratio), held as each table's own sx / sy in f32;
- areas, the subclustering test and cluster_center equal; RESI's table
  as the centers.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial import cKDTree

from picasso_tpu import clusterer as jclust
from picasso_tpu import postprocess as jpost
from picasso_tpu.ops import neighbors as jnb
from picasso_torch import clusterer as tclust
from picasso_torch import postprocess as tpost
from picasso_torch.ops import cluster as cluster_ops
from picasso_torch.ops import neighbors as tnb
from torch_data import make_event_locs
from torch_native import loaded_native
from torch_parity import CENTERS_ULPS

MEAN_ULPS = 2
PIXELSIZE = 130


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _df(locs):
    return pd.DataFrame.from_records(locs)


def _records(df):
    return df.to_records(index=False)


def _locs(seed: int, z: bool = False, n_sites: int = 40, frames: int = 800,
          size: int = 24):
    """make_event_locs without its group field, with z (nm: a depth a
    site from its position, a spread of 30 nm) when ``z``."""
    locs, info = make_event_locs(seed, n_sites=n_sites, frames=frames,
                                 size=size)
    names = [n for n in locs.dtype.names if n != "group"]
    fields = [(n, locs.dtype[n]) for n in names]
    if z:
        fields.insert(3, ("z", np.float32))
    out = np.empty(len(locs), fields)
    for n in names:
        out[n] = locs[n]
    if z:
        rng = np.random.default_rng(seed + 100)
        depth = 300 * np.sin(np.round(locs["x"]) + np.round(locs["y"]))
        out["z"] = depth + rng.normal(0, 30, len(locs))
    return out, info


def boundary_pairs(X: np.ndarray, radius: float, ulps: int = 4) -> int:
    """Pairs whose f32 d^2 (summed as the native core sums it) lies within
    ``ulps`` f32 ulps of radius^2: where a fused multiply-add in the
    native build could put a pair on the other side of the radius."""
    X = np.ascontiguousarray(X, np.float32)
    ij = cKDTree(X.astype(np.float64)).query_pairs(radius * 1.01,
                                                   output_type="ndarray")
    d = X[ij[:, 0]] - X[ij[:, 1]]
    d2 = np.zeros(len(ij), np.float32)
    for c in range(X.shape[1]):
        d2 = d2 + d[:, c] * d[:, c]
    r2 = np.float32(radius * radius)
    return int(np.count_nonzero(np.abs(d2 - r2) <= ulps * np.spacing(r2)))


# --- the SMLM clusterer -------------------------------------------------


@pytest.mark.parametrize("fa", [False, True], ids=["fa0", "fa1"])
@pytest.mark.parametrize("dims", [2, 3])
def test_smlm_cluster_matches_jax(dims, fa):
    """Labels, the clustered table (z as (z / px) * px in f32) and the
    info block equal JAX's native route."""
    locs, _ = _locs(1 + dims, z=dims == 3)
    kw = dict(radius_z=0.3, pixelsize=PIXELSIZE) if dims == 3 else {}
    got, ginfo = tclust.cluster(locs, 0.1, 5, fa, return_info=True,
                                device="cpu", **kw)
    want, winfo = jclust.cluster(_df(locs), 0.1, 5, fa, return_info=True,
                                 **kw)
    X = np.column_stack([locs["x"], locs["y"]] + (
        [locs["z"] / PIXELSIZE * (0.1 / 0.3)] if dims == 3 else []))
    print(f"SMLM {dims}D fa={fa}: {len(got)} of {len(locs)} locs clustered, "
          f"{boundary_pairs(X, 0.1)} pairs within 4 ulps of r^2")
    want = _records(want)
    assert got.dtype == want.dtype
    for n in got.dtype.names:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert ginfo == winfo
    assert got["group"].dtype == np.int32 and len(np.unique(got["group"])) > 3


def test_frame_analysis_matches_jax_on_its_boundaries():
    """Clusters whose mean frame sits at exactly 0.2 and 0.8 of the
    acquisition (kept) and just outside (dropped), one with 80% of its
    locs in one bin (kept) and one with more (dropped), and unlabelled
    locs that set n_frames."""
    frame = np.array([0, 2, 38, 40, 41, 39, 160, 160, 159, 161, 10, 10, 10,
                      10, 90, 50, 50, 50, 50, 51, 199], np.uint32)
    labels = np.array([0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 4, 4, 5, 5, 5,
                       5, 5, -1], np.int32)
    got = tclust.frame_analysis(labels, frame)
    want = jclust.frame_analysis(labels, frame)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert set(np.unique(got)) != set(np.unique(labels))


def test_sweep_twin_matches_the_native_sweep():
    """ops/cluster.sweep_plain (and sweep on CPU tensors) == picasso_tpu
    native.cluster_label_sweep on random maxima with overlapping
    neighbourhoods."""
    rng = np.random.default_rng(5)
    n, m = 400, 60
    lm = np.sort(rng.choice(n, m, replace=False)).astype(np.int64)
    sizes = rng.integers(0, 40, m)
    stops = np.cumsum(sizes).astype(np.int64)
    starts = stops - sizes
    cols = rng.integers(0, n, int(sizes.sum())).astype(np.int64)
    want = np.full(n, -1, np.int32)
    loaded_native().cluster_label_sweep(lm, starts, stops, cols, want)
    np.testing.assert_array_equal(
        cluster_ops.sweep_plain(lm, starts, stops, cols, n), want)
    before = cluster_ops.sweep.launches
    got = cluster_ops.sweep(*(torch.from_numpy(a) for a in (
        lm, starts, stops, cols)), n)
    np.testing.assert_array_equal(got, want)
    assert cluster_ops.sweep.launches == before  # the library's sweeps only


@pytest.mark.parametrize("dims", [2, 3])
def test_counts_and_radius_max_match_jax(dims):
    """cluster_counts == JAX's radius_count (the point itself included)
    and radius_max == JAX's radius_max of the counts, at a radius whose
    square is the same in f32 and f64 (JAX compares with f32(r)^2, the
    native core with r * r in f64)."""
    locs, _ = _locs(7, z=dims == 3, n_sites=30, frames=400)
    X = np.column_stack([locs["x"], locs["y"]] + (
        [locs["z"] / 400] if dims == 3 else [])).astype(np.float32)
    r = 0.125
    print(f"{dims}D: {boundary_pairs(X, r)} pairs within 4 ulps of r^2")
    Xt = torch.from_numpy(X)
    counts = tnb.cluster_counts(Xt, r, budget=4096)
    np.testing.assert_array_equal(counts.numpy(), jnb.radius_count(X, X, r))
    want = jnb.radius_max(X, X, r, counts.numpy().astype(np.float32))
    np.testing.assert_array_equal(tnb.radius_max(Xt, r, counts, budget=4096)
                                  .numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dims", [2, 3])
def test_neighbour_lists_are_the_native_pairs(dims):
    """The CSR of a subset of rows: each row's neighbours (itself left
    out) are the points the native test accepts, brute force in numpy."""
    locs, _ = _locs(8, z=dims == 3, n_sites=20, frames=300)
    X = np.column_stack([locs["x"], locs["y"]] + (
        [locs["z"] / 400] if dims == 3 else [])).astype(np.float32)
    rows = np.sort(np.random.default_rng(0).choice(len(X), 50, replace=False))
    starts, stops, cols = tnb.neighbour_lists(
        torch.from_numpy(X), 0.1, torch.from_numpy(rows), budget=1000)
    for k, i in enumerate(rows):
        d = X - X[i]
        d2 = np.zeros(len(X), np.float32)
        for c in range(dims):
            d2 = d2 + d[:, c] * d[:, c]
        want = np.nonzero(d2.astype(np.float64) <= 0.1 * 0.1)[0]
        got = np.sort(cols[starts[k]:stops[k]].numpy())
        np.testing.assert_array_equal(got, want[want != i])


# --- DBSCAN and HDBSCAN -------------------------------------------------


@pytest.mark.parametrize("case", ["2d", "3d", "3d-radius_z", "min_locs"])
def test_dbscan_matches_sklearn_through_jax(case):
    """The port's DBSCAN (no sklearn) == sklearn's through JAX: labels,
    the clustered table and the info block."""
    locs, _ = _locs(11, z=case.startswith("3d"))
    kw = {"3d": dict(pixelsize=PIXELSIZE),
          "3d-radius_z": dict(pixelsize=PIXELSIZE, radius_z=0.25),
          "min_locs": dict(min_locs=60)}.get(case, {})
    got, ginfo = tclust.dbscan(locs, 0.08, 8, return_info=True, device="cpu",
                               **kw)
    want, winfo = jclust.dbscan(_df(locs), 0.08, 8, return_info=True, **kw)
    want = _records(want)
    assert got.dtype == want.dtype and len(got) == len(want)
    for n in got.dtype.names:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert ginfo == winfo
    assert winfo["Number of clusters"] > 3


def test_dbscan_border_points_take_the_lowest_cluster():
    """Two clusters of core points and a border point in reach of one
    core point of each: it takes the lower cluster (the one whose lowest
    core index is lower), as sklearn's depth-first search gives it."""
    x = np.concatenate([0.2 + np.arange(5) * 0.01, -np.arange(5) * 0.01,
                        [0.1, 3.0]])
    X = np.column_stack([x, np.zeros_like(x)])
    want = jclust._dbscan(X.copy(), 0.105, 5)
    got = tclust._dbscan(X, 0.105, 5, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0] * 5 + [1] * 5 + [0, -1])


@pytest.mark.parametrize("case", ["eps0", "eps0.3", "3d", "lattice"])
def test_hdbscan_matches_sklearn_through_jax(case):
    """The port's HDBSCAN (core distances and Prim's tree in torch, the
    tree in numpy) == sklearn 1.9's labels through JAX. ``lattice`` puts
    the locs on a 0.02 px lattice, where the mutual reachabilities tie
    and Prim's first-index rule and the sort decide."""
    locs, _ = _locs(13, z=case == "3d", n_sites=24, frames=300)
    if case == "lattice":
        for c in ("x", "y"):
            locs[c] = np.round(locs[c] / 0.02) * 0.02
    kw = dict(pixelsize=PIXELSIZE) if case == "3d" else {}
    eps = 0.3 if case == "eps0.3" else 0.0
    got, ginfo = tclust.hdbscan(locs, 10, 10, cluster_eps=eps,
                                return_info=True, device="cpu", **kw)
    want, winfo = jclust.hdbscan(_df(locs), 10, 10, cluster_eps=eps,
                                 return_info=True, **kw)
    want = _records(want)
    assert got.dtype == want.dtype
    for n in got.dtype.names:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert ginfo == winfo
    assert winfo["Number of clusters"] > 3


def test_hdbscan_non_finite_rows_as_sklearn():
    locs, _ = _locs(14, n_sites=10, frames=200)
    X = np.column_stack([locs["x"], locs["y"]]).astype(np.float64)
    X[3, 0], X[10, 1] = np.inf, np.nan
    np.testing.assert_array_equal(tclust._hdbscan(X, 10, 10, device="cpu"),
                                  jclust._hdbscan(X.copy(), 10, 10))


# --- centers, areas, subclustering, RESI ---------------------------------


def compare_centers(got: np.ndarray, want: np.ndarray, locs: np.ndarray
                    ) -> int:
    """Hold the port's centers of ``locs`` to pandas' (see the module's
    tolerances); returns the number of float cells that differ."""
    assert got.dtype == want.dtype and len(got) == len(want)
    differ = 0
    for n in got.dtype.names:
        a, b = got[n], want[n]
        if got.dtype[n].kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=n)
            continue
        if n == "ellipticity" and "sx" in got.dtype.names:
            for t in (got, want):
                np.testing.assert_array_equal(t[n], t["sx"] / t["sy"])
            continue
        ok = ~np.isnan(b)
        np.testing.assert_array_equal(np.isnan(a), ~ok, err_msg=n)
        d = np.abs(a[ok].astype(np.float64) - b[ok])
        if n == "z":
            w = (1.0 / (locs["lpx"] + locs["lpy"]) ** 2 if "lpx" in
                 locs.dtype.names else np.ones(len(locs)))
            inv = np.unique(locs["group"], return_inverse=True)[1]
            scale = (np.bincount(inv, np.abs(locs["z"] * w))
                     / np.bincount(inv, w)).astype(np.float32)
            assert np.all(d <= CENTERS_ULPS * np.spacing(scale[ok])), n
        else:
            assert np.all(d <= MEAN_ULPS * np.spacing(np.abs(b[ok]))), n
        differ += int(np.count_nonzero(d))
    return differ


def _clustered(seed: int, z: bool):
    locs, info = _locs(seed, z=z)
    kw = dict(radius_z=0.3, pixelsize=PIXELSIZE) if z else {}
    return tclust.cluster(locs, 0.1, 5, False, device="cpu", **kw), info


@pytest.mark.parametrize("case", ["2d", "3d", "bare", "group_input",
                                  "3d-no-lp"])
def test_find_cluster_centers_matches_jax(case):
    """Integer columns equal, float columns within CENTERS_ULPS f32 ulps;
    ``bare`` without photons, sx, sy, bg and net_gradient;
    ``group_input`` carries each loc's earlier group."""
    locs, _ = _clustered(17, case.startswith("3d"))
    if case == "bare":
        keep = ["frame", "x", "y", "lpx", "lpy", "group"]
        locs = np.array(locs[keep].tolist(), [(n, locs.dtype[n])
                                              for n in keep])
    elif case == "group_input":
        locs = tpost._with_fields(locs, [("group_input", (
            locs["group"] * 7 + locs["frame"] % 3).astype(np.int32))])
    elif case == "3d-no-lp":
        keep = [n for n in locs.dtype.names if n not in ("lpx", "lpy")]
        locs = np.array(locs[keep].tolist(), [(n, locs.dtype[n])
                                              for n in keep])
    px = PIXELSIZE if case.startswith("3d") else None
    got = tclust.find_cluster_centers(locs, px, device="cpu")
    want = _records(jclust.find_cluster_centers(_df(locs), px))
    differ = compare_centers(got, want, locs)
    print(f"{case}: {len(got)} clusters, {differ} float cells differ")


@pytest.mark.parametrize("dims", [2, 3])
def test_cluster_areas_match_jax(dims):
    """Equal to JAX's cluster_areas in 2D. In 3D JAX's raises here (it
    writes z / pixelsize into the read-only array pandas 3 gives,
    picasso_tpu/clusterer.py:626), so the port is held to JAX's
    _cluster_area of each cluster's points, taken as that function
    meant them."""
    locs, info = _clustered(19, dims == 3)
    got = tclust.cluster_areas(locs, info)
    if dims == 2:
        want = _records(jclust.cluster_areas(_df(locs), info))
    else:
        lp = float(np.median((locs["lpx"] + locs["lpy"]) / 2.0))
        ids = np.unique(locs["group"])
        want = np.empty(len(ids), [("group", np.int32),
                                   ("Volume (LP^3)", np.float32)])
        want["group"] = ids
        for k, g in enumerate(ids):
            pts = np.column_stack([locs[c][locs["group"] == g] for c in
                                   "xyz"]).astype(np.float64)
            pts[:, 2] = pts[:, 2] / PIXELSIZE
            want["Volume (LP^3)"][k] = jclust._cluster_area(pts, lp)
    assert got.dtype == want.dtype
    for n in got.dtype.names:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


@pytest.mark.parametrize("dims", [2, 3])
def test_subclustering_matches_jax(dims):
    locs, info = _clustered(23, dims == 3)
    centers = tclust.find_cluster_centers(
        locs, PIXELSIZE if dims == 3 else None, device="cpu")
    for dist in ((25, 80), (60, 200)):
        got = tclust.test_subclustering(centers, info, *dist, device="cpu")
        want = jclust.test_subclustering(_df(centers), info, *dist)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(got[0]) + len(got[1]) > 0


@pytest.mark.parametrize("dims", [2, 3])
def test_cluster_center_matches_jax(dims):
    locs, _ = _clustered(29, dims == 3)
    one = locs[locs["group"] == locs["group"][0]]
    px = PIXELSIZE if dims == 3 else None
    got = tclust.cluster_center(one, px, device="cpu")
    want = jclust.cluster_center(_df(one), px)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=MEAN_ULPS * 2.0**-23)


def test_resi_matches_jax(tmp_path):
    """Two channels (the second a copy moved by 0.02 px and another
    seed's locs), each clustered with frame analysis; the table within
    the centers' ulps, the info block and the files written equal."""
    a, info = _locs(31)
    b, _ = _locs(37)
    b["x"] += 0.02
    args = ([a, b], [info, info])
    kw = dict(radius_xy=0.1, min_locs=[5, 6], apply_fa=True,
              save_clustered_locs=True, save_cluster_centers=True)
    paths = {d: [str(tmp_path / f"{d}{k}.hdf5") for k in range(2)]
             for d in "tj"}
    got, ginfo = tpost.resi(*args, **kw, output_paths=paths["t"],
                            resi_path=str(tmp_path / "t_resi.hdf5"),
                            device="cpu")
    want, winfo = jpost.resi([_df(a), _df(b)], args[1], **kw,
                             output_paths=paths["j"],
                             resi_path=str(tmp_path / "j_resi.hdf5"))
    keys = [(c, g) for c, t in enumerate((a, b)) for g in np.unique(
        tclust.cluster(t, 0.1, [5, 6][c], True, device="cpu")["group"])]
    assert [tuple(k) for k in got[["resi_channel_id", "cluster_id"]]
            .tolist()] == keys
    want = _records(want)
    for n in got.dtype.names:
        if n == "ellipticity":
            np.testing.assert_array_equal(got[n], got["sx"] / got["sy"])
        elif got.dtype[n].kind == "f":
            ok = ~np.isnan(want[n])
            assert np.all(np.abs(got[n][ok].astype(np.float64) - want[n][ok])
                          <= MEAN_ULPS * np.spacing(np.abs(want[n][ok]))), n
        else:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert got.dtype == want.dtype
    assert ginfo == winfo
    assert set(got["resi_channel_id"]) == {0, 1}
    assert sorted(p.name[1:] for p in tmp_path.iterdir() if p.name[0] == "t"
                  ) == sorted(p.name[1:] for p in tmp_path.iterdir()
                              if p.name[0] == "j")


def test_entry_points_need_a_card_by_default(tmp_path):
    """device defaults to cuda, and without a card each entry point and
    verb raises rather than run on the CPU, and writes no file."""
    from picasso_torch import __main__ as cli
    from picasso_torch import io

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    locs, info = _clustered(41, False)
    path = str(tmp_path / "x_locs.hdf5")
    io.save_locs(path, locs, info)
    calls = [
        lambda: tclust.cluster(locs, 0.1, 5, False),
        lambda: tclust.dbscan(locs, 0.1, 5),
        lambda: tclust.hdbscan(locs, 10, 10),
        lambda: tclust.find_cluster_centers(locs),
        lambda: tclust.test_subclustering(
            tclust.find_cluster_centers(locs, device="cpu"), info),
        lambda: tclust.cluster_center(locs),
        lambda: tpost.resi([locs, locs], [info, info], 0.1),
        lambda: cli.main(["smlm_cluster", path, "0.1", "5"]),
        lambda: cli.main(["dbscan", path, "0.1", "5"]),
        lambda: cli.main(["hdbscan", path, "10", "10"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "x_locs.hdf5", "x_locs.yaml"]
