"""Localization statistics of the port held against picasso_tpu on the
CPU: NeNA (postprocess._next_frame_neighbor_distance_histogram, nena),
FRC (frc, masking.threshold_tukey, masking.loess_smooth,
imageprocess.radial_sum), groupprops, cluster_combine,
cluster_combine_dist, lib.merge_locs, io.load_clusters,
io.save_datasets, and the CLI verbs link, dark, density, nneighbor,
clusterfilter, join, groupprops, pc, cluster_combine,
cluster_combine_dist, smlm_cluster, dbscan and hdbscan against the JAX
CLI.

Tolerances, with what was measured on the CPU (numpy 2, pandas 3, torch
2.13):
- NeNA's histogram equal for f32 and f64 columns, its fit parameters
  equal (the same curve_fit on the same numbers);
- FRC: the curve within 1e-9 (measured 1.7e-15: the FFTs are torch's and
  numpy's), the resolution within a relative 1e-6 (measured equal), the
  images, the Tukey mask, the ring sums of one image and the LOESS
  equal;
- groupprops: integer columns equal; float columns within
  GROUPPROPS_ULPS f32 ulps. pandas sums an f32 column's mean in f32 with
  Kahan compensation and divides in f32, and forms a std by Welford's
  recurrence in f64; the port sums in f64 (two passes for the std) and
  rounds once. Measured: means 1 ulp, stds 0 (8 seeds);
- cluster_combine: the photon-weighted coordinates within COMBINE_ULPS
  f32 ulps of the weighted mean of |coordinate| (pandas' f32 Kahan sums
  against the port's f64 sums; measured 2), the rest within one ulp
  (measured equal); cluster_combine_dist equal;
- the CLI's files, HDF5 fields and YAML equal within the same bounds
  (``link`` reads the rows in JAX's quicksort order,
  tests/test_torch_link.py).
"""

from __future__ import annotations

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import imageprocess as jimage
from picasso_tpu import io as jio
from picasso_tpu import lib as jlib
from picasso_tpu import masking as jmask
from picasso_tpu import postprocess as jpost
from picasso_torch import imageprocess as timage
from picasso_torch import io as tio
from picasso_torch import lib as tlib
from picasso_torch import masking as tmask
from picasso_torch import postprocess as tpost
from test_torch_cluster import compare_centers
from test_torch_link import _f64, jax_order
from torch_data import make_event_locs

FRC_CURVE = 1e-9
FRC_RES_REL = 1e-6
GROUPPROPS_ULPS = 2
COMBINE_ULPS = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _df(locs):
    return pd.DataFrame.from_records(locs)


def _linked(seed, f64=False, frames=1500):
    """Events with dark times (link at d_max 1 px, tolerance 1, then
    dark) of make_event_locs(seed)."""
    locs, info = make_event_locs(seed, n_sites=30, frames=frames)
    if f64:
        locs = _f64(locs, seed)
    linked = tpost.link(jax_order(locs), info, r_max=1.0, max_dark_time=1,
                        device="cpu")
    return tpost.compute_dark_times(linked, device="cpu"), info


def _ulps(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref)
    both_nan = np.isnan(got) & np.isnan(ref)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    d = np.abs(got - ref) / np.spacing(np.abs(ref).astype(np.float32))
    return float(np.max(np.where(both_nan, 0, d), initial=0))


def _cluster_locs(seed: int, z: bool, n: int = 3000) -> tuple:
    """Clustered locs (group, cluster) with a cluster of one loc."""
    rng = np.random.default_rng(seed)
    names = ["frame", "x", "y"] + (["z"] if z else []) + [
        "photons", "lpx", "lpy", "group", "cluster"]
    dt = {"frame": np.uint32, "group": np.int32, "cluster": np.int32}
    locs = np.zeros(n, [(c, dt.get(c, np.float32)) for c in names])
    locs["group"] = rng.integers(0, 12, n)
    locs["cluster"] = rng.integers(0, 6, n)
    centres = rng.uniform(5, 60, (12, 6, 2))
    for k, c in enumerate("xy"):
        locs[c] = centres[locs["group"], locs["cluster"], k] + rng.normal(
            0, 0.05, n)
    if z:
        locs["z"] = rng.normal(0, 50, n)
    locs["photons"] = rng.uniform(500, 5000, n)
    locs["frame"] = rng.integers(0, 1000, n)
    locs["lpx"] = locs["lpy"] = 0.05
    locs["cluster"][5] = 99
    info = [{"Frames": 1000, "Width": 64, "Height": 64, "Pixelsize": 130}]
    return locs, info


# --- NeNA ---------------------------------------------------------------


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("with_group", [False, True])
def test_nena_histogram_and_fit_match_jax(f64, with_group):
    locs, info = make_event_locs(20, n_sites=40, frames=600, size=24)
    if f64:
        locs = _f64(locs, 20)
    if not with_group:
        locs = locs[[n for n in locs.dtype.names if n != "group"]]
    bj, hj = jpost._next_frame_neighbor_distance_histogram(_df(locs))
    bt, ht = tpost._next_frame_neighbor_distance_histogram(locs,
                                                           device="cpu")
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(ht, hj)
    assert hj.sum() > 1000
    rj, sj = jpost.nena(_df(locs), info)
    rt, st = tpost.nena(locs, info, device="cpu")
    assert st == sj
    assert rt["best_values"] == rj["best_values"]
    np.testing.assert_array_equal(rt["best_fit"], rj["best_fit"])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sqrt_bins_equal_numpy_binning(dtype):
    """The thresholds bin squared distances as numpy bins their roots:
    int(sqrt(s) / 0.001) in the dtype, kept where sqrt(s) <= 1."""
    rng = np.random.default_rng(21)
    T, s_max = tpost._sqrt_bins(dtype, 0.001, 1000, 1.0)
    s = np.concatenate([rng.uniform(0, 1.1, 200000), T, np.nextafter(T, 0),
                        np.nextafter(T, 2), [s_max, np.nextafter(s_max, 2),
                                             0.0, 1.0]]).astype(dtype)
    d = np.sqrt(s)
    keep = d <= 1.0
    want = (d[keep] / 0.001).astype(int)
    got = np.searchsorted(T, s[s <= s_max], side="right")
    np.testing.assert_array_equal(keep, s <= s_max)
    np.testing.assert_array_equal(got, want)


def test_nena_without_pairs_and_empty_locs():
    locs, info = make_event_locs(22, n_sites=4, frames=40)
    one = locs[np.unique(locs["frame"], return_index=True)[1][::3]]
    _, h = tpost._next_frame_neighbor_distance_histogram(one, device="cpu")
    np.testing.assert_array_equal(
        h, jpost._next_frame_neighbor_distance_histogram(_df(one))[1])
    b, h = tpost._next_frame_neighbor_distance_histogram(locs[:0],
                                                         device="cpu")
    assert len(b) == 1000 and not h.any()


# --- FRC ----------------------------------------------------------------


@pytest.mark.parametrize("size", [15, 64, 101])
def test_tukey_mask_radial_sum_and_loess_match_jax(size):
    rng = np.random.default_rng(size)
    image = rng.random((size, size))
    np.testing.assert_array_equal(
        tmask.threshold_tukey(torch.from_numpy(image)).numpy(),
        jmask.threshold_tukey(image))
    if size % 2:
        np.testing.assert_array_equal(
            timage.radial_sum(torch.from_numpy(image)).numpy(),
            jimage.radial_sum(image))
    curve = rng.random(size)
    for span in (5, 8):
        np.testing.assert_array_equal(tmask.loess_smooth(curve, span),
                                      jmask.loess_smooth(curve, span))
    with pytest.raises(ValueError, match="square"):
        tmask.threshold_tukey(torch.zeros((4, 5)))
    with pytest.raises(ValueError, match="odd"):
        timage.radial_sum(torch.zeros((4, 4)))


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("viewport,seed", [(((2.0, 3.0), (20.0, 22.0)), 42),
                                           (((0.0, 0.0), (24.0, 16.0)), 7)])
def test_frc_matches_jax(f64, viewport, seed):
    locs, info = make_event_locs(23, n_sites=40, frames=400, size=24)
    if f64:
        locs = _f64(locs, 23)
    fj = jpost.frc(_df(locs), info, viewport, random_seed=seed)
    ft = tpost.frc(locs, info, viewport, random_seed=seed, device="cpu")
    np.testing.assert_allclose(ft["frc_curve"], fj["frc_curve"], rtol=0,
                               atol=FRC_CURVE)
    np.testing.assert_allclose(ft["frc_curve_smooth"],
                               fj["frc_curve_smooth"], rtol=0, atol=FRC_CURVE)
    np.testing.assert_array_equal(ft["frequencies"], fj["frequencies"])
    assert fj["resolution"] is not None
    assert abs(ft["resolution"] / fj["resolution"] - 1) <= FRC_RES_REL
    for a, b in zip(ft["images"], fj["images"]):
        np.testing.assert_array_equal(a, b)


def test_frc_non_square_render_raises(monkeypatch):
    """A viewport that squares by float arithmetic to ((7.715, 3.24),
    (15.815, 11.34)), an 82 x 81 image at 0.1 px bins (81 x 80 after
    the cut to odd size): JAX asserts in masking.threshold_tukey, the
    port raises its ValueError before the FFTs."""
    locs, info = make_event_locs(23, n_sites=40, frames=400, size=24)
    viewport = ((7.64, 3.24), (15.89, 11.34))
    monkeypatch.setattr(jpost, "nena", lambda *a, **k: (None, 0.2))
    monkeypatch.setattr(tpost, "nena", lambda *a, **k: (None, 0.2))
    with pytest.raises(AssertionError):
        jpost.frc(_df(locs), info, viewport)
    with pytest.raises(ValueError, match="image must be square"):
        tpost.frc(locs, info, viewport, device="cpu")


# --- groupprops and the combines ------------------------------------------


@pytest.mark.parametrize("seed,f64", [(0, False), (1, True), (2, False)])
def test_groupprops_matches_jax(seed, f64):
    dark, _ = _linked(seed, f64)
    got = tpost.groupprops(dark, device="cpu")
    want = jpost.groupprops(_df(dark)).to_records(index=False)
    assert got.dtype.descr == want.dtype.descr
    for n in got.dtype.names:
        if got.dtype[n].kind in "iu":
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        else:
            assert _ulps(got[n], want[n]) <= GROUPPROPS_ULPS, n
    assert "qpaint_idx" in got.dtype.names and len(got) > 10


def test_groupprops_leaves_out_events_without_dark_time():
    dark, _ = _linked(3)
    dark = dark.copy()
    dark["dark"][::4] = -1
    got = tpost.groupprops(dark, device="cpu")
    want = jpost.groupprops(_df(dark)).to_records(index=False)
    np.testing.assert_array_equal(got["n_events"], want["n_events"])
    calls = []
    tpost.groupprops(dark, callback=calls.append, device="cpu")
    assert calls == [len(got)]


@pytest.mark.parametrize("z", [False, True])
def test_cluster_combine_and_dist_match_jax(z):
    locs, _ = _cluster_locs(24, z)
    got = tpost.cluster_combine(locs, device="cpu")
    want = jpost.cluster_combine(_df(locs)).to_records(index=False)
    assert got.dtype.descr == want.dtype.descr
    keys = locs["group"].astype(np.int64) * 1000 + locs["cluster"]
    inv = np.unique(keys, return_inverse=True)[1]
    w = locs["photons"].astype(np.float64)
    for n in got.dtype.names:
        if n in ("x", "y", "z"):
            scale = np.bincount(inv, np.abs(locs[n] * w)) / np.bincount(inv, w)
            d = np.abs(got[n].astype(np.float64) - want[n])
            assert np.all(d <= COMBINE_ULPS * np.spacing(
                scale.astype(np.float32))), n
        elif got.dtype[n].kind in "iu":
            np.testing.assert_array_equal(got[n], want[n])
        else:
            assert _ulps(got[n], want[n]) <= 1, n
    for px in (None, 107.0):
        d_got = tpost.cluster_combine_dist(np.asarray(want), px, device="cpu")
        d_want = jpost.cluster_combine_dist(_df(want), px).to_records(
            index=False)
        assert d_got.dtype.descr == d_want.dtype.descr
        for n in d_got.dtype.names:
            np.testing.assert_array_equal(d_got[n], d_want[n], err_msg=n)


# --- I/O ----------------------------------------------------------------


def _merge_inputs(case):
    """Tables for merge_locs: the same fields in another order, a _link
    table (extra int and f32 fields) beside a plain one in both orders,
    and a table of zero rows with extra fields between two plain ones."""
    a, info = make_event_locs(25, n_sites=4, frames=50)
    b, _ = make_event_locs(26, n_sites=5, frames=70)
    if case == "same":
        return [a, b[list(reversed(b.dtype.names))], a[:0]]
    linked = jpost.link(_df(b), info, r_max=1.0, max_dark_time=1)
    linked = linked.to_records(index=False)
    if case == "link+plain":
        return [linked, a]
    if case == "plain+link":
        return [a[list(reversed(a.dtype.names))], linked]
    extra = np.zeros(0, [("frame", np.uint32), ("z", np.float32),
                         ("group", np.int32), ("x", np.float64)])
    return [a, extra, b]


@pytest.mark.parametrize("case,increment", [
    # the cases of the same fields keep their ids of before
    pytest.param(case, inc, id=str(inc) if case == "same" else
                 f"{case}-{inc}")
    for case in ("same", "link+plain", "plain+link",
                 "empty with extra fields")
    for inc in (False, True)])
def test_merge_locs_matches_jax(case, increment):
    """merge_locs == pd.concat field by field: the union of the fields
    in pandas' order, NaN in a gap, an int field with a gap as f64, an
    f32 one as f32."""
    tables = _merge_inputs(case)
    got = tlib.merge_locs(tables, increment_frames=increment)
    want = jlib.merge_locs([_df(t) for t in tables],
                           increment_frames=increment).to_records(index=False)
    assert got.dtype.descr == want.dtype.descr
    for n in got.dtype.names:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    if case != "same":
        assert any(np.isnan(got[n]).any() for n in got.dtype.names
                   if got.dtype[n].kind == "f")


def test_load_clusters_and_save_datasets_match_jax(tmp_path):
    locs, info = make_event_locs(27, n_sites=4, frames=50)
    groups = tpost.groupprops(locs, device="cpu")
    tio.save_datasets(str(tmp_path / "t.hdf5"), info, groups=groups,
                      locs=locs)
    jio.save_datasets(str(tmp_path / "j.hdf5"), info,
                      groups=_df(groups), locs=_df(locs))
    for key in ("groups", "locs"):
        with h5py.File(tmp_path / "t.hdf5") as ft, h5py.File(
                tmp_path / "j.hdf5") as fj:
            assert ft[key].dtype == fj[key].dtype
            np.testing.assert_array_equal(ft[key][()], fj[key][()])
    assert tio.load_info(str(tmp_path / "t.hdf5")) == info
    got = tio.load_clusters(str(tmp_path / "t.hdf5"))
    want = jio.load_clusters(str(tmp_path / "t.hdf5")).to_records(index=False)
    assert got.dtype.names == want.dtype.names
    np.testing.assert_array_equal(got["x"], want["x"])
    tio.save_datasets(str(tmp_path / "c.hdf5"), info, clusters=locs[:9])
    np.testing.assert_array_equal(tio.load_clusters(str(tmp_path / "c.hdf5")),
                                  locs[:9])


# --- the CLI ------------------------------------------------------------


def _write_locs(path, locs, info):
    jio.save_locs(str(path), _df(locs), info)


def _inputs(tmp_path, d):
    """The input files of every verb in ``tmp_path/d``."""
    folder = tmp_path / d
    folder.mkdir()
    locs, info = make_event_locs(28, n_sites=24, frames=600)
    _write_locs(folder / "ev_locs.hdf5", locs, info)
    # link: the port reads the rows in the order JAX's sort gives them
    _write_locs(folder / "lk_locs.hdf5", jax_order(locs) if d == "t" else
                locs, info)
    _write_locs(folder / "ev2_locs.hdf5", make_event_locs(29)[0], info)
    linked = jpost.link(_df(locs), info, r_max=1.0, max_dark_time=1)
    _write_locs(folder / "ev_link.hdf5", linked.to_records(index=False), info)
    _write_locs(folder / "ev_dark.hdf5", jpost.compute_dark_times(
        linked).to_records(index=False), info)
    clusters, cinfo = _cluster_locs(30, z=True)
    _write_locs(folder / "cl.hdf5", clusters, cinfo)
    comb = jpost.cluster_combine(_df(clusters))
    jio.save_locs(str(folder / "cl_comb_in.hdf5"), comb, cinfo)
    return folder


_VERBS = {
    "link": (["link", "{d}/lk_locs.hdf5"], ["lk_locs_link.hdf5"]),
    "link-d-t": (["link", "{d}/lk_locs.hdf5", "-d", "0.3", "-t", "3"],
                 ["lk_locs_link.hdf5"]),
    "dark": (["dark", "{d}/ev_link.hdf5"], ["ev_link_dark.hdf5"]),
    "density": (["density", "{d}/ev_locs.hdf5", "0.5"],
                ["ev_locs_density.hdf5"]),
    "nneighbor": (["nneighbor", "{d}/cl_comb_in.hdf5"], ["cl_comb_in_nn.csv"]),
    "clusterfilter": (["clusterfilter", "{d}/ev_locs.hdf5", "photons", "1000",
                       "3000"], ["ev_locs_filter.hdf5"]),
    "join": (["join", "{d}/ev_locs.hdf5", "{d}/ev2_locs.hdf5"],
             ["ev_locs_join.hdf5"]),
    "join-k": (["join", "{d}/ev2_locs.hdf5", "{d}/ev_locs.hdf5", "-k"],
               ["ev2_locs_join.hdf5"]),
    # tables of different fields: the _link file's extra fields are NaN
    # in the plain file's rows
    "join-link": (["join", "{d}/ev_link.hdf5", "{d}/ev2_locs.hdf5"],
                  ["ev_link_join.hdf5"]),
    "groupprops": (["groupprops", "{d}/ev_dark.hdf5"],
                   ["ev_dark_groupprops.hdf5"]),
    "pc": (["pc", "{d}/ev_locs.hdf5", "-b", "0.1", "-r", "5"],
           ["ev_locs_pc.csv"]),
    "cluster_combine": (["cluster_combine", "{d}/cl.hdf5"], ["cl_comb.hdf5"]),
    "cluster_combine_dist": (["cluster_combine_dist", "{d}/cl_comb_in.hdf5"],
                             ["cl_comb_in_cdist.hdf5"]),
    "smlm_cluster": (["smlm_cluster", "{d}/ev_locs.hdf5", "0.1", "5"],
                     ["ev_locs_clustered.hdf5",
                      "ev_locs_cluster_centers.hdf5"]),
    "smlm_cluster-3d-fa": (["smlm_cluster", "{d}/cl.hdf5", "0.2", "5", "-z",
                            "0.5", "-f", "1"],
                           ["cl_clustered.hdf5", "cl_cluster_centers.hdf5"]),
    "dbscan": (["dbscan", "{d}/ev_locs.hdf5", "0.1", "5"],
               ["ev_locs_dbscan.hdf5", "ev_locs_dbscan_centers.hdf5"]),
    "hdbscan": (["hdbscan", "{d}/ev_locs.hdf5", "10", "10"],
                ["ev_locs_hdbscan.hdf5", "ev_locs_hdbscan_centers.hdf5"]),
}


def _datasets(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


@pytest.mark.parametrize("verb", list(_VERBS))
def test_cli_verbs_match_the_jax_cli(tmp_path, verb, capsys):
    """The port's verb (--device cpu where it takes one) and the JAX
    CLI's: the same files and messages; HDF5 fields and YAML equal
    (groupprops and cluster_combine within their ulps, cluster centers
    as tests/test_torch_cluster.compare_centers holds them); CSVs
    equal."""
    from picasso_torch import __main__ as tmain
    from picasso_tpu import __main__ as jmain

    argv, produced = _VERBS[verb]
    device = [] if argv[0] in ("join", "clusterfilter") else ["--device",
                                                             "cpu"]
    out = {}
    for d, main, extra in (("t", tmain.main, device), ("j", jmain.main, [])):
        folder = _inputs(tmp_path, d)
        main([a.format(d=folder) for a in argv] + extra)
        out[d] = capsys.readouterr().out.replace(str(folder), "")
    assert out["t"] == out["j"]
    t, j = tmp_path / "t", tmp_path / "j"
    assert sorted(p.name for p in t.iterdir()) == sorted(
        p.name for p in j.iterdir())
    for name in produced:
        if name.endswith(".csv"):
            np.testing.assert_array_equal(np.loadtxt(t / name, delimiter=","),
                                          np.loadtxt(j / name, delimiter=","))
            continue
        dt, dj = _datasets(t / name), _datasets(j / name)
        assert dt.keys() == dj.keys()
        if name.endswith("_centers.hdf5"):
            compare_centers(dt["locs"], dj["locs"],
                            _datasets(t / produced[0])["locs"])
            dt = {}
        for key in dt:
            a, b = dt[key], dj[key]
            assert a.dtype == b.dtype and len(a) == len(b) > 0
            for n in a.dtype.names:
                if verb == "groupprops" and a.dtype[n].kind == "f":
                    assert _ulps(a[n], b[n]) <= GROUPPROPS_ULPS, n
                elif verb == "cluster_combine" and n in ("x", "y", "z"):
                    np.testing.assert_allclose(a[n], b[n], rtol=0, atol=COMBINE_ULPS
                                               * np.spacing(np.float32(64)))
                else:
                    np.testing.assert_array_equal(a[n], b[n], err_msg=n)
        assert tio.load_info(str(t / name)) == tio.load_info(str(j / name))
