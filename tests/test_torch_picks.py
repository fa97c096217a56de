"""The pick analyses of the port held against picasso_tpu on the CPU:
similar picks, removal and combination of the locs in picks, qPAINT
kinetics (pick_kinetics, evaluate_picks, pick_properties), FRET, the
pick geometry and kinetic fits of lib, the picks files, the plots and the
deprecated aliases of postprocess, and the device rule of the new entry
points.

Inputs: tests/torch_data.make_origami_locs (origami of 11 sites, events
of 3-8 frames) and make_event_locs. Where a pick's rows meet JAX's
link, the locs keep one loc a frame (``_one_a_frame``): JAX sorts each
pick by frame with pandas' quicksort, the port stably, and only rows of
one frame can differ in order (tests/test_torch_link.jax_order).

Tolerances (tests/torch_parity.py): bit for bit the lib geometry and
fits, the picks files, FRET, remove_locs_in_picks' surviving rows, the
events and dark times of the pick analyses and their kinetic fits; within
one f32 ulp pick_properties' group statistics (as groupprops); the
similar picks by compare_similar_picks (measured: the same picks, 1 f32
ulp apart).
"""

from __future__ import annotations

import ast
import os

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_torch import io as tio
from picasso_torch import lib as tlib
from picasso_torch import postprocess as tpost
from picasso_tpu import io as jio
from picasso_tpu import lib as jlib
from picasso_tpu import postprocess as jpost
from torch_data import make_event_locs, make_origami_locs
from torch_parity import compare_similar_picks, compare_tables_ulps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}


def _df(locs: np.ndarray) -> pd.DataFrame:
    return pd.DataFrame.from_records(locs)


def _assert_table_equal(got: np.ndarray, ref) -> None:
    rec = (ref.to_records(index=False) if isinstance(ref, pd.DataFrame)
           else ref)
    assert got.dtype.names == rec.dtype.names, (got.dtype, rec.dtype)
    for name in got.dtype.names:
        assert got.dtype[name] == rec.dtype[name], name
        np.testing.assert_array_equal(got[name], rec[name], err_msg=name)


def _one_a_frame(locs: np.ndarray) -> np.ndarray:
    """The first loc of each frame."""
    return locs[np.sort(np.unique(locs["frame"], return_index=True)[1])]


@pytest.fixture(scope="module")
def origami():
    locs, info, truth = make_origami_locs(16, 3)
    return _one_a_frame(locs), info, truth


def _circle_picks(truth, extra=((1.0, 1.0),)) -> list:
    """Circles on the origami centres, then ``extra`` (by default one on
    a corner of the field, which holds no loc)."""
    return [tuple(map(float, c)) for c in truth["centers"]] + list(extra)


def _picked(locs, info, picks, radius=0.5):
    got = tpost.picked_locs(locs, info, picks, "Circle", radius)
    ref = jpost.picked_locs(_df(locs), info, picks, "Circle", radius)
    for a, b in zip(got, ref):
        _assert_table_equal(a, b)
    return got, ref


# ---------------------------------------------------------------------------
# lib: pick geometry, metadata, groups, kinetic fits
# ---------------------------------------------------------------------------


POLYGONS = [[(1.0, 1.0), (5.0, 1.5), (4.0, 6.0), (1.5, 4.0), (1.0, 1.0)],
            [(2.0, 2.0), (3.0, 2.0)]]
RECTANGLES = [((1.0, 1.0), (6.0, 3.0)), ((2.0, 5.0), (2.0, 9.0))]


@pytest.mark.parametrize("shape,picks,size", [
    ("Circle", [(1.0, 2.0), (3.0, 4.0)], 1.3),
    ("Rectangle", RECTANGLES, 0.7),
    ("Polygon", POLYGONS, None),
    ("Square", [(1.0, 2.0)], 2.5),
])
def test_pick_areas_match_jax(shape, picks, size):
    np.testing.assert_array_equal(tlib.pick_areas(shape, picks, size),
                                  jlib.pick_areas(shape, picks, size))


def test_area_helpers_and_unknown_shape_match_jax():
    X, Y = np.array(POLYGONS[0]).T
    assert tlib.polygon_area(X, Y) == jlib.polygon_area(X, Y)
    np.testing.assert_array_equal(tlib.pick_areas_polygon(POLYGONS),
                                  jlib.pick_areas_polygon(POLYGONS))
    np.testing.assert_array_equal(tlib.pick_areas_circle([1, 2, 3], 0.4),
                                  jlib.pick_areas_circle([1, 2, 3], 0.4))
    np.testing.assert_array_equal(tlib.pick_areas_rectangle(RECTANGLES, 2),
                                  jlib.pick_areas_rectangle(RECTANGLES, 2))
    for mod in (tlib, jlib):
        with pytest.raises(ValueError, match="Unknown pick shape"):
            mod.pick_areas("Hexagon", [(1, 1)], 1.0)


def test_locs_in_polygon_and_rectangle_match_jax():
    locs = make_event_locs(1, size=10)[0]
    X, Y = np.array(POLYGONS[0]).T
    _assert_table_equal(tlib.locs_in_polygon(locs, X, Y),
                        jlib.locs_in_polygon(_df(locs), X, Y))
    Xr, Yr = tlib.get_pick_rectangle_corners(1.0, 1.0, 6.0, 3.0, 2.0)
    got = tlib.locs_in_rectangle(locs, Xr, Yr)
    _assert_table_equal(got, jlib.locs_in_rectangle(_df(locs), Xr, Yr))
    assert 0 < len(got) < len(locs)


def test_overwrite_metadata_and_sync_groups_match_jax():
    info = [{"Width": 10, "Frames": 5}, {"Pixelsize": 130}]
    for key in ("Width", "Height"):
        got = tlib.overwrite_metadata(info, key, 99)
        assert got == jlib.overwrite_metadata(info, key, 99)
    assert info == [{"Width": 10, "Frames": 5}, {"Pixelsize": 130}]
    a = make_event_locs(2)[0]
    b = make_event_locs(3)[0]
    b = b[b["group"] != 4]
    got = tlib.sync_groups([a, b])
    ref = jlib.sync_groups([_df(a), _df(b)])
    for g_, r_ in zip(got, ref):
        _assert_table_equal(g_, r_)
    assert 4 not in got[0]["group"]
    for mod in (tlib,):
        with pytest.raises(AssertionError, match="group"):
            mod.sync_groups([a[["x", "y"]]])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_group_mean_equals_pandas(dtype):
    """lib.group_mean (the groupby means of unfold, average and average3)
    equals pandas' groupby mean bit for bit, f32 and f64: a Kahan sum in
    the column's dtype."""
    rng = np.random.default_rng(4)
    values = (rng.normal(60, 30, 5000)).astype(dtype)
    group = rng.integers(0, 37, 5000)
    ids, rows = tlib.group_rows(group)
    want = pd.DataFrame({"v": values, "g": group}).groupby("g")["v"].mean()
    got = tlib.group_mean(values, rows)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want.to_numpy())
    np.testing.assert_array_equal(ids, want.index.to_numpy())


@pytest.mark.parametrize("kw", [{}, {"n_square": 3, "spacing": 2.5}])
def test_unfold_localizations_square_matches_jax(kw):
    locs, info, _ = make_origami_locs(9, 1)
    locs = tpost._with_fields(locs, [("group", (np.arange(len(locs)) % 7
                                                * 3).astype(np.int32))])
    got, ginfo = tlib.unfold_localizations_square(locs, info, **kw)
    ref, rinfo = jlib.unfold_localizations_square(_df(locs), info, **kw)
    _assert_table_equal(got, ref)
    assert ginfo == rinfo and ginfo != info
    with pytest.raises(AssertionError, match="group"):
        tlib.unfold_localizations_square(locs[["x", "y"]], info)


@pytest.mark.parametrize("data", [
    [3.0], [2.0, 5.0], [4.0, 4.0, 4.0, 4.0],
    list(np.random.default_rng(5).exponential(7.0, 60).round() + 1),
    list(np.random.default_rng(6).exponential(30.0, 400) + 1),
])
def test_kinetic_fits_match_jax(data):
    assert tlib.estimate_kinetic_rate(data) == jlib.estimate_kinetic_rate(
        data)
    if len(set(data)) > 2:
        got, ref = tlib.fit_cum_exp(data), jlib.fit_cum_exp(data)
        assert got["best_values"] == ref["best_values"]
        np.testing.assert_array_equal(got["best_fit"], ref["best_fit"])
        np.testing.assert_array_equal(got["data"], ref["data"])
    x = np.linspace(0, 50, 11)
    np.testing.assert_array_equal(tlib.cumulative_exponential(x, 3, 7, 1),
                                  jlib.cumulative_exponential(x, 3, 7, 1))


def test_permutation_test_matches_jax():
    rng = np.random.default_rng(7)
    a, b = rng.normal(0, 1, 40), rng.normal(0.4, 1, 55)
    np.random.seed(3)
    got = tlib.permutation_test(a, b, 200)
    np.random.seed(3)
    assert got == jlib.permutation_test(a, b, 200)


def _lines(fig):
    return [(ax.get_title(), [(ln.get_xdata(), ln.get_ydata())
                              for ln in ax.get_lines()]) for ax in fig.axes]


def _assert_same_figure(a, b):
    la, lb = _lines(a), _lines(b)
    assert [t for t, _ in la] == [t for t, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        assert len(x) == len(y)
        for (xa, ya), (xb, yb) in zip(x, y):
            np.testing.assert_array_equal(np.asarray(xa, float),
                                          np.asarray(xb, float))
            np.testing.assert_array_equal(np.asarray(ya, float),
                                          np.asarray(yb, float))


def test_plots_match_jax():
    """plot_cumulative_exponential_fit, plot_drift, plot_nena and
    plot_frc draw the same lines and titles as JAX's (Agg)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = np.random.default_rng(8).exponential(5.0, 50) + 1
    fit = tlib.fit_cum_exp(data)
    _assert_same_figure(tlib.plot_cumulative_exponential_fit(data, fit),
                        jlib.plot_cumulative_exponential_fit(data, fit))
    drift = np.zeros(30, [("x", np.float64), ("y", np.float64),
                          ("z", np.float64)])
    drift["x"], drift["y"] = np.sin(np.arange(30)), np.arange(30) / 7
    drift["z"] = np.cos(np.arange(30))
    for px in (1.0, 130.0):
        _assert_same_figure(tpost.plot_drift(drift, px),
                            jpost.plot_drift(_df(drift), px))
    locs, info = make_event_locs(9)
    nena = tpost.nena(locs, info, **CPU)[0]
    _assert_same_figure(tpost.plot_nena(nena), jpost.plot_nena(nena))
    q = np.linspace(0, 0.05, 40)
    frc = {"frequencies": q, "frc_curve": np.exp(-q * 40),
           "frc_curve_smooth": np.exp(-q * 41), "resolution": 21.3}
    _assert_same_figure(tpost.plot_frc(frc), jpost.plot_frc(frc))
    plt.close("all")


# ---------------------------------------------------------------------------
# picks files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,picks,size", [
    ("Circle", [[1.5, 2.0], [3.0, 4.25]], 0.8),
    ("Rectangle", [[[1.0, 1.0], [6.0, 3.0]]], 0.5),
    ("Polygon", [[[1.0, 1.0], [5.0, 1.5], [4.0, 6.0], [1.0, 1.0]]], None),
    ("Square", [[1.0, 2.0]], 1.5),
])
def test_picks_files_match_jax(tmp_path, shape, picks, size):
    """save_picks writes JAX's file byte for byte; load_picks reads
    either back as JAX does (size in nm over the pixel size)."""
    a, b = str(tmp_path / "a.yaml"), str(tmp_path / "b.yaml")
    tio.save_picks(a, picks, shape, size, pixelsize=130.0)
    jio.save_picks(b, picks, shape, size, pixelsize=130.0)
    assert open(a).read() == open(b).read()
    for px in (None, 130.0):
        assert tio.load_picks(a, px) == jio.load_picks(a, px)


def test_picks_file_legacy_and_bad_inputs_match_jax(tmp_path):
    import yaml

    legacy = str(tmp_path / "legacy.yaml")
    with open(legacy, "w") as f:
        yaml.dump({"Centers": [[1.0, 2.0]], "Diameter": 0.9}, f)
    assert tio.load_picks(legacy) == jio.load_picks(legacy) == (
        [[1.0, 2.0]], "Circle", 0.9)
    bad = str(tmp_path / "bad.yaml")
    with open(bad, "w") as f:
        yaml.dump({"Vertices": []}, f)
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="Unrecognized picks file"):
            mod.load_picks(bad)
        with pytest.raises(AssertionError, match="yaml"):
            mod.load_picks(str(tmp_path / "picks.txt"))
        with pytest.raises(ValueError, match="Unrecognized pick shape"):
            mod.save_picks(str(tmp_path / "x.yaml"), [], "Hexagon", 1.0)


# ---------------------------------------------------------------------------
# postprocess: the pick analyses
# ---------------------------------------------------------------------------


def test_rmsd_at_com_matches_jax():
    rng = np.random.default_rng(10)
    for dtype in (np.float32, np.float64):
        xy = rng.normal(20, 0.05, (2, 333)).astype(dtype)
        got = tpost.rmsd_at_com(xy)
        assert type(got) is float and got == jpost.rmsd_at_com(xy)


@pytest.mark.parametrize("shape", ["Circle", "Rectangle", "Polygon",
                                   "Square"])
def test_remove_locs_in_picks_matches_jax(shape):
    """The rows left are JAX's, in their order: a circle's picked rows
    are dropped by their positions through the sanity filter (rows of
    NaN, beyond the field and of negative photons are in the input) and
    the block sort."""
    locs, info = make_event_locs(11, size=12)
    locs = locs.copy()
    locs["x"][5] = np.nan
    locs["y"][17] = 13.0
    locs["photons"][40] = -1
    picks, size = {
        "Circle": ([(4.0, 4.0), (7.0, 6.5), (4.2, 4.1)], 3.0),
        "Rectangle": ([((2.0, 2.0), (9.0, 7.0))], 2.0),
        "Polygon": ([[(2.0, 2.0), (9.0, 3.0), (6.0, 9.0), (2.0, 2.0)],
                     [(1.0, 1.0), (2.0, 2.0)]], None),
        "Square": ([(5.0, 5.0), (8.0, 3.0)], 3.0)}[shape]
    got = tpost.remove_locs_in_picks(locs, info, picks=picks,
                                     pick_shape=shape, pick_size=size)
    ref = jpost.remove_locs_in_picks(_df(locs), info, picks=picks,
                                     pick_shape=shape, pick_size=size)
    _assert_table_equal(got, ref)
    assert 0 < len(got) < len(locs) - 10
    kept = ref.index.to_numpy()
    _assert_table_equal(locs[kept], got)
    if shape == "Circle":
        blocks = tpost.get_index_blocks(locs, info, 1.0)
        again = tpost.remove_locs_in_picks(
            locs, info, picks=picks, pick_shape=shape, pick_size=size,
            index_blocks=blocks)
        _assert_table_equal(again, jpost.remove_locs_in_picks(
            _df(locs), info, picks=picks, pick_shape=shape, pick_size=size,
            index_blocks=jpost.get_index_blocks(_df(locs), info, 1.0)))


def test_remove_locs_in_picks_leaves_the_rest():
    """What is left plus the union of every pick's rows are the sane
    input, each row once."""
    locs, info, truth = make_origami_locs(9, 2)
    picks = _circle_picks(truth, ())
    left = tpost.remove_locs_in_picks(locs, info, picks=picks,
                                      pick_shape="Circle", pick_size=1.0)
    picked = np.concatenate(tpost.picked_locs(locs, info, picks, "Circle",
                                              0.5, add_group=False))
    both = np.concatenate([left, picked])
    assert len(np.unique(both)) == len(both) == len(
        tlib.ensure_sanity(locs, info))


def test_picked_locs_overwrite_an_existing_group_as_jax():
    locs, info = make_event_locs(12)
    locs = _one_a_frame(locs)
    got = tpost.picked_locs(locs, info, [(10.0, 10.0)], "Circle", 4.0)
    ref = jpost.picked_locs(_df(locs), info, [(10.0, 10.0)], "Circle", 4.0)
    _assert_table_equal(got[0], ref[0])
    assert len(got[0]) and set(got[0]["group"]) == {0}


def test_combine_locs_in_picks_matches_jax(origami):
    locs, info, truth = origami
    picks = _circle_picks(truth)
    kw = dict(picks=picks, pick_shape="Circle", pick_size=1.0)
    got = tpost.combine_locs_in_picks(locs, info, **kw, **CPU)
    ref = jpost.combine_locs_in_picks(_df(locs), info, **kw)
    _assert_table_equal(got, ref)
    assert len(got) == len(truth["centers"])
    empty = tpost.combine_locs_in_picks(locs, info, picks=[(1.0, 1.0)],
                                        pick_shape="Circle", pick_size=1.0,
                                        **CPU)
    assert len(empty) == 0 and empty.dtype == locs.dtype


def test_combine_locs_in_picks_one_call_equals_a_call_a_pick():
    """With several locs a frame (rows whose order JAX's quicksort may
    change): the one link call over all picks equals linking each pick
    alone, pick by pick."""
    locs, info, truth = make_origami_locs(9, 4)
    picks = _circle_picks(truth, ())
    got = tpost.combine_locs_in_picks(locs, info, picks=picks,
                                      pick_shape="Square", pick_size=1.2,
                                      **CPU)
    per_pick = [tpost.link(p, info, r_max=1e9, max_dark_time=10**9,
                           remove_ambiguous_lengths=False, **CPU)
                for p in tpost.picked_locs(locs, info, picks, "Square", 1.2)]
    _assert_table_equal(got, np.concatenate(per_pick))
    assert len(got) > len(picks)


def _kinetics_inputs(origami):
    locs, info, truth = origami
    picks = _circle_picks(truth)
    picks.insert(3, (truth["centers"][3][0] + 0.55,
                     truth["centers"][3][1]))
    return _picked(locs, info, picks) + (info, picks)


@pytest.mark.parametrize("max_dark_time", [3, 40])
def test_pick_kinetics_matches_jax(origami, max_dark_time):
    """The events and dark times equal, pick for pick, and the fits bit
    for bit; the empty pick and the pick of a few events are skipped or
    kept as JAX keeps them."""
    got_p, ref_p, info, _ = _kinetics_inputs(origami)
    got = tpost.pick_kinetics(got_p, info, max_dark_time=max_dark_time,
                              **CPU)
    ref = jpost.pick_kinetics(ref_p, info, max_dark_time=max_dark_time)
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _assert_table_equal(got[3], ref[3])
    assert 0 < len(got[0]) < len(got_p)


def test_evaluate_picks_matches_jax(origami):
    got_p, ref_p, info, _ = _kinetics_inputs(origami)
    got = tpost.evaluate_picks(got_p, info, **CPU)
    ref = jpost.evaluate_picks(ref_p, info)
    for a, b in zip(got[:6], ref[:6]):
        np.testing.assert_array_equal(a, b)
    _assert_table_equal(got[6], ref[6])
    assert np.isnan(got[0]).sum() == 1
    # already linked picks (a ``len`` field) are not linked again
    linked = [tpost.link(p, info, r_max=999999, **CPU) for p in got_p]
    again = tpost.evaluate_picks(linked, info, **CPU)
    jagain = jpost.evaluate_picks([_df(p) for p in linked], info)
    for a, b in zip(again[:6], jagain[:6]):
        np.testing.assert_array_equal(a, b)
    _assert_table_equal(again[6], jagain[6])


def test_evaluate_picks_z_and_no_group_match_jax(origami):
    """3D picks (rmsd_z) without a group field: the events keep no group,
    as JAX's."""
    got_p, ref_p, info, _ = _kinetics_inputs(origami)
    rng = np.random.default_rng(13)
    got_z, ref_z = [], []
    for p in got_p:
        q = tpost._with_fields(p[[n for n in p.dtype.names if n != "group"]],
                               [("z", rng.normal(0, 40, len(p)).astype(
                                   np.float32))])
        got_z.append(q)
        ref_z.append(_df(q))
    got = tpost.evaluate_picks(got_z, info, **CPU)
    ref = jpost.evaluate_picks(ref_z, info)
    for a, b in zip(got[:6], ref[:6]):
        np.testing.assert_array_equal(a, b)
    _assert_table_equal(got[6], ref[6])
    assert "group" not in got[6].dtype.names


def test_pick_properties_matches_jax(origami):
    got_p, ref_p, info, picks = _kinetics_inputs(origami)
    keep = [k for k, p in enumerate(got_p) if len(p) > 20]
    got_p, ref_p = [got_p[k] for k in keep], [ref_p[k] for k in keep]
    areas = tlib.pick_areas("Circle", [picks[k] for k in keep], 1.0)
    got = tpost.pick_properties(got_p, info, pick_areas=areas, **CPU)
    ref = jpost.pick_properties(ref_p, info, pick_areas=areas)
    rec = ref.to_records(index=False)
    assert got.dtype.names == rec.dtype.names
    stats = [n for n in got.dtype.names if n not in (
        "pick_area_um2", "n_units", "locs", "length_cdf", "dark_cdf",
        "qpaint_idx_cdf")]
    compare_tables_ulps(got[stats], rec[stats], 1, "pick_properties")
    for n in got.dtype.names[len(stats):]:
        assert got.dtype[n] == rec.dtype[n], n
        np.testing.assert_array_equal(got[n], rec[n], err_msg=n)
    with pytest.raises(ValueError, match="Length of values"):
        tpost.pick_properties(got_p, info, pick_areas=areas[:-1], **CPU)


def test_pick_similar_matches_jax():
    """64 origami, 20 seed picks on true centres: the same picks as JAX's
    under compare_similar_picks (1 f32 ulp apart here), each within 0.05
    px of a true centre; the record holds every candidate."""
    locs, info, truth = make_origami_locs(64, 0)
    picks = [tuple(c) for c in truth["centers"][:20]]
    rec = {}
    got = tpost.pick_similar(locs, info, picks, 1.0, index_blocks=object(),
                             record=rec, **CPU)
    ref = jpost.pick_similar(_df(locs), info, picks, 1.0)
    out = compare_similar_picks(got, rec, ref, what="pick_similar vs JAX")
    assert out["matched"] == len(got) == len(ref) > 10
    assert all(isinstance(v, np.float32) for p in got for v in p)
    from scipy.spatial import cKDTree

    assert cKDTree(truth["centers"]).query(np.array(got))[0].max() < 0.05
    assert len(rec["started"]) == len(rec["candidates"]) > 1000
    assert rec["accepted"].sum() == len(got)


def test_compare_similar_picks_allows_only_near_ties():
    """The rule itself: a pick alone on one side passes at a recorded near
    tie and fails without one."""
    locs, info, truth = make_origami_locs(16, 5)
    picks = [tuple(c) for c in truth["centers"][:8]]
    rec = {}
    got = tpost.pick_similar(locs, info, picks, 1.0, record=rec, **CPU)
    assert compare_similar_picks(got, rec, list(got))["matched"] == len(got)
    with pytest.raises(AssertionError, match="no near tie"):
        compare_similar_picks(got, rec, got[1:])
    k = np.nonzero(rec["accepted"])[0][0]
    rec["edge"] = rec["edge"].copy()
    rec["edge"][k] = 0.0
    out = compare_similar_picks(got, rec, got[1:])
    assert out["got_alone"] == [0]


# ---------------------------------------------------------------------------
# FRET
# ---------------------------------------------------------------------------


def _fret_locs(seed, n, frames):
    locs = make_event_locs(seed)[0][:n].copy()
    locs["frame"] = frames
    return locs


@pytest.mark.parametrize("case", ["both", "no_acceptor", "no_donor",
                                  "none_in_range"])
def test_calculate_fret_matches_jax(case):
    """Acceptor frames repeat (the last loc of a frame wins), donor
    frames do not; an empty channel, or no efficiency within (0, 1)."""
    rng = np.random.default_rng(14)
    acc = _fret_locs(14, 60, np.sort(rng.integers(0, 80, 60)))
    don = _fret_locs(15, 50, np.sort(rng.choice(90, 50, replace=False)))
    if case == "no_acceptor":
        acc = acc[:0]
    elif case == "no_donor":
        don = don[:0]
    elif case == "none_in_range":
        don["photons"] = don["bg"]
        acc["photons"] = acc["bg"] - 1
    got_d, got_l = tpost.calculate_fret(acc, don)
    ref_d, ref_l = jpost.calculate_fret(_df(acc), _df(don))
    assert got_d.keys() == ref_d.keys()
    for k in got_d:
        np.testing.assert_array_equal(got_d[k], ref_d[k], err_msg=k)
        assert np.asarray(got_d[k]).dtype == np.asarray(ref_d[k]).dtype, k
    if isinstance(ref_l, list):
        assert got_l == ref_l == []
    else:
        _assert_table_equal(got_l, ref_l)
        assert len(got_l) > 5


# ---------------------------------------------------------------------------
# deprecated aliases
# ---------------------------------------------------------------------------


def test_block_aliases_match_jax(capsys):
    locs, info = make_event_locs(16, size=12)
    blocks = tpost.get_index_blocks(locs, info, 2.0)
    jblocks = jpost.get_index_blocks(_df(locs), info, 2.0)
    assert tpost.index_blocks_shape(info, 2.0) == jpost.index_blocks_shape(
        info, 2.0)
    *_, starts, ends, K, L = blocks
    for yx in [(0, 0), (0, 3), (2, 2), (5, 5), (3, 0)]:
        got = tpost.n_block_locs_at(yx[1], yx[0], K, L, starts, ends)
        assert got == jpost.n_block_locs_at(yx[1], yx[0], K, L, starts, ends)
        assert type(got) is np.uint32
    xy = np.stack([blocks[0]["x"], blocks[0]["y"]])
    jxy = np.stack([jblocks[0]["x"].to_numpy(), jblocks[0]["y"].to_numpy()])
    np.testing.assert_array_equal(xy, jxy)
    for yx in [(0, 0), (2, 3), (5, 5)]:
        np.testing.assert_array_equal(
            tpost.get_block_locs_at_numba(yx[1], yx[0], xy, starts, ends, K,
                                          L),
            jpost.get_block_locs_at_numba(yx[1], yx[0], xy, starts, ends, K,
                                          L))
    np.testing.assert_array_equal(tpost.locs_at_numba(5.0, 6.0, xy, 1.5),
                                  jpost.locs_at_numba(5.0, 6.0, xy, 1.5))
    # row and column 0 are left out of the reference's count
    full = np.arange(16, dtype=np.uint32).reshape(4, 4) + 1
    zero = np.zeros((4, 4), np.uint32)
    assert tpost.n_block_locs_at(0, 0, 4, 4, zero, full) == jpost.n_block_locs_at(
        0, 0, 4, 4, zero, full) == full[1, 1]
    # both packages print their notice a call
    assert capsys.readouterr().out.count("Deprecation warning") == 2 * 7


def test_link_aliases_match_jax(capsys):
    from test_torch_link import jax_order

    locs, info = make_event_locs(17)
    locs = jax_order(locs)
    cols = (locs["frame"], locs["x"], locs["y"], 1.0, 1, locs["group"])
    ids = tpost.get_link_groups(*cols, **CPU)
    np.testing.assert_array_equal(ids, jpost.get_link_groups(*cols))
    _assert_table_equal(tpost.link_loc_groups(locs, info, ids, **CPU),
                        jpost.link_loc_groups(_df(locs), info, ids))
    got = tpost.next_frame_neighbor_distance_histogram(locs, **CPU)
    ref = jpost.next_frame_neighbor_distance_histogram(_df(locs))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert capsys.readouterr().out.count("Deprecation warning") == 2 * 3


# ---------------------------------------------------------------------------
# the port's names and its device rule
# ---------------------------------------------------------------------------


def _public(path: str) -> set:
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


#: public names of the JAX package that the port leaves out on purpose:
#: nothing in the port reads a host stage log (its spans time the steps,
#: picasso_torch/profiling.py)
LEFT_OUT = {"profiling": {"StageTimer"}}


@pytest.mark.parametrize("module", [
    "postprocess", "masking", "io", "spatial_index", "profiling", "render",
    "lib", "localize", "gausslq", "g5m", "design", "design_sequences",
    "updater", "server/__init__", "server/db", "server/watcher",
    "server/app", "gui/base", "gui/apps", "gui/plugins/__init__",
    "gui/render_app", "gui/panels", "gui/viewers", "gui/__init__"])
def test_every_public_name_of_the_module_is_ported(module):
    """Every top-level public function, class and constant of
    picasso_tpu/<module>.py exists in picasso_torch/<module>.py, render's
    drawing helpers of the render window included, but for the names of
    :data:`LEFT_OUT`, which JAX's module has and the port's has not. The
    sources are parsed, so the Streamlit script and the apps import
    nothing."""
    jax_names = _public(f"picasso_tpu/{module}.py")
    torch_names = _public(f"picasso_torch/{module}.py")
    left_out = LEFT_OUT.get(module, set())
    assert left_out <= jax_names and not left_out & torch_names
    missing = jax_names - torch_names - left_out
    assert not missing, sorted(missing)


def _imported(path: str) -> set:
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    return {a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names}


@pytest.mark.parametrize("module", ["gui/__init__", "gui/viewers"])
def test_the_gui_modules_export_what_jax_does(module):
    """The names gui/__init__ and gui/viewers import for their users
    (the apps, the panels, the re-exported RenderApp) are the port's
    too, and picasso_torch.gui holds them."""
    from picasso_torch import gui

    names = _imported(f"picasso_tpu/{module}.py") - {"annotations"}
    assert names - _imported(f"picasso_torch/{module}.py") == set()
    if module == "gui/__init__":
        assert {"RenderApp", "LocalizeApp", "FilterApp", "InfoPanel"} <= names
        for name in names:
            assert callable(getattr(gui, name)), name


def test_pick_and_lib_names_are_ported():
    for name in ("polygon_area", "pick_areas_polygon", "pick_areas_circle",
                 "pick_areas_rectangle", "pick_areas", "locs_in_polygon",
                 "locs_in_rectangle", "overwrite_metadata",
                 "unfold_localizations_square", "sync_groups",
                 "cumulative_exponential", "fit_cum_exp",
                 "estimate_kinetic_rate", "permutation_test",
                 "plot_cumulative_exponential_fit"):
        assert callable(getattr(tlib, name)), name
    assert callable(tio.load_picks) and callable(tio.save_picks)


def test_pick_entry_points_need_the_card_or_cpu():
    """Without device="cpu" and without a card the entry points that link
    or walk on the device raise; the host-only ones take no device."""
    from picasso_torch import masking

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    locs, info = make_event_locs(18)
    picked = tpost.picked_locs(locs, info, [(10.0, 10.0)], "Circle", 3.0)
    calls = [
        lambda: tpost.pick_similar(locs, info, [(10.0, 10.0)], 1.0),
        lambda: tpost.combine_locs_in_picks(
            locs, info, picks=[(10.0, 10.0)], pick_shape="Circle",
            pick_size=1.0),
        lambda: tpost.evaluate_picks(picked, info),
        lambda: tpost.pick_kinetics(picked, info),
        lambda: tpost.pick_properties(picked, info),
        lambda: masking.generate_image(locs, info, 65.0, 100.0),
        lambda: tpost.next_frame_neighbor_distance_histogram(locs),
        lambda: tpost.get_link_groups(locs["frame"], locs["x"], locs["y"],
                                      1.0, 1, locs["group"]),
        lambda: tpost.link_loc_groups(locs, info, np.zeros(len(locs),
                                                           np.int32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    tpost.remove_locs_in_picks(locs, info, picks=[(10.0, 10.0)],
                               pick_shape="Circle", pick_size=1.0)
    one = _one_a_frame(locs)
    tpost.calculate_fret(one[:5], one[5:9])
