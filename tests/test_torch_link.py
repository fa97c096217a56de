"""Linking and dark times of the port held against picasso_tpu on the CPU:
ops/link.py (the candidate successors by cells, the walk's Python twin),
postprocess.link_groups, link, _link_loc_groups, dark_times and
compute_dark_times.

JAX sorts the locs by frame with pandas' quicksort, which reorders rows
within a frame, and that order decides which successor a chain claims;
the port sorts stably. So the port gets the rows in the order JAX's sort
gives them (``df.sort_values(kind="quicksort", by="frame")``, taken once
here), and then:
- chain ids equal picasso_tpu.native.link_groups;
- the linked table equals JAX's bit for bit (f64 segment sums in index
  order on both sides; f32 and f64 coordinates);
- dark times equal.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import postprocess as jpost
from picasso_torch import postprocess as tpost
from picasso_torch.ops import link as link_ops
from torch_data import make_event_locs
from torch_native import loaded_native


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_order(locs: np.ndarray) -> np.ndarray:
    """The rows in the order JAX's link sorts them."""
    df = pd.DataFrame.from_records(locs)
    order = df.sort_values(kind="quicksort", by="frame").index.to_numpy()
    return locs[order]


def _f64(locs: np.ndarray, seed: int = 0) -> np.ndarray:
    """``locs`` with f64 x, y moved by a small drift, as undrift writes
    them."""
    out = np.empty(len(locs), [(n, np.float64 if n in ("x", "y") else
                                locs.dtype[n]) for n in locs.dtype.names])
    for n in locs.dtype.names:
        out[n] = locs[n]
    drift = np.random.default_rng(seed).normal(0, 0.01, locs["frame"].max() + 1)
    out["x"] -= drift[locs["frame"]]
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_table_equal(got: np.ndarray, ref: pd.DataFrame) -> None:
    rec = ref.to_records(index=False)
    assert got.dtype.names == rec.dtype.names
    for name in got.dtype.names:
        assert got.dtype[name] == rec.dtype[name], name
        np.testing.assert_array_equal(got[name], rec[name], err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("d_max,tol", [(1.0, 1), (0.05, 3), (0.5, 0),
                                       (0.35, 2), (2.0, 5)])
def test_link_groups_equal_native(seed, d_max, tol):
    locs = jax_order(make_event_locs(seed)[0])
    args = (locs["frame"], locs["x"], locs["y"], locs["group"], d_max, tol)
    want = loaded_native().link_groups(*args)
    got = tpost.link_groups(*args, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_loaded_native_restores_a_lost_build_race(monkeypatch):
    """A process left without the native library (another process was
    still writing it when this one imported picasso_tpu.native) gets it
    back from torch_native.loaded_native, with the same answers."""
    native = loaded_native()
    locs = jax_order(make_event_locs(0)[0])
    args = (locs["frame"], locs["x"], locs["y"], locs["group"], 1.0, 1)
    sweep = (np.array([1, 4], np.int64), np.array([0, 2], np.int64),
             np.array([2, 3], np.int64), np.array([0, 2, 4], np.int64))

    def answers():
        labels = np.full(6, -1, np.int32)
        native.cluster_label_sweep(*sweep, labels)
        return native.link_groups(*args), labels

    before = answers()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "AVAILABLE", False)
    with pytest.raises(AttributeError):
        native.link_groups(*args)
    assert loaded_native() is native
    assert native.AVAILABLE and native._lib is not None
    for got, want in zip(answers(), before):
        np.testing.assert_array_equal(got, want)


def test_loaded_native_raises_when_the_library_stays_missing(monkeypatch):
    """If loading again fails too, the helper says so; it never skips."""
    native = loaded_native()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "AVAILABLE", False)
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="libpicasso_native"):
        loaded_native()


def test_link_groups_of_f64_coordinates_cast_to_f32_as_native():
    locs = jax_order(_f64(make_event_locs(2)[0]))
    args = (locs["frame"], locs["x"], locs["y"], locs["group"], 0.1, 1)
    np.testing.assert_array_equal(tpost.link_groups(*args, device="cpu"),
                                  loaded_native().link_groups(*args))


@pytest.mark.parametrize("budget", [1, 7, 1000])
def test_successors_in_chunks_equal_brute_force(budget):
    """The CSR equals a brute-force scan of every pair with the native
    test, whatever the pair budget; the walk over it equals the native
    chain ids."""
    locs = make_event_locs(3, n_sites=10, frames=80, size=12)[0]
    frame = locs["frame"].astype(np.int64)
    x = locs["x"].astype(np.float64)
    y = locs["y"].astype(np.float64)
    g = locs["group"].astype(np.int64)
    d_max, tol = 0.8, 2
    off, succ = link_ops.successors(_t(frame), _t(locs["x"]), _t(locs["y"]),
                                    _t(g), d_max, tol, budget=budget)
    off, succ = off.numpy(), succ.numpy()
    d2 = d_max * d_max
    for i in range(len(locs)):
        dx2, dy2 = (x[i] - x) ** 2, (y[i] - y) ** 2
        ok = ((frame > frame[i]) & (frame <= frame[i] + tol + 1)
              & (g == g[i]) & (dx2 <= d2) & (dy2 <= d2) & (dx2 + dy2 <= d2))
        np.testing.assert_array_equal(succ[off[i]:off[i + 1]], np.nonzero(ok)[0])
    np.testing.assert_array_equal(
        link_ops.walk(_t(off), _t(succ)).numpy(),
        loaded_native().link_groups(locs["frame"], locs["x"], locs["y"],
                                    locs["group"], d_max, tol))


def test_successors_on_cell_edges_negative_coordinates_and_one_cell():
    """Points exactly on cell edges (multiples of d_max), at negative
    coordinates (link does not sanitize) and all within one cell: the
    CSR equals the native test on every pair."""
    d_max = 0.5
    xs = np.array([0.0, 0.5, 1.0, -0.5, -1.0, -0.25, 0.25, 1.5, -1.5, 0.75],
                  np.float32)
    rng = np.random.default_rng(4)
    n = 400
    x = rng.choice(xs, n) + rng.choice([0, 0, 1e-7, -1e-7], n).astype(
        np.float32)
    y = rng.choice(xs, n)
    frame = np.sort(rng.integers(0, 20, n)).astype(np.int64)
    g = rng.integers(0, 2, n).astype(np.int64)
    for xx, yy in ((x, y), (x * 0 + 3.1, y * 0 - 2.2)):
        off, succ = link_ops.successors(_t(frame), _t(xx), _t(yy), _t(g),
                                        d_max, 1, budget=64)
        off, succ = off.numpy(), succ.numpy()
        x64, y64 = xx.astype(np.float64), yy.astype(np.float64)
        for i in range(n):
            dx2, dy2 = (x64[i] - x64) ** 2, (y64[i] - y64) ** 2
            ok = ((frame > frame[i]) & (frame <= frame[i] + 2) & (g == g[i])
                  & (dx2 <= 0.25) & (dy2 <= 0.25) & (dx2 + dy2 <= 0.25))
            np.testing.assert_array_equal(succ[off[i]:off[i + 1]],
                                          np.nonzero(ok)[0])
        np.testing.assert_array_equal(
            link_ops.walk(_t(off), _t(succ)).numpy(),
            loaded_native().link_groups(frame, xx, yy, g.astype(np.int32),
                                        d_max, 1))


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("d_max,tol", [(1.0, 1), (0.05, 3)])
def test_link_table_matches_jax(f64, d_max, tol):
    locs, info = make_event_locs(5)
    if f64:
        locs = _f64(locs)
    got = tpost.link(jax_order(locs), info, r_max=d_max, max_dark_time=tol,
                     device="cpu")
    ref = jpost.link(pd.DataFrame.from_records(locs), info, r_max=d_max,
                     max_dark_time=tol)
    _assert_table_equal(got, ref)
    assert 0 < len(got) < len(locs)


def test_link_keeps_every_event_without_removing_ambiguous_lengths():
    locs, info = make_event_locs(6)
    kw = dict(r_max=1.0, max_dark_time=1, remove_ambiguous_lengths=False)
    got = tpost.link(jax_order(locs), info, device="cpu", **kw)
    ref = jpost.link(pd.DataFrame.from_records(locs), info, **kw)
    _assert_table_equal(got, ref)
    assert got["frame"].min() == 0
    assert (got["frame"] + got["len"] - 1).max() >= info[0]["Frames"]


def test_link_3d_columns_match_jax():
    """z with lpz as a weighted mean, d_zcalib and z without lpz as
    means."""
    locs, info = make_event_locs(7)
    rng = np.random.default_rng(7)
    extra = [("z", np.float32), ("lpz", np.float32), ("d_zcalib", np.float32),
             ("ellipticity", np.float32)]
    full = np.empty(len(locs), locs.dtype.descr + extra)
    for n in locs.dtype.names:
        full[n] = locs[n]
    full["z"] = rng.normal(0, 80, len(locs))
    full["lpz"] = rng.uniform(0.05, 0.3, len(locs))
    full["d_zcalib"] = rng.uniform(0, 1, len(locs))
    full["ellipticity"] = rng.uniform(0, 0.5, len(locs))
    for cols in (full.dtype.names, [n for n in full.dtype.names
                                    if n != "lpz"]):
        sub = full[list(cols)]
        got = tpost.link(jax_order(sub), info, r_max=1.0, max_dark_time=1,
                         device="cpu")
        ref = jpost.link(pd.DataFrame.from_records(sub), info, r_max=1.0,
                         max_dark_time=1)
        _assert_table_equal(got, ref)


def test_link_without_group_and_empty_input_match_jax():
    locs, info = make_event_locs(8)
    locs = locs[[n for n in locs.dtype.names if n != "group"]]
    got = tpost.link(jax_order(locs), info, r_max=1.0, max_dark_time=1,
                     device="cpu")
    ref = jpost.link(pd.DataFrame.from_records(locs), info, r_max=1.0,
                     max_dark_time=1)
    _assert_table_equal(got, ref)
    empty = make_event_locs(8)[0][:0]
    _assert_table_equal(tpost.link(empty, info, device="cpu"),
                        jpost.link(pd.DataFrame.from_records(empty), info))


def test_link_refit_raises():
    locs, info = make_event_locs(9)
    with pytest.raises(NotImplementedError, match="Refit"):
        tpost.link(locs, info, combine_mode="refit", device="cpu")
    with pytest.raises(NotImplementedError, match="Refit"):
        jpost.link(pd.DataFrame.from_records(locs), info,
                   combine_mode="refit")


def test_link_rows_in_frame_keep_their_order():
    """The port sorts stably: on its own row order its chains are those
    of native.link_groups on that order (JAX's quicksort would reorder
    the rows within a frame first)."""
    locs, info = make_event_locs(10)
    shuffled = locs[np.random.default_rng(1).permutation(len(locs))]
    stable = shuffled[np.argsort(shuffled["frame"], kind="stable")]
    ids = loaded_native().link_groups(stable["frame"], stable["x"],
                                      stable["y"], stable["group"], 1.0, 1)
    got = tpost.link(shuffled, info, r_max=1.0, max_dark_time=1,
                     remove_ambiguous_lengths=False, device="cpu")
    assert len(got) == ids.max() + 1
    np.testing.assert_array_equal(
        got["n"], np.bincount(ids, minlength=ids.max() + 1))


@pytest.mark.parametrize("explicit_group", [False, True])
def test_dark_times_match_jax(explicit_group):
    locs, info = make_event_locs(11)
    linked = tpost.link(jax_order(locs), info, r_max=1.0, max_dark_time=1,
                        device="cpu")
    df = pd.DataFrame.from_records(linked)
    group = (np.random.default_rng(0).integers(0, 3, len(linked))
             if explicit_group else None)
    got = tpost.dark_times(linked, group, device="cpu")
    want = jpost.dark_times(df, group)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got == -1).sum() > 0 and (got > 1).sum() > 0
    _assert_table_equal(tpost.compute_dark_times(linked, group, device="cpu"),
                        jpost.compute_dark_times(df, group))


def test_dark_times_without_group_and_without_len():
    locs, info = make_event_locs(12)
    linked = tpost.link(jax_order(locs), info, r_max=1.0, max_dark_time=1,
                        device="cpu")
    linked = linked[[n for n in linked.dtype.names if n != "group"]]
    df = pd.DataFrame.from_records(linked)
    np.testing.assert_array_equal(tpost.dark_times(linked, device="cpu"),
                                  jpost.dark_times(df))
    _assert_table_equal(tpost.compute_dark_times(linked, device="cpu"),
                        jpost.compute_dark_times(df))
    with pytest.raises(AttributeError, match="link localizations first"):
        tpost.compute_dark_times(locs, device="cpu")


@pytest.mark.parametrize("max_dark_time", [3, 999_999, 10**9])
def test_link_with_any_dark_time_matches_jax(max_dark_time):
    """r_max 1e9 (every loc of a group within reach) at the dark times of
    the pick analyses: combine_locs_in_picks' 10**9, evaluate_picks'
    r_max 999999 at its default 3, and 999,999; the events equal JAX's
    (its native walk visits every pair); beyond the movie's length a
    group's chains are as many as its locs in its busiest frame."""
    locs, info = make_event_locs(15)
    kw = dict(r_max=1e9, max_dark_time=max_dark_time,
              remove_ambiguous_lengths=False)
    got = tpost.link(jax_order(locs), info, device="cpu", **kw)
    ref = jpost.link(pd.DataFrame.from_records(locs), info, **kw)
    _assert_table_equal(got, ref)
    if max_dark_time > info[0]["Frames"]:
        busiest = sum(np.unique(locs["frame"][locs["group"] == g],
                                return_counts=True)[1].max()
                      for g in np.unique(locs["group"]))
        assert len(got) == busiest


def test_window_ranges_do_not_grow_with_the_window():
    """ops/link.window_ranges: nine ranges a loc whatever the window (the
    3 x 3 cells, each one run of frames), a window beyond the frame span
    gives the ranges of the span itself, and the pairs of a 10**9-frame
    window are every later loc of the group in touching cells."""
    locs = make_event_locs(16, n_sites=8, frames=120, size=10)[0]
    cols = [_t(locs["frame"].astype(np.int64)),
            _t(locs["x"].astype(np.float64)), _t(locs["y"].astype(np.float64)),
            _t(locs["group"].astype(np.int64))]
    n = len(locs)
    span = int(locs["frame"].max()) - int(locs["frame"].min()) + 1
    shapes = {}
    for window in (1, 4, span, 10**6, 10**9 + 1):
        lo, hi, _ = link_ops.window_ranges(*cols, 1e9, window)
        shapes[window] = (tuple(lo.shape), tuple(hi.shape))
        if window >= span:
            lo_s, hi_s, _ = link_ops.window_ranges(*cols, 1e9, span)
            assert torch.equal(lo, lo_s) and torch.equal(hi, hi_s)
    assert set(shapes.values()) == {((n, 9), (n, 9))}
    pairs = np.concatenate([np.stack([i.numpy(), j.numpy()], 1) for i, j in
                            link_ops.window_pairs(*cols, 1e9, 10**9 + 1)])
    frame, g = locs["frame"].astype(np.int64), locs["group"]
    want = {(a, b) for a in range(n) for b in range(n)
            if frame[b] > frame[a] and g[a] == g[b]}
    assert set(map(tuple, pairs.tolist())) == want
    assert len(pairs) == len(want)
