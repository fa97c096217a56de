"""The summary database of ``localize -db`` in the port, held against
picasso_tpu on the CPU: the checks (localize.check_nena, check_kinetics,
check_drift), the ``files`` row that add_file_to_db writes through
sqlite3 alone against the row JAX writes through pandas' to_sql, and the
CLI's ``localize -db`` against the JAX CLI's.

Tolerances, with what was measured on the CPU (numpy 2, pandas 3, torch
2.13):
- NeNA equal (the same distance histogram and the same curve_fit on
  it), the mean event length equal (the same chains: the rows hold one
  loc a site and frame, so no order within a frame decides a link);
- the mean drift within DRIFT_AGREE = 1e-5 px (the port correlates in
  f64, numpy 2 JAX's f32 segments in complex64; measured 1.3e-8 px);
- the columns' means and stds equal (lib.series_mean_std is pandas'
  arithmetic), the settings, counts and file names equal, the file's
  time equal and the entry's time compared by format only;
- the SQLite declared types and the storage class of every value equal
  to pandas' (REAL, INTEGER for int and bool, TEXT for str and for a
  column of NaN only, TIMESTAMP as 'YYYY-MM-DD HH:MM:SS[.ffffff]' text,
  BLOB for numpy int64 and float32 scalars);
- for the CLI, whose two runs fit the movie each with its own package,
  every REAL within CLI_RTOL = 1e-4 relative (the MLE fits agree within
  tests/torch_parity.compare_fits; measured 3.9e-5, lpy_std) and the
  rest equal.
"""

from __future__ import annotations

import re
import sqlite3
from datetime import datetime

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import io as jio
from picasso_tpu import localize as jloc
from picasso_torch import localize as tloc
from torch_data import make_bench_movie, make_event_locs
from torch_native import loaded_native

DRIFT_AGREE = 1e-5  # px
CLI_RTOL = 1e-4
STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d(\.\d{6})?$")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _native_loaded():
    """picasso_tpu.localize.get_spots (and fit2D, fit and localize through
    it) converts a C-contiguous u16 movie with one factor only while
    picasso_tpu.native is loaded, and in three roundings otherwise; the
    port mirrors the one-factor route. A test process that lost the
    native library's build race would hold the port to the other route:
    load the library first (torch_native.loaded_native)."""
    loaded_native()


def _events(seed: int = 40):
    """make_event_locs with one loc a site and frame (the second loc that
    some frames hold is dropped, and the loc one past the movie),
    frame-sorted, 400 frames of 32 x 32 px, with the settings -db
    copies."""
    locs, info = make_event_locs(seed, n_sites=24, frames=400)
    drop = locs["frame"] >= 400  # one past the movie: no drift there
    drop[1:] |= (locs["frame"][1:] == locs["frame"][:-1]) & (
        np.abs(locs["x"][1:] - locs["x"][:-1]) < 0.3)
    info = [dict(info[0], **{"Box Size": 7, "Min. Net Gradient": 5000})]
    return locs[~drop], info


def _df(locs):
    return pd.DataFrame.from_records(locs)


def test_checks_match_jax():
    locs, info = _events()
    assert tloc.check_nena(locs, info, device="cpu") == jloc.check_nena(
        _df(locs), info)
    assert tloc.check_kinetics(locs, info, device="cpu") == (
        jloc.check_kinetics(_df(locs), info))
    np.testing.assert_allclose(tloc.check_drift(locs, info, device="cpu"),
                               jloc.check_drift(_df(locs), info), rtol=0,
                               atol=DRIFT_AGREE)
    # a table without precisions: the NeNA fit fails, NaN in both
    bare = locs[["frame", "x", "y", "group"]]
    assert np.isnan(tloc.check_nena(bare, info, device="cpu"))
    assert np.isnan(jloc.check_nena(_df(bare), info))


def _rows(home):
    """(PRAGMA table_info rows, [(value, typeof(value)) per column] per
    row) of the files table under ``home``."""
    con = sqlite3.connect(home / ".picasso" / "app_0410.db")
    try:
        cols = con.execute('PRAGMA table_info("files")').fetchall()
        names = [c[1] for c in cols]
        quoted = ['"' + n.replace('"', '""') + '"' for n in names]
        sel = ", ".join(f"{q}, typeof({q})" for q in quoted)
        rows = con.execute(f'SELECT {sel} FROM "files"').fetchall()
    finally:
        con.close()
    return cols, [list(zip(r[::2], r[1::2])) for r in rows]


def _both(tmp_path, monkeypatch, fn_t, fn_j):
    """``fn_t()`` with HOME at tmp_path/t, ``fn_j()`` at tmp_path/j;
    returns the two databases' contents."""
    out = []
    for d, fn in (("t", fn_t), ("j", fn_j)):
        (tmp_path / d).mkdir(exist_ok=True)
        monkeypatch.setenv("HOME", str(tmp_path / d))
        fn()
        out.append(_rows(tmp_path / d))
    return out


def test_save_file_summary_matches_pandas_to_sql(tmp_path, monkeypatch):
    """Every kind of value a summary may hold, through the port's sqlite3
    writer and through JAX's pandas to_sql: the same declared types, in
    the summary's order, and the same stored values and storage classes;
    a second row appended to the existing table keeps its types."""
    first = {
        "x_mean": 1.5, "n_locs": 2, "filename": "a.raw", "flag": True,
        "file_created": datetime(2026, 1, 2, 3, 4, 5, 678901),
        "entry_created": datetime(2026, 1, 2, 3, 4, 5), "z_mean": np.nan,
        "none": None, "frames64": np.int64(3), "px32": np.float32(2.5),
        "quote\"d name": 7.25,
    }
    second = dict(first, x_mean=-0.25, n_locs=5, z_mean=1.0, none="later",
                  flag=False, frames64=4)

    def write(save):
        save(dict(first))
        save(dict(second))

    (cols_t, rows_t), (cols_j, rows_j) = _both(
        tmp_path, monkeypatch, lambda: write(tloc._save_file_summary),
        lambda: write(jloc._save_file_summary))
    assert cols_t == cols_j
    assert [c[1] for c in cols_t] == list(first)
    assert dict((c[1], c[2]) for c in cols_t) == {
        "x_mean": "REAL", "n_locs": "INTEGER", "filename": "TEXT",
        "flag": "INTEGER", "file_created": "TIMESTAMP",
        "entry_created": "TIMESTAMP", "z_mean": "TEXT", "none": "TEXT",
        "frames64": "INTEGER", "px32": "REAL", "quote\"d name": "REAL"}
    assert rows_t == rows_j
    assert rows_t[0][4] == ("2026-01-02 03:04:05.678901", "text")
    assert rows_t[0][6] == (None, "null")
    assert rows_t[0][8][1] == "blob"


def test_add_file_to_db_matches_jax(tmp_path, monkeypatch):
    """add_file_to_db on one movie and locs file, through both packages:
    the same column names in the same order, the same declared types
    (the missing z columns and the NaN-only column TEXT, the times
    TIMESTAMP, the counts INTEGER) and the values within the check
    tolerances; the second call, with the checks given, appends."""
    locs, info = _events()
    movie = tmp_path / "ev.raw"
    movie.write_bytes(b"")
    hdf = tmp_path / "ev_locs.hdf5"
    jio.save_locs(str(hdf), _df(locs), info)

    def run(add):
        add(str(movie), str(hdf))
        add(str(movie), None, drift=(0.5, -0.25), len_mean=3.0, nena=0.04)

    (cols_t, rows_t), (cols_j, rows_j) = _both(
        tmp_path, monkeypatch,
        lambda: run(lambda *a, **k: tloc.add_file_to_db(*a, **k,
                                                          device="cpu")),
        lambda: run(jloc.add_file_to_db))
    assert cols_t == cols_j
    names = [c[1] for c in cols_t]
    types = {c[1]: c[2] for c in cols_t}
    assert names[:2] == ["frame_mean", "frame_std"]
    assert types["z_mean"] == types["lpz_std"] == "TEXT"
    assert types["file_created"] == types["entry_created"] == "TIMESTAMP"
    assert types["n_locs"] == types["frames"] == "INTEGER"
    assert len(rows_t) == len(rows_j) == 2
    for rt, rj in zip(rows_t, rows_j):
        for name, (vt, kt), (vj, kj) in zip(names, rt, rj):
            assert kt == kj, name
            if name == "entry_created":
                assert STAMP.match(vt) and STAMP.match(vj)
            elif name in ("drift_x", "drift_y"):
                np.testing.assert_allclose(vt, vj, rtol=0, atol=DRIFT_AGREE)
            else:
                assert vt == vj, name
    assert rows_t[1][names.index("filename_hdf")][0] == str(hdf)


def test_cli_localize_db_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """``localize x.raw -d 0 -db --device cpu`` against the JAX CLI's
    ``localize x.raw -d 0 -db``: one files row each, the same columns,
    declared types and storage classes, the REAL values within CLI_RTOL,
    the rest equal but for the paths and the times."""
    from picasso_torch import __main__ as tmain
    from picasso_tpu import __main__ as jmain

    movie = make_bench_movie(200, 32, 8, 0.5, np.random.default_rng(41))
    info = [{"Byte Order": "<", "Data Type": "uint16", "Frames": 200,
             "Height": 32, "Width": 32}]
    out = {}

    def run(d, main, extra):
        jio.save_raw(str(tmp_path / d / "x.raw"), movie, info)
        main(["localize", str(tmp_path / d / "x.raw"), "-d", "0", "-g",
              "4000", "-db"] + extra)
        out[d] = capsys.readouterr().out.replace(str(tmp_path / d), "")

    (cols_t, rows_t), (cols_j, rows_j) = _both(
        tmp_path, monkeypatch, lambda: run("t", tmain.main,
                                           ["--device", "cpu"]),
        lambda: run("j", jmain.main, []))
    assert out["t"] == out["j"]
    assert cols_t == cols_j and len(rows_t) == len(rows_j) == 1
    types = {c[1]: c[2] for c in cols_t}
    for name, (vt, kt), (vj, kj) in zip(types, rows_t[0], rows_j[0]):
        assert kt == kj, name
        if name.startswith("file") or name == "entry_created":
            continue
        if types[name] == "REAL":
            np.testing.assert_allclose(vt, vj, rtol=CLI_RTOL, err_msg=name)
        else:
            assert vt == vj, name
    row = dict(zip(types, (v for v, _ in rows_t[0])))
    assert row["n_locs"] > 100 and row["frames"] == 200
    assert row["filename"] == str(tmp_path / "t" / "x.raw")
