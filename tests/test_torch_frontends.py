"""The port's host front ends against picasso_tpu on the CPU: the origami
plate design and its sequence tables, the updater, the server's query
layer over the summary database, the folder watcher, the Streamlit
script's import guard, the rest of ``lib`` and the loose constants, and
the ``server`` and GUI verbs of the CLI.

What is held, and how closely:
- plates, sequence tables, design yaml and settings files: equal byte
  for byte;
- the updater: every case of tests/test_updater.py, and the settings
  file it leaves, equal to JAX's with HOME in a folder of its own and the
  network patched out (nothing is fetched);
- the query layer: the rows of the port's fetch_db, history, db_status
  and compare equal JAX's DataFrames turned into rows (NaN and None are
  one missing value), on one database that the port's
  localize.add_file_to_db wrote;
- the watcher: check_new's lists equal; process_file's locs held to
  JAX's by tests/torch_parity.compare_fits (the same MLE fits), every
  other column equal; on a machine without a card, ``watch`` with
  device="cuda" raises before it polls and ``process_file`` logs FAILED
  and returns None;
- the lib helpers: equal values, figures with the same data.
"""

from __future__ import annotations

import concurrent.futures
import io as _stdio
import json
import os
import sys
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import design as jdesign
from picasso_tpu import design_sequences as jseqs
from picasso_tpu import lib as jlib
from picasso_tpu import localize as jloc
from picasso_tpu import updater as jupd
from picasso_tpu.server import db as jdb
from picasso_tpu.server import watcher as jwatch
from picasso_torch import design as tdesign
from picasso_torch import design_sequences as tseqs
from picasso_torch import io as tio
from picasso_torch import lib as tlib
from picasso_torch import localize as tloc
from picasso_torch import updater as tupd
from picasso_torch.server import db as tdb
from picasso_torch.server import watcher as twatch
from torch_data import make_bench_movie, make_event_locs
from torch_parity import compare_fits


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """No test of this file reaches the network."""
    def refuse(*a, **k):
        raise OSError("network access is patched out in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


# ---------------------------------------------------------------------------
# design and design_sequences
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_plate_conversion_roundtrip(tmp_path, pkg):
    """tests/test_frontends.py::test_plate_conversion_roundtrip on either
    package."""
    design = {"jax": jdesign, "torch": tdesign}[pkg]
    plate = [["A1", "oligo_A1", "ACGT"], ["I5", "oligo_I5", "TTTT"]]
    out = design.convertPlateIndex(plate, "myplate")
    assert out[0] == ["PLATE NAME", "PLATE POSITION", "OLIGO NAME",
                      "SEQUENCE"]
    assert len(out) == 1 + 16 * 12
    assert ["myplate_1", "A1", "oligo_A1", "ACGT"] in out
    assert ["myplate_2", "A5", "oligo_I5", "TTTT"] in out
    path = str(tmp_path / "plate.csv")
    design.savePlate(path, [out])
    assert design.readPlate(path)[0] == out[0]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sequences_tables(pkg):
    """tests/test_frontends.py::test_sequences_tables on either package."""
    seqs = {"jax": jseqs, "torch": tseqs}[pkg]
    assert seqs.base_sequences[0] == ["Position", "Name", "Sequence"]
    assert len(seqs.base_sequences) > 100
    assert seqs.get_paint_sequence("P1") == "TTATACATCTA"
    with pytest.raises(KeyError):
        seqs.get_paint_sequence("P99")


def test_sequence_tables_and_plates_equal_jax(tmp_path):
    """The port's copies of the tables equal JAX's, and every plate it
    writes (with and without colours, a CSV and a saveInfo yaml) equals
    JAX's byte for byte."""
    assert tseqs.base_sequences == jseqs.base_sequences
    assert tseqs.paint_sequences == jseqs.paint_sequences
    for row in jseqs.paint_sequences[1:]:
        assert tseqs.get_paint_sequence(row[0]) == row[1]
    plate = [[r[0], r[1], r[2], i % 4]
             for i, r in enumerate(jseqs.base_sequences[1:40])]
    plate += [["P12", "odd, name", 'SEQ "q"', 3]]
    for name in ("convertPlateIndex", "convertPlateIndexColor"):
        got = getattr(tdesign, name)(plate, "CUSTOM")
        want = getattr(jdesign, name)(plate, "CUSTOM")
        assert got == want
        tdesign.savePlate(str(tmp_path / f"t_{name}.csv"), [got, got])
        jdesign.savePlate(str(tmp_path / f"j_{name}.csv"), [want, want])
        assert ((tmp_path / f"t_{name}.csv").read_bytes()
                == (tmp_path / f"j_{name}.csv").read_bytes())
        assert (tdesign.readPlate(str(tmp_path / f"t_{name}.csv"))
                == jdesign.readPlate(str(tmp_path / f"j_{name}.csv")))
    info = {"Structure": [["A", 1, 2]], "Extensions Short": ["P1"]}
    tdesign.saveInfo(str(tmp_path / "t.yaml"), info)
    jdesign.saveInfo(str(tmp_path / "j.yaml"), info)
    assert (tmp_path / "t.yaml").read_bytes() == (
        tmp_path / "j.yaml").read_bytes()


# ---------------------------------------------------------------------------
# updater
# ---------------------------------------------------------------------------


def _case_parse(up, mp):
    return (up._parse_version("1.2.3"), up._parse_version("0.10.3") >
            (0, 9, 9), up._parse_version("1.2rc1.0"),
            up._parse_version("x.y"))


def _case_offline(up, mp):
    mp.setattr(up, "get_latest_version", lambda *a, **k: None)
    return up.check_for_update(), up.is_update_available()


def _case_newer(up, mp):
    mp.setattr(up, "get_latest_version", lambda *a, **k: "999.0.0")
    return up.check_for_update(), up.is_update_available()


def _case_same(up, mp):
    mp.setattr(up, "get_latest_version", lambda *a, **k: up.__version__)
    return up.check_for_update(), up.is_update_available()


def _case_notify_once(up, mp):
    mp.setattr(up, "get_latest_version", lambda *a, **k: "999.0.0")
    messages = []
    first = up.check_and_notify(notify=messages.append)
    up.skip_version("999.0.0")
    second = up.check_and_notify(notify=messages.append)
    return first, second, messages, up.should_notify("999.0.0"), (
        up.should_notify("1000.0"))


def _case_snooze(up, mp):
    mp.setattr(up, "get_latest_version", lambda *a, **k: "999.0.0")
    up.snooze(days=3)
    return up.check_and_notify(notify=lambda m: None), (
        up.should_check_today())


def _case_check_and_mark(up, mp):
    before = up.should_check_today()
    up.mark_checked()
    return before, up.should_check_today()


def _case_url(up, mp):
    return up.get_update_url(), up.URL_LATEST_RELEASE_API


def _case_disable_and_dates(up, mp):
    up.disable_updates()
    disabled = up.should_check_today()
    up.disable_updates(False)
    up.snooze_until("2000-01-01")  # in the past: no effect
    past = up.should_check_today()
    up.snooze_until("2999-01-01")
    return disabled, past, up.should_check_today()


def _case_cli(up, mp):
    mp.setattr(up, "get_latest_version", lambda *a, **k: "999.0.0")
    out = []
    mp.setattr("builtins.print", lambda *a, **k: out.append(a))
    up.cli_notify_update()
    up.setup_gui_update_check("ignored", parent=None)  # checked today
    return out


def _case_pypi(up, mp):
    """The network refused, then a PyPI answer: get_latest_version
    swallows the error and reads the version."""
    refused = up.get_latest_version()

    class Answer(_stdio.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    body = json.dumps({"info": {"version": "3.4.5"}}).encode()
    mp.setattr(urllib.request, "urlopen", lambda *a, **k: Answer(body))
    return refused, up.get_latest_version(timeout=0.1), up.check_for_update()


@pytest.mark.parametrize("case", [
    _case_parse, _case_offline, _case_newer, _case_same, _case_notify_once,
    _case_snooze, _case_check_and_mark, _case_url, _case_disable_and_dates,
    _case_cli, _case_pypi], ids=lambda f: f.__name__[6:])
def test_updater_matches_jax(tmp_path, monkeypatch, case):
    """Each case of tests/test_updater.py (and the rest of the module's
    names) with HOME in a folder of its own: the port answers as JAX does
    and leaves the same settings file."""
    answers, settings = [], []
    for name, up in (("t", tupd), ("j", jupd)):
        home = tmp_path / name
        home.mkdir()
        with monkeypatch.context() as mp:
            mp.setenv("HOME", str(home))
            answers.append(case(up, mp))
        path = home / ".picasso" / "settings.yaml"
        settings.append(path.read_bytes() if path.exists() else None)
    assert answers[0] == answers[1]
    assert settings[0] == settings[1]


# ---------------------------------------------------------------------------
# server: the query layer over the summary database
# ---------------------------------------------------------------------------


def _norm(rows: list[dict]) -> list[dict]:
    """Rows with NaN as None (pandas reads a missing REAL as NaN)."""
    return [{k: None if isinstance(v, float) and v != v else v
             for k, v in r.items()} for r in rows]


def _df_rows(df: pd.DataFrame) -> list[dict]:
    return _norm(df.to_dict("records"))


@pytest.fixture
def summary_db(tmp_path, monkeypatch):
    """A database with two rows that the port's add_file_to_db wrote,
    and both packages' localize._db_filename pointed at it."""
    db = str(tmp_path / "app_0410.db")
    monkeypatch.setattr(tloc, "_db_filename", lambda: db)
    monkeypatch.setattr(jloc, "_db_filename", lambda: db)
    for k, (seed, drift) in enumerate([(40, None), (41, (0.5, -0.25))]):
        locs, info = make_event_locs(seed, n_sites=12 + 6 * k, frames=200)
        locs = locs[locs["frame"] < 200]  # drift is per frame of the movie
        info = [dict(info[0], **{"Box Size": 7, "Min. Net Gradient": 5000})]
        movie = tmp_path / f"m{k}.raw"
        movie.write_bytes(b"")
        hdf = tmp_path / f"m{k}_locs.hdf5"
        tio.save_locs(str(hdf), locs, info)
        kw = {} if drift is None else dict(drift=drift, len_mean=3.0,
                                           nena=0.04)
        tloc.add_file_to_db(str(movie), str(hdf), device="cpu", **kw)
    return db


def test_db_queries_match_jax(summary_db):
    rows = tdb.fetch_db()
    assert len(rows) == 2
    assert _norm(rows) == _df_rows(jdb.fetch_db())
    assert list(rows[0]) == list(jdb.fetch_db().columns)
    got, want = tdb.db_status(), jdb.db_status()
    assert got == want and got["n_entries"] == 2
    for sort_by in ("entry_created", "n_locs", "z_mean", "no such column"):
        assert _norm(tdb.history(sort_by)) == _df_rows(jdb.history(sort_by))
    assert [r["n_locs"] for r in tdb.history("n_locs")] == sorted(
        (r["n_locs"] for r in rows), reverse=True)
    a, b = (r["filename"] for r in rows)
    for pair in ((a, b), (b, a), (a, "missing")):
        ref = jdb.compare(*pair)
        got = tdb.compare(*pair)
        assert list(got) == list(ref.columns)
        assert {f: _norm([c])[0] for f, c in got.items()} == {
            f: _norm([ref[f].to_dict()])[0] for f in ref.columns}


def test_db_queries_without_a_database(tmp_path, monkeypatch):
    db = str(tmp_path / "none" / "app_0410.db")
    monkeypatch.setattr(tloc, "_db_filename", lambda: db)
    monkeypatch.setattr(jloc, "_db_filename", lambda: db)
    assert tdb.fetch_db() == [] and jdb.fetch_db().empty
    assert tdb.db_status() == jdb.db_status()
    assert tdb.history() == [] and jdb.history().empty
    assert tdb.compare("a", "b") == {} and jdb.compare("a", "b").empty


def test_db_path_is_the_ports_localize_database(tmp_path, monkeypatch):
    """Without a repointed database the query layer reads
    ~/.picasso/app_0410.db, as localize -db writes it."""
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tdb.db_status()["path"] == str(
        tmp_path / ".picasso" / "app_0410.db")
    assert tdb.db_status() == jdb.db_status()


# ---------------------------------------------------------------------------
# server: the folder watcher
# ---------------------------------------------------------------------------


WATCH_MOVIE = dict(n_frames=24, size=48, n_sites=24, p_on=0.5)


def _movie():
    m = WATCH_MOVIE
    return make_bench_movie(m["n_frames"], m["size"], m["n_sites"], m["p_on"],
                            np.random.default_rng(21))


def _folder(path, movie):
    """A watched folder: a raw movie, a TIFF whose _locs.hdf5 exists, a
    TIFF series' first file, and files the watcher skips."""
    from torch_data import write_tiff

    path.mkdir()
    tio.save_raw(str(path / "a.raw"), movie, [{
        "Byte Order": "<", "Data Type": "uint16", "Frames": len(movie),
        "Height": movie.shape[1], "Width": movie.shape[2]}])
    write_tiff(str(path / "b.ome.tif"), movie[:4])
    (path / "b.ome_locs.hdf5").write_bytes(b"")
    write_tiff(str(path / "c.tif"), movie[:4])
    (path / "notes.txt").write_text("x")
    return path


def test_check_new_matches_jax(tmp_path):
    folder = _folder(tmp_path / "w", _movie())
    t_log, j_log = tmp_path / "t.log", tmp_path / "j.log"
    got = twatch.check_new(str(folder), {}, str(t_log))
    want = jwatch.check_new(str(folder), {}, str(j_log))
    assert got == want
    assert sorted(os.path.basename(f) for f in got[0]) == ["a.raw", "c.tif"]
    assert os.path.normpath(str(folder / "b.ome.tif")) in got[1]
    assert t_log.read_text().split(" Checking")[1] == (
        j_log.read_text().split(" Checking")[1])
    assert twatch.FILETYPES == jwatch.FILETYPES
    again = twatch.check_new(str(folder), dict.fromkeys(
        [os.path.normpath(f) for f in got[0]], True))
    assert again[0] == []


def _fits(locs):
    order = np.lexsort((locs["x"], locs["y"], locs["frame"]))
    locs = locs[order]
    theta = np.stack([locs[c] for c in ("x", "y", "photons", "bg", "sx",
                                        "sy")]).astype(np.float32)
    crlb = np.stack([locs[c] ** 2 for c in ("lpx", "lpy", "photons_unc",
                                             "bg_unc", "sx_unc", "sy_unc")])
    return locs, (theta, crlb, locs["log_likelihood"],
                  locs["iterations"].astype(np.int32))


def test_process_file_matches_jax(tmp_path):
    """process_file on the CPU gives the locs and the info of JAX's
    process_file on the same movie, and logs the same line."""
    movie = _movie()
    outs, logs = [], []
    for name, fn in (("t", lambda f, log: twatch.process_file(
            f, {"Box Size": 7, "Gain": 1}, log, device="cpu")),
            ("j", lambda f, log: jwatch.process_file(
                f, {"Box Size": 7, "Gain": 1}, log))):
        folder = _folder(tmp_path / name, movie)
        log = str(tmp_path / f"{name}.log")
        out = fn(str(folder / "a.raw"), log)
        assert out == str(folder / "a_locs.hdf5")
        outs.append(tio.load_locs(out))
        logs.append(open(log).read())
    (t_locs, t_info), (j_locs, j_info) = outs
    assert t_locs.dtype == j_locs.dtype and len(t_locs) == len(j_locs) > 50
    for block in t_info + j_info:
        block.pop("File", None)
    assert t_info == j_info
    (t_sorted, t_fit), (j_sorted, j_fit) = _fits(t_locs), _fits(j_locs)
    compare_fits(j_fit, t_fit)
    np.testing.assert_array_equal(t_sorted["frame"], j_sorted["frame"])
    np.testing.assert_allclose(t_sorted["net_gradient"],
                               j_sorted["net_gradient"], rtol=1e-5)
    assert [ln.split(" ", 2)[2].replace(str(tmp_path / "t"), "")
            for ln in logs[0].splitlines()] == [
        ln.split(" ", 2)[2].replace(str(tmp_path / "j"), "")
        for ln in logs[1].splitlines()]


def test_process_file_looks_up_save_locs_at_call_time(tmp_path, monkeypatch):
    """process_file saves through io.save_locs as it finds it when
    called, so that a caller may replace it."""
    folder = _folder(tmp_path / "w", _movie())
    saved = []
    monkeypatch.setattr(tio, "save_locs", lambda path, locs, info:
                        saved.append((path, len(locs))))
    out = twatch.process_file(str(folder / "a.raw"), device="cpu")
    assert saved == [(out, saved[0][1])] and saved[0][1] > 0
    assert not os.path.exists(out)


def test_watch_localizes_every_new_movie_once(tmp_path, monkeypatch):
    """watch on the CPU: every new movie is localized once, the one with a
    _locs.hdf5 sibling is skipped, and a second poll finds nothing."""
    folder = _folder(tmp_path / "w", _movie())
    waited = []
    monkeypatch.setattr(twatch, "wait_for_change", waited.append)
    log = str(tmp_path / "watch.log")
    twatch.watch(str(folder), {"Min. Net Gradient": 4000}, log, poll_s=0,
                 max_iterations=2, device="cpu")
    lines = open(log).read().splitlines()
    processed = [ln for ln in lines if " Processed " in ln]
    assert len(processed) == 2 and not any("FAILED" in ln for ln in lines)
    assert sorted(os.path.basename(f) for f in waited) == ["a.raw", "c.tif"]
    assert (folder / "a_locs.hdf5").exists() and (folder / "c_locs.hdf5"
                                                  ).exists()
    assert sum(" Checking" in ln for ln in lines) == 2


def test_watcher_needs_the_card_or_cpu(tmp_path):
    """Without a card: watch(device="cuda") raises before it polls (no
    log, nothing written); process_file(device="cuda") logs FAILED and
    returns None, as JAX's does for any error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    folder = _folder(tmp_path / "w", _movie())
    log = tmp_path / "watch.log"
    with pytest.raises(RuntimeError, match="cuda"):
        twatch.watch(str(folder), logfile=str(log), poll_s=0,
                     max_iterations=1)
    assert not log.exists()
    assert twatch.process_file(str(folder / "a.raw"), logfile=str(log)) is None
    text = log.read_text()
    assert " FAILED " in text and "torch.cuda.is_available() is False" in text
    assert not (folder / "a_locs.hdf5").exists()
    # JAX's watcher logs any error so too
    assert jwatch.process_file(str(folder / "notes.txt"),
                               logfile=str(log)) is None
    assert log.read_text().count(" FAILED ") == 2


def test_server_app_without_streamlit_raises_jaxs_message(monkeypatch):
    """The Streamlit script raises JAX's ImportError, naming the port."""
    from picasso_torch.server import STREAMLIT_AVAILABLE
    from picasso_tpu.server import STREAMLIT_AVAILABLE as JAX_AVAILABLE

    assert STREAMLIT_AVAILABLE == JAX_AVAILABLE
    if STREAMLIT_AVAILABLE:
        pytest.skip("streamlit is installed")
    monkeypatch.setattr(sys, "path", list(sys.path))
    errors = []
    for name in ("picasso_torch.server.app", "picasso_tpu.server.app"):
        monkeypatch.delitem(sys.modules, name, raising=False)
        with pytest.raises(ImportError) as e:
            __import__(name)
        errors.append(str(e.value))
    assert errors[0] == errors[1].replace("picasso_tpu", "picasso_torch")
    assert "python -m picasso_torch server" in errors[0]


# ---------------------------------------------------------------------------
# the CLI's server and GUI verbs
# ---------------------------------------------------------------------------


def _verbs(main) -> set:
    out = _stdio.StringIO()
    with pytest.raises(SystemExit):
        sys.stdout, keep = out, sys.stdout
        try:
            main(["--help"])
        finally:
            sys.stdout = keep
    text = out.getvalue()
    return set(text[text.index("{") + 1:text.index("}")].split(","))


def test_cli_has_all_of_jaxs_verbs():
    from picasso_torch import __main__ as tcli
    from picasso_tpu import __main__ as jcli

    got, want = _verbs(tcli.main), _verbs(jcli.main)
    assert len(want) == 39 and got == want


@pytest.mark.parametrize("verb", ["filter", "design", "simulate", "average",
                                  "average3", "nanotron", "rotation"])
def test_cli_gui_verbs_without_a_display_match_jax(monkeypatch, capsys, verb):
    """With no display each GUI verb prints how to run the apps from
    Python, as JAX's does, and opens nothing."""
    from picasso_torch import __main__ as tcli
    from picasso_tpu import __main__ as jcli

    for var in ("DISPLAY", "WAYLAND_DISPLAY"):
        monkeypatch.delenv(var, raising=False)
    assert tcli.main([verb]) is None
    got = capsys.readouterr().out
    assert jcli.main([verb]) is None
    want = capsys.readouterr().out
    head = f"'{verb}' runs from python: picasso_%s.gui provides "
    assert got.startswith(head % "torch") and want.startswith(head % "tpu")
    tail = "All processing is also available headlessly through this CLI"
    assert tail in got and tail in want
    from picasso_torch import gui

    for app in ("RenderApp", "LocalizeApp", "FilterApp", "RotationApp",
                "AverageApp", "SimulateApp", "DesignApp", "SpinnaApp",
                "NanotronApp", "ToRawApp"):
        assert app in got and app in want and hasattr(gui, app)


@pytest.mark.parametrize("verb", ["filter", "rotation"])
def test_cli_gui_stub_names_every_app_as_jax(monkeypatch, capsys, verb):
    """The message is JAX's, for the port's package and with the port's
    Average3App beside AverageApp: the render window, the movie browser
    and the filter first."""
    from picasso_torch import __main__ as tcli
    from picasso_tpu import __main__ as jcli

    for var in ("DISPLAY", "WAYLAND_DISPLAY"):
        monkeypatch.delenv(var, raising=False)
    tcli.main([verb])
    got = capsys.readouterr().out
    jcli.main([verb])
    want = capsys.readouterr().out
    assert got == want.replace("picasso_tpu", "picasso_torch").replace(
        "AverageApp / ", "AverageApp / Average3App / ")
    assert "provides RenderApp / LocalizeApp / FilterApp / " in got


def test_cli_server_runs_streamlit_as_jax(monkeypatch):
    """`server` runs `python -m streamlit run <package>/server/app.py`."""
    import subprocess

    from picasso_torch import __main__ as tcli
    from picasso_tpu import __main__ as jcli

    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **k: calls.append(cmd))
    tcli.main(["server"])
    jcli.main(["server"])
    (t_cmd, j_cmd) = calls
    assert t_cmd[:-1] == j_cmd[:-1] == [sys.executable, "-m", "streamlit",
                                        "run"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert t_cmd[-1] == os.path.join(root, "picasso_torch", "server",
                                     "app.py")
    assert j_cmd[-1] == os.path.join(root, "picasso_tpu", "server", "app.py")


# ---------------------------------------------------------------------------
# the rest of lib, and the loose constants
# ---------------------------------------------------------------------------


def test_lib_helpers_match_jax():
    for n in (1, 3, 7):
        assert tlib.get_colors(n) == jlib.get_colors(n)
    for text in ("#00ff7F", "#00ff7", "00ff7f0", "#00fg7f", 7, None, "#"):
        assert tlib.is_hexadecimal(text) == jlib.is_hexadecimal(text)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(lambda: 1) for _ in range(3)]
        concurrent.futures.wait(futures)
        futures.append(concurrent.futures.Future())
        assert tlib.n_futures_done(futures) == jlib.n_futures_done(
            futures) == 3
    for name in ("IntArray1D", "IntArray2D", "IntArray3D", "FloatArray1D",
                 "FloatArray2D", "FloatArray3D", "BoolArray1D",
                 "BoolArray2D", "Array3x3", "SeriesOrFloatArray1D",
                 "SeriesOrIntArray1D", "SOUND_NOTIFICATION_DURATION"):
        assert getattr(tlib, name) == getattr(jlib, name), name
    assert tloc.LOCALIZATION_COLUMNS == jloc.LOCALIZATION_COLUMNS
    assert tloc.MEAN_COLS == jloc.MEAN_COLS
    from picasso_torch import g5m as tg5m
    from picasso_torch import gausslq as tlq
    from picasso_tpu import g5m as jg5m
    from picasso_tpu import gausslq as jlq

    assert tlq.GPUFIT_INSTALLED == jlq.GPUFIT_INSTALLED
    assert tg5m.N_TASKS == jg5m.N_TASKS


def test_progress_reporters_match_jax(capsys):
    """MockProgress, TqdmProgress and ProgressDialog take the same calls
    and report the same values; ProgressType holds the three."""
    for lib in (tlib, jlib):
        with lib.MockProgress(5, "x") as p:
            p.set_value(3)
            p.update()
            p.zero_progress("y")
            p.close()
    values = []
    for lib in (tlib, jlib):
        t = lib.TqdmProgress(10, "fit", disable=True)
        t.set_value(4)
        t.set_value(2)  # backwards: ignored
        t.update(3)
        seen = [t._value, t._tqdm.n]
        t.zero_progress("again")
        seen += [t._value, t._tqdm.n]
        t.close()
        d = lib.ProgressDialog("Fitting", 2, 12)
        d.set_value(5)
        seen += [d.value(), d.maximum(), list(d.get_iterator()),
                 list(d.get_iterator(0, 3))]
        d.zero_progress("next")
        seen += [d.value(), d.description_base]
        d.closeEvent()
        values.append(seen)
        assert set(lib.ProgressType.__args__) == {
            lib.ProgressDialog, lib.MockProgress, lib.TqdmProgress}
    capsys.readouterr()
    assert values[0] == values[1]


def test_qt_only_names_raise_as_jax():
    for name in ("Dialog", "StatusDialog", "install_excepthook"):
        with pytest.raises(tlib.QtOnlyAttributeError, match="Qt"):
            getattr(tlib, name)
        with pytest.raises(jlib.QtOnlyAttributeError):
            getattr(jlib, name)
        assert not hasattr(tlib, name) and not hasattr(jlib, name)
    assert issubclass(tlib.QtOnlyAttributeError, AttributeError)
    with pytest.raises(AttributeError, match="picasso_torch.lib"):
        tlib.no_such_name  # noqa: B018


def test_sound_notification_settings_match_jax(tmp_path, monkeypatch):
    """The sound settings round-trip through ~/.picasso/settings.yaml as
    JAX's do; neither package ships sounds."""
    answers, files = [], []
    for name, lib in (("t", tlib), ("j", jlib)):
        (tmp_path / name).mkdir()
        monkeypatch.setenv("HOME", str(tmp_path / name))
        first = lib.get_sound_notification_path()

        class Action:
            def objectName(self):
                return "bell.wav"

        lib.set_sound_notification(Action())
        named = lib.get_sound_notification_path()  # not bundled: None
        lib.set_sound_notification("None")
        answers.append((first, named, lib.get_sound_notification_path(),
                        lib.get_available_sound_notifications()))
        files.append((tmp_path / name / ".picasso" / "settings.yaml"
                      ).read_bytes())
    assert answers[0] == answers[1] == (None, None, None, ["None"])
    assert files[0] == files[1]


def _figure_data(fig):
    """What each axes of a figure shows: its title, labels, limits, and
    the data of its lines, collections and patches."""
    out = []
    for ax in fig.axes:
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                    ax.get_xlim(), ax.get_ylim(),
                    [line.get_xydata().tolist() for line in ax.lines],
                    [c.get_offsets().tolist() for c in ax.collections
                     if hasattr(c, "get_offsets")],
                    [(p.get_x(), p.get_height()) for p in ax.patches
                     if hasattr(p, "get_height")]))
    return out


def test_qc_plots_match_jax(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    locs, info = make_event_locs(3, n_sites=4, frames=120)
    locs = locs[(locs["group"] == 0) & (locs["frame"] < 120)]  # one site
    for kw in (dict(include_photons=True), dict(include_photons=False)):
        tfig, t_trace = tlib.plot_trace(locs, info, return_trace=True, **kw)
        jfig, j_trace = jlib.plot_trace(pd.DataFrame.from_records(locs),
                                        info, return_trace=True, **kw)
        assert _figure_data(tfig) == _figure_data(jfig)
        for a, b in zip(t_trace, j_trace):
            np.testing.assert_array_equal(a, b)
        plt.close(tfig)
        plt.close(jfig)
    rng = np.random.default_rng(2)
    clustered, sparse = rng.poisson(9, 60), rng.poisson(5, 80)
    for args in ((clustered, sparse), (clustered, []), ([], [])):
        np.random.seed(0)
        tfig, _ = tlib.plot_subclustering_check(
            *args, return_fig=True, clustering_dist=20.0, sparse_dist=50.0)
        np.random.seed(0)
        jfig, _ = jlib.plot_subclustering_check(
            *args, return_fig=True, clustering_dist=20.0, sparse_dist=50.0)
        assert _figure_data(tfig) == _figure_data(jfig)
        plt.close(tfig)
        plt.close(jfig)
    assert tlib.plot_subclustering_check(clustered, sparse,
                                         plot_path=str(tmp_path / "s.png")
                                         ) == (None, None)
    assert (tmp_path / "s.png").stat().st_size > 0
    for dims in ("xy", "xyz"):
        names = ["rel_sigma"] if dims == "xy" else [
            f"rel_sigma_{d}" for d in dims]
        mols = np.zeros(50, [(n, np.float32) for n in names + (
            ["z"] if dims == "xyz" else [])])
        for n in names:
            mols[n] = rng.uniform(0.5, 1.5, 50)
        tlib.plot_rel_sigma_check(mols, None, str(tmp_path / f"t{dims}.png"))
        jlib.plot_rel_sigma_check(pd.DataFrame.from_records(mols), None,
                                  str(tmp_path / f"j{dims}.png"))
        import imageio

        np.testing.assert_array_equal(
            imageio.v3.imread(tmp_path / f"t{dims}.png"),
            imageio.v3.imread(tmp_path / f"j{dims}.png"))
    assert not plt.get_fignums()
