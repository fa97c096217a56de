"""The port's localize slice (identify -> cut -> MLE fit -> locs -> HDF5)
held against picasso_tpu.localize on the same movie (CPU), plus the
``python -m picasso_torch localize`` CLI.

Hit lists and fits are held to the tolerances of tests/torch_parity.py.
"""

from __future__ import annotations

import os
import subprocess
import sys

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from torch_data import make_bench_movie
from picasso_tpu import io as jio
from picasso_tpu import lib as jlib
from picasso_tpu import localize as jloc
from picasso_tpu.ops import fused as jfused
from picasso_torch import __main__ as cli
from picasso_torch import io as tio
from picasso_torch import localize as tloc
from picasso_torch.ops import fused as tfused
from torch_parity import compare_fits, compare_hits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
MIN_NG = 4000
PARAMS = {"Min. Net Gradient": MIN_NG, "Box Size": 7}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def movie():
    return make_bench_movie(32, 64, 40, 0.5, np.random.default_rng(7))


def _movie_info(movie):
    return [{"Byte Order": "<", "Data Type": "uint16",
             "Frames": movie.shape[0], "Height": movie.shape[1],
             "Width": movie.shape[2]}]


@pytest.fixture(scope="module")
def jax_localized(movie):
    return jloc.localize(movie, dict(CAMERA), PARAMS,
                         movie_info=_movie_info(movie),
                         fitting_method="gaussmle", return_info=True)


def _by_position(locs: np.ndarray) -> np.ndarray:
    """Rows ordered by (frame, y, x): pandas' quicksort in the JAX
    package may permute the locs of one frame."""
    return locs[np.lexsort((locs["x"], locs["y"], locs["frame"]))]


def test_localize_fused_matches_jax(movie):
    j_ids, j_fits = jfused.localize_fused(movie, MIN_NG, 7, dict(CAMERA))
    t_ids, t_fits = tfused.localize_fused(movie, MIN_NG, 7, dict(CAMERA),
                                          device="cpu")
    ref = [j_ids[c].to_numpy() for c in ("frame", "y", "x", "net_gradient")]
    got = [t_ids[c] for c in ("frame", "y", "x", "net_gradient")]
    assert len(ref[0]) > 300
    compare_hits(ref, got, MIN_NG)
    assert len(ref[0]) == len(got[0])
    for c in ("frame", "y", "x"):
        np.testing.assert_array_equal(ref[("frame", "y", "x").index(c)],
                                      got[("frame", "y", "x").index(c)])
    theta_j, crlb_j, ll_j, it_j = j_fits
    theta_t, crlb_t, ll_t, it_t = t_fits
    compare_fits((theta_j.T, crlb_j.T, ll_j, it_j),
                 (theta_t.T, crlb_t.T, ll_t, it_t))


def test_localize_matches_jax(movie, jax_localized):
    j_locs, j_info = jax_localized
    t_locs, t_info = tloc.localize(movie, dict(CAMERA), PARAMS,
                                   movie_info=_movie_info(movie),
                                   fitting_method="gaussmle",
                                   return_info=True, device="cpu")
    assert t_info == j_info
    j_rec = j_locs.to_records(index=False)
    assert t_locs.dtype == j_rec.dtype
    assert np.all(np.diff(t_locs["frame"].astype(np.int64)) >= 0)
    j_rec, t_sorted = _by_position(j_rec), _by_position(t_locs)
    np.testing.assert_array_equal(t_sorted["frame"], j_rec["frame"])
    same = (j_rec["iterations"] == t_sorted["iterations"]) & (
        j_rec["iterations"] < 100
    )
    assert same.mean() >= 0.95
    for c in ("x", "y"):
        np.testing.assert_allclose(t_sorted[c][same], j_rec[c][same],
                                   rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_sorted["net_gradient"],
                               j_rec["net_gradient"], rtol=1e-5)


def test_save_locs_byte_compatible(tmp_path, jax_localized):
    """The same table written by both packages gives identical files."""
    j_locs, j_info = jax_localized
    rec = np.asarray(j_locs.to_records(index=False))
    tio.save_locs(str(tmp_path / "t_locs.hdf5"), rec, j_info)
    jio.save_locs(str(tmp_path / "j_locs.hdf5"), pd.DataFrame(rec), j_info)
    for ext in (".hdf5", ".yaml"):
        assert (tmp_path / f"t_locs{ext}").read_bytes() == (
            tmp_path / f"j_locs{ext}"
        ).read_bytes()


def _write_raw(path, movie):
    jio.save_raw(str(path), movie, _movie_info(movie))


def test_cli_localize_writes_the_jax_locs_layout(tmp_path, movie,
                                                 jax_localized):
    _write_raw(tmp_path / "x.raw", movie)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "picasso_torch", "localize", "x.raw",
         "-d", "0", "-g", str(MIN_NG), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    with h5py.File(tmp_path / "x_locs.hdf5", "r") as f:
        t_rec = f["locs"][()]
    j_locs, j_info = jax_localized
    j_rec = j_locs.to_records(index=False)
    assert t_rec.dtype == j_rec.dtype
    assert t_rec.dtype.names == tuple(j_locs.columns)
    assert len(t_rec) == len(jlib.ensure_sanity(j_locs, j_info))
    t_info = tio.load_info(str(tmp_path / "x_locs.hdf5"))
    assert [d.get("Generated by") for d in t_info[1:]] == [
        "Picasso: v0.1.0 Identify", "Picasso: v0.1.0 Fit 2D",
    ]
    assert t_info[2]["Fit method"] == "gaussmle"
    assert t_info[1]["Min. Net Gradient"] == MIN_NG


def test_cli_undrift_exits_2_before_any_work(tmp_path, movie, capsys):
    """A movie shorter than two segments at the default -d 1000: the
    undrift is refused with the JAX CLI's message before any of its work,
    the locs stay and the run ends normally, with no drift written."""
    _write_raw(tmp_path / "x.raw", movie[:2])
    cli.main(["localize", str(tmp_path / "x.raw"), "--device", "cpu"])
    assert "RCC undrift failed: Segmentation 1000 gives 0 segment(s)" in (
        capsys.readouterr().out)
    assert (tmp_path / "x_locs.hdf5").exists()
    assert not (tmp_path / "x_locs_drift.txt").exists()
    assert not (tmp_path / "x_locs_undrift.hdf5").exists()


def test_cli_profile_writes_a_trace(tmp_path, movie):
    _write_raw(tmp_path / "x.raw", movie[:4])
    cli.main(["localize", str(tmp_path / "x.raw"), "-d", "0", "--device",
              "cpu", "--profile", str(tmp_path / "prof")])
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert (tmp_path / "x_locs.hdf5").exists()


@pytest.mark.parametrize("method", ["lq-3d", "avg"])
def test_cli_unported_fit_methods_exit_2(tmp_path, method):
    with pytest.raises(SystemExit) as exc:
        cli.main(["localize", str(tmp_path / "x.raw"), "-d", "0",
                  "-a", method, "--device", "cpu"])
    assert exc.value.code == 2


def test_cuda_without_a_card_raises(tmp_path, movie):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _write_raw(tmp_path / "x.raw", movie[:2])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["localize", str(tmp_path / "x.raw"), "-d", "0"])
    with pytest.raises(RuntimeError, match="cuda"):
        tloc.localize(movie[:2], dict(CAMERA), PARAMS,
                      fitting_method="gaussmle")


def test_localize_unported_methods_raise(movie):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloc.localize(movie, dict(CAMERA), PARAMS, fitting_method="avg",
                      device="cpu")
    per_pixel = dict(CAMERA, Baseline=np.zeros(movie.shape[1:]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloc.localize(movie, per_pixel, PARAMS, device="cpu")


@pytest.mark.parametrize("key", ["frame", "n_id"])
def test_locs_from_fits_matches_jax(key):
    """Columns, dtypes, values and order; unique keys, so the JAX
    package's unstable quicksort and the port's stable sort agree."""
    from picasso_torch import gaussmle as tg
    from picasso_tpu import gaussmle as jg

    n = 3000
    rng = np.random.default_rng(11)
    fields = [("frame", np.int64), ("x", np.int64), ("y", np.int64),
              ("net_gradient", np.float32)]
    if key == "n_id":
        fields.append(("n_id", np.int64))
    ids = np.zeros(n, dtype=fields)
    ids["frame"] = rng.integers(0, 50, n)
    ids[key] = rng.permutation(n)
    ids["x"] = rng.integers(3, 60, n)
    ids["y"] = rng.integers(3, 60, n)
    ids["net_gradient"] = rng.random(n) * 1e4
    theta = (rng.random((n, 6)) + 0.5).astype(np.float32)
    crlb = (rng.random((n, 6)) - 0.1).astype(np.float32)  # some NaN lp
    ll = -rng.random(n).astype(np.float32) * 50
    iters = rng.integers(1, 101, n).astype(np.int32)
    t = tg.locs_from_fits(ids, theta, crlb, ll, iters, 7)
    j = jg.locs_from_fits(pd.DataFrame(ids), theta, crlb, ll, iters,
                          7).to_records(index=False)
    assert t.dtype == j.dtype
    for name in t.dtype.names:
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)


def test_chunk_prefetcher_order_errors_and_close():
    from picasso_torch.stream import ChunkPrefetcher

    movie = np.arange(40, dtype=np.uint16).reshape(10, 2, 2)
    p = ChunkPrefetcher(movie, [(0, 4), (4, 8), (8, 10)])
    got = list(p)
    p.close()
    assert [lo for lo, _ in got] == [0, 4, 8]
    np.testing.assert_array_equal(np.concatenate([c for _, c in got]), movie)
    assert all(c.flags.writeable for _, c in got)

    class Broken:
        def __getitem__(self, s):
            raise OSError("unreadable frame")

    p = ChunkPrefetcher(Broken(), [(0, 1)])
    with pytest.raises(OSError, match="unreadable"):
        list(p)
    p.close()

    p = ChunkPrefetcher(movie, [(i, i + 1) for i in range(10)], depth=1)
    next(iter(p))
    p.close()
    assert not p.thread.is_alive()
