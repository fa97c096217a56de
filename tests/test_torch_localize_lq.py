"""The port's LQ localize slice (identify -> cut -> LM fit -> locs ->
HDF5) and the ``sigma`` MLE method of the MLE slice, held against
picasso_tpu.localize on the same movie (CPU), plus ``python -m
picasso_torch localize -a lq``.

The JAX package sorts its locs with pandas' unstable quicksort, which
reorders the rows of one frame; the port keeps hit order (a stable
sort). Rows are compared by position: the JAX table's index still holds
the hit order.

Tolerances: tests/torch_parity.py.
"""

from __future__ import annotations

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from picasso_tpu import io as jio
from picasso_tpu import lib as jlib
from picasso_tpu import localize as jloc
from picasso_tpu.ops import fused as jfused
from picasso_torch import io as tio
from picasso_torch import localize as tloc
from picasso_torch.ops import fused as tfused
from picasso_torch.ops import winfit_cuda
from torch_data import make_bench_movie
from torch_native import loaded_native
from torch_parity import compare_hits, compare_lq_fits

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


@pytest.fixture(scope="module", autouse=True)
def _native_loaded():
    """picasso_tpu.localize.get_spots (and fit2D, fit and localize through
    it) converts a C-contiguous u16 movie with one factor only while
    picasso_tpu.native is loaded, and in three roundings otherwise; the
    port mirrors the one-factor route. A test process that lost the
    native library's build race would hold the port to the other route:
    load the library first (torch_native.loaded_native)."""
    loaded_native()


@pytest.fixture(scope="module")
def movie():
    return make_bench_movie(32, 64, 40, 0.5, np.random.default_rng(7))


def _movie_info(movie):
    return [{"Byte Order": "<", "Data Type": "uint16",
             "Frames": movie.shape[0], "Height": movie.shape[1],
             "Width": movie.shape[2]}]


@pytest.fixture(scope="module")
def port_fused(movie):
    return tfused.localize_fused(movie, MIN_NG, 7, dict(CAMERA),
                                 fitting_method="gausslq", device="cpu")


def _rois(movie, ids):
    """The fits' (7, 7, n) photon ROIs, cut around the hits."""
    t = torch.from_numpy(movie)
    return winfit_cuda.cut_rois_t(
        t, *(torch.from_numpy(np.ascontiguousarray(ids[c], np.int64))
             for c in ("frame", "y", "x")), 7,
    ).to(torch.float32).numpy()


def test_localize_fused_lq_matches_jax(movie, port_fused):
    j_ids, j_fits = jfused.localize_fused(movie, MIN_NG, 7, dict(CAMERA),
                                          fitting_method="gausslq")
    t_ids, t_fits = port_fused
    ref = [j_ids[c].to_numpy() for c in ("frame", "y", "x", "net_gradient")]
    got = [t_ids[c] for c in ("frame", "y", "x", "net_gradient")]
    assert len(ref[0]) > 300
    compare_hits(ref, got, MIN_NG)
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(a, b)
    compare_lq_fits(j_fits[0].T, t_fits[0].T, _rois(movie, t_ids))
    # the LQ payload carries no crlb/ll/iters: zeros, as in JAX
    for a, b in zip(j_fits[1:], t_fits[1:]):
        assert a.shape == b.shape and a.dtype == b.dtype and not b.any()


@pytest.mark.parametrize("method", ["gausslq", "gausslq-gpu"])
def test_localize_lq_matches_jax(movie, port_fused, method):
    j_locs, j_info = jloc.localize(movie, dict(CAMERA), PARAMS,
                                   movie_info=_movie_info(movie),
                                   fitting_method=method, return_info=True)
    t_locs, t_info = tloc.localize(movie, dict(CAMERA), PARAMS,
                                   movie_info=_movie_info(movie),
                                   fitting_method=method,
                                   return_info=True, device="cpu")
    assert t_info == j_info
    assert "Max iterations" not in t_info[-1]
    j_rec = j_locs.sort_index().to_records(index=False)  # hit order
    assert t_locs.dtype == j_rec.dtype
    np.testing.assert_array_equal(t_locs["frame"], j_rec["frame"])
    np.testing.assert_allclose(t_locs["net_gradient"], j_rec["net_gradient"],
                               rtol=1e-5)
    ids = port_fused[0]
    theta = [np.stack([r["x"] - ids["x"], r["y"] - ids["y"], r["photons"],
                       r["bg"], r["sx"], r["sy"]]) for r in (j_rec, t_locs)]
    # x/y pass through absolute f32 coordinates here (ulp ~4e-6 px at 64
    # px), so the tight p50 of compare_lq_fits is checked in the test
    # above; here the locs of >= 99% of spots agree to 1e-3 px
    d = np.abs(theta[0][:2] - theta[1][:2]).max(axis=0)
    assert np.mean(d <= 1e-3) >= 0.99
    for c in ("lpx", "lpy", "ellipticity"):
        rel = np.abs(t_locs[c] - j_rec[c]) / np.abs(j_rec[c])
        assert np.mean(rel <= 1e-2) >= 0.99, c


def test_localize_sigma_matches_jax(movie):
    j_locs, j_info = jloc.localize(movie, dict(CAMERA), PARAMS,
                                   movie_info=_movie_info(movie),
                                   fitting_method="gaussmle",
                                   mle_method="sigma", return_info=True)
    t_locs, t_info = tloc.localize(movie, dict(CAMERA), PARAMS,
                                   movie_info=_movie_info(movie),
                                   fitting_method="gaussmle",
                                   mle_method="sigma", return_info=True,
                                   device="cpu")
    assert t_info == j_info
    j_rec = j_locs.sort_index().to_records(index=False)
    assert t_locs.dtype == j_rec.dtype
    np.testing.assert_array_equal(t_locs["frame"], j_rec["frame"])
    np.testing.assert_array_equal(t_locs["sx"], t_locs["sy"])
    same = (j_rec["iterations"] == t_locs["iterations"]) & (
        j_rec["iterations"] < 100)
    assert same.mean() >= 0.95
    for c in ("x", "y", "sx"):
        np.testing.assert_allclose(t_locs[c][same], j_rec[c][same],
                                   rtol=0, atol=1e-3)


def test_cli_localize_lq_writes_the_jax_locs_layout(tmp_path, movie):
    jio.save_raw(str(tmp_path / "x.raw"), movie, _movie_info(movie))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "picasso_torch", "localize", "x.raw",
         "-a", "lq", "-d", "0", "-g", str(MIN_NG), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    with h5py.File(tmp_path / "x_locs.hdf5", "r") as f:
        t_rec = f["locs"][()]
    j_locs, j_info = jloc.localize(movie, dict(CAMERA, Qe=1), PARAMS,
                                   movie_info=_movie_info(movie),
                                   fitting_method="gausslq", return_info=True)
    assert t_rec.dtype == j_locs.to_records(index=False).dtype
    assert t_rec.dtype.names == tuple(j_locs.columns)
    assert len(t_rec) == len(jlib.ensure_sanity(j_locs, j_info))
    t_info = tio.load_info(str(tmp_path / "x_locs.hdf5"))
    assert t_info[2]["Fit method"] == "gausslq"
    assert "Convergence criterion" not in t_info[2]
