"""The port's LQ fitting API (picasso_torch.gausslq) held against
picasso_tpu.gausslq on the same numpy inputs (CPU): the locs tables, the
Mortensen precision, the Gpufit column layout and the public fit calls.

Tolerances: tests/torch_parity.compare_lq_fits for fits; the tables are
built from the same fits and must agree exactly.
"""

from __future__ import annotations

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_torch import gausslq as tg
from picasso_tpu import gausslq as jg
from torch_data import make_spots
from torch_parity import compare_lq_fits


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids_theta(key, n=3000, seed=11):
    rng = np.random.default_rng(seed)
    fields = [("frame", np.int64), ("x", np.int64), ("y", np.int64),
              ("net_gradient", np.float32)]
    if key == "n_id":
        fields.append(("n_id", np.int64))
    ids = np.zeros(n, dtype=fields)
    ids["frame"] = rng.integers(0, 50, n)
    ids[key] = rng.permutation(n)  # unique keys: any sort gives one order
    ids["x"] = rng.integers(3, 60, n)
    ids["y"] = rng.integers(3, 60, n)
    ids["net_gradient"] = rng.random(n) * 1e4
    theta = np.stack([
        rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
        rng.uniform(100, 1e4, n), rng.uniform(-5, 50, n),  # some bg < 0
        rng.uniform(0.5, 2, n), rng.uniform(0.5, 2, n),
    ], axis=1).astype(np.float32)
    return ids, theta


@pytest.mark.parametrize("em", [False, True])
@pytest.mark.parametrize("key", ["frame", "n_id"])
def test_locs_from_fits_matches_jax(key, em):
    """Columns, dtypes, values and order (NaN precision where bg < 0
    makes the variance negative)."""
    ids, theta = _ids_theta(key)
    t = tg.locs_from_fits(ids, theta, 7, em)
    j = jg.locs_from_fits(pd.DataFrame(ids), theta, 7, em).to_records(
        index=False)
    assert t.dtype == j.dtype
    for name in t.dtype.names:
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)


def test_locs_from_fits_gpufit_matches_jax():
    ids, theta = _ids_theta("frame", seed=12)
    gpufit = theta[:, [2, 0, 1, 4, 5, 3]].copy()
    gpufit[:, 1:3] += 3
    t = tg.locs_from_fits_gpufit(ids, gpufit, 7, True)
    j = jg.locs_from_fits_gpufit(pd.DataFrame(ids), gpufit, 7,
                                 True).to_records(index=False)
    assert t.dtype == j.dtype
    for name in t.dtype.names:
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)


def test_localization_precision_of_diverged_fits():
    """Diverged fits (huge widths and background) give a finite f64
    precision where JAX's is finite, and no overflow warning."""
    rng = np.random.default_rng(3)
    n = 1000
    photons = rng.uniform(1, 1e5, n).astype(np.float32)
    s = (10.0 ** rng.uniform(-1, 38, n)).astype(np.float32)
    s_orth = (10.0 ** rng.uniform(-1, 38, n)).astype(np.float32)
    bg = (10.0 ** rng.uniform(-1, 38, n)).astype(np.float32)
    for em in (False, True):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            t = tg.localization_precision(photons, s, s_orth, bg, em=em)
        j = jg.localization_precision(photons, s, s_orth, bg, em=em)
        assert t.dtype == np.float64
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
        assert np.isfinite(t).all()
        np.testing.assert_array_equal(t, j)


def test_sigma_uncertainty_matches_jax():
    rng = np.random.default_rng(4)
    args = [rng.uniform(0.8, 2, 500), rng.uniform(0.8, 2, 500),
            rng.uniform(500, 1e4, 500), rng.uniform(1, 50, 500)]
    np.testing.assert_array_equal(tg.sigma_uncertainty(*args),
                                  jg.sigma_uncertainty(*args))


@pytest.fixture(scope="module")
def spots():
    return make_spots(600, seed=21)


def test_fit_spots_gpufit_layout(spots):
    """[photons, x, y, sx, sy, bg] with x/y in box coordinates, from the
    same fit as fit_spots; and JAX's Gpufit layout holds to it."""
    theta = tg.fit_spots(spots, device="cpu")
    g = tg.fit_spots_gpufit(spots, device="cpu")
    assert g.shape == (600, 6) and g.dtype == np.float32
    np.testing.assert_array_equal(g[:, 0], theta[:, 2])
    np.testing.assert_array_equal(g[:, 1], theta[:, 0] + 3)
    np.testing.assert_array_equal(g[:, 2], theta[:, 1] + 3)
    np.testing.assert_array_equal(g[:, 3:], theta[:, [4, 5, 3]])
    j = jg.fit_spots_gpufit(spots)
    back = lambda a: np.stack([a[:, 1] - 3, a[:, 2] - 3, a[:, 0], a[:, 5],  # noqa: E731
                               a[:, 3], a[:, 4]])
    compare_lq_fits(back(j), back(g),
                    np.ascontiguousarray(spots.transpose(1, 2, 0)))


@pytest.mark.parametrize("raw", [False, True])
def test_fit_spots_matches_jax(spots, raw):
    """The public fit call (the JAX package's default max_it 30), with
    and without the photon conversion (raw - baseline) * factor of u16
    counts on the device."""
    conv = None
    data = spots
    if raw:
        data = (spots * 2 + 100).astype(np.uint16)
        conv = (100.0, 0.5)
    j = jg.fit_spots(data, photon_conversion=conv)
    t = tg.fit_spots(data, photon_conversion=conv, device="cpu")
    assert t.shape == (600, 6) and t.dtype == np.float32
    compare_lq_fits(j.T, t.T, np.ascontiguousarray(spots.transpose(1, 2, 0)))
    np.testing.assert_array_equal(tg.fit_spot(spots[0], device="cpu"),
                                  tg.fit_spots(spots[:1], device="cpu")[0])
    fut = tg.fit_spots_parallel(spots[:5], asynch=True, device="cpu")
    np.testing.assert_array_equal(tg.fits_from_futures(fut),
                                  tg.fit_spots(spots[:5], device="cpu"))


def test_port_keeps_hit_order_where_pandas_reorders():
    """The JAX package sorts locs with pandas' unstable quicksort, which
    reorders rows of one frame even when the frames are already in
    order; the port keeps the hit order (a stable sort). 100,000 rows,
    500 per frame."""
    n = 100_000
    ids = np.zeros(n, dtype=[("frame", np.int64), ("x", np.int64),
                             ("y", np.int64), ("net_gradient", np.float32)])
    ids["frame"] = np.arange(n) // 500
    ids["net_gradient"] = np.arange(n)  # marks the hit order
    theta = np.ones((n, 6), np.float32)
    t = tg.locs_from_fits(ids, theta, 7, False)
    j = jg.locs_from_fits(pd.DataFrame(ids), theta, 7, False)
    np.testing.assert_array_equal(t["net_gradient"], ids["net_gradient"])
    moved = int((j["net_gradient"].to_numpy() != ids["net_gradient"]).sum())
    assert moved > 0
