"""The ``avg`` fit method (picasso_torch.avgroi) held against
picasso_tpu.avgroi on the CPU: the ROI sums within
torch_parity.compare_avg_photons, every other column of theta and the
locs table equal."""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

from picasso_tpu import avgroi as javg
from picasso_torch import avgroi as tavg
from torch_data import make_spots
from torch_parity import compare_avg_photons


@pytest.mark.parametrize("box", [5, 7, 9])
def test_fit_spots_matches_jax(box):
    spots = make_spots(3000, box, seed=box) * np.float32(0.37) - 11
    ref = javg.fit_spots(spots)
    got = tavg.fit_spots(spots, device="cpu")
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    compare_avg_photons(ref[:, 2], got[:, 2], spots)
    np.testing.assert_array_equal(got[:, 3], got[:, 2])
    np.testing.assert_array_equal(np.delete(got, [2, 3], 1),
                                  np.delete(ref, [2, 3], 1))


def test_fit_spot_parallel_and_futures():
    spots = make_spots(10, 7, seed=1)
    theta = tavg.fit_spots(spots, device="cpu")
    one = tavg.fit_spot(spots[3], device="cpu")
    assert one[:2] == [0, 0] and one[4:] == [1, 1]
    assert one[2] == one[3] == pytest.approx(float(theta[3, 2]), rel=0)
    ref = javg.fit_spot(spots[3])
    assert one[2] == pytest.approx(ref[2], rel=1e-6)
    np.testing.assert_array_equal(
        tavg.fit_spots_parallel(spots, device="cpu"), theta)
    futures = tavg.fit_spots_parallel(spots, asynch=True, device="cpu")
    np.testing.assert_array_equal(tavg.fits_from_futures(futures), theta)
    calls = []
    tavg.fit_spots(spots, calls.append, device="cpu")
    assert calls == [10]
    assert tavg.fit_spots(spots[:0], device="cpu").shape == (0, 6)


@pytest.mark.parametrize("key", ["frame", "n_id"])
@pytest.mark.parametrize("em", [False, True])
def test_locs_from_fits_matches_jax(key, em):
    """Columns, dtypes and values; unique keys, so picasso_tpu's unstable
    quicksort and the port's stable sort give one order."""
    n = 2000
    rng = np.random.default_rng(3)
    fields = [("frame", np.int64), ("x", np.int64), ("y", np.int64),
              ("net_gradient", np.float32)]
    if key == "n_id":
        fields.append(("n_id", np.int64))
    ids = np.zeros(n, dtype=fields)
    ids["frame"] = rng.integers(0, 40, n)
    ids[key] = rng.permutation(n)
    ids["x"] = rng.integers(3, 60, n)
    ids["y"] = rng.integers(3, 60, n)
    ids["net_gradient"] = rng.random(n) * 1e4
    theta = tavg.fit_spots(make_spots(n, 7, seed=4) - 40, device="cpu")
    got = tavg.locs_from_fits(ids, theta, 7, em)
    ref = javg.locs_from_fits(pd.DataFrame(ids), theta, 7,
                              em).to_records(index=False)
    assert got.dtype == ref.dtype
    for name in got.dtype.names:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def test_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tavg.fit_spots(make_spots(4, 7))
