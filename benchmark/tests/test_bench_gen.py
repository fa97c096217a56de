"""The generators of the benchmark's inputs, at small sizes on the CPU:
they follow their recipe's parameters, and one seed gives the same
inputs twice."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import WIDE_PARAMS, wide_config
from core.spec import BENCH_DIR, load_module

GEN = BENCH_DIR / "gen"
CPU = torch.device("cpu")


def _json(path):
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def movie_gen():
    return load_module(GEN / "blink_movie.py", "test_gen_blink_movie")


@pytest.fixture(scope="module")
def locs_gen():
    return load_module(GEN / "drift_locs.py", "test_gen_drift_locs")


def _b7():
    return _json(BENCH_DIR / "configs" / "dnapaint2d-b7-mle.json")


def _one_site_params(p_on):
    return {"layout_seed": 3, "n_sites": 1, "p_on": p_on, "margin": 20,
            "margin_high": 20, "subpixel": False, "min_distance": 0,
            "movies": 1}


def test_same_seed_same_movie(movie_gen):
    params = _json(BENCH_DIR / "traffic" / "blink-dense.json")["params"]
    sizes = {"frames": 20, "height": 48, "width": 48, "n_sites": 10}
    a = movie_gen.generate(_b7(), params, 2 ** 33 + 5, CPU, sizes)
    b = movie_gen.generate(_b7(), params, 2 ** 33 + 5, CPU, sizes)
    c = movie_gen.generate(_b7(), params, 2 ** 33 + 6, CPU, sizes)
    assert all(np.array_equal(x, y) for x, y in zip(a["movies"], b["movies"]))
    assert not np.array_equal(a["movies"][0], c["movies"][0])
    assert a["movies"][0].dtype == np.uint16
    assert a["movies"][0].shape == (20, 48, 48)
    # the sites come from the traffic's layout, the same for every seed
    assert np.array_equal(a["sites"][0], c["sites"][0])


def test_background_photons_and_blinking_follow_the_recipe(movie_gen):
    cfg = _b7()
    spot = cfg["spot"]
    sizes = {"frames": 3000, "height": 40, "width": 40}
    out = movie_gen.generate(cfg, _one_site_params(0.3), 11, CPU, sizes)
    movie = out["movies"][0].astype(np.float64)
    (sy, sx), = out["sites"][0].astype(int)
    h = spot["footprint"] // 2
    window = movie[:, sy - h:sy + h + 1, sx - h:sx + h + 1]
    # background: the frame outside the spot's footprint
    mask = np.ones(movie.shape[1:], bool)
    mask[sy - h:sy + h + 1, sx - h:sx + h + 1] = False
    bg = movie[:, mask]
    assert abs(bg.mean() - spot["background"]) < 0.05
    excess = window.sum((1, 2)) - window[0].size * spot["background"]
    expected = movie_gen.expected_photons(spot)
    on = excess > expected / 2
    assert abs(on.mean() - 0.3) < 0.03
    assert abs(excess[on].mean() - expected) < 0.01 * expected
    # the peak pixel holds the spot's peak over the background
    peak = window[on][:, h, h].mean() - spot["background"]
    assert abs(peak - spot["peak"]) < 0.02 * spot["peak"]


def test_wide_sites_keep_their_distance(movie_gen):
    cfg = wide_config(_b7())
    params = dict(WIDE_PARAMS, n_sites=100)
    out = movie_gen.generate(cfg, params, 4, CPU,
                             {"frames": 4, "height": 256, "width": 256})
    sites = out["sites"][0]
    assert len(sites) == params["n_sites"]
    d = np.hypot(*(sites[:, None, :] - sites[None, :, :]).transpose(2, 0, 1))
    assert d[np.triu_indices(len(sites), 1)].min() >= params["min_distance"]
    assert sites.min() >= params["margin"]
    assert sites.max() < 256 - params["margin_high"]
    assert not np.array_equal(sites, np.floor(sites))  # sub-pixel


def test_drift_locs_follow_the_recipe(locs_gen):
    cfg = _b7()
    params = _json(BENCH_DIR / "traffic" / "drift-locs.json")["params"]
    sizes = {"frames": 2000, "height": 64, "width": 64, "n_sites": 30}
    a = locs_gen.generate(cfg, params, 2 ** 34, CPU, sizes)
    b = locs_gen.generate(cfg, params, 2 ** 34, CPU, sizes)
    locs, info = a["sets"][0]
    assert np.array_equal(locs, b["sets"][0][0])
    assert locs.dtype == locs_gen.LOCS_DTYPE
    assert info[0]["Frames"] == 2000
    assert abs(len(locs) / (2000 * 30) - params["p_on"]) < 0.01
    assert np.all(np.diff(locs["frame"].astype(np.int64)) >= 0)
    # each loc less its frame's true drift scatters around its site by
    # its precision
    drift = a["truth"][0]
    f = locs["frame"].astype(np.int64)
    x = locs["x"] - drift[f, 0]
    lo, hi = params["precision_px"]
    assert x.min() > params["margin"] - 5 * hi
    assert np.all((locs["lpx"] >= lo) & (locs["lpx"] <= hi))
    assert abs(drift[-1, 0] - drift[0, 0]) > 0.5  # a drift of px
