"""The plain reference against the port's CPU path on small inputs, and
the reference's independence: it imports nothing of the program, JAX or
the JAX package. (The test imports both; the reference does not.)"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, SMALL_DRIFT, WIDE_PARAMS, wide_config
from core.spec import load_module
from reference import compare, mle as ref_mle, rcc as ref_rcc
from reference import identify as ref_identify, locs as ref_locs

CPU = torch.device("cpu")


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _case(box: int):
    """(configuration, traffic parameters, sites) of a small movie at
    box 7 (the b7 cell's) or 17 (a wide PSF)."""
    cfg = _cfg("dnapaint2d-b7-mle")
    if box == 7:
        params = json.loads((BENCH / "traffic" / "blink-dense.json")
                            .read_text())["params"]
        return cfg, params, 12
    return wide_config(cfg), WIDE_PARAMS, 4


def _movie(box: int, frames=32, size=64):
    gen = load_module(BENCH / "gen" / "blink_movie.py", "ref_test_gen")
    cfg, params, n_sites = _case(box)
    return gen.generate(cfg, params, 99, CPU,
                        {"frames": frames, "height": size, "width": size,
                         "n_sites": n_sites})["movies"][0]


@pytest.mark.parametrize("box", [7, 17])
def test_identify_matches_the_port(box):
    from picasso_torch import localize

    fit = _case(box)[0]["fit"]
    movie = _movie(box)
    f, y, x, ng = (t.numpy() for t in ref_identify.identify(
        movie, fit["box"], fit["min_net_gradient"]))
    ids = localize.identify(movie, fit["min_net_gradient"], fit["box"],
                            device="cpu")
    assert len(ids) == len(f) > 0
    order = np.lexsort((ids["x"], ids["y"], ids["frame"]))
    assert np.array_equal(ids["frame"][order], f)
    assert np.array_equal(ids["y"][order], y)
    assert np.array_equal(ids["x"][order], x)
    np.testing.assert_allclose(ids["net_gradient"][order], ng, rtol=1e-5)


@pytest.mark.parametrize("box", [7, 17])
def test_mle_fit_matches_the_port(box):
    from picasso_torch import gaussmle

    movie = _movie(box)
    fit = _case(box)[0]["fit"]
    ids = ref_locs.ids_of(movie, fit, torch.float64, CPU)
    h = box // 2
    off = np.arange(box) - h
    spots = movie[ids["frame"][:, None, None],
                  ids["y"][:, None, None] + off[None, :, None],
                  ids["x"][:, None, None] + off[None, None, :]]
    theta, crlb, ll, iters = (t.numpy() for t in ref_mle.fit(
        torch.from_numpy(spots.astype(np.float64)), fit["eps"],
        fit["max_it"]))
    p_theta, p_crlb, p_ll, p_iters = gaussmle.gaussmle(
        spots.astype(np.float32), fit["eps"], fit["max_it"], device="cpu")
    conv = (iters < fit["max_it"]) & (p_iters < fit["max_it"])
    assert conv.mean() > 0.9
    np.testing.assert_allclose(p_theta[conv][:, :2], theta[conv][:, :2],
                               atol=5e-3)
    np.testing.assert_allclose(p_theta[conv][:, 2:], theta[conv][:, 2:],
                               rtol=1e-2)
    np.testing.assert_allclose(p_crlb[conv], crlb[conv], rtol=1e-2)
    np.testing.assert_allclose(p_ll[conv], ll[conv], rtol=1e-3)


def test_localize_numbers_within_their_limits_on_the_port():
    from picasso_torch import localize

    cfg = _cfg("dnapaint2d-b7-mle")
    fit, camera = cfg["fit"], dict(cfg["camera"])
    movie = _movie(7)
    locs = localize.localize(
        movie, camera, {"Min. Net Gradient": fit["min_net_gradient"],
                        "Box Size": fit["box"]},
        fitting_method="gaussmle", mle_method="sigmaxy", eps=fit["eps"],
        max_it=fit["max_it"], device="cpu")
    ids = ref_locs.ids_of(movie, fit, torch.float64, CPU)
    fits = ref_locs.fit_ids(movie, ids, fit, camera, torch.float64, CPU)
    numbers = compare.localize(locs, ids, fits, fit, 0.99)
    limits = json.loads((BENCH / "limits" / "2d-b7-mle-dense.json")
                        .read_text())
    assert set(numbers) == set(limits)
    assert all(numbers[k] <= limits[k] for k in limits), numbers


def test_rcc_matches_the_port():
    from picasso_torch import postprocess

    cfg = _cfg("dnapaint2d-b7-mle")
    gen = load_module(BENCH / "gen" / "drift_locs.py", "ref_test_drift")
    params = json.loads((BENCH / "traffic" / "drift-locs.json").read_text())
    out = gen.generate(cfg, params["params"], 7, CPU, SMALL_DRIFT)
    locs, info = out["sets"][0]
    seg = cfg["undrift"]["segmentation"]
    drift, x, y = ref_rcc.undrift(locs, info, seg)
    p_drift, p_locs = postprocess.undrift(locs, info, seg, device="cpu")
    numbers = compare.undrift(locs, p_drift, p_locs, drift, x, y)
    assert numbers["fields_changed"] == 0
    assert numbers["drift_gap_px"] < 1e-5
    # and the reference finds the drift that was put in: at each segment's
    # centre, the segment's mean drift, from the first segment's
    truth = out["truth"][0]
    bounds = ref_rcc.segment_bounds(info[0]["Frames"], seg)
    centres = ((bounds[1:].astype(float) + bounds[:-1]) / 2).astype(int)
    for axis in (0, 1):
        mean = np.array([truth[a:b, axis].mean()
                         for a, b in zip(bounds[:-1], bounds[1:])])
        found = drift[centres, axis]
        np.testing.assert_allclose(found - found[0], mean - mean[0],
                                   atol=0.05)


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1]]\n"
        "import reference.identify, reference.mle, reference.rcc\n"
        "import reference.locs, reference.compare, reference.control\n"
        "import roofline.identify, roofline.fit\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'picasso_tpu',"
        " 'picasso_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
