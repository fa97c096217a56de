"""``correct`` can fail: the control (the reference one precision below
the configuration's) fails the check, and so does a run whose timed path
is broken underneath, driven by the harness without its look for a
card. On the CPU at small sizes; the card-marked test runs a small cell
on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import SMALL, SMALL_DRIFT
from core.harness import run_cell
from core.spec import Cell
from reference import compare, control

CPU = torch.device("cpu")
SEED = 2 ** 32 + 17
CELLS = [("2d-b7-mle-dense", SMALL), ("2d-b7-rcc-undrift", SMALL_DRIFT)]


def _run(cell, sizes, seed=SEED):
    return run_cell(cell, seed, 0.5, False, device="cpu", sizes=sizes,
                    check_device=False)


def _failed_numbers(numbers: dict, limits: dict) -> list[str]:
    return [k for k in limits if not numbers[k] <= limits[k]]


@pytest.mark.parametrize("cell,sizes", CELLS)
def test_the_program_passes_and_the_control_fails(cell, sizes):
    assert _run(cell, sizes)["correct"]
    c = Cell(cell)
    mod = c.driver()
    driver = mod.Driver(c.config, c.traffic, SEED, CPU, sizes)
    driver.setup(c.generator())
    numbers = control.numbers(driver, mod.KIND, c.limits)
    assert set(numbers) == set(c.limits)
    assert _failed_numbers(numbers, c.limits)


def _wrap_locs(monkeypatch, change):
    from picasso_torch import gaussmle

    plain = gaussmle.locs_from_fits

    def broken(*args, **kwargs):
        return change(plain(*args, **kwargs))

    monkeypatch.setattr(gaussmle, "locs_from_fits", broken)


def test_a_fit_that_leaves_its_state_unchanged_fails(monkeypatch):
    from picasso_torch.ops import mle

    monkeypatch.setitem(mle._STEPS, "sigmaxy",
                        lambda theta, spots, max_step: theta)
    assert not _run("2d-b7-mle-dense", SMALL)["correct"]


def test_half_of_the_locs_left_out_fails(monkeypatch):
    _wrap_locs(monkeypatch, lambda locs: locs[::2])
    assert not _run("2d-b7-mle-dense", SMALL)["correct"]


def test_one_altered_answer_fails(monkeypatch):
    def alter(locs):
        locs = locs.copy()
        locs["net_gradient"][len(locs) // 2] *= 1.01
        return locs

    _wrap_locs(monkeypatch, alter)
    result = _run("2d-b7-mle-dense", SMALL)
    assert not result["correct"]
    assert result["checks"]["ng_gap"]["value"] > 1e-3


def test_a_few_converged_fits_moved_fail_where_the_quantiles_pass(
        monkeypatch):
    # one fit in 200 moved by 0.01 px: the 99th percentiles stay within
    # their limits, the share of converged fits far apart does not
    def move(locs):
        locs = locs.copy()
        locs["x"][::200] += 0.01
        return locs

    _wrap_locs(monkeypatch, move)
    result = _run("2d-b7-mle-dense", SMALL)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["xy_gap_px"]["value"] <= checks["xy_gap_px"]["limit"]
    assert checks["xy_far_share"]["value"] > (
        checks["xy_far_share"]["limit"])


def test_a_fit_left_unmatched_counts():
    ref = {"frame": np.array([0, 0, 1]), "net_gradient": np.array(
        [6000.0, 7000.0, 8000.0]), "x": np.array([3.0, 9.0, 5.0]),
        "y": np.array([3.0, 9.0, 5.0]), "iterations": np.array([5, 5, 5])}
    locs = np.zeros(3, compare.LOCS_DTYPE)
    for n in ("frame", "net_gradient", "x", "y"):
        locs[n] = ref[n]
    locs["iterations"] = 5
    fit = {"min_net_gradient": 5000, "max_it": 100}
    assert compare.localize(locs, ref, ref, fit, 0.99)["fits_unmatched"] == 0
    # a loc whose net gradient is off by 2e-5: unmatched at the least
    # tolerance, matched at a wider one
    locs["net_gradient"][1] *= 1 + 2e-5
    assert compare.localize(locs, ref, ref, fit, 0.99)["fits_unmatched"] == 1
    assert compare.localize(locs, ref, ref, fit, 0.99, ng_match=3e-5)[
        "fits_unmatched"] == 0
    # a fit at the threshold is a tie, and not counted
    tie = dict(ref, net_gradient=np.array([5000.1, 7000.0, 8000.0]))
    assert compare.localize(locs[1:], tie, tie, fit, 0.99, ng_match=3e-5)[
        "fits_unmatched"] == 0


def test_undrift_that_returns_no_drift_fails(monkeypatch):
    from picasso_torch import imageprocess

    def no_shift(segments, max_shift=None, mesh=None):
        n = len(segments)
        return np.zeros(n), np.zeros(n)

    monkeypatch.setattr(imageprocess, "rcc", no_shift)
    assert not _run("2d-b7-rcc-undrift", SMALL_DRIFT)["correct"]


def test_undrift_of_half_of_the_locs_fails(monkeypatch):
    from picasso_torch import render

    plain = render.render_t

    def half(cols, *args, **kwargs):
        return plain({k: v[::2] for k, v in cols.items()}, *args, **kwargs)

    monkeypatch.setattr(render, "render_t", half)
    assert not _run("2d-b7-rcc-undrift", SMALL_DRIFT)["correct"]


def test_one_altered_drift_fails(monkeypatch):
    from picasso_torch import postprocess

    plain = postprocess.undrift

    def alter(*args, **kwargs):
        drift, locs = plain(*args, **kwargs)
        drift = drift.copy()
        drift["x"][len(drift) // 2] += 0.01
        return drift, locs

    monkeypatch.setattr(postprocess, "undrift", alter)
    assert not _run("2d-b7-rcc-undrift", SMALL_DRIFT)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,sizes", CELLS)
def test_small_cells_on_the_card(cuda, cell, sizes):
    result = run_cell(cell, SEED, 0.5, True, device=cuda,
                      sizes=dict(sizes, frames=max(sizes["frames"], 512))
                      if cell != "2d-b7-rcc-undrift" else sizes)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
