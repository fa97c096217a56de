"""2D particle averaging of the port held against picasso_tpu on the CPU:
com_align, build_group_index, prepare_locs_for_save, the host route
(below 64 groups) and the device route (from 64 groups, run here on the
CPU), JAX's sharpness gate, and the rotations recovered against the
truth.

Inputs: tests/torch_data.make_origami_locs (3 x 4 grids at 20 nm without
a corner, precisions 0.02-0.04 px), each loc grouped to its origami.

Tolerances, with what was measured on the CPU (numpy 2, torch 2.13, jax
0.9):
- com_align, build_group_index and prepare_locs_for_save equal (the
  group means are pandas' f32 Kahan sums);
- the host route equal to JAX's, x and y bit for bit (the same numpy
  code);
- the device route against JAX's device route: the first iteration's
  picks equal but for near ties (a group whose best and second-best
  correlation lie within TIE_REL of each other; 0 here), and x/y after
  three iterations within XY_ABS px, the bound of JAX's own
  device-against-host test (measured 1.2e-7: f32 rotations and FFTs on
  both sides);
- the averaged origami (256, 3 iterations): their rotations relative to
  the consensus within 2 angle steps of the truth, or of the truth turned
  by pi, for ROTATION_SHARE_PI of them (measured 1.0), and without the
  turn for ROTATION_SHARE (measured 0.770; 0.969-0.977 on 1000 origami
  of seeds 0-2, where the average image forms sooner).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import average as ja
from picasso_torch import average as ta
from picasso_torch import lib
from torch_data import (
    make_origami_locs, origami_groups, rigid_rotations, rotation_share,
)

TIE_REL = 1e-5
XY_ABS = 1e-3
ROTATION_SHARE = 0.6
ROTATION_SHARE_PI = 0.95


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """JAX's default routes (no override), torch on few threads."""
    monkeypatch.delenv("PICASSO_TPU_AVERAGE", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _grouped(n: int, seed: int = 0):
    locs, info, truth = make_origami_locs(n, seed)
    return origami_groups(locs, truth), info, truth


def _df(locs):
    return pd.DataFrame.from_records(locs)


def _assert_equal(got: np.ndarray, want: pd.DataFrame):
    want = want.to_records(index=False)
    assert got.dtype.names == want.dtype.names
    for n in got.dtype.names:
        assert got.dtype[n] == want.dtype[n], n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_com_align_group_index_and_save_match_jax():
    locs, info, _ = _grouped(12, 1)
    locs = locs[np.random.default_rng(0).permutation(len(locs))]
    gi_t, gi_j = ta.build_group_index(locs), ja.build_group_index(_df(locs))
    assert gi_t.shape == gi_j.shape
    assert (gi_t.toarray() == gi_j.toarray()).all()
    got = ta.com_align(locs, gi_t)
    want = ja.com_align(_df(locs), gi_j)
    _assert_equal(got, want)
    assert not np.shares_memory(got, locs)
    for params in ({}, {"disp_px_size": 5.0, "it": 3}):
        a = ta.prepare_locs_for_save(got, info, params)
        b = ja.prepare_locs_for_save(want, info, params)
        _assert_equal(a[0], b[0])
        assert a[1] == b[1]


def test_host_route_matches_jax():
    """12 origami (the host route on both sides), shifted back for
    saving: the same table and info."""
    locs, info, _ = _grouped(12, 2)
    got = ta.average(locs, info, iterations=2, return_shifted_locs=True,
                     device="cpu")
    want = ja.average(_df(locs), info, iterations=2,
                      return_shifted_locs=True)
    _assert_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.fixture(scope="module")
def origami64():
    locs, info, truth = _grouped(64, 3)
    out = ta.average(locs, info, iterations=3, device="cpu")
    return locs, info, truth, out


def test_device_route_matches_jax(origami64):
    """64 origami (the device route on both sides): the first iteration's
    picks from the same inputs equal but for near ties, and x, y after
    three iterations within XY_ABS px of JAX's."""
    locs, info, _, out = origami64
    x, y, rows, angles, ov, t_min, t_max = ta._workspace(
        ta.com_align(locs), info, 5.0)
    _, image = ta._render_hist_square(x, y, ov, t_min, t_max)
    half = image.shape[0] / 2
    picks = []
    xt, yt = ta._align_groups_device(x.copy(), y.copy(), rows, angles, ov,
                                     t_min, t_max, image, half, "cpu",
                                     picks=picks)
    xj, yj = ja._align_groups_device(x.copy(), y.copy(), rows, angles, ov,
                                     t_min, t_max, image, half)
    best, val, second = (np.concatenate(p) for p in zip(*picks))
    moved = [g for g, r in enumerate(rows) if max(
        np.abs(xt[r] - xj[r]).max(), np.abs(yt[r] - yj[r]).max()) > XY_ABS]
    for g in moved:
        assert val[g] - second[g] <= TIE_REL * abs(val[g]), g
    print(f"first iteration: {len(moved)} of {len(rows)} picks differ "
          "(near ties)")
    assert (val > 0).all()
    want = ja.average(_df(locs), info, iterations=3)
    np.testing.assert_allclose(out["x"], want["x"].to_numpy(), rtol=0,
                               atol=XY_ABS)
    np.testing.assert_allclose(out["y"], want["y"].to_numpy(), rtol=0,
                               atol=XY_ABS)


def test_device_route_sharpens_the_ensemble(origami64):
    """JAX's gate (tests/test_average.py): the ensemble image after
    averaging is over 1.5x as sharp as before."""
    locs, _, _, out = origami64
    r = np.hypot(locs["x"] - locs["x"].mean(), locs["y"] - locs["y"].mean())

    def sharpness(t):
        _, img = ta._render_hist_square(
            t["x"] - t["x"].mean(), t["y"] - t["y"].mean(), 13.0,
            -2 * r.mean(), 2 * r.mean())
        return (img**2).sum() / max(img.sum(), 1) ** 2

    assert sharpness(out) > 1.5 * sharpness(locs)


def test_device_route_recovers_the_rotations():
    """256 origami, the smoke's settings (3 iterations, 5 nm): each
    origami's rotation (a rigid fit of its locs before and after),
    relative to the consensus, within 2 angle steps of its true relative
    rotation, or of it turned by pi (10 of the 11 sites match there), for
    ROTATION_SHARE_PI of them, and without the turn for a majority
    (ROTATION_SHARE)."""
    locs, info, truth = _grouped(256, 3)
    out = ta.average(locs, info, iterations=3, device="cpu")
    _, rows = lib.group_rows(locs["group"])
    angles = ta._workspace(ta.com_align(locs), info, 5.0)[3]
    rec = rigid_rotations(locs, out, rows)
    share, share_pi, _ = rotation_share(rec, truth["angles"], 2 * angles[1])
    print(f"rotation share {share:.3f}, with the turn by pi {share_pi:.3f} "
          f"({len(angles)} angles)")
    assert share >= ROTATION_SHARE and share_pi >= ROTATION_SHARE_PI


def test_average_reports_progress_and_walls():
    locs, info, _ = _grouped(6, 4)
    calls, walls = [], []
    ta.average(locs, info, iterations=2, device="cpu", walls=walls,
               progress_callback=lambda *a: calls.append(a))
    assert [c[:2] for c in calls] == [(1, 2), (2, 2)]
    assert len(walls) == 2 and all(w["total"] > 0 for w in walls)


def test_average_needs_a_card_by_default():
    """device defaults to cuda: without a card average raises on both
    routes (6 and 64 groups)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for n in (6, 64):
        locs, info, _ = _grouped(n, 5)
        with pytest.raises(RuntimeError, match="cuda"):
            ta.average(locs, info)
    with pytest.raises(AssertionError):
        ta.average(make_origami_locs(4, 6)[0], info, device="cpu")
