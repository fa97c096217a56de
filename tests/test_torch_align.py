"""Channel alignment of the port held against picasso_tpu on the CPU:
postprocess.align (one RCC pass over the channels' smooth renders),
align_rcc (passes until converged), align_from_picked (centres of mass
of picks, 2D and with z), lib.minimize_shifts with z, and the ``align``
verb against the JAX CLI.

Tolerances, with what was measured on the CPU (numpy 2, pandas 3, torch
2.13):
- RCC shifts within SHIFT_AGREE = 1e-6 px (measured 5.7e-8: the port
  correlates in f64, numpy 2 transforms JAX's f32 images in complex64;
  the correlation peaks of these site images are sharp, unlike the noise
  images of tests/test_torch_undrift.py);
- the aligned coordinates within COORD_ULPS = 2 f32 ulps of the field's
  largest coordinate, 1.5e-5 px (measured 1.9e-6 px: the shifts above,
  rounded to f32 as pandas rounds a numpy scalar before subtracting it);
- the shifts from picks within 1e-6 px (measured 2.4e-7: the port sorts
  a pick's locs stably, JAX with pandas' quicksort, so the f32 sums of a
  centre of mass run in another order); minimize_shifts equal;
- every other column equal, and the dtypes equal.
"""

from __future__ import annotations

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import io as jio
from picasso_tpu import lib as jlib
from picasso_tpu import postprocess as jpost
from picasso_torch import io as tio
from picasso_torch import lib as tlib
from picasso_torch import postprocess as tpost

SIZE = 64  # px, the field of every channel
SHIFT_AGREE = 1e-6  # px
COORD_ULPS = 2
COORD_AGREE = COORD_ULPS * float(np.spacing(np.float32(SIZE)))
# channel offsets (x, y px, z nm) from the first channel
OFFSETS = [(0.0, 0.0, 0.0), (0.37, -0.21, 12.0), (-0.6, 0.45, -7.0)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_channels(seed: int, n_channels: int, z: bool = False,
                  n_sites: int = 80, per_site: int = 30):
    """``n_channels`` locs tables of the same ``n_sites`` sites in a SIZE
    px field, each moved by its row of OFFSETS, ``per_site`` locs a site
    with 0.05 px scatter (and z scatter of 30 nm). Returns (locs list,
    info list, sites (n_sites, 2) x, y)."""
    rng = np.random.default_rng(seed)
    sites = rng.uniform(4, SIZE - 4, (n_sites, 2))
    names = ["frame", "x", "y"] + (["z"] if z else []) + [
        "photons", "lpx", "lpy"]
    dtype = [(c, np.uint32 if c == "frame" else np.float32) for c in names]
    n = n_sites * per_site
    site = np.repeat(np.arange(n_sites), per_site)
    out = []
    for dx, dy, dz in OFFSETS[:n_channels]:
        locs = np.zeros(n, dtype)
        locs["frame"] = np.sort(rng.integers(0, 500, n))
        locs["x"] = sites[site, 0] + dx + rng.normal(0, 0.05, n)
        locs["y"] = sites[site, 1] + dy + rng.normal(0, 0.05, n)
        if z:
            locs["z"] = rng.normal(dz, 30, n)
        locs["photons"] = rng.uniform(500, 3000, n)
        locs["lpx"] = locs["lpy"] = 0.05
        out.append(locs)
    info = [{"Frames": 500, "Width": SIZE, "Height": SIZE,
             "Pixelsize": 130}]
    return out, [list(info) for _ in out], sites


def _dfs(locs):
    return [pd.DataFrame.from_records(l) for l in locs]


def _assert_locs_close(got: list[np.ndarray], want: list[pd.DataFrame]):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        rec = w.to_records(index=False)
        assert g.dtype == rec.dtype
        for name in g.dtype.names:
            if name in ("x", "y"):
                np.testing.assert_allclose(g[name], rec[name], rtol=0,
                                           atol=COORD_AGREE, err_msg=name)
            else:
                np.testing.assert_array_equal(g[name], rec[name],
                                              err_msg=name)


@pytest.mark.parametrize("n_channels", [2, 3])
def test_align_matches_jax(n_channels):
    """One RCC pass: the shifts within SHIFT_AGREE, the locs moved in
    place (as JAX's DataFrames are) within COORD_AGREE; the recovered
    offsets within 0.1 px of the injected ones."""
    locs, infos, _ = make_channels(n_channels, n_channels)
    mine = [l.copy() for l in locs]
    got, (sx_t, sy_t) = tpost.align(mine, infos, return_shifts=True,
                                    device="cpu")
    want, (sx_j, sy_j) = jpost.align(_dfs(locs), infos, return_shifts=True)
    assert got is mine
    np.testing.assert_allclose(sx_t, sx_j, rtol=0, atol=SHIFT_AGREE)
    np.testing.assert_allclose(sy_t, sy_j, rtol=0, atol=SHIFT_AGREE)
    _assert_locs_close(got, want)
    off = np.array(OFFSETS[:n_channels])
    np.testing.assert_allclose(sx_t, off[:, 0], atol=0.1)
    np.testing.assert_allclose(sy_t, off[:, 1], atol=0.1)
    # apply_shifts=False leaves the locs as they were
    before = [l.copy() for l in locs]
    same, _ = tpost.align(locs, infos, apply_shifts=False,
                          return_shifts=True, device="cpu")
    for a, b in zip(same, before):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_channels", [2, 3])
def test_align_rcc_matches_jax(n_channels):
    """align_rcc: the same passes (the mean shift of each) within
    SHIFT_AGREE, the aligned copies within COORD_AGREE, the inputs left
    as they were; the channels end within 0.02 px of each other."""
    locs, infos, _ = make_channels(10 + n_channels, n_channels)
    before = [l.copy() for l in locs]
    got, (hx_t, hy_t) = tpost.align_rcc(locs, infos, return_shifts=True,
                                        device="cpu")
    want, (hx_j, hy_j) = jpost.align_rcc(_dfs(locs), infos,
                                         return_shifts=True)
    assert len(hx_t) == len(hx_j) and len(hy_t) == len(hy_j)
    np.testing.assert_allclose(hx_t, hx_j, rtol=0, atol=SHIFT_AGREE)
    np.testing.assert_allclose(hy_t, hy_j, rtol=0, atol=SHIFT_AGREE)
    _assert_locs_close(got, want)
    for a, b in zip(locs, before):
        np.testing.assert_array_equal(a, b)
    for c in ("x", "y"):
        resid = [np.median(g[c] - got[0][c]) for g in got]
        assert np.abs(resid).max() < 0.02, resid


@pytest.mark.parametrize("z", [False, True])
@pytest.mark.parametrize("pick_shape,pick_size", [("Circle", 3.0),
                                                  ("Square", 3.0)])
def test_align_from_picked_matches_jax(z, pick_shape, pick_size):
    """Picks on the sites with no other site within 4 px (so each pick
    holds one site of every channel, whole): the shifts (y, x and, with
    z in every channel, z) within SHIFT_AGREE of JAX's, the aligned
    copies within COORD_AGREE (z within an f32 ulp at 200 nm), the
    offsets recovered within 0.01 px (8 nm in z, whose scatter is 30
    nm)."""
    locs, infos, sites = make_channels(20, 3, z=z)
    d = np.hypot(*(sites[:, None] - sites[None]).transpose(2, 0, 1))
    alone = (d < 4).sum(1) == 1
    assert alone.sum() >= 20
    picks = [tuple(p) for p in sites[alone]]
    got, shift_t = tpost.align_from_picked(
        locs, infos, picks=picks, pick_shape=pick_shape,
        pick_size=pick_size, return_shifts=True)
    want, shift_j = jpost.align_from_picked(
        _dfs(locs), infos, picks=picks, pick_shape=pick_shape,
        pick_size=pick_size, return_shifts=True)
    assert len(shift_t) == len(shift_j) == (3 if z else 2)
    np.testing.assert_allclose(np.array(shift_t), np.array(shift_j), rtol=0,
                               atol=SHIFT_AGREE)
    off = np.array(OFFSETS)
    np.testing.assert_allclose(shift_t[0], off[:, 1], atol=0.01)
    np.testing.assert_allclose(shift_t[1], off[:, 0], atol=0.01)
    if z:
        np.testing.assert_allclose(shift_t[2], off[:, 2], atol=8.0)
    for g, w in zip(got, want):
        rec = w.to_records(index=False)
        assert g.dtype == rec.dtype
        for name in g.dtype.names:
            atol = (COORD_AGREE if name in ("x", "y") else
                    float(np.spacing(np.float32(200))) if name == "z" else 0)
            np.testing.assert_allclose(g[name], rec[name], rtol=0, atol=atol,
                                       err_msg=name)


def test_minimize_shifts_with_z_matches_jax():
    rng = np.random.default_rng(5)
    sx, sy, sz = (np.triu(rng.normal(size=(5, 5)), 1) for _ in range(3))
    for args in ((sx, sy), (sx, sy, sz)):
        got = tlib.minimize_shifts(*args)
        want = jlib.minimize_shifts(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_series_mean_std_equals_pandas():
    """lib.series_mean_std gives a column pandas' mean and std bit for
    bit: f32 with a NaN, f64, u32 and i32, of 0, 1, 2 and 100,003 rows."""
    rng = np.random.default_rng(6)
    for dt in (np.float32, np.float64, np.uint32, np.int32):
        for n in (0, 1, 2, 100003):
            v = (rng.normal(50, 30, n) * 100).astype(dt)
            if dt == np.float32 and n > 2:
                v[1] = np.nan
            got = tlib.series_mean_std(v)
            s = pd.Series(v)
            for g, w in zip(got, (s.mean(), s.std())):
                assert type(g) is type(w) or n < 2, (dt, n)
                np.testing.assert_array_equal(g, w, err_msg=f"{dt} {n}")


def test_align_verb_matches_the_jax_cli(tmp_path, capsys):
    """``align a b c --device cpu`` against the JAX CLI on the same
    files: the same messages and _align.hdf5 files, their fields within
    the tolerances above, their info chains equal (the "Picasso Align"
    block appended); fewer than two files print a message."""
    from picasso_torch import __main__ as tmain
    from picasso_tpu import __main__ as jmain

    locs, infos, _ = make_channels(30, 3)
    out = {}
    for d, main, extra in (("t", tmain.main, ["--device", "cpu"]),
                           ("j", jmain.main, [])):
        folder = tmp_path / d
        folder.mkdir()
        for k, (l, info) in enumerate(zip(locs, infos)):
            jio.save_locs(str(folder / f"ch{k}_locs.hdf5"),
                          pd.DataFrame.from_records(l), info)
        main(["align", str(folder / "ch*_locs.hdf5")] + extra)
        main(["align", str(folder / "ch0_locs.hdf5")] + extra)
        out[d] = capsys.readouterr().out.replace(str(folder), "")
    assert out["t"] == out["j"]
    assert "align requires at least two files" in out["t"]
    t, j = tmp_path / "t", tmp_path / "j"
    names = sorted(p.name for p in t.iterdir())
    assert names == sorted(p.name for p in j.iterdir())
    produced = [n for n in names if n.endswith("_align.hdf5")]
    assert len(produced) == 3
    for name in produced:
        with h5py.File(t / name, "r") as f:
            got = f["locs"][()]
        want = jio.load_locs(str(j / name))[0]
        _assert_locs_close([got], [want])
        info = tio.load_info(str(t / name))
        assert info == tio.load_info(str(j / name))
        assert info[-1] == {"Generated by": "Picasso Align"}
