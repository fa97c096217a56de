"""The port's simulator held against picasso_tpu.simulate on the CPU:
under one np.random.seed every function gives JAX's arrays bit for bit
(the same draws of the global stream in the same order), the movie and
info files are written alike, and the closed loop (simulate, then the
port's localize) recovers the sites as JAX's own test requires
(tests/test_simulate.py): more than 50 locs, median distance to the
nearest site below 1 px.
"""

from __future__ import annotations

import numpy as np
import pytest

from picasso_tpu import simulate as js
from picasso_torch import simulate as ts

CX = [1.5e-7, -2.0e-5, 1.0e-3, 0.05, 1.2]


def _both(fn_name, *args, seed=0, **kw):
    """The port's and JAX's ``fn_name(*args, **kw)``, each after
    np.random.seed(seed), with the stream's state after each call."""
    out = []
    for mod in (ts, js):
        np.random.seed(seed)
        res = getattr(mod, fn_name)(*args, **kw)
        out.append((res, np.random.get_state()[1].copy()))
    return out


def _assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


@pytest.mark.parametrize("fn, args, kw", [
    ("paintgen", (5000, 1000, 2000, 100, 50, 0, 1e9), {}),
    ("paintgen", (3000, 500, 400, 300, 60, 10, 1.5e6), {}),
    ("paintgen", (100, 50000, 500, 100, 100, 0, 5000), {}),
    ("noisy", (np.zeros((16, 16)), 3.0, 1.0), {}),
    ("noisy_p", (np.zeros((16, 16)), 20.0), {}),
    ("generatePositions", (9, 64, 5, 0), {}),
    ("generatePositions", (7, 64, 5, 1), {}),
    ("incorporateStructure", (np.ones((4, 200)), 0.5), {}),
    ("randomExchange", (np.arange(20.0).reshape(4, 5),), {}),
    ("rotateStructure", (np.arange(12.0).reshape(4, 3),), {}),
])
def test_functions_match_jax_bit_for_bit(fn, args, kw):
    (got, state_t), (want, state_j) = _both(fn, *args, **kw)
    _assert_same(got, want)
    np.testing.assert_array_equal(state_t, state_j)


def test_structures_and_photons_match_jax():
    struct = ts.defineStructure([0.0, 20, 40, 20], [0.0, 0, 0, 30],
                                [1, 1, 2, 1], [0, 0, 0, 10], 130)
    _assert_same(struct, js.defineStructure([0.0, 20, 40, 20],
                                            [0.0, 0, 0, 30], [1, 1, 2, 1],
                                            [0, 0, 0, 10], 130))
    _assert_same(ts.defineStructure([1.0, 3], [2.0, 5], [1, 1], [0, 0], 130,
                                    mean=False),
                 js.defineStructure([1.0, 3], [2.0, 5], [1, 1], [0, 0], 130,
                                    mean=False))
    pos = ts.generatePositions(6, 48, 5, 0)
    for orient, inc, exch in ((0, 1.0, 0), (1, 0.7, 1)):
        (got, st), (want, sj) = _both("prepareStructures", struct, pos,
                                      orient, 6, inc, exch, seed=3)
        _assert_same(got, want)
        np.testing.assert_array_equal(st, sj)
    structures = np.array([pos[:, 0], pos[:, 1], np.ones(6), np.arange(6),
                           np.linspace(-200, 200, 6)])
    (got, _), (want, _) = _both("distphotons", structures, 300, 200, 3000,
                                500, 60, 10, 1.5e6, seed=4)
    _assert_same(got, want)
    photondist = got[0]
    frame = int(np.argmax(photondist.sum(0)))
    for mode3d in (False, True):
        for fn in ("distphotonsxy", "convertMovie"):
            args = ((frame, photondist, structures, 0.82, mode3d, CX, CX)
                    if fn == "distphotonsxy" else
                    (frame, photondist, structures, 48, 200, 0.82, 60, 1, 0,
                     mode3d, CX, CX))
            (g, st), (w, sj) = _both(fn, *args, seed=5)
            _assert_same(g, w)
            np.testing.assert_array_equal(st, sj)
    _assert_same(ts.calculate_zpsf(np.linspace(-300, 300, 7), CX, CX),
                 js.calculate_zpsf(np.linspace(-300, 300, 7), CX, CX))
    _assert_same(ts.test_calculate_zpsf(), js.test_calculate_zpsf())
    assert ts.MAGFAC == ts.magfac == js.MAGFAC


def test_simulate_movie_and_files_match_jax(tmp_path):
    movie, sites, info = ts.simulate_movie(n_sites=6, imagesize=24,
                                           frames=60, taud=800, seed=11)
    j_movie, j_sites, j_info = js.simulate_movie(n_sites=6, imagesize=24,
                                                 frames=60, taud=800,
                                                 seed=11)
    _assert_same(movie, j_movie)
    _assert_same(sites, j_sites)
    assert info == j_info and movie.dtype == np.dtype("<u2") and movie.any()
    (got, _), (want, _) = _both("check_type", np.array([[7e4, 10.0, 3e5]]))
    _assert_same(got, want)
    for mod, tag in ((ts, "t"), (js, "j")):
        mod.saveMovie(str(tmp_path / f"{tag}.raw"), movie, info)
        mod.saveInfo(str(tmp_path / f"{tag}_flow.yaml"), info)
    for a, b in (("t.raw", "j.raw"), ("t.yaml", "j.yaml"),
                 ("t_flow.yaml", "j_flow.yaml")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def test_noise_calibration_matches_jax():
    rng = np.random.default_rng(2)
    conc = rng.uniform(1, 10, 8)
    laser = rng.uniform(50, 200, 8)
    itime = rng.uniform(100, 300, 8)
    bg = (0.3 + 0.05 * conc) * laser * itime * rng.uniform(0.95, 1.05, 8)
    bgstd = 1e-3 * laser * itime + 0.02 * bg + 3 + rng.normal(0, 0.1, 8)
    got = ts.calibrate_noise_model(bg, bgstd, laser, itime, conc)
    want = js.calibrate_noise_model(bg, bgstd, laser, itime, conc)
    assert got.keys() == want.keys()
    for k in got:
        _assert_same(got[k], want[k])
    data = rng.normal(0, 1, 500)
    _assert_same(ts.sigmafilter(data, 2), js.sigmafilter(data, 2))
    x = np.array([conc, laser, itime])
    _assert_same(ts.fitFuncBg(x, 0.2, 0.1), js.fitFuncBg(x, 0.2, 0.1))
    _assert_same(ts.fitFuncStd(x, 0.2, 0.1, 3), js.fitFuncStd(x, 0.2, 0.1, 3))


def test_closed_loop_with_the_ports_localize():
    """JAX's closed loop (tests/test_simulate.py:71-101) with the port's
    localize (MLE) on the CPU."""
    from scipy.spatial import cKDTree

    from picasso_torch import localize

    movie, sites, info = ts.simulate_movie(
        n_sites=16, imagesize=32, frames=400, taud=3000, photonrate=60,
        seed=7)
    cam = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    locs = localize.localize(movie, cam, {"Min. Net Gradient": 3000,
                                          "Box Size": 7},
                             movie_info=[info], fitting_method="gaussmle",
                             device="cpu")
    assert len(locs) > 50
    d, _ = cKDTree(sites).query(np.column_stack([locs["x"], locs["y"]]))
    assert np.median(d) < 1.0

