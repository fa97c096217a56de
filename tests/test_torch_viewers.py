"""The port's movie browser and locs filter (picasso_torch.gui.LocalizeApp,
FilterApp) beside picasso_tpu's, on the Agg backend with device="cpu":
the recipes of tests/test_gui.py, each run on both apps.

What is held, and how closely:
- LocalizeApp's preview: the spots of each frame by compare_hits (equal
  but at near-threshold ties), the titles equal, on frame and gradient
  keys and with an ROI;
- ``localize_movie`` at the app's default (gausslq) and gaussmle: frames
  equal in hit order, MLE fits by compare_fits, LM locs as
  tests/test_torch_localize_lq.py holds localize (>= 99% of x/y within
  1e-3 px, lpx/lpy within 1e-2 relative for >= 99%), the info chains
  and the saved yaml equal;
- ``fit_from_identifications`` from JAX's identifications file: MLE by
  compare_fits, LM by compare_lq_fits (tests/test_torch_localize.py's
  fit2D test), the info chains equal;
- ``localize_movie_3d``: z and d_zcalib equal where the 2D widths are,
  z within tests/test_torch_zfit.Z_DIFF_NM (1 nm); ``calibrate_z`` on a
  stack: the curves within 1e-6 px over +-400 nm (test_torch_zfit);
- ``quality_check`` on the same locs: NeNA and the event length equal,
  the drift within DRIFT_AGREE (1e-5 px, test_torch_db); ``save_spots``:
  the spots, count and info equal;
- FilterApp: masks, counts, history, tables, pages and columns equal;
  the saved .hdf5/.yaml and ThunderSTORM .csv files equal; the 2D
  histogram's counts equal; the subclustering counts equal;
- without a card, device="cuda" raises in every app's constructor.
Every figure is closed after each test.
"""

from __future__ import annotations

import importlib.util
import sys
import types

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from picasso_torch import gui as tgui  # noqa: E402
from picasso_torch import io as tio  # noqa: E402
from picasso_torch import localize as tloc  # noqa: E402
from picasso_torch.gui import plugins as tplugins  # noqa: E402
from picasso_tpu import gui as jgui  # noqa: E402
from picasso_tpu import io as jio  # noqa: E402
from picasso_tpu import localize as jloc  # noqa: E402
from tests.test_torch_localize import CAM2, _fit_cols  # noqa: E402
from tests.test_torch_render_gui import _rec, _table_equal  # noqa: E402
from tests.test_torch_zfit import (  # noqa: E402
    Z_DIFF_NM, _simulated_astig_movie,
)
from torch_data import CALIB_3D, make_bench_movie  # noqa: E402
from torch_native import loaded_native  # noqa: E402
from torch_parity import (  # noqa: E402
    compare_fits, compare_hits, compare_lq_fits,
)

CPU = {"device": "cpu"}
DRIFT_AGREE = 1e-5  # px, tests/test_torch_db.py
MIN_NG = 5000  # LocalizeApp's default
INFO = [{"Frames": 100, "Height": 32, "Width": 32, "Pixelsize": 130}]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    plt.close("all")


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
             "Width": movie.shape[2], "Pixelsize": 130}]


def _apps(movie, **kw):
    return (tgui.LocalizeApp(movie, _movie_info(movie), **kw, **CPU),
            jgui.LocalizeApp(movie, _movie_info(movie), **kw))


def _hits(app):
    _, x, y, ng = app.identify_current()
    return [app.frame_number * np.ones(len(x), int), np.asarray(y),
            np.asarray(x), np.asarray(ng)]


# ---------------------------------------------------------------------------
# LocalizeApp
# ---------------------------------------------------------------------------


def test_browse_and_identify_match_jax(movie):
    t, j = _apps(movie)
    assert t.redraw() == j.redraw() > 0
    keys = ("right", "right", "down", "left", "up", "down", "down", "x")
    for key in keys:
        for app in (t, j):
            app._on_key(types.SimpleNamespace(key=key))
        assert t.frame_number == j.frame_number
        assert t.min_net_gradient == j.min_net_gradient
        assert t.ax.get_title() == j.ax.get_title()
        compare_hits(_hits(j), _hits(t), t.min_net_gradient)
    assert t.frame_number == 1 and t.min_net_gradient < MIN_NG
    for app in (t, j):
        app.set_roi(4, 8, 40, 48)
    assert t.ax.get_title() == j.ax.get_title()
    compare_hits(_hits(j), _hits(t), t.min_net_gradient)
    for app in (t, j):
        app.clear_roi()
    assert t.roi is None and t.redraw() == j.redraw()


def test_camera_parameters_and_config_match_jax(movie):
    t, j = _apps(movie)
    for app in (t, j):
        app.set_camera_parameters(Baseline=100, Sensitivity=0.5)
        with pytest.raises(KeyError, match="Bogus"):
            app.set_camera_parameters(Bogus=1)
    assert t.camera_info == j.camera_info
    assert t.load_camera_config(config={}) == j.load_camera_config(config={})
    config = {"Cameras": {"cam A": {"Baseline": 398, "Sensitivity": 0.46,
                                    "Gain": 2, "Qe": 0.9}}}
    for app in (t, j):
        app.info = [dict(app.info[0], Camera="cam A")]
    assert t.load_camera_config(config=config) == (
        j.load_camera_config(config=config))
    assert t.camera_info["Baseline"] == 398


def _hit_order(locs: np.ndarray) -> np.ndarray:
    return locs[np.lexsort((locs["x"], locs["y"], locs["frame"]))]


@pytest.mark.parametrize("method", [None, "gaussmle"])
def test_localize_movie_matches_jax(movie, tmp_path, method):
    """None: the app's default method, gausslq."""
    t, j = _apps(movie)
    out = {tag: str(tmp_path / f"{tag}_locs.hdf5") for tag in "tj"}
    got, got_info = t.localize_movie(out["t"], fitting_method=method)
    ref, ref_info = j.localize_movie(out["j"], fitting_method=method)
    assert got_info == ref_info
    ref = ref.sort_index().to_records(index=False)  # hit order
    assert got.dtype == ref.dtype and len(got) == len(ref) > 50
    np.testing.assert_array_equal(got["frame"], ref["frame"])
    ids = tloc.identify(movie, MIN_NG, 7, **CPU)
    if method == "gaussmle":
        compare_fits(_fit_cols(ref, ids, method), _fit_cols(got, ids, method))
    else:
        d = np.maximum(np.abs(got["x"] - ref["x"]), np.abs(got["y"]
                                                           - ref["y"]))
        assert np.mean(d <= 1e-3) >= 0.99
        for c in ("lpx", "lpy"):
            rel = np.abs(got[c] - ref[c]) / np.abs(ref[c])
            assert np.mean(rel <= 1e-2) >= 0.99, c
    back, back_info = tio.load_locs(out["t"])
    assert len(back) == len(jio.load_locs(out["j"])[0]) > 50
    assert back_info == got_info
    assert ((tmp_path / "t_locs.yaml").read_text()
            == (tmp_path / "j_locs.yaml").read_text())
    assert t.status.last.replace("t_locs", "j_locs") == j.status.last


@pytest.mark.parametrize("method", ["gausslq", "gaussmle"])
def test_fit_from_identifications_matches_jax(movie, tmp_path, method):
    """On tests/test_torch_localize.py's fit2D recipe: the movie on a
    baseline of 100 and that test's camera (CAM2)."""
    movie = movie + np.uint16(100)
    ids, info = jloc.identify(movie, MIN_NG, 7, return_info=True)
    path = str(tmp_path / "movie_ids.hdf5")
    jio.save_identifications(path, ids, _movie_info(movie) + [info])
    t, j = _apps(movie)
    for app in (t, j):
        app.set_camera_parameters(**{k: v for k, v in CAM2.items()
                                     if k != "Pixelsize"})
    got, got_info = t.fit_from_identifications(
        path, out_path=str(tmp_path / "t_locs.hdf5"), fitting_method=method)
    ref, ref_info = j.fit_from_identifications(
        path, out_path=str(tmp_path / "j_locs.hdf5"), fitting_method=method)
    assert got_info == ref_info
    # rows in hit order: fit2D keeps the file's order, so the hits go
    # with the port's rows (tests/test_torch_localize.py's fit2D test)
    ref = _hit_order(ref.to_records(index=False))
    order = np.lexsort((got["x"], got["y"], got["frame"]))
    got, hits = got[order], tio.load_identifications(path)[0][order]
    assert got.dtype == ref.dtype and len(got) == len(ref) == len(ids) > 50
    np.testing.assert_array_equal(got["frame"], ref["frame"])
    if method == "gaussmle":
        compare_fits(_fit_cols(ref, hits, method),
                     _fit_cols(got, hits, method))
    else:
        camera = dict(t.camera_info)
        spots_t = jloc.get_spots(movie, pd.DataFrame(hits), 7,
                                 camera).transpose(1, 2, 0)
        compare_lq_fits(_fit_cols(ref, hits, method),
                        _fit_cols(got, hits, method), spots_t)
    assert t.status.messages[0] == j.status.messages[0]


@pytest.mark.parametrize("method", ["gausslq", "gaussmle"])
def test_localize_movie_3d_matches_jax(tmp_path, method):
    movie = _simulated_astig_movie()
    info = [{"Frames": len(movie), "Height": 48, "Width": 48,
             "Data Type": "uint16", "Byte Order": "<", "Pixelsize": 130}]
    t = tgui.LocalizeApp(movie, info, min_net_gradient=3000, **CPU)
    j = jgui.LocalizeApp(movie, info, min_net_gradient=3000)
    for app in (t, j):
        app.set_camera_parameters(Baseline=100, Sensitivity=0.45, Gain=7)
    got, got_info = t.localize_movie_3d(CALIB_3D, str(tmp_path / "t.hdf5"),
                                        fitting_method=method)
    ref, ref_info = j.localize_movie_3d(CALIB_3D, str(tmp_path / "j.hdf5"),
                                        fitting_method=method)
    assert got_info == ref_info
    ref = _hit_order(ref.to_records(index=False))
    got = _hit_order(got)
    assert got.dtype == ref.dtype and len(got) == len(ref) > 50
    np.testing.assert_array_equal(got["frame"], ref["frame"])
    same = (got["sx"] == ref["sx"]) & (got["sy"] == ref["sy"])
    assert same.any()
    for name in ("z", "d_zcalib"):
        np.testing.assert_array_equal(got[name][same], ref[name][same])
    assert np.abs(got["z"] - ref["z"]).max() <= Z_DIFF_NM
    assert t.status.last.replace("t.hdf5", "j.hdf5") == j.status.last


def test_calibrate_z_matches_jax(movie, tmp_path, monkeypatch):
    """calibrate_z composes localize_movie and zfit.calibrate_z; a
    simulated z stack stands in for the fit, as tests/test_gui.py does."""
    rng = np.random.default_rng(3)
    n_frames, d = 201, 5.0
    cx = np.asarray(CALIB_3D["X Coefficients"])
    cy = np.asarray(CALIB_3D["Y Coefficients"])
    f = np.repeat(np.arange(n_frames), 10)
    z = ((n_frames - 1) / 2 - f) * d
    stack = pd.DataFrame({
        "frame": f.astype(np.uint32),
        "x": rng.uniform(5, 27, len(f)).astype(np.float32),
        "y": rng.uniform(5, 27, len(f)).astype(np.float32),
        "sx": (np.polyval(cx, z) + rng.normal(0, 0.01, len(f))
               ).astype(np.float32),
        "sy": (np.polyval(cy, z) + rng.normal(0, 0.01, len(f))
               ).astype(np.float32),
    })
    info = [dict(_movie_info(movie)[0], Frames=n_frames)]
    t, j = _apps(movie)
    monkeypatch.setattr(t, "localize_movie", lambda: (_rec(stack), info))
    monkeypatch.setattr(j, "localize_movie", lambda: (stack, info))
    got = t.calibrate_z(d, 0.79, path=str(tmp_path / "t.yaml"))
    ref = j.calibrate_z(d, 0.79, path=str(tmp_path / "j.yaml"))
    assert got.keys() == ref.keys()
    zz = np.linspace(-400, 400, 81)
    for key in ("X Coefficients", "Y Coefficients"):
        np.testing.assert_allclose(np.polyval(got[key], zz),
                                   np.polyval(ref[key], zz), rtol=0,
                                   atol=1e-6)
    assert t.status.last.replace("t.yaml", "j.yaml") == j.status.last


def test_quality_check_and_save_spots_match_jax(movie, tmp_path):
    t, j = _apps(movie)
    locs, info = j.localize_movie()
    qt = t.quality_check(_rec(locs.reset_index(drop=True)), info)
    qj = j.quality_check(locs, info)
    assert qt.keys() == qj.keys()
    for k in ("NeNA (px)", "Mean event length (frames)"):
        assert qt[k] == qj[k] or (np.isnan(qt[k]) and np.isnan(qj[k])), k
    for k in ("Mean drift x (px)", "Mean drift y (px)"):
        assert abs(qt[k] - qj[k]) <= DRIFT_AGREE, k
    assert t.status.last.startswith("QC:")
    n = [app.save_spots(str(tmp_path / f"{tag}_spots.npy"))
         for app, tag in ((t, "t"), (j, "j"))]
    assert n[0] == n[1] > 0
    st, it = tio.load_spots(str(tmp_path / "t_spots.npy"))
    sj, ij = jio.load_spots(str(tmp_path / "j_spots.npy"))
    np.testing.assert_array_equal(st, sj)
    assert it == ij and it[-1]["Box Size"] == 7


def test_apps_need_the_card_or_cpu(movie):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    locs = _rec(_locs())
    with pytest.raises(RuntimeError, match="cuda"):
        tgui.LocalizeApp(movie, _movie_info(movie))
    with pytest.raises(RuntimeError, match="cuda"):
        tgui.FilterApp(locs, INFO)
    with pytest.raises(RuntimeError, match="cuda"):
        tgui.RenderApp(locs, INFO)
    assert tgui.LocalizeApp is tgui.viewers.LocalizeApp
    assert tgui.viewers.RenderApp is tgui.render_app.RenderApp


# ---------------------------------------------------------------------------
# FilterApp
# ---------------------------------------------------------------------------


def _locs(n=2000, seed=0):
    """tests/test_gui.py's locs."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "frame": rng.integers(0, 100, n).astype(np.uint32),
        "x": rng.uniform(2, 30, n).astype(np.float32),
        "y": rng.uniform(2, 30, n).astype(np.float32),
        "photons": rng.uniform(100, 5000, n).astype(np.float32),
        "lpx": np.full(n, 0.1, np.float32),
        "lpy": np.full(n, 0.1, np.float32),
    })


def _filters():
    df = _locs()
    return tgui.FilterApp(_rec(df), INFO, **CPU), jgui.FilterApp(df, INFO)


def _same_filter(t, j):
    assert t.n_filtered == j.n_filtered
    np.testing.assert_array_equal(t._mask, j._mask)
    assert t.history == j.history
    assert t.ax.get_title() == j.ax.get_title()
    assert t.current_column == j.current_column
    _table_equal(t.locs, j.locs, "filtered")


FILTER_STEPS = {
    "1d": lambda a: (a.apply_filter("photons", 1000, 3000),
                     a.plot_histogram("lpx")),
    "2d and lasso": lambda a: (a.apply_filter_2d("x", "y", 5, 25, 5, 25),
                               a.apply_lasso("x", "y",
                                             [(5, 5), (25, 5), (5, 25)])),
    "undo": lambda a: (a.apply_filter("photons", 1000, 4000),
                       a.apply_filter_2d("x", "y", 10, 20, 10, 20),
                       a.apply_lasso("x", "photons",
                                     [(0, 0), (40, 0), (40, 6000)]),
                       a.undo(), a.undo()),
    "undo all": lambda a: (a.apply_filter("x", 10, 20), a.undo_all(),
                           a.undo()),
}


@pytest.mark.parametrize("steps", list(FILTER_STEPS))
def test_filter_steps_match_jax(steps):
    t, j = _filters()
    assert t.current_column == j.current_column == "photons"
    for app in (t, j):
        FILTER_STEPS[steps](app)
    _same_filter(t, j)
    page = t.table(0, 10)
    assert len(page) == 10
    _table_equal(page, j.table(0, 10), "page")
    np.testing.assert_array_equal(t.get_column("x"),
                                  j.get_column("x"))


@pytest.mark.parametrize("ext", ["hdf5", "csv"])
def test_filter_save_matches_jax(tmp_path, ext):
    t, j = _filters()
    for app in (t, j):
        app.apply_filter("photons", 1000, 4000)
        app.apply_filter_2d("lpx", "lpy", 0.0, 1.0, 0.0, 1.0)
        app.apply_lasso("x", "y", [(0, 0), (32, 0), (0, 32)])
    paths = {tag: str(tmp_path / f"{tag}_locs.{ext}") for tag in "tj"}
    t.save(paths["t"])
    j.save(paths["j"])
    if ext == "csv":
        assert (tmp_path / "t_locs.csv").read_bytes() == (
            tmp_path / "j_locs.csv").read_bytes()
        return
    lt, it = tio.load_locs(paths["t"])
    lj, ij = jio.load_locs(paths["j"])
    _table_equal(lt, lj, "saved")
    assert it == ij and it[-1]["Filters 2D"][0]["Column X"] == "lpx"
    assert ((tmp_path / "t_locs.yaml").read_text()
            == (tmp_path / "j_locs.yaml").read_text())


def test_filter_hist2d_and_table_assignment_match_jax():
    t, j = _filters()
    ft = t.plot_hist2d("x", "photons")
    fj = j.plot_hist2d("x", "photons")
    ct, cj = (np.asarray(f.axes[0].collections[0].get_array())
              for f in (ft, fj))
    np.testing.assert_array_equal(ct, cj)
    for app in (t, j):
        app.apply_filter("x", 3, 29)
    t.locs = t.locs[t.locs["photons"] > 2000]
    j.locs = j.locs[j.locs["photons"] > 2000]
    _same_filter(t, j)
    assert t.n_filtered == len(t.original) and t.history == []


def test_filter_subclustering_matches_jax():
    from tests.test_torch_cluster import PIXELSIZE, _clustered
    from picasso_torch import clusterer as tclust

    locs, info = _clustered(23, False)
    centers = tclust.find_cluster_centers(locs, None, **CPU)
    t = tgui.FilterApp(centers, info, **CPU)
    j = jgui.FilterApp(pd.DataFrame.from_records(centers), info)
    for dist in ((25, 80), (60, 200)):
        (_, got), (_, want) = (app.plot_subclustering(*dist)
                               for app in (t, j))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert PIXELSIZE > 0


def test_plugin_template_loads_into_the_filter(monkeypatch, capsys):
    """The port's plugin template, loaded as a drop-in module would be:
    its action registers on a RenderApp (its ``name``), runs, and says
    so; it names the port; apps of other names skip it."""
    import os

    import picasso_torch.gui as pkg

    assert "plugin_template" not in tplugins.discover_plugin_modules()
    path = os.path.join(os.path.dirname(pkg.__file__), "plugin_template.py")
    spec = importlib.util.spec_from_file_location(
        "picasso_torch.gui.plugins.template_copy", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setitem(sys.modules, spec.name, module)
    monkeypatch.setattr(tplugins, "discover_plugin_modules",
                        lambda: ["template_copy"])
    app = tgui.RenderApp(_rec(_locs()), INFO, **CPU)
    assert [label for label, _ in app.plugin_actions] == [
        "Example plugin action"]
    app.run_plugin_action("Example plugin action")
    assert "picasso_torch plugin" in capsys.readouterr().out
    assert tgui.FilterApp(_rec(_locs()), INFO, **CPU).plugins == []
