"""The port's secondary GUI apps (picasso_torch.gui) on the Agg backend,
each beside picasso_tpu's app on the same inputs (the recipes of
tests/test_gui_apps.py), with device="cpu".

What is held, and how closely:
- RotationApp: the rotated render within tests/test_torch_render3d.py's
  RTOL/ATOL of JAX's (gaussian blur) and the RGB equal where the render
  is exact (no blur); the tripod and the angles drawn equal; the GIF's
  frame count and shape equal; the saved locs and info chain equal;
- AverageApp: JAX's host route (12 origami) equal; JAX's device route
  (64 origami) within test_torch_average.XY_ABS after the iterations;
- Average3App: x, y and z equal to JAX's (no pass has a near tie on
  this recipe, compare_average3's premise), the saved file equal;
- SimulateApp: the movie, the truth, the positions, the structures and
  the saved raw equal for the same seed;
- DesignApp: the plates byte-equal, the clicked hex canvas included;
- SpinnaApp: the structures' yaml, the search space, the mask and the
  NND values equal;
- NanotronApp: JAX's model carried across (nanotron.params_from_jax)
  predicts the same classes, its probabilities within 1e-5;
- ToRawApp: the .raw and .yaml files byte-equal.
Every figure is closed after each test.
"""

from __future__ import annotations

import os
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
from picasso_torch import render as trender  # noqa: E402
from picasso_tpu import gui as jgui  # noqa: E402
from picasso_tpu import render as jrender  # noqa: E402
from torch_data import (  # noqa: E402
    make_average3_locs, make_origami_locs, origami_groups, write_tiff,
)

CPU = {"device": "cpu"}
INFO = [{"Frames": 100, "Height": 32, "Width": 32, "Pixelsize": 130}]
RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_render3d.py
XY_ABS = 1e-3  # tests/test_torch_average.py


@pytest.fixture(autouse=True)
def _close_figures():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    plt.close("all")


def _df(locs):
    return pd.DataFrame.from_records(locs)


def _locs_3d(n=3000, seed=0, frames=100):
    """tests/test_gui_apps.py's 3D locs as a structured array."""
    rng = np.random.default_rng(seed)
    locs = np.zeros(n, [("frame", np.uint32), ("x", np.float32),
                        ("y", np.float32), ("z", np.float32),
                        ("photons", np.float32), ("sx", np.float32),
                        ("sy", np.float32), ("bg", np.float32),
                        ("lpx", np.float32), ("lpy", np.float32)])
    locs["frame"] = rng.integers(0, frames, n)
    locs["x"] = rng.uniform(4, 28, n)
    locs["y"] = rng.uniform(4, 28, n)
    locs["z"] = rng.uniform(-200, 200, n)
    locs["photons"] = rng.uniform(500, 3000, n)
    locs["sx"], locs["sy"], locs["bg"] = 1.1, 1.0, 10
    locs["lpx"] = locs["lpy"] = 0.05
    return locs


def _assert_table_equal(got: np.ndarray, want):
    want = want.to_records(index=False) if isinstance(
        want, pd.DataFrame) else want
    assert got.dtype == want.dtype
    for n in got.dtype.names:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


# ---------------------------------------------------------------------------
# RotationApp
# ---------------------------------------------------------------------------


def _record_renders(monkeypatch, module, into: list):
    """Keep the float image each render_frame passes to scale_contrast."""
    keep = module.scale_contrast

    def record(image, *a, **k):
        into.append(np.array(image))
        return keep(image, *a, **k)

    monkeypatch.setattr(module, "scale_contrast", record)


@pytest.mark.parametrize("blur", ["gaussian", None])
def test_rotation_app_renders_as_jax(monkeypatch, blur):
    """The rotated views of the window on its keys, against JAX's: the
    render within RTOL/ATOL (equal without blur), the RGB with its
    tripod and angles equal where the render is exact, the titles
    equal."""
    locs = _locs_3d()
    images = {"t": [], "j": []}
    _record_renders(monkeypatch, trender, images["t"])
    _record_renders(monkeypatch, jrender, images["j"])
    t = tgui.RotationApp(locs, INFO, blur_method=blur, **CPU)
    j = jgui.RotationApp(_df(locs), INFO, blur_method=blur)
    assert t.ax.get_title() == j.ax.get_title()
    key = types.SimpleNamespace(key="right", inaxes=None)
    for app in (t, j):
        app.rotate(dy=np.radians(30), dz=0.2)
        app._on_key(key)
        app._on_key(types.SimpleNamespace(key="+", inaxes=None))
    assert t.ax.get_title() == j.ax.get_title() and "40" in t.ax.get_title()
    assert len(images["t"]) == len(images["j"]) == 4
    for a, b in zip(images["t"], images["j"]):
        assert a.shape == b.shape and b.max() > 0
        if blur is None:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL * b.max())
    rgb_t, n_t = t.render_frame()
    rgb_j, n_j = j.render_frame()
    assert n_t == n_j > 0 and rgb_t.shape == rgb_j.shape
    if blur is None:
        np.testing.assert_array_equal(rgb_t, rgb_j)
    t.close()
    j.close()
    assert t.fig is None


def test_rotation_app_needs_z_and_the_card():
    locs = _locs_3d(200)
    no_z = locs[[n for n in locs.dtype.names if n != "z"]]
    with pytest.raises(ValueError, match="z column"):
        tgui.RotationApp(no_z, INFO, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tgui.RotationApp(locs, INFO)


def test_rotation_drawing_helpers_match_jax():
    rgb = np.random.default_rng(4).integers(0, 255, (120, 160, 3),
                                            dtype=np.uint8)
    for ang in ((0.0, 0.0, 0.0), (0.3, -1.2, 2.5)):
        np.testing.assert_array_equal(trender.draw_rotation(rgb, ang),
                                      jrender.draw_rotation(rgb, ang))
        np.testing.assert_array_equal(
            trender.draw_rotation_angles(rgb, ang),
            jrender.draw_rotation_angles(rgb, ang))
        np.testing.assert_array_equal(
            trender.draw_rotation(rgb, ang, 12, (20, 30)),
            jrender.draw_rotation(rgb, ang, 12, (20, 30)))


def test_rotation_app_animation_export_and_save_match_jax(tmp_path):
    import imageio

    locs = _locs_3d(300, seed=1, frames=50)
    info = [dict(INFO[0], Frames=50)]
    apps = {"t": tgui.RotationApp(locs, info, blur_method=None,
                                  oversampling=4.0, **CPU),
            "j": jgui.RotationApp(_df(locs), info, blur_method=None,
                                  oversampling=4.0)}
    out = {}
    for name, app in apps.items():
        app.add_keyframe()
        app.rotate(dy=np.radians(90))
        app.add_keyframe()
        gif = tmp_path / f"{name}.gif"
        n = app.build_animation(str(gif), n_frames_between=4, fps=5)
        app.export_view(str(tmp_path / f"{name}.png"))
        app.save_rotated_locs(str(tmp_path / f"{name}_locs.hdf5"),
                              pick=(16.0, 16.0), pick_shape="Circle",
                              pick_size=2.0)
        out[name] = (n, imageio.v3.imread(gif, index=None),
                     imageio.v3.imread(tmp_path / f"{name}.png"))
    assert out["t"][0] == out["j"][0] == 5
    assert out["t"][1].shape == out["j"][1].shape
    assert out["t"][1].shape[0] == 5
    np.testing.assert_array_equal(out["t"][1], out["j"][1])
    np.testing.assert_array_equal(out["t"][2], out["j"][2])
    t_locs, t_info = tio.load_locs(str(tmp_path / "t_locs.hdf5"))
    j_locs, j_info = tio.load_locs(str(tmp_path / "j_locs.hdf5"))
    _assert_table_equal(t_locs, j_locs)
    assert t_info == j_info and t_info[-1]["Pick size (nm)"] == 260.0
    apps["t"].clear_keyframes()
    with pytest.raises(ValueError, match="2 keyframes"):
        apps["t"].build_animation(str(tmp_path / "x.gif"))


# ---------------------------------------------------------------------------
# AverageApp and Average3App
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_origami,iterations", [(12, 2), (64, 2)])
def test_average_app_matches_jax(tmp_path, n_origami, iterations):
    """12 origami take both packages' host route (equal bit for bit), 64
    their device route (x, y within XY_ABS, as test_torch_average); the
    saved files agree the same way."""
    locs, info, truth = make_origami_locs(n_origami, 5)
    locs = origami_groups(locs, truth)
    t = tgui.AverageApp(locs, info, **CPU)
    j = jgui.AverageApp(_df(locs), info)
    assert t.ax.get_title() == j.ax.get_title()
    calls = []
    got = t.run(iterations=iterations, progress=lambda *a: calls.append(a))
    want = j.run(iterations=iterations).to_records(index=False)
    assert len(calls) == iterations and t.iterations_done == iterations
    assert t.ax.get_title() == j.ax.get_title()
    assert got.dtype == want.dtype
    if n_origami < 64:
        _assert_table_equal(got, want)
    else:
        for c in ("x", "y"):
            np.testing.assert_allclose(got[c], want[c], rtol=0, atol=XY_ABS)
    t.save(str(tmp_path / "t_avg.hdf5"))
    j.save(str(tmp_path / "j_avg.hdf5"))
    t_locs, t_info = tio.load_locs(str(tmp_path / "t_avg.hdf5"))
    j_locs, j_info = tio.load_locs(str(tmp_path / "j_avg.hdf5"))
    assert t_info == j_info and len(t_locs) == len(j_locs) == len(locs)
    np.testing.assert_allclose(t_locs["x"], j_locs["x"], rtol=0,
                               atol=0 if n_origami < 64 else XY_ABS)


def test_average3_app_matches_jax(tmp_path):
    """tests/test_gui_apps.py's Average3App recipe (one pass about z at
    oversampling 8): x, y, z equal to JAX's, the same projections'
    titles, and the same saved file."""
    locs = make_average3_locs(n_groups=6)
    info = [{"Frames": len(locs), "Height": 32, "Width": 32,
             "Pixelsize": 130}]
    t = tgui.Average3App(locs, info, oversampling=8, **CPU)
    j = jgui.Average3App(_df(locs), info, oversampling=8)
    got = t.run(iterations=1, rot_axes=("z",))
    want = j.run(iterations=1, rot_axes=("z",))
    _assert_table_equal(got, want)
    assert t.fig._suptitle.get_text() == j.fig._suptitle.get_text()
    for ax_t, ax_j in zip(t.axes, j.axes):
        np.testing.assert_array_equal(ax_t.images[0].get_array(),
                                      ax_j.images[0].get_array())
    t.save(str(tmp_path / "t.hdf5"))
    j.save(str(tmp_path / "j.hdf5"))
    t_locs, t_info = tio.load_locs(str(tmp_path / "t.hdf5"))
    j_locs, j_info = tio.load_locs(str(tmp_path / "j.hdf5"))
    _assert_table_equal(t_locs, j_locs)
    assert t_info == j_info and t_info[-1]["Generated by"] == (
        "Picasso Average3")
    with pytest.raises(ValueError, match="group"):
        tgui.Average3App(locs[["frame", "x", "y", "z"]], info, **CPU)


# ---------------------------------------------------------------------------
# SimulateApp
# ---------------------------------------------------------------------------


def test_simulate_app_matches_jax(tmp_path):
    t = tgui.SimulateApp(frames=8, imagesize=16, n_sites=5)
    j = jgui.SimulateApp(frames=8, imagesize=16, n_sites=5)
    movie_t, info_t = t.run()
    movie_j, info_j = j.run()
    np.testing.assert_array_equal(movie_t, movie_j)
    np.testing.assert_array_equal(t.ground_truth, j.ground_truth)
    assert info_t == info_j and movie_t.dtype == np.uint16
    for app in (t, j):
        app._on_key(types.SimpleNamespace(key="right"))
    assert t.frame_number == j.frame_number == 1
    assert t.ax.get_title() == j.ax.get_title()
    t.save(str(tmp_path / "t.raw"))
    j.save(str(tmp_path / "j.raw"))
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw"
                                                 ).read_bytes()
    assert (tmp_path / "t.yaml").read_bytes() == (tmp_path / "j.yaml"
                                                  ).read_bytes()
    for call in (lambda a: a.grid_structure(3, 4, 20, 20),
                 lambda a: a.circle_structure(8, 100.0),
                 lambda a: a.custom_structure([0, 10, 25], [5, 0, 12],
                                              exchange=[1, 2, 1])):
        np.testing.assert_array_equal(call(t), call(j))
    assert t.plot_structure() is not None
    for arrangement in (0, 1):
        np.random.seed(11)
        pos_t = t.generate_positions(25, frame=3, arrangement=arrangement)
        np.random.seed(11)
        pos_j = j.generate_positions(25, frame=3, arrangement=arrangement)
        np.testing.assert_array_equal(pos_t, pos_j)
    assert t.plot_positions() is not None
    rng = np.random.default_rng(0)
    stats = [rng.uniform(1, 10, 30) for _ in range(5)]
    got, want = t.calibrate_noise(*stats), j.calibrate_noise(*stats)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_design_to_simulate_handoff_matches_jax(tmp_path):
    """A Design yaml exported by each package imports into each package's
    Simulate window as the same structure."""
    structures = []
    for gui in (tgui, jgui):
        d = gui.DesignApp()
        d.grid[0, 0] = 1
        d.grid[2, 1] = 2
        path = str(tmp_path / f"{gui.__name__}.yaml")
        d.export_design(path)
        structures.append(gui.SimulateApp().import_design(path))
    np.testing.assert_array_equal(*structures)
    assert (tmp_path / "picasso_torch.gui.yaml").read_bytes() == (
        tmp_path / "picasso_tpu.gui.yaml").read_bytes()


# ---------------------------------------------------------------------------
# DesignApp
# ---------------------------------------------------------------------------


def _click(app, r, c=None):
    """A left click on site (r, c), or at canvas point r = (x, y)."""
    from matplotlib.backend_bases import MouseEvent

    x, y = app.index_to_hex(r, c) if c is not None else r
    xp, yp = app.ax.transData.transform((x, y))
    ev = MouseEvent("button_press_event", app.fig.canvas, xp, yp, button=1)
    app.fig.canvas.callbacks.process("button_press_event", ev)


def test_design_app_constants_match_jax():
    from picasso_torch.gui import apps as tapps
    from picasso_tpu.gui import apps as japps

    for name in ("DESIGN_COLUMNS", "DESIGN_ROWS", "DESIGN_RGB",
                 "HEX_SIDE_HALF", "IND2REMOVE", "ORIGAMI_SITES"):
        assert getattr(tapps, name) == getattr(japps, name), name
    assert len(tapps.ORIGAMI_SITES) == 176


def test_hex_canvas_plates_are_byte_equal_to_jax(tmp_path):
    """tests/test_gui_apps.py's hex canvas recipe on both apps: handles
    set, sites clicked on the canvas and on the palette, the same
    canvas, every plate export and the design yaml byte-equal."""
    apps = {"t": tgui.DesignApp(), "j": jgui.DesignApp()}
    for name, app in apps.items():
        app.set_extension(1, "5xR1")
        app.set_extension(2, "P3")
        app.set_extension(3, "P5")
        app.set_extension(3, "None")
        app.current_color = 1
        _click(app, 0, 0)
        _click(app, 4, 3)
        for k, xy in app._palette_positions():
            if k == 2:
                _click(app, xy)
        _click(app, 11, 15)
        _click(app, 5, 5)
        _click(app, 5, 5)  # the same colour again erases
        app.grid[7, 9] = 4  # a colour with no handle: 'P4'
        app.redraw()
        app._on_key(types.SimpleNamespace(key="6"))
        app.export_plates(str(tmp_path / f"{name}.csv"), platename="test")
        app.export_design(str(tmp_path / f"{name}.yaml"))
    t, j = apps["t"], apps["j"]
    np.testing.assert_array_equal(t.grid, j.grid)
    assert t.canvas_colors().count(1) == 2 and t.grid[11, 15] == 2
    assert t.color_counts() == j.color_counts()
    assert t.to_plate() == j.to_plate()
    assert t.prepare_plate(1) == j.prepare_plate(1)
    assert t.prepare_plate(2) == j.prepare_plate(2)
    assert t.ax.get_title() == j.ax.get_title()
    for ext in ("csv", "yaml"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (
            tmp_path / f"j.{ext}").read_bytes(), ext
    blank = [r for r in t.to_plate() if r[0] == "C2"]
    assert not blank  # a removed site has no staple
    t2, j2 = tgui.DesignApp(), jgui.DesignApp()
    t2.load_design(str(tmp_path / "j.yaml"))
    j2.load_design(str(tmp_path / "t.yaml"))
    np.testing.assert_array_equal(t2.grid, j2.grid)
    assert t2.tableshort == j2.tableshort and t2.tablelong == j2.tablelong
    t2.clear_canvas()
    assert not t2.grid.any() and t2.tableshort == ["None"] * 7
    with pytest.raises(ValueError):
        t2.set_extension(8, "P1")


# ---------------------------------------------------------------------------
# SpinnaApp
# ---------------------------------------------------------------------------


def _spinna_app(gui, **kw):
    app = gui.SpinnaApp(**kw)
    app.new_structure("monomer")
    app.set_structure_coordinates(0, "T", [0.0], [0.0])
    app.new_structure("dimer")
    app.set_structure_coordinates(1, "T", [0.0, 20.0], [0.0, 0.0])
    return app


def test_spinna_app_matches_jax(tmp_path):
    """tests/test_gui_apps.py's SPINNA workflow on both apps: the saved
    structures, the search space, a simulation from one seed, the NND
    values and their files, and the mask, equal."""
    out = {}
    for name, gui, kw in (("t", tgui, CPU), ("j", jgui, {})):
        app = _spinna_app(gui, **kw)
        assert app.plot_structure(1) is not None
        app.save_structures(str(tmp_path / f"{name}_structs.yaml"))
        space = app.generate_search_space({"T": 100}, granularity=5)
        np.random.seed(3)
        app.build_mixer(label_unc={"ALL": 3.0}, le={"ALL": 1.0},
                        width=5000.0, height=5000.0)
        gt = app.mixer.run_simulation([30, 35])
        app.set_experimental_data("T", gt["T"])
        np.random.seed(4)
        de, ds = app.run_single_simulation([30, 35], N_sim=1)
        assert app.plot_nnd() is not None
        paths = app.save_nnd_values(str(tmp_path / f"{name}_nnd"))
        rng = np.random.default_rng(0)
        locs = np.zeros(2000, [("frame", np.uint32), ("x", np.float32),
                               ("y", np.float32)])
        locs["frame"] = rng.integers(0, 100, 2000)
        locs["x"] = rng.uniform(2, 14, 2000)
        locs["y"] = rng.uniform(2, 14, 2000)
        info = [{"Frames": 100, "Height": 16, "Width": 16, "Pixelsize": 130}]
        mask = app.generate_mask(locs if name == "t" else _df(locs), info,
                                 binsize=260.0, sigma=260.0)
        app.save_mask(str(tmp_path / f"{name}_mask.npy"))
        app.delete_structure_target(0, "T")
        out[name] = (space, gt, de, ds, [open(p, "rb").read() for p in paths],
                     mask, app.structures[0].targets)
    t, j = out["t"], out["j"]
    assert t[0].keys() == j[0].keys() == {"monomer", "dimer"}
    for k in t[0]:
        np.testing.assert_array_equal(t[0][k], j[0][k])
    np.testing.assert_array_equal(t[1]["T"], j[1]["T"])
    for a, b in zip(t[2] + t[3], j[2] + j[3]):
        np.testing.assert_array_equal(a, b)
    assert t[4] == j[4] and len(t[4]) == 2
    np.testing.assert_array_equal(t[5], j[5])
    assert t[5].ndim == 2 and t[5].max() > 0 and t[6] == j[6] == []
    assert (tmp_path / "t_structs.yaml").read_bytes() == (
        tmp_path / "j_structs.yaml").read_bytes()
    np.testing.assert_array_equal(np.load(tmp_path / "t_mask.npy"),
                                  np.load(tmp_path / "j_mask.npy"))
    app = tgui.SpinnaApp(**CPU)
    targets = app.load_structures(str(tmp_path / "j_structs.yaml"))
    assert targets == ["T"] and [s.title for s in app.structures] == [
        "monomer", "dimer"]
    with pytest.raises(RuntimeError, match="build_mixer"):
        app.fit([[1, 1]])


# ---------------------------------------------------------------------------
# NanotronApp
# ---------------------------------------------------------------------------


def _nanotron_locs(kind, n_picks, rng):
    """tests/test_gui_apps.py's picks (spots or rings) as a structured
    array."""
    rows = []
    for g in range(n_picks):
        cx, cy = rng.uniform(5, 27, 2)
        if kind == "spot":
            pts = rng.normal((cx, cy), 0.05, (60, 2))
        else:
            ang = rng.uniform(0, 2 * np.pi, 60)
            pts = np.column_stack([cx + 0.4 * np.cos(ang),
                                   cy + 0.4 * np.sin(ang)]) + rng.normal(
                0, 0.03, (60, 2))
        rows += [(g, p[0], p[1]) for p in pts]
    arr = np.array(rows)
    locs = np.zeros(len(arr), [("frame", np.uint32), ("x", np.float32),
                               ("y", np.float32), ("group", np.int32),
                               ("lpx", np.float32), ("lpy", np.float32)])
    locs["frame"] = np.arange(len(arr)) % 100
    locs["x"], locs["y"], locs["group"] = arr[:, 1], arr[:, 2], arr[:, 0]
    locs["lpx"] = locs["lpy"] = 0.03
    return locs


def test_nanotron_app_with_jaxs_weights_predicts_as_jax(tmp_path):
    """JAX's app trains on spots and rings; its model file loads into the
    port's app (the weights carried across by nanotron.params_from_jax),
    which classifies fresh picks as JAX's app does. The port's training
    data equal JAX's within the render tolerance of
    test_torch_nanotron."""
    rng = np.random.default_rng(1)
    spots, rings = _nanotron_locs("spot", 8, rng), _nanotron_locs("ring", 8,
                                                                   rng)
    fresh = _nanotron_locs("ring", 5, rng)
    j = jgui.NanotronApp()
    t = tgui.NanotronApp(**CPU)
    for app, conv in ((j, _df), (t, lambda x: x)):
        app.add_train_dataset(conv(spots), 0, "spots")
        app.add_train_dataset(conv(rings), 1, "rings")
    assert t.prepare_training_data() == j.prepare_training_data() == 64
    for a, b in zip(t._train_data, j._train_data):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    assert t._train_labels == j._train_labels
    stats = j.train_with_stats(test_fraction=0.25, max_iter=30)
    assert stats["confusion_matrix"].sum() == 16
    path = str(tmp_path / "jax_model.sav")
    j.save_model(path)
    t.load(path)
    assert t.model_info == j.model_info
    got = t.predict_all(fresh, pick_radius=1.0, oversampling=10.0)
    want = j.predict_all(_df(fresh), pick_radius=1.0,
                         oversampling=10.0).to_records(index=False)
    assert got.dtype.names == want.dtype.names == ("group", "prediction",
                                                    "probability")
    np.testing.assert_array_equal(got["group"], want["group"])
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=1e-5)
    cut = float(np.median(want["probability"]))
    kept = t.predict_all(fresh, 1.0, 10.0, min_probability=cut)
    assert list(kept["group"]) == list(j.predict_all(
        _df(fresh), 1.0, 10.0, min_probability=cut)["group"])
    pred_t = t.predict(fresh, 2, 1.0, 10.0)
    pred_j = j.predict(_df(fresh), 2, 1.0, 10.0)
    np.testing.assert_array_equal(pred_t[0], pred_j[0])
    t.save_model(str(tmp_path / "torch_model.sav"))
    t2 = tgui.NanotronApp(**CPU)
    t2.load(str(tmp_path / "torch_model.sav"))
    np.testing.assert_array_equal(
        t2.predict_all(fresh, 1.0, 10.0)["prediction"], got["prediction"])


def test_nanotron_app_trains_with_stats_on_the_cpu():
    """The port's training workflow: a split, the accuracy, the confusion
    matrix and the learning plot, as tests/test_gui_apps.py asks of
    JAX's."""
    rng = np.random.default_rng(1)
    app = tgui.NanotronApp(**CPU)
    app.add_train_dataset(_nanotron_locs("spot", 10, rng), 0, "spots")
    app.add_train_dataset(_nanotron_locs("ring", 10, rng), 1, "rings")
    stats = app.train_with_stats(test_fraction=0.25, max_iter=60)
    n = len(app._train_data)
    assert stats["test_score"] > 0.7
    assert stats["confusion_matrix"].sum() == max(1, int(n * 0.25))
    assert app.plot_learning_stats() is not None
    assert len(app.model.loss_curve_) == 60
    out = app.predict_all(_nanotron_locs("ring", 6, rng), 1.0, 10.0,
                          min_probability=0.5)
    assert (out["prediction"] == 1).mean() > 0.6
    model = app.train(list(np.stack(app._train_data)[:8]),
                      app._train_labels[:8], max_iter=2)
    assert model is app.model and app.model_info == {"Classes": [0]}


# ---------------------------------------------------------------------------
# ToRawApp, the plugin host and the status log
# ---------------------------------------------------------------------------


def test_to_raw_app_writes_jaxs_files(tmp_path):
    movie = (np.random.default_rng(5).random((6, 20, 24)) * 900).astype(
        np.uint16)
    outs = {}
    for name, gui in (("t", tgui), ("j", jgui)):
        folder = tmp_path / name
        folder.mkdir()
        write_tiff(str(folder / "a.tif"), movie)
        write_tiff(str(folder / "b.tiff"), movie[:3])
        (folder / "notes.txt").write_text("x")
        app = gui.ToRawApp()
        app.add_folder(str(folder))
        assert [os.path.basename(p) for p in app.queue] == ["a.tif",
                                                            "b.tiff"]
        done = []
        outs[name] = [os.path.basename(p) for p in app.run(
            progress=done.append)]
        assert done == [1, 2] and app.queue == []
    assert outs["t"] == outs["j"] == ["a.ome.raw", "b.ome.raw"]
    for base in ("a.ome", "b.ome"):
        assert (tmp_path / "t" / f"{base}.raw").read_bytes() == (
            tmp_path / "j" / f"{base}.raw").read_bytes()
        t_yaml = (tmp_path / "t" / f"{base}.yaml").read_text()
        j_yaml = (tmp_path / "j" / f"{base}.yaml").read_text()
        assert t_yaml == j_yaml.replace(str(tmp_path / "j"),
                                        str(tmp_path / "t"))


def test_plugins_load_into_the_apps(monkeypatch):
    """A plugin module in picasso_torch.gui.plugins extends the app it
    names: its action runs by name and on F1; a plugin for another app
    is skipped; a broken one is reported and the app still opens."""
    from picasso_torch.gui import plugins

    ran = []

    class Plugin:
        def __init__(self, window):
            self.window = window
            self.name = "design"

        def execute(self):
            self.window.add_plugin_action("count", lambda: ran.append(1))

    class Other(Plugin):
        def __init__(self, window):
            super().__init__(window)
            self.name = "rotation"

    class Broken:
        def __init__(self, window):
            raise RuntimeError("broken plugin")

    for mod, cls in (("good", Plugin), ("other", Other), ("bad", Broken)):
        module = types.ModuleType(f"{plugins.__name__}.{mod}")
        module.Plugin = cls
        monkeypatch.setitem(sys.modules, module.__name__, module)
    monkeypatch.setattr(plugins, "discover_plugin_modules",
                        lambda: ["good", "other", "bad"])
    errors = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: errors.append(a))
    app = tgui.DesignApp()
    assert [type(p).__name__ for p in app.plugins] == ["Plugin"]
    assert any("picasso_torch plugin 'bad' failed" in e[0] for e in errors)
    app.run_plugin_action("count")
    app._on_plugin_key(types.SimpleNamespace(key="f1"))
    app._on_plugin_key(types.SimpleNamespace(key="f9"))
    assert ran == [1, 1]
    with pytest.raises(KeyError):
        app.run_plugin_action("missing")
    with tgui.DesignApp() as other:
        assert other.fig is not None
    assert other.fig is None
    monkeypatch.undo()
    assert plugins.discover_plugin_modules() == []


def test_status_log_matches_jax():
    from picasso_tpu.gui.base import StatusLog as JStatusLog

    seen = []
    logs = [tgui.StatusLog(), JStatusLog(),
            tgui.StatusLog(callback=seen.append)]
    for log in logs:
        assert log.last is None
        log("one")
        log(2)
    assert [log.messages for log in logs[:2]] == [["one", "2"]] * 2
    assert logs[0].last == logs[1].last == "2" and seen == ["one", 2]
