"""The port's render window (picasso_torch.gui.RenderApp) and render's
drawing helpers, beside picasso_tpu's on the same inputs, on the Agg
backend with device="cpu": the recipes of tests/test_render_app.py, each
session run on both apps (the mouse sessions of
tests/test_gui_interactive.py are in tests/test_torch_gui_mouse.py).

What is held, and how closely:
- the 12 drawing helpers: the RGB arrays and the values equal; the
  exported PDF/SVG files exist for both; rgb_to_qimage raises JAX's
  ImportError (no PyQt6);
- every rendered view: the float image each redraw passes to
  render.scale_contrast equal for blur None, within RENDER_AGREE of its
  maximum otherwise (chip_smoke.py: 1e-6 for smooth/convolve, 1e-5 for
  the splats), and ``last_image`` equal where the images are; the titles
  and the localization counts equal;
- drifts within DRIFT_AGREE (tests/test_torch_undrift.py: 1e-5 px), the
  undrifted locs within it too;
- picks, pick files, cluster labels, masks, linked and expression
  tables equal (after the undo too); RESI's centres within
  torch_parity.CENTERS_ULPS of JAX's;
- the saved .hdf5/.yaml/.csv files equal (tables field by field, info
  chains equal, CSV byte for byte).
Every figure is closed after each test.
"""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.backend_bases import KeyEvent  # noqa: E402

from picasso_torch import gui as tgui  # noqa: E402
from picasso_torch import io as tio  # noqa: E402
from picasso_torch import render as trender  # noqa: E402
from picasso_torch.gui import panels as tpanels  # noqa: E402
from picasso_tpu import gui as jgui  # noqa: E402
from picasso_tpu import io as jio  # noqa: E402
from picasso_tpu import lib as jlib  # noqa: E402
from picasso_tpu import render as jrender  # noqa: E402
from tests.test_render_app import (  # noqa: E402
    INFO, N_FRAMES, SITES, _locs3d, _make_channel,
)
from tests.test_torch_link import jax_order  # noqa: E402
from torch_parity import CENTERS_ULPS, compare_tables_ulps  # noqa: E402

CPU = {"device": "cpu"}
DRIFT_AGREE = 1e-5  # px, tests/test_torch_undrift.py
RENDER_AGREE = {"None": 0.0, "smooth": 1e-6, "convolve": 1e-6,
                "gaussian": 1e-5, "gaussian_iso": 1e-5}  # chip_smoke.py


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    plt.close("all")


def _rec(df: pd.DataFrame) -> np.ndarray:
    out = np.empty(len(df), [(c, df[c].dtype) for c in df.columns])
    for c in df.columns:
        out[c] = df[c].to_numpy()
    return out


def _table_equal(got: np.ndarray, want, what: str = "table"):
    want = _rec(want.reset_index(drop=True)) if isinstance(
        want, pd.DataFrame) else want
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert len(got) == len(want), (what, len(got), len(want))
    for n in want.dtype.names:
        np.testing.assert_array_equal(got[n], want[n], err_msg=f"{what} {n}")


def _as_set(rec: np.ndarray) -> np.ndarray:
    """Rows sorted by every field (tests/test_torch_undrift.py): the
    port's picked_locs and mask_locs order the rows of one frame as
    their own tests allow."""
    return rec[np.lexsort([rec[n] for n in rec.dtype.names[::-1]])]


def _rows_equal(got: np.ndarray, want, what: str = "table"):
    want = _rec(want.reset_index(drop=True)) if isinstance(
        want, pd.DataFrame) else want
    _table_equal(_as_set(got), _as_set(want), what)


def _table_close(got: np.ndarray, want, atol: float, what: str = "table"):
    want = _rec(want.reset_index(drop=True)) if isinstance(
        want, pd.DataFrame) else want
    assert got.dtype == want.dtype and len(got) == len(want), what
    for n in want.dtype.names:
        if want.dtype[n].kind == "f":
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=atol,
                                       err_msg=f"{what} {n}")
        else:
            np.testing.assert_array_equal(got[n], want[n],
                                          err_msg=f"{what} {n}")


def _one_a_frame_channel(seed: int, per_site: int = 20) -> pd.DataFrame:
    """_make_channel's sites, no fiducial and no drift, one loc a frame in
    the whole table: where a pick's rows meet JAX's link, which sorts by
    frame with pandas' quicksort, no two rows tie (as
    tests/test_torch_picks.py's ``_one_a_frame``)."""
    rng = np.random.default_rng(seed)
    frames = rng.permutation(N_FRAMES)[:len(SITES) * per_site]
    site = np.repeat(np.arange(len(SITES)), per_site)
    n = len(frames)
    locs = pd.DataFrame({
        "frame": frames.astype(np.uint32),
        "x": (SITES[site, 1] + rng.normal(0, 0.03, n)).astype(np.float32),
        "y": (SITES[site, 0] + rng.normal(0, 0.03, n)).astype(np.float32),
        "photons": rng.uniform(500, 3000, n).astype(np.float32),
        "sx": np.full(n, 0.9, np.float32),
        "sy": np.full(n, 0.9, np.float32),
        "bg": np.full(n, 50, np.float32),
        "lpx": np.full(n, 0.03, np.float32),
        "lpy": np.full(n, 0.03, np.float32),
    })
    return locs.sort_values("frame").reset_index(drop=True)


def _record_renders(monkeypatch, module, into: list):
    keep = module.scale_contrast

    def record(image, *a, **k):
        into.append(np.array(image))
        return keep(image, *a, **k)

    monkeypatch.setattr(module, "scale_contrast", record)


class Pair:
    """A JAX app and a port app built from the same locs, driven by the
    same calls; ``check`` holds their views to each other."""

    def __init__(self, monkeypatch, locs, info=INFO, port_rows=None, **kw):
        self.images = {"t": [], "j": []}
        _record_renders(monkeypatch, trender, self.images["t"])
        _record_renders(monkeypatch, jrender, self.images["j"])
        rows = _rec(locs) if port_rows is None else port_rows(_rec(locs))
        self.t = tgui.RenderApp(rows, [dict(d) for d in info], **kw, **CPU)
        self.j = jgui.RenderApp(locs.copy(), [dict(d) for d in info], **kw)

    def both(self, name, *args, **kwargs):
        out = (getattr(self.t, name)(*args, **kwargs),
               getattr(self.j, name)(*args, **kwargs))
        return out

    def set(self, **attrs):
        for app in (self.t, self.j):
            for k, v in attrs.items():
                setattr(app, k, v)

    def check(self):
        """Every render since the last check, and the current view."""
        t, j = self.images["t"], self.images["j"]
        assert len(t) == len(j) > 0
        agree = RENDER_AGREE[str(self.j.blur_method)]
        for a, b in zip(t, j):
            assert a.shape == b.shape
            if agree == 0:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=agree * max(b.max(), 1e-30))
        if agree == 0:
            np.testing.assert_array_equal(self.t.last_image,
                                          self.j.last_image)
        else:
            d = np.abs(self.t.last_image.astype(int) - self.j.last_image)
            assert d.max() <= 1
        assert self.t.ax.get_title() == self.j.ax.get_title()
        assert self.t.viewport == self.j.viewport
        assert self.t.picks == self.j.picks
        t.clear()
        j.clear()


# ---------------------------------------------------------------------------
# render's drawing helpers
# ---------------------------------------------------------------------------

RGB = np.random.default_rng(4).integers(0, 255, (120, 160, 3), dtype=np.uint8)
VIEW = ((2.0, 3.0), (14.0, 19.0))


@pytest.mark.parametrize("helper", [
    "draw_scalebar", "draw_points", "draw_picks", "draw_legend",
    "draw_minimap", "geometry"])
def test_drawing_helper_matches_jax(helper):
    calls = {
        "draw_scalebar": [((RGB, 130.0, 13.0), {}),
                          ((RGB, 130.0, 13.0), {"length_nm": 500.0}),
                          ((RGB, 108.0, 54.0), {"margin": 4,
                                                "height_px": 2})],
        "draw_points": [((RGB, [(3.5, 2.5), (10.0, 8.0), (18.9, 13.9),
                                (40.0, 1.0)], VIEW), {}),
                        ((RGB, [(5.0, 5.0)], VIEW), {"color": (0, 255, 0)})],
        "draw_picks": [((RGB, [(5.0, 5.0), (12.0, 9.0), (19.0, 2.0)], 2.0,
                         VIEW), {}),
                       ((RGB, [(8.0, 8.0)], 0.3, VIEW), {"color": (1, 2, 3)})],
        "draw_legend": [((RGB, ["ch0", "a long channel"],
                          [(255, 0, 0), (0, 255, 255)]), {}),
                        ((RGB, ["one"], [(9, 9, 9)]),
                         {"init_pos": (30, 60), "text_fontsize": 10})],
        "draw_minimap": [((RGB, VIEW, (32.0, 32.0)), {}),
                         ((RGB, ((0.0, 0.0), (32.0, 64.0)), (32.0, 64.0)),
                          {"length_minimap": 60, "margin": (5, 8)})],
    }
    if helper == "geometry":
        for args in ((3.0, 4.0, VIEW, 160, 120), (19.0, 2.0, VIEW, 64, 48)):
            assert trender.map_to_view(*args) == jrender.map_to_view(*args)
        for most_right in (False, True):
            args = (4.0, 5.0, 12.0, 9.5, 1.5, most_right)
            assert (trender.get_rectangle_pick_polygon(*args)
                    == jrender.get_rectangle_pick_polygon(*args))
        assert trender.POLYGON_POINTER_SIZE == jrender.POLYGON_POINTER_SIZE

        def shape_and_view(image, viewport):
            return viewport

        assert (trender.adjust_viewport_decorator(shape_and_view)(RGB, VIEW)
                == jrender.adjust_viewport_decorator(shape_and_view)(RGB,
                                                                     VIEW))
        return
    for args, kw in calls[helper]:
        got = getattr(trender, helper)(*args, **kw)
        want = getattr(jrender, helper)(*args, **kw)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, RGB)
        np.testing.assert_array_equal(args[0], RGB)  # not painted in place
    if helper == "draw_legend":
        with pytest.raises(AssertionError, match="channel_names"):
            trender.draw_legend(RGB, ["a", "b"], [(1, 1, 1)])


def test_qimage_helpers_without_qt(tmp_path):
    for module in (trender, jrender):
        with pytest.raises(ImportError, match="requires PyQt6"):
            module.rgb_to_qimage(RGB)
    for name in ("export_qimage_to_pdf", "export_qimage_to_svg"):
        for tag, module in (("t", trender), ("j", jrender)):
            path = tmp_path / f"{tag}{name[-3:]}.{name[-3:]}"
            getattr(module, name)(RGB, str(path))
            assert path.stat().st_size > 0


def test_export_image_takes_a_qimage_as_jax_does(tmp_path):
    """_export_image reads a QImage by its methods (RGB888 and the
    BGRA of (A)RGB32) into the same PNG as JAX's."""
    import imageio

    class Bits(bytearray):
        def setsize(self, n):
            assert n == len(self)

    class QImage:
        """The methods of a QImage that _export_image reads."""

        def __init__(self, rgb, bpp, pad=4):
            h, w = rgb.shape[:2]
            px = rgb if bpp == 3 else np.concatenate(  # BGRA in memory
                [rgb[..., ::-1], np.full((h, w, 1), 255, np.uint8)], axis=2)
            rows = np.zeros((h, w * bpp + pad), np.uint8)
            rows[:, :w * bpp] = px.reshape(h, w * bpp)
            self._bits = Bits(rows.tobytes())
            self._shape = (h, w, bpp, w * bpp + pad)

        def constBits(self):
            return self._bits

        def sizeInBytes(self):
            return len(self._bits)

        def height(self):
            return self._shape[0]

        def width(self):
            return self._shape[1]

        def depth(self):
            return 8 * self._shape[2]

        def bytesPerLine(self):
            return self._shape[3]

    for bpp in (3, 4):
        image = QImage(RGB, bpp)
        for tag, module in (("t", trender), ("j", jrender)):
            module._export_image(image, str(tmp_path / f"{tag}{bpp}.png"))
        t = imageio.v3.imread(tmp_path / f"t{bpp}.png")
        np.testing.assert_array_equal(t, imageio.v3.imread(
            tmp_path / f"j{bpp}.png"))
        plain = tmp_path / f"plain{bpp}.png"
        trender._export_image(RGB, str(plain))
        np.testing.assert_array_equal(t, imageio.v3.imread(plain))


# ---------------------------------------------------------------------------
# scripted sessions (tests/test_render_app.py)
# ---------------------------------------------------------------------------


def test_workflow_session_matches_jax(monkeypatch, tmp_path):
    """pick -> undrift from the picked fiducial -> SMLM clusters, undo
    -> RESI -> save, on both apps."""
    p = Pair(monkeypatch, _make_channel(0))
    for app, locs in ((p.t, _rec(_make_channel(1, site_shift=0.15))),
                      (p.j, _make_channel(1, site_shift=0.15))):
        app.add_channel(locs, INFO)
    p.set(pick_diameter=3.0)
    p.both("add_pick", (6.0, 6.0))
    for ch in range(2):
        p.set(current_channel=ch)
        dt, dj = p.both("undrift_from_picked")
        for c in ("x", "y"):
            np.testing.assert_allclose(dt[c], dj[c].to_numpy(), rtol=0,
                                       atol=DRIFT_AGREE)
        _table_close(p.t.locs, p.j.locs, DRIFT_AGREE, f"undrifted {ch}")
    p.check()
    p.set(current_channel=0, picks=[])
    nt, nj = p.both("smlm_clusterer", radius_xy=0.25, min_locs=15)
    assert nt == nj == len(SITES) + 1
    _table_equal(p.t.locs, p.j.locs, "clustered")
    assert p.both("undo") == ("smlm cluster", "smlm cluster")
    assert "group" not in p.t.locs.dtype.names
    (it, ct), (ij, cj) = p.both("resi", radius_xy=0.25, min_locs=15)
    assert it == ij == 2
    compare_tables_ulps(ct, _rec(cj), CENTERS_ULPS, "RESI centres")
    assert p.t.channels[2].info == p.j.channels[2].info
    p.check()
    p.set(current_channel=2)
    for tag, app in (("t", p.t), ("j", p.j)):
        app.save_locs(str(tmp_path / f"{tag}_resi.hdf5"))
    saved_t, info_t = tio.load_locs(str(tmp_path / "t_resi.hdf5"))
    saved_j, info_j = jio.load_locs(str(tmp_path / "j_resi.hdf5"))
    compare_tables_ulps(saved_t, _rec(saved_j), CENTERS_ULPS, "saved RESI")
    assert info_t == info_j
    assert [m.replace("t_resi", "j_resi") for m in p.t.status.messages
            ] == p.j.status.messages


SHAPES = {
    "Circle": ({"pick_diameter": 2.0}, [(10.0, 10.0), (16.0, 22.0)]),
    "Square": ({"pick_side": 2.0}, [(10.0, 10.0), (22.0, 16.0)]),
    "Rectangle": ({"pick_width": 2.0}, [((9.0, 8.0), (11.0, 12.0)),
                                        ((16.0, 8.0), (16.0, 24.0))]),
    "Polygon": ({}, [[(8, 8), (12, 8), (12, 12), (8, 12)],
                     [(20.0, 20.0), (24.0, 21.0), (22.0, 25.0)]]),
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_pick_shape_session_matches_jax(monkeypatch, tmp_path, shape):
    """Picks of one shape: the picked tables, the saved pick file and the
    picked-locs file equal; loaded into a fresh app, the same picks."""
    sizes, picks = SHAPES[shape]
    p = Pair(monkeypatch, _make_channel(0))
    p.both("set_pick_shape", shape)
    p.set(**sizes)
    for pick in picks:
        p.both("add_pick", pick)
    pt, pj = p.both("picked_locs")
    assert len(pt) == len(pj) == 2 and len(pt[0]) > 0
    for a, b in zip(pt, pj):
        _rows_equal(a, b, f"{shape} picked")
    assert p.t.pick_info() == p.j.pick_info()
    files = {}
    for tag, app in (("t", p.t), ("j", p.j)):
        files[tag] = (tmp_path / f"{tag}.yaml", tmp_path / f"{tag}_p.hdf5")
        app.save_picks(str(files[tag][0]))
        assert app.save_picked_locs(str(files[tag][1])) > 0
    assert files["t"][0].read_bytes() == files["j"][0].read_bytes()
    lt, it = tio.load_locs(str(files["t"][1]))
    lj, ij = jio.load_locs(str(files["j"][1]))
    _rows_equal(lt, lj, "picked file")
    assert it == ij
    fresh = Pair(monkeypatch, _make_channel(0))
    fresh.both("load_picks", str(files["t"][0]))
    assert fresh.t.pick_shape == fresh.j.pick_shape == shape
    assert fresh.t.picks == fresh.j.picks
    assert [len(a) for a in fresh.t.picked_locs()] == [len(a) for a in pt]
    p.check()
    fresh.check()


def _recipe_polygon_clicks(p):
    p.both("set_pick_shape", "Polygon")
    for x, y in ((8, 8), (12, 8), (12, 12)):
        assert p.both("add_polygon_point", x, y) == (False, False)
    assert p.both("add_polygon_point", 8.05, 8.05) == (True, True)
    assert p.t.picks[0][0] == p.t.picks[0][-1]


def _recipe_pick_editing(p):
    p.set(pick_diameter=2.0)
    p.both("add_pick", (10, 10))
    p.both("add_pick", (20, 20))
    p.both("remove_closest_pick", 19, 19)
    assert p.t.picks == [(10.0, 10.0)]
    p.both("clear_picks")


def _recipe_filter_picks(p):
    p.set(pick_diameter=1.0)
    p.both("add_pick", (10, 10))
    p.both("add_pick", (28, 28))
    assert p.both("filter_picks", min_locs=5) == (1, 1)


def _recipe_keep_picks(p):
    for pick in [(6.0, 6.0), (16.0, 16.0), (22.0, 22.0)]:
        p.both("add_pick", pick)
    p.both("keep_picks", [0, 2])
    assert p.t.picks == [(6.0, 6.0), (22.0, 22.0)]


def _recipe_fiducials_and_move(p):
    assert p.both("pick_fiducials") == (1, 1)
    assert p.t.pick_diameter == p.j.pick_diameter
    p.both("move_to_pick", 0)


def _recipe_pick_similar(p):
    p.set(pick_diameter=3.0)
    p.both("add_pick", (6.0, 6.0))
    n = p.both("pick_similar")
    assert n[0] == n[1]


def _recipe_navigation(p):
    p.both("zoom_in")
    p.both("pan_right")
    p.both("pan_down")
    p.both("zoom", 0.5, center=(16.0, 16.0))
    p.both("pan_left")
    p.both("pan_up")
    p.both("zoom_out")
    assert p.t.oversampling == p.j.oversampling
    p.both("fit_in_view")


def _recipe_display(p):
    p.both("set_contrast", 0.0, 10.0)
    p.both("set_min_blur_width", 0.01)
    p.both("set_invert_colors", True)
    p.both("set_colormap", "viridis")
    p.both("set_contrast", None, None)
    p.both("set_oversampling", 4.0)
    p.both("set_scalebar", show=True, length_nm=500.0)
    p.both("set_minimap", True)
    p.both("set_legend", True)
    p.both("set_pixelsize", 108.0)
    assert p.t.info == p.j.info


def _recipe_fast_render(p):
    n_full = p.both("redraw")
    p.both("set_fast_render", 0.25, seed=1)
    n_fast = p.both("redraw")
    assert n_fast[0] == n_fast[1] < n_full[0] * 0.5
    p.both("set_fast_render", 1.0)


def _recipe_render_property(p):
    p.both("set_render_property", "frame", n_colors=8)
    p.both("set_render_property", "photons", n_colors=4, min_value=600.0,
           max_value=2500.0, colormap="magma")
    p.both("clear_render_property")


def _recipe_measure(p):
    p.both("set_tool", "measure")
    p.both("add_measure_point", 5.0, 5.0)
    p.both("add_measure_point", 8.0, 9.0)
    assert p.t.status.last == p.j.status.last
    p.both("clear_measure_points")


RECIPES = {name[len("_recipe_"):]: fn for name, fn in globals().items()
           if name.startswith("_recipe_")}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_view_recipe_matches_jax(monkeypatch, recipe):
    """Picks, navigation and display settings: the same picks, the
    same viewports and the same views after each step; the recipes take
    the blurs in turn."""
    blur = (None, "smooth", "gaussian", "convolve")[
        list(RECIPES).index(recipe) % 4]
    p = Pair(monkeypatch, _make_channel(0), blur_method=blur)
    RECIPES[recipe](p)
    p.check()
    assert p.t.status.messages == p.j.status.messages


def test_multichannel_composite_matches_jax(monkeypatch):
    p = Pair(monkeypatch, _make_channel(0), blur_method="gaussian")
    for app, locs in ((p.t, _rec(_make_channel(1))),
                      (p.j, _make_channel(1))):
        app.add_channel(locs, INFO, path="/data/ch1_locs.hdf5")
    p.both("set_channel_color", 0, (1.0, 0.0, 0.0))
    p.both("set_channel_color", 1, (0.0, 1.0, 0.0))
    p.both("set_channel_intensity", 1, 0.5)
    p.both("redraw")
    assert p.t.last_image[..., 0].max() > 0
    assert p.t.last_image[..., 1].max() > 0
    p.both("set_legend", True)
    assert ([t.get_text() for t in p.t.ax.texts]
            == [t.get_text() for t in p.j.ax.texts])
    p.both("set_channel_visible", 1, False)
    p.both("redraw")
    p.check()


def test_export_view_complete_and_slices_match_jax(monkeypatch, tmp_path):
    import imageio

    p = Pair(monkeypatch, _locs3d(), blur_method=None)
    p.set(dynamic_oversampling=False)
    for tag, app in (("t", p.t), ("j", p.j)):
        app.export_view(str(tmp_path / f"{tag}_view.png"))
        app.zoom_in()
        app.export_complete(str(tmp_path / f"{tag}_full.png"))
        app.start_slicer(thickness_nm=200.0)
        assert app.n_slices() == 4
        app.export_slices(str(tmp_path / f"{tag}_stack"))
        app.set_slice(2)
    for name in ("view.png", "full.png", *(f"stack_Z{i:03d}.png"
                                           for i in range(4))):
        np.testing.assert_array_equal(
            imageio.v3.imread(tmp_path / f"t_{name}"),
            imageio.v3.imread(tmp_path / f"j_{name}"))
    assert ((tmp_path / "t_view.yaml").read_text()
            == (tmp_path / "j_view.yaml").read_text())
    assert p.t.slice_range() == p.j.slice_range()
    counts = []
    for i in range(p.t.n_slices()):
        p.both("set_slice", i)
        counts.append(p.both("redraw"))
    assert [c[0] for c in counts] == [c[1] for c in counts]
    assert sum(c[0] for c in counts) == len(p.t.locs)
    p.both("next_slice")
    p.both("previous_slice")
    p.both("stop_slicer")
    p.check()


def test_slicer_and_rotation_window_need_z():
    locs = _rec(_make_channel(0))
    app = tgui.RenderApp(locs, INFO, **CPU)
    with pytest.raises(ValueError, match="z"):
        app.start_slicer()
    with pytest.raises(ValueError, match="z column"):
        app.open_rotation_window()
    with pytest.raises(AssertionError, match="rectangular"):
        app.plot_pick_profile()
    with pytest.raises(AssertionError):
        app.set_render_property("nope")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tgui.RenderApp(locs, INFO)


def test_info_frc_and_nena_match_jax(monkeypatch, tmp_path):
    rng = np.random.default_rng(3)
    sites = rng.uniform(4, 28, (60, 2))
    f = np.repeat(np.arange(N_FRAMES), 3)
    s = rng.integers(0, len(sites), len(f))
    locs = pd.DataFrame({
        "frame": f.astype(np.uint32),
        "x": (sites[s, 1] + rng.normal(0, 0.1, len(f))).astype(np.float32),
        "y": (sites[s, 0] + rng.normal(0, 0.1, len(f))).astype(np.float32),
        "lpx": np.full(len(f), 0.1, np.float32),
        "lpy": np.full(len(f), 0.1, np.float32),
    })
    p = Pair(monkeypatch, locs)
    assert p.t.show_info() == p.j.show_info()
    rt = p.t.calculate_frc(save_images=str(tmp_path / "t_frc.npy"))
    rj = p.j.calculate_frc(save_images=str(tmp_path / "j_frc.npy"))
    assert rt["resolution"] == pytest.approx(rj["resolution"], rel=1e-6)
    for half in ("half1", "half2"):
        np.testing.assert_allclose(np.load(tmp_path / f"t_frc_{half}.npy"),
                                   np.load(tmp_path / f"j_frc_{half}.npy"),
                                   rtol=1e-6, atol=1e-9)
    assert p.t.plot_frc().axes[0].get_title() == (
        p.j.plot_frc().axes[0].get_title())
    nt, nj = p.both("calculate_nena")
    assert nt["lp"] == pytest.approx(nj["lp"], rel=1e-6)


def test_mask_trace_and_kmeans_match_jax(monkeypatch):
    p = Pair(monkeypatch, _make_channel(0))
    (mt, it, ot), (mj, ij, oj) = p.both("mask_image", "otsu",
                                        disp_px_size=260.0, blur=520.0)
    np.testing.assert_array_equal(mt, mj)
    _rows_equal(it, ij, "in")
    _rows_equal(ot, oj, "out")
    n0 = len(p.t.locs)
    p.both("apply_mask", "otsu", keep="out", disp_px_size=260.0, blur=520.0)
    _rows_equal(p.t.locs, p.j.locs, "kept out")
    assert len(p.t.locs) < n0 and p.t.info == p.j.info
    p.both("undo")
    assert len(p.t.locs) == n0
    p.set(pick_diameter=3.0)
    p.both("add_pick", (6.0, 6.0))
    tt, tj = p.both("show_trace", 0)
    for k in ("frames", "photons", "x", "y"):
        np.testing.assert_array_equal(tt[k], np.asarray(tj[k]))
    np.testing.assert_array_equal(*p.both("pick_scatter", 0))
    kt, kj = p.both("cluster_in_pick_kmeans", 0, n_clusters=2)
    _table_equal(kt, kj, "k-means")
    p.check()


def test_combine_and_remove_locs_in_picks_match_jax(monkeypatch):
    p = Pair(monkeypatch, _one_a_frame_channel(5))
    p.set(pick_diameter=1.0)
    for sy, sx in SITES[:3]:
        p.both("add_pick", (sx, sy), redraw=False)
    p.both("combine_locs")
    _table_equal(p.t.locs, p.j.locs, "combined")
    assert len(p.t.locs) == 3 and p.t.info == p.j.info
    p.both("undo")
    p.both("remove_locs_in_picks")
    _table_equal(p.t.locs, p.j.locs, "removed in picks")
    assert p.t.info == p.j.info
    p.check()


def test_link_with_undo_matches_jax(monkeypatch):
    """Link, then undo: the port gets the rows in the order JAX's link
    sorts them (tests/test_torch_link.py), and the linked table equals
    JAX's bit for bit."""
    p = Pair(monkeypatch, _make_channel(0), port_rows=jax_order)
    n0 = len(p.t.locs)
    p.both("link", r_max=0.2, max_dark_time=2)
    _table_equal(p.t.locs, p.j.locs, "linked")
    assert len(p.t.locs) < n0 and p.t.info == p.j.info
    assert p.both("undo") == ("link", "link")
    assert len(p.t.locs) == n0
    p.check()


def test_postprocess_actions_match_jax(monkeypatch, tmp_path):
    """DBSCAN, HDBSCAN, remove columns, unfold, combine, remove locs in
    picks, nearest neighbours and a drift file."""
    p = Pair(monkeypatch, _make_channel(0))
    assert p.both("dbscan", radius=0.3, min_density=10)[0] >= len(SITES)
    _table_equal(p.t.locs, p.j.locs, "dbscan")
    p.both("remove_columns", ["bg"])
    _table_equal(p.t.locs, p.j.locs, "columns removed")
    grouped = p.j.locs
    p.t.unfold_groups_square(n_square=3)
    with pytest.raises(KeyError, match="Pixelsize"):
        p.j.unfold_groups_square(n_square=3)  # JAX stores (locs, info)
    want, info = jlib.unfold_localizations_square(
        grouped, [dict(d) for d in p.j.info[:-1]], n_square=3)
    _table_equal(p.t.locs, want, "unfolded")
    assert p.t.info[:-1] == info and p.t.info[-1] == {
        "Generated by": "picasso-tpu Render : Unfold square", "Side": 3}
    p.t.undo()
    p.j.channel.pop_undo()
    del p.images["t"][-2:]  # the port's redraws of the unfold and its undo
    p.both("undo")
    p.both("undo")
    nt, nj = p.both("hdbscan", 10, 10)
    assert nt == nj
    _table_equal(p.t.locs, p.j.locs, "hdbscan")
    p.both("undo")
    for tag, app, other in (("t", p.t, _rec(_make_channel(1))),
                            ("j", p.j, _make_channel(1))):
        app.add_channel(other, INFO)
    np.testing.assert_array_equal(*p.both("nearest_neighbor", 0, 1,
                                          nn_count=2))
    drift = pd.DataFrame({"x": np.linspace(0, 1, N_FRAMES),
                          "y": np.zeros(N_FRAMES)})
    path = tmp_path / "drift.txt"
    jio.save_drift(str(path), drift)
    p.set(current_channel=0)
    p.both("apply_drift_file", str(path))
    _table_equal(p.t.locs, p.j.locs, "drift file")
    for tag, app in (("t", p.t), ("j", p.j)):
        app.save_drift(str(tmp_path / f"{tag}_out.txt"))
        assert app.show_drift() is not None
    assert ((tmp_path / "t_out.txt").read_bytes()
            == (tmp_path / "j_out.txt").read_bytes())
    p.check()


def test_undrift_rcc_and_aim_match_jax(monkeypatch):
    p = Pair(monkeypatch, _make_channel(0))
    for name, kw in (("undrift_rcc", {"segmentation": 50}),
                     ("undrift_aim", {"segmentation": 50})):
        dt, dj = p.both(name, **kw)
        for c in dj.dtype.names if hasattr(dj, "dtype") and dj.dtype.names \
                else dj.columns:
            np.testing.assert_allclose(dt[c], np.asarray(dj[c]), rtol=0,
                                       atol=DRIFT_AGREE)
        _table_close(p.t.locs, p.j.locs, DRIFT_AGREE, name)
        assert p.t.info == p.j.info
        p.both("undo_drift")
        _table_equal(p.t.locs, p.j.locs, f"{name} undone")
        assert p.t.channel.drift is None
    p.check()


def test_pick_properties_profile_and_qpaint_match_jax(monkeypatch, tmp_path):
    p = Pair(monkeypatch, _one_a_frame_channel(8), blur_method=None)
    p.set(pick_diameter=1.5)
    for sy, sx in SITES[:3]:
        p.both("add_pick", (sx, sy), redraw=False)
    st, sj = p.both("calculate_pick_info")
    assert st.keys() == sj.keys()
    for k in st:
        assert st[k] == pytest.approx(sj[k], rel=1e-6, nan_ok=True), k
    assert p.both("calibrate_influx", units_per_pick=1.0)[0] == (
        pytest.approx(p.j.influx_rate, rel=1e-6))
    assert p.t.n_units() == pytest.approx(p.j.n_units(), rel=1e-6)
    props = {}
    for tag, app in (("t", p.t), ("j", p.j)):
        props[tag] = app.save_pick_properties(str(tmp_path / f"{tag}.hdf5"))
    compare_tables_ulps(props["t"], _rec(props["j"]), CENTERS_ULPS,
                        "pick properties")
    assert ((tmp_path / "t.yaml").read_text()
            == (tmp_path / "j.yaml").read_text())
    p.both("set_pick_shape", "Rectangle")
    p.set(pick_width=4.0)
    p.both("add_pick", ((16.0, 8.0), (16.0, 24.0)))
    rt, rj = p.both("plot_pick_profile", bin_width_nm=130.0)
    np.testing.assert_array_equal(rt["bin_edges"], rj["bin_edges"])
    for a, b in zip(rt["counts"] + rt["profiles"],
                    rj["counts"] + rj["profiles"]):
        np.testing.assert_array_equal(a, b)
    for tag, app in (("t", p.t), ("j", p.j)):
        app.export_profile(str(tmp_path / f"{tag}_profile.csv"))
    assert ((tmp_path / "t_profile.csv").read_bytes()
            == (tmp_path / "j_profile.csv").read_bytes())
    p.check()


def test_expressions_with_undo_match_jax(monkeypatch):
    """View > Apply expression: a shift, flip x y, flip x z (3D), spiral
    and uspiral, python over the columns, each undone in turn; tables
    and dtypes equal to JAX's after every step."""
    locs = _make_channel(seed=4)
    locs["z"] = np.linspace(-200, 200, len(locs)).astype(np.float32)
    p = Pair(monkeypatch, locs, blur_method=None)
    p.set(dynamic_oversampling=False)
    msgs = {"t": [], "j": []}
    p.t.status.callback, p.j.status.callback = (msgs["t"].append,
                                                msgs["j"].append)
    p.both("apply_expression", "uspiral")
    cmds = ["x += 2", "flip x y", "flip x z", "flip z y", "spiral 2 3",
            "uspiral", "photons = photons * 2 + frame",
            "x[x > 20] = 20.5; y = y - 0.25"]
    for cmd in cmds:
        p.both("apply_expression", cmd)
        _table_equal(p.t.locs, p.j.locs, cmd)
    for cmd in reversed(cmds):
        assert p.both("undo") == (f"expression: {cmd}",) * 2
        _table_equal(p.t.locs, p.j.locs, f"undo {cmd}")
    _table_equal(p.t.locs, locs, "all undone")
    assert msgs["t"] == msgs["j"]
    p.check()


def test_save_pick_and_export_formats_match_jax(monkeypatch, tmp_path):
    locs = _make_channel(seed=7)
    locs["z"] = np.zeros(len(locs), np.float32)
    p = Pair(monkeypatch, locs, blur_method=None)
    for fmt, ext in (("imagej", ".txt"), ("nis", ".txt"),
                     ("chimera", ".xyz"), ("visp", ".3d"),
                     ("thunderstorm", ".csv")):
        for tag, app in (("t", p.t), ("j", p.j)):
            app.export_locs(str(tmp_path / f"{tag}{fmt}{ext}"), fmt)
        assert ((tmp_path / f"t{fmt}{ext}").read_bytes()
                == (tmp_path / f"j{fmt}{ext}").read_bytes()), fmt
    with pytest.raises(AssertionError, match="Unknown export"):
        p.t.export_locs(str(tmp_path / "x.bin"), "bin")
    p.set(oversampling=4.0, dynamic_oversampling=False)
    st, sj = p.both("export_roi_imaris", str(tmp_path / "fov.ims"))
    np.testing.assert_array_equal(st, sj)
    rotated = list(INFO) + [{"Generated by": "Picasso Render : Rotate",
                             "Pick": (16.0, 16.0), "Pick shape": "Circle",
                             "Pick size (nm)": 2.0}]
    jio.save_locs(str(tmp_path / "rot_locs.hdf5"), locs, rotated)
    assert p.both("open_rotated_locs", str(tmp_path / "rot_locs.hdf5")) == (
        1, 1)
    assert p.t.pick_diameter == p.j.pick_diameter == 2.0
    _table_equal(p.t.channels[1].locs, p.j.channels[1].locs, "opened")
    p.check()


def test_rotation_and_filter_windows_from_the_app(monkeypatch):
    p = Pair(monkeypatch, _locs3d(), blur_method=None)
    p.set(dynamic_oversampling=False, pick_diameter=6.0)
    p.both("add_pick", (16.0, 16.0))
    rt, rj = p.both("open_rotation_window", 0)
    assert rt.device == "cpu"
    _table_equal(rt.locs, rj.locs, "rotation window")
    assert rt.redraw() == rj.redraw() == len(rt.locs)
    ft, fj = p.both("open_filter_window")
    assert ft.device == "cpu"
    assert ft.apply_filter("photons", 1000, 2000) == fj.apply_filter(
        "photons", 1000, 2000)
    gt, gj = p.both("test_clustering", 0, "dbscan", radius=0.3,
                    min_density=4)
    _table_equal(gt, gj, "test clustering")


def test_plugin_actions_and_close():
    app = tgui.RenderApp(_rec(_make_channel(0)), INFO, **CPU)
    hits = []
    app.add_plugin_action("count", lambda: hits.append(1))
    app._on_plugin_key(KeyEvent("key_press_event", app.fig.canvas, "f1"))
    app.run_plugin_action("count")
    assert hits == [1, 1] and app.plugins == []
    panel = app.open_display_settings()
    assert isinstance(panel, tpanels.DisplaySettingsPanel)
    app.close()
    assert app.fig is None and not plt.fignum_exists(panel.fig.number)
