"""The port's render-window panels (picasso_torch.gui.panels) beside
picasso_tpu's, on the Agg backend with device="cpu": each recipe of
tests/test_gui_panels.py drives a panel of the port's RenderApp and a
panel of JAX's with the same widget actions. The panels that run
analyses (undrift, clustering, mask, expressions, link) are in
tests/test_torch_gui_panels_actions.py.

What is held, and how closely (tests/test_torch_render_gui.py's Pair):
- the app state each panel sets (blur, colormap, contrast, oversampling,
  scale bar, minimap, legend, pixel size, channels' colour, visibility
  and intensity, pick shape and size, slicer, fast render, viewport,
  render property) equal to JAX's, and the widgets' text and values;
- every view the panels cause: the float image within RENDER_AGREE of
  JAX's (equal for blur None), ``last_image`` within one level;
- the fast render's subsample equal; the slicer's exported PNGs equal;
  NeNA and FRC within 1e-6 relative; the panels' texts equal.
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

from picasso_torch import lib as tlib  # noqa: E402
from tests.test_torch_render_gui import (  # noqa: E402
    Pair, _rec, _table_equal,
)

INFO = [{"Frames": 100, "Height": 32, "Width": 32, "Pixelsize": 130}]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    plt.close("all")


def _locs(n=2000, seed=0):
    """tests/test_gui_panels.py's locs."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "frame": rng.integers(0, 100, n).astype(np.uint32),
        "x": rng.uniform(4, 28, n).astype(np.float32),
        "y": rng.uniform(4, 28, n).astype(np.float32),
        "photons": rng.uniform(500, 3000, n).astype(np.float32),
        "sx": np.full(n, 1.1, np.float32),
        "sy": np.full(n, 1.0, np.float32),
        "bg": np.full(n, 10, np.float32),
        "lpx": np.full(n, 0.05, np.float32),
        "lpy": np.full(n, 0.05, np.float32),
        "net_gradient": rng.uniform(5e3, 5e4, n).astype(np.float32),
    })


def _locs_3d(n=3000, seed=3):
    locs = _locs(n, seed)
    locs["z"] = np.random.default_rng(seed + 1).uniform(
        -200, 200, n).astype(np.float32)
    return locs


APP_STATE = ("blur_method", "colormap", "contrast", "oversampling",
             "dynamic_oversampling", "invert_colors", "min_blur_width",
             "pick_shape", "pick_diameter", "pick_width", "pick_side",
             "picks", "viewport", "slicer_on", "slice_thickness",
             "slice_position", "fast_render_fraction", "current_channel")
OPTIONAL_STATE = ("show_minimap", "show_scalebar", "scalebar_length_nm",
                  "scalebar_text", "show_legend", "render_property",
                  "annotate_picks")


def _same_state(p):
    for name in APP_STATE:
        assert getattr(p.t, name) == getattr(p.j, name), name
    for name in OPTIONAL_STATE:
        assert getattr(p.t, name, None) == getattr(p.j, name, None), name
    assert p.t.info == p.j.info
    for ct, cj in zip(p.t.channels, p.j.channels, strict=True):
        assert (ct.color, ct.visible, ct.relative_intensity) == (
            cj.color, cj.visible, cj.relative_intensity)


def _same_widgets(pt, pj):
    """The TextBoxes, sliders, radio buttons and check boxes of two
    panels show the same values."""
    from matplotlib.widgets import CheckButtons, RadioButtons, Slider, TextBox

    for name, wt in vars(pt).items():
        wj = getattr(pj, name, None)
        if isinstance(wt, TextBox):
            assert wt.text == wj.text, name
        elif isinstance(wt, Slider):
            assert wt.val == pytest.approx(wj.val), name
        elif isinstance(wt, RadioButtons):
            assert wt.value_selected == wj.value_selected, name
        elif isinstance(wt, CheckButtons):
            assert wt.get_status() == wj.get_status(), name


def _pair(monkeypatch, locs=None, **kw):
    return Pair(monkeypatch, _locs() if locs is None else locs,
                info=INFO, **kw)


def _panels(p, opener, **kw):
    return getattr(p.t, opener)(**kw), getattr(p.j, opener)(**kw)


def _on_both(panels, fn):
    return [fn(panel) for panel in panels]


# ---------------------------------------------------------------------------
# DisplaySettingsPanel
# ---------------------------------------------------------------------------


def _blur(panel):
    panel.blur.set_active(2)
    panel.blur.set_active(0)
    panel.blur.set_active(3)


def _colormap(panel):
    labels = [t.get_text() for t in panel.colormap.labels]
    panel.colormap.set_active(labels.index("viridis"))


def _contrast(panel):
    panel.min_density.set_val("0.5")
    panel.max_density.set_val("12")
    panel.min_density.set_val("")
    panel.max_density.set_val("")
    panel.max_density.set_val("3")


def _oversampling(panel):
    panel.oversampling.set_val(4.0)


def _general(panel):
    panel.general_checks.set_active(2)
    panel.general_checks.set_active(1)
    panel.general_checks.set_active(0)


def _scalebar(panel):
    panel.scalebar_length.set_val("500")
    panel.scalebar_checks.set_active(0)
    panel.scalebar_checks.set_active(1)
    panel.scalebar_checks.set_active(2)
    panel.scalebar_length.set_val("250")


def _camera(panel):
    panel.pixelsize.set_val("108")
    panel.min_blur.set_val("0.8")
    panel.min_blur.set_val("junk")


def _property(panel):
    panel.prop_parameter.set_val("photons")
    panel.prop_colors.set_val("8")
    panel.prop_min.set_val("600")
    panel.apply_render_property()
    panel.prop_parameter.set_val("")
    panel.apply_render_property()


DISPLAY = {f.__name__[1:]: f for f in (_blur, _colormap, _contrast,
                                       _oversampling, _general, _scalebar,
                                       _camera, _property)}


@pytest.mark.parametrize("recipe", list(DISPLAY))
def test_display_settings_panel_matches_jax(monkeypatch, recipe):
    p = _pair(monkeypatch)
    panels = _panels(p, "open_display_settings")
    _on_both(panels, DISPLAY[recipe])
    _same_state(p)
    _same_widgets(*panels)
    if recipe == "camera":
        assert tlib.get_from_metadata(p.t.info, "Pixelsize") == 108.0
    p.check()


def test_display_settings_sync_matches_jax(monkeypatch):
    p = _pair(monkeypatch)
    panels = _panels(p, "open_display_settings")
    p.both("set_blur", "convolve")
    p.both("set_colormap", "gray")
    p.both("set_contrast", 1.0, 9.0)
    p.both("set_scalebar", show=True, length_nm=250.0)
    p.both("set_invert_colors", True)
    _on_both(panels, lambda panel: panel.sync())
    _same_widgets(*panels)
    assert panels[0].blur.value_selected == "convolve"
    assert panels[0].max_density.text == "9.0"
    assert p.t.contrast == (1.0, 9.0) and p.t.blur_method == "convolve"
    _same_state(p)
    p.check()


def test_custom_colormap_matches_jax(monkeypatch):
    p = _pair(monkeypatch)
    ct, cj = p.both("register_colormap", "portfire",
                    ["black", "red", "yellow", "white"])
    assert p.t.colormap == "portfire"
    np.testing.assert_array_equal(ct(np.linspace(0, 1, 9)),
                                  cj(np.linspace(0, 1, 9)))
    p.both("register_colormap", "portcool", [(0, 0, 0), (0, 1, 1)],
           set_active=False)
    assert p.t.colormap == "portfire"
    panels = _panels(p, "open_display_settings")
    assert ([t.get_text() for t in panels[0].colormap.labels]
            == [t.get_text() for t in panels[1].colormap.labels])
    p.check()


# ---------------------------------------------------------------------------
# ChannelsPanel, InfoPanel, ToolsSettingsPanel
# ---------------------------------------------------------------------------


def test_channels_panel_matches_jax(monkeypatch):
    p = _pair(monkeypatch)
    p.t.add_channel(_rec(_locs(seed=1)), [dict(d) for d in INFO])
    p.j.add_channel(_locs(seed=1), [dict(d) for d in INFO])
    panels = _panels(p, "open_channels_panel")
    assert len(panels[0].intensity_sliders) == 2
    for panel in panels:
        panel.visible_checks.set_active(1)
        panel.intensity_sliders[0].set_val(1.5)
        panel.cycle_color(0)
        panel.cycle_color(0)
        panel.legend_check.set_active(0)
        panel.visible_checks.set_active(1)
    assert p.t.channels[0].color == (0, 1, 0)
    _same_state(p)
    for app, locs in ((p.t, _rec(_locs(seed=2))), (p.j, _locs(seed=2))):
        app.add_channel(locs, [dict(d) for d in INFO])
    _on_both(panels, lambda panel: panel.rebuild())
    assert len(panels[0].intensity_sliders) == 3
    _same_widgets(*panels)
    p.check()


@pytest.mark.parametrize("action", ["refresh", "nena", "frc"])
def test_info_panel_matches_jax(monkeypatch, action):
    p = _pair(monkeypatch)
    p.set(pick_diameter=2.0)
    p.both("add_pick", (16.0, 16.0))
    panels = _panels(p, "open_info_panel")
    if action == "refresh":
        assert panels[0].refresh() == panels[1].refresh()
    elif action == "nena":
        rt, rj = _on_both(panels, lambda panel: panel.run_nena())
        assert rt["lp"] == pytest.approx(rj["lp"], rel=1e-6)
    else:
        rt, rj = _on_both(panels, lambda panel: panel.run_frc())
        assert rt["resolution"] == pytest.approx(rj["resolution"],
                                                 rel=1e-6)
    text_t, text_j = (panel._text.get_text() for panel in panels)
    if action == "refresh":
        assert text_t == text_j
    else:  # the last line holds the measured value
        assert text_t.splitlines()[:-1] == text_j.splitlines()[:-1]
        assert text_t.splitlines()[-1].split(":")[0] == (
            text_j.splitlines()[-1].split(":")[0])
    p.check()


def _shape_and_size(panel):
    panel.shape.set_active(1)
    panel.size.set_val("2.5")
    panel.shape.set_active(0)
    panel.size.set_val("3.0")
    panel.shape.set_active(3)
    panel.size.set_val("-1")
    panel.size.set_val("junk")
    panel.size.set_val("1.75")
    panel.shape.set_active(2)
    panel.size.set_val("4")


def _annotate(panel):
    panel.app.add_pick((10.0, 10.0))
    panel.annotate.set_active(0)


def _similar(panel):
    panel.app.pick_diameter = 3.0
    for pick in ((10.0, 10.0), (16.0, 16.0), (22.0, 22.0)):
        panel.app.add_pick(pick)
    panel.std_range.set_val("3.0")
    assert panel.run_pick_similar() == len(panel.app.picks)
    panel.app.clear_picks()
    panel.sync()


TOOLS = {f.__name__[1:]: f for f in (_shape_and_size, _annotate, _similar)}


@pytest.mark.parametrize("recipe", list(TOOLS))
def test_tools_settings_panel_matches_jax(monkeypatch, recipe):
    p = _pair(monkeypatch)
    panels = _panels(p, "open_tools_settings")
    _on_both(panels, TOOLS[recipe])
    _same_state(p)
    _same_widgets(*panels)
    assert panels[0]._size_note.get_text() == panels[1]._size_note.get_text()
    assert panels[0]._status.get_text() == panels[1]._status.get_text()
    if recipe == "annotate":
        assert ([t.get_text() for t in p.t.ax.texts]
                == [t.get_text() for t in p.j.ax.texts] == ["0"])
    p.check()


# ---------------------------------------------------------------------------
# SlicerPanel, FastRenderPanel, ChangeFOVPanel, PicksPanel
# ---------------------------------------------------------------------------


def _slider(panel):
    panel.position.set_val(1)
    panel._set_slice(0)
    panel._set_slice(panel.app.slice_position + 1)
    panel._set_slice(panel.app.slice_position - 1)


def _thickness(panel):
    panel.thickness.set_val("50")
    assert panel.position.valmax == max(panel.app.n_slices() - 1, 1)
    panel.position.set_val(3)
    panel.thickness.set_val("-4")


def _stop(panel):
    panel._set_slice(2)
    panel.app.stop_slicer()


SLICER = {f.__name__[1:]: f for f in (_slider, _thickness, _stop)}


@pytest.mark.parametrize("recipe", list(SLICER))
def test_slicer_panel_matches_jax(monkeypatch, recipe):
    p = _pair(monkeypatch, _locs_3d())
    panels = _panels(p, "open_slicer_panel", thickness_nm=100.0)
    assert p.t.slicer_on and p.t.n_slices() == p.j.n_slices()
    _on_both(panels, SLICER[recipe])
    _same_state(p)
    _same_widgets(*panels)
    assert (panels[0]._range_text.get_text()
            == panels[1]._range_text.get_text())
    assert p.t.slice_range() == p.j.slice_range()
    p.check()


def test_slicer_panel_export_and_needs_z(monkeypatch, tmp_path):
    import imageio

    p = _pair(monkeypatch, _locs_3d(), blur_method=None)
    panels = _panels(p, "open_slicer_panel", thickness_nm=200.0)
    paths = [panel.export_stack(str(tmp_path / f"{tag}_stack"))
             for panel, tag in zip(panels, "tj")]
    assert len(paths[0]) == len(paths[1]) == p.t.n_slices()
    for a, b in zip(*paths):
        np.testing.assert_array_equal(imageio.v3.imread(a),
                                      imageio.v3.imread(b))
    flat = _pair(monkeypatch)
    for app in (flat.t, flat.j):
        with pytest.raises(ValueError, match="z"):
            app.open_slicer_panel()
    p.check()


def test_fast_render_panel_matches_jax(monkeypatch):
    p = _pair(monkeypatch)
    panels = _panels(p, "open_fast_render_panel")
    for panel in panels:
        panel.fraction.set_val(0.25)
    assert len(p.t._fast_render_masks) == len(p.t.channels)
    shown = [app._visible_locs() for app in (p.t, p.j)]
    _table_equal(*shown, "fast render")
    assert 0 < len(shown[0]) < len(p.t.locs)
    _on_both(panels, lambda panel: panel._reset())
    assert p.t.fast_render_fraction == 1.0
    _same_state(p)
    _same_widgets(*panels)
    p.check()


def test_change_fov_panel_matches_jax(monkeypatch):
    p = _pair(monkeypatch)
    panels = _panels(p, "open_fov_panel")
    for panel in panels:
        panel.x.set_val("4")
        panel.y.set_val("6")
        panel.w.set_val("10")
        panel.h.set_val("8")
        panel.apply()
    assert p.t.viewport == ((6.0, 4.0), (14.0, 14.0))
    for panel in panels:
        panel.w.set_val("-5")
        panel.apply()
        panel._full()
    _same_state(p)
    _same_widgets(*panels)
    p.check()


def test_picks_panel_matches_jax(monkeypatch):
    p = _pair(monkeypatch)
    p.set(pick_diameter=3.0)
    for pick in ((8.0, 8.0), (16.0, 16.0), (24.0, 24.0)):
        p.both("add_pick", pick)
    panels = _panels(p, "open_picks_panel")
    for delta in (1, -1, -1, 1, 1):
        _on_both(panels, lambda panel: panel.step(delta))
        assert panels[0].current == panels[1].current
        assert panels[0]._label.get_text() == panels[1]._label.get_text()
        _same_state(p)
    assert _on_both(panels, lambda panel: panel.apply_filter()) == [3, 3]
    for panel in panels:
        panel.min_locs.set_val("20")
        panel.max_locs.set_val("60")
    nt, nj = _on_both(panels, lambda panel: panel.apply_filter())
    assert nt == nj
    assert panels[0]._status.get_text() == panels[1]._status.get_text()
    _on_both(panels, lambda panel: panel._clear())
    assert "no picks" in panels[0]._label.get_text()
    _same_state(p)
    p.check()
