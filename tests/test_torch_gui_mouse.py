"""Mouse-driven sessions of the port's render window beside JAX's, on the
Agg backend with device="cpu": every gesture of
tests/test_gui_interactive.py (drag-drawn picks of the four shapes,
rubber-band and wheel zoom, middle-drag pan, ctrl-drag contrast, measure
clicks, the panel keys) synthesized as matplotlib events on both apps.

What is held, and how closely (tests/test_torch_render_gui.py's Pair):
every gesture's viewport, picks, pick sizes, contrast and status lines
equal to JAX's; the views within RENDER_AGREE (equal for blur None); the
panels the ctrl keys open of the same classes, bound to the port's app;
the mouse session's locs within 1e-4 px of the scripted session's (as
JAX's own test holds them) and its viewport's size and centre equal,
the scripted session's locs within DRIFT_AGREE (1e-5 px) of JAX's.
Every figure is closed after each test.
"""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.backend_bases import KeyEvent, MouseEvent  # noqa: E402

from picasso_torch import gui as tgui  # noqa: E402
from picasso_torch.gui import panels as tpanels  # noqa: E402
from picasso_tpu import gui as jgui  # noqa: E402
from tests.test_render_app import INFO, _make_channel  # noqa: E402
from tests.test_torch_render_gui import (  # noqa: E402
    CPU, DRIFT_AGREE, Pair, _rec, _table_close,
)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    plt.close("all")


def _mouse(app, name, x, y, button=1, key=None, dy_pix=0.0):
    xp, yp = app.ax.transData.transform((x, y))
    ev = MouseEvent(name, app.fig.canvas, xp, yp + dy_pix, button=button,
                    key=key, step=1 if button == "up" else -1)
    app.fig.canvas.callbacks.process(name, ev)


def _drag(app, x0, y0, x1, y1, button=1, key=None):
    _mouse(app, "button_press_event", x0, y0, button, key)
    for t in np.linspace(0.2, 1.0, 3):
        _mouse(app, "motion_notify_event", x0 + (x1 - x0) * t,
               y0 + (y1 - y0) * t, button, key)
    _mouse(app, "button_release_event", x1, y1, button, key)


def _click(app, x, y, button=1, key=None):
    _mouse(app, "button_press_event", x, y, button, key)
    _mouse(app, "button_release_event", x, y, button, key)


def _key(app, k):
    app.fig.canvas.callbacks.process(
        "key_press_event", KeyEvent("key_press_event", app.fig.canvas, k))


GESTURES = {
    "wheel": lambda a: (_mouse(a, "scroll_event", 10.0, 12.0, "up"),
                        _mouse(a, "scroll_event", 10.0, 12.0, "down")),
    "rubber band": lambda a: _drag(a, 6.0, 8.0, 20.0, 24.0),
    "middle pan": lambda a: _drag(a, 20.0, 20.0, 15.0, 18.0, button=2),
    "circle": lambda a: (a.set_tool("pick"), _drag(a, 6.0, 6.0, 6.0, 7.5),
                         _click(a, 10.0, 16.0)),
    "square": lambda a: (a.set_tool("pick"), a.set_pick_shape("Square"),
                         _drag(a, 16.0, 16.0, 17.2, 16.4)),
    "rectangle": lambda a: (a.set_tool("pick"),
                            a.set_pick_shape("Rectangle"),
                            _drag(a, 5.0, 5.0, 15.0, 9.0),
                            _click(a, 20.0, 20.0), _click(a, 25.0, 22.0)),
    "polygon": lambda a: (a.set_tool("pick"), a.set_pick_shape("Polygon"),
                          *(_click(a, float(x), float(y)) for x, y in
                            ((5, 5), (15, 5), (15, 15), (5, 15))),
                          _click(a, 5.05, 5.05)),
    "alt and right": lambda a: (a.set_tool("pick"), a.add_pick((6.0, 6.0)),
                                a.add_pick((20.0, 20.0)),
                                _click(a, 6.2, 6.2, key="alt"),
                                _click(a, 16.0, 10.0, button=3),
                                _click(a, 16.0, 10.0, button=3, key="alt")),
    "contrast": lambda a: (
        _mouse(a, "button_press_event", 10.0, 10.0, key="control"),
        _mouse(a, "motion_notify_event", 10.0, 10.0, key="control",
               dy_pix=200.0),
        _mouse(a, "button_release_event", 10.0, 10.0, key="control")),
    "keys": lambda a: [_key(a, k) for k in ("+", "left", "down", "-", "w",
                                            "up", "right")],
}


@pytest.mark.parametrize("gesture", list(GESTURES))
def test_mouse_gesture_matches_jax(monkeypatch, gesture):
    p = Pair(monkeypatch, _make_channel(0), blur_method=None)
    p.set(dynamic_oversampling=False)
    msgs = {"t": [], "j": []}
    p.t.status.callback, p.j.status.callback = (msgs["t"].append,
                                                msgs["j"].append)
    for app in (p.t, p.j):
        GESTURES[gesture](app)
    assert p.t.contrast == p.j.contrast
    assert p.t.pick_diameter == p.j.pick_diameter
    assert p.t.pick_side == p.j.pick_side
    assert p.t._rubber is None and p.j._rubber is None
    assert msgs["t"] == msgs["j"]
    p.check()


def test_measure_and_panel_keys_match_jax(monkeypatch):
    p = Pair(monkeypatch, _make_channel(0), blur_method=None)
    for app in (p.t, p.j):
        app.set_tool("measure")
        _click(app, 5.0, 5.0)
        _click(app, 8.0, 9.0)
    assert p.t.measure_points == p.j.measure_points
    assert p.t.status.last == p.j.status.last and "5.000 px" in (
        p.t.status.last)
    for k, attr in (("ctrl+d", "display_settings"),
                    ("ctrl+f", "channels_panel"), ("ctrl+i", "info_panel"),
                    ("ctrl+t", "tools_settings"), ("ctrl+m", "mask_panel"),
                    ("ctrl+u", "undrift_panel"), ("ctrl+k", "cluster_panel"),
                    ("ctrl+a", "apply_panel"), ("ctrl+l", "link_panel"),
                    ("ctrl+g", "fov_panel"), ("ctrl+p", "picks_panel")):
        _key(p.t, k)
        _key(p.j, k)
        panel = getattr(p.t, attr)
        assert type(panel).__name__ == type(getattr(p.j, attr)).__name__
        assert isinstance(panel, getattr(tpanels, type(panel).__name__))
        assert panel.app is p.t
        panel.close()
        getattr(p.j, attr).close()
    p.check()


def test_mouse_session_matches_the_scripted_session(monkeypatch):
    """The scripted pick/undrift/zoom chain and the same chain by mouse
    events, on the port: equal locs and viewports; both equal to JAX's
    scripted chain."""
    locs = _make_channel(seed=0)
    s = tgui.RenderApp(_rec(locs), list(INFO), blur_method=None, **CPU)
    s.dynamic_oversampling = False
    s.pick_diameter = 2.0
    s.add_pick((6.0, 6.0))
    s.undrift_from_picked()
    s.zoom(0.8, center=(16.0, 16.0))
    a = tgui.RenderApp(_rec(locs), list(INFO), blur_method=None, **CPU)
    a.dynamic_oversampling = False
    a.set_tool("pick")
    _drag(a, 6.0, 6.0, 6.0, 7.0)
    assert a.pick_diameter == pytest.approx(2.0, rel=0.05)
    a.undrift_from_picked()
    _mouse(a, "scroll_event", 16.0, 16.0, "up")
    np.testing.assert_allclose(a.locs["x"], s.locs["x"], atol=1e-4)
    np.testing.assert_allclose(a.locs["y"], s.locs["y"], atol=1e-4)
    (ay0, ax0), (ay1, ax1) = a.viewport
    (sy0, sx0), (sy1, sx1) = s.viewport
    assert (ax1 - ax0) == pytest.approx(sx1 - sx0)
    assert (ax0 + ax1) / 2 == pytest.approx((sx0 + sx1) / 2)
    j = jgui.RenderApp(locs.copy(), list(INFO), blur_method=None)
    j.dynamic_oversampling = False
    j.pick_diameter = 2.0
    j.add_pick((6.0, 6.0))
    j.undrift_from_picked()
    j.zoom(0.8, center=(16.0, 16.0))
    _table_close(s.locs, j.locs, DRIFT_AGREE, "scripted")
    assert s.viewport == j.viewport
