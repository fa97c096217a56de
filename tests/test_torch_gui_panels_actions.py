"""The port's analysis panels beside picasso_tpu's, on the Agg backend
with device="cpu": UndriftPanel, ClusterPanel, MaskPanel, ApplyPanel and
LinkPanel, each recipe of tests/test_gui_panels.py driving a panel of
the port's RenderApp and one of JAX's with the same widget actions.

What is held, and how closely (tests/test_torch_render_gui.py's Pair):
- drifts and the undrifted locs within DRIFT_AGREE (1e-5 px), and the
  drift curves drawn in the panel;
- cluster labels, masks, the masked tables (as sets of rows, as
  tests/test_torch_masking.py holds mask_locs), expression and linked
  tables equal, after each undo too; the panels' status lines and
  histories equal;
- every view within RENDER_AGREE of JAX's (equal for blur None);
- the panels' deliberate faults are JAX's: UndriftPanel's shared
  segmentation of 200, its undo raising without a drift, ApplyPanel's
  history popped on any undo.
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

from picasso_torch.gui import panels as tpanels  # noqa: E402
from picasso_tpu.gui import panels as jpanels  # noqa: E402
from tests.test_torch_gui_panels import (  # noqa: E402
    _locs, _on_both, _pair, _panels,
)
from tests.test_torch_link import jax_order  # noqa: E402
from tests.test_torch_render_gui import (  # noqa: E402
    DRIFT_AGREE, Pair, _rec, _rows_equal, _table_close, _table_equal,
)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    plt.close("all")


def _drift_close(dt, dj):
    for name in dj.columns if hasattr(dj, "columns") else dj.dtype.names:
        np.testing.assert_allclose(dt[name], np.asarray(dj[name]), rtol=0,
                                   atol=DRIFT_AGREE)


@pytest.mark.parametrize("method", ["rcc", "aim"])
def test_undrift_panel_matches_jax(monkeypatch, method):
    p = _pair(monkeypatch)
    panels = _panels(p, "open_undrift_panel")
    assert panels[0].segmentation.text == "200"  # JAX's shared default
    for panel in panels:
        panel.segmentation.set_val("20")
    run = {"rcc": lambda panel: panel.run_rcc(),
           "aim": lambda panel: panel.run_aim()}[method]
    _drift_close(*_on_both(panels, run))
    _table_close(p.t.locs, p.j.locs, DRIFT_AGREE, method)
    assert panels[0]._status.get_text() == panels[1]._status.get_text()
    lines = [[np.asarray(ln.get_ydata()) for ln in panel.drift_ax.lines]
             for panel in panels]
    assert len(lines[0]) == len(lines[1]) == 2
    for a, b in zip(*lines):
        np.testing.assert_allclose(a, b, rtol=0, atol=DRIFT_AGREE)
    _on_both(panels, lambda panel: panel._undo())
    assert p.t.channel.drift is None and not panels[0].drift_ax.lines
    _table_equal(p.t.locs, p.j.locs, "undone")
    for panel in panels:  # JAX's fault kept: no drift, no undo
        with pytest.raises(ValueError, match="No drift"):
            panel._undo()
    p.check()


def test_undrift_panel_from_picked_matches_jax(monkeypatch):
    from tests.test_render_app import _make_channel

    p = Pair(monkeypatch, _make_channel(0))
    p.set(pick_diameter=3.0)
    p.both("add_pick", (6.0, 6.0))
    panels = _panels(p, "open_undrift_panel")
    _drift_close(*_on_both(panels, lambda panel: panel.run_from_picked()))
    assert panels[0]._status.get_text() == panels[1]._status.get_text()
    _table_close(p.t.locs, p.j.locs, DRIFT_AGREE, "from picked")
    _on_both(panels, lambda panel: panel.sync())
    p.check()


@pytest.mark.parametrize("algo", [
    (0, {"radius_xy": "0.5", "min_locs": "2"}),
    (1, {"radius": "0.5", "min_density": "2"}),
    (2, {"min_cluster": "3", "min_samples": "3"}),
], ids=["smlm", "dbscan", "hdbscan"])
def test_cluster_panel_matches_jax(monkeypatch, algo):
    index, fields = algo
    p = _pair(monkeypatch)
    panels = _panels(p, "open_cluster_panel")
    for panel in panels:
        panel.algo.set_active(index)
        for name, text in fields.items():
            getattr(panel, name).set_val(text)
    nt, nj = _on_both(panels, lambda panel: panel.run())
    assert nt == nj >= 1
    _table_equal(p.t.locs, p.j.locs, "clustered")
    assert p.t.info == p.j.info
    assert panels[0]._status.get_text() == panels[1]._status.get_text()
    _on_both(panels, lambda panel: panel._undo())
    assert panels[0]._status.get_text() == panels[1]._status.get_text()
    assert "group" not in p.t.locs.dtype.names
    _table_equal(p.t.locs, p.j.locs, "undone")
    p.check()


@pytest.mark.parametrize("method", ["otsu", "mean", "triangle"])
def test_mask_panel_matches_jax(monkeypatch, method):
    p = _pair(monkeypatch)
    panels = _panels(p, "open_mask_panel")
    for panel in panels:
        labels = [t.get_text() for t in panel.method.labels]
        panel.method.set_active(labels.index(method))
    assert panels[0]._kwargs() == panels[1]._kwargs()
    np.testing.assert_array_equal(*_on_both(panels,
                                            lambda panel: panel.preview()))
    assert panels[0]._status.get_text() == panels[1]._status.get_text()
    before = len(p.t.locs)
    _on_both(panels, lambda panel: panel.apply("in"))
    _rows_equal(p.t.locs, p.j.locs, "in")
    kept_in = len(p.t.locs)
    p.both("undo")
    assert len(p.t.locs) == before
    _on_both(panels, lambda panel: panel.apply("out"))
    _rows_equal(p.t.locs, p.j.locs, "out")
    assert len(p.t.locs) == before - kept_in
    assert panels[0]._status.get_text() == panels[1]._status.get_text()
    p.check()


def test_apply_panel_matches_jax(monkeypatch):
    """Expressions and their history; an undo of a cluster run after an
    expression pops the history all the same (JAX's fault, kept)."""
    p = _pair(monkeypatch)
    panels = _panels(p, "open_apply_panel")
    for panel in panels:
        panel.expression.set_val("x += 1")
        panel.expression.set_val("   ")
        panel.expression.set_val("flip x y")
    _table_equal(p.t.locs, p.j.locs, "expressions")
    assert panels[0].history == panels[1].history == ["x += 1", "flip x y"]
    p.both("dbscan", radius=0.5, min_density=2)
    _on_both(panels, lambda panel: panel._undo())
    assert panels[0].history == panels[1].history == ["x += 1"]
    _on_both(panels, lambda panel: panel._undo())
    _on_both(panels, lambda panel: panel._undo())
    assert panels[0].history == []
    _table_equal(p.t.locs, _rec(_locs()), "all undone")
    assert (panels[0]._history_text.get_text()
            == panels[1]._history_text.get_text())
    p.check()


def test_link_panel_matches_jax(monkeypatch):
    """Repeated detections, linked: the port gets the rows in the order
    JAX's link sorts them (tests/test_torch_link.py)."""
    locs = _locs()
    again = locs.copy()
    again["frame"] = again["frame"] + 1
    both = pd.concat([locs, again], ignore_index=True)
    p = _pair(monkeypatch, both, port_rows=jax_order)
    panels = _panels(p, "open_link_panel")
    for panel in panels:
        panel.r_max.set_val("0.1")
    nt, nj = _on_both(panels, lambda panel: panel.run())
    assert nt == nj < len(both)
    _table_equal(p.t.locs, p.j.locs, "linked")
    assert panels[0]._status.get_text() == panels[1]._status.get_text()
    p.both("undo")
    assert len(p.t.locs) == len(both)
    p.check()


def test_panel_module_surface_matches_jax():
    assert tpanels.__all__ == jpanels.__all__
    assert tpanels._COLORMAPS == jpanels._COLORMAPS
    assert tpanels._BLUR_LABELS == jpanels._BLUR_LABELS
    assert tpanels._CHANNEL_COLORS == jpanels._CHANNEL_COLORS
    for text in ("", " 2.5 ", "junk", "1e3"):
        assert tpanels._parse_float(text) == jpanels._parse_float(text)
