"""The render window's control panels on matplotlib widgets
(picasso_tpu/gui/panels.py; the reference's Qt dialogs
DisplaySettingsDialog picasso/gui/render.py:6030, DatasetDialog :378,
InfoDialog :4295, ToolsSettingsDialog :5688, SlicerDialog :6610,
FastRenderDialog :6519, AIMDialog :2222, the clustering dialogs
:2308/:2556/:2734, MaskSettingsDialog :4992, ApplyDialog :274,
LinkDialog :2663, ChangeFOV :4168 and the pick navigation :1459).

Each panel is a figure bound to a live
:class:`~picasso_torch.gui.render_app.RenderApp`: every control calls
the app's public setter or action (so panels, scripts and plugins share
one state, and the analyses run on the app's device), and ``sync``
refreshes the widgets from the app without firing their callbacks.
Everything works under the Agg backend.

The panels keep JAX's behaviour where it departs from the reference:
UndriftPanel's one segmentation field of 200 serves RCC and AIM alike
(the reference defaults to 1000 for RCC and 100 for AIM); its "undo
drift" raises ValueError when no drift was computed; ApplyPanel's undo
pops the expression history whenever the app undid anything.
"""

from __future__ import annotations

import contextlib

import numpy as np

from picasso_torch import lib

__all__ = [
    "DisplaySettingsPanel",
    "ChannelsPanel",
    "InfoPanel",
    "ToolsSettingsPanel",
    "SlicerPanel",
    "FastRenderPanel",
    "UndriftPanel",
    "ClusterPanel",
    "MaskPanel",
    "ApplyPanel",
    "LinkPanel",
    "ChangeFOVPanel",
    "PicksPanel",
]

_COLORMAPS = ["hot", "gray", "viridis", "inferno", "magma", "plasma"]
_BLUR_LABELS = [
    "none", "smooth", "gaussian", "gaussian_iso", "convolve"
]
# DatasetDialog's default per-channel color cycle
_CHANNEL_COLORS = [
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 1, 1),
]


def _parse_float(text: str) -> float | None:
    """Blank/invalid text means "automatic" everywhere a numeric
    field can be cleared (contrast limits, scalebar length)."""
    text = text.strip()
    if not text:
        return None
    try:
        return float(text)
    except ValueError:
        return None


class _Panel:
    """Figure lifecycle + callback-suppression shared by the panels."""

    def __init__(self, app, title: str, figsize=(5.2, 7.0)):
        self.app = app
        self.fig = app._new_fig(figsize=figsize)
        with contextlib.suppress(Exception):
            self.fig.canvas.manager.set_window_title(title)
        self._updating = 0

    @contextlib.contextmanager
    def _no_callbacks(self):
        self._updating += 1
        try:
            yield
        finally:
            self._updating -= 1

    def _guarded(self, fn):
        """Wrap a widget callback so sync() doesn't re-enter it."""

        def cb(*args):
            if not self._updating:
                fn(*args)

        return cb

    def close(self):
        import matplotlib.pyplot as plt

        plt.close(self.fig)


class DisplaySettingsPanel(_Panel):
    """DisplaySettingsDialog equivalent: general (display pixel size /
    dynamic / minimap / invert), contrast (min/max density, colormap),
    blur (method + min blur width), camera (pixel size), scale bar
    (show / length / print text / automatic), and render-by-property.
    Control set mirrors reference gui/render.py:6030-6420."""

    def __init__(self, app):
        from matplotlib.widgets import (
            Button, CheckButtons, RadioButtons, Slider, TextBox,
        )

        super().__init__(app, "Display settings")
        fig = self.fig
        fig.text(0.04, 0.975, "Display settings", fontsize=11,
                 fontweight="bold")

        # --- general -------------------------------------------------
        fig.text(0.04, 0.945, "General", fontsize=9, color="0.35")
        ax = fig.add_axes([0.30, 0.895, 0.55, 0.035])
        self.oversampling = Slider(
            ax, "oversampling (log2)", -2.0, 6.0,
            valinit=float(np.log2(max(app.oversampling, 0.25))),
        )
        self.oversampling.on_changed(self._guarded(
            lambda v: app.set_oversampling(
                2.0 ** float(v), dynamic=app.dynamic_oversampling
            )
        ))
        ax = fig.add_axes([0.04, 0.77, 0.42, 0.115], frameon=False)
        self.general_checks = CheckButtons(
            ax, ["dynamic", "minimap", "invert colors"],
            [app.dynamic_oversampling,
             bool(getattr(app, "show_minimap", False)),
             app.invert_colors],
        )
        self.general_checks.on_clicked(
            self._guarded(self._on_general_check)
        )

        # --- contrast ------------------------------------------------
        fig.text(0.04, 0.745, "Contrast", fontsize=9, color="0.35")
        c = app.contrast or (None, None)
        ax = fig.add_axes([0.30, 0.70, 0.16, 0.035])
        self.min_density = TextBox(
            ax, "min ", initial="" if c[0] is None else str(c[0])
        )
        ax = fig.add_axes([0.62, 0.70, 0.16, 0.035])
        self.max_density = TextBox(
            ax, "max ", initial="" if c[1] is None else str(c[1])
        )
        self.min_density.on_submit(self._guarded(self._on_contrast))
        self.max_density.on_submit(self._guarded(self._on_contrast))
        ax = fig.add_axes([0.04, 0.50, 0.30, 0.185], frameon=False)
        cmaps = list(_COLORMAPS)
        if app.colormap not in cmaps:
            cmaps.insert(0, app.colormap)
        self.colormap = RadioButtons(
            ax, cmaps, active=cmaps.index(app.colormap)
        )
        self.colormap.on_clicked(self._guarded(app.set_colormap))

        # --- blur ----------------------------------------------------
        fig.text(0.44, 0.685, "Blur", fontsize=9, color="0.35")
        ax = fig.add_axes([0.44, 0.50, 0.34, 0.175], frameon=False)
        active = _BLUR_LABELS.index(
            app.blur_method if app.blur_method is not None else "none"
        )
        self.blur = RadioButtons(ax, _BLUR_LABELS, active=active)
        self.blur.on_clicked(self._guarded(
            lambda lbl: app.set_blur(None if lbl == "none" else lbl)
        ))
        ax = fig.add_axes([0.55, 0.435, 0.23, 0.035])
        self.min_blur = TextBox(
            ax, "min blur (cam. px) ", initial=str(app.min_blur_width)
        )
        self.min_blur.on_submit(self._guarded(
            lambda t: app.set_min_blur_width(_parse_float(t) or 0.0)
        ))

        # --- camera --------------------------------------------------
        fig.text(0.04, 0.40, "Camera", fontsize=9, color="0.35")
        px = lib.get_from_metadata(
            app.info, "Pixelsize", default=130.0, raise_error=False
        )
        ax = fig.add_axes([0.55, 0.355, 0.23, 0.035])
        self.pixelsize = TextBox(
            ax, "pixel size (nm) ", initial=str(px)
        )
        self.pixelsize.on_submit(self._guarded(
            lambda t: app.set_pixelsize(_parse_float(t) or px)
        ))

        # --- scale bar -----------------------------------------------
        fig.text(0.04, 0.325, "Scale bar", fontsize=9, color="0.35")
        ax = fig.add_axes([0.04, 0.19, 0.42, 0.115], frameon=False)
        self.scalebar_checks = CheckButtons(
            ax, ["show", "print length", "automatic length"],
            [bool(getattr(app, "show_scalebar", False)),
             bool(getattr(app, "scalebar_text", True)),
             getattr(app, "scalebar_length_nm", None) is None],
        )
        self.scalebar_checks.on_clicked(
            self._guarded(self._on_scalebar_check)
        )
        length = getattr(app, "scalebar_length_nm", None)
        ax = fig.add_axes([0.62, 0.245, 0.20, 0.035])
        self.scalebar_length = TextBox(
            ax, "length (nm) ",
            initial="" if length is None else str(length),
        )
        self.scalebar_length.on_submit(
            self._guarded(self._on_scalebar_length)
        )

        # --- render by property ---------------------------------------
        fig.text(0.04, 0.155, "Render properties", fontsize=9,
                 color="0.35")
        prop = getattr(app, "render_property", None) or {}
        ax = fig.add_axes([0.22, 0.105, 0.22, 0.035])
        self.prop_parameter = TextBox(
            ax, "parameter ", initial=prop.get("parameter", "")
        )
        ax = fig.add_axes([0.56, 0.105, 0.10, 0.035])
        self.prop_min = TextBox(
            ax, "min ",
            initial="" if prop.get("min_value") is None
            else str(prop["min_value"]),
        )
        ax = fig.add_axes([0.76, 0.105, 0.10, 0.035])
        self.prop_max = TextBox(
            ax, "max ",
            initial="" if prop.get("max_value") is None
            else str(prop["max_value"]),
        )
        ax = fig.add_axes([0.22, 0.055, 0.10, 0.035])
        self.prop_colors = TextBox(
            ax, "colors ", initial=str(prop.get("n_colors", 32))
        )
        ax = fig.add_axes([0.44, 0.055, 0.16, 0.035])
        self.prop_apply = Button(ax, "Render")
        self.prop_apply.on_clicked(
            self._guarded(lambda ev: self.apply_render_property())
        )
        ax = fig.add_axes([0.64, 0.055, 0.16, 0.035])
        self.prop_clear = Button(ax, "Clear")
        self.prop_clear.on_clicked(
            self._guarded(lambda ev: self._clear_render_property())
        )

    # -- callbacks ----------------------------------------------------
    def _on_general_check(self, _label):
        dyn, minimap, invert = self.general_checks.get_status()
        app = self.app
        app.dynamic_oversampling = bool(dyn)
        if bool(minimap) != bool(getattr(app, "show_minimap", False)):
            app.set_minimap(minimap)
        if bool(invert) != app.invert_colors:
            app.set_invert_colors(invert)

    def _on_contrast(self, _text):
        self.app.set_contrast(
            _parse_float(self.min_density.text),
            _parse_float(self.max_density.text),
        )

    def _on_scalebar_length(self, text):
        """Typing a length implies manual mode; clearing it implies
        automatic — keep the checkbox consistent either way."""
        length = _parse_float(text)
        self.app.set_scalebar(length_nm=length)
        want_auto = length is None
        with self._no_callbacks():
            if self.scalebar_checks.get_status()[2] != want_auto:
                self.scalebar_checks.set_active(2)

    def _on_scalebar_check(self, _label):
        show, text, optimal = self.scalebar_checks.get_status()
        self.app.set_scalebar(
            show=show, text=text,
            length_nm=None if optimal
            else _parse_float(self.scalebar_length.text),
        )

    def apply_render_property(self):
        """Apply the render-properties group (reference
        activate_render_property, gui/render.py:10814)."""
        param = self.prop_parameter.text.strip()
        if not param:
            self._clear_render_property()
            return
        n_colors = _parse_float(self.prop_colors.text) or 32
        self.app.set_render_property(
            param,
            n_colors=int(n_colors),
            min_value=_parse_float(self.prop_min.text),
            max_value=_parse_float(self.prop_max.text),
        )

    def _clear_render_property(self):
        self.app.clear_render_property()

    # -- state refresh --------------------------------------------------
    def sync(self):
        """Refresh every widget from app state (after scripted
        changes), without firing the control callbacks."""
        app = self.app
        with self._no_callbacks():
            self.oversampling.set_val(
                float(np.log2(max(app.oversampling, 0.25)))
            )
            want = [
                app.dynamic_oversampling,
                bool(getattr(app, "show_minimap", False)),
                app.invert_colors,
            ]
            for i, (cur, tgt) in enumerate(
                zip(self.general_checks.get_status(), want)
            ):
                if cur != tgt:
                    self.general_checks.set_active(i)
            c = app.contrast or (None, None)
            self.min_density.set_val(
                "" if c[0] is None else str(c[0])
            )
            self.max_density.set_val(
                "" if c[1] is None else str(c[1])
            )
            labels = [t.get_text() for t in self.colormap.labels]
            if app.colormap in labels:
                self.colormap.set_active(
                    labels.index(app.colormap)
                )
            self.blur.set_active(_BLUR_LABELS.index(
                app.blur_method if app.blur_method is not None
                else "none"
            ))
            self.min_blur.set_val(str(app.min_blur_width))
            want = [
                bool(getattr(app, "show_scalebar", False)),
                bool(getattr(app, "scalebar_text", True)),
                getattr(app, "scalebar_length_nm", None) is None,
            ]
            for i, (cur, tgt) in enumerate(
                zip(self.scalebar_checks.get_status(), want)
            ):
                if cur != tgt:
                    self.scalebar_checks.set_active(i)
            length = getattr(app, "scalebar_length_nm", None)
            self.scalebar_length.set_val(
                "" if length is None else str(length)
            )


class ChannelsPanel(_Panel):
    """DatasetDialog equivalent (reference gui/render.py:378): one row
    per channel — visibility tick, color cycle, relative intensity —
    plus the global legend toggle. Rebuilt on add/remove."""

    MAX_ROWS = 8

    def __init__(self, app):
        super().__init__(app, "Channels", figsize=(5.2, 4.6))
        self.rebuild()

    def rebuild(self):
        from matplotlib.widgets import Button, CheckButtons, Slider

        fig = self.fig
        fig.clear()
        app = self.app
        fig.text(0.04, 0.94, "Channels", fontsize=11,
                 fontweight="bold")
        ax = fig.add_axes([0.60, 0.90, 0.36, 0.07], frameon=False)
        self.legend_check = CheckButtons(
            ax, ["show legend"],
            [bool(getattr(app, "show_legend", False))],
        )
        self.legend_check.on_clicked(self._guarded(
            lambda _l: app.set_legend(
                self.legend_check.get_status()[0]
            )
        ))
        n = min(len(app.channels), self.MAX_ROWS)
        self.visible_checks = None
        self.color_buttons: list = []
        self.intensity_sliders: list = []
        if n:
            labels = [
                (ch.path or f"channel {i}").rsplit("/", 1)[-1][:24]
                for i, ch in enumerate(app.channels[:n])
            ]
            ax = fig.add_axes(
                [0.04, 0.86 - 0.085 * n, 0.40, 0.085 * n],
                frameon=False,
            )
            self.visible_checks = CheckButtons(
                ax, labels,
                [bool(getattr(ch, "visible", True))
                 for ch in app.channels[:n]],
            )
            self.visible_checks.on_clicked(
                self._guarded(self._on_visible)
            )
            for i in range(n):
                y = 0.86 - 0.085 * (i + 0.8)
                bax = fig.add_axes([0.48, y, 0.12, 0.055])
                btn = Button(bax, "color")
                btn.on_clicked(self._guarded(
                    lambda ev, i=i: self.cycle_color(i)
                ))
                self.color_buttons.append(btn)
                sax = fig.add_axes([0.68, y + 0.012, 0.26, 0.03])
                s = Slider(
                    sax, "", 0.0, 2.0,
                    valinit=float(
                        getattr(
                            app.channels[i], "relative_intensity", 1.0
                        )
                    ),
                )
                s.on_changed(self._guarded(
                    lambda v, i=i: (
                        app.set_channel_intensity(i, float(v)),
                        app.redraw(),
                    )
                ))
                self.intensity_sliders.append(s)
        if len(app.channels) > self.MAX_ROWS:
            fig.text(
                0.04, 0.02,
                f"... {len(app.channels) - self.MAX_ROWS} more "
                "channels (use the scripting API)", fontsize=8,
            )

    def _on_visible(self, _label):
        status = self.visible_checks.get_status()
        for i, vis in enumerate(status):
            self.app.set_channel_visible(i, bool(vis))
        self.app.redraw()

    def cycle_color(self, i: int):
        """Advance channel ``i`` through the default color cycle
        (DatasetDialog's per-channel color combo)."""
        ch = self.app.channels[i]
        cur = getattr(ch, "color", None)
        try:
            idx = _CHANNEL_COLORS.index(tuple(cur))
        except (TypeError, ValueError):
            idx = -1
        nxt = _CHANNEL_COLORS[(idx + 1) % len(_CHANNEL_COLORS)]
        self.app.set_channel_color(i, nxt)
        self.app.redraw()


class InfoPanel(_Panel):
    """InfoDialog equivalent (reference gui/render.py:4295): display /
    movie / localization statistics as text, with NeNA and FRC actions
    that run the real analyses and append their results."""

    def __init__(self, app):
        from matplotlib.widgets import Button

        super().__init__(app, "Info", figsize=(5.2, 5.6))
        fig = self.fig
        fig.text(0.04, 0.95, "Info", fontsize=11, fontweight="bold")
        self._text = fig.text(
            0.04, 0.90, "", fontsize=8, family="monospace",
            va="top",
        )
        ax = fig.add_axes([0.04, 0.04, 0.26, 0.06])
        self.nena_button = Button(ax, "NeNA")
        self.nena_button.on_clicked(
            self._guarded(lambda ev: self.run_nena())
        )
        ax = fig.add_axes([0.37, 0.04, 0.26, 0.06])
        self.frc_button = Button(ax, "FRC")
        self.frc_button.on_clicked(
            self._guarded(lambda ev: self.run_frc())
        )
        ax = fig.add_axes([0.70, 0.04, 0.26, 0.06])
        self.refresh_button = Button(ax, "Refresh")
        self.refresh_button.on_clicked(
            self._guarded(lambda ev: self.refresh())
        )
        self.nena_result: dict | None = None
        self.frc_result: dict | None = None
        self.refresh()

    def refresh(self):
        info = self.app.show_info()
        lines = [f"{k}: {v}" for k, v in info.items()]
        if self.app.picks:
            with contextlib.suppress(Exception):
                pi = self.app.pick_info()
                lines.append("")
                lines += [f"picks.{k}: {v}" for k, v in pi.items()]
        if self.nena_result is not None:
            lines.append("")
            lines.append(
                "NeNA lp (px): "
                f"{self.nena_result.get('lp', float('nan')):.4f}"
            )
        if self.frc_result is not None:
            res = self.frc_result.get("resolution")
            lines.append(
                "FRC resolution (nm): "
                + (f"{res:.1f}" if res is not None
                   else "n/a (no 1/7 crossing)")
            )
        self._text.set_text("\n".join(lines))
        self.fig.canvas.draw_idle()
        return info

    def run_nena(self) -> dict:
        self.nena_result = self.app.calculate_nena()
        self.refresh()
        return self.nena_result

    def run_frc(self) -> dict:
        self.frc_result = self.app.calculate_frc()
        self.refresh()
        return self.frc_result


class ToolsSettingsPanel(_Panel):
    """ToolsSettingsDialog equivalent (reference gui/render.py:5688):
    pick shape, the per-shape size field (circle diameter / rectangle
    width / square side, camera px), pick annotation, and the
    'pick similar' std range with its action button."""

    _SHAPES = ("Circle", "Rectangle", "Polygon", "Square")

    def __init__(self, app):
        from matplotlib.widgets import (
            Button, CheckButtons, RadioButtons, TextBox,
        )

        super().__init__(app, "Tools settings", figsize=(4.6, 4.6))
        fig = self.fig
        fig.text(0.04, 0.94, "Tools settings", fontsize=11,
                 fontweight="bold")

        fig.text(0.04, 0.88, "Pick shape", fontsize=9, color="0.35")
        ax = fig.add_axes([0.04, 0.60, 0.38, 0.26], frameon=False)
        self.shape = RadioButtons(
            ax, self._SHAPES,
            active=self._SHAPES.index(app.pick_shape),
        )
        self.shape.on_clicked(self._guarded(self._on_shape))

        ax = fig.add_axes([0.62, 0.76, 0.30, 0.05])
        self.size = TextBox(
            ax, "size (px) ", initial=str(self._current_size())
        )
        self.size.on_submit(self._guarded(self._on_size))
        self._size_note = fig.text(
            0.62, 0.70, self._size_label(), fontsize=8, color="0.35"
        )

        ax = fig.add_axes([0.50, 0.52, 0.46, 0.10], frameon=False)
        self.annotate = CheckButtons(
            ax, ["annotate picks"],
            [bool(getattr(app, "annotate_picks", False))],
        )
        self.annotate.on_clicked(self._guarded(self._on_annotate))

        fig.text(0.04, 0.44, "Pick similar", fontsize=9, color="0.35")
        ax = fig.add_axes([0.44, 0.33, 0.22, 0.06])
        self.std_range = TextBox(ax, "std range ", initial="2.0")
        ax = fig.add_axes([0.04, 0.18, 0.42, 0.08])
        self.similar_button = Button(ax, "Pick similar")
        self.similar_button.on_clicked(
            self._guarded(lambda ev: self.run_pick_similar())
        )
        ax = fig.add_axes([0.54, 0.18, 0.42, 0.08])
        self.clear_button = Button(ax, "Clear picks")
        self.clear_button.on_clicked(
            self._guarded(lambda ev: app.clear_picks())
        )
        self._status = fig.text(0.04, 0.06, "", fontsize=8)

    def _size_label(self) -> str:
        return {
            "Circle": "diameter",
            "Rectangle": "width",
            "Square": "side",
            "Polygon": "(no size: click vertices)",
        }[self.app.pick_shape]

    def _current_size(self) -> float:
        app = self.app
        return {
            "Circle": app.pick_diameter,
            "Rectangle": app.pick_width,
            "Square": app.pick_side,
            "Polygon": 0.0,
        }[app.pick_shape]

    # -- callbacks ----------------------------------------------------
    def _on_shape(self, label):
        self.app.set_pick_shape(label)
        with self._no_callbacks():
            self.size.set_val(str(self._current_size()))
        self._size_note.set_text(self._size_label())
        self.fig.canvas.draw_idle()

    def _on_size(self, text):
        size = _parse_float(text)
        if size is None or size <= 0:
            return
        app = self.app
        if app.pick_shape == "Circle":
            app.pick_diameter = size
        elif app.pick_shape == "Rectangle":
            app.pick_width = size
        elif app.pick_shape == "Square":
            app.pick_side = size
        app.redraw()

    def _on_annotate(self, _label):
        self.app.annotate_picks = self.annotate.get_status()[0]
        self.app.redraw()

    def run_pick_similar(self) -> int:
        """Reference 'Pick similar' tool (gui/render.py:11904):
        expands the pick set to all regions statistically like the
        current picks; returns the new pick count."""
        std = _parse_float(self.std_range.text) or 2.0
        self.app.pick_similar(std_range=std)
        n = len(self.app.picks)
        self._status.set_text(f"{n} picks")
        self.fig.canvas.draw_idle()
        return n

    def sync(self):
        app = self.app
        with self._no_callbacks():
            self.shape.set_active(self._SHAPES.index(app.pick_shape))
            self.size.set_val(str(self._current_size()))
            if (
                self.annotate.get_status()[0]
                != bool(getattr(app, "annotate_picks", False))
            ):
                self.annotate.set_active(0)
        self._size_note.set_text(self._size_label())


class SlicerPanel(_Panel):
    """SlicerDialog equivalent (reference gui/render.py:6610): z
    histogram with the active slab shaded, thickness field, slice
    slider, prev/next steppers and PNG stack export. Requires 3D locs
    (a ``z`` column), like the reference dialog."""

    def __init__(self, app, thickness_nm: float = 50.0):
        from matplotlib.widgets import Button, Slider, TextBox

        super().__init__(app, "Slicer", figsize=(5.2, 4.2))
        if "z" not in app.locs.dtype.names:
            self.close()
            raise ValueError(
                "Slicer requires 3D locs (a 'z' column)."
            )
        if not app.slicer_on:
            app.start_slicer(thickness_nm=thickness_nm)
        fig = self.fig
        fig.text(0.04, 0.93, "Slicer", fontsize=11, fontweight="bold")

        self.hist_ax = fig.add_axes([0.12, 0.52, 0.82, 0.36])
        self._span = None
        self._draw_histogram()

        ax = fig.add_axes([0.36, 0.38, 0.24, 0.06])
        self.thickness = TextBox(
            ax, "thickness (nm) ", initial=str(app.slice_thickness)
        )
        self.thickness.on_submit(self._guarded(self._on_thickness))

        ax = fig.add_axes([0.12, 0.26, 0.70, 0.05])
        self.position = Slider(
            ax, "slice", 0, max(app.n_slices() - 1, 1),
            valinit=app.slice_position, valstep=1,
        )
        self.position.on_changed(self._guarded(
            lambda v: self._set_slice(int(v))
        ))

        ax = fig.add_axes([0.12, 0.12, 0.14, 0.08])
        self.prev_button = Button(ax, "prev")
        self.prev_button.on_clicked(self._guarded(
            lambda ev: self._set_slice(self.app.slice_position - 1)
        ))
        ax = fig.add_axes([0.30, 0.12, 0.14, 0.08])
        self.next_button = Button(ax, "next")
        self.next_button.on_clicked(self._guarded(
            lambda ev: self._set_slice(self.app.slice_position + 1)
        ))
        ax = fig.add_axes([0.52, 0.12, 0.20, 0.08])
        self.stop_button = Button(ax, "full view")
        self.stop_button.on_clicked(self._guarded(
            lambda ev: self.app.stop_slicer()
        ))
        self._range_text = fig.text(0.04, 0.03, "", fontsize=8)
        self._update_range_text()

    def _draw_histogram(self):
        ax = self.hist_ax
        ax.clear()
        z = self.app.locs["z"]
        ax.hist(z, bins=min(100, max(10, z.size // 50)),
                color="0.6")
        ax.set_xlabel("z (nm)", fontsize=8)
        ax.tick_params(labelsize=7)
        lo, hi = self.app.slice_range()
        self._span = ax.axvspan(lo, hi, color="C0", alpha=0.35)
        self.fig.canvas.draw_idle()

    def _update_range_text(self):
        lo, hi = self.app.slice_range()
        self._range_text.set_text(
            f"slice {self.app.slice_position + 1}/"
            f"{self.app.n_slices()}: z in [{lo:.1f}, {hi:.1f}) nm"
        )

    def _set_slice(self, position: int):
        self.app.set_slice(position)
        self.sync()

    def _on_thickness(self, text):
        t = _parse_float(text)
        if t is None or t <= 0:
            return
        self.app.start_slicer(thickness_nm=t)
        with self._no_callbacks():
            self.position.valmax = max(self.app.n_slices() - 1, 1)
            self.position.ax.set_xlim(0, self.position.valmax)
        self.sync()

    def export_stack(self, basepath: str) -> list[str]:
        """Write one PNG per z slice (reference
        SlicerDialog.export_stack, gui/render.py:6855)."""
        return self.app.export_slices(basepath)

    def sync(self):
        app = self.app
        with self._no_callbacks():
            self.position.set_val(app.slice_position)
            self.thickness.set_val(str(app.slice_thickness))
        self._draw_histogram()
        self._update_range_text()


class FastRenderPanel(_Panel):
    """FastRenderDialog equivalent (reference gui/render.py:6519):
    display a random locs fraction while navigating. The slider sets
    the kept fraction; 100% restores the full set."""

    def __init__(self, app):
        from matplotlib.widgets import Button, Slider

        super().__init__(app, "Fast render", figsize=(4.6, 1.8))
        fig = self.fig
        fig.text(0.04, 0.82, "Fast render", fontsize=11,
                 fontweight="bold")
        ax = fig.add_axes([0.24, 0.45, 0.60, 0.16])
        self.fraction = Slider(
            ax, "fraction ", 0.01, 1.0,
            valinit=float(
                getattr(app, "fast_render_fraction", 1.0)
            ),
        )
        self.fraction.on_changed(self._guarded(
            lambda v: app.set_fast_render(float(v))
        ))
        ax = fig.add_axes([0.24, 0.08, 0.30, 0.22])
        self.reset_button = Button(ax, "show all")
        self.reset_button.on_clicked(
            self._guarded(lambda ev: self._reset())
        )

    def _reset(self):
        self.app.set_fast_render(1.0)
        self.sync()

    def sync(self):
        with self._no_callbacks():
            self.fraction.set_val(float(
                getattr(self.app, "fast_render_fraction", 1.0)
            ))


class UndriftPanel(_Panel):
    """Undrift controls (the reference's Postprocess menu +
    AIMDialog, gui/render.py:2222, and DriftPlotWindow :4141): RCC
    segmentation, AIM parameters, undrift-from-picked, undo, and the
    drift curve drawn into the panel after each run."""

    def __init__(self, app):
        from matplotlib.widgets import Button, TextBox

        super().__init__(app, "Undrift", figsize=(5.2, 5.0))
        fig = self.fig
        fig.text(0.04, 0.94, "Undrift", fontsize=11,
                 fontweight="bold")

        ax = fig.add_axes([0.40, 0.84, 0.18, 0.05])
        self.segmentation = TextBox(ax, "segmentation ", initial="200")
        ax = fig.add_axes([0.66, 0.84, 0.28, 0.06])
        self.rcc_button = Button(ax, "RCC")
        self.rcc_button.on_clicked(
            self._guarded(lambda ev: self.run_rcc())
        )

        ax = fig.add_axes([0.40, 0.74, 0.18, 0.05])
        self.intersect_d = TextBox(ax, "intersect (nm) ", initial="20")
        ax = fig.add_axes([0.40, 0.66, 0.18, 0.05])
        self.roi_r = TextBox(ax, "ROI r (nm) ", initial="60")
        ax = fig.add_axes([0.66, 0.68, 0.28, 0.06])
        self.aim_button = Button(ax, "AIM")
        self.aim_button.on_clicked(
            self._guarded(lambda ev: self.run_aim())
        )

        ax = fig.add_axes([0.04, 0.56, 0.42, 0.06])
        self.picked_button = Button(ax, "from picked")
        self.picked_button.on_clicked(
            self._guarded(lambda ev: self.run_from_picked())
        )
        ax = fig.add_axes([0.52, 0.56, 0.42, 0.06])
        self.undo_button = Button(ax, "undo drift")
        self.undo_button.on_clicked(
            self._guarded(lambda ev: self._undo())
        )

        self.drift_ax = fig.add_axes([0.12, 0.10, 0.82, 0.38])
        self._status = fig.text(0.04, 0.02, "", fontsize=8)
        self._plot_drift()

    def _seg(self) -> int:
        return int(_parse_float(self.segmentation.text) or 200)

    def run_rcc(self):
        drift = self.app.undrift_rcc(segmentation=self._seg())
        self._after(drift, "RCC")
        return drift

    def run_aim(self):
        drift = self.app.undrift_aim(
            segmentation=self._seg(),
            intersect_d_nm=_parse_float(self.intersect_d.text) or 20.0,
            roi_r_nm=_parse_float(self.roi_r.text) or 60.0,
        )
        self._after(drift, "AIM")
        return drift

    def run_from_picked(self):
        drift = self.app.undrift_from_picked()
        self._after(drift, "from picked")
        return drift

    def _undo(self):
        self.app.undo_drift()
        self._status.set_text("drift undone")
        self._plot_drift()

    def _after(self, drift, label: str):
        n = len(drift) if drift is not None else 0
        self._status.set_text(f"undrift {label}: {n} frames")
        self._plot_drift()

    def _plot_drift(self):
        ax = self.drift_ax
        ax.clear()
        drift = self.app.channel.drift
        if drift is None:
            ax.text(0.5, 0.5, "no drift computed",
                    ha="center", va="center", fontsize=8,
                    transform=ax.transAxes)
        else:
            # drift is a structured array with x/y(/z) fields
            # (postprocess.undrift, aim.aim, io.load_drift)
            for name in drift.dtype.names:
                ax.plot(np.asarray(drift[name]), label=name, lw=0.8)
            ax.legend(fontsize=7)
            ax.set_xlabel("frame", fontsize=8)
            ax.set_ylabel("drift (px)", fontsize=8)
        ax.tick_params(labelsize=7)
        self.fig.canvas.draw_idle()

    def sync(self):
        self._plot_drift()


class ClusterPanel(_Panel):
    """Clustering dialogs rolled into one panel (the reference's
    DbscanDialog gui/render.py:2308, HdbscanDialog :2556, SMLMDialog
    :2734): pick the algorithm, edit its parameters, run on the
    active channel. The parameter rows mirror each dialog's fields;
    only the selected algorithm's values are read on Run."""

    _ALGOS = ("smlm", "dbscan", "hdbscan")

    def __init__(self, app):
        from matplotlib.widgets import Button, RadioButtons, TextBox

        super().__init__(app, "Clustering", figsize=(5.2, 4.6))
        fig = self.fig
        fig.text(0.04, 0.94, "Clustering", fontsize=11,
                 fontweight="bold")
        ax = fig.add_axes([0.04, 0.62, 0.30, 0.24], frameon=False)
        self.algo = RadioButtons(ax, self._ALGOS, active=0)

        # SMLM clusterer row
        fig.text(0.40, 0.84, "smlm", fontsize=8, color="0.35")
        ax = fig.add_axes([0.62, 0.80, 0.14, 0.05])
        self.radius_xy = TextBox(ax, "radius xy (px) ", initial="0.3")
        ax = fig.add_axes([0.84, 0.80, 0.12, 0.05])
        self.min_locs = TextBox(ax, "min locs ", initial="10")

        # DBSCAN row
        fig.text(0.40, 0.72, "dbscan", fontsize=8, color="0.35")
        ax = fig.add_axes([0.62, 0.68, 0.14, 0.05])
        self.radius = TextBox(ax, "radius (px) ", initial="0.3")
        ax = fig.add_axes([0.84, 0.68, 0.12, 0.05])
        self.min_density = TextBox(ax, "min density ", initial="4")

        # HDBSCAN row
        fig.text(0.40, 0.60, "hdbscan", fontsize=8, color="0.35")
        ax = fig.add_axes([0.62, 0.56, 0.14, 0.05])
        self.min_cluster = TextBox(ax, "min cluster ", initial="10")
        ax = fig.add_axes([0.84, 0.56, 0.12, 0.05])
        self.min_samples = TextBox(ax, "min samples ", initial="10")

        ax = fig.add_axes([0.04, 0.34, 0.42, 0.08])
        self.run_button = Button(ax, "Run")
        self.run_button.on_clicked(
            self._guarded(lambda ev: self.run())
        )
        ax = fig.add_axes([0.54, 0.34, 0.42, 0.08])
        self.undo_button = Button(ax, "Undo")
        self.undo_button.on_clicked(
            self._guarded(lambda ev: self._undo())
        )
        self._status = fig.text(0.04, 0.22, "", fontsize=8)

    def run(self) -> int:
        """Cluster the active channel with the selected algorithm;
        returns the cluster count (the dialogs' OK action)."""
        algo = self.algo.value_selected
        app = self.app
        if algo == "smlm":
            n = app.smlm_clusterer(
                radius_xy=_parse_float(self.radius_xy.text) or 0.3,
                min_locs=int(_parse_float(self.min_locs.text) or 10),
            )
        elif algo == "dbscan":
            n = app.dbscan(
                radius=_parse_float(self.radius.text) or 0.3,
                min_density=int(
                    _parse_float(self.min_density.text) or 4
                ),
            )
        else:
            n = app.hdbscan(
                min_cluster_size=int(
                    _parse_float(self.min_cluster.text) or 10
                ),
                min_samples=int(
                    _parse_float(self.min_samples.text) or 10
                ),
            )
        self._status.set_text(f"{algo}: {n} clusters")
        self.fig.canvas.draw_idle()
        return n

    def _undo(self):
        label = self.app.undo()
        self._status.set_text(f"undid: {label}" if label else "")
        self.fig.canvas.draw_idle()


class MaskPanel(_Panel):
    """MaskSettingsDialog equivalent (reference gui/render.py:4992):
    threshold method, mask render pixel size and blur, preview the
    binary mask, and apply it keeping the locs inside or outside."""

    def __init__(self, app):
        from matplotlib.widgets import Button, RadioButtons, TextBox

        from picasso_torch import masking

        super().__init__(app, "Mask image", figsize=(5.2, 5.2))
        fig = self.fig
        fig.text(0.04, 0.94, "Mask image", fontsize=11,
                 fontweight="bold")
        ax = fig.add_axes([0.04, 0.42, 0.34, 0.46], frameon=False)
        self.method = RadioButtons(
            ax, list(masking.THRESHOLD_METHODS),
            active=list(masking.THRESHOLD_METHODS).index("otsu"),
        )
        ax = fig.add_axes([0.70, 0.82, 0.20, 0.05])
        self.disp_px = TextBox(ax, "mask px (nm) ", initial="200")
        ax = fig.add_axes([0.70, 0.74, 0.20, 0.05])
        self.blur = TextBox(ax, "blur (nm) ", initial="500")

        self.mask_ax = fig.add_axes([0.46, 0.34, 0.48, 0.36])
        self.mask_ax.set_axis_off()

        ax = fig.add_axes([0.04, 0.20, 0.28, 0.08])
        self.preview_button = Button(ax, "Preview")
        self.preview_button.on_clicked(
            self._guarded(lambda ev: self.preview())
        )
        ax = fig.add_axes([0.36, 0.20, 0.28, 0.08])
        self.keep_in_button = Button(ax, "Keep inside")
        self.keep_in_button.on_clicked(
            self._guarded(lambda ev: self.apply("in"))
        )
        ax = fig.add_axes([0.68, 0.20, 0.28, 0.08])
        self.keep_out_button = Button(ax, "Keep outside")
        self.keep_out_button.on_clicked(
            self._guarded(lambda ev: self.apply("out"))
        )
        self._status = fig.text(0.04, 0.08, "", fontsize=8)
        self.last_mask = None

    def _kwargs(self) -> dict:
        return {
            "method": self.method.value_selected,
            "disp_px_size": _parse_float(self.disp_px.text) or 200.0,
            "blur": _parse_float(self.blur.text) or 500.0,
        }

    def preview(self):
        mask, locs_in, locs_out = self.app.mask_image(**self._kwargs())
        self.last_mask = mask
        self.mask_ax.clear()
        self.mask_ax.imshow(mask, cmap="gray", origin="lower")
        self.mask_ax.set_axis_off()
        self._status.set_text(
            f"{len(locs_in)} in / {len(locs_out)} out"
        )
        self.fig.canvas.draw_idle()
        return mask

    def apply(self, keep: str = "in"):
        """Split the channel by the mask (MaskSettingsDialog's save
        actions write locs_in/locs_out; here the kept side replaces
        the channel, with undo)."""
        mask = self.app.apply_mask(keep=keep, **self._kwargs())
        self.last_mask = mask
        self._status.set_text(
            f"kept {keep}: {len(self.app.locs)} locs"
        )
        self.fig.canvas.draw_idle()
        return mask


class ApplyPanel(_Panel):
    """ApplyDialog equivalent (reference gui/render.py:274): a
    one-line expression over the localization columns (``x += 10``,
    ``flip x y``, ``spiral 2 3``, ...), with the command history
    shown and undo."""

    def __init__(self, app):
        from matplotlib.widgets import Button, TextBox

        super().__init__(app, "Apply expression", figsize=(5.2, 2.6))
        fig = self.fig
        fig.text(0.04, 0.88, "Apply expression", fontsize=11,
                 fontweight="bold")
        ax = fig.add_axes([0.14, 0.60, 0.82, 0.12])
        self.expression = TextBox(ax, "cmd ", initial="")
        self.expression.on_submit(self._guarded(self._on_submit))
        ax = fig.add_axes([0.04, 0.36, 0.28, 0.16])
        self.apply_button = Button(ax, "Apply")
        self.apply_button.on_clicked(self._guarded(
            lambda ev: self._on_submit(self.expression.text)
        ))
        ax = fig.add_axes([0.38, 0.36, 0.28, 0.16])
        self.undo_button = Button(ax, "Undo")
        self.undo_button.on_clicked(
            self._guarded(lambda ev: self._undo())
        )
        self.history: list[str] = []
        self._history_text = fig.text(
            0.04, 0.26, "", fontsize=8, family="monospace", va="top"
        )

    def _on_submit(self, text):
        cmd = text.strip()
        if not cmd:
            return
        self.app.apply_expression(cmd)
        self.history.append(cmd)
        self._show_history()

    def _undo(self):
        label = self.app.undo()
        if label and self.history:
            self.history.pop()
        self._show_history()

    def _show_history(self):
        self._history_text.set_text(
            "\n".join(self.history[-3:])
        )
        self.fig.canvas.draw_idle()


class LinkPanel(_Panel):
    """LinkDialog equivalent (reference gui/render.py:2663): link
    localizations persisting across consecutive frames within a
    radius, tolerating dark gaps."""

    def __init__(self, app):
        from matplotlib.widgets import Button, TextBox

        super().__init__(app, "Link", figsize=(4.6, 2.4))
        fig = self.fig
        fig.text(0.04, 0.86, "Link localizations", fontsize=11,
                 fontweight="bold")
        ax = fig.add_axes([0.50, 0.58, 0.20, 0.14])
        self.r_max = TextBox(ax, "max distance (px) ", initial="0.05")
        ax = fig.add_axes([0.50, 0.38, 0.20, 0.14])
        self.max_dark = TextBox(
            ax, "max dark frames ", initial="1"
        )
        ax = fig.add_axes([0.04, 0.08, 0.36, 0.20])
        self.link_button = Button(ax, "Link")
        self.link_button.on_clicked(
            self._guarded(lambda ev: self.run())
        )
        ax = fig.add_axes([0.48, 0.08, 0.36, 0.20])
        self.undo_button = Button(ax, "Undo")
        self.undo_button.on_clicked(
            self._guarded(lambda ev: self.app.undo())
        )
        self._status = fig.text(0.75, 0.14, "", fontsize=8)

    def run(self) -> int:
        before = len(self.app.locs)
        self.app.link(
            r_max=_parse_float(self.r_max.text) or 0.05,
            max_dark_time=int(_parse_float(self.max_dark.text) or 1),
        )
        n = len(self.app.locs)
        self._status.set_text(f"{before} -> {n}")
        self.fig.canvas.draw_idle()
        return n


class ChangeFOVPanel(_Panel):
    """ChangeFOV equivalent (reference gui/render.py:4168): type the
    viewport origin and size in camera pixels, or snap back to the
    full FOV."""

    def __init__(self, app):
        from matplotlib.widgets import Button, TextBox

        super().__init__(app, "Change FOV", figsize=(4.6, 2.6))
        fig = self.fig
        fig.text(0.04, 0.88, "Change field of view", fontsize=11,
                 fontweight="bold")
        (y_min, x_min), (y_max, x_max) = app.viewport
        ax = fig.add_axes([0.18, 0.62, 0.22, 0.13])
        self.x = TextBox(ax, "x ", initial=f"{x_min:g}")
        ax = fig.add_axes([0.64, 0.62, 0.22, 0.13])
        self.y = TextBox(ax, "y ", initial=f"{y_min:g}")
        ax = fig.add_axes([0.18, 0.42, 0.22, 0.13])
        self.w = TextBox(ax, "w ", initial=f"{x_max - x_min:g}")
        ax = fig.add_axes([0.64, 0.42, 0.22, 0.13])
        self.h = TextBox(ax, "h ", initial=f"{y_max - y_min:g}")
        ax = fig.add_axes([0.04, 0.08, 0.40, 0.22])
        self.apply_button = Button(ax, "Set FOV")
        self.apply_button.on_clicked(
            self._guarded(lambda ev: self.apply())
        )
        ax = fig.add_axes([0.54, 0.08, 0.40, 0.22])
        self.full_button = Button(ax, "Full FOV")
        self.full_button.on_clicked(
            self._guarded(lambda ev: self._full())
        )

    def apply(self):
        x = _parse_float(self.x.text)
        y = _parse_float(self.y.text)
        w = _parse_float(self.w.text)
        h = _parse_float(self.h.text)
        if None in (x, y, w, h) or w <= 0 or h <= 0:
            return
        self.app.viewport = ((y, x), (y + h, x + w))
        self.app.redraw()

    def _full(self):
        self.app.fit_in_view()
        self.sync()

    def sync(self):
        (y_min, x_min), (y_max, x_max) = self.app.viewport
        with self._no_callbacks():
            self.x.set_val(f"{x_min:g}")
            self.y.set_val(f"{y_min:g}")
            self.w.set_val(f"{x_max - x_min:g}")
            self.h.set_val(f"{y_max - y_min:g}")


class PicksPanel(_Panel):
    """Pick browser (the reference's Tools menu pick actions +
    PlotDialog navigation, gui/render.py:1459): step through picks
    (centering the viewport like 'Move to pick'), inspect the current
    pick's trace or scatter, and filter the pick list by loc count."""

    def __init__(self, app):
        from matplotlib.widgets import Button, TextBox

        super().__init__(app, "Picks", figsize=(4.6, 3.4))
        fig = self.fig
        fig.text(0.04, 0.92, "Picks", fontsize=11, fontweight="bold")
        self.current = 0

        ax = fig.add_axes([0.04, 0.72, 0.20, 0.10])
        self.prev_button = Button(ax, "prev")
        self.prev_button.on_clicked(
            self._guarded(lambda ev: self.step(-1))
        )
        ax = fig.add_axes([0.28, 0.72, 0.20, 0.10])
        self.next_button = Button(ax, "next")
        self.next_button.on_clicked(
            self._guarded(lambda ev: self.step(1))
        )
        self._label = fig.text(0.54, 0.76, "", fontsize=9)

        ax = fig.add_axes([0.04, 0.54, 0.28, 0.10])
        self.trace_button = Button(ax, "trace")
        self.trace_button.on_clicked(
            self._guarded(lambda ev: self.app.plot_trace(self.current))
        )
        ax = fig.add_axes([0.36, 0.54, 0.28, 0.10])
        self.scatter_button = Button(ax, "scatter")
        self.scatter_button.on_clicked(
            self._guarded(lambda ev: self.app.show_pick(self.current))
        )
        ax = fig.add_axes([0.68, 0.54, 0.28, 0.10])
        self.scatter3d_button = Button(ax, "3D")
        self.scatter3d_button.on_clicked(
            self._guarded(
                lambda ev: self.app.show_pick_3d(self.current)
            )
        )

        fig.text(0.04, 0.42, "Filter by loc count", fontsize=9,
                 color="0.35")
        ax = fig.add_axes([0.26, 0.28, 0.16, 0.10])
        self.min_locs = TextBox(ax, "min ", initial="0")
        ax = fig.add_axes([0.58, 0.28, 0.16, 0.10])
        self.max_locs = TextBox(ax, "max ", initial="")
        ax = fig.add_axes([0.78, 0.28, 0.18, 0.10])
        self.filter_button = Button(ax, "apply")
        self.filter_button.on_clicked(
            self._guarded(lambda ev: self.apply_filter())
        )
        ax = fig.add_axes([0.04, 0.08, 0.34, 0.12])
        self.clear_button = Button(ax, "clear all")
        self.clear_button.on_clicked(
            self._guarded(lambda ev: self._clear())
        )
        self._status = fig.text(0.44, 0.12, "", fontsize=8)
        self.sync()

    def step(self, delta: int):
        """Move to the previous/next pick, recentering the view
        (Tools > Move to pick, gui/render.py:11942)."""
        n = len(self.app.picks)
        if not n:
            return
        self.current = (self.current + delta) % n
        self.app.move_to_pick(self.current)
        self.sync()

    def apply_filter(self) -> int:
        """Tools > Filter picks by loc count."""
        self.app.filter_picks(
            min_locs=int(_parse_float(self.min_locs.text) or 0),
            max_locs=(
                None if _parse_float(self.max_locs.text) is None
                else int(_parse_float(self.max_locs.text))
            ),
        )
        self.current = 0
        self.sync()
        n = len(self.app.picks)
        self._status.set_text(f"{n} picks kept")
        return n

    def _clear(self):
        self.app.clear_picks()
        self.current = 0
        self.sync()

    def sync(self):
        n = len(self.app.picks)
        self.current = min(self.current, max(n - 1, 0))
        self._label.set_text(
            f"pick {self.current + 1}/{n}" if n else "no picks"
        )
        self.fig.canvas.draw_idle()
