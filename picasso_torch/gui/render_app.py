"""The full-workflow super-resolution viewer of the port
(picasso_tpu/gui/render_app.py; the reference's flagship app
picasso/gui/render.py: View :6883, Window :11654, and its dialogs
DisplaySettingsDialog :6030, ToolsSettingsDialog :5688,
MaskSettingsDialog :4992, SlicerDialog :6610, FastRenderDialog :6519,
InfoDialog :4295, DatasetDialog :378).

A matplotlib canvas stands for the Qt view, and every menu action is a
method, so a scripted session (a test, a notebook) runs pick -> undrift
-> cluster -> RESI without a display. Each analysis action is the
library call a script would make, on the port's own modules and on
``device`` (the card by default; without one the first render raises,
as every entry point of the port does): the renders (render.render_scene,
render.render), postprocess, aim, clusterer, masking, imageprocess, g5m
and gui.apps.RotationApp. Picks, the undo stack and the overlays are
host state. matplotlib is imported in the constructor.

Locs are numpy structured arrays where the JAX package's app holds
DataFrames, and each DataFrame idiom has its array form: a column
assigned takes the dtype of the values (lib.append_to_rec), as a
DataFrame's does, so an expression that makes a column f64 (``spiral``,
``x = x + frame``) leaves it f64 as in JAX; the undo stack holds the
arrays it replaced; the pick profile's CSV is pandas' to_csv of the
profiles side by side (lib.write_table, shorter columns padded with
empty cells); ``uspiral`` restores the rows that ``spiral`` kept, as
JAX's index alignment does.

What differs from JAX's app: RCC's status log has no per-segment lines
(postprocess.undrift takes no callbacks in the port); JAX's class
defines ``open_rotation_window`` twice and Python keeps the second, so
the port has that one only; ``unfold_groups_square`` takes the table and
the info (the new Width and Height) that lib.unfold_localizations_square
returns, where JAX's stores the pair as the channel's locs and its next
redraw raises KeyError.
"""

from __future__ import annotations

import os

import numpy as np

from picasso_torch import io, lib, render, spatial_index
from picasso_torch.gui.base import StatusLog, _has, _n_groups, _PluginHost

PICK_SHAPES = ("Circle", "Rectangle", "Polygon", "Square")

# Fraction of the view moved by the pan actions and the zoom step
# (reference gui/render.py:11862-11883 Left/Right/Up/Down + zoom 10/7).
PAN_FRACTION = 0.8
ZOOM_STEP = 10 / 7


def _stack(locs: np.ndarray, names) -> np.ndarray:
    """DataFrame.to_numpy of the columns ``names``."""
    return np.column_stack([locs[n] for n in names])


class Channel:
    """One open locs file (reference DatasetDialog row,
    gui/render.py:378): table + info chain + display state."""

    def __init__(self, locs, info, path="", color=None):
        self.locs = locs
        self.info = list(info)
        self.path = path
        self.color = color  # (r, g, b) floats or None -> auto
        self.visible = True
        self.relative_intensity = 1.0
        self.drift = None
        # (label, locs, info) before each action; every action assigns
        # new arrays and lists, so the entries stay as they were
        self._undo: list[tuple[str, np.ndarray, list[dict]]] = []
        self.rebuild_index()

    def rebuild_index(self):
        try:
            self.index = spatial_index.build_render_index(self.locs,
                                                          self.info)
        except Exception:
            self.index = None

    def push_undo(self, label: str):
        self._undo.append((label, self.locs, self.info))

    def pop_undo(self) -> str | None:
        if not self._undo:
            return None
        label, self.locs, self.info = self._undo.pop()
        self.rebuild_index()
        return label


class RenderApp(_PluginHost):
    """Super-resolution viewer + workflow controller.

    Covers the reference Render app's menu surface
    (picasso/gui/render.py:11764-12101): File (open/save/export),
    View (display settings, info, slicer), Tools (pick shapes, pick
    similar, fiducials, traces, filter picks, masking, fast render)
    and Postprocess (undrift AIM/RCC/picked, drift management, link,
    align, combine, clustering, NN analysis, RESI).
    """

    def __init__(self, locs: np.ndarray, info: list[dict],
                 blur_method: str | None = "smooth", colormap: str = "hot",
                 oversampling: float = 8.0, fig=None, status_callback=None,
                 device="cuda"):
        import matplotlib.pyplot as plt  # noqa: F401

        self.device = device
        self.channels: list[Channel] = [Channel(locs, info)]
        self.current_channel = 0
        self.blur_method = blur_method
        self.colormap = colormap
        self.oversampling = oversampling
        self.dynamic_oversampling = True
        self.min_blur_width = 0.0
        self.contrast: tuple[float, float] | None = None  # None=auto
        self.invert_colors = False
        self.fast_render_fraction = 1.0  # FastRenderDialog :6519
        self._fast_render_masks: dict[int, np.ndarray] = {}
        self.status = StatusLog(status_callback)

        # tools state (ToolsSettingsDialog :5688)
        self.pick_shape = "Circle"
        self.pick_diameter = 1.0  # Circle: diameter [px]
        self.pick_width = 1.0  # Rectangle: width [px]
        self.pick_side = 1.0  # Square: side length [px]
        self.picks: list = []
        self._polygon_in_progress: list = []

        # interactive tool state (reference Tools menu Zoom/Pick/
        # Measure + View mouse handlers, gui/render.py:6883)
        self.tool = "zoom"  # "zoom" | "pick" | "measure"
        self.measure_points: list[tuple[float, float]] = []
        self._drag: dict | None = None
        self._rubber = None  # transient drag-overlay artist
        self._contrast_limits: tuple[float, float] | None = None

        # FRC state (InfoDialog FRC group box :4480)
        self.frc_result: dict = {}

        # slicer state (SlicerDialog :6610)
        self.slicer_on = False
        self.slice_thickness = 50.0  # nm
        self.slice_position = 0

        height = lib.get_from_metadata(info, "Height")
        width = lib.get_from_metadata(info, "Width")
        self.viewport = ((0.0, 0.0), (float(height), float(width)))
        self.fig = fig or self._new_fig(figsize=(8, 8))
        self.ax = self.fig.add_subplot(111)
        self._im = None
        self.last_image: np.ndarray | None = None
        canvas = self.fig.canvas
        canvas.mpl_connect("scroll_event", self._on_scroll)
        canvas.mpl_connect("button_press_event", self._on_click)
        canvas.mpl_connect("key_press_event", self._on_key)
        canvas.mpl_connect("motion_notify_event", self._on_motion)
        canvas.mpl_connect("button_release_event", self._on_release)
        self._init_plugins("render")
        self.redraw()

    # ------------------------------------------------------------------
    # channels (File menu + DatasetDialog, gui/render.py:378, 11765)
    # ------------------------------------------------------------------
    @property
    def channel(self) -> Channel:
        return self.channels[self.current_channel]

    @property
    def locs(self) -> np.ndarray:
        return self.channel.locs

    @locs.setter
    def locs(self, value):
        self.channel.locs = value
        self.channel.rebuild_index()

    @property
    def info(self) -> list[dict]:
        return self.channel.info

    @info.setter
    def info(self, value):
        self.channel.info = list(value)

    @property
    def index(self):
        return self.channel.index

    def _channel_at(self, channel: int | None) -> Channel:
        return self.channels[self.current_channel if channel is None
                             else channel]

    def _visible_channels(self) -> list[int]:
        return [i for i, ch in enumerate(self.channels) if ch.visible]

    def _pixelsize(self, info=None) -> float:
        return lib.get_from_metadata(self.info if info is None else info,
                                     "Pixelsize", 130)

    def add_channel(self, locs, info, path="", color=None) -> int:
        """Add a locs dataset as a new display channel
        (reference File > Open with an existing file open)."""
        self.channels.append(Channel(locs, info, path, color))
        self.status(f"Added channel {len(self.channels) - 1} "
                    f"({path or 'memory'})")
        return len(self.channels) - 1

    def open_file(self, path: str) -> int:
        locs, info = io.load_locs(path)
        if len(self.channels) == 1 and len(self.channels[0].locs) == 0:
            self.channels[0] = Channel(locs, info, path)
            return 0
        return self.add_channel(locs, info, path)

    def remove_channel(self, i: int):
        if len(self.channels) == 1:
            raise ValueError("Cannot remove the last channel.")
        del self.channels[i]
        self.current_channel = min(self.current_channel,
                                   len(self.channels) - 1)
        self._fast_render_masks.clear()

    def set_channel_visible(self, i: int, visible: bool):
        self.channels[i].visible = bool(visible)

    def set_channel_color(self, i: int, color):
        self.channels[i].color = color

    def set_channel_intensity(self, i: int, rel: float):
        """Relative intensity slider (DatasetDialog :378)."""
        self.channels[i].relative_intensity = float(rel)

    def save_locs(self, path: str, channel: int | None = None):
        ch = self._channel_at(channel)
        io.save_locs(path, ch.locs, ch.info)
        self.status(f"Saved {len(ch.locs)} locs to {path}")

    def remove_all_locs(self):
        """File > Remove all localizations (gui/render.py:11834)."""
        self.channels = [Channel(self.locs[:0].copy(), self.info)]
        self.current_channel = 0
        self.picks = []
        self._fast_render_masks.clear()

    # ------------------------------------------------------------------
    # display settings (DisplaySettingsDialog, gui/render.py:6030)
    # ------------------------------------------------------------------
    def set_blur(self, method: str | None):
        assert method in (None, "gaussian", "gaussian_iso", "smooth",
                          "convolve")
        self.blur_method = method
        self.redraw()

    def set_colormap(self, name: str):
        self.colormap = name
        self.redraw()

    def register_colormap(self, name: str, colors, set_active=True):
        """Build and register a custom single-channel colormap from a
        list of anchor colors (the reference's CustomColormapDialog,
        gui/render.py:1011, which interpolates between user-picked
        RGB anchors). ``colors`` is a sequence of matplotlib colors
        (names, hex or RGB tuples); evenly spaced anchors."""
        import matplotlib
        from matplotlib.colors import LinearSegmentedColormap

        cmap = LinearSegmentedColormap.from_list(name, list(colors))
        matplotlib.colormaps.register(cmap, name=name, force=True)
        if set_active:
            self.set_colormap(name)
        return cmap

    def set_contrast(self, vmin: float | None, vmax: float | None):
        """Manual contrast limits; (None, None) re-enables autoscale."""
        self.contrast = (None if vmin is None and vmax is None
                         else (vmin, vmax))
        self.redraw()

    def set_min_blur_width(self, width: float):
        self.min_blur_width = float(width)
        self.redraw()

    def set_oversampling(self, value: float, dynamic: bool = False):
        self.oversampling = float(value)
        self.dynamic_oversampling = bool(dynamic)
        self.redraw()

    def set_invert_colors(self, invert: bool):
        self.invert_colors = bool(invert)
        self.redraw()

    def set_pixelsize(self, nm: float):
        """Camera pixel size (DisplaySettingsDialog camera group,
        reference gui/render.py:6030): written into every channel's
        metadata chain so all nm conversions (blur widths, scalebar,
        FRC/NeNA reporting) follow."""
        nm = float(nm)
        for ch in self.channels:
            for entry in ch.info:
                if isinstance(entry, dict) and "Pixelsize" in entry:
                    entry["Pixelsize"] = nm
                    break
            else:
                if ch.info and isinstance(ch.info[0], dict):
                    ch.info[0]["Pixelsize"] = nm
        self.redraw()

    def set_scalebar(self, show: bool | None = None,
                     length_nm: float | None = ...,
                     text: bool | None = None,
                     optimal: bool | None = None):
        """Scale bar group of the display settings (reference
        gui/render.py:6030): ``length_nm=None`` means automatic
        (optimal) length; pass ``...`` to leave the length unchanged."""
        if show is not None:
            self.show_scalebar = bool(show)
        if length_nm is not ...:
            self.scalebar_length_nm = (None if length_nm is None
                                       else float(length_nm))
        if optimal is not None and optimal:
            self.scalebar_length_nm = None
        if text is not None:
            self.scalebar_text = bool(text)
        self.redraw()

    def set_minimap(self, show: bool):
        """Minimap checkbox (DisplaySettingsDialog general group)."""
        self.show_minimap = bool(show)
        self.redraw()

    def set_legend(self, show: bool):
        """Legend checkbox (DatasetDialog, reference
        gui/render.py:378)."""
        self.show_legend = bool(show)
        self.redraw()

    def set_fast_render(self, fraction: float, seed: int = 0):
        """Display a random locs subsample while navigating
        (FastRenderDialog, gui/render.py:6519)."""
        assert 0 < fraction <= 1
        self.fast_render_fraction = float(fraction)
        self._fast_render_masks = {}
        if fraction < 1:
            rng = np.random.default_rng(seed)
            for i, ch in enumerate(self.channels):
                self._fast_render_masks[i] = rng.random(len(ch.locs)
                                                        ) < fraction
        self.redraw()

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------
    def _display_locs(self, i: int) -> np.ndarray:
        """Channel i's locs restricted to viewport / subsample /
        z slice."""
        ch = self.channels[i]
        locs = ch.locs
        mask = self._fast_render_masks.get(i)
        if mask is not None and len(mask) == len(locs):
            locs = locs[mask]
        if ch.index is not None and mask is None:
            idx = spatial_index.query_viewport(ch.index, self.viewport)
            if idx is not None:
                locs = ch.locs[idx]
        if self.slicer_on and _has(locs, "z"):
            z_lo, z_hi = self.slice_range()
            z = locs["z"]
            locs = locs[(z >= z_lo) & (z < z_hi)]
        return locs

    def _visible_locs(self) -> np.ndarray:
        return self._display_locs(self.current_channel)

    def set_render_property(self, parameter: str | None, n_colors: int = 32,
                            min_value: float | None = None,
                            max_value: float | None = None,
                            colormap: str = "viridis"):
        """Display settings > Render by property (reference
        gui/render.py:10814 activate_render_property +
        render.split_locs_by_property): color the active channel's
        localizations by a column value (frame, z, photons, …) in
        ``n_colors`` bins of the given colormap. ``parameter=None``
        deactivates."""
        if parameter is not None:
            assert _has(self.locs, parameter), parameter
        self.render_property = None if parameter is None else {
            "parameter": parameter,
            "n_colors": int(n_colors),
            "min_value": min_value,
            "max_value": max_value,
            "colormap": colormap,
        }
        self.redraw()

    def clear_render_property(self):
        self.set_render_property(None)

    def _property_scene(self, prop):
        """Render the active channel split into property bins as a
        multi-channel composite."""
        import matplotlib.pyplot as plt

        ch = self.channel
        parts = render.split_locs_by_property(
            self._display_locs(self.current_channel),
            property_name=prop["parameter"], n_colors=prop["n_colors"],
            min_value=prop["min_value"], max_value=prop["max_value"])
        cmap = plt.get_cmap(prop["colormap"])
        colors = [tuple(cmap(k / max(prop["n_colors"] - 1, 1))[:3])
                  for k in range(prop["n_colors"])]
        rgb, n, self._contrast_limits = render.render_scene(
            parts, [ch.info] * len(parts), colors=colors,
            disp_px_size=self._pixelsize(ch.info) / self.oversampling,
            viewport=self.viewport, blur_method=self.blur_method,
            min_blur_width=self.min_blur_width, contrast=self.contrast,
            invert_colors=self.invert_colors, return_contrast_limits=True,
            device=self.device)
        return rgb, n

    def render_scene(self) -> tuple[np.ndarray, int]:
        """Current view as an RGB uint8 array (render.render_scene)."""
        prop = getattr(self, "render_property", None)
        if prop is not None:
            return self._property_scene(prop)
        vis = self._visible_channels() or [self.current_channel]
        disp_px = self._pixelsize(self.channels[vis[0]].info
                                  ) / self.oversampling
        kwargs = dict(disp_px_size=disp_px, viewport=self.viewport,
                      blur_method=self.blur_method,
                      min_blur_width=self.min_blur_width,
                      contrast=self.contrast,
                      invert_colors=self.invert_colors,
                      return_contrast_limits=True, device=self.device)
        if len(vis) == 1:
            i = vis[0]
            rgb, n, self._contrast_limits = render.render_scene(
                self._display_locs(i), self.channels[i].info,
                single_channel_colormap=self.colormap, **kwargs)
        else:
            colors = [
                self.channels[i].color if self.channels[i].color is not None
                else tuple(render.get_colors_from_colormap(len(vis))[k])
                for k, i in enumerate(vis)]
            rgb, n, self._contrast_limits = render.render_scene(
                [self._display_locs(i) for i in vis],
                [self.channels[i].info for i in vis], colors=colors,
                relative_intensities=[self.channels[i].relative_intensity
                                      for i in vis], **kwargs)
        return rgb, n

    def redraw(self):
        rgb, n = self.render_scene()
        self.last_image = rgb
        (y_min, x_min), (y_max, x_max) = self.viewport
        self.ax.clear()
        self._im = self.ax.imshow(rgb, extent=(x_min, x_max, y_max, y_min),
                                  interpolation="nearest")
        self._draw_picks()
        self._draw_overlays()
        title = f"{n} localizations"
        if self.slicer_on:
            z_lo, z_hi = self.slice_range()
            title += f" | slice [{z_lo:.0f}, {z_hi:.0f}) nm"
        if len(self.channels) > 1:
            title += f" | {len(self.channels)} channels"
        self.ax.set_title(title)
        self.fig.canvas.draw_idle()
        return n

    def _draw_overlays(self):
        """Display-settings overlays (reference
        DisplaySettingsDialog :6030 scalebar group, DatasetDialog
        legend checkbox :935, minimap :7313): scalebar with optional
        optimal length, per-channel legend, and a minimap inset
        showing the viewport within the full FOV."""
        import matplotlib.patches as mpatches

        (y_min, x_min), (y_max, x_max) = self.viewport
        w = x_max - x_min
        h = y_max - y_min
        pixelsize = self._pixelsize()
        if getattr(self, "show_scalebar", False):
            length_nm = getattr(self, "scalebar_length_nm", None)
            if not length_nm:
                length_nm = render.optimal_scalebar_length(pixelsize, w)
            length_px = length_nm / pixelsize
            x1 = x_max - 0.05 * w
            x0 = x1 - length_px
            ybar = y_max - 0.05 * h
            self.ax.plot([x0, x1], [ybar, ybar], color="white", lw=3,
                         solid_capstyle="butt")
            if getattr(self, "scalebar_text", True):
                label = (f"{length_nm / 1000:g} um" if length_nm >= 1000
                         else f"{length_nm:g} nm")
                self.ax.annotate(label, ((x0 + x1) / 2, ybar - 0.02 * h),
                                 color="white", ha="center", va="bottom",
                                 fontsize=8)
        if getattr(self, "show_legend", False) and len(self.channels) > 1:
            vis = self._visible_channels()
            auto = render.get_colors_from_colormap(max(len(vis), 1))
            for k, i in enumerate(vis):
                ch = self.channels[i]
                color = ch.color if ch.color is not None else tuple(auto[k])
                name = ch.path and os.path.basename(ch.path) or (
                    f"channel {i}")
                self.ax.annotate(
                    name, (x_min + 0.02 * w, y_min + (0.04 + 0.05 * k) * h),
                    color=color, fontsize=8, va="top")
        if getattr(self, "show_minimap", False):
            full_h = lib.get_from_metadata(self.info, "Height")
            full_w = lib.get_from_metadata(self.info, "Width")
            inset = self.ax.inset_axes([0.78, 0.78, 0.2, 0.2])
            inset.set_xlim(0, full_w)
            inset.set_ylim(full_h, 0)
            inset.set_xticks([])
            inset.set_yticks([])
            inset.set_facecolor("black")
            inset.add_patch(mpatches.Rectangle(
                (x_min, y_min), w, h, fill=False, edgecolor="white",
                linewidth=1.0))
            self._minimap_ax = inset

    def _draw_picks(self):
        import matplotlib.patches as mpatches

        style = dict(fill=False, edgecolor="yellow")
        for pick in self.picks:
            if self.pick_shape == "Circle":
                self.ax.add_patch(mpatches.Circle(
                    pick, self.pick_diameter / 2, **style))
            elif self.pick_shape == "Square":
                x, y = pick
                s = self.pick_side
                self.ax.add_patch(mpatches.Rectangle(
                    (x - s / 2, y - s / 2), s, s, **style))
            elif self.pick_shape == "Rectangle":
                (xs, ys), (xe, ye) = pick
                X, Y = lib.get_pick_rectangle_corners(xs, ys, xe, ye,
                                                      self.pick_width)
                self.ax.add_patch(mpatches.Polygon(
                    np.column_stack([X, Y]), closed=True, **style))
            elif self.pick_shape == "Polygon":
                pts = np.asarray(pick, dtype=float)
                if len(pts) >= 2:
                    self.ax.add_patch(mpatches.Polygon(pts, closed=True,
                                                       **style))
        if getattr(self, "annotate_picks", False):
            # Tools settings > Annotate picks (reference
            # ToolsSettingsDialog): draw the pick index at its center
            for i, pick in enumerate(self.picks):
                cx, cy = self._pick_center(pick)
                self.ax.annotate(str(i), (cx, cy), color="yellow",
                                 fontsize=8, ha="center", va="center")
        if self._polygon_in_progress:
            pts = np.asarray(self._polygon_in_progress, dtype=float)
            self.ax.plot(pts[:, 0], pts[:, 1], "y.-", lw=0.8)
        if self.measure_points:
            pts = np.asarray(self.measure_points, dtype=float)
            self.ax.plot(pts[:, 0], pts[:, 1], "c+-", lw=0.8)

    # ------------------------------------------------------------------
    # view navigation (gui/render.py:11862-11887)
    # ------------------------------------------------------------------
    def pan(self, dy_frac: float, dx_frac: float):
        h = render.viewport_height(self.viewport)
        w = render.viewport_width(self.viewport)
        self.viewport = render.shift_viewport(self.viewport, dy_frac * h,
                                              dx_frac * w)
        self.redraw()

    def pan_left(self):
        self.pan(0, -PAN_FRACTION)

    def pan_right(self):
        self.pan(0, PAN_FRACTION)

    def pan_up(self):
        self.pan(-PAN_FRACTION, 0)

    def pan_down(self):
        self.pan(PAN_FRACTION, 0)

    def _follow_zoom(self):
        """Dynamic oversampling: 8 at the full height, more zoomed in."""
        if self.dynamic_oversampling:
            h = render.viewport_height(self.viewport)
            full_h = lib.get_from_metadata(self.info, "Height")
            self.oversampling = max(1.0, 8.0 * full_h / max(h, 1e-6))

    def zoom(self, factor: float, center=None):
        self.viewport = render.zoom_viewport(self.viewport, factor, center)
        self._follow_zoom()
        self.redraw()

    def zoom_in(self):
        self.zoom(1 / ZOOM_STEP)

    def zoom_out(self):
        self.zoom(ZOOM_STEP)

    def _full_view(self):
        height = lib.get_from_metadata(self.info, "Height")
        width = lib.get_from_metadata(self.info, "Width")
        return ((0.0, 0.0), (float(height), float(width)))

    def fit_in_view(self):
        self.viewport = self._full_view()
        if self.dynamic_oversampling:
            self.oversampling = 8.0
        self.redraw()

    def export_view(self, path: str):
        """File > Export current view (gui/render.py:12144)."""
        if self.last_image is None:
            self.redraw()
        render._export_image(self.last_image, path)
        base, _ = os.path.splitext(path)
        io.save_info(base + ".yaml", self.info + [{
            "Generated by": "picasso-tpu Render : Export view",
            "Viewport": [list(self.viewport[0]), list(self.viewport[1])],
            "Oversampling": float(self.oversampling),
            "Blur method": self.blur_method,
            "Colormap": self.colormap,
        }])

    def export_complete(self, path: str):
        """File > Export complete image (gui/render.py:12289)."""
        saved = self.viewport
        try:
            self.viewport = self._full_view()
            rgb, _ = self.render_scene()
            render._export_image(rgb, path)
        finally:
            self.viewport = saved

    # ------------------------------------------------------------------
    # info / metadata (InfoDialog gui/render.py:4295)
    # ------------------------------------------------------------------
    def show_info(self) -> dict:
        locs = self._visible_locs()
        (y_min, x_min), (y_max, x_max) = self.viewport
        out = {
            "Display pixels": None if self.last_image is None else
            list(self.last_image.shape[:2]),
            "Viewport": [[y_min, x_min], [y_max, x_max]],
            "Locs in view": int(len(locs)),
            "Channels": len(self.channels),
            "Picks": len(self.picks),
        }
        if len(locs):
            area = (y_max - y_min) * (x_max - x_min)
            out["Density (1/um^2)"] = float(
                len(locs) / area * 1e6 / self._pixelsize() ** 2
            ) if area > 0 else 0.0
            for col in ("lpx", "lpy"):
                if _has(locs, col):
                    out[f"Median {col} (px)"] = float(np.median(locs[col]))
        return out

    def show_metadata(self) -> list[dict]:
        return self.info

    def calculate_frc(self, save_images: str | None = None) -> dict:
        """FRC resolution of the current FOV (InfoDialog's FRC group
        box, gui/render.py:4480-4497): split locs in view into random
        halves, render, Fourier-ring-correlate, report the 1/7
        crossing. Stores the curve for :meth:`plot_frc`."""
        from picasso_torch import postprocess

        result = postprocess.frc(self.locs, self.info, self.viewport,
                                 device=self.device)
        self.frc_result = result
        res = result["resolution"]
        if res is None:
            self.status("FRC: no 1/7 threshold crossing found")
        else:
            self.status(f"FRC resolution = {res:.1f} nm")
        if save_images:
            im1, im2 = result["images"]
            base, _ = os.path.splitext(save_images)
            for tag, im in (("half1", im1), ("half2", im2)):
                np.save(f"{base}_{tag}.npy", np.asarray(im))
        return result

    def plot_frc(self, fig=None):
        """FRC curve window (FRCPlotWindow gui/render.py:4315):
        raw + smoothed curve vs spatial frequency with the 1/7
        threshold and the resolution crossing marked."""
        if not getattr(self, "frc_result", None):
            self.calculate_frc()
        result = self.frc_result
        fig = fig or self._new_fig(figsize=(6, 4))
        ax = fig.add_subplot(111)
        freqs = result["frequencies"]
        ax.plot(freqs, result["frc_curve"], lw=0.8, alpha=0.5, label="FRC")
        ax.plot(freqs, result["frc_curve_smooth"], lw=1.5,
                label="FRC (smoothed)")
        ax.axhline(1 / 7, color="k", ls="--", lw=0.8, label="1/7")
        res = result["resolution"]
        if res is not None:
            ax.axvline(1 / res, color="r", ls=":", lw=0.8)
            ax.set_title(f"FRC resolution: {res:.1f} nm")
        ax.set_xlabel("Spatial frequency (1/nm)")
        ax.set_ylabel("FRC")
        ax.legend(loc="upper right", fontsize=8)
        return fig

    def calculate_nena(self) -> dict:
        """NeNA precision of the active channel (InfoDialog's
        'Calculate' button, gui/render.py:4533)."""
        from picasso_torch import postprocess

        best_values, lp = postprocess.nena(self.locs, self.info,
                                           device=self.device)
        self.status(f"NeNA lp = {lp:.4f} px")
        return {"lp": float(lp), "best_values": best_values}

    # ------------------------------------------------------------------
    # slicer (SlicerDialog gui/render.py:6610)
    # ------------------------------------------------------------------
    def z_range(self) -> tuple[float, float]:
        z = self.locs["z"]
        return float(z.min()), float(z.max())

    def n_slices(self) -> int:
        z_lo, z_hi = self.z_range()
        return max(1, int(np.ceil((z_hi - z_lo) / self.slice_thickness)))

    def slice_range(self) -> tuple[float, float]:
        z_lo, _ = self.z_range()
        lo = z_lo + self.slice_position * self.slice_thickness
        return lo, lo + self.slice_thickness

    def start_slicer(self, thickness_nm: float = 50.0):
        if not _has(self.locs, "z"):
            raise ValueError("Slicer requires 3D locs (a 'z' column).")
        self.slice_thickness = float(thickness_nm)
        self.slice_position = 0
        self.slicer_on = True
        self.redraw()

    def stop_slicer(self):
        self.slicer_on = False
        self.redraw()

    def set_slice(self, position: int):
        self.slice_position = int(np.clip(position, 0, self.n_slices() - 1))
        self.redraw()

    def next_slice(self):
        self.set_slice(self.slice_position + 1)

    def previous_slice(self):
        self.set_slice(self.slice_position - 1)

    def export_slices(self, basepath: str) -> list[str]:
        """Export every z slice as PNG (SlicerDialog.export_stack,
        gui/render.py:6855)."""
        paths = []
        saved = self.slice_position
        try:
            for i in range(self.n_slices()):
                self.set_slice(i)
                path = f"{basepath}_Z{i:03d}.png"
                render._export_image(self.last_image, path)
                paths.append(path)
        finally:
            self.set_slice(saved)
        return paths

    # ------------------------------------------------------------------
    # picking tools (gui/render.py:11904-11990)
    # ------------------------------------------------------------------
    def set_pick_shape(self, shape: str):
        assert shape in PICK_SHAPES, f"Invalid pick shape: {shape}"
        if shape != self.pick_shape and self.picks:
            self.status("Pick shape changed — clearing picks")
            self.picks = []
        self.pick_shape = shape
        self._polygon_in_progress = []

    @property
    def _pick_size(self) -> float | None:
        """pick_size argument for postprocess.picked_locs."""
        if self.pick_shape == "Circle":
            return self.pick_diameter / 2
        if self.pick_shape == "Rectangle":
            return self.pick_width
        if self.pick_shape == "Square":
            return self.pick_side
        return None

    @property
    def _pick_size_by_diameter(self) -> float | None:
        """pick_size of the calls that take a circle's diameter
        (remove/combine locs in picks, lib.pick_areas)."""
        return (self.pick_diameter if self.pick_shape == "Circle"
                else self._pick_size)

    def add_pick(self, pick, redraw: bool = True):
        if self.pick_shape == "Polygon":
            pts = [tuple(map(float, p)) for p in pick]
            if len(pts) >= 3 and pts[0] != pts[-1]:
                pts.append(pts[0])
            self.picks.append(pts)
        elif self.pick_shape == "Rectangle":
            (xs, ys), (xe, ye) = pick
            self.picks.append(((float(xs), float(ys)),
                               (float(xe), float(ye))))
        else:
            self.picks.append((float(pick[0]), float(pick[1])))
        if redraw:
            self.redraw()

    def add_polygon_point(self, x: float, y: float, close_tol=0.3):
        """Incremental polygon picking: clicking near the first vertex
        closes the polygon (reference View.add_polygon_point,
        gui/render.py pick handling)."""
        pts = self._polygon_in_progress
        if len(pts) >= 3 and np.hypot(x - pts[0][0],
                                      y - pts[0][1]) < close_tol:
            self._polygon_in_progress = []
            self.add_pick(pts + [pts[0]])
            return True
        pts.append((float(x), float(y)))
        self.redraw()
        return False

    def remove_closest_pick(self, x: float, y: float):
        """Alt-click removes the nearest pick (reference View)."""
        if not self.picks:
            return
        centers = np.array([self._pick_center(p) for p in self.picks])
        i = int(np.argmin((centers[:, 0] - x) ** 2
                          + (centers[:, 1] - y) ** 2))
        del self.picks[i]
        self.redraw()

    def _pick_center(self, pick) -> tuple[float, float]:
        if self.pick_shape in ("Circle", "Square"):
            return tuple(map(float, pick))
        arr = np.asarray(pick if self.pick_shape == "Polygon"
                         else list(pick), dtype=float)
        return float(arr[..., 0].mean()), float(arr[..., 1].mean())

    def clear_picks(self):
        self.picks = []
        self._polygon_in_progress = []
        self.redraw()

    def picked_locs(self, channel: int | None = None, add_group: bool = True
                    ) -> list[np.ndarray]:
        from picasso_torch import postprocess

        ch = self._channel_at(channel)
        return postprocess.picked_locs(ch.locs, ch.info, self.picks,
                                       self.pick_shape,
                                       pick_size=self._pick_size,
                                       add_group=add_group)

    def pick_similar(self, std_range: float = 2.0):
        """Tools > Pick similar (gui/render.py:9965) — circles only,
        like the reference."""
        from picasso_torch import postprocess

        if self.pick_shape != "Circle":
            raise ValueError("Pick similar requires circular picks.")
        if not self.picks:
            raise ValueError("Pick at least one region first.")
        self.picks = [tuple(p) for p in postprocess.pick_similar(
            self.locs, self.info, self.picks, d=self.pick_diameter,
            std_range=std_range, device=self.device)]
        self.status(f"{len(self.picks)} similar picks")
        self.redraw()
        return len(self.picks)

    def pick_fiducials(self):
        """Tools > Pick fiducials (gui/render.py:11949)."""
        from picasso_torch import imageprocess

        picks, box = imageprocess.find_fiducials(self.locs, self.info,
                                                 device=self.device)
        self.set_pick_shape("Circle")
        self.pick_diameter = float(box)
        self.picks = [tuple(map(float, p)) for p in picks]
        self.redraw()
        return len(self.picks)

    def move_to_pick(self, i: int):
        """Tools > Move to pick (gui/render.py:8306)."""
        cx, cy = self._pick_center(self.picks[i])
        h = render.viewport_height(self.viewport)
        w = render.viewport_width(self.viewport)
        self.viewport = ((cy - h / 2, cx - w / 2), (cy + h / 2, cx + w / 2))
        self.redraw()

    def filter_picks(self, min_locs: int = 0, max_locs: int | None = None):
        """Tools > Filter picks by locs number (gui/render.py:9708)."""
        counts = [len(p) for p in self.picked_locs(add_group=False)]
        hi = np.inf if max_locs is None else max_locs
        self.picks = [pick for pick, n in zip(self.picks, counts)
                      if min_locs <= n <= hi]
        self.redraw()
        return len(self.picks)

    def subtract_pick_regions(self, path: str):
        """Tools > Subtract pick regions (gui/render.py:8751): drop
        picks whose center falls inside any region of the file."""
        other, shape, size = io.load_picks(path, self._pixelsize())
        keep = []
        for pick in self.picks:
            cx, cy = self._pick_center(pick)
            if not self._inside_any(cx, cy, other, shape, size):
                keep.append(pick)
        removed = len(self.picks) - len(keep)
        self.picks = keep
        self.status(f"Subtracted {removed} picks")
        self.redraw()
        return removed

    @staticmethod
    def _inside_any(cx, cy, other, shape, size) -> bool:
        """Whether (cx, cy) lies in a region of ``other`` (picks of
        ``shape`` and ``size`` as io.load_picks gives them)."""
        if shape == "Circle":
            r = (size or 0) / 2
            return any((cx - ox) ** 2 + (cy - oy) ** 2 < r * r
                       for ox, oy in other)
        if shape == "Square":
            half = (size or 0) / 2
            return any(abs(cx - ox) < half and abs(cy - oy) < half
                       for ox, oy in other)
        if shape == "Rectangle":
            for (xs, ys), (xe, ye) in other:
                X, Y = lib.get_pick_rectangle_corners(xs, ys, xe, ye, size)
                if lib.check_if_in_rectangle(np.array([cx]), np.array([cy]),
                                             np.array(X), np.array(Y))[0]:
                    return True
            return False
        for poly in other:  # Polygon
            X, Y = lib.get_pick_polygon_corners([tuple(p) for p in poly])
            if X is None:
                continue
            if lib.check_if_in_polygon(np.array([cx]), np.array([cy]),
                                       np.asarray(X), np.asarray(Y))[0]:
                return True
        return False

    def remove_locs_in_picks(self):
        """Tools > Remove localizations in picks
        (gui/render.py:11939)."""
        from picasso_torch import postprocess

        ch = self.channel
        ch.push_undo("remove locs in picks")
        ch.locs = postprocess.remove_locs_in_picks(
            ch.locs, ch.info, picks=self.picks, pick_shape=self.pick_shape,
            pick_size=self._pick_size_by_diameter)
        ch.info = ch.info + [{
            "Generated by": "picasso-tpu Render : Remove locs in picks",
            "Number of picks": len(self.picks),
        }]
        ch.rebuild_index()
        self.redraw()

    def show_trace(self, pick_index: int = 0) -> dict:
        """Tools > Show trace (gui/render.py:9072): per-frame binding
        trace of one pick."""
        locs = self.picked_locs(add_group=False)[pick_index]
        n_frames = lib.get_from_metadata(self.info, "Frames")
        trace = np.zeros(int(n_frames), dtype=np.float32)
        frames = locs["frame"].astype(int)
        np.add.at(trace, frames, locs["photons"])
        return {"frames": frames, "photons": trace, "x": locs["x"],
                "y": locs["y"]}

    def plot_trace(self, pick_index: int = 0, fig=None):
        trace = self.show_trace(pick_index)
        fig = fig or self._new_fig(figsize=(8, 3))
        ax = fig.add_subplot(111)
        ax.step(np.arange(len(trace["photons"])), trace["photons"],
                where="mid", lw=0.7)
        ax.set_xlabel("frame")
        ax.set_ylabel("photons")
        return fig

    def pick_scatter(self, pick_index: int = 0) -> np.ndarray:
        """XY(Z) scatter data for pick inspection (Select picks
        (XY/XYZ scatter), gui/render.py:11964)."""
        locs = self.picked_locs(add_group=False)[pick_index]
        return _stack(locs, ["x", "y"] + (["z"] if _has(locs, "z") else []))

    def show_pick(self, pick_index: int = 0, fig=None):
        """Tools > Select picks (XY scatter) for one pick
        (gui/render.py:9324 show_pick): 2D scatter of the picked
        localizations; combine with ``keep_picks`` for the
        accept/reject inspection loop."""
        data = self.pick_scatter(pick_index)
        fig = fig or self._new_fig(figsize=(4, 4))
        ax = fig.add_subplot(111)
        ax.scatter(data[:, 0], data[:, 1], s=2)
        ax.set_aspect("equal")
        ax.set_title(f"Pick {pick_index}: {len(data)} locs")
        return fig

    def show_pick_3d(self, pick_index: int = 0, fig=None):
        """Tools > Select picks (XYZ scatter) (gui/render.py:9422):
        3D scatter of one pick; requires a z column."""
        data = self.pick_scatter(pick_index)
        assert data.shape[1] == 3, "3D scatter requires a z column"
        fig = fig or self._new_fig(figsize=(4, 4))
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(data[:, 0], data[:, 1], data[:, 2], s=2)
        ax.set_title(f"Pick {pick_index}: {len(data)} locs")
        return fig

    def select_traces(self, fig=None):
        """Tools > Select picks (trace) (gui/render.py:9193): the
        frame-vs-index trace of every pick on one figure; combine
        with ``keep_picks`` to accept/reject."""
        fig = fig or self._new_fig(figsize=(6, 4))
        ax = fig.add_subplot(111)
        for i, picked in enumerate(self.picked_locs()):
            frames = picked["frame"]
            ax.plot(frames, np.full(len(frames), i), "|", markersize=4,
                    label=f"pick {i}")
        ax.set_xlabel("Frame")
        ax.set_ylabel("Pick")
        return fig

    def plot_pick_profile(self, pick_index: int = 0,
                          bin_width_nm: float | None = None,
                          fig=None) -> dict:
        """Tools > Plot pick profile (gui/render.py:9858
        plot_profile): histogram of localization positions along the
        center axis of a RECTANGULAR pick, in nm, one profile per
        visible channel. Returns {"profiles": [per-channel position
        arrays (nm)], "bin_edges": edges, "counts": [histograms]} and
        draws onto ``fig`` when given."""
        assert self.pick_shape == "Rectangle", (
            "Please select one rectangular pick to plot the profile.")
        from picasso_torch import postprocess

        pixelsize = self._pixelsize()
        profiles = []
        for i in self._visible_channels() or [self.current_channel]:
            ch = self.channels[i]
            picked = postprocess.picked_locs(
                ch.locs, ch.info, [self.picks[pick_index]], "Rectangle",
                pick_size=self.pick_width)[0]
            profiles.append(picked["y_pick_rot"] * pixelsize)
        concat = np.concatenate(profiles)
        self._profiles = profiles
        if concat.size == 0:
            self.status("No localizations in the pick.")
            return {"profiles": profiles, "bin_edges": np.array([0.0, 1.0]),
                    "counts": [np.zeros(1, int) for _ in profiles]}
        if bin_width_nm is None or concat.min() == concat.max():
            edges = lib.calculate_optimal_bins(concat, max_n_bins=1000)
        else:
            edges = np.arange(concat.min(), concat.max() + bin_width_nm,
                              bin_width_nm)
        counts = [np.histogram(p, bins=edges)[0] for p in profiles]
        if fig is not None:
            ax = fig.add_subplot(111)
            for p in profiles:
                ax.hist(p, bins=edges, alpha=0.5)
            ax.set_xlabel("Position along pick (nm)")
            ax.set_ylabel("Counts")
        return {"profiles": profiles, "bin_edges": edges, "counts": counts}

    def export_profile(self, path: str):
        """Export the last pick profile as csv (gui/render.py:9947): one
        column a channel, named 0, 1, ...; a shorter column ends in empty
        cells."""
        assert getattr(self, "_profiles", None), "No profile to export."
        n = max(len(p) for p in self._profiles)
        table = {}
        for k, p in enumerate(self._profiles):
            col = np.full(n, np.nan, np.result_type(p.dtype, np.float32))
            col[:len(p)] = p
            table[str(k)] = col
        lib.write_table(path, table)

    def keep_picks(self, indices):
        """Keep only the given picks — the scripted analogue of the
        reference's Select picks (XY/XYZ scatter, trace) accept/
        reject inspection loop (gui/render.py:9193/:11964)."""
        indices = set(int(i) for i in indices)
        self.picks = [p for i, p in enumerate(self.picks) if i in indices]
        self.redraw()

    def export_locs(self, path: str, fmt: str, channel: int | None = None):
        """File > Export localizations (gui/render.py:12416
        export_multi): write the channel's locs in one of the
        reference's exchange formats — ``"imagej"`` (.txt),
        ``"nis"`` (.txt), ``"chimera"`` (.xyz), ``"visp"`` (.3d),
        ``"thunderstorm"`` (.csv)."""
        ch = self._channel_at(channel)
        exporters = {
            "imagej": io.export_txt_imagej,
            "nis": io.export_txt_nis,
            "chimera": io.export_xyz_chimera,
            "visp": io.export_3d_visp,
            "thunderstorm": io.export_ts,
        }
        assert fmt in exporters, (f"Unknown export format {fmt!r}; "
                                  f"choose from {sorted(exporters)}")
        exporters[fmt](path, ch.locs, ch.info)
        self.status(f"Exported locs to {path}")

    def export_roi_imaris(self, path: str):
        """File > Export ROI for Imaris (gui/render.py:12481
        export_fov_ims): render the current viewport of every visible
        channel on the device and write a multi-channel .ims volume."""
        pixelsize = self._pixelsize()
        disp_px = pixelsize / self.oversampling
        images = []
        for i in self._visible_channels() or [self.current_channel]:
            _, raw = render.render(
                self._display_locs(i), self.channels[i].info,
                disp_px_size=disp_px, viewport=self.viewport,
                blur_method=self.blur_method,
                min_blur_width=self.min_blur_width, device=self.device)
            images.append(np.asarray(raw, np.float32))
        stack = np.stack(images)  # (C, Y, X)
        # one TimePoint per channel (io.write_ims is single-channel;
        # Imaris reads the stack as a time series per channel)
        io.write_ims(path, stack, pixelsize=disp_px)
        self.status(f"Exported FOV to {path}")
        return stack

    def open_rotated_locs(self, path: str) -> int:
        """File > Open rotated localizations (gui/render.py:12800):
        open a locs file whose yaml chain carries Pick/Pick shape
        keys (written by the rotation window) and restore the pick
        state."""
        i = self.open_file(path)
        last = self.channels[i].info[-1]
        if "Pick" in last:
            self.picks = [last["Pick"]]
            self.pick_shape = last["Pick shape"]
            size = last.get("Pick size (nm)") or last.get("Pick size")
            if size is not None:
                if self.pick_shape == "Circle":
                    self.pick_diameter = float(size)
                elif self.pick_shape == "Rectangle":
                    self.pick_width = float(size)
            self.redraw()
        return i

    def cluster_in_pick_kmeans(self, pick_index: int = 0,
                               n_clusters: int = 2, seed: int = 0
                               ) -> np.ndarray:
        """Tools > Cluster in pick (k-means) (gui/render.py:11982)."""
        from scipy.cluster.vq import kmeans2

        locs = self.picked_locs(add_group=False)[pick_index]
        X = _stack(locs, ["x", "y"]).astype(np.float64)
        _, labels = kmeans2(X, n_clusters, minit="++", seed=seed)
        return lib.append_to_rec(locs, labels.astype(np.int32), "group")

    def mask_image(self, method: str = "otsu", disp_px_size: float = 200.0,
                   blur: float = 500.0):
        """Tools > Mask image (MaskSettingsDialog,
        gui/render.py:4992): threshold a blurred render, split locs
        into inside/outside."""
        from picasso_torch import masking

        image = masking.generate_image(self.locs, self.info, disp_px_size,
                                       blur, device=self.device)
        mask = masking.mask_image(image, method)
        locs_in, locs_out = masking.mask_locs(self.locs, mask,
                                              info=self.info)
        self.status(f"Mask ({method}): {len(locs_in)} in / "
                    f"{len(locs_out)} out")
        return mask, locs_in, locs_out

    def apply_mask(self, method: str = "otsu", keep: str = "in", **kw):
        mask, locs_in, locs_out = self.mask_image(method, **kw)
        ch = self.channel
        ch.push_undo("mask")
        ch.locs = locs_in if keep == "in" else locs_out
        ch.info = ch.info + [{
            "Generated by": "picasso-tpu Render : Mask image",
            "Method": method,
            "Kept": keep,
        }]
        ch.rebuild_index()
        self.redraw()
        return mask

    # ------------------------------------------------------------------
    # pick IO (File menu, gui/render.py:11774-11791)
    # ------------------------------------------------------------------
    def save_picks(self, path: str):
        size = {
            "Circle": self.pick_diameter,
            "Rectangle": self.pick_width,
            "Square": self.pick_side,
            "Polygon": None,
        }[self.pick_shape]
        io.save_picks(path, [self._pick_to_yaml(p) for p in self.picks],
                      self.pick_shape, size=size, pixelsize=self._pixelsize())

    def _pick_to_yaml(self, pick):
        if self.pick_shape in ("Circle", "Square"):
            return [float(pick[0]), float(pick[1])]
        if self.pick_shape == "Rectangle":
            return [[float(pick[0][0]), float(pick[0][1])],
                    [float(pick[1][0]), float(pick[1][1])]]
        return [[float(x), float(y)] for x, y in pick]

    def load_picks(self, path: str):
        picks, shape, size = io.load_picks(path, self._pixelsize())
        self.pick_shape = shape
        self._polygon_in_progress = []
        if shape == "Circle":
            self.pick_diameter = size or self.pick_diameter
            self.picks = [tuple(p) for p in picks]
        elif shape == "Rectangle":
            self.pick_width = size or self.pick_width
            self.picks = [(tuple(p[0]), tuple(p[1])) for p in picks]
        elif shape == "Square":
            self.pick_side = size or self.pick_side
            self.picks = [tuple(p) for p in picks]
        else:
            self.picks = [[tuple(pt) for pt in poly] for poly in picks]
        self.redraw()

    def _pick_areas_um2(self) -> np.ndarray:
        areas_px = lib.pick_areas(self.pick_shape, self.picks,
                                  pick_size=self._pick_size_by_diameter)
        return np.asarray(areas_px, float) * (self._pixelsize()
                                              / 1000) ** 2

    def pick_info(self) -> dict:
        """Info block describing the current picks, with per-pick and
        total areas in um^2 (reference gui/render.py:10570; the total
        'Area (um^2)' for circle/square picks was fixed in v0.10.3)."""
        areas_um2 = self._pick_areas_um2()
        if self.pick_shape in ("Circle", "Square"):
            # identical for every pick — store one value
            areas_list = [float(areas_um2[0])] if len(areas_um2) else []
        else:
            areas_list = [float(a) for a in areas_um2]
        return {
            "Generated by": "picasso-tpu Render : Pick",
            "Pick Shape": self.pick_shape,
            "Pick Areas (um^2)": areas_list,
            "Area (um^2)": float(np.sum(areas_um2)),
            "Number of picks": len(self.picks),
        }

    def calculate_pick_info(self, max_dark_time=None) -> dict:
        """Info dialog > Calculate pick info (reference
        gui/render.py:11380 update_pick_info_long): per-pick
        statistics — locs/pick, RMSD to the center of mass (and z),
        bright/dark-time means — plus the pooled dark time the qPAINT
        calibration consumes. Stored on the app for
        ``calibrate_influx``/``n_units``."""
        from picasso_torch import postprocess

        picked = self.picked_locs()
        assert picked, "No picks."
        n_locs, rmsd, rmsd_z, length, dark, all_dark = [], [], [], [], [], []
        for p in picked:
            n_locs.append(len(p))
            if len(p) == 0:
                rmsd.append(np.nan)
                length.append(np.nan)
                dark.append(np.nan)
                continue
            cx, cy = p["x"].mean(), p["y"].mean()
            rmsd.append(float(np.sqrt(np.mean((p["x"] - cx) ** 2
                                              + (p["y"] - cy) ** 2))))
            if _has(p, "z"):
                rmsd_z.append(float(np.sqrt(np.mean(
                    (p["z"] - p["z"].mean()) ** 2))))
            linked = postprocess.link(p, self.info,
                                      max_dark_time=max_dark_time or 1,
                                      device=self.device)
            length.append(float(np.nanmean(linked["len"])))
            d = postprocess.dark_times(linked, device=self.device)
            d = d[np.isfinite(d) & (d > 0)]
            all_dark.append(d)
            dark.append(float(np.mean(d)) if len(d) else np.nan)
        pooled = np.concatenate(all_dark) if all_dark else np.zeros(0)
        self._pick_statistics = {
            "n_picks": len(picked),
            "locs_per_pick_mean": float(np.nanmean(n_locs)),
            "locs_per_pick_std": float(np.nanstd(n_locs)),
            "rmsd_mean": float(np.nanmean(rmsd)),
            "rmsd_std": float(np.nanstd(rmsd)),
            "rmsd_z_mean": float(np.nanmean(rmsd_z)) if rmsd_z else None,
            "length_mean": float(np.nanmean(length)),
            "dark_mean": float(np.nanmean(dark)),
            "pooled dark": (float(lib.estimate_kinetic_rate(pooled))
                            if len(pooled) else np.nan),
        }
        return self._pick_statistics

    def calibrate_influx(self, units_per_pick: float = 1.0) -> float:
        """Info dialog > Calibrate influx (gui/render.py:4754):
        influx = 1 / (pooled dark time x units per pick). Requires
        calculate_pick_info() first."""
        stats = getattr(self, "_pick_statistics", None)
        assert stats is not None, "Run calculate_pick_info() first."
        self.influx_rate = 1.0 / (stats["pooled dark"] * units_per_pick)
        return self.influx_rate

    def n_units(self, influx_rate: float | None = None) -> float:
        """Number of binding units per pick from its mean dark time
        (gui/render.py:4762 calculate_n_units)."""
        stats = getattr(self, "_pick_statistics", None)
        assert stats is not None, "Run calculate_pick_info() first."
        rate = influx_rate or getattr(self, "influx_rate", None)
        assert rate, "No influx rate; run calibrate_influx() first."
        return 1.0 / (rate * stats["dark_mean"])

    def save_picked_locs(self, path: str, channel: int | None = None):
        """Save the locs inside the current picks with the pick info
        appended to the yaml chain (reference gui/render.py:10588)."""
        picked = self.picked_locs(channel=channel)
        if not picked:
            raise ValueError("No picks to save.")
        out = np.concatenate(picked)
        io.save_locs(path, out,
                     list(self._channel_at(channel).info) + [self.pick_info()])
        return len(out)

    def save_pick_properties(self, path: str, max_dark_time: int = 3,
                             influx_rate: float = 0.03) -> np.ndarray:
        """File > Save pick properties (gui/render.py:11783):
        per-pick kinetics/qPAINT statistics table saved as an HDF5
        'groups' dataset + yaml chain."""
        from picasso_torch import postprocess

        picked = self.picked_locs()
        areas_um2 = self._pick_areas_um2()
        if len(areas_um2) == 1 and len(picked) > 1:
            areas_um2 = np.repeat(areas_um2, len(picked))
        props = postprocess.pick_properties(
            picked, self.info, max_dark_time=max_dark_time,
            influx_rate=influx_rate, pick_areas=areas_um2,
            device=self.device)
        io.save_datasets(path, list(self.info) + [self.pick_info()],
                         groups=props)
        return props

    def apply_expression(self, cmd: str, channel: int | None = None):
        """View > Apply expression (reference ApplyDialog +
        open_apply_dialog, gui/render.py:275/:12710): manipulate the
        channel's localization columns with a one-line command.

        - ``x += 10`` (any python over the column namespace),
        - ``flip x y`` / ``flip x z`` (the z variant converts through
          the pixelsize and recenters on the movie extent),
        - ``spiral R N`` (plot each loc over time in a spiral of
          radius R px and N turns), ``uspiral`` to undo it.

        A column written takes the dtype of what is written to it, as a
        DataFrame's column does (lib.append_to_rec)."""
        ch = self._channel_at(channel)
        ch.push_undo(f"expression: {cmd}")
        # new arrays: the undo stack holds the previous one as it was
        locs = ch.locs

        def put(name, values):
            nonlocal locs
            values = np.asarray(values)
            if values.shape != (len(locs),):
                values = np.broadcast_to(values, (len(locs),)).copy()
            locs = lib.append_to_rec(locs, values, name)

        parts = cmd.split()
        if parts and parts[0] == "flip" and len(parts) == 3:
            var_1, var_2 = parts[1], parts[2]
            a, b = locs[var_1].copy(), locs[var_2].copy()
            if "z" in parts:
                if var_1 == "z":
                    var_1, var_2 = var_2, "z"
                    a, b = b, a
                pixelsize = self._pixelsize(ch.info)
                height = lib.get_from_metadata(ch.info, "Height")
                width = lib.get_from_metadata(ch.info, "Width")
                dist = width if var_1 == "x" else height
                put(var_1, b / pixelsize + dist / 2)
                put(var_2, a * pixelsize)
            else:
                put(var_1, b)
                put(var_2, a)
        elif parts and parts[0] == "spiral" and len(parts) == 3:
            radius = float(parts[1])
            turns = int(parts[2])
            maxframe = lib.get_from_metadata(ch.info, "Frames")
            x0, y0 = locs["x"].copy(), locs["y"].copy()
            scale_time = maxframe / (turns * 2 * np.pi)
            scale_x = turns * 2 * np.pi
            t = locs["frame"] / scale_time
            put("x", (t * np.cos(t)) / scale_x * radius + x0)
            put("y", (t * np.sin(t)) / scale_x * radius + y0)
            # the rows that ensure_sanity keeps below, whose x and y
            # uspiral restores (JAX's index alignment)
            keep = lib.sane_rows(locs, ch.info)
            self._x_spiral, self._y_spiral = x0[keep], y0[keep]
        elif parts and parts[0] == "uspiral":
            if not hasattr(self, "_x_spiral"):
                self.status("Localizations have not been spiraled yet.")
                ch.pop_undo()
                return
            put("x", self._x_spiral)
            put("y", self._y_spiral)
        else:
            # any python over the column namespace, each column a copy
            # written back in the dtype the command left it in
            names = list(locs.dtype.names)
            ns = {c: np.array(locs[c]) for c in names}
            exec(cmd, ns)
            for c in names:
                put(c, ns[c])
        ch.locs = lib.ensure_sanity(locs, ch.info)
        ch.rebuild_index()
        self.redraw()

    def undo(self) -> str | None:
        """Undo the last locs-modifying action on the active channel
        (the reference exposes only 'Undo drift'; this generalizes)."""
        label = self.channel.pop_undo()
        if label is not None:
            self.status(f"Undid: {label}")
            self.redraw()
        return label

    # ------------------------------------------------------------------
    # postprocess menu (gui/render.py:11994-12079)
    # ------------------------------------------------------------------
    def _record(self, label: str, extra: dict | None = None):
        block = {"Generated by": f"picasso-tpu Render : {label}"}
        if extra:
            block.update(extra)
        self.channel.info = self.channel.info + [block]

    def _pixelsize_if_3d(self, locs: np.ndarray) -> float | None:
        """The clusterers' pixelsize argument: given for 3D locs."""
        return self._pixelsize(self.info) if _has(locs, "z") else None

    def undrift_rcc(self, segmentation: int = 1000):
        """Postprocess > Undrift by RCC (gui/render.py:11030)."""
        from picasso_torch import postprocess

        ch = self.channel
        ch.push_undo("undrift RCC")
        self.status("Undrifting by RCC...")
        drift, locs = postprocess.undrift(ch.locs, ch.info, segmentation,
                                          device=self.device)
        ch.locs = locs
        ch.drift = drift
        self._record("Undrift by RCC", {"Segmentation": segmentation})
        ch.rebuild_index()
        self.redraw()
        return drift

    def undrift_aim(self, segmentation: int = 100,
                    intersect_d_nm: float = 20.0, roi_r_nm: float = 60.0):
        """Postprocess > Undrift by AIM (AIMDialog
        gui/render.py:2222, action :11996)."""
        from picasso_torch import aim as _aim

        ch = self.channel
        ch.push_undo("undrift AIM")
        pixelsize = self._pixelsize(ch.info)
        self.status("Undrifting by AIM...")
        locs, new_info, drift = _aim.aim(
            ch.locs, ch.info, segmentation=segmentation,
            intersect_d=intersect_d_nm / pixelsize,
            roi_r=roi_r_nm / pixelsize, device=self.device)
        ch.locs = locs
        ch.info = list(new_info)
        ch.drift = drift
        ch.rebuild_index()
        self.redraw()
        return drift

    def undrift_from_picked(self):
        """Postprocess > Undrift from picked (gui/render.py:11092).
        Requires picks on fiducial markers."""
        from picasso_torch import postprocess

        ch = self.channel
        picked = self.picked_locs()
        if not picked:
            raise ValueError("Pick fiducials first.")
        ch.push_undo("undrift from picked")
        drift = postprocess.undrift_from_picked(picked, ch.info)
        ch.locs = postprocess.apply_drift(ch.locs, ch.info, drift=drift,
                                            device=self.device)
        ch.drift = drift
        self._record("Undrift from picked", {"Number of picks": len(picked)})
        ch.rebuild_index()
        self.redraw()
        return drift

    def undo_drift(self):
        """Postprocess > Undo drift (gui/render.py:11159)."""
        ch = self.channel
        if ch.drift is None:
            raise ValueError("No drift to undo.")
        label = ch.pop_undo()
        ch.drift = None
        self.status(f"Undid: {label}")
        self.redraw()

    def show_drift(self, fig=None):
        """Postprocess > Show drift (DriftPlotWindow
        gui/render.py:4141)."""
        from picasso_torch import postprocess

        if self.channel.drift is None:
            raise ValueError("No drift computed yet.")
        return postprocess.plot_drift(self.channel.drift,
                                      pixelsize=self._pixelsize(), fig=fig)

    def save_drift(self, path: str):
        if self.channel.drift is None:
            raise ValueError("No drift computed yet.")
        io.save_drift(path, self.channel.drift)

    def apply_drift_file(self, path: str):
        """Postprocess > Apply drift from an external file
        (gui/render.py:12019)."""
        from picasso_torch import postprocess

        drift = io.load_drift(path)
        ch = self.channel
        ch.push_undo("apply drift")
        ch.locs = postprocess.apply_drift(ch.locs, ch.info, drift=drift,
                                            device=self.device)
        ch.drift = drift
        self._record("Apply drift", {"Drift file": path})
        ch.rebuild_index()
        self.redraw()
        return drift

    def remove_columns(self, columns: list[str]):
        """Postprocess > Remove columns (gui/render.py:12025)."""
        ch = self.channel
        missing = [c for c in columns if not _has(ch.locs, c)]
        if missing:
            raise KeyError(f"{missing} not found in axis")
        ch.push_undo("remove columns")
        ch.locs = lib.drop_fields(ch.locs, list(columns))
        self._record("Remove columns", {"Columns": list(columns)})

    def unfold_groups_square(self, n_square: int = 100):
        """Postprocess > Unfold picks (square) (gui/render.py:12031)."""
        ch = self.channel
        if not _has(ch.locs, "group"):
            raise ValueError("Unfold requires grouped (picked) locs.")
        ch.push_undo("unfold square")
        # lib.overwrite_metadata writes into the dicts it is given, and
        # the undo stack holds these
        ch.locs, ch.info = lib.unfold_localizations_square(
            ch.locs, [dict(d) for d in ch.info], n_square=n_square)
        self._record("Unfold square", {"Side": n_square})
        ch.rebuild_index()
        self.redraw()

    def link(self, r_max: float = 0.05, max_dark_time: int = 1):
        """Postprocess > Link localizations (LinkDialog
        gui/render.py:2663, View.link :7330)."""
        from picasso_torch import postprocess

        ch = self.channel
        ch.push_undo("link")
        self.status("Linking...")
        ch.locs = postprocess.link(ch.locs, ch.info, r_max=r_max,
                                   max_dark_time=max_dark_time,
                                   device=self.device)
        self._record("Link", {
            "Maximum distance": r_max,
            "Maximum transient dark time": max_dark_time,
        })
        ch.rebuild_index()
        self.redraw()

    def align_channels(self):
        """Postprocess > Align channels by RCC (View.align
        gui/render.py:7273)."""
        from picasso_torch import postprocess

        if len(self.channels) < 2:
            raise ValueError("Aligning requires at least 2 channels.")
        locs_list = [ch.locs for ch in self.channels]
        infos = [ch.info for ch in self.channels]
        for ch in self.channels:
            ch.push_undo("align")
        aligned = postprocess.align(locs_list, infos, device=self.device)
        for ch, locs in zip(self.channels, aligned):
            ch.locs = locs
            ch.info = ch.info + [{"Generated by": "picasso-tpu Render : "
                                                  "Align"}]
            ch.rebuild_index()
        self.redraw()

    def combine_locs(self):
        """Postprocess > Combine locs in picks (View.combine
        gui/render.py:7297)."""
        from picasso_torch import postprocess

        ch = self.channel
        ch.push_undo("combine")
        ch.locs = postprocess.combine_locs_in_picks(
            ch.locs, ch.info, picks=self.picks, pick_shape=self.pick_shape,
            pick_size=self._pick_size_by_diameter, device=self.device)
        self._record("Combine", {"Number of picks": len(self.picks)})
        ch.rebuild_index()
        self.redraw()

    # -- clustering (gui/render.py:12058-12067) --
    def dbscan(self, radius: float, min_density: int, save_path=None):
        """Postprocess > Clustering > DBSCAN (DbscanDialog
        gui/render.py:2308, View.dbscan :7360)."""
        from picasso_torch import clusterer

        ch = self.channel
        ch.push_undo("dbscan")
        self.status("DBSCAN...")
        ch.locs = clusterer.dbscan(ch.locs, radius, min_density,
                                   pixelsize=self._pixelsize_if_3d(ch.locs),
                                   device=self.device)
        self._record("DBSCAN", {"Radius": radius,
                                "Min density": min_density})
        ch.rebuild_index()
        if save_path:
            io.save_locs(save_path, ch.locs, ch.info)
        self.redraw()
        return _n_groups(ch.locs)

    def hdbscan(self, min_cluster_size: int, min_samples: int,
                cluster_eps: float = 0.0):
        """Postprocess > Clustering > HDBSCAN (gui/render.py:2556)."""
        from picasso_torch import clusterer

        ch = self.channel
        ch.push_undo("hdbscan")
        ch.locs = clusterer.hdbscan(ch.locs, min_cluster_size, min_samples,
                                    cluster_eps=cluster_eps,
                                    pixelsize=self._pixelsize_if_3d(ch.locs),
                                    device=self.device)
        self._record("HDBSCAN", {"Min cluster size": min_cluster_size,
                                 "Min samples": min_samples})
        ch.rebuild_index()
        self.redraw()
        return _n_groups(ch.locs)

    def smlm_clusterer(self, radius_xy: float, min_locs: int,
                       frame_analysis: bool = True,
                       radius_z: float | None = None):
        """Postprocess > Clustering > SMLM clusterer (SMLMDialog
        gui/render.py:2734, View.smlm_clusterer :7610)."""
        from picasso_torch import clusterer

        ch = self.channel
        ch.push_undo("smlm cluster")
        locs, info_block = clusterer.cluster(
            ch.locs, radius_xy, min_locs, frame_analysis, radius_z=radius_z,
            pixelsize=self._pixelsize_if_3d(ch.locs), return_info=True,
            device=self.device)
        ch.locs = locs
        ch.info = ch.info + [info_block]
        ch.rebuild_index()
        self.redraw()
        return _n_groups(locs)

    def test_clustering(self, pick_index: int = 0, method: str = "smlm",
                        **params):
        """Postprocess > Clustering > Test clustering
        (TestClustererDialog gui/render.py:3180): run a clusterer on
        one pick only and return the labeled locs for inspection."""
        from picasso_torch import clusterer

        locs = self.picked_locs(add_group=False)[pick_index]
        pixelsize = self._pixelsize_if_3d(locs)
        if method == "smlm":
            return clusterer.cluster(
                locs, params.get("radius_xy", 0.1),
                params.get("min_locs", 10),
                params.get("frame_analysis", False),
                radius_z=params.get("radius_z"), pixelsize=pixelsize,
                device=self.device)
        if method == "dbscan":
            return clusterer.dbscan(locs, params.get("radius", 0.1),
                                    params.get("min_density", 4),
                                    pixelsize=pixelsize, device=self.device)
        if method == "hdbscan":
            return clusterer.hdbscan(locs, params.get("min_cluster_size", 10),
                                     params.get("min_samples", 10),
                                     pixelsize=pixelsize, device=self.device)
        raise ValueError(f"Unknown clustering method: {method}")

    def nearest_neighbor(self, channel1: int = 0,
                         channel2: int | None = None, nn_count: int = 1
                         ) -> np.ndarray:
        """Postprocess > Nearest Neighbor Analysis (View.
        nearest_neighbor gui/render.py:8983)."""
        from picasso_torch import postprocess

        ch1 = self.channels[channel1]
        ch2 = self.channels[channel1 if channel2 is None else channel2]
        cols = ["x", "y"] + (["z"] if _has(ch1.locs, "z")
                             and _has(ch2.locs, "z") else [])
        return postprocess.nn_analysis(_stack(ch1.locs, cols),
                                       _stack(ch2.locs, cols), nn_count,
                                       device=self.device)

    def resi(self, radius_xy: float, min_locs: int = 10, radius_z=None,
             **kwargs):
        """Postprocess > RESI (RESIDialog gui/render.py:5783):
        cluster every channel, combine the cluster centers."""
        from picasso_torch import postprocess

        if len(self.channels) < 2:
            raise ValueError("RESI requires at least 2 channels.")
        self.status("RESI...")
        centers, info = postprocess.resi(
            [ch.locs for ch in self.channels],
            [ch.info for ch in self.channels], radius_xy,
            radius_z=radius_z, min_locs=min_locs, device=self.device,
            **kwargs)
        idx = self.add_channel(centers, info, path="<RESI>")
        self.redraw()
        return idx, centers

    def open_rotation_window(self, pick_index: int | None = None):
        """View > Update rotation window (gui/render.py:11899): open
        the 3D rotation viewer on a picked region (or the whole
        channel), on this app's device."""
        from picasso_torch.gui.apps import RotationApp

        if pick_index is not None:
            locs = self.picked_locs(add_group=False)[pick_index]
        else:
            locs = self.locs
        if not _has(locs, "z"):
            raise ValueError(
                "The rotation window requires 3D locs (z column).")
        return RotationApp(locs, self.info, oversampling=self.oversampling,
                           device=self.device)

    def open_filter_window(self):
        """Hand the active channel to a FilterApp (the reference
        drags files between apps)."""
        from picasso_torch.gui.viewers import FilterApp

        return FilterApp(self.locs, self.info, device=self.device)

    def _open_panel(self, attr: str, cls_name: str, **kwargs):
        from picasso_torch.gui import panels

        panel = getattr(panels, cls_name)(self, **kwargs)
        setattr(self, attr, panel)
        return panel

    def open_display_settings(self):
        """Interactive display-settings panel (the reference's
        DisplaySettingsDialog, gui/render.py:6030, as a
        matplotlib-widgets figure)."""
        return self._open_panel("display_settings", "DisplaySettingsPanel")

    def open_channels_panel(self):
        """Per-channel dataset panel (the reference's DatasetDialog,
        gui/render.py:378)."""
        return self._open_panel("channels_panel", "ChannelsPanel")

    def open_info_panel(self):
        """Info window with NeNA/FRC actions (the reference's
        InfoDialog, gui/render.py:4295)."""
        return self._open_panel("info_panel", "InfoPanel")

    def open_tools_settings(self):
        """Pick-tool settings panel (the reference's
        ToolsSettingsDialog, gui/render.py:5688)."""
        return self._open_panel("tools_settings", "ToolsSettingsPanel")

    def open_slicer_panel(self, thickness_nm: float = 50.0):
        """Interactive z-slicer panel (the reference's SlicerDialog,
        gui/render.py:6610). Starts the slicer if it isn't running."""
        return self._open_panel("slicer_panel", "SlicerPanel",
                                thickness_nm=thickness_nm)

    def open_fast_render_panel(self):
        """Fast-render subsampling panel (the reference's
        FastRenderDialog, gui/render.py:6519)."""
        return self._open_panel("fast_render_panel", "FastRenderPanel")

    def open_undrift_panel(self):
        """Undrift controls + drift plot (the reference's Postprocess
        menu with AIMDialog gui/render.py:2222 and DriftPlotWindow
        :4141)."""
        return self._open_panel("undrift_panel", "UndriftPanel")

    def open_cluster_panel(self):
        """Clustering panel (the reference's DbscanDialog
        gui/render.py:2308, HdbscanDialog :2556, SMLMDialog :2734)."""
        return self._open_panel("cluster_panel", "ClusterPanel")

    def open_mask_panel(self):
        """Mask-image panel (the reference's MaskSettingsDialog,
        gui/render.py:4992)."""
        return self._open_panel("mask_panel", "MaskPanel")

    def open_apply_panel(self):
        """Apply-expression panel (the reference's ApplyDialog,
        gui/render.py:274)."""
        return self._open_panel("apply_panel", "ApplyPanel")

    def open_link_panel(self):
        """Link panel (the reference's LinkDialog,
        gui/render.py:2663)."""
        return self._open_panel("link_panel", "LinkPanel")

    def open_fov_panel(self):
        """Change-FOV panel (the reference's ChangeFOV dialog,
        gui/render.py:4168)."""
        return self._open_panel("fov_panel", "ChangeFOVPanel")

    def open_picks_panel(self):
        """Pick browser panel (the reference's pick navigation +
        PlotDialog, gui/render.py:1459)."""
        return self._open_panel("picks_panel", "PicksPanel")

    def molecular_mapping(self, **kwargs):
        """Postprocess > Molecular mapping (G5MDialog
        gui/render.py:2887): per-cluster Gaussian-mixture fitting of
        the active channel's grouped locs, on this app's device."""
        from picasso_torch import g5m as _g5m

        if not _has(self.locs, "group"):
            raise ValueError(
                "G5M requires clustered locs (a 'group' column).")
        centers, clustered, info = _g5m.g5m(self.locs, self.info,
                                            device=self.device, **kwargs)
        self.status(f"G5M done: {len(centers)} molecules")
        return centers, clustered, info

    # ------------------------------------------------------------------
    # interaction
    # ------------------------------------------------------------------
    def _on_scroll(self, event):
        if event.inaxes != self.ax or event.xdata is None:
            return
        factor = 0.8 if event.button == "up" else 1.25
        self.viewport = render.zoom_viewport(self.viewport, factor,
                                             (event.ydata, event.xdata))
        self._follow_zoom()
        self.redraw()

    # ------------------------------------------------------------------
    # mouse-driven interaction (reference View mouse handlers,
    # gui/render.py:6883 mousePressEvent/mouseMoveEvent/
    # mouseReleaseEvent, pick drawing ~:7650-7900, wheel zoom)
    # ------------------------------------------------------------------
    def set_tool(self, tool: str):
        """Active left-button tool (reference Tools menu)."""
        assert tool in ("zoom", "pick", "measure"), tool
        self.tool = tool
        self._drag = None
        self._clear_rubber()

    def add_measure_point(self, x: float, y: float):
        """Measure tool: each click appends a point; the distance to
        the previous point is logged in px and nm (reference
        View.add_measure_point)."""
        self.measure_points.append((float(x), float(y)))
        if len(self.measure_points) >= 2:
            (x0, y0), (x1, y1) = self.measure_points[-2:]
            d_px = float(np.hypot(x1 - x0, y1 - y0))
            self.status(f"Distance: {d_px:.3f} px / "
                        f"{d_px * self._pixelsize():.1f} nm")
        self.redraw()

    def clear_measure_points(self):
        self.measure_points = []
        self.redraw()

    def _clear_rubber(self):
        if self._rubber is not None:
            try:
                self._rubber.remove()
            except (ValueError, NotImplementedError):
                pass
            self._rubber = None

    def _update_rubber(self, kind, x0, y0, x1, y1):
        """Transient drag overlay: rectangle outline for zoom /
        rectangle picks, circle for circle picks. Artists only — no
        scene re-render per motion event."""
        import matplotlib.patches as mpatches

        self._clear_rubber()
        style = dict(fill=False, linestyle="--", linewidth=1.0,
                     edgecolor="yellow" if kind == "zoomrect" else "cyan")
        if kind == "pick-circle":
            r = float(np.hypot(x1 - x0, y1 - y0))
            self._rubber = mpatches.Circle((x0, y0), r, **style)
        elif kind == "pick-square":
            s = max(abs(x1 - x0), abs(y1 - y0))
            self._rubber = mpatches.Rectangle((x0 - s, y0 - s), 2 * s,
                                              2 * s, **style)
        else:
            self._rubber = mpatches.Rectangle(
                (min(x0, x1), min(y0, y1)), abs(x1 - x0), abs(y1 - y0),
                **style)
        self.ax.add_patch(self._rubber)
        self.fig.canvas.draw_idle()

    def _start_drag(self, kind, event):
        self._drag = {"kind": kind, "x0": event.xdata, "y0": event.ydata,
                      "x1": event.xdata, "y1": event.ydata}

    def _rectangle_click(self, x, y):
        """Two-click rectangle: the first click starts the center axis,
        the second ends it."""
        if self._polygon_in_progress:
            start = self._polygon_in_progress.pop()
            self.add_pick((start, (x, y)))
        else:
            self._polygon_in_progress.append((x, y))

    def _on_click(self, event):
        if event.inaxes != self.ax or event.xdata is None:
            return
        if event.button == 3:
            # right button: the click-to-pick flow, from any tool
            if event.key == "alt":
                self.remove_closest_pick(event.xdata, event.ydata)
            elif self.pick_shape == "Polygon":
                self.add_polygon_point(event.xdata, event.ydata)
            elif self.pick_shape == "Rectangle":
                self._rectangle_click(event.xdata, event.ydata)
            else:
                self.add_pick((event.xdata, event.ydata))
            return
        if event.button == 2:
            self._start_drag("pan", event)
            return
        if event.button != 1:
            return
        if event.key == "control":
            # ctrl + vertical drag = live display contrast
            limits = self.contrast or self._contrast_limits or (0.0, 1.0)
            self._drag = {"kind": "contrast", "ypix0": event.y,
                          "limits0": tuple(limits)}
            return
        if self.tool == "measure":
            self.add_measure_point(event.xdata, event.ydata)
            return
        if self.tool == "pick":
            if event.key == "alt":
                self.remove_closest_pick(event.xdata, event.ydata)
            elif self.pick_shape == "Polygon":
                self.add_polygon_point(event.xdata, event.ydata)
            else:
                self._start_drag({"Circle": "pick-circle",
                                  "Square": "pick-square",
                                  "Rectangle": "pick-rect"}[self.pick_shape],
                                 event)
            return
        # zoom tool: rubber-band rectangle zoom
        self._start_drag("zoomrect", event)

    def _on_motion(self, event):
        d = self._drag
        if d is None:
            return
        if d["kind"] == "contrast":
            if event.y is None:
                return
            vmin0, vmax0 = d["limits0"]
            scale = float(np.exp((event.y - d["ypix0"]) / 200.0))
            self.set_contrast(vmin0, vmin0 + (vmax0 - vmin0) * scale)
            return
        if event.inaxes != self.ax or event.xdata is None:
            return
        d["x1"], d["y1"] = event.xdata, event.ydata
        if d["kind"] != "pan":
            self._update_rubber(d["kind"], d["x0"], d["y0"], d["x1"],
                                d["y1"])

    def _moved(self, d) -> bool:
        span = max(render.viewport_width(self.viewport),
                   render.viewport_height(self.viewport))
        return np.hypot(d["x1"] - d["x0"], d["y1"] - d["y0"]) > 0.005 * span

    def _on_release(self, event):
        d = self._drag
        self._drag = None
        if d is None:
            return
        self._clear_rubber()
        if d["kind"] == "contrast":
            return
        if event.inaxes == self.ax and event.xdata is not None:
            d["x1"], d["y1"] = event.xdata, event.ydata
        x0, y0 = d["x0"], d["y0"]
        x1, y1 = d["x1"], d["y1"]
        if d["kind"] == "pan":
            (ymin, xmin), (ymax, xmax) = self.viewport
            dx, dy = x0 - x1, y0 - y1
            self.viewport = ((ymin + dy, xmin + dx), (ymax + dy, xmax + dx))
            self.redraw()
            return
        if d["kind"] == "zoomrect":
            if self._moved(d):
                self.viewport = ((min(y0, y1), min(x0, x1)),
                                 (max(y0, y1), max(x0, x1)))
                self.redraw()
            return
        # pick draws: a drag sizes the pick, a plain click places one
        # at the current tool size (reference pick drawing)
        if d["kind"] == "pick-circle":
            if self._moved(d):
                self.pick_diameter = 2 * float(np.hypot(x1 - x0, y1 - y0))
            self.add_pick((x0, y0))
        elif d["kind"] == "pick-square":
            if self._moved(d):
                self.pick_side = 2 * float(max(abs(x1 - x0), abs(y1 - y0)))
            self.add_pick((x0, y0))
        elif d["kind"] == "pick-rect":
            if self._moved(d):
                self.add_pick(((x0, y0), (x1, y1)))
            else:
                # no drag: fall back to the two-click flow
                self._rectangle_click(x0, y0)

    def _on_key(self, event):
        actions = {
            "left": self.pan_left,
            "right": self.pan_right,
            "up": self.pan_up,
            "down": self.pan_down,
            "+": self.zoom_in,
            "-": self.zoom_out,
            "w": self.fit_in_view,
            # panel shortcuts (the reference's ctrl+key menu
            # accelerators, gui/render.py addAction shortcuts); ctrl+f
            # also toggles matplotlib's fullscreen on an interactive
            # backend, as in JAX's app
            "ctrl+d": self.open_display_settings,
            "ctrl+f": self.open_channels_panel,
            "ctrl+i": self.open_info_panel,
            "ctrl+t": self.open_tools_settings,
            "ctrl+m": self.open_mask_panel,
            "ctrl+u": self.open_undrift_panel,
            "ctrl+k": self.open_cluster_panel,
            "ctrl+a": self.open_apply_panel,
            "ctrl+l": self.open_link_panel,
            "ctrl+g": self.open_fov_panel,
            "ctrl+p": self.open_picks_panel,
        }
        if self.slicer_on:
            actions["pageup"] = self.next_slice
            actions["pagedown"] = self.previous_slice
        fn = actions.get(event.key)
        if fn is not None:
            fn()
