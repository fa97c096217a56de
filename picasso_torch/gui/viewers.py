"""The movie browser and the locs filter of the port, and the render
window re-exported (picasso_tpu/gui/viewers.py; the reference's
picasso/gui/localize.py, gui/filter.py and gui/render.py).

LocalizeApp's actions run on ``device`` (the card by default; without
one the constructor's preview raises, as every entry point of the port
does): the preview identifies one frame through K4
(localize.identify_in_frame), ``localize_movie`` and
``localize_movie_3d`` run the fused chain (K4 + K5, then the z fit),
``fit_from_identifications`` fits through fit2D's kernels (K1/K2 for
MLE, K3 for LM), ``quality_check`` runs the -db checks and
``save_spots`` identifies and cuts on the device. FilterApp filters on
the host; its subclustering check runs clusterer.test_subclustering on
its device, which it checks when it is built. Locs are numpy structured
arrays where the JAX package's apps take DataFrames; FilterApp.table
returns a structured array. The plugin surface comes from
picasso_torch.gui.base, imported here as JAX's module imports it.
"""

from __future__ import annotations

import numpy as np

from picasso_torch import io, lib, localize
from picasso_torch.gui.base import StatusLog, _PluginHost
from picasso_torch.gui.render_app import RenderApp  # noqa: F401 (re-export)


class LocalizeApp(_PluginHost):
    """Movie browser with live identification overlay plus the full
    fit workflow of the reference Localize app (picasso/gui/localize.py:
    ParametersDialog :605 camera/fit settings, identify/fit workers,
    'Save spots' :2762): tune parameters per frame, set camera
    parameters (from the config file or directly), pick an ROI, then
    localize the whole movie to a _locs.hdf5 + yaml chain."""

    def __init__(self, movie, info: list[dict],
                 min_net_gradient: float = 5000, box: int = 7, fig=None,
                 status_callback=None, device="cuda"):
        import matplotlib.pyplot as plt  # noqa: F401

        self.movie = movie
        self.info = info
        self.device = device
        self.min_net_gradient = min_net_gradient
        self.box = box
        self.frame_number = 0
        self.roi = None  # ((y0, x0), (y1, x1)) or None
        self.contrast_percentiles = (0.5, 99.5)
        # ParametersDialog experiment settings (gui/localize.py:605)
        self.camera_info = {
            "Baseline": 0.0, "Sensitivity": 1.0, "Gain": 1.0, "Qe": 1.0,
            "Pixelsize": lib.get_from_metadata(info, "Pixelsize", 130),
        }
        self.fitting_method = "gausslq"
        self.status = StatusLog(status_callback)
        self.fig = fig or self._new_fig(figsize=(7, 7))
        self.ax = self.fig.add_subplot(111)
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self._init_plugins("localize")
        self.redraw()

    # -- camera settings (CamSettingComboBox etc.,
    #    gui/localize.py:277-463) --
    def set_camera_parameters(self, **kwargs):
        for key, val in kwargs.items():
            if key not in self.camera_info:
                raise KeyError(f"Unknown camera parameter {key!r}")
            self.camera_info[key] = float(val)

    def load_camera_config(self, config: dict | None = None):
        """Resolve camera parameters for this movie from the user
        config (~/.picasso/config.yaml 'Cameras' section) like the
        reference's camera combos."""
        if config is None:
            config = io.load_config()
        params = None
        if hasattr(self.movie, "camera_parameters"):
            params = self.movie.camera_parameters(config)
        else:
            cameras = (config or {}).get("Cameras", {})
            camera = lib.get_from_metadata(self.info, "Camera", None)
            if camera in cameras:
                cam = cameras[camera]
                params = {
                    "Baseline": cam.get("Baseline", 0.0),
                    "Sensitivity": cam.get("Sensitivity", 1.0),
                    "Gain": cam.get("Gain", 1.0),
                    "Qe": cam.get("Qe", 1.0),
                }
        if params:
            pixelsize = self.camera_info["Pixelsize"]
            self.camera_info.update(params)
            self.camera_info.setdefault("Pixelsize", pixelsize)
        return dict(self.camera_info)

    def set_roi(self, y0: int, x0: int, y1: int, x1: int):
        """Restrict identification to a rectangular ROI
        (reference View ROI rubber band)."""
        self.roi = ((int(y0), int(x0)), (int(y1), int(x1)))
        self.redraw()

    def clear_roi(self):
        self.roi = None
        self.redraw()

    def identify_current(self):
        """The spots of the current frame on the device (K4)."""
        frame = np.asarray(self.movie[self.frame_number])
        y, x, ng = localize.identify_in_frame(
            frame.astype(np.float32), self.min_net_gradient, self.box,
            roi=self.roi, device=self.device)
        return frame, x, y, ng

    def redraw(self):
        import matplotlib.patches as patches

        frame, x, y, ng = self.identify_current()
        lo, hi = np.percentile(frame, self.contrast_percentiles)
        self.ax.clear()
        self.ax.imshow(frame, cmap="gray", interpolation="nearest",
                       vmin=lo, vmax=max(hi, lo + 1))
        half = self.box // 2
        for xi, yi in zip(x, y):
            self.ax.add_patch(patches.Rectangle(
                (xi - half - 0.5, yi - half - 0.5), self.box, self.box,
                fill=False, edgecolor="red"))
        if self.roi is not None:
            (y0, x0), (y1, x1) = self.roi
            self.ax.add_patch(patches.Rectangle(
                (x0 - 0.5, y0 - 0.5), x1 - x0, y1 - y0, fill=False,
                edgecolor="cyan", linestyle="--"))
        self.ax.set_title(
            f"frame {self.frame_number + 1}/{len(self.movie)} — "
            f"{len(x)} spots (min_ng={self.min_net_gradient:g})")
        self.fig.canvas.draw_idle()
        return len(x)

    def localize_movie(self, out_path: str | None = None,
                       fitting_method: str | None = None):
        """Run the full identify+fit pipeline at the current
        parameters on the device and save _locs.hdf5 + yaml — the
        reference's identify/fit worker chain (gui/localize.py
        IdentificationWorker / FitWorker)."""
        method = fitting_method or self.fitting_method
        parameters = {"Min. Net Gradient": self.min_net_gradient,
                      "Box Size": self.box}
        self.status(f"Localizing ({method})...")
        locs, new_info = localize.localize(
            self.movie, dict(self.camera_info), parameters, roi=self.roi,
            movie_info=list(self.info), fitting_method=method,
            identification_progress_callback=lambda v: self.status(
                f"identify {v}"),
            return_info=True, device=self.device)
        if out_path is not None:
            io.save_locs(out_path, locs, new_info)
            self.status(f"Saved {len(locs)} locs to {out_path}")
        return locs, new_info

    def fit_from_identifications(self, path: str,
                                 out_path: str | None = None,
                                 fitting_method: str | None = None):
        """File > Load locs as identifications (gui/localize.py):
        refit the CURRENT movie at spot positions loaded from a saved
        identifications/locs HDF5 — e.g. to refit with a different
        method or camera parameters without re-identifying."""
        ids, ids_info = io.load_identifications(path)
        method = fitting_method or self.fitting_method
        self.status(f"Fitting {len(ids)} loaded identifications "
                    f"({method})...")
        locs, new_info = localize.fit2D(
            self.movie, list(self.info) + list(ids_info),
            dict(self.camera_info), ids, self.box, fitting_method=method,
            device=self.device)
        new_info = list(self.info) + [new_info]
        if out_path is not None:
            io.save_locs(out_path, locs, new_info)
            self.status(f"Saved {len(locs)} locs to {out_path}")
        return locs, new_info

    def _on_key(self, event):
        if event.key == "right":
            self.frame_number = min(self.frame_number + 1,
                                    len(self.movie) - 1)
        elif event.key == "left":
            self.frame_number = max(self.frame_number - 1, 0)
        elif event.key == "up":
            self.min_net_gradient *= 1.25
        elif event.key == "down":
            self.min_net_gradient /= 1.25
        else:
            return
        self.redraw()

    def localize_movie_3d(self, calibration, out_path: str | None = None,
                          fitting_method: str | None = None,
                          magnification_factor: float | None = None):
        """3D localize: 2D fit then astigmatism z fit against a
        calibration (dict or yaml path) — the reference FitZWorker
        chain (picasso/gui/localize.py:3067)."""
        method = fitting_method or self.fitting_method
        self.status(f"Localizing 3D ({method})...")
        locs, new_info = localize.localize_3D(
            self.movie, movie_info=list(self.info),
            camera_info=dict(self.camera_info), box=self.box,
            minimum_ng=self.min_net_gradient, calibration_3d=calibration,
            roi=self.roi, fitting_method=method, device=self.device)
        if out_path is not None:
            io.save_locs(out_path, locs, new_info)
            self.status(f"Saved {len(locs)} 3D locs to {out_path}")
        return locs, new_info

    def calibrate_z(self, d: float, magnification_factor: float,
                    path: str | None = None):
        """'Calibrate 3D' on a z-stepped bead stack: 2D-fit the movie,
        then fit the 6th-order sx/sy-vs-z polynomials (reference
        FitZWorker calibration arm + zfit.calibrate_z,
        picasso/gui/localize.py:3067, picasso/zfit.py:46)."""
        from picasso_torch import zfit

        locs, new_info = self.localize_movie()
        calibration = zfit.calibrate_z(locs, new_info, d,
                                       magnification_factor, path=path)
        self.status("Z calibration done" + (f" -> {path}" if path else ""))
        return calibration

    def quality_check(self, locs, info) -> dict:
        """Post-fit QC metrics — the reference QualityWorker
        (picasso/gui/localize.py:3114): NeNA precision, mean binding
        event length, mean RCC drift."""
        drift_x, drift_y = localize.check_drift(locs, info,
                                                device=self.device)
        out = {
            "NeNA (px)": localize.check_nena(locs, info, device=self.device),
            "Mean event length (frames)": localize.check_kinetics(
                locs, info, device=self.device),
            "Mean drift x (px)": drift_x,
            "Mean drift y (px)": drift_y,
        }
        self.status("QC: " + ", ".join(f"{k}={v:.4g}"
                                       for k, v in out.items()))
        return out

    def save_spots(self, path: str, camera_info: dict | None = None):
        """Identify the whole movie at the current parameters and save
        the cut ROIs (.npy/.tif + yaml), like the reference Localize
        app's 'Save spots' (picasso/gui/localize.py:2762)."""
        ids = localize.identify(self.movie, self.min_net_gradient, self.box,
                                return_info=False, device=self.device)
        camera_info = camera_info or {"Baseline": 0, "Sensitivity": 1,
                                      "Gain": 1}
        spots = localize.get_spots(self.movie, ids, self.box, camera_info,
                                   device=self.device)
        info = list(self.info) + [{
            "Generated by": "picasso-tpu Localize spots",
            "Min. Net Gradient": self.min_net_gradient,
            "Box Size": self.box,
        }]
        io.save_spots(path, np.asarray(spots), info)
        return len(ids)


class FilterApp(_PluginHost):
    """Locs-table filter — capability analogue of the reference Filter
    app (picasso/gui/filter.py: TableModel :37, HistWindow :197,
    Hist2DWindow :256, Window.apply_range :736 / apply_range2d :767).

    Filtering is mask-based like the reference (the original table is
    kept; a boolean index accumulates), so million-row tables filter
    without copies until ``save``/``locs`` materializes the view."""

    def __init__(self, locs: np.ndarray, info: list[dict], fig=None,
                 device="cuda"):
        import matplotlib.pyplot as plt  # noqa: F401

        lib.resolve_device(device)
        self.device = device
        self.original = locs
        self.info = info
        self._mask = np.ones(len(locs), dtype=bool)
        # history entries: ("1d", col, lo, hi) |
        # ("2d", cx, cy, xlo, xhi, ylo, yhi) |
        # ("lasso", cx, cy, vertices)
        self.history: list[tuple] = []
        self.fig = fig or self._new_fig(figsize=(7, 5))
        self.ax = self.fig.add_subplot(111)
        names = locs.dtype.names
        self.current_column = "photons" if "photons" in names else names[0]
        self._init_plugins("filter")
        self.plot_histogram(self.current_column)

    # -- table surface (TableModel parity, filter.py:37) --
    @property
    def locs(self) -> np.ndarray:
        """The filtered view, materialized."""
        if self._mask.all():
            return self.original
        return self.original[self._mask]

    @locs.setter
    def locs(self, value: np.ndarray):
        # legacy assignment support: replace the table outright
        self.original = value
        self._mask = np.ones(len(value), dtype=bool)
        self.history = []

    @property
    def n_filtered(self) -> int:
        return int(self._mask.sum())

    def table(self, start: int = 0, stop: int = 20) -> np.ndarray:
        """One page of the filtered table (the reference shows the
        table in a QTableView; scripted sessions page through it)."""
        return self.locs[start:stop]

    def get_column(self, column: str) -> np.ndarray:
        return self.original[column][self._mask]

    # -- plotting --
    def plot_histogram(self, column: str):
        self.current_column = column
        data = self.get_column(column)
        bins = lib.calculate_optimal_bins(data, max_n_bins=200)
        self.ax.clear()
        self.ax.hist(data, bins=bins)
        self.ax.set_xlabel(column)
        self.ax.set_ylabel("count")
        self.ax.set_title(f"{self.n_filtered} locs")
        self.fig.canvas.draw_idle()

    def plot_hist2d(self, col_x: str, col_y: str, fig=None):
        """2D histogram of two columns with log counts
        (Hist2DWindow, filter.py:256)."""
        from matplotlib.colors import LogNorm

        fig = fig or self._new_fig(figsize=(6, 6))
        ax = fig.add_subplot(111)
        x = self.get_column(col_x)
        y = self.get_column(col_y)
        bins_x = lib.calculate_optimal_bins(x, max_n_bins=200)
        bins_y = lib.calculate_optimal_bins(y, max_n_bins=200)
        counts, _, _, im = ax.hist2d(x, y, bins=[bins_x, bins_y],
                                     norm=LogNorm())
        ax.set_xlabel(col_x)
        ax.set_ylabel(col_y)
        fig.colorbar(im, ax=ax)
        return fig

    # -- filtering (Window.apply_range :736 / apply_range2d :767) --
    def apply_filter(self, column: str, lo: float, hi: float):
        vals = self.original[column]
        self._mask &= (vals >= lo) & (vals <= hi)
        self.history.append(("1d", column, lo, hi))
        self.plot_histogram(self.current_column)
        return self.n_filtered

    def apply_filter_2d(self, col_x: str, col_y: str, x_lo: float,
                        x_hi: float, y_lo: float, y_hi: float):
        """Rectangle selection in a 2D histogram — keep locs inside
        the rectangle (Hist2DWindow.on_rect_select, filter.py:344)."""
        x = self.original[col_x]
        y = self.original[col_y]
        self._mask &= (x >= x_lo) & (x <= x_hi) & (y >= y_lo) & (y <= y_hi)
        self.history.append(("2d", col_x, col_y, x_lo, x_hi, y_lo, y_hi))
        self.plot_histogram(self.current_column)
        return self.n_filtered

    def apply_lasso(self, col_x: str, col_y: str, vertices: list):
        """Free-form polygon selection in column space — keep locs
        whose (col_x, col_y) fall inside the lasso."""
        from matplotlib.path import Path

        pts = np.column_stack([self.original[col_x], self.original[col_y]])
        self._mask &= Path(np.asarray(vertices, float)).contains_points(pts)
        self.history.append(("lasso", col_x, col_y, list(vertices)))
        self.plot_histogram(self.current_column)
        return self.n_filtered

    def undo(self):
        """Drop the last filter step and recompute the mask."""
        if not self.history:
            return self.n_filtered
        steps = self.history[:-1]
        self._mask = np.ones(len(self.original), dtype=bool)
        self.history = []
        apply = {"1d": self.apply_filter, "2d": self.apply_filter_2d,
                 "lasso": self.apply_lasso}
        for kind, *args in steps:
            apply[kind](*args)
        self.plot_histogram(self.current_column)
        return self.n_filtered

    def undo_all(self):
        self._mask = np.ones(len(self.original), dtype=bool)
        self.history = []
        self.plot_histogram(self.current_column)

    def plot_subclustering(self, clustering_dist: float = 25,
                           sparse_dist: float = 80, fig=None):
        """Subclustering check on clustered molecules (SubclusterNum,
        filter.py:458; clusterer.test_subclustering on the device)."""
        from picasso_torch import clusterer

        n_events_cl, n_events_sp = clusterer.test_subclustering(
            self.locs, self.info, clustering_dist=clustering_dist,
            sparse_dist=sparse_dist, device=self.device)
        fig = fig or self._new_fig(figsize=(6, 4))
        ax = fig.add_subplot(111)
        bins = np.arange(0, max(
            n_events_cl.max() if len(n_events_cl) else 1,
            n_events_sp.max() if len(n_events_sp) else 1) + 2)
        ax.hist([n_events_cl, n_events_sp], bins=bins, density=True,
                label=["clustered", "sparse"])
        ax.set_xlabel("binding events per molecule")
        ax.legend()
        return fig, (n_events_cl, n_events_sp)

    def save(self, path: str):
        new_info = self.info + [{
            "Generated by": "Picasso Filter",
            "Filters": [{"Column": c, "Min": lo, "Max": hi}
                        for kind, c, lo, hi in (
                            s for s in self.history if s[0] == "1d")],
            "Filters 2D": [
                {"Column X": cx, "Column Y": cy, "Min X": xlo,
                 "Max X": xhi, "Min Y": ylo, "Max Y": yhi}
                for kind, cx, cy, xlo, xhi, ylo, yhi in (
                    s for s in self.history if s[0] == "2d")],
        }]
        if path.lower().endswith(".csv"):
            # File > Export as CSV (gui/filter.py): ThunderSTORM-
            # compatible table, same exporter as Render's
            io.export_ts(path, self.locs, new_info)
        else:
            io.save_locs(path, self.locs, new_info)
