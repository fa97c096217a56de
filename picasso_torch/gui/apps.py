"""The secondary GUI apps of the port: the rotation window, particle
averaging in 2D and 3D, the simulation designer, the origami plate
designer, SPINNA, nanotron and the movie-to-raw converter
(picasso_tpu/gui/apps.py; picasso/gui/rotation.py, average.py,
simulate.py, design.py, spinna.py, nanotron.py, toraw.py).

Each app is a thin matplotlib shell whose analysis is the library call
a script would make, so that its results are the script's. Locs are
numpy structured arrays where the JAX package's apps take DataFrames.
An app whose analysis runs on a device takes ``device`` (the card by
default) and passes it to the port's call: ``render.render``,
``average.average``, ``average3.average3``, the ``spinna`` fits and the
``nanotron`` renders, training and predictions. Without a card those
raise, as every entry point of the port does. matplotlib is imported in
the constructors; every app builds on the Agg backend.

The plugin surface comes from picasso_torch.gui.base, which
gui/viewers.py imports too, as the JAX package's does.
RotationApp passes the table as it holds it to the rotated render, z in
nm beside x and y in camera pixels, as the JAX package's window does
(picasso_tpu/gui/apps.py:64-74; render.locs_rotation).
"""

from __future__ import annotations

import os

import numpy as np

from picasso_torch import io, lib, render
from picasso_torch.gui.base import _has, _n_groups, _PluginHost


class RotationApp(_PluginHost):
    """3D rotation window (picasso/gui/rotation.py): renders the locs
    under an interactive rotation on ``device``. Arrow keys rotate, +/-
    zoom."""

    def __init__(self, locs: np.ndarray, info: list[dict],
                 blur_method: str | None = "gaussian",
                 oversampling: float = 8.0, fig=None, device="cuda"):
        import matplotlib.pyplot as plt  # noqa: F401

        if not _has(locs, "z"):
            raise ValueError("RotationApp needs 3D locs (z column)")
        self.locs = locs
        self.info = info
        self.blur_method = blur_method
        self.oversampling = oversampling
        self.device = device
        self.angles = [0.0, 0.0, 0.0]  # rotation around x, y, z
        self.show_axes = True
        self.last_image = None
        self.keyframes: list[tuple[list[float], float]] = []
        height = lib.get_from_metadata(info, "Height")
        width = lib.get_from_metadata(info, "Width")
        self.viewport = ((0.0, 0.0), (float(height), float(width)))
        self.fig = fig or self._new_fig(figsize=(7, 7))
        self.ax = self.fig.add_subplot(111)
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self._init_plugins("rotation")
        self.redraw()

    def render_frame(self, angles=None, oversampling=None
                     ) -> tuple[np.ndarray, int]:
        """One rotated view as RGB with the axis tripod and the angles
        painted in (render.draw_rotation, draw_rotation_angles)."""
        ang = tuple(self.angles if angles is None else angles)
        n, image = render.render(
            self.locs, self.info,
            oversampling=(self.oversampling if oversampling is None
                          else oversampling),
            viewport=self.viewport, blur_method=self.blur_method, ang=ang,
            device=self.device)
        image = render.scale_contrast(image, autoscale=True)
        rgb = render.apply_colormap(render.to_8bit(image), "hot")
        if self.show_axes:
            rgb = render.draw_rotation(rgb, ang)
            rgb = render.draw_rotation_angles(rgb, ang)
        return rgb, n

    def redraw(self):
        rgb, n = self.render_frame()
        self.last_image = rgb
        self.ax.clear()
        self.ax.imshow(rgb, interpolation="nearest")
        self.ax.set_title("rot x/y/z = " + "/".join(
            f"{np.degrees(a):.0f}°" for a in self.angles))
        self.fig.canvas.draw_idle()
        return n

    def rotate(self, dx=0.0, dy=0.0, dz=0.0):
        self.angles[0] += dx
        self.angles[1] += dy
        self.angles[2] += dz
        self.redraw()

    def save_rotated_locs(self, path: str, pick=None,
                          pick_shape: str = "Circle",
                          pick_size: float | None = None):
        """Save the locs, unrotated, with the rotation state appended to
        the info chain (picasso/gui/rotation.py:2112): Pick, Pick shape,
        Pick size (nm), angx..z and the quaternion, from which the
        render window restores the view."""
        from scipy.spatial.transform import Rotation

        pixelsize = lib.get_from_metadata(self.info, "Pixelsize", 130)
        ax, ay, az = self.angles
        quat = Rotation.from_euler("xyz", [ax, ay, az]).as_quat()
        new_info = {
            "Generated by": "picasso-tpu Render 3D",
            "Pick shape": pick_shape,
            "angx": float(ax),
            "angy": float(ay),
            "angz": float(az),
            "Quaternion (x, y, z, w)": [float(q) for q in quat],
        }
        if pick is not None:
            new_info["Pick"] = pick
        if pick_size is not None:
            new_info["Pick size (nm)"] = float(pick_size * pixelsize)
        io.save_locs(path, self.locs, list(self.info) + [new_info])

    def export_view(self, path: str):
        """Export the current rotated view (picasso/gui/rotation.py
        'Export current view')."""
        if self.last_image is None:
            self.redraw()
        render._export_image(self.last_image, path)

    # keyframe animations (picasso/gui/rotation.py AnimationDialog: add
    # positions, then build a movie between them)
    def add_keyframe(self):
        self.keyframes.append((list(self.angles), float(self.oversampling)))
        return len(self.keyframes)

    def clear_keyframes(self):
        self.keyframes = []

    def build_animation(self, path: str, n_frames_between: int = 15,
                        fps: int = 15) -> int:
        """Render frames between the keyframes, angles and zoom
        interpolated, and write a GIF or mp4 (render.build_animation).
        Returns the frame count."""
        if len(self.keyframes) < 2:
            raise ValueError("Add at least 2 keyframes first.")
        frames = []
        for (a0, o0), (a1, o1) in zip(self.keyframes[:-1],
                                      self.keyframes[1:]):
            for t in np.linspace(0, 1, n_frames_between, endpoint=False):
                ang = [(1 - t) * u + t * v for u, v in zip(a0, a1)]
                rgb, _ = self.render_frame(ang, (1 - t) * o0 + t * o1)
                frames.append(rgb)
        rgb, _ = self.render_frame(*self.keyframes[-1])
        frames.append(rgb)
        render.build_animation(path, frames, fps=fps)
        return len(frames)

    def _on_key(self, event):
        step = np.radians(10)
        if event.key == "left":
            self.rotate(dy=-step)
        elif event.key == "right":
            self.rotate(dy=step)
        elif event.key == "up":
            self.rotate(dx=-step)
        elif event.key == "down":
            self.rotate(dx=step)
        elif event.key in ("+", "="):
            self.oversampling *= 1.25
            self.redraw()
        elif event.key == "-":
            self.oversampling /= 1.25
            self.redraw()


class AverageApp(_PluginHost):
    """2D particle averaging (picasso/gui/average.py): the iterative
    rotation and translation alignment on ``device``, with the averaged
    render after each run."""

    def __init__(self, picked_locs: np.ndarray, info: list[dict],
                 oversampling: float = 40.0, fig=None, device="cuda"):
        import matplotlib.pyplot as plt  # noqa: F401

        if not _has(picked_locs, "group"):
            raise ValueError("AverageApp needs grouped (picked) locs")
        self.locs = picked_locs
        self.info = info
        self.oversampling = oversampling
        self.device = device
        self.iterations_done = 0
        self.fig = fig or self._new_fig(figsize=(6, 6))
        self.ax = self.fig.add_subplot(111)
        self._init_plugins("average")
        self.redraw()

    def run(self, iterations: int = 3, progress=None):
        from picasso_torch import average as _average

        self.locs = _average.average(self.locs, self.info,
                                     iterations=iterations,
                                     progress_callback=progress,
                                     device=self.device)
        self.iterations_done += iterations
        self.redraw()
        return self.locs

    def redraw(self):
        half = 1.5
        cx = float(self.locs["x"].mean())
        cy = float(self.locs["y"].mean())
        viewport = ((cy - half, cx - half), (cy + half, cx + half))
        n, image = render.render(self.locs, self.info,
                                 oversampling=self.oversampling,
                                 viewport=viewport, blur_method="smooth",
                                 device=self.device)
        image = render.scale_contrast(image, autoscale=True)
        self.ax.clear()
        self.ax.imshow(image, cmap="magma", interpolation="nearest")
        self.ax.set_title(f"{_n_groups(self.locs)} particles, "
                          f"{self.iterations_done} iterations")
        self.fig.canvas.draw_idle()
        return n

    def save(self, path: str):
        from picasso_torch import average as _average

        # shift the origin-centred average back into the field of view:
        # the save-time sanity filter drops negative coordinates
        out, new_info = _average.prepare_locs_for_save(
            self.locs, self.info, {"it": self.iterations_done})
        io.save_locs(path, out, new_info)


class Average3App(_PluginHost):
    """3D particle averaging (picasso/gui/average3.py): rotation scans
    around x/y/z on ``device`` with projections of the result."""

    def __init__(self, picked_locs: np.ndarray, info: list[dict],
                 oversampling: float = 10.0, fig=None, device="cuda"):
        import matplotlib.pyplot as plt  # noqa: F401

        if not (_has(picked_locs, "group") and _has(picked_locs, "z")):
            raise ValueError(
                "Average3App needs grouped 3D locs (group + z columns)")
        self.locs = picked_locs
        self.info = info
        self.oversampling = oversampling
        self.device = device
        self.iterations_done = 0
        self.fig = fig or self._new_fig(figsize=(10, 4))
        self.axes = [self.fig.add_subplot(1, 3, i + 1) for i in range(3)]
        self._init_plugins("average3")
        self.redraw()

    def run(self, iterations: int = 3, rot_axes=("z", "x", "y"),
            progress=None):
        from picasso_torch import average3 as _average3

        self.locs = _average3.average3(
            self.locs, self.info, iterations=iterations,
            oversampling=self.oversampling, rot_axes=tuple(rot_axes),
            progress_callback=progress, device=self.device)
        self.iterations_done += iterations
        self.redraw()
        return self.locs

    def redraw(self):
        pixelsize = lib.get_from_metadata(self.info, "Pixelsize", 130)
        x = self.locs["x"] - self.locs["x"].mean()
        y = self.locs["y"] - self.locs["y"].mean()
        z = (self.locs["z"] - self.locs["z"].mean()) / pixelsize
        r = 2.0
        for ax, (name, a, b) in zip(self.axes, [("xy", x, y), ("xz", x, z),
                                                ("yz", y, z)]):
            ax.clear()
            H, *_ = np.histogram2d(b, a, bins=int(2 * r * self.oversampling),
                                   range=[[-r, r], [-r, r]])
            ax.imshow(H, cmap="magma", interpolation="nearest")
            ax.set_title(name)
            ax.set_xticks([])
            ax.set_yticks([])
        self.fig.suptitle(f"{_n_groups(self.locs)} particles, "
                          f"{self.iterations_done} iterations")
        self.fig.canvas.draw_idle()

    def save(self, path: str):
        from picasso_torch import average3 as _average3

        out, new_info = _average3.prepare_locs_for_save(
            self.locs, self.info, {"Iterations": self.iterations_done,
                                   "Oversampling": self.oversampling})
        io.save_locs(path, out, new_info)


class SimulateApp(_PluginHost):
    """Simulation designer (picasso/gui/simulate.py): the simulation's
    parameters, a movie from picasso_torch.simulate (host numpy), frame
    previews, the structure builders, and the movie saved as raw."""

    def __init__(self, fig=None, **params):
        import matplotlib.pyplot as plt  # noqa: F401

        self.params = dict(n_sites=20, imagesize=32, frames=100, psf=0.82,
                           photonrate=50.0, photonratestd=10.0,
                           photonbudget=1.5e6, taud=5000.0, taub=500.0,
                           itime=300.0, background=1.0, seed=0)
        self.params.update(params)
        self.movie = None
        self.info = None
        self.ground_truth = None
        self.frame_number = 0
        self.fig = fig or self._new_fig(figsize=(6, 6))
        self.ax = self.fig.add_subplot(111)
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self._init_plugins("simulate")

    def run(self):
        from picasso_torch import simulate as _simulate

        self.movie, self.ground_truth, self.info = _simulate.simulate_movie(
            **self.params)
        self.frame_number = 0
        self.redraw()
        return self.movie, self.info

    def redraw(self):
        self.ax.clear()
        if self.movie is None:
            self.ax.set_title("no simulation yet — call run()")
        else:
            self.ax.imshow(self.movie[self.frame_number], cmap="gray",
                           interpolation="nearest")
            self.ax.set_title(
                f"frame {self.frame_number + 1}/{len(self.movie)}")
        self.fig.canvas.draw_idle()

    def _on_key(self, event):
        if self.movie is None:
            return
        if event.key == "right":
            self.frame_number = min(self.frame_number + 1,
                                    len(self.movie) - 1)
        elif event.key == "left":
            self.frame_number = max(self.frame_number - 1, 0)
        else:
            return
        self.redraw()

    def save(self, path: str):
        if self.movie is None:
            raise RuntimeError("run() the simulation first")
        io.save_raw(path, self.movie, [self.info])

    # the structure designer (picasso/gui/simulate.py:1101 structure
    # types GRID / CIRCLE / CUSTOM)
    def grid_structure(self, columns: int = 3, rows: int = 4,
                       spacing_x: float = 20.0, spacing_y: float = 20.0,
                       exchange: int = 1, pixelsize: float = 130.0):
        from picasso_torch import simulate as _simulate

        xx, yy = np.meshgrid(np.arange(columns) * spacing_x,
                             np.arange(rows) * spacing_y)
        n = columns * rows
        self.structure = _simulate.defineStructure(
            xx.ravel(), yy.ravel(), np.full(n, exchange, int), np.zeros(n),
            pixelsize)
        return self.structure

    def circle_structure(self, n_labels: int = 12, diameter: float = 100.0,
                         exchange: int = 1, pixelsize: float = 130.0):
        from picasso_torch import simulate as _simulate

        ang = 2 * np.pi * np.arange(n_labels) / n_labels
        self.structure = _simulate.defineStructure(
            diameter / 2 * np.cos(ang), diameter / 2 * np.sin(ang),
            np.full(n_labels, exchange, int), np.zeros(n_labels), pixelsize)
        return self.structure

    def custom_structure(self, xx_nm, yy_nm, exchange=None, structure3d=None,
                         pixelsize: float = 130.0):
        from picasso_torch import simulate as _simulate

        xx_nm = np.asarray(xx_nm, float)
        if exchange is None:
            exchange = np.ones(len(xx_nm), int)
        if structure3d is None:
            structure3d = np.zeros(len(xx_nm))
        self.structure = _simulate.defineStructure(
            xx_nm, yy_nm, exchange, structure3d, pixelsize)
        return self.structure

    def plot_structure(self, fig=None):
        """Scatter preview coloured by exchange round
        (picasso/gui/simulate.py:1921 plotStructure)."""
        if getattr(self, "structure", None) is None:
            raise RuntimeError("define a structure first")
        fig = fig or self._new_fig(figsize=(5, 5))
        ax = fig.add_subplot(111)
        xx, yy, ex = self.structure[0], self.structure[1], self.structure[2]
        for e in np.unique(ex):
            sel = ex == e
            ax.scatter(xx[sel], yy[sel], label=f"exchange {int(e)}")
        ax.set_aspect("equal")
        ax.legend()
        return fig

    def generate_positions(self, number: int = 50, frame: int = 3,
                           arrangement: int = 1):
        """Structure origins over the field of view
        (picasso/gui/simulate.py:1944 generatePositions)."""
        from picasso_torch import simulate as _simulate

        self.positions = _simulate.generatePositions(
            number, self.params["imagesize"], frame, arrangement)
        return self.positions

    def plot_positions(self, fig=None):
        if getattr(self, "positions", None) is None:
            raise RuntimeError("generate_positions() first")
        fig = fig or self._new_fig(figsize=(5, 5))
        ax = fig.add_subplot(111)
        ax.scatter(self.positions[:, 0], self.positions[:, 1], s=8)
        ax.set_xlim(0, self.params["imagesize"])
        ax.set_ylim(0, self.params["imagesize"])
        ax.set_aspect("equal")
        return fig

    def calibrate_noise(self, bg, bgstd, laser, itime, conc):
        """The noise model's coefficients from measured statistics
        (picasso/gui/simulate.py:2123 calibrateNoise)."""
        from picasso_torch import simulate as _simulate

        return _simulate.calibrate_noise_model(bg, bgstd, laser, itime, conc)

    def import_design(self, path: str, pixelsize: float = 130.0):
        """A Design yaml (Structure.StructureX/Y/Ex, comma-separated) as
        the custom structure (picasso/gui/simulate.py:1770)."""
        info = io.load_info(path)

        def values(key, kind):
            return [kind(v) for v in str(info[0][key]).split(",") if v]

        return self.custom_structure(
            values("Structure.StructureX", float),
            values("Structure.StructureY", float),
            exchange=values("Structure.StructureEx", int),
            pixelsize=pixelsize)


# The hexagonal rectangular-origami (RRO) staple lattice of the
# reference's editor (picasso/gui/design.py:164-293): 12 structure rows x
# 16 columns of flat-top hexagons without the 16 biotin/void sites; the
# canvas label of site (row, col) is letter(col) + str(row + 1) (letters
# A..P run over the 16 columns, numbers 1..12 over the rows), and the
# base staple table (design_sequences.base_sequences) lists the sites
# [(row, col) for row in 12 for col in 16] without the removed ones.
DESIGN_ROWS = 12
DESIGN_COLUMNS = 16
_ROW_LETTERS = list("ABCDEFGHIJKLMNOP")  # canvas letters, one a column
HEX_SIDE_HALF = 20  # gui/design.py:164
IND2REMOVE = frozenset(
    (r, c) for c in (2, 6, 10, 14) for r in (1, 2, 8, 9)
)  # gui/design.py:194 ind2remove
ORIGAMI_SITES = [
    (r, c)
    for r in range(DESIGN_ROWS)
    for c in range(DESIGN_COLUMNS)
    if (r, c) not in IND2REMOVE
]
# display palette (reference rgbcolors, colour scheme 0, :260)
DESIGN_RGB = {
    0: (205, 205, 205), 1: (166, 206, 227), 2: (31, 120, 180),
    3: (178, 223, 138), 4: (51, 160, 44), 5: (251, 154, 153),
    6: (227, 26, 28), 7: (253, 191, 111),
}


class DesignApp(_PluginHost):
    """Hexagonal origami designer (picasso/gui/design.py Scene :848,
    Window :1722): paint extension sites on the RRO staple lattice by
    clicking, give each colour one DNA-PAINT docking handle (SeqDialog
    :422, handles from design_sequences.paint_sequences), and export
    pipetting plate lists as the reference's readCanvas and preparePlate
    make them (:1224/:1261). Host code."""

    MAXCOLOR = 8  # palette: colours 1..7 paint, the 8th slot erases

    #: display names kept for the plugin surface
    COLORS = ["lightgrey", "red", "green", "blue", "orange", "purple",
              "cyan", "magenta"]

    def __init__(self, fig=None):
        self.grid = np.zeros((DESIGN_ROWS, DESIGN_COLUMNS), dtype=np.int64)
        self.current_color = 1
        # docking-handle assignment per colour 1..7 (SeqDialog table)
        self.tableshort = ["None"] * 7
        self.tablelong = ["None"] * 7
        self.fig = fig or self._new_fig(figsize=(10, 6))
        self.ax = self.fig.add_subplot(111)
        self.fig.canvas.mpl_connect("button_press_event", self._on_click)
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self._init_plugins("design")
        self.redraw()

    # lattice geometry (gui/design.py:286 indextoHex)
    @staticmethod
    def index_to_hex(row: int, col: int) -> tuple[float, float]:
        """Hexagon centre in canvas units; odd columns drop half a row
        pitch."""
        x = col * 1.5 * HEX_SIDE_HALF
        y = -(row + 0.5 * (col % 2)) * np.sqrt(3) * HEX_SIDE_HALF
        return x, y

    @staticmethod
    def index_to_str(row: int, col: int) -> str:
        """Canvas label, e.g. (0, 0) -> 'A1' (indextoStr :296)."""
        return _ROW_LETTERS[col] + str(row + 1)

    @staticmethod
    def site_nm(row: int, col: int) -> tuple[float, float]:
        """Site position in nm for Simulate: the reference's allcords
        scaling (gui/design.py:916), a 5 nm column pitch."""
        return 5.0 * col, 2.5 + 5.0 * row + 2.5 * (col % 2)

    # palette swatches: one column of hexes right of the grid
    _PALETTE_COL = DESIGN_COLUMNS + 2

    def _palette_positions(self):
        for k in range(1, self.MAXCOLOR + 1):
            yield k, self.index_to_hex(k - 1, self._PALETTE_COL)

    # extensions (SeqDialog :422)
    def set_extension(self, color: int, shortname: str):
        """Give paint colour ``color`` (1..7) the docking handle
        ``shortname`` (e.g. 'P1', '5xR1'; 'None' clears)."""
        from picasso_torch import design_sequences as _seqs

        if not 1 <= color <= 7:
            raise ValueError(f"colour {color} is not one of 1..7")
        if shortname == "None":
            self.tableshort[color - 1] = "None"
            self.tablelong[color - 1] = "None"
        else:
            self.tableshort[color - 1] = shortname
            self.tablelong[color - 1] = _seqs.get_paint_sequence(shortname)
        self.redraw()

    def color_counts(self) -> list[int]:
        """Sites per colour [1..7, 0] (evaluateCanvas :1075 order)."""
        colors = self.canvas_colors()
        return [colors.count(k) for k in range(1, 8)] + [colors.count(0)]

    def canvas_colors(self) -> list[int]:
        """Colour of each site in ORIGAMI_SITES (= base-table) order."""
        return [int(self.grid[s]) for s in ORIGAMI_SITES]

    # drawing
    def _hex_patch(self, cx, cy, color, scale=1.0, **kw):
        import matplotlib.patches as mpatches

        s = HEX_SIDE_HALF * scale
        verts = [
            (cx - s, cy), (cx - 0.5 * s, cy + 0.866 * s),
            (cx + 0.5 * s, cy + 0.866 * s), (cx + s, cy),
            (cx + 0.5 * s, cy - 0.866 * s), (cx - 0.5 * s, cy - 0.866 * s),
        ]
        rgb = tuple(v / 255 for v in DESIGN_RGB[color % 8])
        return mpatches.Polygon(verts, closed=True, facecolor=rgb,
                                edgecolor="black", linewidth=0.8, **kw)

    def redraw(self):
        self.ax.clear()
        for r, c in ORIGAMI_SITES:
            x, y = self.index_to_hex(r, c)
            self.ax.add_patch(self._hex_patch(x, y, int(self.grid[r, c])))
        for k, (x, y) in self._palette_positions():
            self.ax.add_patch(self._hex_patch(x, y, 0 if k == 8 else k,
                                              scale=0.9))
            if k == self.current_color or (k == 8
                                           and self.current_color == 0):
                self.ax.add_patch(self._hex_patch(x, y, 0, scale=1.05,
                                                  fill=False))
        self.ax.set_xlim(-2 * HEX_SIDE_HALF,
                         (self._PALETTE_COL + 2) * 1.5 * HEX_SIDE_HALF)
        self.ax.set_ylim(-(DESIGN_ROWS + 1) * np.sqrt(3) * HEX_SIDE_HALF,
                         2 * HEX_SIDE_HALF)
        self.ax.set_aspect("equal")
        self.ax.set_axis_off()
        n_ext = int(sum(1 for s in ORIGAMI_SITES if self.grid[s] > 0))
        ext = (self.tableshort[self.current_color - 1]
               if 1 <= self.current_color <= 7 else "erase")
        self.ax.set_title(f"{n_ext} extended staples - color "
                          f"{self.current_color} ({ext})")
        self.fig.canvas.draw_idle()

    # interaction (Scene.mousePressEvent :1041)
    def _on_click(self, event):
        if event.inaxes != self.ax or event.xdata is None:
            return
        r_click = HEX_SIDE_HALF * HEX_SIDE_HALF
        for k, (x, y) in self._palette_positions():  # the palette first
            if (x - event.xdata) ** 2 + (y - event.ydata) ** 2 < r_click:
                self.current_color = 0 if k == 8 else k
                self.redraw()
                return
        best = None
        for r, c in ORIGAMI_SITES:
            x, y = self.index_to_hex(r, c)
            d2 = (x - event.xdata) ** 2 + (y - event.ydata) ** 2
            if best is None or d2 < best[0]:
                best = (d2, r, c)
        if best and best[0] < r_click:
            _, r, c = best
            # clicking with the site's own colour erases it (:1069)
            self.grid[r, c] = (0 if self.grid[r, c] == self.current_color
                               else self.current_color)
            self.redraw()

    def _on_key(self, event):
        if event.key and event.key.isdigit():
            self.current_color = min(int(event.key), 7)
            self.redraw()

    def clear_canvas(self):
        """Reset the sites and extensions (Scene.clearCanvas :1121)."""
        self.grid[:] = 0
        self.tableshort = ["None"] * 7
        self.tablelong = ["None"] * 7
        self.redraw()

    # plate export (Scene.readCanvas :1224 / preparePlate :1261)
    def _base_rows(self):
        from picasso_torch import design_sequences as _seqs

        return [list(row) for row in _seqs.base_sequences[1:]]

    def to_plate(self) -> list:
        """Canvas rows [Position, Name, Sequence, colour] of every staple
        in base-table order; a coloured site's name swaps its 'BLK'
        suffix for the handle's short name and its sequence gains ' ' +
        the handle, as readCanvas (:1229-1263). A colour with no handle
        takes 'P<colour>', so a bare canvas still exports."""
        from picasso_torch import design_sequences as _seqs

        base = self._base_rows()
        out = [["Position", "Name", "Sequence", "Color"]]
        for i, (r, c) in enumerate(ORIGAMI_SITES):
            pos, name, seq = base[i][:3]
            color = int(self.grid[r, c])
            if color > 0:
                short = self.tableshort[color - 1]
                long = self.tablelong[color - 1]
                if short == "None":
                    short = f"P{color}"
                    long = _seqs.get_paint_sequence(short)
                name = name[:-3] + short
                seq = seq + " " + long
            out.append([pos, name, seq, color])
        return out

    def prepare_plate(self, mode: int) -> dict:
        """preparePlate (:1261): mode 1, one plate with the drawn
        modifications; mode 2, one full plate a used colour."""
        from picasso_torch import design as _design

        allplates = {}
        if mode == 2:
            for j, color in enumerate(sorted(set(self.canvas_colors()))):
                base = self._base_rows()
                if color == 0:
                    allplates[j] = _design.convertPlateIndex(base, "BLK")
                else:
                    short = self.tableshort[color - 1]
                    long = self.tablelong[color - 1]
                    for row in base:
                        row[2] = row[2] + " " + long
                        row[1] = row[1][:-3] + short
                    allplates[j] = _design.convertPlateIndex(base, short)
        elif mode == 1:
            plate = [row[:3] for row in self.to_plate()[1:]]
            allplates[0] = _design.convertPlateIndex(plate, "CUSTOM")
        return allplates

    def export_plates(self, path: str, platename: str = "CUSTOM"):
        from picasso_torch import design as _design

        data = _design.convertPlateIndexColor(self.to_plate(), platename)
        _design.savePlate(path, [data])
        return data

    # design yaml (Scene.saveCanvas :1154 / loadCanvas :1197)
    def structure_nm(self) -> tuple[list, list, list]:
        """The extended sites as nm coordinates for Simulate (the
        StructureX/Y/Ex vectors of saveCanvas)."""
        xs, ys, ex = [], [], []
        for r, c in ORIGAMI_SITES:
            color = int(self.grid[r, c])
            if color > 0:
                x, y = self.site_nm(r, c)
                xs.append(x)
                ys.append(y)
                ex.append(color)
        return xs, ys, ex

    def export_design(self, path: str):
        """Save the design yaml with saveCanvas' keys (:1154), which
        Simulate's 'Import design' reads (gui/simulate.py:1770)."""
        xs, ys, ex = self.structure_nm()
        structure = [[_ROW_LETTERS[c], r + 1, int(self.grid[r, c])]
                     for r, c in ORIGAMI_SITES]
        info = {
            "Generated by": "picasso-tpu Design",
            "Structure": structure,
            "Extensions Short": list(self.tableshort),
            "Extensions Long": list(self.tablelong),
            "Structure.StructureX": ", ".join(f"{v:f}" for v in xs),
            "Structure.StructureY": ", ".join(f"{v:f}" for v in ys),
            "Structure.StructureEx": ", ".join(str(v) for v in ex),
        }
        io.save_info(path, [info])

    def save_design(self, path: str):
        self.export_design(path)

    def load_design(self, path: str):
        """Load a design yaml of export_design or of the reference's
        saveCanvas (the same keys)."""
        info = io.load_info(path)
        self.grid[:] = 0
        letter_to_col = {s: i for i, s in enumerate(_ROW_LETTERS)}
        for letter, number, color in info[0]["Structure"]:
            self.grid[int(number) - 1, letter_to_col[letter]] = int(color)
        self.tableshort = list(info[0].get("Extensions Short",
                                           ["None"] * 7))
        self.tablelong = list(info[0].get("Extensions Long", ["None"] * 7))
        self.redraw()


class SpinnaApp(_PluginHost):
    """SPINNA front end (picasso/gui/spinna.py): the structures and the
    experiment's coordinates, the stoichiometry fit on ``device``, and
    the fitted proportions and NND histograms."""

    def __init__(self, fig=None, device="cuda"):
        import matplotlib.pyplot as plt  # noqa: F401

        self.structures = []
        self.exp_data: dict[str, np.ndarray] = {}
        self.mixer = None
        self.result = None
        self.device = device
        self.fig = fig or self._new_fig(figsize=(7, 5))
        self.ax = self.fig.add_subplot(111)
        self._init_plugins("spinna")

    def add_structure(self, structure):
        self.structures.append(structure)

    def load_structures(self, path: str):
        from picasso_torch import spinna as _spinna

        structures, targets = _spinna.load_structures(path)
        self.structures.extend(structures)
        return targets

    def set_experimental_data(self, target: str, coords: np.ndarray):
        self.exp_data[target] = np.asarray(coords, dtype=np.float64)

    def build_mixer(self, label_unc: dict, le: dict, width: float,
                    height: float, depth: float | None = None, **kwargs):
        from picasso_torch import spinna as _spinna

        self.mixer = _spinna.StructureMixer(
            self.structures, label_unc=label_unc, le=le, width=width,
            height=height, depth=depth, **kwargs)
        return self.mixer

    def fit(self, N_structures, N_sim: int = 1, **kwargs):
        from picasso_torch import spinna as _spinna

        if self.mixer is None:
            raise RuntimeError("build_mixer() first")
        fitter = _spinna.SPINNA(self.mixer, self.exp_data, N_sim=N_sim,
                                device=self.device)
        self.result = fitter.fit(N_structures, **kwargs)
        self.redraw()
        return self.result

    def redraw(self):
        self.ax.clear()
        if self.result is None:
            self.ax.set_title("no fit yet")
        else:
            opt_props, score = self.result[0], self.result[1]
            names = (self.mixer.get_structure_names()
                     if self.mixer is not None
                     else [str(i) for i in range(len(opt_props))])
            self.ax.bar(range(len(opt_props)), np.atleast_1d(opt_props))
            self.ax.set_xticks(range(len(names)))
            self.ax.set_xticklabels(names, rotation=45)
            self.ax.set_ylabel("fitted proportion")
            self.ax.set_title(f"KS score {float(score):.4f}")
        self.fig.canvas.draw_idle()

    # the Structures tab (picasso/gui/spinna.py:1325 StructuresTab)
    def new_structure(self, title: str):
        from picasso_torch import spinna as _spinna

        s = _spinna.Structure(title)
        self.structures.append(s)
        return s

    def set_structure_coordinates(self, index: int, target: str, x, y,
                                  z=None):
        self.structures[index].define_coordinates(target, x, y, z)
        return self.structures[index]

    def delete_structure_target(self, index: int, target: str):
        self.structures[index].delete_target(target)

    def save_structures(self, path: str):
        """All structures into one yaml (picasso/gui/spinna.py:1582),
        which spinna.load_structures reads."""
        io.save_info(path, [s.get_info() for s in self.structures])

    def plot_structure(self, index: int, fig=None):
        """Scatter preview of one structure's targets
        (picasso/gui/spinna.py:1791)."""
        s = self.structures[index]
        fig = fig or self._new_fig(figsize=(5, 5))
        ax = fig.add_subplot(111)
        for t in s.targets:
            ax.scatter(s.x[t], s.y[t], label=t, s=60)
        ax.set_aspect("equal")
        ax.legend()
        ax.set_title(s.title)
        return fig

    # mask generation (MaskGeneratorTab, picasso/gui/spinna.py:361)
    def generate_mask(self, locs, info, binsize: float = 200.0,
                      sigma: float = 200.0, mode: str = "2D",
                      thresholded: bool = True):
        """A density mask of ``locs`` for masked simulations (host)."""
        from picasso_torch import spinna as _spinna

        self.mask_generator = _spinna.MaskGenerator(
            locs, info, binsize=binsize, sigma=sigma, mode=mode)
        return self.mask_generator.generate_mask(thresholded=thresholded)

    def save_mask(self, path: str):
        if getattr(self, "mask_generator", None) is None:
            raise RuntimeError("generate_mask() first")
        self.mask_generator.save_mask(path)

    # the Simulations tab (picasso/gui/spinna.py:2773)
    def generate_search_space(self, N_total: dict, granularity: int = 10,
                              save: str = "") -> dict:
        """Every candidate stoichiometry with the target totals
        (picasso/gui/spinna.py:3622)."""
        from picasso_torch import spinna as _spinna

        self.search_space = _spinna.generate_N_structures(
            self.structures, N_total, granularity, save=save)
        return self.search_space

    def fit_le(self, target_a: str, target_b: str, granularity: int,
               label_unc: dict, distances: list, **kwargs):
        """Labelling efficiency of a dimer model on ``device``
        (picasso/gui/spinna.py:4131; spinna.fit_le)."""
        from picasso_torch import spinna as _spinna

        return _spinna.fit_le(target_a, target_b, self.exp_data,
                              granularity, label_unc, distances,
                              device=self.device, **kwargs)

    def run_single_simulation(self, N_str, N_sim: int = 1):
        """One simulation at fixed counts; keeps the experiment's and
        the simulated NNDs for the plots (picasso/gui/spinna.py:4356)."""
        from picasso_torch import spinna as _spinna

        if self.mixer is None:
            raise RuntimeError("build_mixer() first")
        self.dists_exp = _spinna.get_NN_dist_experimental(self.exp_data,
                                                          self.mixer)
        self.dists_sim = _spinna.get_NN_dist_simulated(np.asarray(N_str),
                                                       N_sim, self.mixer)
        return self.dists_exp, self.dists_sim

    def plot_nnd(self, bin_size: float = 4.0, fig=None):
        """The experiment's and the simulated NND histograms
        (picasso/gui/spinna.py:4857; spinna.plot_NN)."""
        from picasso_torch import spinna as _spinna

        if getattr(self, "dists_sim", None) is None:
            raise RuntimeError("run_single_simulation() first")
        return _spinna.plot_NN(self.dists_exp, self.dists_sim, self.mixer,
                               bin_size=bin_size, fig=fig)

    def save_nnd_values(self, basepath: str) -> list[str]:
        """The NND arrays as csv, a file a target pair and side
        (picasso/gui/spinna.py:4928)."""
        if getattr(self, "dists_sim", None) is None:
            raise RuntimeError("run_single_simulation() first")
        pairs = [t for t in self.mixer.get_neighbor_idx() if t[2]]
        paths = []
        for (t1, t2, nn), de, ds in zip(pairs, self.dists_exp,
                                        self.dists_sim):
            for tag, arr in (("exp", de), ("sim", ds)):
                p = f"{basepath}_{t1}-{t2}_{tag}.csv"
                np.savetxt(p, np.asarray(arr), delimiter=",")
                paths.append(p)
        return paths


_PREDICTION_DTYPE = np.dtype([("group", np.int64), ("prediction", np.int64),
                             ("probability", np.float64)])


class NanotronApp(_PluginHost):
    """Structure classification (picasso/gui/nanotron.py): train the MLP
    on picked structures and classify picks, renders, training and
    predictions on ``device``."""

    def __init__(self, fig=None, device="cuda"):
        import matplotlib.pyplot as plt  # noqa: F401

        self.model = None
        self.model_info = None
        self.device = device
        self.fig = fig or self._new_fig(figsize=(6, 6))
        self.ax = self.fig.add_subplot(111)
        self._init_plugins("nanotron")

    def train(self, data, labels, **kwargs):
        from picasso_torch import nanotron as _nanotron

        self.model = _nanotron.train_model(data, labels, device=self.device,
                                           **kwargs)
        self.model_info = {"Classes": sorted(set(map(int, labels)))}
        return self.model

    def load(self, path: str):
        from picasso_torch import nanotron as _nanotron

        self.model, self.model_info = _nanotron.load_model(
            path, device=self.device)

    def predict(self, locs, pick, pick_radius, oversampling):
        from picasso_torch import nanotron as _nanotron

        if self.model is None:
            raise RuntimeError("train or load a model first")
        return _nanotron.predict_structure(self.model, locs, pick,
                                           pick_radius, oversampling,
                                           device=self.device)

    # the training workflow (picasso/gui/nanotron.py: train-set table
    # :772, combine_data_sets :113, train :691, show_learning_stats :720)
    def add_train_dataset(self, locs, label: int, name: str,
                          pick_radius: float = 1.0,
                          oversampling: float = 10.0):
        """Register one labelled training file (grouped locs)."""
        if not hasattr(self, "train_sets"):
            self.train_sets = []
        self.train_sets.append({"locs": locs, "label": int(label),
                                "name": name, "pick_radius": pick_radius,
                                "oversampling": oversampling})
        return len(self.train_sets)

    def prepare_training_data(self):
        """Render and augment every registered dataset, and combine."""
        from picasso_torch import nanotron as _nanotron

        if not getattr(self, "train_sets", None):
            raise RuntimeError("add_train_dataset() first")
        data, labels = [], []
        for ds in self.train_sets:
            d, lab = _nanotron.prepare_data(
                ds["locs"], ds["label"], ds["pick_radius"],
                ds["oversampling"], device=self.device)
            data.extend(d)
            labels.extend(lab)
        self._train_data = data
        self._train_labels = labels
        return len(data)

    def train_with_stats(self, test_fraction: float = 0.2, seed: int = 0,
                         **kwargs):
        """Train on a split and report the accuracy and the confusion
        matrix (picasso/gui/nanotron.py:980)."""
        from picasso_torch import nanotron as _nanotron

        if not hasattr(self, "_train_data"):
            self.prepare_training_data()
        X = np.stack(self._train_data)
        y = np.asarray(self._train_labels)
        order = np.random.default_rng(seed).permutation(len(X))
        n_test = max(1, int(len(X) * test_fraction))
        test_idx, train_idx = order[:n_test], order[n_test:]
        self.model = _nanotron.train_model(
            list(X[train_idx]), list(y[train_idx]), device=self.device,
            **kwargs)
        train_score = self.model.score(X[train_idx], y[train_idx])
        test_score = self.model.score(X[test_idx], y[test_idx])
        pred = self.model.predict(X[test_idx])
        classes = list(self.model.classes_)
        cm = np.zeros((len(classes), len(classes)), np.int64)
        for t, p in zip(y[test_idx], pred):
            cm[classes.index(t), classes.index(p)] += 1
        self.stats = {"train_score": train_score, "test_score": test_score,
                      "confusion_matrix": cm, "classes": classes}
        self.model_info = {"Classes": classes, "Test accuracy": test_score}
        return self.stats

    def plot_learning_stats(self, fig=None):
        """Loss curve and confusion matrix
        (picasso/gui/nanotron.py:720)."""
        if self.model is None or not hasattr(self.model, "loss_curve_"):
            raise RuntimeError("train_with_stats() first")
        fig = fig or self._new_fig(figsize=(9, 4))
        ax1 = fig.add_subplot(121)
        ax1.plot(self.model.loss_curve_)
        ax1.set_xlabel("epoch")
        ax1.set_ylabel("loss")
        if getattr(self, "stats", None) is not None:
            ax2 = fig.add_subplot(122)
            cm = self.stats["confusion_matrix"]
            ax2.imshow(cm, cmap="Blues")
            ax2.set_xlabel("predicted")
            ax2.set_ylabel("true")
            for (i, j), v in np.ndenumerate(cm):
                ax2.text(j, i, str(v), ha="center", va="center")
        return fig

    def predict_all(self, locs, pick_radius: float, oversampling: float,
                    min_probability: float = 0.0) -> np.ndarray:
        """Classify every picked group; a structured array of group,
        prediction and probability with the rows at
        or above ``min_probability`` (picasso/gui/nanotron.py:402-470)."""
        if self.model is None:
            raise RuntimeError("train or load a model first")
        rows = []
        for g in np.unique(locs["group"]):
            pred, proba = self.predict(locs, int(g), pick_radius,
                                       oversampling)
            rows.append((int(g), int(np.atleast_1d(pred)[0]),
                         float(np.max(proba))))
        out = np.array(rows, dtype=_PREDICTION_DTYPE)
        return out[out["probability"] >= min_probability]

    def save_model(self, path: str):
        from picasso_torch import nanotron as _nanotron

        if self.model is None:
            raise RuntimeError("train or load a model first")
        _nanotron.save_model(path, self.model, self.model_info)


class ToRawApp:
    """Movie to raw converter (picasso/gui/toraw.py): queue movie files
    and convert each to .raw + YAML (host)."""

    def __init__(self):
        self.queue: list[str] = []

    def add(self, path: str):
        self.queue.append(path)

    def add_folder(self, folder: str):
        for name in sorted(os.listdir(folder)):
            if os.path.splitext(name)[1].lower() in (".tif", ".tiff", ".stk",
                                                     ".ims"):
                self.queue.append(os.path.join(folder, name))

    def run(self, progress=None) -> list[str]:
        converted = []
        for i, path in enumerate(self.queue):
            io.to_raw(path)
            converted.append(os.path.splitext(path)[0] + ".ome.raw")
            if progress is not None:
                progress(i + 1)
        self.queue = []
        return converted
