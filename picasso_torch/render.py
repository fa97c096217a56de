"""Super-resolution rendering of locs on a torch device: the histogram,
the per-loc Gaussian blurs (``gaussian``, ``gaussian_iso``), the
whole-image blurs (``smooth``, ``convolve``), rotated 3D views, the 3D
histograms, and the RGB scene of one or more channels with its colours,
contrast and viewport algebra.

Counterpart of picasso_tpu/render.py: render :49, _render_setup :90,
_coords :101, _render_hist :116, render_hist :127, render_hist3d :134,
_render_gaussian :156, _render_gaussian_iso :197, _render_smooth :235,
_render_convolve :248, _fftconvolve :269, render_hist_anisotropic :284,
render_hist3d_anisotropic :298, the rotations :368-411, the viewport
algebra :419-471, the contrast and colours :479-610, the scene :619-736
and the public aliases and helpers :743-821; of the GUI's drawing
helpers, those of the rotation window (build_animation :346,
draw_rotation :983, draw_rotation_angles :1003) and of the render window
(draw_scalebar :321, map_to_view :770, get_rectangle_pick_polygon :781,
draw_points :824, draw_picks :838, the legend, minimap and Qt helpers
:868-1076). Locs are numpy structured arrays;
their columns go to ``device`` once, in the dtype they carry, and the
images are made there
(ops/render_ops.py): the in-view test and the display transform run in
that dtype (f64 after a drift correction), as in JAX, and ops/render_ops
takes JAX's route by the number of locs in view. A rotated view rotates
x, y and z (as the table holds it, nm in a localize_3D table) about the
viewport's centre in f64 on the device, with the matrix of scipy's
Rotation, and splats each loc's 3D covariance diag(sx², sy², sz²)
rotated and projected to 2D. The scene's RGB is made on the host, as
JAX makes it.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from picasso_torch import lib
from picasso_torch.ops import render_ops

BLUR_METHODS = (None, "gaussian", "gaussian_iso", "smooth", "convolve")
N_GROUP_COLORS = 8

# Default group colors used by the GUI convention (index = group % 8).
GROUP_COLORS = np.array(
    [
        (1.0, 0.0, 0.0),
        (0.0, 1.0, 0.0),
        (0.0, 0.4, 1.0),
        (1.0, 1.0, 0.0),
        (1.0, 0.0, 1.0),
        (0.0, 1.0, 1.0),
        (1.0, 0.5, 0.0),
        (0.6, 0.2, 1.0),
    ],
    dtype=np.float32,
)


def columns(locs: np.ndarray, names, device) -> dict[str, torch.Tensor]:
    """The named columns of a locs array as tensors on ``device``, each
    in its own dtype."""
    return {n: torch.from_numpy(np.ascontiguousarray(locs[n])).to(device)
            for n in names}


def _names(locs: np.ndarray, blur_method, ang) -> list[str]:
    """The columns a render of ``locs`` reads."""
    fields = locs.dtype.names
    names = ["x", "y"]
    if ang is not None and "z" in fields:
        names.append("z")
    if blur_method not in (None, "smooth"):
        names += ["lpx", "lpy"]
    if (ang is not None and blur_method in ("gaussian", "gaussian_iso")
            and "lpz" in fields):
        names.append("lpz")
    return names


def render(locs: np.ndarray, info: list[dict] | None,
           oversampling: float = 1.0, viewport=None, blur_method=None,
           min_blur_width: float = 0.0, ang=None,
           disp_px_size: float | None = None, *, device="cuda"):
    """Render locs into a float image (picasso/render.py:37). Returns
    (n_rendered, image (ny, nx) f32 numpy). ``viewport`` is ((y_min,
    x_min), (y_max, x_max)) in camera px, by default the whole frame
    from ``info``; ``disp_px_size`` (nm) supersedes ``oversampling``;
    ``blur_method`` is one of :data:`BLUR_METHODS`; ``ang`` (Euler
    angles (x, y, z) or a scipy Rotation) renders the rotated view."""
    if disp_px_size is not None:
        oversampling = lib.get_from_metadata(
            info, "Pixelsize", raise_error=True) / disp_px_size
    device = lib.resolve_device(device)
    n, image = render_t(columns(locs, _names(locs, blur_method, ang), device),
                        info, oversampling, viewport, blur_method,
                        min_blur_width, ang)
    return n, image.cpu().numpy()


def render_hist(locs: np.ndarray, oversampling, y_min, x_min, y_max, x_max,
                *, device="cuda"):
    """Histogram rendering of a viewport (picasso/render.py:776)."""
    return render(locs, None, oversampling, ((y_min, x_min), (y_max, x_max)),
                  device=device)


def render_gaussian(locs: np.ndarray, oversampling, y_min, x_min, y_max,
                    x_max, min_blur_width, ang=None, *, device="cuda"):
    """The ``gaussian`` blur of a viewport (picasso/render.py:1020)."""
    return render(locs, None, oversampling, ((y_min, x_min), (y_max, x_max)),
                  "gaussian", min_blur_width, ang, device=device)


def render_gaussian_iso(locs: np.ndarray, oversampling, y_min, x_min, y_max,
                        x_max, min_blur_width, ang=None, *, device="cuda"):
    """The ``gaussian_iso`` blur of a viewport
    (picasso/render.py:1148)."""
    return render(locs, None, oversampling, ((y_min, x_min), (y_max, x_max)),
                  "gaussian_iso", min_blur_width, ang, device=device)


def render_smooth(locs: np.ndarray, oversampling, y_min, x_min, y_max, x_max,
                  ang=None, *, device="cuda"):
    """The ``smooth`` blur of a viewport (picasso/render.py:1349)."""
    return render(locs, None, oversampling, ((y_min, x_min), (y_max, x_max)),
                  "smooth", ang=ang, device=device)


def render_convolve(locs: np.ndarray, oversampling, y_min, x_min, y_max,
                    x_max, min_blur_width, ang=None, *, device="cuda"):
    """The ``convolve`` blur of a viewport (picasso/render.py:1249)."""
    return render(locs, None, oversampling, ((y_min, x_min), (y_max, x_max)),
                  "convolve", min_blur_width, ang, device=device)


def _median(v: torch.Tensor) -> np.generic:
    """np.median of a 1D tensor, as a numpy scalar of its dtype: the
    middle value, or the two middle values' sum halved in that dtype;
    NaN if any value is NaN (torch sorts NaN last)."""
    s = torch.sort(v).values
    n = len(s)
    mid = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
    return torch.where(torch.isnan(s[-1]), s[-1], mid).cpu().numpy()[()]


def render_t(cols: dict[str, torch.Tensor], info, oversampling: float = 1.0,
             viewport=None, blur_method=None, min_blur_width: float = 0.0,
             ang=None):
    """:func:`render` on columns already on the device (:func:`columns`;
    z, where there is one, and lpz for a rotated view's splats); returns
    (n_rendered, image tensor)."""
    if blur_method not in BLUR_METHODS:
        raise ValueError("blur_method not understood.")
    if viewport is None:
        try:
            viewport = [(0, 0), (info[0]["Height"], info[0]["Width"])]
        except TypeError:
            raise ValueError("Need info if no viewport is provided.")
    (y_min, x_min), (y_max, x_max) = viewport
    ny = int(np.ceil(oversampling * (y_max - y_min)))
    nx = int(np.ceil(oversampling * (x_max - x_min)))
    if ang is None:
        x, y = cols["x"], cols["y"]
        in_view = ((_promoted(x, x_min) > x_min)
                   & (_promoted(y, y_min) > y_min)
                   & (_promoted(x, x_max) < x_max)
                   & (_promoted(y, y_max) < y_max))
        x = _promoted(x[in_view], x_min) - x_min
        y = _promoted(y[in_view], y_min) - y_min
        x = oversampling * _promoted(x, oversampling)
        y = oversampling * _promoted(y, oversampling)
    else:
        x, y, in_view, _ = _rotate(cols, oversampling, x_min, x_max, y_min,
                                   y_max, ang)
    n = len(x)
    if blur_method is None:
        return n, render_ops.hist2d(x, y, ny, nx)
    if blur_method in ("smooth", "convolve"):
        if n == 0:
            return 0, torch.zeros((ny, nx), dtype=torch.float32,
                                  device=x.device)
        image = render_ops.hist2d(x, y, ny, nx)
        if blur_method == "smooth":
            return n, render_ops.gaussian_filter(image, 1, 1)
        width = oversampling * max(_median(cols["lpx"][in_view]),
                                   min_blur_width)
        height = oversampling * max(_median(cols["lpy"][in_view]),
                                    min_blur_width)
        return n, render_ops.gaussian_filter(image, height, width)
    sx = oversampling * torch.clamp(cols["lpx"], min=min_blur_width)[in_view]
    sy = oversampling * torch.clamp(cols["lpy"], min=min_blur_width)[in_view]
    if blur_method == "gaussian_iso":
        sx = sy = (sx + sy) / 2
    if ang is None:
        return n, render_ops.gaussian_splat(x, y, sx, sy, ny, nx)
    # the z blur: lpz, or twice the mean of lpx and lpy (in their dtype)
    lpz = cols.get("lpz")
    if lpz is None:
        lpz = 2 * ((cols["lpx"] + cols["lpy"]) / 2)
    sz = oversampling * torch.clamp(lpz, min=min_blur_width)[in_view]
    covs = _rotated_covariances(sx, sy, sz, to_rotation(ang).as_matrix())
    return n, render_ops.gaussian_splat_cov(x, y, covs, ny, nx)


def _promoted(t: torch.Tensor, scalar) -> torch.Tensor:
    """``t`` in the dtype numpy computes ``t`` with ``scalar`` in, as
    JAX's in-view test and display transform do on the host (NEP 50: a
    numpy scalar keeps its type, a Python number takes the array's), so
    a viewport of np.float64 bounds, as the viewport algebra makes them,
    moves f32 locs to f64 there as in JAX."""
    dt = np.result_type(np.dtype(str(t.dtype).removeprefix("torch.")),
                        scalar)
    return t.to(getattr(torch, dt.name))


def _rotated_covariances(sx, sy, sz, R: np.ndarray) -> torch.Tensor:
    """(n, 2, 2) f64: the upper left of R diag(sx², sy², sz²) Rᵀ, the
    squares in the sigmas' dtype, each entry summed over the axes in
    order as np.einsum("ab,nbc,dc->nad") sums it."""
    s = [(v * v).to(torch.float64) for v in (sx, sy, sz)]
    out = torch.empty((len(sx), 2, 2), dtype=torch.float64,
                      device=sx.device)
    for a in range(2):
        for d in range(2):
            t = [(float(R[a, b]) * s[b]) * float(R[d, b]) for b in range(3)]
            out[:, a, d] = (t[0] + t[1]) + t[2]
    return out


def render_hist_anisotropic(x, y, oversampling_x, oversampling_y, y_min,
                            x_min, y_max, x_max, *, device="cuda"):
    """Histogram with different pixel sizes in x and y (used by particle
    averaging; picasso_tpu/render.py:284). Returns (n in view, image)."""
    device = lib.resolve_device(device)
    x, y = (_tensor(v, device) for v in (x, y))
    ny = int(np.ceil(oversampling_y * (y_max - y_min)))
    nx = int(np.ceil(oversampling_x * (x_max - x_min)))
    in_view = (x > x_min) & (y > y_min) & (x < x_max) & (y < y_max)
    xs = oversampling_x * (x[in_view] - x_min)
    ys = oversampling_y * (y[in_view] - y_min)
    return (int(in_view.sum()),
            render_ops.hist2d(xs, ys, ny, nx).cpu().numpy())


def render_hist3d(x, y, z, oversampling, y_min, x_min, y_max, x_max, z_min,
                  z_max, pixelsize, *, device="cuda"):
    """3D histogram of a viewport between z_min and z_max (nm; z in nm,
    picasso/render.py:857). Returns (n in view, (ny, nx, nz) f32)."""
    return render_hist3d_anisotropic(x, y, z, oversampling, oversampling,
                                     y_min, x_min, y_max, x_max, z_min, z_max,
                                     pixelsize, device=device)


def render_hist3d_anisotropic(x, y, z, oversampling_xy, oversampling_z,
                              y_min, x_min, y_max, x_max, z_min, z_max,
                              pixelsize, *, device="cuda"):
    """3D histogram with independent lateral and axial oversampling
    (picasso/render.py:920): z and its range (nm) in camera pixels, the
    locs strictly inside the box binned on ``device``. Returns (n in
    view, (ny, nx, nz) f32)."""
    device = lib.resolve_device(device)
    x, y, z = (_tensor(v, device) for v in (x, y, z))
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, one rounding more than numpy's division
    z_px = z / torch.full((), pixelsize, dtype=z.dtype, device=device)
    z_min_px = z_min / pixelsize
    z_max_px = z_max / pixelsize
    ny = int(np.ceil(oversampling_xy * (y_max - y_min)))
    nx = int(np.ceil(oversampling_xy * (x_max - x_min)))
    nz = int(np.ceil(oversampling_z * (z_max_px - z_min_px)))
    in_view = ((x > x_min) & (y > y_min) & (x < x_max) & (y < y_max)
               & (z_px > z_min_px) & (z_px < z_max_px))
    xs = oversampling_xy * (x[in_view] - x_min)
    ys = oversampling_xy * (y[in_view] - y_min)
    zs = oversampling_z * (z_px[in_view] - z_min_px)
    return (int(in_view.sum()),
            render_ops.hist3d(xs, ys, zs, ny, nx, nz).cpu().numpy())


def _tensor(v, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def render_hist_numba(x, y, oversampling, t_min, t_max):
    """Square histogram of the averaging workspace [t_min, t_max)² on
    the host (the reference's name, picasso/render.py:740)."""
    from picasso_torch.average import _render_hist_square

    return _render_hist_square(np.asarray(x), np.asarray(y), oversampling,
                               t_min, t_max)


def determinant_3x3(a) -> float:
    return float(np.linalg.det(np.asarray(a, np.float64)))


def inverse_3x3(a):
    return np.linalg.inv(np.asarray(a, np.float64))


# --- rotation ---------------------------------------------------------------


def rotation_matrix(angx: float, angy: float, angz: float) -> Rotation:
    """Legacy Euler rotation convention (picasso/render.py:1463)."""
    cx, sx = np.cos(angx), np.sin(angx)
    cy, sy = np.cos(angy), np.sin(angy)
    cz, sz = np.cos(angz), np.sin(angz)
    rx = np.array([[1, 0, 0], [0, cx, sx], [0, -sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rotation.from_matrix(rx @ ry @ rz)


def to_rotation(ang) -> Rotation | None:
    """Euler angles, a Rotation or None, as a Rotation or None
    (picasso/render.py:1501)."""
    if ang is None:
        return None
    if isinstance(ang, Rotation):
        return ang
    return rotation_matrix(*ang)


def _rotate(cols: dict[str, torch.Tensor], oversampling, x_min, x_max, y_min,
            y_max, ang):
    """x, y and z (0 without a z column) rotated about the viewport's
    centre in f64 on the columns' device, by a matrix product as scipy's
    Rotation.apply forms it; (x, y) display-scaled in view, the in-view
    mask and z in view times ``oversampling``."""
    f64 = torch.float64
    cx = x_min + (x_max - x_min) / 2
    cy = y_min + (y_max - y_min) / 2
    x = cols["x"].to(f64) - cx
    y = cols["y"].to(f64) - cy
    z = cols["z"].to(f64) if "z" in cols else torch.zeros_like(x)
    R = torch.as_tensor(to_rotation(ang).as_matrix(), dtype=f64,
                        device=x.device)
    r = torch.stack([x, y, z], 1) @ R.T
    x, y, z = r[:, 0] + cx, r[:, 1] + cy, r[:, 2]
    in_view = (x > x_min) & (y > y_min) & (x < x_max) & (y < y_max)
    return (oversampling * (x[in_view] - x_min),
            oversampling * (y[in_view] - y_min), in_view,
            z[in_view] * oversampling)


def locs_rotation(locs: np.ndarray, oversampling, x_min, x_max, y_min,
                  y_max, ang, *, device="cuda"):
    """Rotate locs about the viewport centre (picasso/render.py:1571):
    (x, y display-scaled in view, the in-view mask, z in view times
    ``oversampling``), f64 numpy."""
    names = [n for n in ("x", "y", "z") if n in locs.dtype.names]
    out = _rotate(columns(locs, names, lib.resolve_device(device)),
                  oversampling, x_min, x_max, y_min, y_max, ang)
    return tuple(t.cpu().numpy() for t in out)


def closest_rotvec(rotation, reference):
    """Rotation vector representation of ``rotation`` closest to
    ``reference`` — unwraps full turns for continuous rotation
    tracking (picasso/render.py:1528)."""
    reference = np.asarray(reference, dtype=float)
    base = rotation.as_rotvec()
    theta = np.linalg.norm(base)
    if theta < 1e-9:
        ref_norm = np.linalg.norm(reference)
        if ref_norm < 1e-9:
            return base
        axis = reference / ref_norm
        turns = np.round(ref_norm / (2 * np.pi))
        return axis * 2 * np.pi * turns
    axis = base / theta
    # candidate representations: +-axis with added full turns
    candidates = []
    for sign in (1.0, -1.0):
        t = sign * theta if sign > 0 else 2 * np.pi - theta
        ax = axis if sign > 0 else -axis
        k = np.round((np.dot(reference, ax) - t) / (2 * np.pi))
        for kk in (k - 1, k, k + 1):
            candidates.append(ax * (t + 2 * np.pi * kk))
    d = [np.linalg.norm(c - reference) for c in candidates]
    return candidates[int(np.argmin(d))]


# --- the rotation window's drawing (picasso/render.py:2604-2693, :3411) -----


def _draw_text(rgb, text, xy, color, fontsize=16, bg=None):
    """Rasterize text into an RGB array with PIL (the headless stand-in
    for QPainter.drawText)."""
    from PIL import Image, ImageDraw, ImageFont

    img = Image.fromarray(rgb)
    draw = ImageDraw.Draw(img)
    try:
        font = ImageFont.load_default(size=fontsize)
    except TypeError:  # older Pillow: a fixed-size bitmap font
        font = ImageFont.load_default()
    if bg is not None:
        bbox = draw.textbbox(xy, text, font=font)
        pad = 4
        draw.rectangle((bbox[0] - pad, bbox[1] - pad, bbox[2] + pad,
                        bbox[3] + pad), fill=tuple(bg))
    draw.text(xy, text, fill=tuple(color), font=font)
    return np.asarray(img)


def _draw_line(rgb, p0, p1, color):
    """Burn a 1-px line into an RGB array."""
    h, w = rgb.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.linspace(p0[0], p1[0], n).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n).round().astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    rgb[ys[ok], xs[ok]] = color
    return rgb


def draw_rotation(rgb: np.ndarray, ang, axis_length: int = 30,
                  axis_center: tuple[int, int] = (50, -50)) -> np.ndarray:
    """The rotated x/y/z axis tripod (red/cyan/green), by default in the
    bottom-left corner (picasso/render.py:2604)."""
    rgb = rgb.copy()
    h, w = rgb.shape[:2]
    x = axis_center[0] if axis_center[0] >= 0 else w + axis_center[0]
    y = axis_center[1] if axis_center[1] >= 0 else h + axis_center[1]
    rotated = to_rotation(ang).apply(np.eye(3) * axis_length).astype(int)
    colors = [(255, 0, 0), (0, 255, 255), (0, 255, 0)]
    for (ex, ey, _), color in zip(rotated, colors):
        _draw_line(rgb, (x, y), (x + ex, y + ey), color)
    return rgb


def draw_rotation_angles(rgb: np.ndarray, ang,
                         color=(255, 255, 255)) -> np.ndarray:
    """The rotation angles in degrees as text in the bottom-right corner
    (picasso/render.py:2693)."""
    h, w = rgb.shape[:2]
    angx, angy, angz = [int(np.round(a * 180 / np.pi)) for a in ang]
    text = f"{angx} {angy} {angz}"
    x = w - len(text) * 8 - 10
    y = h - 20
    return _draw_text(np.ascontiguousarray(rgb).copy(), text, (x, y - 12),
                      color, fontsize=12)


def build_animation(path: str, frames: list[np.ndarray], fps: int = 30
                    ) -> None:
    """Write rendered RGB frames to a movie file with imageio
    (picasso/render.py:3411): a GIF always, an mp4 with an ffmpeg
    backend."""
    import imageio

    if path.lower().endswith(".gif"):
        # imageio v3 takes the frame duration (ms) for GIF, not fps
        imageio.mimsave(path, frames, duration=1000.0 / fps, loop=0)
    else:
        imageio.mimsave(path, frames, fps=fps)


def _export_image(image, path) -> None:
    """Write an RGB array, or a QImage where Qt is present, to a vector
    or raster file through matplotlib, the headless stand-in for the
    reference's QPdfWriter/QSvgGenerator painters
    (picasso/render.py:1640/1666)."""
    import matplotlib.pyplot as plt

    if not isinstance(image, np.ndarray):  # a QImage, by its methods
        ptr = image.constBits()
        ptr.setsize(image.sizeInBytes())
        h, w = image.height(), image.width()
        bpp = image.depth() // 8  # 3 for RGB888, 4 for (A)RGB32
        rows = np.frombuffer(ptr, np.uint8).reshape(h, image.bytesPerLine())
        arr = rows[:, :w * bpp].reshape(h, w, bpp)
        # (A)RGB32 is BGRA in little-endian memory
        image = arr[..., 2::-1] if bpp == 4 else arr[..., :3]
    h, w = image.shape[:2]
    fig = plt.figure(figsize=(w / 100, h / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.imshow(image, interpolation="nearest")
    ax.axis("off")
    fig.savefig(path, dpi=100)
    plt.close(fig)


# --- the render window's drawing (picasso/render.py:2040-2727, :3047) -------
# numpy and PIL stand-ins for the reference's QImage painters; each takes
# and returns a uint8 RGB array, on the host

POLYGON_POINTER_SIZE = 16  # must be even (picasso/render.py:34)


def map_to_view(x: float, y: float, viewport, width: int, height: int
                ) -> tuple[int, int]:
    """Camera-pixel coordinates -> display-pixel coordinates of a
    rendered viewport image (picasso/render.py:2040)."""
    (y_min, x_min), (y_max, x_max) = viewport
    cx = int((x - x_min) / (x_max - x_min) * width)
    cy = int((y - y_min) / (y_max - y_min) * height)
    return cx, cy


def get_rectangle_pick_polygon(start_x, start_y, end_x, end_y, width,
                               return_most_right=False):
    """Corner polygon of a rectangular pick (picasso/render.py:2054), or
    its rightmost corner."""
    X, Y = lib.get_pick_rectangle_corners(start_x, start_y, end_x, end_y,
                                          width)
    if return_most_right:
        i = int(np.argmax(X))
        return X[i], Y[i]
    return list(zip(X + [X[0]], Y + [Y[0]]))


def draw_scalebar(rgb: np.ndarray, pixelsize: float, disp_px_size: float,
                  length_nm: float | None = None, margin: int = 10,
                  height_px: int = 5) -> np.ndarray:
    """A white scale bar burnt into the bottom-right corner
    (picasso/render.py:2428)."""
    rgb = rgb.copy()
    h, w = rgb.shape[:2]
    if length_nm is None:
        length_nm = optimal_scalebar_length(disp_px_size, w)
    length_px = min(int(round(length_nm / disp_px_size)), w - 2 * margin)
    y1 = h - margin
    y0 = y1 - height_px
    x1 = w - margin
    x0 = x1 - length_px
    rgb[max(y0, 0):y1, max(x0, 0):x1] = 255
    return rgb


def draw_points(rgb: np.ndarray, points, viewport, color=(255, 255, 0)
                ) -> np.ndarray:
    """3 x 3 point markers at camera-pixel positions (picasso/render.py
    :2550-like)."""
    rgb = rgb.copy()
    h, w = rgb.shape[:2]
    for x, y in points:
        cx, cy = map_to_view(x, y, viewport, w, h)
        if 1 <= cx < w - 1 and 1 <= cy < h - 1:
            rgb[cy - 1:cy + 2, cx - 1:cx + 2] = color
    return rgb


def draw_picks(rgb: np.ndarray, picks, pick_diameter: float, viewport,
               color=(255, 255, 0)) -> np.ndarray:
    """Outlines of circular picks (picasso/render.py:2230-like)."""
    rgb = rgb.copy()
    h, w = rgb.shape[:2]
    (y_min, x_min), (y_max, x_max) = viewport
    px_per_cam_x = w / (x_max - x_min)
    for x, y in picks:
        cx, cy = map_to_view(x, y, viewport, w, h)
        r = pick_diameter / 2 * px_per_cam_x
        theta = np.linspace(0, 2 * np.pi, max(16, int(4 * r)))
        xs = (cx + r * np.cos(theta)).astype(int)
        ys = (cy + r * np.sin(theta)).astype(int)
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        rgb[ys[ok], xs[ok]] = color
    return rgb


def _draw_rect(rgb, x, y, width, height, color):
    """Burn a 1-px rectangle outline into an RGB array."""
    _draw_line(rgb, (x, y), (x + width, y), color)
    _draw_line(rgb, (x, y + height), (x + width, y + height), color)
    _draw_line(rgb, (x, y), (x, y + height), color)
    _draw_line(rgb, (x + width, y), (x + width, y + height), color)
    return rgb


def adjust_viewport_decorator(func):
    """Fit the viewport to the image's aspect ratio before the wrapped
    painter runs; image and viewport are its first two arguments
    (picasso/render.py:2014)."""

    def wrapper(image, viewport, *args, **kwargs):
        h, w = np.asarray(image).shape[:2]
        return func(image, adjust_viewport_to_aspect_ratio(viewport, h / w),
                    *args, **kwargs)

    return wrapper


def draw_legend(rgb: np.ndarray, channel_names: list[str],
                channel_colors: list[tuple[int, int, int]],
                init_pos: tuple[int, int] = (12, 26), dy: int = 24,
                padding: int = 4, text_fontsize: int = 16) -> np.ndarray:
    """Each channel's name in its colour on a black box, in the top-left
    corner (picasso/render.py:2480)."""
    assert len(channel_names) == len(channel_colors), (
        "Length of channel_names must match number of channels in "
        "dataset.")
    rgb = np.ascontiguousarray(rgb).copy()
    x, y = init_pos
    for name, color in zip(channel_names, channel_colors):
        rgb = _draw_text(rgb, name, (x, y - text_fontsize), color,
                         fontsize=text_fontsize, bg=(0, 0, 0))
        y += dy
    return rgb


@adjust_viewport_decorator
def draw_minimap(rgb: np.ndarray, viewport,
                 max_viewport_size: tuple[float, float],
                 color_main=(255, 255, 0), color_frame=(255, 255, 255),
                 length_minimap: int = 100,
                 margin: tuple[int, int] = (20, 20)) -> np.ndarray:
    """Where the viewport sits within the whole field of view, in the
    top-right corner (picasso/render.py:2550)."""
    rgb = rgb.copy()
    movie_height, movie_width = max_viewport_size
    height_minimap = int(movie_height / movie_width * length_minimap)
    x = rgb.shape[1] - length_minimap - margin[0]
    y = margin[1]
    _draw_rect(rgb, x, y, length_minimap, height_minimap, color_frame)
    length = max(5, int(viewport_width(viewport) / movie_width
                        * length_minimap))
    height = max(5, int(viewport_height(viewport) / movie_height
                        * height_minimap))
    x_vp = int(viewport[0][1] / movie_width * length_minimap)
    y_vp = int(viewport[0][0] / movie_height * height_minimap)
    _draw_rect(rgb, x + x_vp, y + y_vp, length, height, color_main)
    return rgb


def rgb_to_qimage(rgb: np.ndarray):
    """A uint8 RGB array as a QImage (picasso/render.py:3047). Qt only:
    raises ImportError where PyQt6 is not installed."""
    try:
        from PyQt6 import QtGui
    except ImportError as e:
        raise ImportError(
            "rgb_to_qimage requires PyQt6, which is not installed. Use "
            "the numpy RGB image directly, or PIL for file export.") from e
    rgb = np.ascontiguousarray(rgb)
    h, w = rgb.shape[:2]
    image = QtGui.QImage(rgb.data, w, h, 3 * w,
                         QtGui.QImage.Format.Format_RGB888)
    return image.copy()


def export_qimage_to_pdf(image, path: str) -> None:
    """A rendered image (numpy RGB or QImage) as PDF
    (picasso/render.py:1640)."""
    _export_image(image, path)


def export_qimage_to_svg(image, path: str) -> None:
    """A rendered image (numpy RGB or QImage) as SVG
    (picasso/render.py:1666)."""
    _export_image(image, path)


# --- viewport algebra (picasso/render.py:1807-2038) -------------------------


def viewport_height(viewport) -> float:
    return viewport[1][0] - viewport[0][0]


def viewport_width(viewport) -> float:
    return viewport[1][1] - viewport[0][1]


def viewport_size(viewport) -> tuple[float, float]:
    return viewport_height(viewport), viewport_width(viewport)


def viewport_center(viewport) -> tuple[float, float]:
    return ((viewport[0][0] + viewport[1][0]) / 2,
            (viewport[0][1] + viewport[1][1]) / 2)


def shift_viewport(viewport, dy: float, dx: float):
    (y_min, x_min), (y_max, x_max) = viewport
    return ((y_min + dy, x_min + dx), (y_max + dy, x_max + dx))


def zoom_viewport(viewport, factor: float, center=None):
    if center is None:
        center = viewport_center(viewport)
    cy, cx = center
    h = viewport_height(viewport) * factor
    w = viewport_width(viewport) * factor
    return ((cy - h / 2, cx - w / 2), (cy + h / 2, cx + w / 2))


def adjust_viewport_to_aspect_ratio(viewport, aspect: float):
    """Grow the smaller dimension so height/width == aspect."""
    h, w = viewport_size(viewport)
    cy, cx = viewport_center(viewport)
    if h / w < aspect:
        h = w * aspect
    else:
        w = h / aspect
    return ((cy - h / 2, cx - w / 2), (cy + h / 2, cx + w / 2))


def optimal_scalebar_length(pixelsize, width) -> int:
    """Scalebar length (nm) near a fifth of the image width, rounded to
    a value of the series 1, 2, 5 (picasso/render.py:3297)."""
    candidates = [1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000,
                  10000, 20000, 50000]
    target = pixelsize * width / 5
    return min(candidates, key=lambda c: abs(c - target))


# --- contrast and colours ---------------------------------------------------


def scale_contrast(image, vmin=None, vmax=None, autoscale: bool = False,
                   return_contrast_limits: bool = False):
    """Scale image(s) into [0, 1] (picasso/render.py:3082), on the host:
    with ``autoscale`` from 0 to half the maximum (of a 2D image, or the
    least nonzero maximum of the channels of a stack)."""
    image = np.asarray(image, np.float32)
    if autoscale:
        if image.ndim == 2:
            max_ = image.max()
        else:
            maxes = [ch.max() for ch in image if ch.max() > 0]
            max_ = min(maxes) if maxes else 1.0
        vmax = 0.5 * max_
        vmin = 0.0
    vmin = vmin if vmin is not None else image.min()
    vmax = vmax if vmax is not None else image.max()
    if vmin == vmax:
        vmax = vmin + 1e-6
    scaled = (image - vmin) / (vmax - vmin)
    scaled[~np.isfinite(scaled)] = 0.0
    scaled = np.clip(scaled, 0.0, 1.0)
    if return_contrast_limits:
        return scaled, (vmin, vmax)
    return scaled


def scale_intensities(images, relative_intensities=None):
    """Per-channel intensity scaling in place (picasso/render.py:3144)."""
    if relative_intensities is not None:
        if len(relative_intensities) != images.shape[0]:
            raise ValueError("one relative intensity a channel is needed")
        for i in range(images.shape[0]):
            images[i] *= relative_intensities[i]
    return images


def to_8bit(image):
    """[0, 1] float image to uint8 (picasso/render.py:3170)."""
    image = np.asarray(image, np.float32)
    image = image / (image.max() if image.max() > 0 else 1.0)
    return np.round(image * 255).astype(np.uint8)


def apply_colormap(image, colormap):
    """Apply a matplotlib colormap name or a (256, 3/4) LUT to an 8-bit
    image (picasso/render.py:3181)."""
    if isinstance(colormap, str):
        import matplotlib.pyplot as plt

        cmap = np.uint8(
            np.round(255 * plt.get_cmap(colormap)(np.arange(256))))
    else:
        cmap = np.uint8(np.round(255 * np.asarray(colormap)))
    return cmap[image][:, :, :3]


def solid_to_lut(rgb) -> np.ndarray:
    """(256, 3) LUT ramping black -> rgb (picasso/render.py:1671)."""
    rgb_arr = np.asarray(rgb, dtype=np.float32).reshape(3)
    return np.linspace(np.zeros(3, np.float32), rgb_arr, 256,
                       dtype=np.float32)


def stops_to_lut(stops) -> np.ndarray:
    """(256, 3) LUT from interpolated colour stops (position, r, g, b)
    (picasso/render.py:1712)."""
    arr = np.asarray(stops, dtype=np.float32)
    positions = arr[:, 0]
    rgb = arr[:, 1:4]
    xs = np.linspace(0.0, 1.0, 256, dtype=np.float32)
    lut = np.empty((256, 3), np.float32)
    for c in range(3):
        lut[:, c] = np.interp(xs, positions, rgb[:, c])
    return lut


def get_colors_from_colormap(n_channels: int, cmap: str = "gist_rainbow"):
    """Evenly spaced RGB colours from a matplotlib colormap
    (picasso/render.py:1745)."""
    import matplotlib.pyplot as plt

    base = plt.get_cmap(cmap)(np.arange(256))[:, :3]
    idx = np.linspace(0, 255, n_channels).astype(int)
    return base[idx]


def get_group_color(locs: np.ndarray, shuffle: bool = False):
    """Colour index of each loc from its group, modulo
    :data:`N_GROUP_COLORS`; ``shuffle`` permutes the groups' colours with
    numpy's global stream (picasso/render.py:1777)."""
    groups = locs["group"].astype(int)
    if shuffle:
        lookup = np.arange(groups.max() + 1)
        np.random.shuffle(lookup)
        lookup %= N_GROUP_COLORS
        return lookup[groups]
    return groups % N_GROUP_COLORS


def split_locs_by_property(locs: np.ndarray, *, property_name,
                           n_colors: int = 32, min_value=None,
                           max_value=None) -> list[np.ndarray]:
    """The locs in ``n_colors`` equal bins of a field's values, the ends
    clipped into the first and last (picasso/render.py:3206)."""
    if property_name not in locs.dtype.names:
        raise ValueError(f"locs have no field {property_name!r}")
    values = locs[property_name]
    if min_value is None:
        min_value = values.min()
    if max_value is None:
        max_value = values.max()
    step = (max_value - min_value) / n_colors
    color = np.floor((values - min_value) / step).astype(int)
    color = np.clip(color, 0, n_colors - 1)
    return [locs[color == i] for i in range(n_colors)]


def split_locs_by_group(locs: np.ndarray, n_colors: int = N_GROUP_COLORS,
                        group_color=None) -> list[np.ndarray]:
    """The locs of each colour index of ``group_color``, else of each
    group in order of first appearance, else all of them
    (picasso/render.py:3257)."""
    if group_color is not None:
        if len(group_color) != len(locs):
            raise ValueError("group_color needs one value a loc")
        return [locs[group_color == i] for i in range(n_colors)]
    if "group" in locs.dtype.names:
        groups = locs["group"]
        first = np.sort(np.unique(groups, return_index=True)[1])
        return [locs[groups == g] for g in groups[first]]
    return [locs]


# --- scene (numpy RGB; picasso/render.py:2728-3047) -------------------------


def _render_single_channel(locs, info, *, disp_px_size, viewport=None,
                           blur_method=None, min_blur_width=0.0, ang=None,
                           contrast=None, invert_colors=False,
                           single_channel_colormap="magma",
                           raw_image_cache=None, device="cuda"):
    if raw_image_cache is not None:
        raw_image = raw_image_cache
        n_locs = 0
    else:
        n_locs, raw_image = render(
            locs, info, disp_px_size=disp_px_size, viewport=viewport,
            blur_method=blur_method, min_blur_width=min_blur_width, ang=ang,
            device=device)
    vmin, vmax = contrast if contrast is not None else (None, None)
    image, limits = scale_contrast(raw_image, vmin, vmax,
                                   autoscale=contrast is None,
                                   return_contrast_limits=True)
    rgb = apply_colormap(to_8bit(image), single_channel_colormap)
    if invert_colors:
        rgb = 255 - rgb
    return n_locs, rgb, limits, raw_image


def _render_multi_channel(locs, info, *, disp_px_size, colors, viewport=None,
                          blur_method=None, min_blur_width=0.0, ang=None,
                          contrast=None, relative_intensities=None,
                          invert_colors=False, raw_image_cache=None,
                          device="cuda"):
    if raw_image_cache is not None:
        raw_image = raw_image_cache
        n_locs = 0
    else:
        renderings = [
            render(locs[i], info[i], disp_px_size=disp_px_size,
                   viewport=viewport, blur_method=blur_method,
                   min_blur_width=min_blur_width, ang=ang, device=device)
            for i in range(len(locs))]
        n_locs = sum(r[0] for r in renderings)
        raw_image = np.array([r[1] for r in renderings])
    vmin, vmax = contrast if contrast is not None else (None, None)
    images, limits = scale_contrast(raw_image, vmin, vmax,
                                    autoscale=contrast is None,
                                    return_contrast_limits=True)
    images = scale_intensities(images, relative_intensities)
    if colors is None:
        colors = get_colors_from_colormap(len(images))
    colors_arr = np.asarray(colors, dtype=np.float32)
    images_f32 = np.ascontiguousarray(images, dtype=np.float32)
    if colors_arr.ndim == 2:
        rgb = np.tensordot(images_f32, colors_arr, axes=([0], [0]))
    else:  # one LUT a channel
        idx = np.clip((images_f32 * 255.0).astype(np.int32), 0, 255)
        rgb = np.zeros((images_f32.shape[1], images_f32.shape[2], 3),
                       np.float32)
        for c in range(images_f32.shape[0]):
            rgb += colors_arr[c][idx[c]]
    np.minimum(rgb, 1.0, out=rgb)
    rgb = to_8bit(rgb)
    if invert_colors:
        rgb = 255 - rgb
    return n_locs, rgb, limits, raw_image


def render_scene(locs, info, *, disp_px_size: float = 100.0, viewport=None,
                 blur_method=None, min_blur_width: float = 0.0, ang=None,
                 contrast=None, invert_colors: bool = False,
                 single_channel_colormap="magma", colors=None,
                 relative_intensities=None, raw_image_cache=None,
                 return_contrast_limits: bool = False,
                 return_raw_image: bool = False, device="cuda"):
    """Render one channel (a locs array) or several (a list, with one
    info a channel) into an RGB uint8 image (picasso/render.py:2728):
    the renders on ``device``, the contrast and colours on the host.
    Returns (rgb, n_locs[, contrast limits][, raw image])."""
    kw = dict(disp_px_size=disp_px_size, viewport=viewport,
              blur_method=blur_method, min_blur_width=min_blur_width,
              ang=ang, contrast=contrast, invert_colors=invert_colors,
              raw_image_cache=raw_image_cache, device=device)
    if isinstance(locs, (list, tuple)):
        n_locs, rgb, limits, raw = _render_multi_channel(
            locs, info, colors=colors,
            relative_intensities=relative_intensities, **kw)
    else:
        n_locs, rgb, limits, raw = _render_single_channel(
            locs, info, single_channel_colormap=single_channel_colormap,
            **kw)
    out = [rgb, n_locs]
    if return_contrast_limits:
        out.append(limits)
    if return_raw_image:
        out.append(raw)
    return tuple(out)
