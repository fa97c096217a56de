"""Super-resolution rendering of locs on a torch device: the histogram,
the per-loc Gaussian blurs (``gaussian``, ``gaussian_iso``) and the
whole-image blurs (``smooth``, ``convolve``), and the contrast scaling of
an image for display.

Counterpart of picasso_tpu/render.py (render :49, _render_setup :90,
_coords :101 without a rotation, _render_hist :116, render_hist :127,
_render_gaussian :156 and _render_gaussian_iso :197 in their unrotated
branches, _render_smooth :235, _render_convolve :248, _fftconvolve :269,
scale_contrast :479). Rotated views are not ported yet (ROADMAP queue 1
item 9). Locs are numpy structured arrays; their columns go to
``device`` once, in the dtype they carry, and the images are made there
(ops/render_ops.py): the in-view test and the display transform run in
that dtype (f64 after a drift correction), as in JAX, and
ops/render_ops takes JAX's route by the number of locs in view.
"""

from __future__ import annotations

import numpy as np
import torch

from picasso_torch import lib
from picasso_torch.ops import render_ops

BLUR_METHODS = (None, "gaussian", "gaussian_iso", "smooth", "convolve")


def columns(locs: np.ndarray, names, device) -> dict[str, torch.Tensor]:
    """The named columns of a locs array as tensors on ``device``, each
    in its own dtype."""
    return {n: torch.from_numpy(np.ascontiguousarray(locs[n])).to(device)
            for n in names}


def render(locs: np.ndarray, info: list[dict] | None,
           oversampling: float = 1.0, viewport=None, blur_method=None,
           min_blur_width: float = 0.0, ang=None,
           disp_px_size: float | None = None, *, device="cuda"):
    """Render locs into a float image (picasso/render.py:37). Returns
    (n_rendered, image (ny, nx) f32 numpy). ``viewport`` is ((y_min,
    x_min), (y_max, x_max)) in camera px, by default the whole frame
    from ``info``; ``disp_px_size`` (nm) supersedes ``oversampling``;
    ``blur_method`` is one of :data:`BLUR_METHODS`."""
    if ang is not None:
        raise NotImplementedError(
            "rotated views (ang=) are not ported yet (ROADMAP queue 1 "
            "item 9)")
    if disp_px_size is not None:
        oversampling = lib.get_from_metadata(
            info, "Pixelsize", raise_error=True) / disp_px_size
    device = lib.resolve_device(device)
    names = ("x", "y") if blur_method in (None, "smooth") else (
        "x", "y", "lpx", "lpy")
    n, image = render_t(columns(locs, names, device), info, oversampling,
                        viewport, blur_method, min_blur_width)
    return n, image.cpu().numpy()


def render_hist(locs: np.ndarray, oversampling, y_min, x_min, y_max, x_max,
                *, device="cuda"):
    """Histogram rendering of a viewport (picasso/render.py:776)."""
    return render(locs, None, oversampling, ((y_min, x_min), (y_max, x_max)),
                  device=device)


def _median(v: torch.Tensor) -> np.generic:
    """np.median of a 1D tensor, as a numpy scalar of its dtype: the
    middle value, or the two middle values' sum halved in that dtype;
    NaN if any value is NaN (torch sorts NaN last)."""
    s = torch.sort(v).values
    n = len(s)
    mid = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
    return torch.where(torch.isnan(s[-1]), s[-1], mid).cpu().numpy()[()]


def render_t(cols: dict[str, torch.Tensor], info, oversampling: float = 1.0,
             viewport=None, blur_method=None, min_blur_width: float = 0.0):
    """:func:`render` on columns already on the device (:func:`columns`);
    returns (n_rendered, image tensor)."""
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
    x, y = cols["x"], cols["y"]
    in_view = (x > x_min) & (y > y_min) & (x < x_max) & (y < y_max)
    x = oversampling * (x[in_view] - x_min)
    y = oversampling * (y[in_view] - y_min)
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
    return n, render_ops.gaussian_splat(x, y, sx, sy, ny, nx)


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
