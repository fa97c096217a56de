"""Super-resolution rendering of locs on a torch device: the histogram and
the per-loc Gaussian blur, what RCC drift correction needs.

Counterpart of picasso_tpu/render.py (render :49, _render_setup :90,
_coords :101 without a rotation, _render_hist :116, _render_gaussian
:156 in its unrotated branch :193). The other blur methods and rotated
views are not ported yet (ROADMAP queue 1 item 9). Locs are numpy
structured arrays; their columns go to ``device`` once and the images
are made there (ops/render_ops.py).
"""

from __future__ import annotations

import numpy as np
import torch

from picasso_torch import lib
from picasso_torch.ops import render_ops


def columns(locs: np.ndarray, names, device) -> dict[str, torch.Tensor]:
    """The named float columns of a locs array as f32 tensors on
    ``device``."""
    return {n: torch.from_numpy(np.ascontiguousarray(locs[n], np.float32))
            .to(device) for n in names}


def render(locs: np.ndarray, info: list[dict] | None,
           oversampling: float = 1.0, viewport=None, blur_method=None,
           min_blur_width: float = 0.0, *, device="cuda"):
    """Render locs into a float image (picasso/render.py:37). Returns
    (n_rendered, image (ny, nx) f32 numpy). ``viewport`` is ((y_min,
    x_min), (y_max, x_max)) in camera px, by default the whole frame
    from ``info``; ``blur_method`` is None (histogram) or
    ``"gaussian"``."""
    device = lib.resolve_device(device)
    names = ("x", "y") if blur_method is None else ("x", "y", "lpx", "lpy")
    n, image = render_t(columns(locs, names, device), info, oversampling,
                        viewport, blur_method, min_blur_width)
    return n, image.cpu().numpy()


def render_t(cols: dict[str, torch.Tensor], info, oversampling: float = 1.0,
             viewport=None, blur_method=None, min_blur_width: float = 0.0):
    """:func:`render` on columns already on the device (:func:`columns`);
    returns (n_rendered, image tensor)."""
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
    if blur_method is None:
        return len(x), render_ops.hist2d(x, y, ny, nx)
    if blur_method == "gaussian":
        sx = oversampling * torch.clamp(cols["lpx"][in_view],
                                        min=min_blur_width)
        sy = oversampling * torch.clamp(cols["lpy"][in_view],
                                        min=min_blur_width)
        return len(x), render_ops.gaussian_splat(x, y, sx, sy, ny, nx)
    raise NotImplementedError(
        f"blur_method={blur_method!r} is not ported yet (ROADMAP queue 1 "
        "item 9); use None or 'gaussian'"
    )
