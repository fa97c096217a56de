"""Drift correction by redundant cross-correlation (RCC) of temporal
segments, on a torch device.

Counterpart of picasso_tpu/postprocess.py (n_segments :1159, segment
:1171, undrift :1204, apply_drift :1351). Locs are numpy structured
arrays; their columns go to ``device`` once, each segment is rendered
there with the Gaussian blur (render.render_t), the pair correlations
run there (imageprocess.pair_xcorrs), and the peak fits, the least
squares and the spline run on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import interpolate

from picasso_torch import imageprocess, lib, render

DRIFT_DTYPE = np.dtype([("x", np.float64), ("y", np.float64)])


def n_segments(info: list[dict], segmentation: int) -> int:
    """Segments of ``segmentation`` frames in the movie; raises
    ValueError below two (drift correction needs a pair)."""
    n_frames = lib.get_from_metadata(info, "Frames")
    n_seg = int(np.round(n_frames / segmentation))
    if n_seg < 2:
        raise ValueError(
            f"Segmentation {segmentation} gives {n_seg} segment(s) for"
            f" {n_frames} frames; drift correction needs at least 2."
            " Choose a smaller segmentation."
        )
    return n_seg


def segment(locs: np.ndarray, info: list[dict], segmentation: int,
            kwargs: dict | None = None, *, device="cuda"):
    """Split locs into temporal segments and render each
    (picasso/postprocess.py:2846). Segment i holds the frames bounds[i]
    <= frame < bounds[i + 1], bounds = linspace(0, Frames - 1, n + 1) as
    uint32, as in the reference (so the last frame is in none). Returns
    (bounds, segments (n, Height, Width) f32 tensor on ``device``);
    ``kwargs`` go to render.render_t."""
    device = lib.resolve_device(device)
    Y, X = info[0]["Height"], info[0]["Width"]
    n_frames = info[0]["Frames"]
    n_seg = n_segments(info, segmentation)
    bounds = np.linspace(0, n_frames - 1, n_seg + 1, dtype=np.uint32)
    kwargs = kwargs or {}
    names = ("x", "y", "lpx", "lpy") if kwargs.get("blur_method") else (
        "x", "y")
    cols = render.columns(locs, names, device)
    frames = torch.from_numpy(locs["frame"].astype(np.int64)).to(device)
    segments = torch.zeros((n_seg, Y, X), dtype=torch.float32, device=device)
    for i in range(n_seg):
        sel = (frames >= int(bounds[i])) & (frames < int(bounds[i + 1]))
        _, segments[i] = render.render_t({k: v[sel] for k, v in cols.items()},
                                         info, **kwargs)
    return bounds, segments


def undrift(locs: np.ndarray, info: list[dict], segmentation: int, *,
            device="cuda"):
    """RCC drift correction (Wang, Schnitzbauer et al., Opt. Express
    2014; picasso/postprocess.py:2903): segments rendered with a Gaussian
    blur of at least 1 px, all pair shifts by FFT correlation, per-segment
    shifts by least squares, then a spline of order min(3, n - 1) through
    the segment centres gives the drift of every frame. Returns (drift
    (Frames,) with fields x, y in f64, the locs with the drift
    subtracted)."""
    bounds, segments = segment(
        locs, info, segmentation,
        {"blur_method": "gaussian", "min_blur_width": 1}, device=device)
    shift_y, shift_x = imageprocess.rcc(segments, 32)
    t = (bounds[1:] + bounds[:-1]) / 2
    k = min(3, len(t) - 1)
    t_inter = np.arange(info[0]["Frames"])
    drift = np.empty(len(t_inter), DRIFT_DTYPE)
    drift["x"] = interpolate.InterpolatedUnivariateSpline(t, shift_x, k=k)(
        t_inter)
    drift["y"] = interpolate.InterpolatedUnivariateSpline(t, shift_y, k=k)(
        t_inter)
    return drift, apply_drift(locs, info, drift=drift)


def apply_drift(locs: np.ndarray, info: list[dict], *, drift) -> np.ndarray:
    """Subtract the per-frame drift (a structured array with fields x, y
    and maybe z, or an (n, 2 or 3) array of those columns) from the
    locs' coordinates (picasso/postprocess.py:3171). As in the JAX
    package, whose pandas columns turn f64 there, the corrected x, y (and
    z) are f64 fields."""
    if drift.dtype.names is None:
        d = {c: drift[:, i] for i, c in enumerate(("x", "y", "z")[
            :drift.shape[1]])}
    else:
        d = {c: drift[c] for c in drift.dtype.names}
    moved = [c for c in ("x", "y", "z") if c in locs.dtype.names and c in d]
    out = np.empty(len(locs), [(n, np.float64 if n in moved else locs.dtype[n])
                               for n in locs.dtype.names])
    frames = locs["frame"]
    for n in locs.dtype.names:
        out[n] = locs[n] - d[n][frames] if n in moved else locs[n]
    return out
