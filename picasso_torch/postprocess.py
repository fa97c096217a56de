"""Drift correction on a torch device: by redundant cross-correlation
(RCC) of temporal segments, from a drift file, and from picked fiducial
markers; and the picks themselves.

Counterpart of picasso_tpu/postprocess.py (get_index_blocks :58,
get_block_locs_at :84, picked_locs :106, n_segments :1159, segment
:1171, undrift :1204, undrift_from_picked :1246 with
_undrift_from_picked_coordinate :1261, undrift_from_fiducials :1299,
apply_drift :1351). Locs are numpy structured arrays. For RCC their
columns go to ``device`` once, each segment is rendered there with the
Gaussian blur (render.render_t), the pair correlations run there
(imageprocess.pair_xcorrs), and the peak fits, the least squares and
the spline run on the host. The picks and the drift from them run on
the host in numpy, as in JAX (a few hundred picks, one trace each); only
the fiducial search renders and identifies on ``device``. AIM is
aim.py.
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


# ---------------------------------------------------------------------------
# Picks and drift from fiducials, on the host
# ---------------------------------------------------------------------------

PICK_SHAPES = ("Circle", "Rectangle", "Polygon", "Square")


def get_index_blocks(locs: np.ndarray, info: list[dict], size: float):
    """The sane locs bucketed into a grid of (size x size) blocks and
    sorted by (y block, x block), so each block is one contiguous range.
    Returns (locs, size, x_index, y_index, block_starts, block_ends, K,
    L) (picasso/postprocess.py:37)."""
    locs = lib.ensure_sanity(locs, info)
    x_index = np.uint32(locs["x"] / size)
    y_index = np.uint32(locs["y"] / size)
    order = np.lexsort([x_index, y_index])
    locs, x_index, y_index = locs[order], x_index[order], y_index[order]
    K = int(np.ceil(info[0]["Height"] / size))
    L = int(np.ceil(info[0]["Width"] / size))
    block_starts = np.zeros((K, L), np.uint32)
    block_ends = np.zeros((K, L), np.uint32)
    if len(locs):
        flat = y_index.astype(np.int64) * L + x_index.astype(np.int64)
        change = np.nonzero(np.diff(flat))[0] + 1
        run_starts = np.concatenate([[0], change])
        run_ends = np.concatenate([change, [len(flat)]])
        ids = np.clip(flat[run_starts], 0, K * L - 1)
        block_starts.reshape(-1)[ids] = run_starts
        block_ends.reshape(-1)[ids] = run_ends
    return locs, size, x_index, y_index, block_starts, block_ends, K, L


def get_block_locs_at(x: float, y: float, index_blocks) -> np.ndarray:
    """Indices into the block-sorted locs of the 3x3 blocks around (x,
    y)."""
    _, size, _, _, block_starts, block_ends, K, L = index_blocks
    x_, y_ = int(x / size), int(y / size)
    parts = [np.arange(int(block_starts[k, m]), int(block_ends[k, m]))
             for k in range(max(0, y_ - 1), min(K, y_ + 2))
             for m in range(max(0, x_ - 1), min(L, x_ + 2))]
    return np.concatenate(parts) if parts else np.empty(0, np.int64)


def _with_fields(locs: np.ndarray, fields: list) -> np.ndarray:
    """``locs`` with the (name, values) of ``fields`` appended as new
    fields, in their values' dtypes."""
    out = np.empty(len(locs), locs.dtype.descr + [
        (name, np.asarray(v).dtype) for name, v in fields])
    for name in locs.dtype.names:
        out[name] = locs[name]
    for name, v in fields:
        out[name] = v
    return out


def picked_locs(locs: np.ndarray, info: list[dict], picks: list,
                pick_shape: str, pick_size: float | None = None,
                add_group: bool = True, index_blocks=None,
                callback=None) -> list[np.ndarray]:
    """The locs in each pick, one array per pick, sorted by frame
    (picasso/postprocess.py:375). Circles (centre, radius ``pick_size``)
    search the 3x3 blocks around their centre among the sane locs;
    rectangles ((start, end), width ``pick_size``) gain their rotated
    coordinates ``x_pick_rot``/``y_pick_rot``; polygons that are not
    closed are left out; squares are ``pick_size`` wide. ``add_group``
    adds the pick's index as the int32 field ``group``. The sort by
    frame is stable: rows within a frame keep their order (JAX's pandas
    quicksort may reorder them)."""
    if pick_shape not in PICK_SHAPES:
        raise ValueError(f"Invalid pick shape: {pick_shape}")
    out = []
    if len(picks) == 0:
        return out
    if pick_shape == "Circle":
        if index_blocks is None:
            index_blocks = get_index_blocks(locs, info, pick_size)
        locs = index_blocks[0]
    x, y = locs["x"], locs["y"]
    with lib.progress_reporter(callback, len(picks), "Picking locs") as rep:
        for i, pick in enumerate(picks):
            extra = []
            if pick_shape == "Circle":
                px, py = pick
                idx = get_block_locs_at(px, py, index_blocks)
                idx = idx[(x[idx] - px) ** 2 + (y[idx] - py) ** 2
                          < pick_size**2]
            elif pick_shape == "Rectangle":
                (xs, ys), (xe, ye) = pick
                X, Y = lib.get_pick_rectangle_corners(xs, ys, xe, ye,
                                                      pick_size)
                idx = np.nonzero(lib.check_if_in_rectangle(
                    x, y, np.array(X), np.array(Y)))[0]
                # in the columns' dtype, as pandas takes the scalars
                ft = x.dtype.type
                angle = 0.5 * np.pi - np.arctan2(ye - ys, xe - xs)
                cos, sin = ft(np.cos(angle)), ft(np.sin(angle))
                dx, dy = x[idx] - ft(xs), y[idx] - ft(ys)
                extra = [("x_pick_rot", dx * cos - dy * sin),
                         ("y_pick_rot", dx * sin + dy * cos)]
            elif pick_shape == "Polygon":
                X, Y = lib.get_pick_polygon_corners([tuple(p) for p in pick])
                if X is None:
                    rep.set_value(i + 1)
                    continue
                idx = np.nonzero(lib.check_if_in_polygon(
                    x, y, np.asarray(X), np.asarray(Y)))[0]
            else:
                px, py = pick
                half = pick_size / 2
                idx = np.nonzero((x > px - half) & (x < px + half)
                                 & (y > py - half) & (y < py + half))[0]
            if add_group:
                extra.append(("group", np.full(len(idx), i, np.int32)))
            group = locs[idx]
            if extra:
                group = _with_fields(group, extra)
            out.append(group[np.argsort(group["frame"], kind="stable")])
            rep.set_value(i + 1)
    return out


def undrift_from_picked(picked: list[np.ndarray], info: list[dict]
                        ) -> np.ndarray:
    """Drift from the picks' traces: each pick's coordinate minus its
    mean, averaged over picks per frame with weights 1 / (the pick's
    mean squared deviation from the plain mean), frames no pick covers
    interpolated (picasso/postprocess.py:3062). A structured array with
    fields x, y (and z if every pick has z), f64."""
    names = ["x", "y"] + (["z"] if all(
        "z" in p.dtype.names for p in picked) else [])
    drift = np.empty(info[0]["Frames"], [(c, np.float64) for c in names])
    for c in names:
        drift[c] = _undrift_from_picked_coordinate(picked, info, c)
    return drift


def _undrift_from_picked_coordinate(picked, info, coordinate) -> np.ndarray:
    n_picks = len(picked)
    n_frames = info[0]["Frames"]
    drift = np.full((n_picks, n_frames), np.nan)
    for i, locs in enumerate(picked):
        coords = locs[coordinate]
        drift[i, locs["frame"]] = coords - np.mean(coords)
    has_any = ~np.all(np.isnan(drift), axis=0)
    drift_mean = np.full(n_frames, np.nan)
    if has_any.any():
        drift_mean[has_any] = np.nanmean(drift[:, has_any], 0)
    sd = (drift - drift_mean) ** 2
    pick_has_any = ~np.all(np.isnan(sd), axis=1)
    msd = np.full(n_picks, np.nan)
    if pick_has_any.any():
        msd[pick_has_any] = np.nanmean(sd[pick_has_any], 1)
    msd = np.where(np.isnan(msd), np.inf, msd)
    # a pick on the mean drift exactly (a single pick) has msd 0: floor
    # it so that the weights stay finite
    msd = np.maximum(msd, 1e-12)
    drift_ma = np.ma.MaskedArray(drift, mask=np.isnan(drift))
    drift_mean = np.ma.average(drift_ma, axis=0, weights=1 / msd)
    drift_mean = drift_mean.filled(np.nan)
    nans = np.isnan(drift_mean)
    if nans.any() and not nans.all():
        idx = np.arange(n_frames)
        drift_mean[nans] = np.interp(idx[nans], idx[~nans], drift_mean[~nans])
    return drift_mean


def undrift_from_fiducials(locs: np.ndarray, info: list[dict],
                           picks: list | None = None,
                           pick_size: float | None = None,
                           undrift_z: bool = True, index_blocks=None, *,
                           device="cuda"):
    """Drift correction from fiducial markers (picasso/postprocess.py:
    2964): with no ``picks``, imageprocess.find_fiducials finds them on
    ``device`` (radius half its box); else circles of radius
    ``pick_size``. Returns (locs with the drift subtracted, info with an
    "Undrift from picked" block, drift)."""
    from picasso_torch import __version__

    pixelsize = lib.get_from_metadata(info, "Pixelsize", raise_error=True)
    if picks is None:
        picks, box = imageprocess.find_fiducials(locs, info, device=device)
        pick_radius = box / 2
        # a given index was built for another radius
        index_blocks = None
    elif pick_size is None:
        raise ValueError(
            "explicit pick coordinates need a pick_size "
            "(the pick radius, in camera pixels)"
        )
    else:
        pick_radius = pick_size
    if not len(picks):
        raise ValueError(
            "no fiducial picks available — cannot estimate drift"
        )
    picked = picked_locs(locs, info, picks, "Circle", pick_size=pick_radius,
                         add_group=False, index_blocks=index_blocks)
    drift = undrift_from_picked(picked, info)
    if not undrift_z and "z" in drift.dtype.names:
        drift = drift[["x", "y"]].astype(DRIFT_DTYPE)
    new_info = info + [{
        "Generated by": f"Picasso v{__version__} Undrift from picked",
        "Number of picks": len(picks),
        "Pick radius (nm)": pick_radius * pixelsize,
    }]
    return apply_drift(locs, info, drift=drift), new_info, drift
