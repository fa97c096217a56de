"""Drift correction on a torch device: by redundant cross-correlation
(RCC) of temporal segments, from a drift file, and from picked fiducial
markers; the picks themselves; linking into binding events, dark times,
group statistics and the localization statistics.

Counterpart of picasso_tpu/postprocess.py (get_index_blocks :58,
get_block_locs_at :84, picked_locs :106, n_segments :1159, segment
:1171, undrift :1204, undrift_from_picked :1246 with
_undrift_from_picked_coordinate :1261, undrift_from_fiducials :1299,
apply_drift :1351; align :1373, align_from_picked :1399, align_rcc
:1538; and the statistics and linking: distance_histogram
:540, pair_correlation :584, compute_local_density :600,
_next_frame_neighbor_distance_histogram :632, nena :677, frc :724, _frc
:773, dark_times :826, compute_dark_times :856, link :920 with the
native link_groups, _link_loc_groups :979, cluster_combine :1067,
cluster_combine_dist :1109, groupprops :1579, nn_analysis :1661, resi
:1687). Locs
are numpy structured arrays. For RCC their records go to ``device``
once (ops/records.upload), each segment is rendered there with the
Gaussian blur (render.render_t) from columns taken out of the records
there, the pair correlations run there (imageprocess.pair_xcorrs), the
peak fits, the least squares and the spline run on the host, and the
drift is subtracted from the records on ``device``
(ops/records.apply_drift_records), which come back once. The picks and
the drift from them run on the host in numpy, as in JAX (a few hundred
picks, one trace each); only the fiducial search renders and identifies
on ``device``, and the drift is subtracted there. AIM is
aim.py. Linking finds its candidates on ``device`` (ops/link.py) and
walks them on the host; the pair statistics run on ``device`` by cell
lists or blocked tiles (ops/neighbors.py), held to JAX's cKDTree route;
roots that must equal numpy's are taken on the host (torch's f64 sqrt
on the CPU is not always correctly rounded).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import interpolate
from scipy.optimize import curve_fit

from picasso_torch import imageprocess, lib, masking, render
from picasso_torch.ops import link as link_ops
from picasso_torch.ops import neighbors, records
from picasso_torch.profiling import span

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
    ``kwargs`` go to render.render_t. The locs go to ``device`` as their
    records (ops/records.upload)."""
    device = lib.resolve_device(device)
    return _segment(records.upload(locs, device), locs.dtype, info,
                    segmentation, kwargs)


def _segment(recs: torch.Tensor, dtype: np.dtype, info: list[dict],
             segmentation: int, kwargs: dict | None = None):
    """:func:`segment` of locs already on the device as (N, itemsize)
    records of ``dtype``: the columns the renders read are taken from
    the records there."""
    Y, X = info[0]["Height"], info[0]["Width"]
    n_frames = info[0]["Frames"]
    n_seg = n_segments(info, segmentation)
    bounds = np.linspace(0, n_frames - 1, n_seg + 1, dtype=np.uint32)
    kwargs = kwargs or {}
    names = ("x", "y", "lpx", "lpy") if kwargs.get("blur_method") else (
        "x", "y")
    with span("picasso.undrift.segment"):
        cols = {n: records.column(recs, dtype, n) for n in names}
        frames = records.column(recs, dtype, "frame")
        segments = torch.zeros((n_seg, Y, X), dtype=torch.float32,
                               device=recs.device)
        for i in range(n_seg):
            sel = (frames >= int(bounds[i])) & (frames < int(bounds[i + 1]))
            _, segments[i] = render.render_t(
                {k: v[sel] for k, v in cols.items()}, info, **kwargs)
    return bounds, segments


def undrift(locs: np.ndarray, info: list[dict], segmentation: int, *,
            device="cuda"):
    """RCC drift correction (Wang, Schnitzbauer et al., Opt. Express
    2014; picasso/postprocess.py:2903): segments rendered with a Gaussian
    blur of at least 1 px, all pair shifts by FFT correlation, per-segment
    shifts by least squares, then a spline of order min(3, n - 1) through
    the segment centres gives the drift of every frame. Returns (drift
    (Frames,) with fields x, y in f64, the locs with the drift
    subtracted). ``device`` may be a mesh, or ``"cuda"`` with several
    cards visible (parallel/mesh.route): the segments render on its
    first device and the pair correlations split over its shards
    (imageprocess.pair_xcorrs). The locs cross to that device once, as
    their records, and the drift is subtracted there
    (ops/records.apply_drift_records); the corrected records cross back
    once. Runs in the span ``picasso.undrift``, its steps in
    ``picasso.undrift.upload``, ``.segment``, ``.xcorr``, ``.peak_fit``,
    ``.solve`` and ``.apply`` (profiling.span)."""
    from picasso_torch.parallel.mesh import route

    device, mesh = route(device)
    with span("picasso.undrift"):
        with span("picasso.undrift.upload"):
            recs = records.upload(locs, device)
        bounds, segments = _segment(
            recs, locs.dtype, info, segmentation,
            {"blur_method": "gaussian", "min_blur_width": 1})
        shift_y, shift_x = imageprocess.rcc(segments, 32, mesh)
        with span("picasso.undrift.solve"):
            t = (bounds[1:] + bounds[:-1]) / 2
            k = min(3, len(t) - 1)
            t_inter = np.arange(info[0]["Frames"])
            drift = np.empty(len(t_inter), DRIFT_DTYPE)
            drift["x"] = interpolate.InterpolatedUnivariateSpline(
                t, shift_x, k=k)(t_inter)
            drift["y"] = interpolate.InterpolatedUnivariateSpline(
                t, shift_y, k=k)(t_inter)
        with span("picasso.undrift.apply"):
            return drift, _apply_drift(recs, locs.dtype, drift)


def apply_drift(locs: np.ndarray, info: list[dict], *, drift,
                device="cuda") -> np.ndarray:
    """Subtract the per-frame drift (a structured array with fields x, y
    and maybe z, or an (n, 2 or 3) array of those columns, taken in f64)
    from the locs' coordinates (picasso/postprocess.py:3171). As in the
    JAX package, whose pandas columns turn f64 there, the corrected x, y
    (and z) are f64 fields, each the f64 coordinate minus the drift of
    its frame, bit for bit as numpy subtracts them field by field. The
    records go to ``device`` once and back once, rewritten there: on the
    card by csrc/records.cu, on the CPU by its plain version
    (ops/records.apply_drift_records_plain). A frame outside the drift
    raises IndexError; a negative frame of a signed type counts from the
    end, as numpy's indexing does."""
    device = lib.resolve_device(device)
    return _apply_drift(records.upload(locs, device), locs.dtype, drift)


def _apply_drift(recs: torch.Tensor, dtype: np.dtype, drift) -> np.ndarray:
    """:func:`apply_drift` of locs already on a device as (N, itemsize)
    records of ``dtype``."""
    layout, table = records.drift_layout(dtype, drift)
    out = records.apply_drift_records(
        recs, layout, torch.from_numpy(table).to(recs.device))
    return records.download(out, layout.out_dtype)


# ---------------------------------------------------------------------------
# Picks and drift from fiducials, on the host
# ---------------------------------------------------------------------------

PICK_SHAPES = ("Circle", "Rectangle", "Polygon", "Square")


def get_index_blocks(locs: np.ndarray, info: list[dict], size: float):
    """The sane locs bucketed into a grid of (size x size) blocks and
    sorted by (y block, x block), so each block is one contiguous range.
    Returns (locs, size, x_index, y_index, block_starts, block_ends, K,
    L) (picasso/postprocess.py:37)."""
    return _index_blocks(locs, info, size)[0]


def _index_blocks(locs: np.ndarray, info: list[dict], size: float):
    """(:func:`get_index_blocks`, the position in ``locs`` of each of its
    rows)."""
    rows = np.nonzero(lib.sane_rows(locs, info))[0]
    locs = locs[rows]
    x_index = np.uint32(locs["x"] / size)
    y_index = np.uint32(locs["y"] / size)
    order = np.lexsort([x_index, y_index])
    locs, x_index, y_index = locs[order], x_index[order], y_index[order]
    K, L = _index_blocks_shape(info, size)
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
    return ((locs, size, x_index, y_index, block_starts, block_ends, K, L),
            rows[order])


def _index_blocks_shape(info: list[dict], size: float) -> tuple[int, int]:
    return (int(np.ceil(info[0]["Height"] / size)),
            int(np.ceil(info[0]["Width"] / size)))


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
    out = np.empty(len(locs), [(n, locs.dtype[n]) for n in locs.dtype.names]
                   + [(name, np.asarray(v).dtype) for name, v in fields])
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
    sets the int32 field ``group`` to the pick's index (in place of a
    ``group`` the locs hold, as JAX's column assignment). The sort by
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
        for i, idx in _pick_rows(x, y, picks, pick_shape, pick_size,
                                 index_blocks):
            rep.set_value(i + 1)
            if idx is None:
                continue
            extra = []
            if pick_shape == "Rectangle":
                (xs, ys), (xe, ye) = picks[i]
                # in the columns' dtype, as pandas takes the scalars
                ft = x.dtype.type
                angle = 0.5 * np.pi - np.arctan2(ye - ys, xe - xs)
                cos, sin = ft(np.cos(angle)), ft(np.sin(angle))
                dx, dy = x[idx] - ft(xs), y[idx] - ft(ys)
                extra = [("x_pick_rot", dx * cos - dy * sin),
                         ("y_pick_rot", dx * sin + dy * cos)]
            if add_group:
                extra.append(("group", np.full(len(idx), i, np.int32)))
            group = locs[idx]
            for name, values in extra:
                group = lib.append_to_rec(group, values, name)
            out.append(group[np.argsort(group["frame"], kind="stable")])
    return out


def _pick_rows(x: np.ndarray, y: np.ndarray, picks: list, pick_shape: str,
               pick_size, index_blocks=None):
    """For each pick, (its index, the rows of (x, y) within it), the rows
    None for a polygon that is not closed. Circles (radius ``pick_size``)
    search the 3x3 blocks of ``index_blocks`` around their centre, and
    (x, y) are then the columns of the blocks' locs."""
    for i, pick in enumerate(picks):
        if pick_shape == "Circle":
            px, py = pick
            idx = get_block_locs_at(px, py, index_blocks)
            idx = idx[(x[idx] - px) ** 2 + (y[idx] - py) ** 2 < pick_size**2]
        elif pick_shape == "Rectangle":
            (xs, ys), (xe, ye) = pick
            X, Y = lib.get_pick_rectangle_corners(xs, ys, xe, ye, pick_size)
            idx = np.nonzero(lib.check_if_in_rectangle(
                x, y, np.array(X), np.array(Y)))[0]
        elif pick_shape == "Polygon":
            X, Y = lib.get_pick_polygon_corners([tuple(p) for p in pick])
            idx = None if X is None else np.nonzero(lib.check_if_in_polygon(
                x, y, np.asarray(X), np.asarray(Y)))[0]
        else:
            px, py = pick
            half = pick_size / 2
            idx = np.nonzero((x > px - half) & (x < px + half)
                             & (y > py - half) & (y < py + half))[0]
        yield i, idx


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
    return (apply_drift(locs, info, drift=drift, device=device), new_info,
            drift)


# ---------------------------------------------------------------------------
# Channel alignment
# ---------------------------------------------------------------------------


def _shift(locs: np.ndarray, name: str, shift) -> None:
    """Subtract ``shift`` from the field ``name`` in place, in the
    field's dtype (a pandas column minus a numpy scalar keeps the
    column's dtype and rounds the scalar to it first)."""
    locs[name] -= locs.dtype[name].type(shift)


def align(locs: list[np.ndarray], infos: list, display: bool = False, *,
          apply_shifts: bool = True, return_shifts: bool = False,
          device="cuda"):
    """One RCC pass across channels (picasso/postprocess.py:3296): the
    ``smooth`` render of each channel on ``device`` (the same shape for
    every channel), the redundant cross-correlation of those images
    (imageprocess.rcc), and with ``apply_shifts`` each channel's shift
    subtracted from its x and y in place, as JAX's pandas columns are.
    Returns the locs, and with ``return_shifts`` (shift_x, shift_y) too.
    ``display`` is accepted for JAX's signature."""
    device = lib.resolve_device(device)
    images = torch.stack([
        render.render_t(render.columns(locs_, ("x", "y"), device), info_,
                        blur_method="smooth")[1]
        for locs_, info_ in zip(locs, infos)])
    shift_y, shift_x = imageprocess.rcc(images)
    if apply_shifts:
        for locs_, dx, dy in zip(locs, shift_x, shift_y):
            _shift(locs_, "y", dy)
            _shift(locs_, "x", dx)
    if return_shifts:
        return locs, (shift_x, shift_y)
    return locs


def align_rcc(locs: list[np.ndarray], infos: list, display: bool = False,
              return_shifts: bool = False, *, device="cuda"):
    """RCC alignment of copies of the channels, repeated until every
    channel's |dx| + |dy| is at most 0.001 px or 5 passes have run
    (picasso/postprocess.py:3352). Returns the aligned locs, and with
    ``return_shifts`` (the mean x shift of each pass, the mean y
    shift)."""
    locs = [locs_.copy() for locs_ in locs]
    convergence = 0.001
    shift_x_hist, shift_y_hist = [], []
    for _ in range(5):
        _, (sx, sy) = align(locs, infos, apply_shifts=False,
                            return_shifts=True, device=device)
        completed = True
        for locs_, dx, dy in zip(locs, sx, sy):
            if abs(dx) + abs(dy) > convergence:
                completed = False
            _shift(locs_, "x", dx)
            _shift(locs_, "y", dy)
        shift_x_hist.append(np.mean(sx))
        shift_y_hist.append(np.mean(sy))
        if completed:
            break
    if return_shifts:
        return locs, (shift_x_hist, shift_y_hist)
    return locs


def align_from_picked(all_locs: list[np.ndarray], infos: list, *,
                      picks: list, pick_shape: str = "Circle",
                      pick_size: float | None = None,
                      return_shifts: bool = False, index_blocks=None):
    """Align channels by the centres of mass of picked regions
    (picasso/postprocess.py:3446): for every pair of channels the mean
    over the picks of the difference of their centres of mass (a pick
    without locs left out) in y, x and, when every channel's first pick
    has z, in z; those pair shifts solved jointly by the RCC redundancy
    step (lib.minimize_shifts), and each channel's shift subtracted from
    a copy of it. Circles take ``pick_size`` as their diameter. On the
    host, in numpy, as in JAX. Returns the aligned locs, and with
    ``return_shifts`` the shifts (y, x[, z]) per channel."""
    if pick_shape not in PICK_SHAPES:
        raise ValueError(f"Invalid pick shape: {pick_shape}")
    size = pick_size / 2 if pick_shape == "Circle" else pick_size
    pl = [picked_locs(locs_, info_, picks, pick_shape, pick_size=size,
                      add_group=False,
                      index_blocks=index_blocks[ch] if index_blocks else None)
          for ch, (locs_, info_) in enumerate(zip(all_locs, infos))]

    def pair_shifts(name):
        coms = [np.array([lib.series_mean_std(p[name])[0] if len(p)
                          else np.nan for p in channel]) for channel in pl]
        n = len(coms)
        shifts = np.zeros((n, n))
        for i in range(n - 1):
            for j in range(i + 1, n):
                shifts[i, j] = np.nanmean(coms[j] - coms[i])
        return shifts

    dz = (pair_shifts("z") if all("z" in channel[0].dtype.names
                                  for channel in pl) else None)
    shift = lib.minimize_shifts(pair_shifts("x"), pair_shifts("y"), dz)
    aligned = []
    for ch, locs_ in enumerate(all_locs):
        out = locs_.copy()
        for name, d in zip(("y", "x", "z"), shift):
            _shift(out, name, d[ch])
        aligned.append(out)
    if return_shifts:
        return aligned, shift
    return aligned


# ---------------------------------------------------------------------------
# Localization statistics: pair distances, local density, NeNA, FRC,
# nearest neighbours
# ---------------------------------------------------------------------------


def _xy(locs: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(np.ascontiguousarray(locs[c])).to(
        device, torch.float64) for c in ("x", "y"))


def distance_histogram(locs: np.ndarray, info: list[dict], bin_size: float,
                       r_max: float, *, device="cuda") -> np.ndarray:
    """Histogram (uint32) of the distances of every pair of sane locs
    below n_bins * bin_size, n_bins = int(uint32(r_max / bin_size)), each
    pair counted once (picasso/postprocess.py:1002). As in JAX, all
    pairs count (the reference's 2 x 2 block scan misses some), and the
    bins are those of JAX's cKDTree route: edge_k <= d < edge_k+1 for
    the linspace edges, tested as squares
    (ops/neighbors.histogram_thresholds)."""
    device = lib.resolve_device(device)
    locs = lib.ensure_sanity(locs, info)
    n_bins = int(np.uint32(r_max / bin_size))
    x, y = _xy(locs, device)
    dh = neighbors.pairwise_distance_histogram(x, y, bin_size, n_bins)
    return dh.cpu().numpy().astype(np.uint32)


def pair_correlation(locs: np.ndarray, info: list[dict], bin_size: float,
                     r_max: float, *, device="cuda"):
    """Ring-area-normalized pair correlation (picasso/postprocess.py:
    1505): (lower bin edges, histogram / ring area)."""
    dh = distance_histogram(locs, info, bin_size, r_max, device=device)
    bins_lower = np.arange(bin_size, r_max + bin_size, bin_size)
    if len(bins_lower) > len(dh):
        bins_lower = bins_lower[:len(dh)]
    area = np.pi * bin_size * (2 * bins_lower + bin_size)
    return bins_lower, dh / area


def compute_local_density(locs: np.ndarray, info: list[dict], radius: float,
                          *, device="cuda") -> np.ndarray:
    """The sane locs with ``density`` (uint32): the other locs within
    ``radius`` of each (picasso/postprocess.py:1582; d^2 <= radius^2 in
    f64, as cKDTree.query_ball_point)."""
    device = lib.resolve_device(device)
    locs = lib.ensure_sanity(locs, info)
    x, y = _xy(locs, device)
    counts = neighbors.radius_count(x, y, radius)
    return lib.append_to_rec(locs, counts.cpu().numpy().astype(np.uint32),
                             "density")


def nn_analysis(X1: np.ndarray, X2: np.ndarray, nn_count: int, *,
                device="cuda") -> np.ndarray:
    """The ``nn_count`` nearest-neighbour distances (n, nn_count) f64 from
    the rows of X1 into X2 (picasso/postprocess.py:3704); when X1 equals
    X2 the nearest (the point itself) is left out, as the reference
    drops the first of nn_count + 1."""
    if X1.shape[1] != X2.shape[1]:
        raise ValueError("X1 and X2 must have the same number of dimensions.")
    device = lib.resolve_device(device)
    same = np.array_equal(X1, X2)
    a = torch.from_numpy(np.ascontiguousarray(X1)).to(device, torch.float64)
    b = a if same else torch.from_numpy(np.ascontiguousarray(X2)).to(
        device, torch.float64)
    d2 = neighbors.knn_d2(a, b, nn_count + same)
    return np.sqrt(d2[:, int(same):].cpu().numpy()).reshape(-1, nn_count)


def _sqrt_bins(dtype, bin_size: float, n_bins: int, d_max: float):
    """The bins of d = sqrt(s) as JAX's numpy forms them in ``dtype``
    (int(d / bin_size), d <= d_max), as thresholds on s itself: (T, s_max)
    with int(d / bin_size) >= k exactly when s >= T[k - 1], and d <=
    d_max exactly when s <= s_max. Both sides are monotone in s, so a
    bisection over the bit patterns of ``dtype`` with numpy's correctly
    rounded sqrt finds them; on the device no root is taken (torch's on
    the CPU goes through MKL and is not always correctly rounded)."""
    ft = np.dtype(dtype).type
    it = np.uint32 if ft == np.float32 else np.uint64
    b, top = ft(bin_size), ft(max(d_max, n_bins * bin_size)) ** 2 * 4

    def first(pred, m):
        lo = np.zeros(m, it)
        hi = np.full(m, np.array(top, ft).view(it))
        while np.any(lo < hi):
            mid = lo + (hi - lo) // 2
            ok = pred(mid.view(ft))
            hi, lo = np.where(ok, mid, hi), np.where(ok, lo, mid + 1)
        return lo.view(ft)

    k = np.arange(1, n_bins + 1)
    T = first(lambda s: np.trunc(np.sqrt(s) / b) >= k, n_bins)
    above = first(lambda s: np.sqrt(s) > ft(d_max), 1)[0]
    return T, np.nextafter(above, ft(0))


def _next_frame_neighbor_distance_histogram(locs: np.ndarray, callback=None,
                                            *, device="cuda"):
    """Histogram of the distances between locs of one group in
    consecutive frames, 1000 bins of 0.001 px (picasso/postprocess.py:
    1179). The pairs come from ops/link.window_pairs (window one frame,
    cells of side a little over 1 px); they are measured as JAX's numpy
    measures them, in the columns' own dtype (under NumPy 2 an f32
    column keeps dx, dx^2, d and d / 0.001 in f32): |dx| and |dy| <= 1,
    d <= 1, bin int(d / 0.001), the last two through :func:`_sqrt_bins`.
    Returns (bin centres, counts f64)."""
    device = lib.resolve_device(device)
    bin_size, d_max = 0.001, 1.0
    bins = np.arange(0, d_max, bin_size)
    dnfl = np.zeros(len(bins))
    if len(locs):
        frame = torch.from_numpy(locs["frame"].astype(np.int64)).to(device)
        group = torch.from_numpy(
            locs["group"].astype(np.int64) if "group" in locs.dtype.names
            else np.zeros(len(locs), np.int64)).to(device)
        x = torch.from_numpy(np.ascontiguousarray(locs["x"])).to(device)
        y = torch.from_numpy(np.ascontiguousarray(locs["y"])).to(device)
        counts = torch.zeros(len(bins), dtype=torch.int64, device=device)
        dt = torch.promote_types(x.dtype, y.dtype)
        T, s_max = _sqrt_bins(torch.empty(0, dtype=dt).numpy().dtype,
                              bin_size, len(bins), d_max)
        T = torch.from_numpy(T).to(device)
        for i, j in link_ops.window_pairs(frame, x.to(torch.float64),
                                          y.to(torch.float64), group, d_max,
                                          1):
            dx = x[i] - x[j]
            dy = y[i] - y[j]
            ok = (dx * dx <= d_max**2) & (dy * dy <= d_max**2)
            dx, dy = dx[ok], dy[ok]
            sq = dx * dx + dy * dy
            idx = torch.searchsorted(T, sq[sq <= float(s_max)], side="right")
            counts += torch.bincount(idx[idx < len(bins)],
                                     minlength=len(bins))
        dnfl += counts.cpu().numpy()
    if callback is not None:
        callback(100)
    return bins + bin_size / 2, dnfl


def nena(locs: np.ndarray, info=None, callback=None, *, device="cuda"):
    """NeNA experimental localization precision (Endesfelder et al.,
    Histochem. Cell Biol. 2014; picasso/postprocess.py:1058): the
    next-frame distance histogram on ``device``, the fit of the single
    and short-range terms with scipy's curve_fit on the host. Returns
    (result dict, s)."""
    bin_centers, dnfl = _next_frame_neighbor_distance_histogram(
        locs, callback, device=device)
    return _nena_fit(locs, bin_centers, dnfl)


def _nena_fit(locs: np.ndarray, bin_centers: np.ndarray, dnfl: np.ndarray):
    """:func:`nena`'s fit of the distance histogram, on the host."""

    def func(d, delta_a, s, ac, dc, sc):
        a = ac + delta_a
        p_single = a * (d / (2 * s**2)) * np.exp(-(d**2) / (4 * s**2))
        p_short = (ac / (sc * np.sqrt(2 * np.pi))
                   * np.exp(-0.5 * ((d - dc) / sc) ** 2))
        return p_single + p_short

    area = np.trapezoid(dnfl, bin_centers)
    median_lp = np.mean([np.median(locs["lpx"]), np.median(locs["lpy"])])
    p0 = [0.8 * area, median_lp, 0.1 * area, 2 * median_lp, median_lp]
    bounds = ([0, 0, 0, 0, 0], [np.inf] * 5)
    popt, _ = curve_fit(func, bin_centers, dnfl, p0=p0, bounds=bounds)
    result = {
        "d": bin_centers,
        "data": dnfl,
        "best_fit": func(bin_centers, *popt),
        "best_values": {"delta_a": popt[0], "s": popt[1], "ac": popt[2],
                        "dc": popt[3], "sc": popt[4]},
    }
    return result, popt[1]


def frc(locs: np.ndarray, info: list[dict], viewport, *,
        random_seed: int = 42, device="cuda") -> dict:
    """Fourier ring correlation resolution (Nieuwenhuizen et al., Nat.
    Methods 2013; picasso/postprocess.py:1320): the viewport squared
    about its centre, the locs in it split at random into halves
    (np.random.RandomState(random_seed).permutation, the stream of JAX's
    np.random.seed + np.random.permutation without its global state),
    each rendered at bins of NeNA / 2 on ``device``, then :func:`_frc`.
    Returns the curve, its LOESS, the frequencies, the resolution (nm,
    None without a 1/7 crossing) and the two masked images (numpy)."""
    device = lib.resolve_device(device)
    pixelsize = lib.get_from_metadata(info, "Pixelsize", raise_error=True)
    lp = nena(locs, info, device=device)[1]
    vw = viewport[1][1] - viewport[0][1]
    vh = viewport[1][0] - viewport[0][0]
    if vw < vh:
        yc = 0.5 * (viewport[0][0] + viewport[1][0])
        viewport = ((yc - vw / 2, viewport[0][1]), (yc + vw / 2,
                                                    viewport[1][1]))
    elif vh < vw:
        xc = 0.5 * (viewport[0][1] + viewport[1][1])
        viewport = ((viewport[0][0], xc - vh / 2), (viewport[1][0],
                                                    xc + vh / 2))
    (y_min, x_min), (y_max, x_max) = viewport
    in_view = ((locs["x"] > x_min) & (locs["y"] > y_min)
               & (locs["x"] < x_max) & (locs["y"] < y_max))
    locs = locs[in_view]
    r_idx = np.random.RandomState(random_seed).permutation(len(locs))
    half = len(r_idx) // 2
    cols = render.columns(locs, ("x", "y"), device)
    idx = torch.from_numpy(r_idx).to(device)
    halves = [{k: v[i] for k, v in cols.items()}
              for i in (idx[:half], idx[half:])]
    curve, smooth, freqs, res, images = _frc(*halves, pixelsize, lp,
                                             viewport)
    return {"frc_curve": curve, "frc_curve_smooth": smooth,
            "frequencies": freqs, "resolution": res, "images": images}


#: spectrum pixels whose ring sums are formed at once
_RING_BLOCK = 1 << 24


def _frc(cols1: dict, cols2: dict, pixelsize, lp, viewport):
    """FRC of two halves given as columns on a device (render.columns):
    histograms at bins of lp / 2 (cut to odd size), the Tukey mask, f64
    FFTs and the ring sums on the device; the curve's LOESS and its 1/7
    crossing on the host (picasso_tpu/postprocess.py:773). For the full
    field (some 30k px square at NeNA / 2 of 0.02 px) the masked image is
    formed in place a block of rows at a time, and the spectra are the
    half planes of rfft2 (a real image's spectrum is Hermitian, and the
    ring sums' terms are equal at k and -k), made by blocks of rows and
    then of columns: the columns kx > 0 count twice, and no fftshift is
    made (the rings are taken on the signed frequencies). JAX transforms
    and sums the full shifted plane in row order, so the sums agree to
    rounding."""
    binsize = lp / 2
    oversampling = 1 / binsize
    info = [{"Pixelsize": pixelsize}]
    images = [render.render_t(c, info, oversampling, viewport, None)[1]
              for c in (cols1, cols2)]
    if images[0].shape[0] % 2 == 0:
        images = [im[:-1, :-1] for im in images]
    # a squared viewport can still render to two pixel counts: raise as
    # masking.threshold_tukey of the first image does
    masking.check_square(images[0])
    # masking.threshold_tukey of the first image, w[n - 1 - i] * w[j],
    # formed a block of rows at a time
    w = masking.tukey_window(images[0].shape[1], images[0].device)
    w_rev = w.flip(0)

    def spectrum(im):
        x = im.to(torch.float64)
        n = x.shape[0]
        rows = max(1, _RING_BLOCK // n)
        for r0 in range(0, n, rows):
            x[r0:r0 + rows] *= w_rev[r0:r0 + rows, None] * w[None, :]
        image = x.cpu().numpy()
        # rfft2 as its two passes, by blocks: a 2D plan of an awkward
        # size asks cuFFT for several times the image as workspace
        half = torch.empty((n, n // 2 + 1), dtype=torch.complex128,
                           device=x.device)
        for r0 in range(0, n, rows):
            half[r0:r0 + rows] = torch.fft.rfft(x[r0:r0 + rows], dim=1)
        del x
        for k0 in range(0, n // 2 + 1, rows):
            half[:, k0:k0 + rows] = torch.fft.fft(half[:, k0:k0 + rows],
                                                  dim=0)
        return half, image

    f1, im1 = spectrum(images.pop(0))
    f2, im2 = spectrum(images.pop(0))
    n = im1.shape[0]
    n_r = n // 2 + 1
    dev = f1.device
    fy = torch.arange(n, device=dev)
    fy = torch.where(fy < n_r, fy, fy - n)
    fx = torch.arange(n_r, device=dev)
    ring = imageprocess.ring_of(fy[:, None], fx[None, :]).reshape(-1)
    twice = (fx > 0).expand(n, n_r).reshape(-1)
    sums = torch.zeros((3, n_r), dtype=torch.float64, device=dev)
    f1, f2 = f1.reshape(-1), f2.reshape(-1)
    for p0 in range(0, len(ring), _RING_BLOCK):
        blk = slice(p0, p0 + _RING_BLOCK)
        keep = ring[blk] < n_r
        idx, a, b = ring[blk][keep], f1[blk][keep], f2[blk][keep]
        scale = torch.where(twice[blk][keep], 2.0, 1.0).to(torch.float64)
        # FRC(q) = Re sum_ring F1 F2* / sqrt(sum_ring |F1|^2 sum_ring
        # |F2|^2), the real part taken per pixel as in JAX
        sums[0].index_add_(0, idx, (a.real * b.real + a.imag * b.imag)
                           * scale)
        sums[1].index_add_(0, idx, (a.real * a.real + a.imag * a.imag)
                           * scale)
        sums[2].index_add_(0, idx, (b.real * b.real + b.imag * b.imag)
                           * scale)
    del f1, f2
    cross, power1, power2 = sums.cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        frc_curve = np.nan_to_num(cross / np.sqrt(power1 * power2), nan=0.0,
                                  posinf=0.0, neginf=0.0)
    sspan = max(int(np.ceil(int(n / 2) / 20)), 5)
    frc_smooth = masking.loess_smooth(frc_curve, sspan)
    freqs = np.arange(len(frc_curve)) / n / (pixelsize * binsize)
    threshold = 1 / 7
    resolution = None
    for i in range(1, len(frc_smooth)):
        if frc_smooth[i - 1] >= threshold and frc_smooth[i] < threshold:
            f1_, f2_ = freqs[i - 1], freqs[i]
            r1, r2 = frc_smooth[i - 1], frc_smooth[i]
            resolution = 1 / (f1_ + (threshold - r1) * (f2_ - f1_) / (r2 - r1))
            break
    return frc_curve, frc_smooth, freqs, resolution, (im1, im2)


# ---------------------------------------------------------------------------
# Linking and dark times
# ---------------------------------------------------------------------------


def _sorted_by_frame(locs: np.ndarray) -> np.ndarray:
    """``locs`` sorted stably by frame (rows within a frame keep their
    order; JAX's pandas quicksort may reorder them)."""
    f = locs["frame"]
    if len(f) > 1 and np.any(f[1:] < f[:-1]):
        return locs[np.argsort(f, kind="stable")]
    return locs


def link_groups_t(frame, x, y, group, d_max: float, max_dark_time: int, *,
                  device="cuda") -> torch.Tensor:
    """Chain ids (n,) int32 on ``device`` of locs sorted by frame: the
    candidate successors on the device (ops/link.successors), then the
    greedy walk (ops/link.walk)."""
    device = lib.resolve_device(device)
    cols = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        np.asarray(frame, np.int64), x, y, np.asarray(group, np.int64))]
    offsets, succ = link_ops.successors(cols[0], cols[1], cols[2], cols[3],
                                        d_max, max_dark_time)
    return link_ops.walk(offsets, succ)


def link_groups(frame, x, y, group, d_max: float, max_dark_time: int, *,
                device="cuda") -> np.ndarray:
    """Greedy chain ids (n,) int32 of locs sorted by frame, the port's
    counterpart of picasso_tpu.native.link_groups (equal to it on the
    same rows)."""
    return link_groups_t(frame, x, y, group, d_max, max_dark_time,
                         device=device).cpu().numpy()


def link(locs: np.ndarray, info: list[dict], r_max: float = 0.05,
         max_dark_time: int = 3, combine_mode: str = "average",
         remove_ambiguous_lengths: bool = True, *, device="cuda"
         ) -> np.ndarray:
    """Group locs into binding events by spatiotemporal proximity
    (picasso/postprocess.py:2007): locs of one group in frames up to
    ``max_dark_time + 1`` apart within ``r_max`` chain greedily
    (:func:`link_groups`), and each chain becomes one event
    (:func:`_link_loc_groups`). The locs are sorted by frame stably, so
    rows within a frame keep their order; JAX's pandas quicksort may
    reorder them, and with them which successor a chain claims."""
    device = lib.resolve_device(device)
    if len(locs) == 0:
        extra = []
        if "frame" in locs.dtype.names:
            extra += [("len", np.array([], np.int32)),
                      ("n", np.array([], np.int32))]
        if "photons" in locs.dtype.names:
            extra.append(("photon_rate", np.array([], np.float32)))
        out = locs
        for name, v in extra:
            out = lib.append_to_rec(out, v, name)
        return out
    if combine_mode != "average":
        raise NotImplementedError(
            "Refit mode is not implemented yet. Please use 'average'.")
    locs = _sorted_by_frame(locs)
    group = (locs["group"] if "group" in locs.dtype.names
             else np.zeros(len(locs), np.int32))
    link_group = link_groups_t(locs["frame"], locs["x"], locs["y"], group,
                               r_max, max_dark_time, device=device)
    return _link_loc_groups(locs, info, link_group, remove_ambiguous_lengths)


def _link_loc_groups(locs: np.ndarray, info: list[dict],
                     link_group: torch.Tensor,
                     remove_ambiguous_lengths: bool = True) -> np.ndarray:
    """Aggregate linked locs into binding events on ``link_group``'s
    device (picasso/postprocess.py:2680): weighted means of the positions
    (weights 1 / lp^2 in the lp column's dtype), sums of photons and bg,
    means elsewhere, all as f64 segment sums (index_add_; on the CPU in
    index order, as np.bincount sums), first and last frames by
    scatter_reduce. The columns, their order and dtypes are JAX's;
    ``remove_ambiguous_lengths`` drops events that start at frame 0 or
    end at the last frame."""
    dev = link_group.device
    lg = link_group.to(torch.int64)
    n_groups = int(lg.max()) + 1
    names = locs.dtype.names

    def col(name):
        return torch.from_numpy(np.ascontiguousarray(locs[name])).to(dev)

    def segsum(v):
        out = torch.zeros(n_groups, dtype=torch.float64, device=dev)
        return out.index_add_(0, lg, v.to(torch.float64))

    n_ = torch.bincount(lg, minlength=n_groups)
    n_f = n_.to(torch.float64)

    def seg_mean(name):
        return (segsum(col(name)) / n_f).to(torch.float32)

    frame = col("frame").to(torch.int64)
    first = torch.zeros(n_groups, dtype=torch.int64, device=dev).scatter_reduce(
        0, lg, frame, "amin", include_self=False)
    last = torch.zeros(n_groups, dtype=torch.int64, device=dev).scatter_reduce(
        0, lg, frame, "amax", include_self=False)
    cols = {"frame": first}
    sw = {}
    for c in ("x", "y"):
        if c in names:
            lp = col("lp" + c)
            w = torch.reciprocal(lp * lp)
            sw[c] = segsum(w)
            cols[c] = (segsum(col(c) * w) / sw[c]).to(torch.float32)
    if "photons" in names:
        cols["photons"] = segsum(col("photons")).to(torch.float32)
    for name in ("sx", "sy"):
        if name in names:
            cols[name] = seg_mean(name)
    if "bg" in names:
        cols["bg"] = segsum(col("bg")).to(torch.float32)
    # lp = sqrt(1 / sum w), the root on the host (below)
    for c in ("x", "y"):
        if c in names:
            cols["lp" + c] = sw[c]
    for name in ("ellipticity", "net_gradient", "likelihood",
                 "log_likelihood", "iterations"):
        if name in names:
            cols[name] = seg_mean(name)
    if "z" in names:
        if "lpz" in names:
            lpz = col("lpz")
            wz = torch.reciprocal(lpz * lpz)
            swz = segsum(wz)
            cols["z"] = (segsum(col("z") * wz) / swz).to(torch.float32)
            cols["lpz"] = swz
        else:
            cols["z"] = seg_mean("z")
    if "d_zcalib" in names:
        cols["d_zcalib"] = seg_mean("d_zcalib")
    if "group" in names:
        # a chain never crosses groups: any member's group is the chain's
        g = col("group")
        cols["group"] = torch.zeros(n_groups, dtype=g.dtype,
                                    device=dev).scatter_(0, lg, g)
    cols["len"] = last - first + 1
    cols["n"] = n_
    if "photons" in names:
        cols["photon_rate"] = (cols["photons"].to(torch.float64) / n_f).to(
            torch.float32)
    if remove_ambiguous_lengths:
        valid = (first > 0) & (last < info[0]["Frames"])
        cols = {k: v[valid] for k, v in cols.items()}
    host = {k: v.cpu().numpy() for k, v in cols.items()}
    for k in ("lpx", "lpy", "lpz"):
        if k in host:
            host[k] = np.sqrt(1 / host[k]).astype(np.float32)
    out = np.empty(len(host["frame"]), [(k, v.dtype) for k, v in
                                        host.items()])
    for k, v in host.items():
        out[k] = v
    return out


def dark_times(locs: np.ndarray, group=None, *, device="cuda") -> np.ndarray:
    """Dark time before each event (int32): its frame minus the latest
    earlier last frame (frame + len - 1) of an event of its group, -1
    if there is none (picasso/postprocess.py:1952). One device sort by
    (group, last frame) and a searchsorted."""
    device = lib.resolve_device(device)
    n = len(locs)
    if n == 0:
        return np.zeros(0, np.int32)
    if group is None:
        group = (locs["group"] if "group" in locs.dtype.names
                 else np.zeros(n, np.int64))
    frame = torch.from_numpy(locs["frame"].astype(np.int64)).to(device)
    last = frame + torch.from_numpy(locs["len"].astype(np.int64)).to(
        device) - 1
    g = torch.unique(torch.from_numpy(np.asarray(group).astype(
        np.int64)).to(device), return_inverse=True)[1]
    base = int(torch.minimum(frame.min(), last.min()))
    S = int(torch.maximum(frame.max(), last.max())) - base + 1
    if (int(g.max()) + 1) * S >= 2**62:
        raise ValueError("dark_times: (group, frame) key exceeds 62 bits")
    keys = torch.sort(g * S + (last - base)).values
    query = g * S + (frame - base)
    pos = torch.searchsorted(keys, query, side="left") - 1
    prev = keys[pos.clamp_min(0)]
    has = (pos >= 0) & (torch.div(prev, S, rounding_mode="floor") == g)
    dark = torch.where(has, query - prev, torch.full_like(query, -1))
    return dark.cpu().numpy().astype(np.int32)


def compute_dark_times(locs: np.ndarray, group=None, *, device="cuda"
                       ) -> np.ndarray:
    """The events with their ``dark`` column (int32), those without a
    predecessor dropped (picasso/postprocess.py:1920)."""
    if "len" not in locs.dtype.names:
        raise AttributeError(
            "Length not found. Please link localizations first.")
    dark = dark_times(locs, group, device=device)
    return lib.append_to_rec(locs, dark, "dark")[dark != -1]


# ---------------------------------------------------------------------------
# Group statistics and combined clusters
# ---------------------------------------------------------------------------


def _segments(keys: np.ndarray, device):
    """Rows sorted stably by ``keys`` (a structured or plain array,
    compared as numpy sorts it): (segment id of each row on ``device``,
    the number of segments, the sorted order, the first row of each
    segment in that order)."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    new = np.ones(len(k), bool)
    new[1:] = k[1:] != k[:-1]
    seg = np.cumsum(new) - 1
    return (torch.from_numpy(seg).to(device), int(new.sum()), order,
            np.nonzero(new)[0])


def _seg_moments(values: torch.Tensor, seg: torch.Tensor, n_seg: int):
    """Per segment of the rows of ``values`` (n, C) f64: (sums, counts,
    sample variance with ddof 1, NaN for one row), two passes in f64 on
    the values' device; the callers take the root with numpy."""
    C = values.shape[1]
    sums = torch.zeros((n_seg, C), dtype=torch.float64,
                       device=values.device).index_add_(0, seg, values)
    cnt = torch.bincount(seg, minlength=n_seg).to(torch.float64)
    dev = values - (sums / cnt[:, None])[seg]
    ss = torch.zeros_like(sums).index_add_(0, seg, dev * dev)
    return sums, cnt, ss / (cnt[:, None] - 1)


def groupprops(locs: np.ndarray, callback=None, *, device="cuda"
               ) -> np.ndarray:
    """Mean and std (ddof 1) of every column per group, groups in sorted
    order, plus the qPAINT index 1 / dark_mean (picasso/postprocess.py:
    3580). Events with dark -1 are left out. Segment sums on ``device``
    in f64, cast to f32 (pandas sums an f32 column's mean in f32 with
    Kahan compensation and its std by Welford in f64: the two agree to a
    few f32 ulps, tests/test_torch_stats.py)."""
    device = lib.resolve_device(device)
    if "dark" in locs.dtype.names:
        locs = locs[locs["dark"] != -1]
    seg, n_seg, order, starts = _segments(locs["group"], device)
    srt = locs[order]
    ids = srt["group"][starts]
    others = [n for n in locs.dtype.names if n != "group"]
    values = torch.from_numpy(np.stack(
        [srt[n].astype(np.float64) for n in others], 1)).to(device)
    sums, cnt, var = _seg_moments(values, seg, n_seg)
    mean = (sums / cnt[:, None]).to(torch.float32).cpu().numpy()
    std = np.sqrt(var.cpu().numpy()).astype(np.float32)
    cols = [("group", ids.astype(np.int32)),
            ("n_events", cnt.cpu().numpy().astype(np.int32))]
    for name in locs.dtype.names:
        if name == "group":
            # the key's mean is the id itself and its std 0, as the
            # reference's per-group loop gives
            cols += [("group_mean", ids.astype(np.float32)),
                     ("group_std", np.zeros(n_seg, np.float32))]
            continue
        k = others.index(name)
        cols += [(name + "_mean", mean[:, k]), (name + "_std", std[:, k])]
    if callable(callback):
        callback(n_seg)
    if "dark_mean" in dict(cols):
        cols.append(("qpaint_idx", 1 / dict(cols)["dark_mean"]))
    out = np.empty(n_seg, [(n, v.dtype) for n, v in cols])
    for n, v in cols:
        out[n] = v
    return out


def cluster_combine(locs: np.ndarray, *, device="cuda") -> np.ndarray:
    """Per (group, cluster), in sorted order: the photon-weighted centre
    of mass, the mean and std of the frame, the standard errors of the
    coordinates and the number of locs (picasso/postprocess.py:2174).
    Segment sums on ``device`` in f64; the weighted sums and the photon
    sums are rounded to their columns' dtype before the ratio, as pandas
    forms them."""
    device = lib.resolve_device(device)
    has_z = "z" in locs.dtype.names
    keys = np.empty(len(locs), [("group", locs.dtype["group"]),
                                ("cluster", locs.dtype["cluster"])])
    keys["group"], keys["cluster"] = locs["group"], locs["cluster"]
    seg, n_seg, order, starts = _segments(keys, device)
    srt = locs[order]
    coords = ["x", "y"] + (["z"] if has_z else [])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    w = t(srt["photons"])
    weighted = [t(srt[c]) * w for c in coords]
    values = torch.stack([t(srt["frame"]).to(torch.float64), w.to(
        torch.float64)] + [v.to(torch.float64) for v in weighted] + [
        t(srt[c]).to(torch.float64) for c in coords], 1)
    sums, cnt, var = _seg_moments(values, seg, n_seg)
    std = np.sqrt(var.cpu().numpy())
    n_host = cnt.cpu().numpy()
    nc = len(coords)
    psum = sums[:, 1].to(w.dtype)
    out_cols = [("group", srt["group"][starts]),
                ("cluster", srt["cluster"][starts]),
                ("mean_frame", (sums[:, 0] / cnt).to(torch.float32))]
    for k, c in enumerate(coords):
        out_cols.append((c, (sums[:, 2 + k].to(weighted[k].dtype) / psum).to(
            torch.float32)))
    out_cols.append(("std_frame", std[:, 0].astype(np.float32)))
    for k, c in enumerate(coords):
        # pandas' std of a column keeps its dtype before the division
        s = std[:, 2 + nc + k].astype(srt.dtype[c])
        out_cols.append(("lp" + c[-1], (s / np.sqrt(n_host)).astype(
            np.float32)))
    out_cols.append(("n", cnt.to(torch.int32)))
    host = [(n, v if isinstance(v, np.ndarray) else v.cpu().numpy())
            for n, v in out_cols]
    out = np.empty(n_seg, [(n, v.dtype) for n, v in host])
    for n, v in host:
        out[n] = v
    return out


def cluster_combine_dist(locs: np.ndarray, pixelsize: float | None = None, *,
                         device="cuda") -> np.ndarray:
    """Combined clusters (:func:`cluster_combine`'s output) with the
    distance of each to the nearest other cluster of its group: 2D adds
    ``min_dist``; 3D scales z by the pixel size (130 nm by default) and
    adds ``min_dist`` (xyz) and ``mind_dist_xy`` (the reference's column
    name) (picasso/postprocess.py:2291). The 2-NN runs on ``device`` in
    f64 from the columns, masked to one group, and is rounded to f32
    once; a group with one cluster gets inf."""
    device = lib.resolve_device(device)
    has_z = "z" in locs.dtype.names
    if has_z and pixelsize is None:
        pixelsize = 130
    group = torch.from_numpy(locs["group"].astype(np.int64)).to(device)

    def nn2(cols):
        pts = torch.from_numpy(np.stack(cols, 1)).to(device)
        d2 = neighbors.knn_d2(pts, pts, 2, labels_a=group, labels_b=group)
        return np.sqrt(d2[:, 1].cpu().numpy()).astype(np.float32)

    xy = [locs["x"], locs["y"]]
    out = locs
    if has_z:
        z = locs["z"] / np.asarray(pixelsize).astype(locs["z"].dtype)
        out = lib.append_to_rec(out, nn2(xy + [z]), "min_dist")
        out = lib.append_to_rec(out, nn2(xy), "mind_dist_xy")
    else:
        out = lib.append_to_rec(out, nn2(xy), "min_dist")
    return out


# ---------------------------------------------------------------------------
# RESI
# ---------------------------------------------------------------------------


def resi(locs: list[np.ndarray], infos: list, radius_xy, radius_z=None,
         min_locs=10, apply_fa: bool = True,
         save_clustered_locs: bool = False,
         save_cluster_centers: bool = False, resi_path: str | None = None,
         output_paths: list[str] | None = None,
         suffix_locs: str = "_clustered",
         suffix_centers: str = "_cluster_centers", progress_callback=None,
         *, device="cuda") -> tuple[np.ndarray, list[dict]]:
    """RESI (picasso/postprocess.py:3742): each channel SMLM-clustered
    (clusterer.cluster with frame analysis ``apply_fa``) on ``device``,
    its cluster centers tagged with ``resi_channel_id`` (int8), the
    channels concatenated as pd.concat does (lib.merge_locs) and
    ``group`` renamed ``cluster_id``. ``radius_xy``, ``radius_z`` and
    ``min_locs`` are one value or one per channel."""
    import os

    from picasso_torch import __version__, clusterer, io

    n_channels = len(locs)
    if n_channels < 2:
        raise ValueError(
            f"RESI requires at least 2 channels, but got {n_channels}."
            " Consider using SMLM Clusterer for single-channel"
            " clustering.")

    def as_list(v, name):
        if isinstance(v, (int, float)):
            return [v] * n_channels
        if len(v) != n_channels:
            raise ValueError(f"{name} list length ({len(v)}) must match "
                             f"number of channels ({n_channels})")
        return list(v)

    radius_xy = as_list(radius_xy, "radius_xy")
    min_locs = as_list(min_locs, "min_locs")
    if radius_z is not None:
        radius_z = as_list(radius_z, "radius_z")
    centers_all, channel_params = [], []
    for c in range(n_channels):
        if callable(progress_callback):
            progress_callback(c)
        elif progress_callback == "console":
            print(f"RESI: clustering channel {c + 1}/{n_channels}")
        pixelsize = lib.get_from_metadata(infos[c], "Pixelsize", default=130)
        rz = radius_z[c] if radius_z is not None else None
        clustered = clusterer.cluster(
            locs[c], radius_xy=radius_xy[c], min_locs=min_locs[c],
            frame_analysis=apply_fa, radius_z=rz, pixelsize=pixelsize,
            device=device)
        centers = clusterer.find_cluster_centers(clustered, pixelsize,
                                                 device=device)
        base = (os.path.splitext(output_paths[c])[0] if output_paths
                else None)
        if save_clustered_locs and base:
            io.save_locs(base + suffix_locs + ".hdf5", clustered, infos[c])
        if save_cluster_centers and base:
            io.save_locs(base + suffix_centers + ".hdf5", centers, infos[c])
        centers_all.append(_with_fields(centers, [(
            "resi_channel_id", np.full(len(centers), c, np.int8))]))
        channel_params.append({
            "Channel": c,
            "Radius xy (px)": radius_xy[c],
            "Radius z (px)": radius_z[c] if radius_z is not None else None,
            "Min locs": min_locs[c],
        })
    resi_centers = lib.merge_locs(centers_all)
    resi_centers = resi_centers.view([
        ("cluster_id" if n == "group" else n, resi_centers.dtype[n])
        for n in resi_centers.dtype.names])
    resi_info = list(infos[0]) + [{
        "Generated by": f"Picasso v{__version__} RESI",
        "Channels": channel_params,
    }]
    if resi_path is not None:
        io.save_locs(resi_path, resi_centers, resi_info)
    return resi_centers, resi_info


# ---------------------------------------------------------------------------
# Pick analyses: similar picks, removal and combination, qPAINT kinetics
# ---------------------------------------------------------------------------

#: pick_similar's walk ends once a move is at most this in x and in y
#: (px), or after this many steps (picasso/postprocess.py:267-279)
SIMILAR_TOL = 1e-3
SIMILAR_MAX_STEPS = 500


class _Balls:
    """The locs in cells for pick_similar's balls of radius ``r``: their
    f64 coordinates in the cells' order."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, r: float):
        self.cells = neighbors.grid(x, y, r)
        self.x, self.y = x[self.cells.order], y[self.cells.order]
        self.r = r

    def pairs(self, qx: torch.Tensor, qy: torch.Tensor):
        return neighbors.ball_pairs(self.cells, self.x, self.y, qx, qy,
                                    self.r)


def _ball_stats(balls: _Balls, qx: torch.Tensor, qy: torch.Tensor):
    """For each f64 centre (qx, qy): the locs within the radius, the f64
    sums of their x and y, and the least | d - r | of any candidate loc
    (how near a loc lies to the ball's edge)."""
    K, dev = len(qx), qx.device
    n = torch.zeros(K, dtype=torch.int64, device=dev)
    sx = torch.zeros(K, dtype=torch.float64, device=dev)
    sy = torch.zeros(K, dtype=torch.float64, device=dev)
    edge = torch.full((K,), np.inf, dtype=torch.float64, device=dev)
    for q, pos, d2, ok in balls.pairs(qx, qy):
        edge.scatter_reduce_(0, q, (d2.sqrt() - balls.r).abs(), "amin")
        q, pos = q[ok], pos[ok]
        n.index_add_(0, q, torch.ones_like(q))
        sx.index_add_(0, q, balls.x[pos])
        sy.index_add_(0, q, balls.y[pos])
    return n, sx, sy, edge


def _ball_rmsd(balls: _Balls, qx: torch.Tensor, qy: torch.Tensor,
               n: torch.Tensor, mx: torch.Tensor,
               my: torch.Tensor) -> torch.Tensor:
    """The f32 rmsd of the locs within the radius of each centre about
    their f32 means (mx, my), as JAX's numpy forms it: dx, dy, dx^2 +
    dy^2 in f32, their mean (here an f64 sum over the count) and the
    root in f32."""
    ss = torch.zeros(len(qx), dtype=torch.float64, device=qx.device)
    for q, pos, _, ok in balls.pairs(qx, qy):
        q, pos = q[ok], pos[ok]
        dx = balls.x[pos].to(torch.float32) - mx[q]
        dy = balls.y[pos].to(torch.float32) - my[q]
        ss.index_add_(0, q, (dx * dx + dy * dy).to(torch.float64))
    return torch.sqrt((ss / n.clamp_min(1)).to(torch.float32))


def _similar_walks(x: np.ndarray, y: np.ndarray, cand: np.ndarray, r: float,
                   n_start: float, dev) -> dict:
    """pick_similar's walks of every hex-grid candidate at once on
    ``dev``: a candidate with at least ``n_start`` locs within ``r``
    starts at their mean, and each step moves every walking centre to the
    mean of the locs within ``r`` of it, until both moves are at most
    SIMILAR_TOL, after SIMILAR_MAX_STEPS steps, or at one loc left
    (picasso/postprocess.py:260-279). Returns numpy arrays over the
    candidates: ``started``, the final ``com`` (K, 2) f32, the locs ``n``
    within ``r`` of it and their ``rmsd`` (f32), ``steps``, and the near
    ties: ``edge``, the least | d - r | of a loc over the walk's balls,
    and ``move``, the least | move - SIMILAR_TOL | of a test."""
    balls = _Balls(torch.from_numpy(x.astype(np.float64)).to(dev),
                   torch.from_numpy(y.astype(np.float64)).to(dev), r)
    cx = torch.from_numpy(np.ascontiguousarray(cand[:, 0])).to(dev)
    cy = torch.from_numpy(np.ascontiguousarray(cand[:, 1])).to(dev)
    K = len(cand)
    n0, sx, sy, _ = _ball_stats(balls, cx, cy)
    started = n0 >= n_start
    s = torch.nonzero(started).flatten()
    f32 = torch.float32
    com_x = (sx[s] / n0[s]).to(f32)
    com_y = (sy[s] / n0[s]).to(f32)
    # JAX compares the f32 mean with the grid point as an f32 number
    prev_x, prev_y = cx[s].to(f32), cy[s].to(f32)
    tol = torch.tensor(SIMILAR_TOL, dtype=f32, device=dev)
    steps = torch.zeros(len(s), dtype=torch.int64, device=dev)
    edge = torch.full((len(s),), np.inf, dtype=torch.float64, device=dev)
    move = torch.full((len(s),), np.inf, dtype=torch.float64, device=dev)
    active = torch.ones(len(s), dtype=torch.bool, device=dev)
    while True:
        a = torch.nonzero(active).flatten()
        if len(a) == 0:
            break
        dx = (com_x[a] - prev_x[a]).abs()
        dy = (com_y[a] - prev_y[a]).abs()
        gap = torch.minimum((dx - tol).abs(), (dy - tol).abs())
        move[a] = torch.minimum(move[a], gap.to(torch.float64))
        go = (dx > tol) | (dy > tol)
        steps[a[go]] += 1
        a = a[go & (steps[a] <= SIMILAR_MAX_STEPS)]
        active.zero_()
        active[a] = True
        if len(a) == 0:
            break
        prev_x[a], prev_y[a] = com_x[a], com_y[a]
        n, sx, sy, e = _ball_stats(balls, com_x[a].to(torch.float64),
                                   com_y[a].to(torch.float64))
        edge[a] = torch.minimum(edge[a], e)
        moved = n > 1
        active[a[~moved]] = False
        a, n = a[moved], n[moved]
        com_x[a] = (sx[moved] / n).to(f32)
        com_y[a] = (sy[moved] / n).to(f32)
    qx, qy = com_x.to(torch.float64), com_y.to(torch.float64)
    n, sx, sy, e = _ball_stats(balls, qx, qy)
    edge = torch.minimum(edge, e)
    rmsd = _ball_rmsd(balls, qx, qy, n, (sx / n.clamp_min(1)).to(f32),
                      (sy / n.clamp_min(1)).to(f32))
    out = {"started": started.cpu().numpy(),
           "com": np.full((K, 2), np.nan, np.float32),
           "n": np.zeros(K, np.int64),
           "rmsd": np.full(K, np.nan, np.float32),
           "steps": np.zeros(K, np.int64),
           "edge": np.full(K, np.inf), "move": np.full(K, np.inf)}
    s = s.cpu().numpy()
    out["com"][s] = torch.stack([com_x, com_y], 1).cpu().numpy()
    for key, v in (("n", n), ("rmsd", rmsd), ("steps", steps),
                   ("edge", edge), ("move", move)):
        out[key][s] = v.cpu().numpy()
    return out


def pick_similar(locs: np.ndarray, info: list[dict], picks: list, d: float,
                 std_range: float = 2.0, index_blocks=None, *, device="cuda",
                 record: dict | None = None) -> list:
    """Circular picks of diameter ``d`` over the field of view whose loc
    count and rmsd lie within ``std_range`` standard deviations of those
    of the given ``picks`` (picasso/postprocess.py:212). The picks'
    statistics are taken on the host as JAX takes them (cKDTree, a loc
    at distance <= d / 2 counts, f32 means); the walks of every candidate
    of the hex grid to its local centre of mass run at once on ``device``
    (:func:`_similar_walks`); then, in JAX's candidate order on the host,
    the test of the final count and rmsd and the suppression of a pick
    closer than ``d`` to one accepted before it. Returns [(x, y)] f32.
    The device's sums round the centres in another order than numpy's, so
    a centre may differ from JAX's by a few f32 ulps, and a pick at a
    near tie may differ (tests/torch_parity.compare_similar_picks).
    ``index_blocks`` is accepted and ignored, as in JAX. ``record``, if
    given, receives every candidate's walk (:func:`_similar_walks`),
    ``dup_d2`` (the squared distance to the nearest pick accepted before
    it), ``dup_of``, ``accepted``, the ``bounds`` and the ``walls`` (s)
    of the seeds' statistics, the walks and the host filter."""
    import time

    from scipy.spatial import cKDTree

    device = lib.resolve_device(device)
    t0 = time.perf_counter()
    r = d / 2
    d2 = d**2
    x, y = locs["x"], locs["y"]
    tree = cKDTree(np.column_stack([x, y]))
    n_locs_list, rmsd_list = [], []
    for px, py in picks:
        idx = tree.query_ball_point([px, py], r)
        n_locs_list.append(len(idx))
        if len(idx) > 1:
            dx = x[idx] - np.mean(x[idx])
            dy = y[idx] - np.mean(y[idx])
            rmsd_list.append(np.sqrt(np.mean(dx**2 + dy**2)))
        else:
            rmsd_list.append(0.0)
    mean_n, std_n = np.mean(n_locs_list), np.std(n_locs_list)
    mean_rmsd, std_rmsd = np.mean(rmsd_list), np.std(rmsd_list)
    min_n = mean_n - std_range * std_n
    max_n = mean_n + std_range * std_n
    min_rmsd = mean_rmsd - std_range * std_rmsd
    max_rmsd = mean_rmsd + std_range * std_rmsd
    width, height = info[0]["Width"], info[0]["Height"]
    gx = np.arange(r, width, d * np.sqrt(3) / 2)
    cand = [(cx, cy) for i, cx in enumerate(gx)
            for cy in np.arange(r + (i % 2) * r, height, d)]
    cand = np.array(cand, np.float64).reshape(-1, 2)
    t1 = time.perf_counter()
    walks = _similar_walks(x, y, cand, r, max(2, min_n), device)
    t2 = time.perf_counter()
    K = len(cand)
    dup_d2 = np.full(K, np.inf, np.float32)
    dup_of = np.full(K, -1, np.int64)
    accepted = np.zeros(K, bool)
    out_x, out_y, out_k = [], [], []
    for k in np.nonzero(walks["started"])[0]:
        n, rmsd = walks["n"][k], walks["rmsd"][k]
        if not (min_n <= n <= max_n) or n < 2:
            continue
        if not (min_rmsd <= rmsd <= max_rmsd):
            continue
        comx, comy = walks["com"][k]
        if out_x:
            dist2 = ((comx - np.array(out_x, np.float32)) ** 2
                     + (comy - np.array(out_y, np.float32)) ** 2)
            j = int(np.argmin(dist2))
            dup_d2[k], dup_of[k] = dist2[j], out_k[j]
            if np.any(dist2 < d2):
                dup_of[k] = out_k[int(np.argmax(dist2 < d2))]
                continue
        accepted[k] = True
        out_x.append(comx)
        out_y.append(comy)
        out_k.append(k)
    if record is not None:
        record.update(walks)
        record.update(candidates=cand, dup_d2=dup_d2, dup_of=dup_of,
                      accepted=accepted, radius=r, d=d,
                      bounds=(min_n, max_n, min_rmsd, max_rmsd),
                      walls={"seeds": t1 - t0, "walks": t2 - t1,
                             "filter": time.perf_counter() - t2})
    return list(zip(out_x, out_y))


def rmsd_at_com(locs_xy: np.ndarray) -> float:
    """The rmsd of the locs (2, n) about their centre of mass, in their
    dtype, as a Python float (picasso/postprocess.py:948)."""
    com_x = np.mean(locs_xy[0])
    com_y = np.mean(locs_xy[1])
    return float(np.sqrt(np.mean((locs_xy[0] - com_x) ** 2
                                 + (locs_xy[1] - com_y) ** 2)))


def _check_pick_shape(pick_shape: str, pick_size, needs_size) -> None:
    if pick_shape not in PICK_SHAPES:
        raise ValueError(f"Invalid pick shape: {pick_shape}")
    if pick_shape in needs_size and not isinstance(pick_size, (int, float)):
        raise ValueError(f"a {pick_shape} pick needs a pick_size")


def _picked_rows(locs: np.ndarray, info: list[dict], picks: list,
                 pick_shape: str, pick_size, index_blocks=None) -> np.ndarray:
    """The positions in ``locs`` of the locs that :func:`picked_locs`
    finds in any pick, ascending. Circles (radius ``pick_size``) search
    the blocks of ``index_blocks``' size, built anew from ``locs`` so that
    each row keeps its position (the rows of equal blocks sort alike)."""
    rows = None
    if pick_shape == "Circle":
        size = pick_size if index_blocks is None else index_blocks[1]
        index_blocks, rows = _index_blocks(locs, info, size)
        locs = index_blocks[0]
    found = [idx for _, idx in _pick_rows(locs["x"], locs["y"], picks,
                                          pick_shape, pick_size, index_blocks)
             if idx is not None]
    found = np.concatenate([np.zeros(0, np.int64)] + found)
    return np.unique(found if rows is None else rows[found])


def remove_locs_in_picks(locs: np.ndarray, info: list[dict], *, picks: list,
                         pick_shape: str, pick_size: float | None = None,
                         index_blocks=None) -> np.ndarray:
    """The locs outside every pick, in their order (picasso/
    postprocess.py:315); ``pick_size`` is a circle's diameter. JAX drops
    the picked rows by their index labels, which a circle's pick carries
    through the sanity filter and the block sort: here the picks' rows
    are found by their positions (:func:`_picked_rows`), on the host."""
    _check_pick_shape(pick_shape, pick_size, ("Circle", "Rectangle",
                                              "Square"))
    if pick_shape == "Circle":
        pick_size = pick_size / 2
    else:
        index_blocks = None
    keep = np.ones(len(locs), bool)
    keep[_picked_rows(locs, info, picks, pick_shape, pick_size,
                      index_blocks)] = False
    return locs[keep]


def _by_pick(events: np.ndarray) -> np.ndarray:
    """Events of one link call over all picks (``group`` the pick) in the
    order of one call a pick: stably by pick, so each pick's events keep
    their order of first frame as its own call gives it."""
    return events[np.argsort(events["group"], kind="stable")]


def combine_locs_in_picks(locs: np.ndarray, info: list[dict], *,
                          picks: list, pick_shape: str,
                          pick_size: float | None = None,
                          index_blocks=None, progress_callback=None,
                          device="cuda") -> np.ndarray:
    """All locs of each pick linked into events with r_max 1e9 and a
    dark time of 10**9 frames, ambiguous lengths kept, ``group`` the pick
    (picasso/postprocess.py:344). JAX links one pick at a time; here all
    picks go to one ``link`` call on ``device`` with ``group`` the pick,
    since link never joins locs of two groups."""
    device = lib.resolve_device(device)
    _check_pick_shape(pick_shape, pick_size, ("Circle", "Rectangle",
                                              "Square"))
    size = pick_size / 2 if pick_shape == "Circle" else pick_size
    picked = [p for p in picked_locs(
        locs, info, picks, pick_shape, size, add_group=True,
        index_blocks=index_blocks, callback=progress_callback) if len(p)]
    if not picked:
        return locs[:0].copy()
    linked = link(np.concatenate(picked), info, r_max=1e9,
                  max_dark_time=10**9, remove_ambiguous_lengths=False,
                  device=device)
    return _by_pick(linked)


def _pick_events(picked: list[np.ndarray], info: list[dict],
                 max_dark_time: int, device):
    """The events of every pick with their dark times, as JAX's loop over
    the picks gives them one pick after another (link with r_max 999999
    where a pick has no ``len``, then compute_dark_times), and the index
    of each event's pick. All picks are linked in one call on ``device``
    and their dark times taken in one, keyed by (pick, group): neither
    joins two keys. The picks are tables of one dtype."""
    ks = [k for k, p in enumerate(picked) if len(p)]
    if not ks:
        return None, np.zeros(0, np.int64)
    cat = np.concatenate([picked[k] for k in ks])
    pick = np.repeat(np.array(ks, np.int64), [len(picked[k]) for k in ks])
    names = cat.dtype.names
    pairs = np.zeros(len(cat), [("pick", np.int64), ("group", np.int64)])
    pairs["pick"] = pick
    if "group" in names:
        pairs["group"] = cat["group"]
    keys, key = np.unique(pairs, return_inverse=True)
    events = lib.append_to_rec(cat, key.ravel().astype(np.int64), "group")
    if "len" not in names:
        events = link(events, info, r_max=999999,
                      max_dark_time=max_dark_time, device=device)
    key = events["group"]
    events = events[np.argsort(keys["pick"][key], kind="stable")]
    key = events["group"]
    dark = dark_times(events, key, device=device)
    if "group" in names:
        events = lib.append_to_rec(
            events, keys["group"][key].astype(cat.dtype["group"]), "group")
    else:
        events = lib.drop_fields(events, ["group"])
    keep = dark != -1
    events = lib.append_to_rec(events, dark, "dark")[keep]
    return events, keys["pick"][key][keep]


def _pick_spans(pick: np.ndarray):
    """(pick index, slice) of each run of one pick in ``pick`` (sorted)."""
    ids, starts = np.unique(pick, return_index=True)
    stops = np.append(starts[1:], len(pick))
    return [(int(k), slice(a, b)) for k, a, b in zip(ids, starts, stops)]


def _no_columns() -> np.ndarray:
    """An empty table without columns (JAX's empty pd.DataFrame())."""
    return np.zeros(0, np.dtype([]))


def pick_kinetics(picked_locs_list: list[np.ndarray], info: list[dict], *,
                  max_dark_time: int = 3, progress_callback=None,
                  device="cuda"):
    """Bright and dark times of each pick by the cumulative-exponential
    fit (picasso/postprocess.py:451): (length, dark, no_locs, out_locs),
    one entry a pick that has events with a dark time and whose fits do
    not raise RuntimeError, as JAX skips the others. The picks are
    linked and their dark times taken on ``device`` in one call each
    (:func:`_pick_events`); the fits run a pick at a time on the host
    with scipy."""
    device = lib.resolve_device(device)
    events, pick = _pick_events(picked_locs_list, info, max_dark_time,
                                device)
    length, dark, no_locs, out = [], [], [], []
    with lib.progress_reporter(progress_callback, len(picked_locs_list),
                               "Calculating kinetics") as rep:
        for k, rows in _pick_spans(pick):
            rep.set_value(k + 1)
            ev = events[rows]
            try:
                l_ = lib.estimate_kinetic_rate(ev["len"])
                d_ = lib.estimate_kinetic_rate(ev["dark"])
            except RuntimeError:
                continue
            length.append(l_)
            dark.append(d_)
            no_locs.append(len(ev))
            out.append(ev)
    out_locs = np.concatenate(out) if out else _no_columns()
    return np.array(length), np.array(dark), np.array(no_locs), out_locs


def evaluate_picks(picked_locs_list: list[np.ndarray], info: list[dict], *,
                   max_dark_time: int = 3, progress_callback=None,
                   device="cuda"):
    """Per pick: the number of locs N, of events with a dark time, the
    rmsd (times Pixelsize) and rmsd_z of the locs, and the bright and dark
    times by the cumulative-exponential fit, NaN where a pick has none
    (picasso/postprocess.py:381). Returns (N, n_events, rmsd, rmsd_z,
    length, dark, events). Linking and the dark times run on ``device``
    in one call each (:func:`_pick_events`); the fits on the host."""
    import warnings

    device = lib.resolve_device(device)
    pixelsize = lib.get_from_metadata(info, "Pixelsize", default=1.0)
    n_picks = len(picked_locs_list)
    N, n_events, rmsd, rmsd_z, length, dark = (np.full(n_picks, np.nan)
                                               for _ in range(6))
    has_z = bool(n_picks) and "z" in picked_locs_list[0].dtype.names
    events, pick = _pick_events(picked_locs_list, info, max_dark_time,
                                device)
    spans = dict(_pick_spans(pick))
    new_locs = []
    with warnings.catch_warnings(), lib.progress_reporter(
            progress_callback, n_picks, "Evaluating picks") as rep:
        warnings.simplefilter("ignore", category=RuntimeWarning)
        for i, pick_locs in enumerate(picked_locs_list):
            rep.set_value(i + 1)
            if not len(pick_locs):
                continue
            N[i] = len(pick_locs)
            rmsd[i] = rmsd_at_com(np.stack([pick_locs["x"],
                                            pick_locs["y"]])) * pixelsize
            if has_z:
                z = pick_locs["z"]
                rmsd_z[i] = np.sqrt(np.mean((z - z.mean()) ** 2))
            if i not in spans:
                continue
            ev = events[spans[i]]
            n_events[i] = len(ev)
            length[i] = lib.estimate_kinetic_rate(ev["len"])
            dark[i] = lib.estimate_kinetic_rate(ev["dark"])
            new_locs.append(ev)
    new_locs = np.concatenate(new_locs) if new_locs else _no_columns()
    return N, n_events, rmsd, rmsd_z, length, dark, new_locs


def pick_properties(picked_locs_list: list[np.ndarray], info: list[dict], *,
                    max_dark_time: int = 3, influx_rate: float = 0.03,
                    pick_areas=None, kinetics_progress=None,
                    groupprops_progress=None, device="cuda") -> np.ndarray:
    """Per pick: groupprops of its events (:func:`pick_kinetics`), then
    ``pick_area_um2`` (``pick_areas`` as given, when given), the qPAINT
    number of binding sites ``n_units`` = 1 / (influx_rate * dark), the
    events ``locs``, ``length_cdf``, ``dark_cdf`` and ``qpaint_idx_cdf``
    = 1 / dark (picasso/postprocess.py:503), on ``device``."""
    import warnings

    device = lib.resolve_device(device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        length, dark, no_locs, out_locs = pick_kinetics(
            picked_locs_list, info, max_dark_time=max_dark_time,
            progress_callback=kinetics_progress, device=device)
        props = groupprops(out_locs, callback=groupprops_progress,
                           device=device)
        cols = []
        if pick_areas is not None:
            cols.append(("pick_area_um2", pick_areas))
        cols += [("n_units", 1 / (influx_rate * dark)), ("locs", no_locs),
                 ("length_cdf", length), ("dark_cdf", dark),
                 ("qpaint_idx_cdf", dark**-1.0)]
    for name, values in cols:
        values = np.asarray(values)
        if values.ndim and len(values) != len(props):
            raise ValueError(f"Length of values ({len(values)}) does not "
                             f"match length of index ({len(props)})")
        props = lib.append_to_rec(props, np.broadcast_to(values, len(props)),
                                  name)
    return props


# ---------------------------------------------------------------------------
# FRET
# ---------------------------------------------------------------------------


def calculate_fret(acc_locs: np.ndarray, don_locs: np.ndarray):
    """The FRET efficiency trace of one pick from its acceptor and donor
    locs (picasso/postprocess.py:1617), on the host: each channel's trace
    photons - bg a frame (where a frame repeats, its last loc), the
    efficiency acc / (acc + don) kept where it lies in (0, 1). Returns
    (fret_dict, f_locs): f_locs the donor locs of those frames with the
    field ``fret``, or an empty list when there are none."""
    if len(acc_locs) == 0:
        max_frames = don_locs["frame"].max()
    elif len(don_locs) == 0:
        max_frames = acc_locs["frame"].max()
    else:
        max_frames = max(acc_locs["frame"].max(), don_locs["frame"].max())
    xvec = np.arange(max_frames + 1)
    acc_trace = np.zeros(len(xvec))
    don_trace = np.zeros(len(xvec))
    acc_trace[acc_locs["frame"]] = acc_locs["photons"] - acc_locs["bg"]
    don_trace[don_locs["frame"]] = don_locs["photons"] - don_locs["bg"]
    with np.errstate(divide="ignore", invalid="ignore"):
        fret_trace = acc_trace / (acc_trace + don_trace)
    selector = (fret_trace > 0) & (fret_trace < 1)
    fret_events = fret_trace[selector]
    fret_timepoints = np.arange(len(fret_trace))[selector]
    f_locs = []
    if len(fret_timepoints) > 0:
        f_locs = np.concatenate([don_locs[don_locs["frame"] == t]
                                 for t in fret_timepoints])
        if len(f_locs) != len(fret_events):
            raise ValueError(
                f"Length of values ({len(fret_events)}) does not match "
                f"length of index ({len(f_locs)})")
        f_locs = _with_fields(f_locs, [("fret", np.array(fret_events))])
    fret_dict = {"fret_events": np.array(fret_events),
                 "fret_timepoints": fret_timepoints, "acc_trace": acc_trace,
                 "don_trace": don_trace, "frames": xvec,
                 "maxframes": max_frames}
    return fret_dict, f_locs


# ---------------------------------------------------------------------------
# Plots (matplotlib imported inside)
# ---------------------------------------------------------------------------


def plot_drift(drift: np.ndarray, pixelsize: float = 1.0, fig=None):
    """The drift trajectory against the frame, and y against x
    (picasso/postprocess.py:1465)."""
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.figure(figsize=(8, 4))
    ax = fig.add_subplot(121)
    frames = np.arange(len(drift))
    ax.plot(frames, drift["x"] * pixelsize, label="x")
    ax.plot(frames, drift["y"] * pixelsize, label="y")
    if "z" in drift.dtype.names:
        ax.plot(frames, drift["z"], label="z")
    ax.set_xlabel("frame")
    ax.set_ylabel("drift (nm)" if pixelsize != 1 else "drift (px)")
    ax.legend()
    ax2 = fig.add_subplot(122)
    ax2.plot(drift["x"] * pixelsize, drift["y"] * pixelsize, lw=0.5)
    ax2.set_xlabel("x")
    ax2.set_ylabel("y")
    ax2.set_aspect("equal")
    return fig


def plot_nena(nena_result: dict, fig=None):
    """The NeNA histogram and its fit (picasso/postprocess.py:1489)."""
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.figure()
    ax = fig.add_subplot(111)
    ax.semilogx(nena_result["d"], nena_result["data"], label="data")
    ax.semilogx(nena_result["d"], nena_result["best_fit"], label="fit")
    s = nena_result["best_values"]["s"]
    ax.set_title(f"NeNA precision: {s:.4f} px")
    ax.set_xlabel("distance (px)")
    ax.set_ylabel("counts")
    ax.legend()
    return fig


def plot_frc(frc_result: dict, fig=None):
    """The FRC curve, its smoothed form, the 1/7 threshold and the
    resolution (picasso/postprocess.py:1511)."""
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.figure()
    ax = fig.add_subplot(111)
    q = frc_result["frequencies"]
    ax.plot(q, frc_result["frc_curve"], color="gray", alpha=0.5,
            label="FRC curve")
    ax.plot(q, frc_result["frc_curve_smooth"], label="Smoothed")
    ax.axhline(1 / 7, color="black", linewidth=1.0, linestyle="--",
               label="1/7 threshold")
    res = frc_result["resolution"]
    ax.set_xlabel("Spatial frequency (nm^-1)")
    ax.set_ylabel("FRC")
    if res is not None:
        ax.set_title(f"FIRE resolution: {res:.2f} nm")
    ax.legend()
    return fig


# ---------------------------------------------------------------------------
# Deprecated public aliases of the reference (picasso/postprocess.py:97/
# 802/890/932/1165/2422/2664), as JAX keeps them
# ---------------------------------------------------------------------------


def index_blocks_shape(info: list[dict], size: float) -> tuple[int, int]:
    """Deprecated: the (rows, columns) of the block index
    (picasso/postprocess.py:97)."""
    lib.deprecation_warning(
        "Deprecation warning: This function will become private in "
        "v0.11.0. Use _index_blocks_shape instead.")
    return _index_blocks_shape(info, size)


def n_block_locs_at(x_range: int, y_range: int, K: int, L: int,
                    block_starts: np.ndarray, block_ends: np.ndarray) -> int:
    """Deprecated: the locs in the 3 x 3 blocks around block (y_range,
    x_range), uint32 (picasso/postprocess.py:802). Block row and column 0
    are left out, as the reference leaves them out here."""
    lib.deprecation_warning(
        "Deprecation warning: This function will become private in "
        "v0.11.0. Use the block index returned by get_index_blocks.")
    total = np.uint32(0)
    for k in range(y_range - 1, y_range + 2):
        if 0 < k < K:
            for m in range(x_range - 1, x_range + 2):
                if 0 < m < L:
                    total += np.uint32(block_ends[k][m] - block_starts[k][m])
    return total


def get_block_locs_at_numba(x_index: int, y_index: int, locs_xy: np.ndarray,
                            block_starts: np.ndarray, block_ends: np.ndarray,
                            K: int, L: int) -> np.ndarray:
    """Deprecated: the columns of ``locs_xy`` (2, N), sorted by block, in
    the 3 x 3 blocks around block (y_index, x_index)
    (picasso/postprocess.py:890)."""
    chunks = [np.arange(block_starts[k, m], block_ends[k, m], dtype=np.uint32)
              for k in range(y_index - 1, y_index + 2) if 0 <= k < K
              for m in range(x_index - 1, x_index + 2)
              if 0 <= m < L and block_ends[k, m] > block_starts[k, m]]
    idx = np.concatenate(chunks) if chunks else np.empty(0, np.uint32)
    return locs_xy[:, idx]


def locs_at_numba(x: float, y: float, locs_xy: np.ndarray, r: float
                  ) -> np.ndarray:
    """Deprecated: the columns of ``locs_xy`` within ``r`` of (x, y)
    (picasso/postprocess.py:932)."""
    dx = locs_xy[0] - x
    dy = locs_xy[1] - y
    return locs_xy[:, dx**2 + dy**2 < r**2]


def next_frame_neighbor_distance_histogram(locs: np.ndarray, callback=None,
                                           *, device="cuda"):
    """Deprecated alias of :func:`_next_frame_neighbor_distance_histogram`
    (picasso/postprocess.py:1165)."""
    lib.deprecation_warning(
        "Deprecation warning: This function will become private in "
        "v0.11.0. Use _next_frame_neighbor_distance_histogram instead.")
    return _next_frame_neighbor_distance_histogram(locs, callback,
                                                   device=device)


def get_link_groups(frame: np.ndarray, x: np.ndarray, y: np.ndarray,
                    d_max: float, max_dark_time: int, group: np.ndarray, *,
                    device="cuda") -> np.ndarray:
    """Deprecated: the chain ids of locs sorted by frame, as
    :func:`link_groups` (picasso/postprocess.py:2422)."""
    lib.deprecation_warning(
        "Deprecation warning: This function will become private in "
        "v0.11.0. Use _get_link_groups instead.")
    return link_groups(frame, x, y, group, d_max, max_dark_time,
                       device=device)


def link_loc_groups(locs: np.ndarray, info: list[dict],
                    link_group: np.ndarray,
                    remove_ambiguous_lengths: bool = True, *,
                    device="cuda") -> np.ndarray:
    """Deprecated: the events of chain ids ``link_group`` of locs sorted
    by frame (picasso/postprocess.py:2664), aggregated on ``device``."""
    lib.deprecation_warning(
        "Deprecation warning: This function will become private in "
        "v0.11.0. Use _link_loc_groups instead.")
    device = lib.resolve_device(device)
    return _link_loc_groups(
        locs, info, torch.from_numpy(np.asarray(link_group)).to(device),
        remove_ambiguous_lengths)
