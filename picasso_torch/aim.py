"""AIM drift correction (Adaptive Intersection Maximization; Ma et al.,
Science Advances 2024) on a torch device.

Counterpart of picasso_tpu/aim.py (_count_intersections_all_shifts :25,
_grid_counts :54, _grid_stride :58, _point_intersect_2d :74,
_point_intersect_3d :93, _get_fft_peak :111, _get_fft_peak_z :131,
intersection_max :143, intersection_max_z :215, aim :279 and the public
aliases :367-404). Locs are quantized to cells of ``intersect_d`` and
keyed as int64 (x + y * stride_w (+ z * stride_w * stride_h)); on the
device each segment's cells are counted (torch.unique) and every shift
of the search region is matched against the reference cells at once
(torch.searchsorted), the shift axis in chunks that bound the (cells,
shifts) temporaries as JAX's do. The coordinates are quantized in the
dtype they carry (f64 in the shifted segments, f32 in the first round's
reference, as JAX reads them), dividing by a tensor: a CUDA division by
a Python number would multiply by its reciprocal. The counts are
integers, so the count maps equal JAX's exactly. The 7x7 phase peak, the
relative drift's sum and the splines run on the host in numpy, as in
JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import InterpolatedUnivariateSpline

from picasso_torch import __version__, lib

# cells x shifts per chunk of the shift axis (picasso_tpu/aim.py:39)
_CHUNK_ELEMENTS = 8e6


def _tensor(a, device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    a = np.ascontiguousarray(a)
    if dtype is None and a.dtype.kind == "u":
        dtype = torch.int64
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _count_intersections_all_shifts(l0_coords, l0_counts, l1_coords,
                                    l1_counts, shifts) -> torch.Tensor:
    """For every shift, the sum of min(reference count, target count)
    over the cells the reference and the shifted target share, all
    shifts at once on the tensors' device; int64 (n_shifts,)."""
    n_shifts = len(shifts)
    out = torch.empty(n_shifts, dtype=torch.int64, device=shifts.device)
    chunk = max(1, int(_CHUNK_ELEMENTS / max(len(l1_coords), 1)))
    last = len(l0_coords) - 1
    for s0 in range(0, n_shifts, chunk):
        block = shifts[s0:s0 + chunk]
        shifted = l1_coords[:, None] + block[None, :]
        pos = torch.searchsorted(l0_coords, shifted).clamp(max=last)
        hit = l0_coords[pos] == shifted
        mins = torch.minimum(l0_counts[pos], l1_counts[:, None])
        out[s0:s0 + len(block)] = torch.where(hit, mins, 0).sum(dim=0)
    return out


def _grid_counts(keys: torch.Tensor):
    return torch.unique(keys, return_counts=True)


def _grid_stride(units: float) -> int:
    """Integer row stride of the cell keys: the rounded width in cells
    where it is an integer, else its ceiling + 1, so that keys and shift
    offsets stay consistent (picasso_tpu/aim.py:58)."""
    r = round(units)
    if abs(units - r) < 1e-6:
        return int(r)
    return int(np.ceil(units)) + 1


def _units(v: torch.Tensor, intersect_d: float) -> torch.Tensor:
    """round(v / intersect_d) as int64, in ``v``'s dtype, half to even
    (np.round)."""
    d = torch.tensor(intersect_d, dtype=v.dtype, device=v.device)
    return torch.round(v / d).to(torch.int64)


def _point_intersect_2d(l0_coords, l0_counts, x1, y1, intersect_d,
                        width_units, shifts_xy, box) -> torch.Tensor:
    """Intersection counts for every xy shift of the search region,
    (box, box) (picasso/aim.py:297)."""
    stride = _grid_stride(width_units)
    l1 = _units(x1, intersect_d) + _units(y1, intersect_d) * stride
    l1_coords, l1_counts = _grid_counts(l1)
    return _count_intersections_all_shifts(
        l0_coords, l0_counts, l1_coords, l1_counts, shifts_xy
    ).reshape(box, box)


def _point_intersect_3d(l0_coords, l0_counts, x1, y1, z1, intersect_d,
                        width_units, height_units, shifts_z):
    """Intersection counts for every z shift (picasso/aim.py:377)."""
    sw = _grid_stride(width_units)
    sh = _grid_stride(height_units)
    l1 = (_units(x1, intersect_d) + _units(y1, intersect_d) * sw
          + _units(z1, intersect_d) * sw * sh)
    l1_coords, l1_counts = _grid_counts(l1)
    return _count_intersections_all_shifts(
        l0_coords, l0_counts, l1_coords, l1_counts, shifts_z)


def _get_fft_peak(roi_cc: np.ndarray, roi_size: float):
    """Phase-based sub-pixel peak of an intersection-count map
    (picasso/aim.py:444), on the host."""
    fft_values = np.fft.fft2(roi_cc.T)
    ang_x = np.angle(fft_values[0, 1])
    ang_x = ang_x - 2 * np.pi * (ang_x > 0)
    px = (np.abs(ang_x) / (2 * np.pi / roi_cc.shape[0])
          - (roi_cc.shape[0] - 1) / 2)
    px *= roi_size / roi_cc.shape[0]
    ang_y = np.angle(fft_values[1, 0])
    ang_y = ang_y - 2 * np.pi * (ang_y > 0)
    py = (np.abs(ang_y) / (2 * np.pi / roi_cc.shape[1])
          - (roi_cc.shape[1] - 1) / 2)
    py *= roi_size / roi_cc.shape[1]
    return px, py


def _get_fft_peak_z(roi_cc: np.ndarray, roi_size: float) -> float:
    """1D phase peak for z (picasso/aim.py:490), on the host."""
    fft_values = np.fft.fft(roi_cc)
    ang_z = np.angle(fft_values[1])
    ang_z = ang_z - 2 * np.pi * (ang_z > 0)
    pz = np.abs(ang_z) / (2 * np.pi / roi_cc.size) - (roi_cc.size - 1) / 2
    return pz * roi_size / roi_cc.size


def _check_round(aim_round) -> None:
    if aim_round not in (1, 2):
        raise ValueError("aim_round must be 1 or 2.")


def _spline(seg_bounds: np.ndarray, drift: np.ndarray) -> np.ndarray:
    """The segments' drifts at their centres, splined (order min(3, n -
    1)) to frames 1 .. seg_bounds[-1]."""
    t = (seg_bounds[1:] + seg_bounds[:-1]) / 2
    k = min(3, len(drift) - 1)
    return InterpolatedUnivariateSpline(t, drift, k=k)(
        np.arange(seg_bounds[-1]) + 1)


def _intersection_max_t(x, y, ref_x, ref_y, frame, seg_bounds, intersect_d,
                        roi_r, width, aim_round, progress):
    """:func:`intersection_max` on tensors of one device (x, y f64,
    frame int64); returns (x_pdc, y_pdc tensors, drift_x, drift_y
    numpy)."""
    _check_round(aim_round)
    dev = x.device
    n_segments = len(seg_bounds) - 1
    rel_drift_x = rel_drift_y = 0.0
    drift_x = np.zeros(n_segments)
    drift_y = np.zeros(n_segments)
    roi_units = int(np.ceil(roi_r / intersect_d))
    steps = np.arange(-roi_units, roi_units + 1)
    box = len(steps)
    width_units = width / intersect_d
    stride = _grid_stride(width_units)
    shifts_xy = torch.from_numpy((steps[:, None] + steps[None, :] * stride)
                                 .astype(np.int64).reshape(-1)).to(dev)
    l0 = _units(ref_x, intersect_d) + _units(ref_y, intersect_d) * stride
    l0_coords, l0_counts = _grid_counts(l0)
    for s in range(1 if aim_round == 1 else 0, n_segments):
        sel = (frame > int(seg_bounds[s])) & (frame <= int(seg_bounds[s + 1]))
        x1, y1 = x[sel], y[sel]
        if len(x1) == 0:
            drift_x[s], drift_y[s] = drift_x[s - 1], drift_y[s - 1]
            continue
        roi_cc = _point_intersect_2d(
            l0_coords, l0_counts, x1 + rel_drift_x, y1 + rel_drift_y,
            intersect_d, width_units, shifts_xy, box).cpu().numpy()
        px, py = _get_fft_peak(roi_cc, 2 * roi_r)
        rel_drift_x += px
        rel_drift_y += py
        drift_x[s], drift_y[s] = -rel_drift_x, -rel_drift_y
        progress.set_value(s)
    drift_x_full = _spline(seg_bounds, drift_x)
    drift_y_full = _spline(seg_bounds, drift_y)
    at = frame - 1
    return (x - torch.from_numpy(drift_x_full).to(dev)[at],
            y - torch.from_numpy(drift_y_full).to(dev)[at],
            drift_x_full, drift_y_full)


def _intersection_max_z_t(x, y, z, ref_x, ref_y, ref_z, frame, seg_bounds,
                          intersect_d, roi_r, width, height, pixelsize,
                          aim_round, progress):
    """:func:`intersection_max_z` on tensors of one device (z and ref_z
    in nm, divided by the pixel size here as JAX divides them); returns
    (z_pdc tensor in nm, drift_z numpy in nm)."""
    _check_round(aim_round)
    px = torch.tensor(pixelsize, dtype=torch.float64, device=x.device)
    z = z.to(torch.float64) / px
    ref_z = ref_z.to(torch.float64) / px
    n_segments = len(seg_bounds) - 1
    rel_drift_z = 0.0
    drift_z = np.zeros(n_segments)
    roi_units = int(np.ceil(roi_r / intersect_d))
    steps = np.arange(-roi_units, roi_units + 1)
    width_units = width / intersect_d
    height_units = height / intersect_d
    sw = _grid_stride(width_units)
    sh = _grid_stride(height_units)
    # int64: z keys reach stride_w * stride_h * z_units
    shifts_z = torch.from_numpy((steps * sw * sh).astype(np.int64)).to(
        x.device)
    l0 = (_units(ref_x, intersect_d) + _units(ref_y, intersect_d) * sw
          + _units(ref_z, intersect_d) * sw * sh)
    l0_coords, l0_counts = _grid_counts(l0)
    for s in range(1 if aim_round == 1 else 0, n_segments):
        sel = (frame > int(seg_bounds[s])) & (frame <= int(seg_bounds[s + 1]))
        if not bool(sel.any()):
            drift_z[s] = drift_z[s - 1]
            continue
        roi_cc = _point_intersect_3d(
            l0_coords, l0_counts, x[sel], y[sel], z[sel] + rel_drift_z,
            intersect_d, width_units, height_units, shifts_z).cpu().numpy()
        rel_drift_z += _get_fft_peak_z(roi_cc, 2 * roi_r)
        drift_z[s] = -rel_drift_z
        progress.set_value(s)
    drift_z_full = _spline(seg_bounds, drift_z)
    z_pdc = z - torch.from_numpy(drift_z_full).to(z.device)[frame - 1]
    return z_pdc * px, drift_z_full * pixelsize


def intersection_max(x, y, ref_x, ref_y, frame, seg_bounds, intersect_d,
                     roi_r, width, aim_round: int = 1, progress=None, *,
                     device="cuda"):
    """Per-segment adaptive intersection maximization in 2D
    (picasso/aim.py:517) on ``device``: segment s holds frames b[s] <
    frame <= b[s + 1]; an empty segment repeats the previous drift.
    Returns numpy (x_pdc, y_pdc, drift_x, drift_y), f64."""
    device = lib.resolve_device(device)
    f64 = torch.float64
    x_pdc, y_pdc, dx, dy = _intersection_max_t(
        _tensor(x, device, f64), _tensor(y, device, f64),
        _tensor(ref_x, device), _tensor(ref_y, device),
        _tensor(frame, device, torch.int64), np.asarray(seg_bounds),
        intersect_d, roi_r, width, aim_round, progress or lib.MockProgress())
    return x_pdc.cpu().numpy(), y_pdc.cpu().numpy(), dx, dy


def intersection_max_z(x, y, z, ref_x, ref_y, ref_z, frame, seg_bounds,
                       intersect_d, roi_r, width, height, pixelsize,
                       aim_round: int = 1, progress=None, *, device="cuda"):
    """Per-segment intersection maximization along z, x/y already
    undrifted, z in nm (picasso/aim.py:662), on ``device``. Returns
    numpy (z_pdc, drift_z) in nm."""
    device = lib.resolve_device(device)
    f64 = torch.float64
    z_pdc, dz = _intersection_max_z_t(
        _tensor(x, device, f64), _tensor(y, device, f64),
        _tensor(z, device), _tensor(ref_x, device), _tensor(ref_y, device),
        _tensor(ref_z, device),
        _tensor(frame, device, torch.int64), np.asarray(seg_bounds),
        intersect_d, roi_r, width, height, pixelsize, aim_round,
        progress or lib.MockProgress())
    return z_pdc.cpu().numpy(), dz


def aim(locs: np.ndarray, info: list[dict], segmentation: int = 100,
        intersect_d: float = 20 / 130, roi_r: float = 60 / 130,
        progress=None, *, device="cuda"):
    """AIM undrifting (picasso/aim.py:776) on ``device``: a round against
    the first segment's locs, a round against all locs, each drift
    minus its mean; then the same along z if the locs have z. Returns
    (locs with x, y (and z) f32, info with an AIM block, drift with
    fields x, y (and z) f32)."""
    device = lib.resolve_device(device)
    width = lib.get_from_metadata(info, "Width", raise_error=True)
    height = lib.get_from_metadata(info, "Height", raise_error=True)
    pixelsize = lib.get_from_metadata(info, "Pixelsize", raise_error=True)
    n_frames = lib.get_from_metadata(info, "Frames", raise_error=True)
    f64 = torch.float64
    frame = _tensor(locs["frame"], device, torch.int64)
    frame = frame + 1 - frame.min()
    seg_bounds = np.concatenate((np.arange(0, n_frames, segmentation),
                                 [n_frames]))
    first = frame <= segmentation
    x, y = _tensor(locs["x"], device), _tensor(locs["y"], device)
    rounds = 2 * (2 if "z" in locs.dtype.names else 1)
    with lib.progress_reporter(
            progress, rounds * int(np.ceil(n_frames / segmentation)),
            "Undrifting by AIM") as rep:
        x_pdc, y_pdc, drift_x1, drift_y1 = _intersection_max_t(
            x.to(f64), y.to(f64), x[first], y[first], frame, seg_bounds,
            intersect_d, roi_r, width, 1, rep)
        x_pdc, y_pdc, drift_x2, drift_y2 = _intersection_max_t(
            x_pdc, y_pdc, x_pdc, y_pdc, frame, seg_bounds, intersect_d,
            roi_r, width, 2, rep)
        drift_x = drift_x1 + drift_x2
        drift_y = drift_y1 + drift_y2
        shift_x, shift_y = np.mean(drift_x), np.mean(drift_y)
        drift_x -= shift_x
        drift_y -= shift_y
        x_pdc = x_pdc + shift_x
        y_pdc = y_pdc + shift_y
        columns = {"x": (x_pdc, drift_x), "y": (y_pdc, drift_y)}
        if "z" in locs.dtype.names:
            z = _tensor(locs["z"], device)
            z_pdc, drift_z1 = _intersection_max_z_t(
                x_pdc, y_pdc, z, x_pdc[first], y_pdc[first], z[first],
                frame, seg_bounds, intersect_d, roi_r, width, height,
                pixelsize, 1, rep)
            z_pdc, drift_z2 = _intersection_max_z_t(
                x_pdc, y_pdc, z_pdc, x_pdc, y_pdc, z_pdc, frame,
                seg_bounds, intersect_d, roi_r, width, height, pixelsize,
                2, rep)
            drift_z = drift_z1 + drift_z2
            shift_z = np.mean(drift_z)
            drift_z -= shift_z
            columns["z"] = (z_pdc + shift_z, drift_z)
    out = np.empty(len(locs), [(n, np.float32 if n in columns
                                else locs.dtype[n]) for n in locs.dtype.names])
    for n in locs.dtype.names:
        out[n] = (columns[n][0].cpu().numpy().astype(np.float32)
                  if n in columns else locs[n])
    drift = np.empty(len(drift_x), [(c, np.float32) for c in columns])
    for c, (_, d) in columns.items():
        drift[c] = d
    new_info = info + [{
        "Generated by": f"Picasso v{__version__} AIM",
        "Intersect distance (nm)": intersect_d * pixelsize,
        "Segmentation": segmentation,
        "Search regions radius (nm)": roi_r * pixelsize,
    }]
    return out, new_info, drift


# the reference's public names (picasso/aim.py:24-220)
def intersect1d(a, b):
    """Indices of the common elements of two sorted unique arrays."""
    aux = np.concatenate((a, b))
    order = np.argsort(aux, kind="stable")
    aux_sorted = aux[order]
    mask = aux_sorted[1:] == aux_sorted[:-1]
    return order[:-1][mask], order[1:][mask] - a.size


def count_intersections(l0_coords, l0_counts, l1_coords, l1_counts, *,
                        device="cuda") -> int:
    """Min-count overlap of two gridded localization sets."""
    return int(run_intersections(l0_coords, l0_counts, l1_coords, l1_counts,
                                 np.zeros(1, np.int64), 1, device=device)[0])


def point_intersect_2d(l0_coords, l0_counts, x1, y1, intersect_d,
                       width_units, shifts_xy, box, *, device="cuda"):
    """:func:`_point_intersect_2d` on numpy inputs; numpy (box, box)."""
    device = lib.resolve_device(device)
    t = [_tensor(a, device) for a in (l0_coords, l0_counts, x1, y1,
                                      shifts_xy)]
    return _point_intersect_2d(t[0], t[1], t[2], t[3], intersect_d,
                               width_units, t[4], box).cpu().numpy()


def point_intersect_3d(l0_coords, l0_counts, x1, y1, z1, intersect_d,
                       width_units, height_units, shifts_z, *,
                       device="cuda"):
    """:func:`_point_intersect_3d` on numpy inputs; numpy counts."""
    device = lib.resolve_device(device)
    t = [_tensor(a, device) for a in (l0_coords, l0_counts, x1, y1, z1,
                                      shifts_z)]
    return _point_intersect_3d(t[0], t[1], t[2], t[3], t[4], intersect_d,
                               width_units, height_units, t[5]
                               ).cpu().numpy()


def run_intersections(l0_coords, l0_counts, l1_coords, l1_counts, shifts_xy,
                      box, *, device="cuda"):
    """Intersection counts for all shifts at once (the reference used
    one thread a shift); (box, box) for box > 1."""
    device = lib.resolve_device(device)
    counts = _count_intersections_all_shifts(
        *(_tensor(a, device, torch.int64) for a in (
            l0_coords, l0_counts, l1_coords, l1_counts, shifts_xy))
    ).cpu().numpy()
    return counts.reshape(box, box) if box > 1 else counts


get_fft_peak = _get_fft_peak
get_fft_peak_z = _get_fft_peak_z
run_intersections_multithread = run_intersections
