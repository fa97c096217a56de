"""3D particle averaging: iterative rotation scans of every picked group
around the x, y and z axes, each group moved to its best (angle, shift)
by FFT cross-correlation against the ensemble's average image.

Counterpart of picasso_tpu/average3.py (ROT_PLANES :27, rotate_axis :30,
_plane_coords :51, _hist_stack :62, _com_align3 :83,
_align_rotation_axis :91, prepare_locs_for_save :150, average3 :164).
Locs are numpy structured arrays with x, y in camera pixels and z in nm.

A pass correlates every group against an average image that is fixed
for the whole pass, and no group reads another's update, so all groups
are scanned at once on ``device`` without changing a result, as the 2D
average does (average._align_groups_device): per chunk of groups sized
by memory, every group rotated by every angle as (G, A, L) tensors in
f64 (JAX's numpy multiplies f32 coordinates by f64 cosines, so the bins
are JAX's), all (group, angle) images histogrammed with one
``index_add_`` (a sink slot an image for the entries out of view),
correlated in complex64 (numpy 2's ``fft2`` of f32 images) with one
batched ``torch.fft``, and each group's best (angle, shift) taken as the
first index of the largest value. The moves themselves are JAX's numpy
code on the host. Unlike the 2D scan a group moves whatever its best
value (JAX's 3D scan has no ``> 0`` test).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from picasso_torch import lib

#: rotation axis -> the projection plane whose image the scan correlates
ROT_PLANES = {"z": "xy", "x": "yz", "y": "xz"}
#: complex64 elements of one chunk's (G, A, P, P) correlation stack, and
#: f64 elements of its (G, A, L) rotated coordinates
CHUNK_BUDGET = 64_000_000
ROTATION_BUDGET = 16_000_000


def rotate_axis(axis, vx, vy, vz, angle, pixelsize):
    """Rotate (x [px], y [px], z [nm]) around a coordinate axis
    (picasso/gui/average3.py:73)."""
    c, s = np.cos(angle), np.sin(angle)
    return _rotate(axis, vx, vy, vz, c, s, pixelsize)


def _rotate(axis, vx, vy, vz, c, s, pixelsize):
    """:func:`rotate_axis` with the cosine and sine given: numpy arrays or
    tensors, the products and sums in JAX's order, each rounded."""
    if axis == "z":
        return c * vx - s * vy, s * vx + c * vy, vz
    if axis == "y":
        return c * vx + s * (vz / pixelsize), vy, -s * vx * pixelsize + c * vz
    if axis == "x":
        return vx, c * vy - s * (vz / pixelsize), s * vy * pixelsize + c * vz
    raise ValueError(f"unknown axis {axis!r}")


def _plane_coords(x, y, z_px, proplane):
    """The two in-plane coordinate arrays (rows, cols) of a projection."""
    if proplane == "xy":
        return y, x
    if proplane == "yz":
        return z_px, y
    if proplane == "xz":
        return z_px, x
    raise ValueError(f"unknown plane {proplane!r}")


def _n_pixel(oversampling, t_min, t_max) -> int:
    return int(np.ceil(oversampling * (t_max - t_min)))


def _hist_stack(rows, cols, oversampling, t_min, t_max) -> np.ndarray:
    """Histograms of (A, n_locs) rows/cols for A angles, (A, P, P) f32 on
    the host."""
    n_pixel = _n_pixel(oversampling, t_min, t_max)
    A = rows.shape[0]
    in_view = (rows > t_min) & (cols > t_min) & (rows < t_max) & (cols < t_max)
    ri = np.clip((oversampling * (rows - t_min)).astype(np.int32), 0,
                 n_pixel - 1)
    ci = np.clip((oversampling * (cols - t_min)).astype(np.int32), 0,
                 n_pixel - 1)
    a_idx = np.broadcast_to(np.arange(A)[:, None], ri.shape)
    flat = (a_idx[in_view] * n_pixel + ri[in_view]) * n_pixel + ci[in_view]
    return np.bincount(flat, minlength=A * n_pixel * n_pixel).reshape(
        A, n_pixel, n_pixel).astype(np.float32)


def _com_align3(locs: np.ndarray) -> np.ndarray:
    """Each group's x, y, z less its pandas f32 mean."""
    locs = locs.copy()
    _, rows = lib.group_rows(locs["group"])
    inv = np.empty(len(locs), np.int64)
    for i, r in enumerate(rows):
        inv[r] = i
    for c in ("x", "y", "z"):
        locs[c] = locs[c] - lib.group_mean(locs[c], rows)[inv]
    return locs


def _scan_chunk(xs, ys, zs, mask, rotaxis, cos_a, sin_a, CF, oversampling,
                t_min, t_max, pixelsize, P, parts, sync):
    """The best flat (angle, row, col) index of each group of a chunk,
    its value and the second-best value, on the device."""
    device = xs.device
    G, A = xs.shape[0], cos_a.shape[0]
    t0 = time.perf_counter()
    c = cos_a[None, :, None]
    s = sin_a[None, :, None]
    # a tensor, not a Python scalar: a CUDA division by a scalar
    # multiplies by its reciprocal, numpy divides
    ps = torch.tensor(float(pixelsize), dtype=torch.float64, device=device)
    xr, yr, zr = _rotate(rotaxis, xs[:, None, :], ys[:, None, :],
                         zs[:, None, :], c, s, ps)
    rows, cols = _plane_coords(xr, yr, zr / ps, ROT_PLANES[rotaxis])
    rows, cols = (a.expand(G, A, xs.shape[1]) for a in (rows, cols))
    ok = ((rows > t_min) & (cols > t_min) & (rows < t_max) & (cols < t_max)
          & mask[:, None, :])
    ri = torch.clamp((oversampling * (rows - t_min)).to(torch.int64), 0,
                     P - 1)
    ci = torch.clamp((oversampling * (cols - t_min)).to(torch.int64), 0,
                     P - 1)
    ga = torch.arange(G * A, device=device).reshape(G, A, 1)
    n_img = G * A * P * P
    flat = torch.where(ok, (ga * P + ri) * P + ci, n_img + ga)
    images = torch.zeros(n_img + G * A, dtype=torch.float32, device=device)
    images.index_add_(0, flat.reshape(-1), torch.ones(
        flat.numel(), dtype=torch.float32, device=device))
    images = images[:n_img].reshape(G, A, P, P)
    sync()
    t1 = time.perf_counter()
    xcorr = torch.fft.fftshift(torch.real(torch.fft.ifft2(
        torch.fft.fft2(images) * CF[None, None])), dim=(2, 3))
    flat2 = xcorr.reshape(G, A * P * P)
    top2 = torch.topk(flat2, 2, 1)
    best = torch.argmax(flat2, 1)
    out = (best.cpu().numpy(), top2.values[:, 0].cpu().numpy(),
           top2.values[:, 1].cpu().numpy())
    parts["rotate_hist"] += t1 - t0
    parts["fft"] += time.perf_counter() - t1
    return out


def _align_rotation_axis(locs, group_rows, rotaxis, angles, oversampling,
                         t_min, t_max, pixelsize, device="cuda",
                         picks: list | None = None,
                         walls: dict | None = None) -> np.ndarray:
    """One rotation-scan pass over all groups around ``rotaxis``
    (picasso_tpu/average3.py:91), the scans on ``device``. Returns the
    moved locs. ``picks``, where given, gains one (best flat index, best
    value, second-best value) array triple a chunk; ``walls`` the seconds
    of the rotations and histograms (``rotate_hist``), the FFTs and picks
    (``fft``) and the host rest (``host``): only then is the card
    synchronized between them."""
    device = torch.device(device)
    sync = (torch.cuda.synchronize
            if device.type == "cuda" and walls is not None
            else (lambda *a: None))
    t_all = time.perf_counter()
    parts = {"rotate_hist": 0.0, "fft": 0.0}
    proplane = ROT_PLANES[rotaxis]
    x, y, z = (np.array(locs[c]) for c in ("x", "y", "z"))
    P = _n_pixel(oversampling, t_min, t_max)
    half = P / 2
    rows, cols = _plane_coords(x, y, z / pixelsize, proplane)
    avg = _hist_stack(rows[None], cols[None], oversampling, t_min, t_max)[0]
    CF = torch.conj(torch.fft.fft2(torch.from_numpy(avg).to(device)))
    A = len(angles)
    cos_a = torch.from_numpy(np.cos(angles[:, None])[:, 0]).to(device)
    sin_a = torch.from_numpy(np.sin(angles[:, None])[:, 0]).to(device)
    sizes = np.array([len(r) for r in group_rows])
    L = max(1, 1 << int(np.ceil(np.log2(max(sizes.max(initial=1), 1)))))
    Gb = int(np.clip(min(CHUNK_BUDGET // max(A * P * P, 1),
                         ROTATION_BUDGET // max(A * L, 1)), 1, 256))
    best_all = []
    for start in range(0, len(group_rows), Gb):
        chunk = group_rows[start:start + Gb]
        pad = np.zeros((3, len(chunk), L), np.float32)
        mask = np.zeros((len(chunk), L), bool)
        for gi, r in enumerate(chunk):
            for k, v in enumerate((x, y, z)):
                pad[k, gi, :len(r)] = v[r]
            mask[gi, :len(r)] = True
        xs, ys, zs = (torch.from_numpy(a).to(device) for a in pad)
        out = _scan_chunk(xs, ys, zs, torch.from_numpy(mask).to(device),
                          rotaxis, cos_a, sin_a, CF, oversampling,
                          float(t_min), float(t_max), pixelsize, P, parts,
                          sync)
        best_all.append(out[0])
        if picks is not None:
            picks.append(out)
    best = np.concatenate(best_all) if best_all else np.zeros(0, np.int64)
    a_best = best // (P * P)
    r_max, c_max = np.divmod(best % (P * P), P)
    # JAX's moves, per group in numpy: each loc takes its group's angle
    # (cosine and sine of the scalar, as JAX takes them) and shift
    inv = np.empty(len(x), np.int64)
    for g, r in enumerate(group_rows):
        inv[r] = g
    cs = {a: (np.cos(angles[a]), np.sin(angles[a])) for a in np.unique(a_best)}
    c = np.array([cs[a][0] for a in a_best])[inv]
    s = np.array([cs[a][1] for a in a_best])[inv]
    dr = (np.ceil(r_max - half) / oversampling)[inv]
    dc = (np.ceil(c_max - half) / oversampling)[inv]
    xb, yb, zb = _rotate(rotaxis, x, y, z, c, s, pixelsize)
    if proplane == "xy":
        yb = yb - dr
        xb = xb - dc
    elif proplane == "yz":
        zb = zb - dr * pixelsize
        yb = yb - dc
    else:
        zb = zb - dr * pixelsize
        xb = xb - dc
    locs = locs.copy()
    locs["x"], locs["y"], locs["z"] = xb, yb, zb
    if walls is not None:
        walls.update(parts)
        walls["host"] = time.perf_counter() - t_all - sum(parts.values())
    return locs


def prepare_locs_for_save(locs: np.ndarray, info: list[dict],
                          params: dict | None = None):
    """Shift origin-centred 3D averages back into the field of view and
    append a provenance block (picasso_tpu/average3.py:150)."""
    locs = locs.copy()
    locs["x"] += lib.get_from_metadata(info, "Width") / 2
    locs["y"] += lib.get_from_metadata(info, "Height") / 2
    block = {"Generated by": "Picasso Average3"}
    block.update(params or {})
    return locs, info + [block]


def _workspace(locs: np.ndarray, pixelsize, oversampling, angle_range):
    """The scan window (t_min, t_max) of twice the RMS radius (z in
    pixels) and the angles of step arcsin(1 / (oversampling r)), in the
    dtypes JAX's pandas and numpy give them."""
    z_px = locs["z"] / pixelsize
    r = 2 * np.sqrt(np.mean(np.ascontiguousarray(
        locs["x"] ** 2 + locs["y"] ** 2 + z_px ** 2)))
    a_step = np.arcsin(1 / (oversampling * r))
    if angle_range is None:
        angles = np.arange(0, 2 * np.pi, a_step)
    else:
        angles = np.arange(-angle_range, angle_range, a_step)
    return -r, r, angles


def average3(locs: np.ndarray, info: list[dict], *, iterations: int = 3,
             oversampling: float = 10.0,
             rot_axes: tuple[str, ...] = ("z", "x", "y"),
             angle_range: float | None = None, progress_callback=None,
             device="cuda", walls: list | None = None,
             picks: list | None = None) -> np.ndarray:
    """Iteratively align picked 3D particles (a ``group`` and a ``z``
    field required; picasso_tpu/average3.py:164) with the scans on
    ``device``: each iteration scans every group around each axis of
    ``rot_axes`` (the full circle, or +-``angle_range`` rad), moves it to
    its best (angle, shift) and recentres the whole ensemble after each
    axis. Returns the aligned locs about the origin. ``walls``, where
    given, gains one dict a pass: the split of _align_rotation_axis and
    ``total`` seconds; ``picks`` one (best index, best value, second-best
    value) array triple a pass."""
    device = lib.resolve_device(device)
    assert "group" in locs.dtype.names, "average3 needs picked (grouped) locs"
    assert "z" in locs.dtype.names, "average3 needs 3D locs"
    pixelsize = lib.get_from_metadata(info, "Pixelsize", 130)
    locs = _com_align3(locs)
    _, group_rows = lib.group_rows(locs["group"])
    t_min, t_max, angles = _workspace(locs, pixelsize, oversampling,
                                      angle_range)
    done = 0
    total = iterations * len(rot_axes)
    for _ in range(iterations):
        for axis in rot_axes:
            t0 = time.perf_counter()
            split, chunks = {}, []
            locs = _align_rotation_axis(locs, group_rows, axis, angles,
                                        oversampling, t_min, t_max,
                                        pixelsize, device, picks=chunks,
                                        walls=split)
            if picks is not None:
                picks.append(tuple(np.concatenate(p) for p in zip(*chunks)))
            # the global recentring only: a group's own would cancel the
            # shift it just received
            for c in ("x", "y", "z"):
                locs[c] -= np.mean(np.ascontiguousarray(locs[c]))
            if walls is not None:
                walls.append(dict(split, axis=axis,
                                  total=time.perf_counter() - t0))
            done += 1
            if callable(progress_callback):
                progress_callback(done, total)
    return locs
