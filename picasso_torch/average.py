"""2D particle averaging: iterative rotate+translate alignment of picked
groups against the sum image by FFT cross-correlation.

Counterpart of picasso_tpu/average.py (_render_hist_square :23,
compute_xcorr :36, align_group_core :45, _align_groups_device :99,
build_group_index :219, com_align :232, prepare_locs_for_save :244,
average :262). Locs are numpy structured arrays. Two routes, where JAX
takes them:

- below 64 groups the host route: each group's angle stack rendered and
  correlated with numpy f64 FFTs, JAX's code;
- from 64 groups the device route on ``device``: every group of a chunk
  rotated by every angle as (G, A, L) tensors, all (group, angle) images
  histogrammed with one ``index_add_`` (a sink slot an image for the
  entries out of view), correlated with one batched ``torch.fft``
  against the average, and each group's best (angle, shift) taken as the
  first index of the largest value.

The group means of com_align are pandas' (groupby mean of an f32 column:
an f32 sum with Kahan compensation in row order, over an f32 count).
"""

from __future__ import annotations

import time
from typing import Callable, Literal

import numpy as np
import scipy.sparse
import torch

from picasso_torch import __version__, lib

# groups from which average() takes the device route, as JAX
# (average.py:311-314)
DEVICE_MIN_GROUPS = 64
# complex64 elements of one chunk's (G, A, P, P) correlation stack
# (average.py:129-130)
CHUNK_BUDGET = 64_000_000


def _render_hist_square(x, y, oversampling, t_min, t_max):
    """Square histogram of coordinates in [t_min, t_max)^2 (the
    averaging workspace; cf. render_hist_numba usage in
    picasso/average.py:101)."""
    n_pixel = int(np.ceil(oversampling * (t_max - t_min)))
    in_view = (x > t_min) & (y > t_min) & (x < t_max) & (y < t_max)
    xi = (oversampling * (x[in_view] - t_min)).astype(np.int32)
    yi = (oversampling * (y[in_view] - t_min)).astype(np.int32)
    image = np.zeros((n_pixel, n_pixel), np.float32)
    np.add.at(image, (yi, xi), 1.0)
    return int(in_view.sum()), image


def compute_xcorr(CF_image_avg, image):
    """fftshifted cross-correlation with a precomputed conjugate
    spectrum (picasso/average.py:27)."""
    F_image = np.fft.fft2(image)
    return np.fft.fftshift(np.real(np.fft.ifft2(F_image * CF_image_avg)))


def align_group_core(index, x, y, angles, oversampling, t_min, t_max,
                     CF_image_avg, image_half):
    """Align one group: render the histogram at EVERY rotation angle,
    correlate all of them against the average image in one batched FFT,
    pick the (angle, shift) with the highest peak
    (picasso/average.py:49, de-serialized over angles)."""
    x0 = x[index]
    y0 = y[index]
    n_pixel = int(np.ceil(oversampling * (t_max - t_min)))
    A = len(angles)
    cos_a = np.cos(angles)
    sin_a = np.sin(angles)
    # rotated coords for all angles: (A, n_locs)
    xr = cos_a[:, None] * x0[None, :] - sin_a[:, None] * y0[None, :]
    yr = sin_a[:, None] * x0[None, :] + cos_a[:, None] * y0[None, :]
    in_view = (xr > t_min) & (yr > t_min) & (xr < t_max) & (yr < t_max)
    xi = (oversampling * (xr - t_min)).astype(np.int32)
    yi = (oversampling * (yr - t_min)).astype(np.int32)
    xi = np.clip(xi, 0, n_pixel - 1)
    yi = np.clip(yi, 0, n_pixel - 1)
    images = np.zeros((A, n_pixel, n_pixel), np.float32)
    a_idx = np.broadcast_to(np.arange(A)[:, None], xi.shape)
    np.add.at(images, (a_idx[in_view], yi[in_view], xi[in_view]), 1.0)
    F = np.fft.fft2(images)
    xcorr = np.fft.fftshift(np.real(np.fft.ifft2(F * CF_image_avg[None])),
                            axes=(1, 2))
    flat = xcorr.reshape(A, -1)
    best_per_angle = flat.max(axis=1)
    a_best = int(np.argmax(best_per_angle))
    if best_per_angle[a_best] <= 0.0:
        # empty/zero correlation (e.g. all locs outside the window):
        # keep the group untouched, like the reference's xcorr_max > 0
        # gate (picasso/average.py:96-107)
        return x0, y0
    y_max, x_max = np.unravel_index(int(np.argmax(flat[a_best])),
                                    (n_pixel, n_pixel))
    rot = angles[a_best]
    dy = np.ceil(y_max - image_half) / oversampling
    dx = np.ceil(x_max - image_half) / oversampling
    x_aligned = np.cos(rot) * x0 - np.sin(rot) * y0 - dx
    y_aligned = np.sin(rot) * x0 + np.cos(rot) * y0 - dy
    return x_aligned, y_aligned


def _align_groups_device(x, y, group_rows, angles, oversampling, t_min,
                         t_max, image_avg, image_half, device="cuda",
                         picks: list | None = None,
                         walls: dict | None = None):
    """Align every group at once on ``device``: per chunk of groups,
    rotate each group by every angle, histogram all (group, angle) images
    with one ``index_add_`` into a flat buffer with a sink slot an image,
    correlate them against the average with one batched FFT, and move
    each group by its best (angle, shift) where the best value is > 0.

    Returns updated (x, y) f32 numpy arrays. ``picks``, where given,
    gains one (best flat index, best value, second-best value) array
    triple a chunk; ``walls`` the seconds of the rotations and histograms
    (``rotate_hist``), the FFTs and picks (``fft``) and the host rest
    (``host``): only then is the card synchronized between them."""
    device = torch.device(device)
    sync = (torch.cuda.synchronize
            if device.type == "cuda" and walls is not None
            else (lambda *a: None))
    t_all = time.perf_counter()
    parts = {"rotate_hist": 0.0, "fft": 0.0}
    P = image_avg.shape[0]
    A = len(angles)
    cos_a = torch.from_numpy(np.cos(angles).astype(np.float32)).to(device)
    sin_a = torch.from_numpy(np.sin(angles).astype(np.float32)).to(device)
    avg = torch.from_numpy(np.asarray(image_avg, np.float32)).to(device)
    CF = torch.conj(torch.fft.fft2(avg))
    sizes = np.array([len(r) for r in group_rows])
    L = max(1, 1 << int(np.ceil(np.log2(max(sizes.max(), 1)))))
    Gb = int(np.clip(CHUNK_BUDGET // max(A * P * P, 1), 1, 256))
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    for start in range(0, len(group_rows), Gb):
        rows = group_rows[start:start + Gb]
        G = len(rows)
        xs = np.zeros((G, L), np.float32)
        ys = np.zeros((G, L), np.float32)
        mask = np.zeros((G, L), bool)
        for gi, r in enumerate(rows):
            xs[gi, :len(r)] = x[r]
            ys[gi, :len(r)] = y[r]
            mask[gi, :len(r)] = True
        xs_t, ys_t, mask_t = (torch.from_numpy(a).to(device)
                              for a in (xs, ys, mask))
        sync()
        t0 = time.perf_counter()
        c3, s3 = cos_a[None, :, None], sin_a[None, :, None]
        xr = c3 * xs_t[:, None, :] - s3 * ys_t[:, None, :]  # (G, A, L)
        yr = s3 * xs_t[:, None, :] + c3 * ys_t[:, None, :]
        ok = ((xr > t_min) & (yr > t_min) & (xr < t_max) & (yr < t_max)
              & mask_t[:, None, :])
        xi = torch.clamp((oversampling * (xr - t_min)).to(torch.int64), 0,
                         P - 1)
        yi = torch.clamp((oversampling * (yr - t_min)).to(torch.int64), 0,
                         P - 1)
        ga = torch.arange(G * A, device=device).reshape(G, A, 1)
        flat = (ga * P + yi) * P + xi
        # entries out of view or padding go to their image's own sink
        # slot: half of them would contend on one address
        # (tests/torch_average_hist_sweep.py)
        n_img = G * A * P * P
        flat = torch.where(ok, flat, n_img + ga)
        images = torch.zeros(n_img + G * A, dtype=torch.float32,
                             device=device)
        images.index_add_(0, flat.reshape(-1),
                          torch.ones(flat.numel(), dtype=torch.float32,
                                     device=device))
        images = images[:n_img].reshape(G, A, P, P)
        sync()
        t1 = time.perf_counter()
        F = torch.fft.fft2(images)
        xcorr = torch.fft.fftshift(
            torch.real(torch.fft.ifft2(F * CF[None, None])), dim=(2, 3))
        flat2 = xcorr.reshape(G, A * P * P)
        best = torch.argmax(flat2, 1)
        val = torch.gather(flat2, 1, best[:, None])[:, 0]
        if picks is not None:
            top2 = torch.topk(flat2, 2, 1).values
            picks.append((best.cpu().numpy(), val.cpu().numpy(),
                          top2[:, 1].cpu().numpy()))
        a_best = best // (P * P)
        rem = best % (P * P)
        dy = torch.ceil((rem // P).to(torch.float32) - image_half
                        ) / oversampling
        dx = torch.ceil((rem % P).to(torch.float32) - image_half
                        ) / oversampling
        c = cos_a[a_best][:, None]
        s = sin_a[a_best][:, None]
        x_al = c * xs_t - s * ys_t - dx[:, None]
        y_al = s * xs_t + c * ys_t - dy[:, None]
        keep = (val > 0.0)[:, None]
        xa = torch.where(keep, x_al, xs_t).cpu().numpy()
        ya = torch.where(keep, y_al, ys_t).cpu().numpy()
        t2 = time.perf_counter()
        parts["rotate_hist"] += t1 - t0
        parts["fft"] += t2 - t1
        for gi, r in enumerate(rows):
            x[r] = xa[gi, :len(r)]
            y[r] = ya[gi, :len(r)]
    if walls is not None:
        walls.update(parts)
        walls["host"] = time.perf_counter() - t_all - sum(parts.values())
    return x, y


def build_group_index(locs: np.ndarray) -> scipy.sparse.lil_matrix:
    """Sparse (n_groups, n_locs) boolean membership matrix
    (picasso/average.py:196)."""
    groups, rows = lib.group_rows(locs["group"])
    group_index = scipy.sparse.lil_matrix((len(groups), len(locs)),
                                          dtype=bool)
    for i, index in enumerate(rows):
        group_index[i, index] = True
    return group_index


def com_align(locs: np.ndarray, group_index=None) -> np.ndarray:
    """Center each group at the origin (picasso/average.py:223): each
    loc's x and y less its group's mean."""
    locs = locs.copy()
    groups, rows = lib.group_rows(locs["group"])
    inv = np.empty(len(locs), np.int64)
    for i, r in enumerate(rows):
        inv[r] = i
    for c in ("x", "y"):
        locs[c] = locs[c] - lib.group_mean(locs[c], rows)[inv]
    return locs


def prepare_locs_for_save(locs: np.ndarray, info: list[dict],
                          params: dict = {}) -> tuple[np.ndarray, list[dict]]:
    """Shift averaged locs back into the FOV + provenance block
    (picasso/average.py:280)."""
    cx = lib.get_from_metadata(info, "Width") / 2
    cy = lib.get_from_metadata(info, "Height") / 2
    locs = locs.copy()
    locs["x"] += cx
    locs["y"] += cy
    avg_info = {"Generated by": f"Picasso {__version__} Average"}
    if "disp_px_size" in params:
        avg_info["Display pixel size (nm)"] = params["disp_px_size"]
    if "it" in params:
        avg_info["Iterations"] = params["it"]
    return locs, info + [avg_info]


def _workspace(locs: np.ndarray, info: list[dict],
               display_pixel_size: float):
    """The centred locs' f32 (x, y), each group's rows, and the alignment
    workspace (angles, oversampling, t_min, t_max): a square of a
    power-of-two pixel count around twice the RMS radius, as JAX forms
    it (average.py:283-294)."""
    r = 2 * np.sqrt(np.mean(locs["x"] ** 2 + locs["y"] ** 2,
                            dtype=locs["x"].dtype))
    camera_pixelsize = lib.get_from_metadata(info, "Pixelsize",
                                             raise_error=True)
    oversampling = camera_pixelsize / display_pixel_size
    n_raw = int(np.ceil(oversampling * 2 * r))
    n_pow2 = 1 << max(int(np.ceil(np.log2(max(n_raw, 2)))), 1)
    pad = (n_pow2 / oversampling - 2 * r) / 2
    t_min, t_max = -r - pad, r + pad
    a_step = np.arcsin(1 / (oversampling * r))
    angles = np.arange(0, 2 * np.pi, a_step)
    x = locs["x"].astype(np.float32)
    y = locs["y"].astype(np.float32)
    _, group_rows = lib.group_rows(locs["group"])
    return x, y, group_rows, angles, oversampling, t_min, t_max


def average(locs: np.ndarray, info: list[dict], *,
            display_pixel_size: float = 5.0, iterations: int = 3,
            return_shifted_locs: bool = False,
            progress_callback: Callable | Literal["console"] | None = None,
            abort_callback: Callable[[], bool] | None = None,
            device="cuda", walls: list | None = None):
    """Iterative rotational/translational particle averaging
    (picasso/average.py:354). From DEVICE_MIN_GROUPS groups each
    iteration aligns on ``device``; below, on the host. The device is
    resolved first, whatever the route: ``"cuda"`` without a card raises.
    ``walls``, where given, gains one dict an iteration: the device
    route's split (_align_groups_device) and ``total`` seconds."""
    device = lib.resolve_device(device)
    assert "group" in locs.dtype.names, (
        "Localizations DataFrame must have a 'group' column.")
    locs = com_align(locs)
    x, y, group_rows, angles, oversampling, t_min, t_max = _workspace(
        locs, info, display_pixel_size)
    n_groups = len(group_rows)
    use_device = n_groups >= DEVICE_MIN_GROUPS
    aborted = False
    with lib.progress_reporter(
            progress_callback if progress_callback == "console" else None,
            iterations * n_groups, "Averaging") as rep:
        for it in range(iterations):
            if callable(abort_callback) and abort_callback():
                aborted = True
                break
            t0 = time.perf_counter()
            _, image_avg = _render_hist_square(x, y, oversampling, t_min,
                                               t_max)
            image_half = image_avg.shape[0] / 2
            split = {}
            if use_device:
                # batched over ALL groups: the groups are independent
                # within an iteration, the average image is fixed
                x, y = _align_groups_device(
                    x, y, group_rows, angles, oversampling, t_min, t_max,
                    image_avg, image_half, device, walls=split)
                rep.set_value((it + 1) * n_groups)
            else:
                CF_image_avg = np.conj(np.fft.fft2(image_avg))
                for gi, index in enumerate(group_rows):
                    xa, ya = align_group_core(
                        index, x, y, angles, oversampling, t_min, t_max,
                        CF_image_avg, image_half)
                    x[index] = xa
                    y[index] = ya
                    rep.set_value(it * n_groups + gi + 1)
            # global recentring each iteration so the ensemble cannot
            # drift out of the fixed histogram window
            # (picasso/average.py:500-503)
            x -= np.mean(x)
            y -= np.mean(y)
            if walls is not None:
                walls.append(dict(split, total=time.perf_counter() - t0))
            if callable(progress_callback):
                locs_current = locs.copy()
                locs_current["x"] = x
                locs_current["y"] = y
                try:
                    progress_callback(it + 1, iterations, locs_current,
                                      n_groups, n_groups)
                except TypeError:
                    pass
    if aborted:
        return None
    locs = locs.copy()
    locs["x"] = x
    locs["y"] = y
    if return_shifted_locs:
        params = {"disp_px_size": display_pixel_size, "it": iterations}
        return prepare_locs_for_save(locs, info, params)
    return locs
