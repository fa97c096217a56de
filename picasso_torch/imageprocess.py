"""FFT image correlation for drift correction: the redundant
cross-correlation (RCC) of rendered segments; and the search for
fiducial markers.

Counterpart of picasso_tpu/imageprocess.py (xcorr :29, _fit_peak :39,
_crop_center :80, get_image_shift :97, rcc :129, find_fiducials :197,
radial_sum :228).
Each segment is FFT'd once on its torch device; the pair correlations
run there in chunks of pairs, in f64 (numpy 2 transforms the JAX
package's f32 segments in complex64), and only the centre that the peak
search reads (max_shift wide) comes back to the host, where the 5x5
Gaussian peak fits run with scipy's curve_fit.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import curve_fit

from picasso_torch import lib
from picasso_torch.profiling import span


def _as_tensor(image) -> torch.Tensor:
    return image if isinstance(image, torch.Tensor) else torch.from_numpy(
        np.asarray(image))


def xcorr(imageA, imageB) -> np.ndarray:
    """FFT cross-correlation fftshift(Re(ifft2(FA * conj(FB)))) /
    sqrt(size) (picasso/imageprocess.py:27), on the images' device (the
    CPU for numpy arrays)."""
    a = _as_tensor(imageA).to(torch.float64)
    b = _as_tensor(imageB).to(a.device, torch.float64)
    out = torch.fft.ifft2(torch.fft.fft2(a) * torch.conj(torch.fft.fft2(b)))
    out = torch.fft.fftshift(out.real) / np.sqrt(a.numel())
    return out.cpu().numpy()


def _fit_peak(XCorr: np.ndarray, box: int, X_: int, Y_: int,
              shape: tuple[int, int]) -> tuple[float, float]:
    """5x5 (box x box) Gaussian sub-pixel fit of the correlation peak
    (picasso/imageprocess.py:119-135). Returns (yc, xc) relative to the
    image centre."""
    Y, X = shape
    fit_X = int(box / 2)
    y, x = np.mgrid[-fit_X:fit_X + 1, -fit_X:fit_X + 1]
    y_max_, x_max_ = np.unravel_index(XCorr.argmax(), XCorr.shape)
    FitROI = XCorr[
        y_max_ - fit_X:y_max_ + fit_X + 1,
        x_max_ - fit_X:x_max_ + fit_X + 1,
    ]
    dims = FitROI.shape
    if 0 in dims or dims[0] != dims[1]:
        return 0.0, 0.0

    def flat_2d_gaussian(coords, a, xc, yc, s, b):
        xg, yg = coords
        A = a * np.exp(-0.5 * ((xg - xc) ** 2 + (yg - yc) ** 2) / s**2) + b
        return A.flatten()

    p0 = [FitROI.max(), 0, 0, 1, FitROI.min()]
    bounds = ([0, -np.inf, -np.inf, 0, 0],
              [np.inf, np.inf, np.inf, np.inf, np.inf])
    try:
        popt, _ = curve_fit(flat_2d_gaussian, (x, y), FitROI.flatten(),
                            p0=p0, bounds=bounds)
    except RuntimeError:
        return 0.0, 0.0
    xc = popt[1] + X_ + x_max_ - np.floor(X / 2)
    yc = popt[2] + Y_ + y_max_ - np.floor(Y / 2)
    return yc, xc


def _crop_offsets(shape: tuple[int, int], roi: int | None):
    """The rows/columns (Y_, X_) that :func:`_crop_center` cuts from each
    side."""
    Y, X = shape
    if roi is None:
        return 0, 0
    return max(int((Y - roi) / 2), 0), max(int((X - roi) / 2), 0)


def _crop_center(XCorr, roi: int | None):
    """The centre of a correlation image, ``roi`` wide (all of it for
    None), and the offsets (Y_, X_) cut from each side."""
    Y_, X_ = _crop_offsets(XCorr.shape[-2:], roi)
    Y, X = XCorr.shape[-2:]
    return XCorr[..., Y_:Y - Y_, X_:X - X_], Y_, X_


def get_image_shift(imageA, imageB, box: int, roi: int | None = None,
                    display: bool = False) -> tuple[float, float]:
    """Shift from imageA to imageB by correlation peak fitting
    (picasso/imageprocess.py:53). Returns (-yc, -xc)."""
    if float(_as_tensor(imageA).sum()) == 0 or float(
            _as_tensor(imageB).sum()) == 0:
        return 0, 0
    XCorr = xcorr(imageA, imageB)
    shape = XCorr.shape
    XCorr, Y_, X_ = _crop_center(XCorr, roi)
    yc, xc = _fit_peak(XCorr, box, X_, Y_, shape)
    return -yc, -xc


def segment_pairs(n: int) -> list[tuple[int, int]]:
    """All pairs (i, j), i < j, in the reference's order."""
    return [(i, j) for i in range(n - 1) for j in range(i + 1, n)]


#: pair correlation pixels (pairs x Y x X) above which a mesh splits the
#: pairs over its shards (picasso_tpu/imageprocess.py:26 and :157-159;
#: below it JAX correlates on the host, and the port on one device)
DEVICE_PAIR_PIXELS = 32e6


def xcorr_pairs(F: torch.Tensor, ii, jj, offsets) -> np.ndarray:
    """The cropped correlations fftshift(Re(ifft2(F_i conj(F_j)))) /
    sqrt(Y X) of the pairs (ii, jj) of segment FFTs F (n, Y, X) on their
    device, in chunks of pairs (as picasso_tpu's rcc :165); returns the
    crops of ``offsets`` (Y_, X_) as one numpy array."""
    _, Y, X = F.shape
    Y_, X_ = offsets
    chunk = max(1, int(256e6 / (Y * X * 4)))
    crops = [torch.zeros((0, Y - 2 * Y_, X - 2 * X_), dtype=torch.float64)]
    for start in range(0, len(ii), chunk):
        i = torch.as_tensor(ii[start:start + chunk], device=F.device)
        j = torch.as_tensor(jj[start:start + chunk], device=F.device)
        xc = torch.fft.ifft2(F[i] * torch.conj(F[j])).real / np.sqrt(Y * X)
        xc = torch.fft.fftshift(xc, dim=(1, 2))
        crops.append(xc[:, Y_:Y - Y_, X_:X - X_].cpu())
    return torch.cat(crops).numpy()


def pair_xcorrs(segments: torch.Tensor, max_shift: int | None, mesh=None):
    """The cross-correlations of every segment pair, cropped to the
    ``max_shift`` centre: each (Y, X) segment is FFT'd once in f64 on its
    device and the pairs correlate there (:func:`xcorr_pairs`); with a
    ``mesh`` (picasso_torch.parallel.mesh.Mesh) and more than
    :data:`DEVICE_PAIR_PIXELS` pair pixels, the pairs split over its
    shards (mesh.pair_xcorrs_crops). Returns (crops (n_pairs, h, w)
    numpy, (Y_, X_))."""
    n, Y, X = segments.shape
    offsets = _crop_offsets((Y, X), max_shift)
    pairs = segment_pairs(n)
    ii = np.array([p[0] for p in pairs], np.int64)
    jj = np.array([p[1] for p in pairs], np.int64)
    if mesh is not None and len(pairs) * Y * X > DEVICE_PAIR_PIXELS:
        from picasso_torch.parallel.mesh import pair_xcorrs_crops

        return pair_xcorrs_crops(segments, ii, jj, mesh, offsets), offsets
    F = torch.fft.fft2(segments.to(torch.float64))
    return xcorr_pairs(F, ii, jj, offsets), offsets


def peak_shifts(crops: np.ndarray, offsets, shape, empty: np.ndarray):
    """Pair shifts (shifts_y, shifts_x) (n, n) from the cropped pair
    correlations by 5x5 peak fits on the host; a pair with an empty
    segment (``empty[i]``) has shift 0."""
    n = len(empty)
    shifts_x = np.zeros((n, n))
    shifts_y = np.zeros((n, n))
    Y_, X_ = offsets
    for (i, j), XCorr in zip(segment_pairs(n), crops):
        if empty[i] or empty[j]:
            yc = xc = 0.0
        else:
            yc, xc = _fit_peak(XCorr, 5, X_, Y_, shape)
        shifts_y[i, j] = -yc
        shifts_x[i, j] = -xc
    return shifts_y, shifts_x


def rcc(segments, max_shift: int | None = None, mesh=None):
    """Redundant cross-correlation (Wang, Schnitzbauer et al., Opt.
    Express 2014; picasso/imageprocess.py:160) of (n, Y, X) segments (a
    tensor on its device, or arrays): all pair shifts (over ``mesh``'s
    shards as :func:`pair_xcorrs` routes them), solved to per-segment
    drift by least squares. Returns (shift_y, shift_x). Its steps run
    in the spans ``picasso.undrift.xcorr``, ``.peak_fit`` and ``.solve``
    (profiling.span)."""
    seg = segments if isinstance(segments, torch.Tensor) else (
        torch.from_numpy(np.stack(segments).astype(np.float32)))
    seg = seg.to(torch.float32)
    with span("picasso.undrift.xcorr"):
        empty = (seg.sum(dim=(1, 2)) == 0).cpu().numpy()
        crops, offsets = pair_xcorrs(seg, max_shift, mesh)
    with span("picasso.undrift.peak_fit"):
        shifts_y, shifts_x = peak_shifts(crops, offsets,
                                         tuple(seg.shape[1:]), empty)
    with span("picasso.undrift.solve"):
        return lib.minimize_shifts(shifts_x, shifts_y)


def percentile_linear(values: torch.Tensor, q: float):
    """np.percentile(values, q) (linear interpolation) of a float tensor
    on its device, as a numpy scalar of its dtype: the two neighbours
    from a sort on the device, then numpy's own interpolation in that
    dtype (q / 100 and the index as numpy forms them)."""
    s = torch.sort(values.reshape(-1)).values
    n = len(s)
    dt = torch.empty(0, dtype=s.dtype).numpy().dtype
    vi = np.asanyarray((n - 1) * np.asanyarray(np.true_divide(
        q, dt.type(100))))
    lo = np.floor(vi)
    if vi >= n - 1:
        i = j = n - 1
    elif vi < 0:
        i = j = 0
    else:
        i, j = int(lo), int(lo) + 1
    if bool(torch.isnan(s[-1])):
        return s[-1].cpu().numpy()[()]
    a, b = (v.cpu().numpy()[()] for v in (s[i], s[j]))
    gamma = np.asanyarray(vi - lo, dtype=vi.dtype)
    diff = np.subtract(b, a)
    out = np.asanyarray(np.add(a, diff * gamma))
    np.subtract(b, diff * (1 - gamma), out=out, where=gamma >= 0.5,
                casting="unsafe", dtype=type(out.dtype))
    return out[()]


def find_fiducials(locs: np.ndarray, info: list[dict], *, device="cuda"):
    """Positions of fiducial markers (picasso/imageprocess.py:220): the
    ``smooth`` render at oversampling 1 on ``device``, its local maxima
    above the 99th percentile through K4 (localize.identify_in_image, box
    900 nm in pixels, odd), kept where a circle of half the box holds
    more locs than 0.8 x Frames. Returns (picks [(x, y)], box)."""
    from picasso_torch import localize, postprocess, render

    device = lib.resolve_device(device)
    _, image = render.render_t(render.columns(locs, ("x", "y"), device),
                               info, oversampling=1, blur_method="smooth")
    threshold = percentile_linear(image, 99)
    pixelsize = lib.get_from_metadata(info, "Pixelsize", default=130)
    box = int(np.round(900 / pixelsize))
    box = box + 1 if box % 2 == 0 else box
    y, x, _ = localize.identify_in_image(image, threshold, box)
    picks = [(int(xi), int(yi)) for xi, yi in zip(x, y)]
    min_n = 0.8 * lib.get_from_metadata(info, "Frames", default=0)
    picked = postprocess.picked_locs(locs, info, picks, "Circle",
                                     pick_size=box / 2, add_group=False)
    return [p for p, g in zip(picks, picked) if len(g) > min_n], box


def ring_of(fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(fy^2 + fx^2)) of integer tensors (broadcast), int64, as
    numpy takes it: the f64 root, then one integer step that makes it
    exact (torch's root on the CPU may be off by an ulp)."""
    q = fy * fy + fx * fx
    ring = torch.floor(torch.sqrt(q.to(torch.float64))).to(torch.int64)
    return ring + ((ring + 1) * (ring + 1) <= q).to(torch.int64) - (
        ring * ring > q).to(torch.int64)


def radial_sum(image: torch.Tensor) -> torch.Tensor:
    """Sums of a square, odd-sized image over rings of integer radius
    floor(distance from the centre), out to the centre's index
    (picasso/imageprocess.py:283), on the image's device: f64 sums in
    the pixels' row-major order (index_add_; on the CPU that is
    np.bincount's order, on a card the atomics' order), real and
    imaginary parts apart for a complex image; in the image's dtype."""
    if image.ndim != 2 or image.shape[0] != image.shape[1] or (
            image.shape[0] % 2 != 1):
        raise ValueError("radial_sum needs a square image of odd size, "
                         f"got {tuple(image.shape)}")
    center = image.shape[0] // 2
    r = torch.arange(image.shape[0], device=image.device) - center
    r_idx = ring_of(r[:, None], r[None, :]).reshape(-1)
    keep = r_idx < center + 1
    idx = r_idx[keep]

    def ring(values):
        out = torch.zeros(center + 1, dtype=torch.float64,
                          device=image.device)
        return out.index_add_(0, idx, values.reshape(-1)[keep].to(
            torch.float64))

    if image.is_complex():
        return torch.complex(ring(image.real), ring(image.imag)).to(
            image.dtype)
    return ring(image).to(image.dtype)
