"""Binary masks from rendered localizations (Render's Mask tool), the
masks and smoothing that the Fourier ring correlation uses, and the
global and local thresholds.

Counterpart of picasso_tpu/masking.py (mask_locs :22, generate_image
:48, binary_mask :66, THRESHOLD_METHODS :78, mask_image :84, the
thresholds :103-:249, threshold_tukey :255, loess_smooth :269). The
histogram image of :func:`generate_image` is rendered on ``device``
(render.render; its counts are integers in f32, so it is the same image
on any device); the blur, the thresholds and the masks run on the host
in numpy and scipy, as in JAX. The Tukey mask is made on the image's
device from its 1D window.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage as ndi

from picasso_torch import lib


def mask_locs(locs: np.ndarray, mask: np.ndarray, width: float | None = None,
              height: float | None = None, info: list[dict] | None = None):
    """Split locs into (inside, outside) by a binary mask that spans the
    field of view (``width`` x ``height`` px, from ``info`` if not
    given) (picasso/masking.py:26). Both are sorted by frame stably (JAX
    sorts with pandas' quicksort, which may reorder rows of a frame)."""
    if width is None or height is None:
        if info is None:
            raise ValueError("`mask_locs` requires `info` parameter.")
        width = lib.get_from_metadata(info, "Width")
        height = lib.get_from_metadata(info, "Height")
    x_ind = np.int32(np.floor(locs["x"] / width * mask.shape[1]))
    y_ind = np.int32(np.floor(locs["y"] / height * mask.shape[0]))
    x_ind = np.clip(x_ind, 0, mask.shape[1] - 1)
    y_ind = np.clip(y_ind, 0, mask.shape[0] - 1)
    index = mask[y_ind, x_ind].astype(bool)

    def by_frame(part):
        return part[np.argsort(part["frame"], kind="stable")]

    return by_frame(locs[index]), by_frame(locs[~index])


def generate_image(locs: np.ndarray, info: list[dict], disp_px_size: float,
                   blur: float, *, device="cuda") -> np.ndarray:
    """The histogram of the locs at ``disp_px_size`` nm a pixel, rendered
    on ``device``, blurred by a Gaussian of ``blur`` nm and divided by
    its maximum on the host (picasso/masking.py:79)."""
    from picasso_torch import render

    device = lib.resolve_device(device)
    _, image = render.render(locs, info, disp_px_size=disp_px_size,
                             blur_method=None, device=device)
    image_blur = ndi.gaussian_filter(image, blur / disp_px_size)
    image_blur /= image_blur.max()
    return image_blur


def binary_mask(image: np.ndarray, threshold) -> np.ndarray:
    """``image > threshold``, a scalar or an array of the image's shape
    (picasso/masking.py:110)."""
    if not np.isscalar(threshold):
        threshold = np.asarray(threshold)
        if threshold.shape != image.shape:
            raise ValueError(
                "Threshold array must have the same shape as the image")
    return image > threshold


THRESHOLD_METHODS = (
    "isodata", "li", "mean", "minimum", "otsu", "triangle", "yen",
    "local_gaussian", "local_mean", "local_median",
)


def mask_image(image: np.ndarray, method: str = "otsu") -> np.ndarray:
    """The binary mask of ``image`` by the threshold ``method``, one of
    :data:`THRESHOLD_METHODS` (picasso/masking.py:143): a local method
    gives the mask itself, a global one its threshold."""
    fn = globals()[f"threshold_{method}"]
    if method.startswith("local_"):
        return fn(image)
    return binary_mask(image, fn(image))


def tukey_window(width: int, device="cpu") -> torch.Tensor:
    """The 1D Tukey window w (width,) f64 of :func:`threshold_tukey`, on
    ``device``: 0.5 - 0.5 cos(8 pi x) over x = (i - width / 2) / width,
    1 where |x| < 3/8 (picasso/masking.py:649)."""
    nfac = 8
    x_im = (np.arange(width) - (width / 2)) / width
    w = 0.5 - 0.5 * np.cos(np.pi * nfac * x_im)
    w[np.abs(x_im) < ((nfac - 2) / (nfac * 2))] = 1
    return torch.from_numpy(w).to(device)


def check_square(image) -> None:
    """Raise ValueError unless ``image`` is a square 2D image (where
    picasso_tpu's threshold_tukey asserts)."""
    if image.ndim != 2 or image.shape[0] != image.shape[1]:
        raise ValueError(f"image must be square, got {tuple(image.shape)}")


def threshold_tukey(image: torch.Tensor) -> torch.Tensor:
    """Tukey window mask (n, n) f64 on ``image``'s device that tapers
    the edges of a square image before an FFT (picasso/masking.py:649).
    JAX tiles the 1D window w over the rows and multiplies the mask by
    its rot90, so mask[i, j] = w[j] * w[n - 1 - i]: here that product of
    the same two f64 numbers, as an outer product."""
    check_square(image)
    w = tukey_window(image.shape[1], image.device)
    return w.flip(0)[:, None] * w[None, :]


def loess_smooth(arr, span: int = 5) -> np.ndarray:
    """LOESS (locally weighted linear regression with tricube weights)
    smoothing of a 1D array (picasso/masking.py:674), in f64 on the
    host."""
    arr = np.asarray(arr, np.float64)
    n = len(arr)
    span += 1 - (span % 2)
    half = span // 2
    x = np.arange(n, dtype=np.float64)
    out = np.empty(n)
    for i in range(n):
        lo = max(0, i - half)
        hi = min(n, i + half + 1)
        xs = x[lo:hi]
        ys = arr[lo:hi]
        d = np.abs(xs - i)
        dmax = d.max() if d.max() > 0 else 1.0
        w = (1 - (d / dmax) ** 3) ** 3
        W = np.sum(w)
        xm = np.sum(w * xs) / W
        ym = np.sum(w * ys) / W
        cov = np.sum(w * (xs - xm) * (ys - ym))
        var = np.sum(w * (xs - xm) ** 2)
        slope = cov / var if var > 0 else 0.0
        out[i] = ym + slope * (i - xm)
    return out


def _histogram(image, bins: int = 256):
    counts, edges = np.histogram(np.asarray(image).ravel(), bins=bins)
    return counts.astype(np.float64), (edges[:-1] + edges[1:]) / 2.0


def threshold_isodata(image: np.ndarray) -> float:
    """Ridler and Calvard's iterative selection: the first bin centre
    that lies within a bin of the mean of the means below and above it
    (picasso_tpu/masking.py:103)."""
    counts, centers = _histogram(image)
    if len(centers) == 1:
        return centers[0]
    csuml = np.cumsum(counts)
    csumh = csuml[-1] - csuml
    csum_i = np.cumsum(counts * centers)
    with np.errstate(invalid="ignore", divide="ignore"):
        lower = csum_i[:-1] / csuml[:-1]
        higher = (csum_i[-1] - csum_i[:-1]) / csumh[:-1]
    all_mean = (lower + higher) / 2.0
    bin_width = centers[1] - centers[0]
    distances = all_mean - centers[:-1]
    candidates = centers[:-1][(distances >= 0) & (distances < bin_width)]
    return float(candidates[0]) if len(candidates) else float(centers[0])


def threshold_li(image: np.ndarray) -> float:
    """Li's minimum cross-entropy threshold by its fixed point, in f64
    (picasso_tpu/masking.py:121)."""
    image = np.asarray(image, np.float64)
    offset = image.min()
    shifted = image - offset + 1e-9  # log needs positive values
    t = shifted.mean()
    for _ in range(100):
        fg = shifted[shifted > t]
        bg = shifted[shifted <= t]
        if len(fg) == 0 or len(bg) == 0:
            break
        mf, mb = fg.mean(), bg.mean()
        denom = np.log(mf) - np.log(mb)
        if denom == 0:
            break
        t_new = (mf - mb) / denom
        if abs(t_new - t) < 1e-6:
            t = t_new
            break
        t = t_new
    return float(t + offset - 1e-9)


def threshold_mean(image: np.ndarray) -> float:
    """The mean of the pixels (picasso_tpu/masking.py:145)."""
    return float(np.mean(image))


def threshold_minimum(image: np.ndarray) -> float:
    """Prewitt and Mendelsohn's minimum: the histogram smoothed by a
    3-bin mean until it has fewer than three maxima, then the valley
    between its first and last maxima (picasso_tpu/masking.py:150)."""
    counts, centers = _histogram(image)
    smooth = counts.copy()
    for _ in range(10000):
        maxima = np.nonzero((smooth[1:-1] > smooth[:-2])
                            & (smooth[1:-1] > smooth[2:]))[0]
        if len(maxima) < 3:
            break
        smooth = np.convolve(smooth, np.ones(3) / 3.0, mode="same")
    maxima = np.nonzero((smooth[1:-1] > smooth[:-2])
                        & (smooth[1:-1] > smooth[2:]))[0] + 1
    if len(maxima) < 2:
        return float(centers[len(centers) // 2])
    lo, hi = maxima[0], maxima[-1]
    return float(centers[lo + int(np.argmin(smooth[lo:hi + 1]))])


def threshold_otsu(image: np.ndarray) -> float:
    """Otsu's threshold: the bin centre of a 256-bin histogram that
    maximizes the between-class variance (picasso_tpu/masking.py:174)."""
    counts, centers = _histogram(image)
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * centers) / np.maximum(w1, 1e-12)
    m2 = (np.cumsum((counts * centers)[::-1])
          / np.maximum(w2[::-1], 1e-12))[::-1]
    var_between = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(centers[np.argmax(var_between)])


def threshold_triangle(image: np.ndarray) -> float:
    """Zack's triangle method: the histogram flipped so that its longer
    tail lies left of the peak, then the bin along that tail farthest
    from the line from the tail's end to the peak
    (picasso_tpu/masking.py:187)."""
    counts, centers = _histogram(image)
    nbins = len(counts)
    peak = int(np.argmax(counts))
    peak_height = counts[peak]
    nonzero = np.nonzero(counts)[0]
    left, right = nonzero[0], nonzero[-1]
    if left == right:
        return float(image.ravel()[0])
    flip = peak - left < right - peak
    if flip:
        counts = counts[::-1]
        left = nbins - right - 1
        peak = nbins - peak - 1
    width = peak - left
    x1 = np.arange(width)
    y1 = counts[x1 + left]
    norm = np.sqrt(peak_height**2 + width**2)
    length = (peak_height / norm) * x1 - (width / norm) * y1
    arg_level = int(np.argmax(length)) + left
    if flip:
        arg_level = nbins - arg_level - 1
    return float(centers[arg_level])


def threshold_yen(image: np.ndarray) -> float:
    """Yen's maximum correlation threshold
    (picasso_tpu/masking.py:218)."""
    counts, centers = _histogram(image)
    p = counts / counts.sum()
    p1 = np.cumsum(p)
    p1_sq = np.cumsum(p**2)
    p2_sq = np.cumsum(p[::-1] ** 2)[::-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        crit = (np.log(np.maximum(p1_sq[:-1] * p2_sq[1:], 1e-30)) * -1
                + 2 * np.log(np.maximum(p1[:-1] * (1.0 - p1[:-1]), 1e-30)))
    return float(centers[np.argmax(crit)])


def threshold_local_gaussian(image: np.ndarray) -> np.ndarray:
    """The mask of pixels above their 3 x 3 Gaussian-weighted mean
    (sigma 1/3, reflected edges) (picasso_tpu/masking.py:234)."""
    sigma = tuple((b - 1) / 6.0 for b in (3, 3))
    return image > ndi.gaussian_filter(image, sigma=sigma, mode="reflect")


def threshold_local_mean(image: np.ndarray) -> np.ndarray:
    """The mask of pixels above their 3 x 3 mean
    (picasso_tpu/masking.py:243)."""
    return image > ndi.uniform_filter(image, (3, 3), mode="reflect")


def threshold_local_median(image: np.ndarray) -> np.ndarray:
    """The mask of pixels above their 3 x 3 median
    (picasso_tpu/masking.py:249)."""
    return image > ndi.median_filter(image, (3, 3), mode="reflect")
