"""The masks and smoothing that the Fourier ring correlation uses, and
Otsu's threshold of the clusterer's areas.

Counterpart of picasso_tpu/masking.py:255-293 (threshold_tukey,
loess_smooth) and :174 (threshold_otsu, which the clusterer's areas
use); the rest of that module (the image masks of the Mask tool) is not
ported. The Tukey mask is made on the image's device from its 1D window,
the LOESS and Otsu's threshold run on the host.
"""

from __future__ import annotations

import numpy as np
import torch


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
