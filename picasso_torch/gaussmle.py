"""MLE Gaussian fitting API of the port (Smith et al., Nature Methods
2010).

Counterpart of picasso_tpu/gaussmle.py (gaussmle :21, gaussmle_async
:51, locs_from_fits :66, sigma_uncertainty :119, _mean_filter :135,
mean_filter :153). Fits run on ``device`` through the route
of ops/mle_cuda.ROI_FITS for the method (K1's work queue with the
CRLB/LL in it, or K2's phase schedule). Locs tables are numpy
structured arrays with the columns and dtypes of the JAX package's
DataFrame.
"""

from __future__ import annotations

from typing import Callable, Literal

import numpy as np
import torch

from picasso_torch import lib
from picasso_torch.ops import mle_cuda
from picasso_torch.ops.identify import as_float32

_CHUNK = 262144


def gaussmle(
    spots: np.ndarray,
    eps: float,
    max_it: int,
    method: Literal["sigma", "sigmaxy"] = "sigmaxy",
    progress_callback: Callable[[int], None] | Literal["console"] | None = None,
    photon_conversion: tuple[float, float] | None = None,
    device="cuda",
):
    """Fit integrated Gaussians by MLE to (N, S, S) spots. Returns numpy
    (thetas (N, 6), CRLBs (N, 6), log-likelihoods (N,), iterations
    (N,)); theta columns [x, y, photons, bg, sx, sy] in box coordinates.
    ``photon_conversion=(baseline, factor)`` converts raw counts as
    (raw - baseline) * factor on the device."""
    device = lib.resolve_device(device)
    spots = np.asarray(spots)
    n = len(spots)
    out = ([], [], [], [])
    with lib.progress_reporter(progress_callback, n, "Fitting (MLE)") as rep:
        for start in range(0, n, _CHUNK):
            part = spots[start:start + _CHUNK]
            if photon_conversion is None:
                part = part.astype(np.float32)
            t = as_float32(
                torch.from_numpy(np.ascontiguousarray(part)).to(device)
            )
            if photon_conversion is not None:
                baseline, factor = photon_conversion
                t = (t - float(np.float32(baseline))) * float(np.float32(factor))
            fit = mle_cuda.ROI_FITS[method](
                t.permute(1, 2, 0).contiguous(), eps, max_it, method
            )
            for acc, a in zip(out, fit):
                acc.append(a.cpu().numpy())
            rep.set_value(start + len(part))
    if callable(progress_callback):
        progress_callback(n)
    if not n:
        z6 = np.zeros((0, 6), np.float32)
        return z6, z6, np.zeros(0, np.float32), np.zeros(0, np.int32)
    theta, crlb, ll, iters = (np.concatenate(a, axis=-1) for a in out)
    return theta.T.copy(), crlb.T.copy(), ll, iters


def gaussmle_async(spots: np.ndarray, eps: float, max_it: int,
                   method: Literal["sigma", "sigmaxy"] = "sigmaxy", *,
                   device="cuda"):
    """The reference's thread-pool launcher (picasso/gaussmle.py:478) as
    a finished call: ([N], thetas, CRLBs, log-likelihoods, iterations)."""
    thetas, CRLBs, likelihoods, iterations = gaussmle(
        spots, eps, max_it, method=method, device=device)
    return [len(spots)], thetas, CRLBs, likelihoods, iterations


def locs_from_fits(
    identifications: np.ndarray,
    theta: np.ndarray,
    CRLBs: np.ndarray,
    log_likelihoods: np.ndarray,
    iterations: np.ndarray,
    box: int,
) -> np.ndarray:
    """The locs table of MLE fits (picasso/gaussmle.py:957-1037), sorted
    stably by frame (by n_id when the identifications carry it)."""
    box_offset = int(box / 2)
    x = theta[:, 0] + identifications["x"] - box_offset
    y = theta[:, 1] + identifications["y"] - box_offset
    with np.errstate(invalid="ignore"):
        unc = np.sqrt(CRLBs.astype(np.float32))
        ellipticity = np.abs(theta[:, 4] - theta[:, 5]) / np.maximum(
            theta[:, 4], theta[:, 5]
        )
    cols = [
        ("frame", np.uint32, identifications["frame"]),
        ("x", np.float32, x),
        ("y", np.float32, y),
        ("photons", np.float32, theta[:, 2]),
        ("sx", np.float32, theta[:, 4]),
        ("sy", np.float32, theta[:, 5]),
        ("bg", np.float32, theta[:, 3]),
        ("lpx", np.float32, unc[:, 0]),
        ("lpy", np.float32, unc[:, 1]),
        ("ellipticity", np.float32, ellipticity),
        ("net_gradient", np.float32, identifications["net_gradient"]),
        ("log_likelihood", np.float32, log_likelihoods),
        ("iterations", np.uint32, iterations),
        ("photons_unc", np.float32, unc[:, 2]),
        ("bg_unc", np.float32, unc[:, 3]),
        ("sx_unc", np.float32, unc[:, 4]),
        ("sy_unc", np.float32, unc[:, 5]),
    ]
    key = "frame"
    if "n_id" in (identifications.dtype.names or ()):
        cols.append(("n_id", np.uint32, identifications["n_id"]))
        key = "n_id"
    return lib.locs_table(cols, key)


def sigma_uncertainty(sigma, sigma_orth, photons, bg) -> np.ndarray:
    """Standard error of a fitted sigma of the MLE model (Rieger &
    Stallinga, ChemPhysChem 2014; picasso/gaussmle.py:1040)."""
    sa2 = sigma**2 + 1 / 12
    tau = (2 * np.pi * sa2 * bg) / photons
    delta_sigma_sq = (sigma**2 / (4 * photons)) * (
        1 + 8 * tau + np.sqrt((8 * tau) / (1 + 2 * tau))
    )
    return np.sqrt(delta_sigma_sq)


def _mean_filter(spot: np.ndarray, size: int) -> np.ndarray:
    """3x3 edge-clipped mean of a size x size patch in f64 on the host
    (picasso/gaussmle.py:62), the background initializer's smoothing,
    which the batched fits carry out on the device."""
    spot = np.asarray(spot, dtype=np.float64)
    padded = np.pad(spot, 1)
    sums = sum(padded[1 + di:1 + di + size, 1 + dj:1 + dj + size]
               for di in (-1, 0, 1) for dj in (-1, 0, 1))
    rows = np.minimum(np.arange(size) + 2, size) - np.maximum(
        np.arange(size) - 1, 0)
    return sums / (rows[:, None] * rows[None, :])


def mean_filter(spot: np.ndarray, size: int) -> np.ndarray:
    """Deprecated alias of :func:`_mean_filter` (picasso/gaussmle.py:52)."""
    print("mean_filter is deprecated and will become a private function "
          "in v0.11.0. Use _mean_filter instead.")
    return _mean_filter(spot, size)
