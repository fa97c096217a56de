"""Least-squares 2D Gaussian fitting API of the port.

Counterpart of picasso_tpu/gausslq.py (fit_spot :27, fit_spots :34,
fit_spots_parallel :54, fit_spots_gpufit :84, locs_from_fits :100,
locs_from_fits_gpufit :145, localization_precision :187,
sigma_uncertainty :211, _initial_parameters_gpufit :228,
initial_parameters_gpufit :247). The reference's scipy, process-pool and Gpufit
paths are one batched LM fit here (ops/lq.fit_spots_batched), run on
``device`` through K3 on the route of ops/lq_cuda.ROI_FIT. Locs
tables are numpy structured arrays with the columns and dtypes of the
JAX package's DataFrame, sorted stably by frame (by n_id when the
identifications carry it).
"""

from __future__ import annotations

from typing import Callable, Literal

import numpy as np

from picasso_torch import lib
from picasso_torch.ops import lq as _lq

# the LM fit is always available on the card (K3), unlike the
# reference's Gpufit DLL; kept for the reference's availability checks
GPUFIT_INSTALLED = True


def fit_spot(spot: np.ndarray, device="cuda") -> np.ndarray:
    """Fit one spot; returns [x, y, photons, bg, sx, sy] with x/y
    relative to the box centre (picasso/gausslq.py:206)."""
    return fit_spots(spot[None], device=device)[0]


def fit_spots(
    spots: np.ndarray,
    progress_callback: Callable[[int], None] | Literal["console"] | None = None,
    photon_conversion: tuple[float, float] | None = None,
    device="cuda",
) -> np.ndarray:
    """Batched LM fit of (N, S, S) spots (picasso/gausslq.py:247);
    theta (N, 6)."""
    with lib.progress_reporter(
        progress_callback, len(spots), "Fitting (LQ)"
    ) as rep:
        theta = _lq.fit_spots_batched(
            spots, progress_callback=rep.set_value,
            photon_conversion=photon_conversion, device=device,
        )
    if callable(progress_callback):
        for i in range(len(spots)):
            progress_callback(i)
    return theta


def fit_spots_parallel(spots: np.ndarray, asynch: bool = False,
                       device="cuda"):
    """The reference farms chunks to a process pool here
    (picasso/gausslq.py:292); the batched fit already runs every spot
    at once. With ``asynch`` the result comes as one finished future."""
    theta = fit_spots(spots, device=device)
    if asynch:
        return [_CompletedFuture(theta)]
    return theta


class _CompletedFuture:
    """The part of concurrent.futures.Future that callers use."""

    def __init__(self, result):
        self._result = result

    def result(self):
        return self._result

    def done(self):
        return True


def fits_from_futures(futures) -> np.ndarray:
    return np.vstack([f.result() for f in futures])


def fit_spots_gpufit(spots: np.ndarray, device="cuda") -> np.ndarray:
    """The reference's Gpufit column layout (picasso/gausslq.py:346):
    [photons, x, y, sx, sy, bg] with x/y in box coordinates."""
    theta = fit_spots(spots, device=device)
    half = int(spots.shape[1] / 2)
    return np.stack([theta[:, 2], theta[:, 0] + half, theta[:, 1] + half,
                     theta[:, 4], theta[:, 5], theta[:, 3]], axis=1)


def _table(identifications, x, y, photons, sx, sy, bg, em, sort_key):
    lpx = localization_precision(photons, sx, sy, bg, em=em)
    lpy = localization_precision(photons, sy, sx, bg, em=em)
    with np.errstate(invalid="ignore"):
        ellipticity = np.abs(sx - sy) / np.maximum(sx, sy)
    cols = [
        ("frame", np.uint32, identifications["frame"]),
        ("x", np.float32, x),
        ("y", np.float32, y),
        ("photons", np.float32, photons),
        ("sx", np.float32, sx),
        ("sy", np.float32, sy),
        ("bg", np.float32, bg),
        ("lpx", np.float32, lpx),
        ("lpy", np.float32, lpy),
        ("ellipticity", np.float32, ellipticity),
        ("net_gradient", np.float32, identifications["net_gradient"]),
    ]
    if sort_key == "n_id":
        cols.append(("n_id", np.uint32, identifications["n_id"]))
    return lib.locs_table(cols, sort_key)


def locs_from_fits(identifications: np.ndarray, theta: np.ndarray, box: int,
                   em: bool) -> np.ndarray:
    """The locs table of LQ fits (picasso/gausslq.py:404-484); theta's
    x/y are relative to the box centre, i.e. to the identification."""
    key = "n_id" if "n_id" in (identifications.dtype.names or ()) else "frame"
    return _table(
        identifications,
        theta[:, 0] + identifications["x"], theta[:, 1] + identifications["y"],
        theta[:, 2], theta[:, 4], theta[:, 5], theta[:, 3], em, key,
    )


def locs_from_fits_gpufit(identifications: np.ndarray, theta: np.ndarray,
                          box: int, em: bool) -> np.ndarray:
    """The locs table of fits in the Gpufit layout
    (picasso/gausslq.py:487-544)."""
    box_offset = int(box / 2)
    return _table(
        identifications,
        theta[:, 1] + identifications["x"] - box_offset,
        theta[:, 2] + identifications["y"] - box_offset,
        theta[:, 0], theta[:, 3], theta[:, 4], theta[:, 5], em, "frame",
    )


def localization_precision(photons, s, s_orth, bg, em: bool) -> np.ndarray:
    """Mortensen precision of a 2D unweighted Gaussian fit, diagonal
    covariance form (picasso/gausslq.py:547-589); EMCCD excess noise
    doubles the variance. Computed in f64: diverged fits carry huge
    widths and backgrounds, and the sa * sa_orth * bg product overflows
    f32."""
    s = np.asarray(s, np.float64)
    s_orth = np.asarray(s_orth, np.float64)
    bg = np.asarray(bg, np.float64)
    photons = np.asarray(photons, np.float64)
    sa2 = s**2 + 1 / 12
    sa = sa2**0.5
    sa_orth = (s_orth**2 + 1 / 12) ** 0.5
    v = sa2 * (16 / 9 + (8 * np.pi * sa * sa_orth * bg) / photons) / photons
    if em:
        v = v * 2
    with np.errstate(invalid="ignore"):
        return np.sqrt(v)


def sigma_uncertainty(sigma, sigma_orth, photons, bg) -> np.ndarray:
    """Standard error of a fitted sigma of the LQ model
    (picasso/gausslq.py:592-633)."""
    sa2 = sigma**2 + 1 / 12
    sa4 = sa2**2
    sa = sa2**0.5
    sa_orth = (sigma_orth**2 + 1 / 12) ** 0.5
    var_sa2 = (
        sa4 / photons
        * (512 / 81 + (64 * np.pi * sa * sa_orth * bg) / (3 * photons))
    )
    return np.sqrt(var_sa2 / (4 * sigma**2))


def _initial_parameters_gpufit(spots: np.ndarray, size: int) -> np.ndarray:
    """Initial parameters in Gpufit's layout, (amplitude, x, y, sx, sy,
    bg) a spot in f32 (picasso/gausslq.py:128)."""
    center = (size / 2.0) - 0.5
    initial_width = max(size / 5.0, 1.0)
    spot_max = np.amax(spots, axis=(1, 2))
    spot_min = np.amin(spots, axis=(1, 2))
    initial = np.empty((len(spots), 6), dtype=np.float32)
    initial[:, 0] = spot_max - spot_min
    initial[:, 1] = center
    initial[:, 2] = center
    initial[:, 3] = initial_width
    initial[:, 4] = initial_width
    initial[:, 5] = spot_min
    return initial


def initial_parameters_gpufit(spots: np.ndarray, size: int) -> np.ndarray:
    """Deprecated alias of :func:`_initial_parameters_gpufit`
    (picasso/gausslq.py:115)."""
    lib.deprecation_warning(
        "Deprecation warning: This function will become private in "
        "v0.11.0. Use _initial_parameters_gpufit instead."
    )
    return _initial_parameters_gpufit(spots, size)
