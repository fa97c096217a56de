"""The ``avg`` fit method: each spot's photons are the sum of its ROI,
its centre the identification (picked-spot photometry).

Counterpart of picasso_tpu/avgroi.py (fit_spot :15, fit_spots :22,
fit_spots_parallel :42, fits_from_futures :50, locs_from_fits :54). The
sums are one device reduction over the (N, S, S) spots, accumulated in
f64 and rounded once to f32, so the card and the CPU give the same
photons; picasso_tpu sums in f32 (numpy's pairwise order), which differs
from the exact sum by a few f32 ulps of the ROI's total (the tolerance
of tests/torch_parity.AVG_PHOTONS_REL).
"""

from __future__ import annotations

from typing import Callable, Literal

import numpy as np
import torch

from picasso_torch import gausslq, lib

_CHUNK = 262144


def fit_spot(spot: np.ndarray, device="cuda") -> list[float]:
    """[x, y, photons, bg, sx, sy] with photons = bg = the pixel sum
    (picasso/avgroi.py:35)."""
    avg_roi = float(fit_spots(np.asarray(spot)[None], device=device)[0, 2])
    return [0, 0, avg_roi, avg_roi, 1, 1]


def fit_spots(
    spots: np.ndarray,
    progress_callback: Callable[[int], None] | Literal["console"] | None = None,
    device="cuda",
) -> np.ndarray:
    """theta (N, 6) f32 [0, 0, sum, sum, 1, 1] of (N, S, S) spots, the
    sums taken on ``device`` (picasso/avgroi.py:43)."""
    device = lib.resolve_device(device)
    spots = np.asarray(spots)
    theta = np.zeros((len(spots), 6), dtype=np.float32)
    theta[:, 4:] = 1
    for start in range(0, len(spots), _CHUNK):
        part = torch.from_numpy(np.ascontiguousarray(
            spots[start:start + _CHUNK], dtype=np.float32)).to(device)
        sums = part.to(torch.float64).sum(dim=(1, 2)).to(torch.float32)
        theta[start:start + len(part), 2] = sums.cpu().numpy()
    theta[:, 3] = theta[:, 2]
    if callable(progress_callback):
        progress_callback(len(spots))
    return theta


def fit_spots_parallel(spots: np.ndarray, asynch: bool = False,
                       device="cuda"):
    """One batched reduction, no pool (picasso/avgroi.py:66); with
    ``asynch`` the result comes as one finished future."""
    theta = fit_spots(spots, device=device)
    if asynch:
        return [gausslq._CompletedFuture(theta)]
    return theta


def fits_from_futures(futures) -> np.ndarray:
    return np.vstack([f.result() for f in futures])


def locs_from_fits(identifications: np.ndarray, theta: np.ndarray, box: int,
                   em: bool) -> np.ndarray:
    """The locs table of avg fits (picasso/avgroi.py:103), the LQ
    table's columns, sorted stably by frame (by n_id when the
    identifications carry it)."""
    key = "n_id" if "n_id" in (identifications.dtype.names or ()) else "frame"
    return gausslq._table(
        identifications,
        theta[:, 0] + identifications["x"], theta[:, 1] + identifications["y"],
        theta[:, 2], theta[:, 4], theta[:, 5], theta[:, 3], em, key,
    )
