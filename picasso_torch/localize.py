"""Identify + fit spots in 2D: the ``localize`` entry point of the port.

Counterpart of picasso_tpu/localize.py (localize :516, fused branch;
_id_frame_chunk :60). The chain per frame chunk (ops/fused.py) runs on
``device``: on a CUDA device through the hand-written kernels, on the
CPU through their plain PyTorch versions. The fitters: ``gausslq`` and
``gausslq-gpu`` (the LM fit, the default) and ``gaussmle`` (methods
``sigmaxy`` and ``sigma``).
"""

from __future__ import annotations

import warnings
from typing import Literal

import numpy as np

from picasso_torch import __version__, gausslq, gaussmle

# f32 bytes per identification batch; frames per chunk adapt to the
# frame size (a 256x256 movie takes 244-frame chunks, evened to 256)
_ID_CHUNK_BYTES = 64e6


def _id_frame_chunk(height: int, width: int) -> int:
    return int(np.clip(_ID_CHUNK_BYTES / (height * width * 4), 16, 1024))


def localize(
    movie,
    camera_info: dict,
    parameters: dict,
    *,
    roi=None,
    frame_bounds=None,
    movie_info: list[dict] | None = None,
    fitting_method: Literal[
        "gausslq", "gausslq-gpu", "gaussmle", "avg"
    ] = "gausslq",
    eps: float = 0.001,
    max_it: int = 100,
    mle_method: Literal["sigma", "sigmaxy"] = "sigmaxy",
    identification_progress_callback=None,
    fit_progress_callback=None,
    return_info: bool = False,
    device="cuda",
):
    """Identify and fit spots in 2D on ``device`` (picasso/localize.py
    :1682). ``parameters`` holds "Min. Net Gradient" and "Box Size".
    Returns the locs structured array, with the info chain when
    ``return_info``. ``fitting_method="avg"`` is not ported yet."""
    from picasso_torch.ops import fused as _fused

    if fitting_method == "avg":
        raise NotImplementedError(
            "fitting_method='avg' is not ported yet (ROADMAP queue 1 item "
            "4: avgroi.py); use 'gausslq' or 'gaussmle'"
        )
    if movie_info is None:
        movie_info = []
    if not all(
        np.isscalar(camera_info.get(k, 0))
        for k in ("Baseline", "Sensitivity", "Gain")
    ):
        raise NotImplementedError(
            "per-pixel camera calibration is not ported yet (ROADMAP "
            "queue 1 item 6: localize/fit2D)"
        )
    if "Pixelsize" not in camera_info:
        warnings.warn(
            "Camera info in fit2D does not contain 'Pixelsize'; "
            "assuming 130."
        )
        camera_info["Pixelsize"] = 130
    identifications, fits = _fused.localize_fused(
        movie,
        parameters["Min. Net Gradient"],
        parameters["Box Size"],
        camera_info,
        fitting_method=fitting_method,
        eps=eps,
        max_it=max_it,
        mle_method=mle_method,
        roi=roi,
        frame_bounds=frame_bounds,
        progress_callback=identification_progress_callback,
        device=device,
    )
    theta, crlb, ll, iters = fits
    box = parameters["Box Size"]
    if fitting_method == "gaussmle":
        locs = gaussmle.locs_from_fits(identifications, theta, crlb, ll,
                                       iters, box)
    else:
        locs = gausslq.locs_from_fits(identifications, theta, box,
                                      camera_info["Gain"] > 1)
    if callable(fit_progress_callback):
        fit_progress_callback(len(identifications))
    identify_info = {
        "Generated by": f"Picasso: v{__version__} Identify",
        "Min. Net Gradient": parameters["Min. Net Gradient"],
        "Box Size": box,
        "ROI": roi,
        "Frame Bounds": frame_bounds,
    }
    fit_info = {
        "Generated by": f"Picasso: v{__version__} Fit 2D",
        "Fit method": fitting_method,
    }
    if fitting_method == "gaussmle":
        fit_info["Convergence criterion"] = eps
        fit_info["Max iterations"] = max_it
    info = movie_info + [identify_info] + [fit_info | camera_info]
    if return_info:
        return locs, info
    return locs
