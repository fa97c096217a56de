"""The reference's own localize: identification, cut, photon
conversion, and the fit of the configuration's fitter (``fits/``), with
the locs table that fitter's program writes."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

from reference import identify as ref_identify

#: the reference fits, one file a fitter: ``fits/<fitting_method>.py``,
#: or ``fits/<fitting_method>.<mle_method>.py`` where the method is named
FITS_DIR = Path(__file__).resolve().parent / "fits"
_FITTERS: dict = {}


def fitter_name(fit: dict) -> str:
    return ".".join(str(fit[k]) for k in ("fitting_method", "mle_method")
                    if k in fit)


def fitter(fit: dict):
    """The reference fit of the configuration's fitter, found by name: a
    module with ``LOCS_DTYPE`` (the locs table the program writes) and
    ``fit(spots, fit)`` (the table's fit fields)."""
    name = fitter_name(fit)
    if name not in _FITTERS:
        path = FITS_DIR / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no reference fit for {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(
            "reference.fits." + name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _FITTERS[name] = module
    return _FITTERS[name]


#: the locs table of MLE fits, as ``localize`` writes it
LOCS_DTYPE = fitter({"fitting_method": "gaussmle",
                     "mle_method": "sigmaxy"}).LOCS_DTYPE


def ids_of(movie, fit: dict, dtype, device) -> dict:
    """The identifications of a whole movie: numpy frame, y, x, ng."""
    f, y, x, ng = ref_identify.identify(movie, fit["box"],
                                        fit["min_net_gradient"], dtype=dtype,
                                        device=device)
    return {"frame": f.cpu().numpy(), "y": y.cpu().numpy(),
            "x": x.cpu().numpy(),
            "net_gradient": ng.to(torch.float64).cpu().numpy()}


def fit_ids(movie: np.ndarray, ids: dict, fit: dict, camera: dict, dtype,
            device) -> dict:
    """The locs fields of the identifications ``ids`` (numpy frame, y,
    x, net_gradient): each spot's box cut from the movie, converted to
    photons as (raw - baseline) * sensitivity / gain, fitted by the
    configuration's reference fit, and put in camera pixels. Float64
    numpy columns."""
    box = fit["box"]
    h = box // 2
    off = np.arange(box) - h
    f, y, x = ids["frame"], ids["y"], ids["x"]
    raw = movie[f[:, None, None], y[:, None, None] + off[None, :, None],
                x[:, None, None] + off[None, None, :]]
    spots = torch.as_tensor(raw.astype(np.float64), device=device).to(dtype)
    spots = (spots - float(camera["Baseline"])) * (
        float(camera["Sensitivity"]) / float(camera["Gain"]))
    cols = fitter(fit).fit(spots, fit)
    cols["x"] = cols["x"] + x - h
    cols["y"] = cols["y"] + y - h
    return {"frame": f, "net_gradient": ids["net_gradient"], **cols}


def select(cols: dict, rows) -> dict:
    return {k: v[rows] for k, v in cols.items()}


def in_frames(frame: np.ndarray, frames: np.ndarray) -> np.ndarray:
    """The rows whose frame is one of ``frames``."""
    return np.isin(frame, frames)
