"""Astigmatic 3D: the z calibration and the z fit of every loc (Huang et
al., Science 2008).

Counterpart of picasso_tpu/zfit.py (calibrate_z :41, _fit_z_batched
:123, _fit_z :165, zfit :207, filter_z_fits :254,
axial_localization_precision_astig :273/:296, the aliases :346-394).
Each loc's z minimises (sqrt(sx) - sqrt(wx(z)))^2 + (sqrt(sy) -
sqrt(wy(z)))^2 over a 1-unit grid on [-1000, 1000] with a parabolic
refinement around the grid minimum. picasso_tpu forms the (N, Z) cost
of all locs at once under jax.jit; here it is plain torch on ``device``
over blocks of :data:`Z_ROWS` rows (each row's answer depends on no
other). Every operation rounds as XLA rounds it on the CPU: the K=2
product as fma(b, v, a u) and the refined target as one fused step,
both formed in f64 and rounded once, the square roots correctly rounded
(no TF32, no matmul). The refinement divides differences of costs near
their minimum, where one ulp moves z by up to a grid step, so this is
what makes the port's z equal picasso_tpu's, and the card's the CPU's,
bit for bit. The calibration polynomials and the precision lpz stay in
numpy, in picasso_tpu's dtypes. Locs are numpy structured arrays; the
fit appends the fields z, d_zcalib and lpz in picasso_tpu's column
order.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from picasso_torch import __version__, gaussmle, gausslq, lib

_Z_BOUND = 1000.0  # fit bounds in calibration units (picasso/zfit.py:359)
_Z_STEP = 1.0
#: rows of one block of the z-grid scan: a (Z_ROWS, 2001) f32 cost is
#: 128 MB, and the block's temporaries (two of them f64) about eight
#: times that
Z_ROWS = 16384


def _interpolate_nan(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, np.float64).copy()
    nans = np.isnan(arr)
    if nans.any() and not nans.all():
        idx = np.arange(len(arr))
        arr[nans] = np.interp(idx[nans], idx[~nans], arr[~nans])
    return arr


def _group_stats(frame: np.ndarray, values: np.ndarray, frames: np.ndarray):
    """Per-frame mean and sample variance (ddof 1) of ``values`` for each
    of ``frames``, NaN where a frame has no value (variance: fewer than
    two); taken in f64, rounded to the f32 of the column."""
    idx = np.searchsorted(frames, frame)
    n = np.bincount(idx, minlength=len(frames)).astype(np.float64)
    v = values.astype(np.float64)
    s = np.bincount(idx, weights=v, minlength=len(frames))
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = s / n
        ss = np.bincount(idx, weights=(v - mean[idx]) ** 2,
                         minlength=len(frames))
        var = np.where(n > 1, ss / (n - 1), np.nan)
    return (mean.astype(values.dtype).astype(np.float64),
            var.astype(values.dtype).astype(np.float64))


def calibrate_z(locs: np.ndarray, info: list[dict], d: float,
                magnification_factor: float, path: str | None = None,
                frame_bounds: tuple[int, int] | None = None) -> dict:
    """6th-order polynomials through the frame means of sx and sy of a
    z-stepped calibration stack, re-centred where the curves cross
    (picasso/zfit.py:46). Frames count down from the top of the scan;
    ``frame_bounds`` cut the full stack's axis, bounds inclusive. Locs
    farther from their frame's mean than its standard deviation are
    dropped first. Saved as YAML to ``path`` if given."""
    n_frames = lib.get_from_metadata(info, "Frames")
    frame_range = np.arange(n_frames)
    z_range = -(frame_range * d - (n_frames - 1) * d / 2)
    if frame_bounds is not None:
        lo = frame_bounds[0] or 0
        hi = frame_bounds[1] or (n_frames - 1)
        frame_range = frame_range[lo:hi + 1]
        z_range = z_range[lo:hi + 1]
        locs = locs[(locs["frame"] >= lo) & (locs["frame"] <= hi)]
    frame = locs["frame"].astype(np.int64)
    mean_sx, var_sx = _group_stats(frame, locs["sx"], frame_range)
    mean_sy, var_sy = _group_stats(frame, locs["sy"], frame_range)
    i = frame - frame_range[0]
    keep = (((locs["sx"] - mean_sx[i]) ** 2 < var_sx[i])
            & ((locs["sy"] - mean_sy[i]) ** 2 < var_sy[i]))
    locs, frame = locs[keep], frame[keep]
    mean_sx = _interpolate_nan(_group_stats(frame, locs["sx"], frame_range)[0])
    mean_sy = _interpolate_nan(_group_stats(frame, locs["sy"], frame_range)[0])
    cx = np.polyfit(z_range, mean_sx, 6)
    cy = np.polyfit(z_range, mean_sy, 6)
    z = np.linspace(z_range[0], z_range[-1], 10000)
    crossing = z[np.argmin(np.abs(np.polyval(cx, z) - np.polyval(cy, z)))]
    z_range = z_range - crossing
    cx = np.polyfit(z_range, mean_sx, 6)
    cy = np.polyfit(z_range, mean_sy, 6)
    calibration = {
        "X Coefficients": [float(_) for _ in cx],
        "Y Coefficients": [float(_) for _ in cy],
        "Number of frames": int(n_frames),
        "Step size in nm": float(d),
        "Magnification factor": float(magnification_factor),
        "Path": path if path is not None else "N/A",
        "Frame bounds": frame_bounds,
    }
    if path is not None:
        import yaml

        with open(path, "w") as f:
            yaml.dump(calibration, f)
    return calibration


def _fit_z_rows(sx, sy, u, v, c, z_grid):
    """argmin over the grid of (sqrt(sx) - u)^2 + (sqrt(sy) - v)^2 for
    each row, with the parabolic sub-grid step; (z, min target) f32.
    u, v, c = sqrt(wx), sqrt(wy), wx + wy at the grid points, NaN where
    the calibration is not positive. The cost is c - 2 (a u + b v), plus
    sx + sy at the end, as picasso_tpu's _fit_z_batched forms it."""
    # f32 sqrt correctly rounded (torch's CPU sqrt is not), through f64
    a, b = (torch.sqrt(s.double()).float()[:, None] for s in (sx, sy))
    # a u + b v as XLA's CPU dot rounds it, fma(b, v, a u): b v is exact
    # in f64, so the f64 sum rounded to f32 is the fused result (but for
    # a double rounding at an f32 midpoint); the target's step below is
    # fused alike
    cross = _fma(b, v[None, :], a * u[None, :])
    cost = c[None, :] - 2.0 * cross
    valid = torch.isfinite(c)[None, :] & torch.isfinite(cross)
    cost = torch.where(valid, cost, torch.inf)
    idx = torch.argmin(cost, dim=1)
    idx_c = idx.clamp(1, cost.shape[1] - 2)
    f0, f1, f2, fmin = (torch.gather(cost, 1, i[:, None])[:, 0]
                        for i in (idx_c - 1, idx_c, idx_c + 1, idx))
    denom = f0 - 2 * f1 + f2
    delta = torch.where((denom > 0) & torch.isfinite(f0) & torch.isfinite(f2),
                        0.5 * (f0 - f2) / denom, 0.0).clamp(-1.0, 1.0)
    z = z_grid[idx_c] + delta * (z_grid[1] - z_grid[0])
    target = torch.minimum(_fma(-0.25 * (f0 - f2), delta, f1), fmin)
    return z, target + sx + sy


def _fma(x, y, z):
    """x * y + z in f32 with one rounding, through f64."""
    return (x.double() * y.double() + z.double()).float()


def fit_z_grid(sx: np.ndarray, sy: np.ndarray, calibration: dict,
               device="cuda", rows: int = Z_ROWS):
    """The z-grid scan of :func:`_fit_z_rows` for every loc on
    ``device``, ``rows`` locs at a time; numpy f32 (z in calibration
    units, squared distance to the calibration curve)."""
    device = lib.resolve_device(device)
    cx = np.asarray(calibration["X Coefficients"], np.float64)
    cy = np.asarray(calibration["Y Coefficients"], np.float64)
    z_grid = np.arange(-_Z_BOUND, _Z_BOUND + _Z_STEP, _Z_STEP)
    wx, wy = np.polyval(cx, z_grid), np.polyval(cy, z_grid)
    ok = (wx > 0) & (wy > 0)
    grid = [torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        np.where(ok, np.sqrt(np.maximum(wx, 0)), np.nan),
        np.where(ok, np.sqrt(np.maximum(wy, 0)), np.nan),
        np.where(ok, wx + wy, np.nan), z_grid)]
    z = np.empty(len(sx), np.float32)
    sq_d = np.empty(len(sx), np.float32)
    for lo in range(0, len(sx), rows):
        part = [torch.from_numpy(np.ascontiguousarray(a[lo:lo + rows],
                                                      np.float32)).to(device)
                for a in (sx, sy)]
        zt, dt = _fit_z_rows(*part, *grid)
        z[lo:lo + rows] = zt.cpu().numpy()
        sq_d[lo:lo + rows] = dt.cpu().numpy()
    return z, sq_d


def _with_fields(locs: np.ndarray, cols: dict) -> np.ndarray:
    """``locs`` with the fields ``cols`` (name -> f32 values) set:
    overwritten where present, appended in order otherwise."""
    names = locs.dtype.names
    dtype = locs.dtype.descr + [(n, np.float32) for n in cols
                                if n not in names]
    out = np.empty(len(locs), dtype)
    for n in names:
        out[n] = locs[n]
    for n, values in cols.items():
        out[n] = values
    return out


def _fit_z(locs, info, calibration, magnification_factor, pixelsize,
           fitting_method="gausslq", filter=2, progress_callback=None,
           device="cuda"):
    """z, d_zcalib and lpz of every loc, then ensure_sanity and
    :func:`filter_z_fits` (picasso/zfit.py:327)."""
    cx = np.asarray(calibration["X Coefficients"], np.float64)
    cy = np.asarray(calibration["Y Coefficients"], np.float64)
    z, sq_d = fit_z_grid(locs["sx"], locs["sy"], calibration, device=device)
    locs = _with_fields(locs, {
        "z": (z.astype(np.float64) * magnification_factor).astype(np.float32),
        "d_zcalib": np.sqrt(np.maximum(sq_d.astype(np.float64), 0)).astype(
            np.float32),
        "lpz": np.nan,
    })
    locs["lpz"] = _axial_localization_precision_astig(
        locs, cx, cy, magnification_factor, pixelsize, fitting_method
    ).astype(np.float32)
    if callable(progress_callback):
        progress_callback(len(locs))
    return filter_z_fits(lib.ensure_sanity(locs, info), filter)


def zfit(
    locs: np.ndarray,
    info: list[dict],
    *,
    calibration: dict,
    magnification_factor: float | None = None,
    pixelsize: float | None = None,
    fitting_method: Literal["gausslq", "gaussmle"] = "gausslq",
    filter: int = 2,
    multiprocess: bool = False,
    progress_callback=None,
    abort_callback=None,
    device="cuda",
):
    """Fit z to every loc on ``device``; returns (locs, info chain with
    the Fit Z block) (picasso/zfit.py:465). ``multiprocess`` is accepted
    for the reference's signature."""
    assert fitting_method in ("gausslq", "gaussmle")
    assert filter >= 0
    assert isinstance(calibration, dict)
    if magnification_factor is None:
        magnification_factor = calibration["Magnification factor"]
    if pixelsize is None:
        pixelsize = lib.get_from_metadata(info, "Pixelsize", raise_error=True)
    if abort_callback is not None and abort_callback():
        return None, None
    locs = _fit_z(locs, info, calibration, magnification_factor, pixelsize,
                  fitting_method, filter, progress_callback, device)
    return locs, info + [{
        "Generated by": f"Picasso v{__version__} Fit Z",
        "Calibration": calibration,
        "Magnification factor": magnification_factor,
    }]


def filter_z_fits(locs: np.ndarray, range: int) -> np.ndarray:
    """Drop locs whose distance to the calibration curve is above
    ``range`` times its RMS (picasso/zfit.py:675)."""
    if "d_zcalib" not in locs.dtype.names:
        return locs
    if range > 0:
        rmsd = np.sqrt(np.nanmean(locs["d_zcalib"] ** 2))
        locs = locs[locs["d_zcalib"] <= range * rmsd]
    return locs


def axial_localization_precision_astig(locs, info, calibration,
                                       fitting_method="gausslq"):
    """Analytic lpz (Kowalewski, Reinhardt et al.; picasso/zfit.py:747)."""
    return _axial_localization_precision_astig(
        locs,
        np.asarray(calibration["X Coefficients"], np.float64),
        np.asarray(calibration["Y Coefficients"], np.float64),
        calibration["Magnification factor"],
        lib.get_from_metadata(info, "Pixelsize", raise_error=True),
        fitting_method,
    )


def _axial_localization_precision_astig(locs, cx, cy, magnification_factor,
                                        pixelsize, fitting_method="gausslq"):
    """lpz by propagating the sigma uncertainties through the
    calibration curves (picasso/zfit.py:805), in the dtypes picasso_tpu
    computes it in: the sigma terms in the columns' f32, the curves in
    f64."""
    # diverged fits (NaN, negative or huge widths) give NaN lpz, as in
    # picasso_tpu, and ensure_sanity drops them
    with np.errstate(all="ignore"):
        return _lpz(locs, cx, cy, magnification_factor, pixelsize,
                    fitting_method)


def _lpz(locs, cx, cy, magnification_factor, pixelsize, fitting_method):
    names = locs.dtype.names
    if fitting_method == "gausslq":
        unc = gausslq.sigma_uncertainty
    elif fitting_method == "gaussmle":
        unc = gaussmle.sigma_uncertainty
    else:
        raise ValueError("fitting_method must be 'gausslq' or 'gaussmle'.")
    if fitting_method == "gaussmle" and {"sx_unc", "sy_unc"} <= set(names):
        se_sx = locs["sx_unc"] * pixelsize
        se_sy = locs["sy_unc"] * pixelsize
    else:
        se_sx = unc(locs["sx"], locs["sy"], locs["photons"],
                    locs["bg"]) * pixelsize
        se_sy = unc(locs["sy"], locs["sx"], locs["photons"],
                    locs["bg"]) * pixelsize
    z = np.asarray(locs["z"] / magnification_factor)
    wx_calib = np.polyval(cx, z) * pixelsize
    wy_calib = np.polyval(cy, z) * pixelsize
    wx_prime = np.polyval(np.polyder(cx), z) * pixelsize
    wy_prime = np.polyval(np.polyder(cy), z) * pixelsize
    sqrt_wx_prime = wx_prime / (2 * np.sqrt(wx_calib))
    sqrt_wy_prime = wy_prime / (2 * np.sqrt(wy_calib))
    d_sqrt_wx = (1 / (2 * np.sqrt(locs["sx"] * pixelsize))) * se_sx
    d_sqrt_wy = (1 / (2 * np.sqrt(locs["sy"] * pixelsize))) * se_sy
    swxc2 = sqrt_wx_prime**2
    swyc2 = sqrt_wy_prime**2
    lpz = np.sqrt((swxc2 * d_sqrt_wx**2 + swyc2 * d_sqrt_wy**2)
                  / (swxc2 + swyc2) ** 2)
    return lpz * magnification_factor


def fit_z(locs, info, calibration, magnification_factor, pixelsize,
          fitting_method="gausslq", filter=2, progress_callback=None,
          device="cuda"):
    """The z fit of every loc (picasso/zfit.py:296)."""
    return _fit_z(locs, info, calibration, magnification_factor, pixelsize,
                  fitting_method, filter, progress_callback, device)


def fit_z_parallel(locs, info, calibration, magnification_factor, pixelsize,
                   fitting_method="gausslq", filter=2, asynch=False,
                   device="cuda"):
    """The reference farms locs to a process pool here
    (picasso/zfit.py:416); the grid scan covers every loc at once. With
    ``asynch`` the result comes as one finished future."""
    result = _fit_z(locs, info, calibration, magnification_factor, pixelsize,
                    fitting_method, filter, device=device)
    if asynch:
        return [gausslq._CompletedFuture(result)]
    return result


def locs_from_futures(futures, filter=2) -> np.ndarray:
    """Partial z-fit results joined and filtered (picasso/zfit.py:460)."""
    return filter_z_fits(np.concatenate([f.result() for f in futures]),
                         filter)


def axial_localization_precision(locs, info, calibration,
                                 fitting_method="gausslq",
                                 modality="astigmatic"):
    """Modality dispatch (picasso/zfit.py:706); astigmatic only."""
    assert modality == "astigmatic", "Only astigmatic 3D is supported."
    return axial_localization_precision_astig(locs, info, calibration,
                                              fitting_method)
