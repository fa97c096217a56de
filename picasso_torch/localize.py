"""Identify + fit spots: the ``identify``, ``fit2D``, ``localize`` and
``localize_3D`` entry points of the port, ``identify_in_image``, and the
summary database of ``localize -db``.

Counterpart of picasso_tpu/localize.py (_id_frame_chunk :60,
identify_in_image :71, identify_in_frame :82, identify_by_frame_number
:96, identify :134, picks_to_identifications :257, get_spots :290,
get_spots_raw :326, fit2D :346, fit :462, fit_async :473,
locs_from_fits :486, localize :516, localize_3D :668;
LOCALIZATION_COLUMNS :23, MEAN_COLS and SET_COLS :41, check_nena :736,
check_kinetics :749, check_drift :758, get_file_summary :779,
_db_filename :838, _save_file_summary :849, add_file_to_db :859,
local_maxima :875, gradient_at :889, net_gradient :898, identify_async
:913, identifications_from_futures :940,
locs_to_identifications :949, save_file_summary :976). ``localize`` with
a Gaussian fitter and a scalar camera runs the fused chain per frame
chunk (ops/fused.py) on ``device``: on a CUDA device through the
hand-written kernels, on the CPU through their plain PyTorch versions.
``avg``, and any fitter with a camera whose values are arrays, identify
(K4) and then fit2D; a lazy movie does so in one pass
(stream.identify_and_cut). A camera value that is an array (a 0-d
array, or a per-pixel map) converts ROIs to photons on the host with
numpy's broadcasting, as in JAX: a map that does not broadcast against
the (N, box, box) ROIs raises numpy's ValueError.
The fitters: ``gausslq`` and ``gausslq-gpu`` (the LM fit, the default),
``gaussmle`` (methods ``sigmaxy`` and ``sigma``) and ``avg``.

Identifications are numpy structured arrays (frame, x, y, net_gradient;
ops/fused._IDS_DTYPE), in the column order of the JAX package's
DataFrame.

Photon conversion follows picasso_tpu per route: the fused chain and the
fitters' raw-ROI route convert as (raw - baseline) * f32(sensitivity /
gain); ``get_spots`` of a u16 array as (raw - baseline) * (f32
sensitivity / f32 gain), picasso_tpu's native cut; every other route
(lazy movies, other dtypes, pre-cut ROIs for ``avg``) as ((raw -
baseline) * sensitivity) / gain, rounded after each step.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Literal

import numpy as np

from picasso_torch import __version__, avgroi, gausslq, gaussmle, lib
from picasso_torch.profiling import span

# f32 bytes per identification batch; frames per chunk adapt to the
# frame size (a 256x256 movie takes 244-frame chunks, evened to 256)
_ID_CHUNK_BYTES = 64e6

_GAUSS_METHODS = ("gausslq", "gausslq-gpu", "gaussmle")

# the localization columns by kind (picasso/localize.py:52-71); the
# summary database keeps the means and stds of MEAN_COLS and copies
# SET_COLS from the info
LOCALIZATION_COLUMNS = {
    "Base": ["frame", "x", "y", "photons", "sx", "sy", "bg", "lpx", "lpy",
             "ellipticity", "net_gradient"],
    "3D only": ["z", "d_zcalib", "lpz"],
    "Picked spots only": ["n_id"],
    "MLE only": ["log_likelihood", "iterations"],
}
MEAN_COLS = LOCALIZATION_COLUMNS["Base"] + LOCALIZATION_COLUMNS["3D only"]
SET_COLS = [
    "Frames", "Height", "Width", "Box Size", "Min. Net Gradient",
    "Pixelsize",
]
MAX_LOCS = int(1e6)


def _id_frame_chunk(height: int, width: int) -> int:
    return int(np.clip(_ID_CHUNK_BYTES / (height * width * 4), 16, 1024))


def _identify_info(minimum_ng, box, roi, frame_bounds) -> dict:
    return {
        "Generated by": f"Picasso: v{__version__} Identify",
        "Min. Net Gradient": minimum_ng,
        "Box Size": box,
        "ROI": roi,
        "Frame Bounds": frame_bounds,
    }


def _is_array(movie) -> bool:
    return isinstance(movie, np.ndarray) or hasattr(movie, "__array__")


def _scalar_camera(camera_info: dict) -> bool:
    return all(np.isscalar(camera_info.get(k, 0))
               for k in ("Baseline", "Sensitivity", "Gain"))


def _default_pixelsize(camera_info: dict) -> None:
    if "Pixelsize" not in camera_info:
        warnings.warn(
            "Camera info in fit2D does not contain 'Pixelsize'; "
            "assuming 130."
        )
        camera_info["Pixelsize"] = 130


def identify(
    movie,
    minimum_ng: float,
    box: int,
    *,
    roi: tuple[tuple[int, int], tuple[int, int]] | None = None,
    frame_bounds: tuple[int, int] | None = None,
    threaded: bool = True,
    progress_callback: Callable[[int], None] | Literal["console"] | None = None,
    abort_callback: Callable[[], bool] | None = None,
    return_info: bool = False,
    device="cuda",
):
    """Identify spots in a (possibly lazy) movie on ``device``
    (picasso/localize.py:639): chunks of frames through K4 and the
    compaction, the next chunk decoding in the background. Returns the
    frame-sorted identifications (with the identify info block when
    ``return_info``), or None if ``abort_callback()`` turns true. The
    upper frame bound is inclusive; ``threaded`` is accepted for the
    reference's signature."""
    from picasso_torch.ops.fused import make_ids
    from picasso_torch.ops.identify import compact
    from picasso_torch.ops.identify_cuda import identify_tiles
    from picasso_torch.stream import device_chunks

    device = lib.resolve_device(device)
    hits = []
    with contextlib.closing(device_chunks(
            movie, device, roi=roi, frame_bounds=frame_bounds,
            progress_callback=progress_callback,
            description="Identifying spots")) as chunks:
        for offset, chunk in chunks:
            if abort_callback is not None and abort_callback():
                return None
            hits.append((offset, *(a.cpu().numpy() for a in compact(
                *identify_tiles(chunk, minimum_ng, box), box))))
    ids = make_ids(hits, roi)
    if return_info:
        return ids, _identify_info(minimum_ng, box, roi, frame_bounds)
    return ids


def identify_in_image(image, minimum_ng: float, box: int, *, device="cuda"):
    """Local maxima and net gradients of one image through K4
    (picasso/localize.py:248): a 2D array, or a tensor, which stays on
    its own device. Returns numpy (y, x, net_gradient)."""
    import torch

    from picasso_torch.ops.identify import compact
    from picasso_torch.ops.identify_cuda import identify_tiles

    if isinstance(image, torch.Tensor):
        frames = image.to(torch.float32)[None].contiguous()
    else:
        frames = torch.from_numpy(np.ascontiguousarray(
            image, np.float32)[None]).to(lib.resolve_device(device))
    _, y, x, ng = compact(*identify_tiles(frames, minimum_ng, box), box)
    return (y.cpu().numpy().astype(np.int64),
            x.cpu().numpy().astype(np.int64),
            ng.cpu().numpy().astype(np.float32))


def _cut_on_device(movie, identifications, box: int, device) -> np.ndarray:
    """Raw (N, box, box) ROIs of an in-RAM movie, cut on ``device``
    (winfit_cuda.cut_rois_t) from chunks of frames uploaded once each,
    in the identifications' row order; u16 for a u16 movie, f32
    otherwise (ops/identify.upload_frames)."""
    import torch

    from picasso_torch.ops.identify import upload_frames
    from picasso_torch.ops.winfit_cuda import cut_rois_t

    movie = np.asarray(movie)
    frame = np.asarray(identifications["frame"], np.int64)
    n = len(frame)
    dtype = np.uint16 if movie.dtype == np.uint16 else np.float32
    out = np.empty((n, box, box), dtype)
    if not n:
        return out
    order = np.argsort(frame, kind="stable")
    step = _id_frame_chunk(*movie.shape[1:])
    groups = np.searchsorted(frame[order] // step,
                             np.unique(frame[order] // step))
    for lo, hi in zip(groups, [*groups[1:], n]):
        rows = order[lo:hi]
        first, last = frame[rows[0]], frame[rows[-1]]
        chunk = upload_frames(movie[first:last + 1], device)
        hit = [frame[rows] - first] + [np.asarray(identifications[c])[rows]
                                       for c in ("y", "x")]
        f, y, x = (torch.from_numpy(a.astype(np.int64)).to(device)
                   for a in hit)
        out[rows] = cut_rois_t(chunk, f, y, x, box).permute(
            2, 0, 1).cpu().numpy()
    return out


def get_spots(movie, identifications: np.ndarray, box: int,
              camera_info: dict, device="cuda") -> np.ndarray:
    """(N, box, box) ROIs in photons (picasso/localize.py:1115): from an
    in-RAM movie cut on ``device``, from a lazy one on the host. A
    C-contiguous u16 array with a scalar camera converts with one factor
    (picasso_tpu's native cut), anything else in three roundings with
    numpy's broadcasting (ops/identify.to_photons)."""
    from picasso_torch.ops.identify import to_photons, to_photons_one_factor

    raw = get_spots_raw(movie, identifications, box, device=device)
    if (_scalar_camera(camera_info) and _is_array(movie)
            and np.asarray(movie).dtype == np.uint16
            and np.asarray(movie).flags.c_contiguous):
        return to_photons_one_factor(raw, camera_info)
    return to_photons(raw, camera_info)


def get_spots_raw(movie, identifications: np.ndarray, box: int,
                  device="cuda") -> np.ndarray:
    """(N, box, box) raw ROIs without photon conversion
    (picasso_tpu/localize.py:326): from an in-RAM movie cut on
    ``device`` (u16 or f32), from a lazy one on the host in its dtype
    (ops/identify.cut_spots_numpy)."""
    from picasso_torch.ops.identify import cut_spots_numpy

    if _is_array(movie):
        return _cut_on_device(movie, identifications, box,
                              lib.resolve_device(device))
    return cut_spots_numpy(
        movie, *(np.asarray(identifications[c], np.int64)
                 for c in ("frame", "x", "y")), box)


def fit2D(
    movie,
    movie_info: list[dict],
    camera_info: dict,
    identifications: np.ndarray,
    box: int,
    fitting_method: Literal[
        "gausslq", "gausslq-gpu", "gaussmle", "avg"
    ] = "gausslq",
    eps: float = 0.001,
    max_it: int = 100,
    mle_method: Literal["sigma", "sigmaxy"] = "sigmaxy",
    multiprocess: bool = True,
    progress_callback: Callable[[int], None] | Literal["console"] | None = None,
    abort_callback: Callable[[], bool] | None = None,
    spots: np.ndarray | None = None,
    device="cuda",
):
    """Fit the identified spots in 2D on ``device``
    (picasso/localize.py:1344): MLE on the route of ops/mle_cuda.ROI_FITS
    (gaussmle.gaussmle), LM through K3 (gausslq.fit_spots, max_it 30 as
    in picasso_tpu, the route of ops/lq_cuda.ROI_FIT), avg by
    a device sum (avgroi.fit_spots). ``spots`` are pre-cut raw ROIs (from
    stream.identify_and_cut), so the movie is not read again. A camera
    whose values are arrays converts the ROIs on the host (get_spots,
    ops/identify.to_photons), a scalar one on the device. Returns
    (locs, fit info block | camera_info), or (None, {}) if aborted;
    ``multiprocess`` is accepted for the reference's signature."""
    from picasso_torch.ops.identify import to_photons

    assert isinstance(movie_info, list), "movie_info must be a list"
    assert isinstance(camera_info, dict), "camera_info must be a dict"
    assert isinstance(box, int) and box > 0, "box must be a positive integer"
    assert fitting_method in (*_GAUSS_METHODS, "avg")
    assert eps > 0 and max_it > 0
    assert mle_method in ("sigma", "sigmaxy")
    device = lib.resolve_device(device)
    _default_pixelsize(camera_info)
    # the raw ROIs convert on the device only for a scalar camera
    raw = fitting_method in _GAUSS_METHODS and _scalar_camera(camera_info)
    conversion = (float(camera_info["Baseline"]),
                  float(camera_info["Sensitivity"])
                  / float(camera_info["Gain"])) if raw else None
    if spots is not None:
        if not (raw and spots.dtype == np.uint16):
            spots, conversion = to_photons(spots, camera_info), None
    elif raw and (movie if isinstance(movie, np.ndarray)
                  else np.asarray(movie[0])).dtype == np.uint16:
        spots = get_spots_raw(movie, identifications, box, device=device)
    else:
        spots = get_spots(movie, identifications, box, camera_info,
                          device=device)
        conversion = None
    if abort_callback is not None and abort_callback():
        return None, {}
    em = camera_info["Gain"] > 1
    if fitting_method in ("gausslq", "gausslq-gpu"):
        theta = gausslq.fit_spots(spots, progress_callback,
                                  photon_conversion=conversion, device=device)
        locs = gausslq.locs_from_fits(identifications, theta, box, em)
    elif fitting_method == "gaussmle":
        locs = gaussmle.locs_from_fits(identifications, *gaussmle.gaussmle(
            spots, eps, max_it, mle_method, progress_callback,
            photon_conversion=conversion, device=device), box)
    else:
        theta = avgroi.fit_spots(spots, progress_callback, device=device)
        locs = avgroi.locs_from_fits(identifications, theta, box, em)
    fit_info = {
        "Generated by": f"Picasso: v{__version__} Fit 2D",
        "Fit method": fitting_method,
    }
    if fitting_method == "gaussmle":
        fit_info["Convergence criterion"] = eps
        fit_info["Max iterations"] = max_it
    return locs, fit_info | camera_info


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
    threaded: bool = True,
    identification_progress_callback=None,
    fit_progress_callback=None,
    return_info: bool = False,
    perf: dict | None = None,
    device="cuda",
):
    """Identify and fit spots in 2D on ``device`` (picasso/localize.py
    :1682). ``parameters`` holds "Min. Net Gradient" and "Box Size".
    Returns the locs structured array, with the info chain when
    ``return_info``; None if the fused chain was aborted. The Gaussian
    fitters with a scalar camera run the fused chain, which fills
    ``perf`` (ops/fused.localize_fused) and runs in the span
    ``picasso.localize``, its locs table in ``picasso.localize.
    locs_table`` (profiling.span); ``avg``, or a camera whose values
    are arrays, runs ``identify`` + ``fit2D``, or one pass of
    stream.identify_and_cut + ``fit2D`` on a lazy movie."""
    from picasso_torch.ops import fused as _fused

    if movie_info is None:
        movie_info = []
    _default_pixelsize(camera_info)
    minimum_ng, box = parameters["Min. Net Gradient"], parameters["Box Size"]
    if fitting_method == "avg" or not _scalar_camera(camera_info):
        device = lib.resolve_device(device)
        spots = None
        if _is_array(movie):
            identifications = identify(
                movie, minimum_ng, box, roi=roi, frame_bounds=frame_bounds,
                progress_callback=identification_progress_callback,
                device=device)
        else:
            from picasso_torch import stream

            identifications, spots = stream.identify_and_cut(
                movie, minimum_ng, box, roi=roi, frame_bounds=frame_bounds,
                progress_callback=identification_progress_callback,
                device=device)
        locs, fit_info = fit2D(
            movie, movie_info, camera_info, identifications, box,
            fitting_method=fitting_method, eps=eps, max_it=max_it,
            mle_method=mle_method, progress_callback=fit_progress_callback,
            spots=spots, device=device)
    else:
        with span("picasso.localize"):
            identifications, fits = _fused.localize_fused(
                movie, minimum_ng, box, camera_info,
                fitting_method=fitting_method, eps=eps, max_it=max_it,
                mle_method=mle_method, roi=roi, frame_bounds=frame_bounds,
                progress_callback=identification_progress_callback,
                perf=perf, device=device,
            )
            if identifications is None:
                return None
            theta, crlb, ll, iters = fits
            with span("picasso.localize.locs_table"):
                if fitting_method == "gaussmle":
                    locs = gaussmle.locs_from_fits(identifications, theta,
                                                   crlb, ll, iters, box)
                else:
                    locs = gausslq.locs_from_fits(identifications, theta, box,
                                                  camera_info["Gain"] > 1)
        if callable(fit_progress_callback):
            fit_progress_callback(len(identifications))
        fit_info = {
            "Generated by": f"Picasso: v{__version__} Fit 2D",
            "Fit method": fitting_method,
        }
        if fitting_method == "gaussmle":
            fit_info["Convergence criterion"] = eps
            fit_info["Max iterations"] = max_it
        fit_info = fit_info | camera_info
    info = movie_info + [_identify_info(minimum_ng, box, roi, frame_bounds),
                         fit_info]
    if return_info:
        return locs, info
    return locs


def localize_3D(
    movie,
    *,
    movie_info: list[dict],
    camera_info: dict,
    box: int,
    minimum_ng: float,
    calibration_3d,
    roi=None,
    frame_bounds=None,
    fitting_method: Literal["gausslq", "gausslq-gpu", "gaussmle"] = "gausslq",
    eps: float = 0.001,
    max_it: int = 100,
    mle_method: Literal["sigma", "sigmaxy"] = "sigmaxy",
    multiprocess: bool = True,
    identification_progress_callback=None,
    fit_progress_callback=None,
    fit_z_progress_callback=None,
    device="cuda",
):
    """2D localization, then the astigmatic z fit of each loc (Huang et
    al., Science 2008; picasso/localize.py:1818), both on ``device``.
    ``calibration_3d`` is the calibration dict or the path of its YAML.
    Returns (locs with z, d_zcalib and lpz, info chain)."""
    from picasso_torch import zfit

    locs, info = localize(
        movie, camera_info, {"Min. Net Gradient": minimum_ng, "Box Size": box},
        roi=roi, frame_bounds=frame_bounds, movie_info=movie_info,
        fitting_method=fitting_method, eps=eps, max_it=max_it,
        mle_method=mle_method, threaded=multiprocess,
        identification_progress_callback=identification_progress_callback,
        fit_progress_callback=fit_progress_callback, return_info=True,
        device=device,
    )
    if isinstance(calibration_3d, str):
        import yaml

        with open(calibration_3d) as f:
            calibration_3d = yaml.full_load(f)
    return zfit.zfit(
        locs, info, calibration=calibration_3d,
        pixelsize=camera_info.get("Pixelsize", 130),
        fitting_method="gaussmle" if fitting_method == "gaussmle"
        else "gausslq",
        progress_callback=fit_z_progress_callback, device=device,
    )


# ---------------------------------------------------------------------------
# The per-file summary database of ``localize -db``
# (picasso/localize.py:2037-2258)
# ---------------------------------------------------------------------------


def check_nena(locs: np.ndarray, info, callback=None, *, device="cuda"
               ) -> float:
    """NeNA localization precision in px of the first MAX_LOCS locs, NaN
    if its fit fails (picasso/localize.py:2037). The distance histogram
    runs on ``device`` and raises as it would; only the host fit's
    failure gives NaN (JAX catches every exception)."""
    from picasso_torch import postprocess

    locs = locs[:MAX_LOCS]
    hist = postprocess._next_frame_neighbor_distance_histogram(
        locs, callback, device=device)
    try:
        _, nena_px = postprocess._nena_fit(locs, *hist)
    except Exception:
        nena_px = float("nan")
    return float(nena_px)


def check_kinetics(locs: np.ndarray, info, *, device="cuda") -> float:
    """Mean binding-event length in frames of the first MAX_LOCS locs,
    linked at link's defaults on ``device`` (picasso/localize.py:2073)."""
    from picasso_torch import postprocess

    linked = postprocess.link(locs[:MAX_LOCS], info, device=device)
    return float(np.mean(linked["len"]))


def check_drift(locs: np.ndarray, info, callback=None, *, device="cuda"):
    """Mean RCC drift (x, y) in px, on locs subsampled to MAX_LOCS, in
    segments of a tenth of the movie (picasso/localize.py:2096), on
    ``device``. ``callback`` is accepted for JAX's signature."""
    from picasso_torch import postprocess

    locs = locs[::max(1, len(locs) // MAX_LOCS)]
    n_frames = lib.get_from_metadata(info, "Frames")
    drift, _ = postprocess.undrift(locs, info, max(1, n_frames // 10),
                                   device=device)
    return float(drift["x"].mean()), float(drift["y"].mean())


def get_file_summary(file: str, file_hdf: str | None, drift=None,
                     len_mean=None, nena=None, *, device="cuda") -> dict:
    """The summary of one localization file (picasso/localize.py:2144):
    :func:`_summary` of the locs in ``file_hdf`` (by default ``<file
    base>_locs.hdf5``)."""
    import os

    from picasso_torch import io

    if file_hdf is None:
        file_hdf = os.path.splitext(file)[0] + "_locs.hdf5"
    locs, info = io.load_locs(file_hdf)
    return _summary(locs, info, file, file_hdf, drift, len_mean, nena,
                    device=device)


def _summary(locs: np.ndarray, info, file: str, file_hdf: str, drift=None,
             len_mean=None, nena=None, *, device="cuda") -> dict:
    """The summary row of ``locs``: the mean and std of each of MEAN_COLS
    (NaN for a missing column), the SET_COLS settings from the info (NaN
    if absent), the checks (NeNA, event length, drift; each computed on
    ``device`` unless given), the counts, the file names and the times
    of ``file`` and of the entry."""
    import os
    from datetime import datetime

    summary = {}
    for col in MEAN_COLS:
        mean, std = (lib.series_mean_std(locs[col])
                     if col in locs.dtype.names else (np.nan, np.nan))
        summary[col + "_mean"] = float(mean)
        summary[col + "_std"] = float(std)
    for col in SET_COLS:
        for inf in info:
            if col in inf:
                summary[col.lower()] = inf[col]
    for col in SET_COLS:
        summary.setdefault(col.lower(), float("nan"))
    nena_px = check_nena(locs, info, device=device) if nena is None else nena
    if len_mean is None:
        len_mean = check_kinetics(locs, info, device=device)
    drift_x, drift_y = (check_drift(locs, info, device=device)
                        if drift is None else drift)
    summary["len_mean"] = len_mean
    summary["n_locs"] = len(locs)
    summary["locs_frame"] = len(locs) / summary["frames"]
    summary["drift_x"] = drift_x
    summary["drift_y"] = drift_y
    summary["nena_px"] = nena_px
    summary["nena_nm"] = nena_px * summary["pixelsize"]
    summary["filename"] = os.path.normpath(file)
    summary["filename_hdf"] = file_hdf
    summary["file_created"] = datetime.fromtimestamp(os.path.getmtime(file))
    summary["entry_created"] = datetime.now()
    return summary


def _db_filename() -> str:
    """The SQLite database under ~/.picasso (picasso/localize.py:2221)."""
    import os

    picasso_dir = os.path.join(os.path.expanduser("~"), ".picasso")
    os.makedirs(picasso_dir, exist_ok=True)
    return os.path.abspath(os.path.join(picasso_dir, "app_0410.db"))


def _missing(value) -> bool:
    return value is None or (isinstance(value, (float, np.floating))
                             and np.isnan(value))


def _sql_type(value) -> str:
    """The SQLite type that pandas' DataFrame.to_sql declares for a
    one-row object column holding ``value`` (pandas.io.sql.SQLiteTable
    _sql_type_name: lib.infer_dtype with missing values skipped; a column
    of NaN/None only is TEXT), for the kinds a summary holds."""
    from datetime import datetime

    if _missing(value):
        return "TEXT"
    if isinstance(value, (bool, np.bool_, int, np.integer)):
        return "INTEGER"
    if isinstance(value, (float, np.floating)):
        return "REAL"
    if isinstance(value, datetime):
        return "TIMESTAMP"
    return "TEXT"


def _sql_value(value):
    """``value`` as pandas' to_sql hands it to sqlite3: NaN and None as
    NULL, a datetime as ``isoformat(" ")`` text, anything else as it is
    (a numpy scalar then goes in as its bytes, a BLOB)."""
    from datetime import datetime

    if _missing(value):
        return None
    if isinstance(value, datetime):
        return value.isoformat(" ")
    return value


def _quote(name: str) -> str:
    return '"' + name.replace('"', '""') + '"'


def _save_file_summary(summary: dict) -> None:
    """Append the summary as one row of the ``files`` table of
    :func:`_db_filename` (picasso/localize.py:2242) with sqlite3 alone:
    the table, if it is new, gets the columns in the summary's order with
    the types pandas' to_sql declares (:func:`_sql_type`); an existing
    table keeps its own; the values go in as pandas passes them
    (:func:`_sql_value`)."""
    import sqlite3

    cols = ", ".join(_quote(k) for k in summary)
    con = sqlite3.connect(_db_filename())
    try:
        with con:
            exists = con.execute(
                "SELECT name FROM sqlite_master WHERE type IN ('table', "
                "'view') AND name=?", ("files",)).fetchone()
            if not exists:
                con.execute("CREATE TABLE " + _quote("files") + " (\n"
                            + ",\n  ".join(f"{_quote(k)} {_sql_type(v)}"
                                            for k, v in summary.items())
                            + "\n)")
            con.execute(
                f"INSERT INTO {_quote('files')} ({cols}) VALUES "
                f"({', '.join('?' * len(summary))})",
                [_sql_value(v) for v in summary.values()])
    finally:
        con.close()


def add_file_to_db(file: str, file_hdf: str | None, drift=None,
                   len_mean=None, nena=None, *, device="cuda") -> None:
    """Summarize a localization file on ``device`` and append it to the
    summary database (picasso/localize.py:2250)."""
    _save_file_summary(get_file_summary(file, file_hdf, drift, len_mean,
                                        nena, device=device))


def save_file_summary(summary: dict) -> None:
    """Alias of :func:`_save_file_summary` (picasso/localize.py:2233)."""
    _save_file_summary(summary)


# ---------------------------------------------------------------------------
# The legacy identify and fit API (deprecated names in the reference)
# ---------------------------------------------------------------------------


#: identifications for refitting picks or locs: the columns and dtypes of
#: the JAX package's DataFrames
_REFIT_IDS_DTYPE = [("frame", np.int64), ("x", np.int64), ("y", np.int64),
                    ("net_gradient", np.float64), ("n_id", np.int64)]


def _ids(n: int) -> np.ndarray:
    from picasso_torch.ops.fused import _IDS_DTYPE

    return np.zeros(n, dtype=_IDS_DTYPE)


def identify_in_frame(frame, minimum_ng: float, box: int, roi=None, *,
                      device="cuda"):
    """Local maxima and net gradients of one frame through K4 on
    ``device``, cropped to ``roi`` and shifted back
    (picasso/localize.py:295). Returns numpy (y, x, net_gradient)."""
    from picasso_torch.ops.identify import identify_frames

    _, y, x, ng = identify_frames(np.asarray(frame, np.float32)[None],
                                  minimum_ng, box, roi=roi, device=device)
    return y, x, ng


def identify_by_frame_number(movie, minimum_ng: float, box: int,
                             frame_number: int, *, roi=None,
                             frame_bounds=None, lock=None, device="cuda"):
    """The identifications (frame, x, y, net_gradient) of one frame of a
    movie (picasso/localize.py:340); none if the frame lies outside
    ``frame_bounds``, whose upper bound is inclusive. ``lock`` is
    accepted for the reference's signature."""
    device = lib.resolve_device(device)
    if frame_bounds is not None:
        lo = frame_bounds[0] if frame_bounds[0] is not None else 0
        hi = frame_bounds[1] if frame_bounds[1] is not None else len(movie)
        if not (max(lo, 0) <= frame_number <= min(hi, len(movie))):
            return _ids(0)
    y, x, ng = identify_in_frame(np.asarray(movie[frame_number]), minimum_ng,
                                 box, roi, device=device)
    ids = _ids(len(x))
    ids["frame"] = frame_number
    ids["x"], ids["y"], ids["net_gradient"] = x, y, ng
    return ids


def picks_to_identifications(picks, *, n_frames: int | None = None,
                             drift: np.ndarray | None = None) -> np.ndarray:
    """One identification a frame at each circular pick's centre (shifted
    by ``drift``, a structured array with x and y a frame, rounded to
    pixels), for refitting picked positions (picasso/localize.py:752):
    (frame, x, y, net_gradient 0, n_id the pick's index)."""
    if n_frames is None and drift is not None:
        n_frames = len(drift)
    if n_frames is None:
        raise ValueError("Either n_frames or drift must be provided.")
    ids = np.zeros(len(picks) * n_frames, _REFIT_IDS_DTYPE)
    for n_id, (x0, y0) in enumerate(picks):
        x = np.full(n_frames, x0, dtype=float)
        y = np.full(n_frames, y0, dtype=float)
        if drift is not None:
            x = x + drift["x"]
            y = y + drift["y"]
        rows = slice(n_id * n_frames, (n_id + 1) * n_frames)
        ids["frame"][rows] = np.arange(n_frames)
        ids["x"][rows] = np.round(x).astype(int)
        ids["y"][rows] = np.round(y).astype(int)
        ids["n_id"][rows] = n_id
    return ids


def local_maxima(frame, box: int, *, device="cuda"):
    """(y, x) of the local maxima of one frame (picasso/localize.py:84):
    the maxima map of ops/identify.identify_maps on ``device``, before
    any threshold or tile reduction."""
    import torch

    from picasso_torch.ops.identify import identify_maps

    maxima, _ = identify_maps(torch.from_numpy(np.ascontiguousarray(
        frame, np.float32)[None]).to(lib.resolve_device(device)), box)
    return np.nonzero(maxima[0].cpu().numpy())


def gradient_at(frame, y, x, i):
    """Central-difference gradient (gy, gx) at one pixel
    (picasso/localize.py:137)."""
    frame = np.asarray(frame)
    gy = float(frame[y + 1, x]) - float(frame[y - 1, x])
    gx = float(frame[y, x + 1]) - float(frame[y, x - 1])
    return gy, gx


def net_gradient(frame, y, x, box, uy, ux):
    """Net gradient at the given maxima on the host, f32 sums of f64
    terms (picasso/localize.py:184)."""
    frame = np.asarray(frame, np.float64)
    half = box // 2
    ng = np.zeros(len(x), np.float32)
    for i, (yi, xi) in enumerate(zip(y, x)):
        for ki, k in enumerate(range(yi - half, yi + half + 1)):
            for li, m in enumerate(range(xi - half, xi + half + 1)):
                if k == yi and m == xi:
                    continue
                gy, gx = gradient_at(frame, k, m, i)
                ng[i] += gy * uy[ki, li] + gx * ux[ki, li]
    return ng


def identify_async(movie, minimum_ng, box, *, roi=None, frame_bounds=None,
                   device="cuda"):
    """The reference's threaded launcher (picasso/localize.py:482) as a
    finished call: ``identify`` on ``device``, returned as ([n_frames],
    [a completed future of the identifications])."""
    from picasso_torch.gausslq import _CompletedFuture

    ids = identify(movie, minimum_ng, box, roi=roi,
                   frame_bounds=frame_bounds, device=device)
    return [len(movie)], [_CompletedFuture(ids)]


def identifications_from_futures(futures) -> np.ndarray:
    """The futures' identifications joined and sorted stably by frame
    (picasso/localize.py:457)."""
    ids = np.concatenate([f.result() for f in futures])
    return ids[np.argsort(ids["frame"], kind="stable")]


def locs_to_identifications(locs: np.ndarray, movie_info: list[dict],
                            n_frames: int) -> np.ndarray:
    """Each loc's pixel as identifications over the frames within
    ``n_frames`` of its own, for refitting (picasso/localize.py:857):
    (frame, x, y, net_gradient 101, n_id the loc's index + 1). As in the
    JAX package a loc within ``n_frames`` of either end of the movie is
    dropped, not clipped."""
    assert isinstance(n_frames, int) and n_frames >= 0
    max_frames = lib.get_from_metadata(movie_info, "Frames",
                                       raise_error=True)
    f = locs["frame"].astype(np.int64)
    keep = np.nonzero((f > n_frames) & (f < max_frames - n_frames))[0]
    span = 2 * n_frames + 1
    ids = np.zeros(len(keep) * span, _REFIT_IDS_DTYPE)
    ids["frame"] = (f[keep][:, None]
                    + np.arange(-n_frames, n_frames + 1)).ravel()
    for c in ("x", "y"):
        ids[c] = np.repeat(np.round(locs[c][keep].astype(np.float64)), span)
    ids["net_gradient"] = 101.0
    ids["n_id"] = np.repeat(keep + 1, span)
    return ids


def fit(movie, camera_info: dict, identifications: np.ndarray, box: int,
        eps: float = 0.001, max_it: int = 100, method="sigmaxy", *,
        device="cuda") -> np.ndarray:
    """The reference's deprecated MLE fit (picasso/localize.py:1148):
    get_spots and gaussmle.gaussmle on ``device``, then the legacy
    :func:`locs_from_fits`. Held to the JAX package, which reads
    gaussmle's theta (x, y, photons, bg, sx, sy) in the legacy order (y,
    x, ..., sy, sx) without the box offset, so its x/y in-box offsets
    and sx/sy are swapped and it lies box // 2 px further along both
    axes than fit2D (ROADMAP queue 3)."""
    device = lib.resolve_device(device)
    spots = get_spots(movie, identifications, box, camera_info,
                      device=device)
    theta, CRLBs, likelihoods, iterations = gaussmle.gaussmle(
        spots, eps, max_it, method=method, device=device)
    return locs_from_fits(identifications, theta, CRLBs, likelihoods,
                          iterations, box)


def fit_async(movie, camera_info: dict, identifications: np.ndarray,
              box: int, eps: float = 0.001, max_it: int = 100,
              method="sigmaxy", *, device="cuda"):
    """The reference's deprecated MLE launcher (picasso/localize.py:1214)
    as a finished call: ([N], thetas, CRLBs, likelihoods, iterations)."""
    device = lib.resolve_device(device)
    lib.deprecation_warning(
        "Deprecation warning: this function will be removed in v0.11.0."
        " Use localize.fit2D instead."
    )
    spots = get_spots(movie, identifications, box, camera_info,
                      device=device)
    return gaussmle.gaussmle_async(spots, eps, max_it, method=method,
                                   device=device)


def locs_from_fits(identifications: np.ndarray, theta, CRLBs, likelihoods,
                   iterations, box) -> np.ndarray:
    """The legacy locs table (picasso/localize.py:1281): theta's columns
    read as (y, x, photons, bg, sy, sx), added to the identifications'
    pixels without a box offset, sorted by frame."""
    return lib.locs_table([
        ("frame", np.uint32, identifications["frame"]),
        ("x", np.float32, theta[:, 1] + identifications["x"]),
        ("y", np.float32, theta[:, 0] + identifications["y"]),
        ("photons", np.float32, theta[:, 2]),
        ("sx", np.float32, theta[:, 5]),
        ("sy", np.float32, theta[:, 4]),
        ("bg", np.float32, theta[:, 3]),
        ("lpx", np.float32, np.sqrt(CRLBs[:, 1])),
        ("lpy", np.float32, np.sqrt(CRLBs[:, 0])),
        ("net_gradient", np.float32, identifications["net_gradient"]),
        ("likelihood", np.float32, likelihoods),
        ("iterations", np.int32, iterations),
    ], "frame")
