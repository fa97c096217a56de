"""Shared utilities of the port: metadata access, the locs sanity filter
on numpy structured arrays, progress reporting and device resolution.

Counterpart of the parts of picasso_tpu/lib.py that the localize path
and the picks use (get_from_metadata :41, ensure_sanity :82,
is_loc_at :133, locs_at :143, check_if_in_polygon :148, merge_locs
:110, check_if_in_rectangle :170, the pick areas :181-204 and :534,
get_pick_rectangle_corners :213, overwrite_metadata :235,
unfold_localizations_square :249, sync_groups :288, the kinetic fits
:307-334, find_local_minima :345, minimize_shifts :445,
deprecation_warning :479, locs_in_polygon :513, locs_in_rectangle :524,
permutation_test :618, plot_cumulative_exponential_fit :641,
MockProgress :670, progress_reporter :731, get_pick_polygon_corners
:828) and of its readers' and filters' helpers (AutoDict :28,
append_to_rec :100, calculate_optimal_bins :364, hist2d :412,
extract_filter_steps :550, apply_filter_steps :605, locs_glob_map :748,
REQUIRED_COLUMNS :784, hist2d_numba :807, is_path_available :814,
remove_from_rec :836, unpack_calibration :849), and the rest of its
names: n_futures_done :484, is_hexadecimal, get_colors :502,
TqdmProgress :695, the constants and type aliases :781-799, the sound
notification settings :886-920, the QC plots :941-1065 (matplotlib
imported inside each), ProgressDialog :1100 (a tqdm bar), ProgressType
and QtOnlyAttributeError :1157-1186. Locs are
numpy structured arrays with the record layout of the HDF5 ``"locs"``
dataset; :func:`series_mean_std` gives a column the mean and std that
the JAX package's pandas columns give.
"""

from __future__ import annotations

import csv
import glob
import os
import sys
from typing import Any, Callable, Literal

import numpy as np
import torch


# Columns that every locs table must carry for 3D analysis
REQUIRED_COLUMNS = ["frame", "x", "y", "z", "lpx", "lpy", "lpz"]


class AutoDict(dict):
    """A dict that creates nested AutoDicts on missing keys
    (picasso/lib.py:608)."""

    def __getitem__(self, key):
        try:
            return super().__getitem__(key)
        except KeyError:
            value = type(self)()
            self[key] = value
            return value


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and no card
    is visible (the port never moves work to the CPU by itself), and for
    a mesh (picasso_torch.parallel.mesh.Mesh), which only the entry
    points that split their work take (parallel/mesh.route): a mesh is
    never narrowed to one of its devices."""
    if hasattr(device, "devices") and hasattr(device, "run"):
        raise TypeError(f"{device!r}: this entry point runs on one device; "
                        "pass one of the mesh's devices")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch versions on the CPU"
        )
    return device


def get_from_metadata(info: list[dict] | dict, key: Any, default=None, *,
                      raise_error: bool = False):
    """``key`` from a metadata dict or an info chain (list of dicts,
    searched newest to oldest, skipping falsy values like the
    reference, picasso/lib.py:878); with ``raise_error`` a key that is
    not found raises KeyError."""
    if isinstance(info, dict):
        if raise_error and key not in info:
            raise KeyError(f"Key '{key}' not found in metadata.")
        return info.get(key, default)
    if isinstance(info, list):
        for block in info[::-1]:
            if val := block.get(key):
                return val
        if raise_error:
            raise KeyError(f"Key '{key}' not found in metadata.")
        return default
    raise ValueError("info must be a dict or a list of dicts.")


_NONNEGATIVE_COLUMNS = (
    "x", "y", "lpx", "lpy", "lpz", "photons", "ellipticity", "sx", "sy",
)


def ensure_sanity(locs: np.ndarray, info: list[dict]) -> np.ndarray:
    """Drop rows with a non-finite value, rows outside the field of view
    and rows with a negative precision/photon/width column
    (picasso/lib.py:1786)."""
    return locs[sane_rows(locs, info)]


def sane_rows(locs: np.ndarray, info: list[dict]) -> np.ndarray:
    """The boolean mask of the rows that :func:`ensure_sanity` keeps."""
    for key in ("Width", "Height", "Frames"):
        if get_from_metadata(info, key) is None:
            raise KeyError(f"Metadata is missing required key: '{key}'")
    keep = np.ones(len(locs), dtype=bool)
    for name in locs.dtype.names:
        if np.issubdtype(locs.dtype[name], np.floating):
            keep &= np.isfinite(locs[name])
    keep &= locs["x"] < get_from_metadata(info, "Width")
    keep &= locs["y"] < get_from_metadata(info, "Height")
    for name in _NONNEGATIVE_COLUMNS:
        if name in locs.dtype.names:
            keep &= locs[name] >= 0
    return keep


def locs_table(cols: list, sort_key: str) -> np.ndarray:
    """A locs structured array from ``cols`` [(name, dtype, values)] of
    4-byte columns, sorted stably by ``sort_key`` (skipped when already
    in order, as hits are frame-major).

    The columns are filled as contiguous rows of one (n_cols, n) buffer
    and transposed once into the record layout, which is ~5x faster than
    writing record fields (or gathering records) one at a time at a
    million rows."""
    n = len(cols[0][2])
    buf = np.empty((len(cols), n), dtype=np.float32)
    for row, (_, dt, values) in zip(buf, cols):
        row.view(dt)[:] = values
    k = buf[[name for name, _, _ in cols].index(sort_key)].view(np.uint32)
    if np.any(k[1:] < k[:-1]):
        buf = buf[:, np.argsort(k, kind="stable")]
    dtype = np.dtype([(name, dt) for name, dt, _ in cols])
    return np.ascontiguousarray(buf.T).view(dtype)[:, 0]


def append_to_rec(locs: np.ndarray, data, name: str) -> np.ndarray:
    """``locs`` with the field ``name`` set to ``data`` in its dtype: in
    place of an existing field of that name (its position kept, as a
    pandas column assignment does), else appended (picasso/lib.py:1660).
    A new array; ``locs`` is not changed."""
    data = np.asarray(data)
    names = locs.dtype.names
    dtype = [(n, data.dtype if n == name else locs.dtype[n]) for n in names]
    if name not in names:
        dtype.append((name, data.dtype))
    out = np.empty(len(locs), dtype)
    for n in names:
        if n != name:
            out[n] = locs[n]
    out[name] = data
    return out


def drop_fields(locs: np.ndarray, names) -> np.ndarray:
    """``locs`` without the fields ``names``, the others in order."""
    out = np.empty(len(locs), [(n, locs.dtype[n]) for n in locs.dtype.names
                               if n not in names])
    for n in out.dtype.names:
        out[n] = locs[n]
    return out


def remove_from_rec(rec_array, name):
    """Deprecated recarray column removal (picasso/lib.py:2087)."""
    from numpy.lib.recfunctions import drop_fields as _drop

    deprecation_warning(
        "remove_from_rec is deprecated: localization tables are pandas"
        " DataFrames now, so drop columns with"
        " locs.drop(columns='name') instead. The recarray helper will"
        " go away in a future release."
    )
    return _drop(rec_array, name, usemask=False, asrecarray=True)


def merge_locs(locs_list: list[np.ndarray],
               increment_frames: bool = False) -> np.ndarray:
    """Concatenate locs tables as pd.concat does (picasso/lib.py:1700);
    with ``increment_frames`` each table's frames start after the
    previous table's last (in the frame column's own dtype, as pandas
    adds the offset). The fields are the union: the first table's in its
    order, then each new one in order of appearance. A field missing from
    a table is NaN there; its dtype is the common dtype of the tables
    that have it (``np.result_type``), made float64 when that is an
    integer dtype and some table lacks the field, as pandas fills a gap
    in an integer column."""
    if not locs_list:
        raise ValueError("No objects to concatenate")
    if increment_frames:
        shifted, offset = [], 0
        for locs in locs_list:
            locs = locs.copy()
            locs["frame"] = locs["frame"] + offset
            offset = int(locs["frame"].max()) + 1 if len(locs) else offset
            shifted.append(locs)
        locs_list = shifted
    names = list(dict.fromkeys(n for locs in locs_list
                               for n in locs.dtype.names))
    dtype = []
    for n in names:
        have = [locs.dtype[n] for locs in locs_list if n in locs.dtype.names]
        dt = np.result_type(*have)
        if len(have) < len(locs_list) and dt.kind != "f":
            if dt.kind not in "iu":
                raise ValueError(
                    f"merge_locs: field {n!r} ({dt}) is missing from a "
                    "table, and pandas would make it an object column")
            dt = np.dtype(np.float64)
        dtype.append((n, dt))
    out = np.empty(sum(len(locs) for locs in locs_list), dtype)
    start = 0
    for locs in locs_list:
        stop = start + len(locs)
        for n in names:
            out[n][start:stop] = (locs[n] if n in locs.dtype.names
                                  else np.nan)
        start = stop
    return out


def series_mean_std(values: np.ndarray):
    """pandas' Series.mean() and Series.std() (NaN skipped, ddof 1) of a
    locs column, in its arithmetic, as numpy scalars: a float column sums
    its mean in its own type and its variance in f64 by two passes,
    rounded to its type before the root; an integer column works in
    f64."""
    v = np.asarray(values)
    with np.errstate(all="ignore"):
        if v.dtype.kind == "f":
            ok = ~np.isnan(v)
            v = np.where(ok, v, v.dtype.type(0))
            count = v.dtype.type(ok.sum())
            mean = v.sum(dtype=v.dtype) / count
        else:
            ok = np.ones(len(v), bool)
            count = np.float64(len(v))
            mean = v.sum(dtype=np.float64) / count
            v = v.astype(np.float64)
        if count <= 1:
            return mean, v.dtype.type(np.nan)
        avg = v.sum(dtype=np.float64) / count
        sqr = np.where(ok, (avg - v) ** 2, 0.0)
        var = v.dtype.type(sqr.sum(dtype=np.float64) / (count - 1))
    return mean, np.sqrt(var)


def minimize_shifts(shifts_x: np.ndarray, shifts_y: np.ndarray,
                    shifts_z: np.ndarray | None = None):
    """Per-segment shifts from all-pairs relative shifts (n, n) by least
    squares, the RCC "redundancy" step (picasso/lib.py:2034): the pair ->
    interval incidence matrix solved with pinv, then cumulative sums from
    the first segment. Returns (shift_y, shift_x), and shift_z when
    ``shifts_z`` is given."""
    n = shifts_x.shape[0]
    pairs = [shifts_y, shifts_x] + ([] if shifts_z is None else [shifts_z])
    rij = np.zeros((n * (n - 1) // 2, len(pairs)))
    A = np.zeros((n * (n - 1) // 2, n - 1))
    k = 0
    for i in range(n - 1):
        for j in range(i + 1, n):
            rij[k] = [p[i, j] for p in pairs]
            A[k, i:j] = 1
            k += 1
    Dj = np.linalg.pinv(A) @ rij
    return tuple(np.insert(np.cumsum(Dj[:, d]), 0, 0)
                 for d in range(len(pairs)))


def group_rows(group: np.ndarray) -> tuple[np.ndarray, list[np.ndarray]]:
    """(the sorted group ids, each group's rows in ascending order)."""
    order = np.argsort(group, kind="stable")
    ids, starts = np.unique(group[order], return_index=True)
    return ids, np.split(order, starts[1:])


def group_mean(values: np.ndarray, rows: list) -> np.ndarray:
    """pandas' groupby mean of a float column, one value a group: the
    rows summed in order in the column's dtype with Kahan compensation,
    over the count in that dtype."""
    ft = values.dtype.type
    counts = np.array([len(r) for r in rows])
    sumx = np.zeros(len(rows), ft)
    comp = np.zeros(len(rows), ft)
    pos = np.zeros((len(rows), counts.max(initial=0)), np.int64)
    for g, r in enumerate(rows):
        pos[g, :len(r)] = r
    for k in range(counts.max(initial=0)):
        g = np.nonzero(counts > k)[0]
        yv = values[pos[g, k]] - comp[g]
        t = sumx[g] + yv
        c = t - sumx[g] - yv
        comp[g] = np.where(np.isnan(c), ft(0), c)
        sumx[g] = t
    return sumx / counts.astype(ft)


def find_local_minima(arr: np.ndarray) -> np.ndarray:
    """Indices of strict local minima of a 1D array
    (picasso/lib.py:1243)."""
    arr = np.asarray(arr)
    if len(arr) < 3:
        return np.array([], dtype=int)
    return np.nonzero((arr[1:-1] < arr[:-2]) & (arr[1:-1] < arr[2:]))[0] + 1


def is_loc_at(x: float, y: float, locs: np.ndarray, r: float) -> np.ndarray:
    """Boolean mask of the locs within radius r of (x, y)
    (picasso/lib.py:1836), in the dtype of the x and y columns."""
    dx = locs["x"] - x
    dy = locs["y"] - y
    return dx * dx + dy * dy < r * r


def locs_at(x: float, y: float, locs: np.ndarray, r: float) -> np.ndarray:
    """The locs within radius r of (x, y) (picasso/lib.py:1861)."""
    return locs[is_loc_at(x, y, locs, r)]


def check_if_in_polygon(x, y, X, Y) -> np.ndarray:
    """Ray-casting point-in-polygon test, vectorized over the points
    (picasso/lib.py:1885), in f64."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    inside = np.zeros(len(x), dtype=bool)
    j = len(X) - 1
    for i in range(len(X)):
        cond = (Y[i] > y) != (Y[j] > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = (X[j] - X[i]) * (y - Y[i]) / (Y[j] - Y[i]) + X[i]
        inside ^= cond & (x < xint)
        j = i
    return inside


def check_if_in_rectangle(x, y, X, Y) -> np.ndarray:
    """Point-in-(rotated)-rectangle test through the polygon test
    (picasso/lib.py:1956)."""
    return check_if_in_polygon(x, y, X, Y)


def get_pick_rectangle_corners(start_x: float, start_y: float, end_x: float,
                               end_y: float, width: float):
    """The 4 corners ([x1..x4], [y1..y4]) of a rectangle pick given by
    its centre line and width."""
    if end_x == start_x:
        alpha = np.pi / 2
    else:
        alpha = np.arctan((end_y - start_y) / (end_x - start_x))
    dx = width * np.sin(alpha) / 2
    dy = width * np.cos(alpha) / 2
    return ([start_x - dx, start_x + dx, end_x + dx, end_x - dx],
            [start_y + dy, start_y - dy, end_y - dy, end_y + dy])


def get_pick_polygon_corners(pick):
    """X and Y corner coordinates of a closed pick polygon, or (None,
    None) if the pick is not closed (picasso/lib.py:2158)."""
    if len(pick) < 3 or pick[0] != pick[-1]:
        return None, None
    return [p[0] for p in pick], [p[1] for p in pick]


def polygon_area(X, Y) -> float:
    """Shoelace area of the polygon with corners (X, Y), in f64
    (picasso/lib.py:2228)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    return 0.5 * abs(np.dot(X, np.roll(Y, -1)) - np.dot(Y, np.roll(X, -1)))


def pick_areas_polygon(picks: list) -> np.ndarray:
    """Areas of polygon picks; a pick of fewer than 3 corners is left
    out (picasso/lib.py:2303)."""
    areas = []
    for pick in picks:
        pick = np.asarray(pick)
        if len(pick) < 3:
            continue
        areas.append(polygon_area(pick[:, 0], pick[:, 1]))
    return np.array(areas)


def pick_areas_circle(picks: list, r: float) -> np.ndarray:
    """Areas of circular picks of radius ``r`` (picasso/lib.py:2270)."""
    return np.pi * r**2 * np.ones(len(picks))


def pick_areas_rectangle(picks: list, w: float) -> np.ndarray:
    """Areas of rectangular picks ((start, end), width ``w``)
    (picasso/lib.py:2285)."""
    return np.array([np.hypot(xe - xs, ye - ys) * w
                     for (xs, ys), (xe, ye) in picks])


def pick_areas(pick_shape: str, picks: list,
               pick_size: float | None = None) -> np.ndarray:
    """Areas of picks of any shape in camera px^2 (picasso/lib.py:2303);
    ``pick_size`` is a circle's diameter, a rectangle's width or a
    square's side. An unknown shape raises ValueError."""
    if pick_shape == "Circle":
        return pick_areas_circle(picks, pick_size / 2)
    if pick_shape == "Rectangle":
        return pick_areas_rectangle(picks, pick_size)
    if pick_shape == "Polygon":
        return pick_areas_polygon(picks)
    if pick_shape == "Square":
        return pick_size**2 * np.ones(len(picks))
    raise ValueError(f"Unknown pick shape: {pick_shape}")


def locs_in_polygon(locs: np.ndarray, X, Y) -> np.ndarray:
    """The locs within the polygon with corners (X, Y)."""
    return locs[check_if_in_polygon(locs["x"], locs["y"], X, Y)]


def locs_in_rectangle(locs: np.ndarray, X, Y) -> np.ndarray:
    """The locs within the (rotated) rectangle with corners (X, Y)."""
    return locs[check_if_in_rectangle(locs["x"], locs["y"], X, Y)]


def overwrite_metadata(info: list[dict], key, value) -> list[dict]:
    """A deep copy of ``info`` with ``key`` set in the newest block that
    holds it, else in the last block (picasso/lib.py:918)."""
    from copy import deepcopy

    info = deepcopy(info)
    for block in info[::-1]:
        if key in block:
            block[key] = value
            return info
    info[-1][key] = value
    return info


def unfold_localizations_square(locs: np.ndarray, info: list[dict], *,
                                n_square: int = 10, spacing: float = 1):
    """Tile the groups onto a square grid of ``n_square`` columns,
    ``spacing`` px apart (picasso/lib.py:2547). Returns (locs, info with
    the new Width and Height). In JAX's pandas arithmetic: the groups
    renumbered 0.. in sorted order (int64), each group's mean
    (:func:`group_mean`) taken from x + Width / 2 in the column's dtype,
    then the
    grid offsets added in f64 (so x and y become f64) and the whole
    field moved by its mean and then its minimum."""
    if "group" not in locs.dtype.names:
        raise AssertionError("Localizations must contain a 'group' column.")
    _, rows = group_rows(locs["group"])
    group = np.empty(len(locs), np.int64)
    for new, r in enumerate(rows):
        group[r] = new
    cols = {"group": group}
    centre = {"x": get_from_metadata(info, "Width", raise_error=True) / 2,
              "y": get_from_metadata(info, "Height", raise_error=True) / 2}
    offset = {"x": np.mod(group, n_square) * spacing,
              "y": np.floor(group / n_square) * spacing}
    for c in ("x", "y"):
        v = locs[c]
        v = (v + v.dtype.type(centre[c])) - group_mean(v, rows)[group]
        v = v + offset[c]
        v = v - v.sum() / len(v)
        cols[c] = v + np.abs(v.min())
    out = np.empty(len(locs), [(n, cols[n].dtype if n in cols else
                                locs.dtype[n]) for n in locs.dtype.names])
    for n in locs.dtype.names:
        out[n] = cols[n] if n in cols else locs[n]
    info = overwrite_metadata(info, "Width", int(np.ceil(out["x"].max())))
    info = overwrite_metadata(info, "Height", int(np.ceil(out["y"].max())))
    return out, info


def sync_groups(locs: list[np.ndarray]) -> list[np.ndarray]:
    """Each table with only the groups that every table holds
    (picasso/lib.py:2616)."""
    if not all("group" in loc.dtype.names for loc in locs):
        raise AssertionError(
            "All localization lists must contain a 'group' column.")
    unique = [np.unique(loc["group"]) for loc in locs]
    common = np.array(sorted(set(unique[0]).intersection(*unique)))
    return [loc[np.isin(loc["group"], common)] for loc in locs]


def cumulative_exponential(x, a: float, t: float, c: float):
    """a (1 - exp(-x / t)) + c, the model of a binding-kinetics CDF."""
    return a * (1 - np.exp(-x / t)) + c


def fit_cum_exp(data) -> dict:
    """A cumulative exponential fit to the sorted durations ``data`` by
    scipy's curve_fit within bounds (picasso/lib.py:1273)."""
    from scipy import optimize

    data = np.sort(np.asarray(data, dtype=np.float64))
    n = len(data)
    y = np.arange(1, n + 1)
    data_min, data_max = data.min(), data.max()
    p0 = [n, float(np.mean(data)), data_min]
    bounds = ([0, data_min, 0], [np.inf, data_max, np.inf])
    popt, _ = optimize.curve_fit(cumulative_exponential, data, y, p0=p0,
                                 bounds=bounds)
    return {"best_values": {"a": popt[0], "t": popt[1], "c": popt[2]},
            "data": data,
            "best_fit": cumulative_exponential(data, *popt)}


def estimate_kinetic_rate(data) -> float:
    """The mean bright or dark time of ``data``: the time constant of
    :func:`fit_cum_exp` from three distinct values, else the mean
    (picasso/lib.py:1325)."""
    data = np.asarray(data, dtype=np.float64)
    if len(data) > 2:
        if data.max() - data.min() == 0:
            return float(np.nanmean(data))
        return float(fit_cum_exp(data)["best_values"]["t"])
    return float(np.nanmean(data))


def permutation_test(arr1, arr2, iterations: int = 1000):
    """Two-sample KS permutation test: (the observed statistic, the
    permutation p-value, scipy's KS p-value); the permutations come from
    the global np.random stream, as in JAX (picasso/lib.py
    permutation_test)."""
    from scipy import stats

    arr1, arr2 = np.asarray(arr1), np.asarray(arr2)
    n1 = len(arr1)
    combined = np.concatenate([arr1, arr2])
    obs_d, ks_pval = stats.ks_2samp(arr1, arr2)
    null = np.empty(iterations)
    for i in range(iterations):
        shuffled = np.random.permutation(combined)
        null[i], _ = stats.ks_2samp(shuffled[:n1], shuffled[n1:])
    p_perm = float(np.sum(null >= obs_d) / iterations)
    return float(obs_d), p_perm, float(ks_pval)


def plot_cumulative_exponential_fit(data, fit_result: dict, fig=None,
                                    ax=None):
    """The sorted data and the fit of :func:`fit_cum_exp`
    (picasso/lib.py:1360); matplotlib is imported here."""
    import matplotlib.pyplot as plt

    if fig is None or ax is None:
        fig, ax = plt.subplots()
    else:
        ax.clear()
    srt = np.sort(np.asarray(data))
    ax.plot(srt, np.arange(1, len(srt) + 1), ".", label="data")
    ax.plot(fit_result["data"], fit_result["best_fit"], label="fit")
    t = fit_result["best_values"]["t"]
    ax.set_title(f"mean time: {t:.1f} frames")
    ax.set_xlabel("time (frames)")
    ax.set_ylabel("cumulative counts")
    ax.legend()
    return fig


def deprecation_warning(message: str) -> None:
    """Print a deprecation notice (picasso/lib.py convention)."""
    print(message)


def n_futures_done(futures) -> int:
    """Count finished futures (picasso/lib.py:2083)."""
    return sum(f.done() for f in futures)


def is_hexadecimal(text: str) -> bool:
    """True if text is a #RRGGBB hex colour."""
    if not isinstance(text, str) or not text.startswith("#"):
        return False
    if len(text) != 7:
        return False
    try:
        int(text[1:], 16)
        return True
    except ValueError:
        return False


def get_colors(n_channels: int) -> list[tuple[float, float, float]]:
    """Evenly hue-spaced RGB colours for multichannel display."""
    import colorsys

    return [colorsys.hsv_to_rgb(i / n_channels, 1.0, 1.0)
            for i in range(n_channels)]


class MockProgress:
    """No-op progress reporter (picasso/lib.py:426)."""

    def __init__(self, *a, **kw):
        pass

    def set_value(self, value):
        pass

    def update(self, n=1):
        pass

    def close(self):
        pass

    def zero_progress(self, description: str | None = None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ConsoleProgress(MockProgress):
    """Progress as one rewritten line on stderr."""

    def __init__(self, total: int, description: str = ""):
        self.total = max(int(total), 1)
        self.description = description
        self.value = 0

    def set_value(self, value):
        self.value = int(value)
        sys.stderr.write(
            f"\r{self.description}: {self.value}/{self.total}"
        )
        sys.stderr.flush()

    def __exit__(self, *exc):
        sys.stderr.write("\n")
        sys.stderr.flush()
        return False


class TqdmProgress:
    """tqdm-backed progress reporter (picasso/lib.py:464)."""

    def __init__(self, total: int, description: str = "", **kw):
        from tqdm import tqdm

        self._tqdm = tqdm(total=total, desc=description, **kw)
        self._value = 0

    def set_value(self, value: int):
        delta = value - self._value
        if delta > 0:
            self._tqdm.update(delta)
            self._value = value

    def update(self, n: int = 1):
        self._value += n
        self._tqdm.update(n)

    def close(self):
        self._tqdm.close()

    def zero_progress(self, description: str | None = None):
        if description is not None:
            self._tqdm.set_description(description)
        self._tqdm.reset()
        self._value = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ProgressDialog:
    """Headless stand-in for the reference's Qt progress dialog
    (picasso/lib.py:307): its constructor and methods (``set_value``,
    ``zero_progress``, ``close``, ``get_iterator``) over a tqdm bar."""

    def __init__(self, description, minimum, maximum, parent=None):
        from tqdm import tqdm

        self.description_base = description
        self._minimum = minimum
        self._maximum = maximum
        self._bar = tqdm(total=maximum - minimum, desc=description,
                         leave=False)
        self._value = minimum

    def value(self):
        return self._value

    def maximum(self):
        return self._maximum

    def set_value(self, value):
        self._value = value
        self._bar.n = value - self._minimum
        self._bar.refresh()

    def setLabelText(self, description):
        self.description_base = description
        self._bar.set_description(description)

    def zero_progress(self, description=None):
        if description:
            self.setLabelText(description)
        self.set_value(self._minimum)

    def get_iterator(self, start=None, end=None):
        start = self._value if start is None else start
        end = self._maximum if end is None else end
        return range(start, end)

    def close(self):
        self._bar.close()

    def closeEvent(self, event=None):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


ProgressType = ProgressDialog | MockProgress | TqdmProgress


def progress_reporter(
    progress: Callable[[int], None] | Literal["console"] | None,
    total: int,
    description: str = "",
):
    """The reference's progress_callback convention ("console" |
    callable | None) as a reporter object."""
    if progress == "console":
        return ConsoleProgress(total, description)
    return MockProgress()


# --- histograms -------------------------------------------------------------


def calculate_optimal_bins(data: np.ndarray, max_n_bins: int | None = None,
                           sample_size: int = 1_000_000) -> np.ndarray:
    """Display bin edges sized by the Freedman–Diaconis rule (width = 2
    IQR n^(-1/3); picasso/lib.py:1540). The IQR comes from a subsample
    drawn with default_rng(0) above ``sample_size`` values; integer data
    never bins finer than 1, and the first edge sits half a bin below the
    minimum."""
    data = np.asarray(data)
    n = len(data)
    if n == 0:
        return np.array([0.0, 1.0])
    is_float = data.dtype.kind == "f"
    lo = np.nanmin(data) if is_float else data.min()
    hi = np.nanmax(data) if is_float else data.max()
    sample = data
    if n > sample_size:
        idx = np.random.default_rng(0).choice(n, sample_size, replace=False)
        sample = data[idx]
    if is_float:
        sample = sample[np.isfinite(sample)]
        if not len(sample):
            return np.array([lo - 1.0, hi + 1.0])
    q1, q3 = np.quantile(sample, [0.25, 0.75])
    iqr = q3 - q1
    if iqr == 0:
        return np.array([data[0] - 1.0, data[0] + 1.0])
    width = 2.0 * iqr / np.cbrt(n)
    if data.dtype.kind in "ui":
        width = max(width, 1)
    start = lo - width / 2
    try:
        n_bins = int((hi - start) / width)
    except (ValueError, OverflowError):
        n_bins = 10
    if max_n_bins:
        n_bins = min(n_bins, max_n_bins)
    return np.linspace(start, hi, n_bins)


def hist2d(x, y, x_min: float, x_max: float, y_min: float, y_max: float,
           nx: int, ny: int) -> np.ndarray:
    """Uniform-bin 2D histogram on the host, counts[ix, iy]; values on
    the right edge fall into the last bin, as in np.histogram2d
    (picasso/lib.py:1602)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    finite = np.isfinite(x) & np.isfinite(y)
    x, y = x[finite], y[finite]
    dx = (x_max - x_min) / nx
    dy = (y_max - y_min) / ny
    ix = ((x - x_min) / dx).astype(np.int64)
    iy = ((y - y_min) / dy).astype(np.int64)
    ix[ix == nx] = nx - 1
    iy[iy == ny] = ny - 1
    keep = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    counts = np.bincount(ix[keep] * ny + iy[keep], minlength=nx * ny)
    return counts.reshape(nx, ny)


def hist2d_numba(x, y, x_min, x_max, y_min, y_max, nx, ny):
    """:func:`hist2d` under the reference's name (picasso/lib.py:1603)."""
    return hist2d(x, y, x_min, x_max, y_min, y_max, nx, ny)


# --- filters recorded in the info chain --------------------------------------


def extract_filter_steps(info: list[dict], current_columns):
    """The [min, max] ranges that Filter stages recorded in the info
    chain (intersected where a field is filtered twice), the fields they
    removed, and the filtered fields the table no longer has
    (picasso/lib.py:923)."""
    current = set(current_columns)
    ranges: dict[str, list[float]] = {}
    to_remove: list[str] = []
    missing: list[str] = []

    def add(col, lo, hi):
        if col not in current:
            missing.append(col)
            return
        lo, hi = float(lo), float(hi)
        if col in ranges:
            ranges[col][0] = max(ranges[col][0], lo)
            ranges[col][1] = min(ranges[col][1], hi)
        else:
            ranges[col] = [lo, hi]

    for d in info:
        if not isinstance(d, dict):
            continue
        if "Filter" not in str(get_from_metadata(d, "Generated by",
                                                 default="")):
            continue
        entries = d.get("Filters", None)
        if isinstance(entries, list):
            # the Filter app's list of {Column, Min, Max}
            for e in entries:
                if e.get("Column") is not None:
                    add(e["Column"], e["Min"], e["Max"])
            continue
        for key, value in d.items():
            if key == "Generated by":
                continue
            if key == "Removed columns" and isinstance(value, list):
                to_remove.extend(c for c in value if c in current)
            elif (isinstance(value, (list, tuple)) and len(value) == 2
                  and all(isinstance(v, (int, float)) for v in value)):
                add(key, *value)
    return ranges, to_remove, missing


def apply_filter_steps(locs: np.ndarray, info: list[dict]):
    """Apply the filters recorded in the info chain
    (:func:`extract_filter_steps`; picasso/lib.py:998): each range
    keeps the values strictly inside it. Returns (locs, ranges,
    removed fields, missing fields)."""
    ranges, to_remove, missing = extract_filter_steps(info,
                                                      locs.dtype.names)
    for field, (xmin, xmax) in ranges.items():
        locs = locs[(locs[field] > xmin) & (locs[field] < xmax)]
    if to_remove:
        locs = drop_fields(locs, to_remove)
    return locs, ranges, to_remove, missing


# --- files ------------------------------------------------------------------


def write_csv(path: str, columns: list[str], rows) -> None:
    """A CSV as pandas' to_csv writes it: a header row, then ``rows`` of
    strings, quoted where needed, each line ending in a newline."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows(rows)


def csv_strings(values) -> np.ndarray:
    """A column's cells as pandas' to_csv writes them without a
    float_format: the shortest repr of each value in the column's own
    dtype (an f32 0.1 as "0.1"), NaN as an empty cell."""
    values = np.asarray(values)
    out = values.astype(str)
    if values.dtype.kind == "f":
        out[np.isnan(values)] = ""
    return out


def write_table(path: str, table: dict) -> None:
    """``pd.DataFrame(table).to_csv(path, index=False)`` of a dict of
    equal-length columns. Numeric cells need no quoting, so a numeric
    table of two or more columns is joined as text, which is several
    times faster than csv's writer; other tables go through it."""
    cells = [csv_strings(v) for v in table.values()]
    if len(cells) < 2 or any(np.asarray(v).dtype.kind not in "biuf"
                             for v in table.values()):
        write_csv(path, list(table), zip(*cells))
        return
    with open(path, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerow(list(table))
        f.writelines(",".join(row) + "\n"
                     for row in zip(*(c.tolist() for c in cells)))


def locs_glob_map(func: Callable, pattern: str, args=(), kwargs=None,
                  extension: str = "") -> list:
    """``func(locs, info, path, *args, **kwargs)`` on every locs file that
    matches ``pattern``; with ``extension`` each result (locs, info) is
    saved as ``<base>_<extension>.hdf5`` (picasso/lib.py:2112)."""
    from picasso_torch import io

    results = []
    for path in glob.glob(pattern):
        locs, info = io.load_locs(path)
        result = func(locs, info, path, *args, **(kwargs or {}))
        if extension:
            out_locs, out_info = result
            io.save_locs(os.path.splitext(path)[0] + "_" + extension
                         + ".hdf5", out_locs, out_info)
        results.append(result)
    return results


def is_path_available(path, *, check_ext="", parent=None):
    """For ``path``, or its base with each extension of ``check_ext``,
    whether nothing exists there yet (picasso/lib.py:1121). ``parent``
    (the reference's Qt overwrite prompt) is accepted and never
    prompts."""
    if check_ext:
        if isinstance(check_ext, str):
            check_ext = [check_ext]
        paths = [os.path.splitext(path)[0] + ext for ext in check_ext]
    else:
        paths = [path]
    return [not os.path.exists(p) for p in paths]


def unpack_calibration(calibration, pixelsize):
    """Deprecated 3D-calibration unpacking for G5M: per-z spot
    width/height from the polynomial coefficients, the z grid in camera
    pixels, and the magnification factor (picasso/lib.py:1488)."""
    deprecation_warning(
        "unpack_calibration is deprecated and slated for removal:"
        " 3D G5M now consumes the x/y polynomial coefficients"
        " directly and no longer needs the unpacked grid."
    )
    cx = calibration["X Coefficients"]
    cy = calibration["Y Coefficients"]
    z_step_size = calibration["Step size in nm"]
    n_frames = calibration["Number of frames"]
    mag_factor = calibration["Magnification factor"]
    z_total_range = (n_frames - 1) * z_step_size
    z_range = -(np.arange(n_frames) * z_step_size - z_total_range / 2)
    spot_size = np.stack((np.polyval(cx, z_range), np.polyval(cy, z_range)))
    return spot_size, z_range / pixelsize, mag_factor


# --- constants and type aliases (picasso/lib.py:46-83) ----------------------

SOUND_NOTIFICATION_DURATION = 60  # seconds

IntArray1D = np.ndarray
IntArray2D = np.ndarray
IntArray3D = np.ndarray
FloatArray1D = np.ndarray
FloatArray2D = np.ndarray
FloatArray3D = np.ndarray
BoolArray1D = np.ndarray
BoolArray2D = np.ndarray
Array3x3 = np.ndarray
# strings, as in the JAX package: the port never imports pandas
SeriesOrFloatArray1D = "pd.Series | np.ndarray"
SeriesOrIntArray1D = "pd.Series | np.ndarray"


# --- sound notifications: the settings without Qt (picasso/lib.py:765-840)


def _sound_notification_dir() -> str:
    return os.path.join(os.path.dirname(os.path.realpath(__file__)), "gui",
                        "notification_sounds")


def get_sound_notification_path():
    """Path of the configured notification sound, or None when unset,
    missing, or not an mp3/wav (picasso/lib.py:765)."""
    from picasso_torch import io

    settings = io.load_user_settings()
    if "Sound_notification" not in settings:
        settings["Sound_notification"]["filename"] = None
        io.save_user_settings(settings)
    filename = settings["Sound_notification"]["filename"]
    if filename is None:
        return None
    path = os.path.join(_sound_notification_dir(), filename)
    if not os.path.isfile(path):
        return None
    if os.path.splitext(filename)[1].lower() not in (".mp3", ".wav"):
        return None
    return path


def get_available_sound_notifications():
    """File names of the bundled notification sounds, after "None"
    (picasso/lib.py:795)."""
    sounds_dir = _sound_notification_dir()
    filenames = []
    if os.path.isdir(sounds_dir):
        filenames = sorted(
            f for f in os.listdir(sounds_dir)
            if os.path.isfile(os.path.join(sounds_dir, f))
            and os.path.splitext(f)[1].lower() in (".mp3", ".wav"))
    return ["None"] + filenames


def set_sound_notification(selection) -> None:
    """Keep the selected notification sound in the user settings
    (picasso/lib.py:815): a file name, or an object with
    ``objectName()`` as the reference's Qt actions have."""
    from picasso_torch import io

    if hasattr(selection, "objectName"):
        selection = selection.objectName()
    if selection == "None":
        selection = None
    settings = io.load_user_settings()
    settings["Sound_notification"]["filename"] = selection
    io.save_user_settings(settings)


# --- QC plots (picasso/lib.py:1385, :2381, :2504) ---------------------------


def plot_trace(locs: np.ndarray, info, *, fig=None, include_photons=True,
               return_trace=False):
    """Per-frame trace of one binding site: x, y, ON/OFF and photons
    (picasso/lib.py:1385)."""
    import matplotlib.pyplot as plt

    n_rows = 4 if include_photons else 3
    if fig is None:
        fig, axes = plt.subplots(n_rows, 1, figsize=(5, 5),
                                 constrained_layout=True, sharex=True)
    else:
        fig.clear()
        axes = fig.subplots(n_rows, sharex=True)
    n_frames = get_from_metadata(info, "Frames", raise_error=True)
    xvec = np.arange(n_frames)
    yvec = np.zeros(n_frames, dtype=int)
    yvec[locs["frame"]] = 1
    yvec_ph = np.zeros(n_frames)
    if "photons" in locs.dtype.names:
        yvec_ph[locs["frame"]] = locs["photons"]
    trace_data = (xvec, yvec, yvec_ph) if include_photons else (xvec, yvec)

    axes[0].scatter(locs["frame"], locs["x"], s=2)
    axes[0].set_title("X-pos vs frame")
    axes[0].set_xlim(0, n_frames)
    axes[0].set_ylabel("X-pos [Px]")
    axes[1].scatter(locs["frame"], locs["y"], s=2)
    axes[1].set_title("Y-pos vs frame")
    axes[1].set_ylabel("Y-pos [Px]")
    axes[2].plot(xvec, yvec, linewidth=1)
    axes[2].fill_between(xvec, 0, yvec, facecolor="red")
    axes[2].set_title("Localizations")
    axes[2].set_xlabel("Frames")
    axes[2].set_ylabel("ON")
    axes[2].set_yticks([0, 1])
    axes[2].set_ylim([-0.1, 1.1])
    if include_photons:
        axes[3].plot(xvec, yvec_ph, linewidth=1)
        axes[3].set_title("Photons")
        axes[3].set_xlabel("Frames")
        axes[3].set_ylabel("Photons")
        axes[3].set_ylim([0, max(yvec_ph.max(), 1) * 1.1])
    if return_trace:
        return fig, trace_data
    return fig


def plot_subclustering_check(clustered_n_events, sparse_n_events,
                             plot_path="", return_fig=False,
                             clustering_dist=None, sparse_dist=None):
    """Event-count histograms of clustered and sparse molecules with a
    KS/permutation test in the title, the companion of
    ``clusterer.test_subclustering`` (picasso/lib.py:2381)."""
    import matplotlib.pyplot as plt

    clustered_n_events = np.asarray(clustered_n_events)
    sparse_n_events = np.asarray(sparse_n_events)
    has_clustered = len(clustered_n_events) > 0
    has_sparse = len(sparse_n_events) > 0
    fig, ax = plt.subplots(1, figsize=(6, 4), constrained_layout=True)
    populations = [
        (has_clustered, clustered_n_events, clustering_dist, "<",
         "Clustered", "C0"),
        (has_sparse, sparse_n_events, sparse_dist, ">", "Sparse", "C1"),
    ]
    for present, events, dist, sign, name, color in populations:
        if not present:
            continue
        vals, counts = np.unique(events, return_counts=True)
        label = f"{name} {events.mean():.1f} +/- {events.std():.1f}"
        if dist is not None:
            label = (f"{name} (d {sign} {dist:.1f} nm) "
                     f"{events.mean():.1f} +/- {events.std():.1f}")
        ax.bar(vals, counts, width=0.8, alpha=0.5, label=label, color=color)
        ax.axvline(events.mean(), color=color, linestyle="--")
    if has_clustered or has_sparse:
        all_events = np.concatenate((sparse_n_events, clustered_n_events))
        min_bin, max_bin = np.percentile(all_events, [2.5, 97.5])
        ax.set_xlabel("Number of events")
        ax.set_ylabel("Counts")
        ax.set_xlim(min_bin - 1, max_bin + 1)
        ax.legend()
    if has_clustered and has_sparse:
        stat, p_perm, p = permutation_test(clustered_n_events,
                                           sparse_n_events)
        p_str = r"$p_{value}$"
        title = (f"KS test: stat={stat:.4f}\n"
                 f"permutation {p_str}={p_perm:.4f}\n"
                 f"theoretical {p_str}={p:.4f}")
    elif has_clustered or has_sparse:
        title = ("Only one population found, no statistical test "
                 "performed; adjust distance parameters.")
    else:
        title = ("No molecules found in either population, adjust "
                 "distance parameters.")
    ax.set_title(title, fontsize=10)
    if len(plot_path):
        if isinstance(plot_path, str):
            plot_path = [plot_path]
        for path in plot_path:
            fig.savefig(path, dpi=300)
    if return_fig:
        return fig, ax
    plt.close(fig)
    return None, None


def plot_rel_sigma_check(mols: np.ndarray, info, path) -> None:
    """Histograms of the relative sigmas of G5M molecules (a panel a
    dimension in 3D), saved to ``path`` (picasso/lib.py:2504)."""
    import matplotlib.pyplot as plt

    if "z" in mols.dtype.names:
        fig, axes = plt.subplots(3, 1, figsize=(6, 8),
                                 constrained_layout=True)
        bins = calculate_optimal_bins(np.concatenate([
            mols["rel_sigma_x"], mols["rel_sigma_y"], mols["rel_sigma_z"]]))
        for i, dim in enumerate("xyz"):
            axes[i].hist(mols[f"rel_sigma_{dim}"], bins=bins,
                         color=f"C{i}", alpha=0.7)
            axes[i].set_xlabel(f"Relative sigma {dim}")
            axes[i].set_ylabel("Counts")
    else:
        fig, ax = plt.subplots(1, figsize=(6, 4), constrained_layout=True)
        ax.hist(mols["rel_sigma"],
                bins=calculate_optimal_bins(mols["rel_sigma"]),
                color="C0", alpha=0.7)
        ax.set_xlabel("Relative sigma")
        ax.set_ylabel("Counts")
    fig.savefig(path, dpi=300)
    plt.close(fig)


# --- the reference's Qt-only names ------------------------------------------

_QT_ONLY_NAMES = {
    "Dialog", "GenericPlotWindow", "HelpButton", "LogDoubleSpinBox",
    "MetadataDialog", "RemoveColumnsDialog", "ScrollableGroupBox",
    "StatusDialog", "UserSettingsDialog", "adjust_widget_size",
    "cancel_dialogs", "get_save_filename_ext_dialog",
    "install_excepthook",
}


class QtOnlyAttributeError(AttributeError):
    """Raised for the reference's names that exist only with Qt. An
    AttributeError, so that hasattr() and getattr(..., default) still
    probe for them."""


def __getattr__(name):
    if name in _QT_ONLY_NAMES:
        raise QtOnlyAttributeError(
            f"lib.{name} is a Qt widget/helper in the reference "
            "(picasso/lib.py); the port has no Qt. Its apps live in "
            "picasso_torch.gui and run on matplotlib.")
    raise AttributeError(
        f"module 'picasso_torch.lib' has no attribute {name!r}")
