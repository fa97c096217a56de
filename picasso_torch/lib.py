"""Shared utilities of the port: metadata access, the locs sanity filter
on numpy structured arrays, progress reporting and device resolution.

Counterpart of the parts of picasso_tpu/lib.py that the localize path
and the picks use (get_from_metadata :41, ensure_sanity :82,
is_loc_at :133, locs_at :143, check_if_in_polygon :148, merge_locs
:110, check_if_in_rectangle :170, get_pick_rectangle_corners :213,
find_local_minima :345, minimize_shifts :445, deprecation_warning :479, MockProgress :670,
progress_reporter :731, get_pick_polygon_corners :828). Locs are
numpy structured arrays with the record layout of the HDF5 ``"locs"``
dataset; :func:`series_mean_std` gives a column the mean and std that
the JAX package's pandas columns give.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Literal

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and no card
    is visible (the port never moves work to the CPU by itself)."""
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
    return locs[keep]


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


def deprecation_warning(message: str) -> None:
    """Print a deprecation notice (picasso/lib.py convention)."""
    print(message)


class MockProgress:
    """No-op progress reporter (picasso/lib.py:426)."""

    def set_value(self, value):
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
