"""Locs records on a torch device: a structured numpy array's bytes as
one (N, itemsize) uint8 tensor, its fields read from those bytes, and
the drift subtracted from them record by record.

No counterpart in picasso_tpu, whose apply_drift
(picasso_tpu/postprocess.py:1351) is pandas on the host. A structured
array crosses PCIe once each way in its own byte layout (:func:`upload`,
:func:`download`), and every per-field step runs where the bytes are:

- :func:`column`: one field as an (N,) tensor, from a byte slice of the
  records (floats in their own type, integers as int64);
- :func:`drift_layout`: what apply_drift writes, worked out from the
  locs' dtype (``dtype.fields`` and ``itemsize``, so padded and aligned
  dtypes work too) and the drift: numpy's output dtype (x, y and z
  become f64) and the segments that build an output record from an
  input one: runs of bytes copied as they are, and f32 or f64
  coordinates minus the drift of the record's frame, in f64;
- :func:`apply_drift_records`: those segments applied to every record,
  on a CUDA tensor by csrc/records.cu (one launch; a block a tile of
  records staged through shared memory) and on a CPU tensor by its plain
  version :func:`apply_drift_records_plain`, which is also the host's
  apply_drift. Both give numpy's field-by-field result bit for bit (a
  NaN stays a NaN; its payload may not). ``apply_drift_records.launches``
  counts the kernel's launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from picasso_torch import _build

COPY, SUBTRACT = 0, 1
#: fields the drift moves, in the order of the drift table's columns
MOVED = ("x", "y", "z")
_FLOAT = {4: torch.float32, 8: torch.float64}
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
#: shared memory a block of csrc/records.cu may take without opting in
SHARED_BYTES = 48 * 1024
ALIGN = 16


class DriftLayout(NamedTuple):
    """How apply_drift turns one input record into one output record."""
    in_size: int
    out_dtype: np.dtype
    #: (S, 5) int32 rows (kind, in_off, out_off, bytes, drift column)
    segments: np.ndarray
    #: the frame field's (offset, bytes, signed)
    frame: tuple[int, int, bool]


def upload(locs: np.ndarray, device) -> torch.Tensor:
    """The records of ``locs`` as one (N, itemsize) uint8 tensor on
    ``device``: one copy of a contiguous array (a non-contiguous one is
    made contiguous first); on the CPU the array's own memory."""
    arr = np.ascontiguousarray(locs)
    flat = arr.view(np.uint8).reshape(len(arr), arr.dtype.itemsize)
    return torch.from_numpy(flat).to(device)


def download(records: torch.Tensor, dtype: np.dtype) -> np.ndarray:
    """(N, itemsize) uint8 records as a structured array of ``dtype``:
    one copy from the card; a CPU tensor's own memory."""
    n = records.shape[0]
    if records.device.type == "cpu":
        return records.numpy().view(dtype).reshape(n)
    host = np.empty(n, dtype)
    torch.from_numpy(host.view(np.uint8).reshape(n, dtype.itemsize)).copy_(
        records)
    return host


def _bytes(records: torch.Tensor, off: int, size: int) -> torch.Tensor:
    """Bytes [off, off + size) of every record, packed (a copy even where
    the slice counts as contiguous, as one record's does)."""
    return records.new_empty((records.shape[0], size)).copy_(
        records[:, off:off + size])


def _float_column(records, off: int, size: int) -> torch.Tensor:
    return _bytes(records, off, size).view(_FLOAT[size]).reshape(-1)


def _int_column(records, off: int, size: int, signed: bool) -> torch.Tensor:
    """An integer field as int64: signed ones sign-extended, unsigned ones
    zero-extended (an unsigned 64-bit value of 2^63 or more turns
    negative). Little-endian, as host and card are."""
    if signed or size == 8:
        return _bytes(records, off, size).view(_SIGNED[size]).reshape(
            -1).long()
    wide = records.new_zeros((records.shape[0], 8))
    wide[:, :size] = records[:, off:off + size]
    return wide.view(torch.int64).reshape(-1)


def column(records: torch.Tensor, dtype: np.dtype, name: str
           ) -> torch.Tensor:
    """Field ``name`` of (N, itemsize) records of ``dtype`` as an (N,)
    tensor on their device: f32 and f64 in their own type, integers as
    int64."""
    ft, off = dtype.fields[name][:2]
    if ft.kind == "f" and ft.itemsize in _FLOAT and ft.isnative:
        return _float_column(records, off, ft.itemsize)
    if ft.kind in "iu" and ft.isnative:
        return _int_column(records, off, ft.itemsize, ft.kind == "i")
    raise ValueError(f"field {name!r} ({ft}) is not a native f32, f64 or "
                     "integer field")


def drift_layout(dtype: np.dtype, drift) -> tuple[DriftLayout, np.ndarray]:
    """The layout that subtracts ``drift`` from locs of ``dtype``, and the
    drift table (frames, k) f64 it indexes. ``drift`` is a structured
    array with fields x, y and maybe z, or an (n, 2 or 3) array of those
    columns, taken in f64. x, y and z are moved where both the locs and
    the drift have them, and become f64 fields; every other field keeps
    its type. The output dtype is numpy's: the fields in their order,
    packed."""
    if drift.dtype.names is None:
        d = {c: drift[:, i] for i, c in enumerate(MOVED[:drift.shape[1]])}
    else:
        d = {c: drift[c] for c in drift.dtype.names}
    moved = [c for c in MOVED if c in dtype.names and c in d]
    out_dtype = np.dtype([(n, np.float64 if n in moved else dtype[n])
                          for n in dtype.names])
    if "frame" not in dtype.names:
        raise ValueError("the locs have no field 'frame'")
    ft, frame_off = dtype.fields["frame"][:2]
    if ft.kind not in "iu" or not ft.isnative:
        raise IndexError(f"frames ({ft}) must be native integers to index "
                         "the drift")
    frame = (frame_off, ft.itemsize, ft.kind == "i")
    segments: list[list[int]] = []
    for n in dtype.names:
        ft, off = dtype.fields[n][:2]
        out_off = out_dtype.fields[n][1]
        if n in moved:
            if ft.kind != "f" or ft.itemsize not in _FLOAT or not ft.isnative:
                raise ValueError(f"field {n!r} ({ft}) is not a native f32 "
                                 "or f64 field")
            segments.append([SUBTRACT, off, out_off, ft.itemsize,
                             moved.index(n)])
            continue
        last = segments[-1] if segments else None
        if (last is not None and last[0] == COPY
                and last[1] + last[3] == off and last[2] + last[3] == out_off):
            last[3] += ft.itemsize
        else:
            segments.append([COPY, off, out_off, ft.itemsize, 0])
    table = (np.stack([np.asarray(d[c], np.float64) for c in moved], 1)
             if moved else np.zeros((0, 0)))
    layout = DriftLayout(dtype.itemsize, out_dtype,
                         np.array(segments, np.int32).reshape(-1, 5), frame)
    return layout, table


def _out_of_bounds(n_frames: int) -> IndexError:
    return IndexError(f"frames out of bounds for a drift of {n_frames} "
                      "frames")


def apply_drift_records_plain(records: torch.Tensor, layout: DriftLayout,
                              table: torch.Tensor) -> torch.Tensor:
    """:func:`apply_drift_records` in PyTorch, on any device, segment by
    segment over all records."""
    n = records.shape[0]
    out = records.new_empty((n, layout.out_dtype.itemsize))
    rows = None
    for kind, off, out_off, size, c in layout.segments.tolist():
        if kind == COPY:
            out[:, out_off:out_off + size] = records[:, off:off + size]
            continue
        if rows is None:
            n_frames = table.shape[0]
            rows = _int_column(records, *layout.frame)
            lo = -n_frames if layout.frame[2] else 0
            if bool(((rows < lo) | (rows >= n_frames)).any()):
                raise _out_of_bounds(n_frames)
            rows = torch.where(rows < 0, rows + n_frames, rows)
        v = _float_column(records, off, size).double() - table[rows, c]
        out[:, out_off:out_off + 8] = v.view(torch.uint8).reshape(n, 8)
    return out


def _granule(layout: DriftLayout) -> int:
    """The widest word (4, 2 or 1 bytes) that every record size, offset
    and run of the layout is a multiple of."""
    sizes = [layout.in_size, layout.out_dtype.itemsize,
             *layout.segments[:, 1:4].ravel().tolist()]
    return next(g for g in (4, 2, 1) if all(s % g == 0 for s in sizes))


def apply_drift_records(records: torch.Tensor, layout: DriftLayout,
                        table: torch.Tensor) -> torch.Tensor:
    """The (N, in_size) uint8 ``records`` rewritten by ``layout`` with the
    drift ``table`` ((frames, k) f64, on their device): (N, out size)
    uint8 records of ``layout.out_dtype``. On the card one launch of
    csrc/records.cu (raises IndexError, after it, for a frame out of
    bounds); on the CPU :func:`apply_drift_records_plain`, uncounted."""
    if records.device.type == "cpu":
        return apply_drift_records_plain(records, layout, table)
    if records.device.type != "cuda":
        raise ValueError(f"no record kernel for tensors on {records.device}")
    n = records.shape[0]
    out_size = layout.out_dtype.itemsize
    if (records.dtype != torch.uint8 or records.dim() != 2
            or records.shape[1] != layout.in_size
            or not records.is_contiguous()
            or records.data_ptr() % ALIGN):
        raise ValueError(
            f"records must be a contiguous, {ALIGN}-B aligned (N, "
            f"{layout.in_size}) uint8 tensor; got {tuple(records.shape)} "
            f"{records.dtype}")
    if (table.dtype != torch.float64 or table.device != records.device
            or not table.is_contiguous()):
        raise ValueError("the drift table must be a contiguous f64 tensor "
                         "on the records' device")
    n_segs = len(layout.segments)
    tile = min(256, (SHARED_BYTES - 20 * n_segs)
               // (layout.in_size + out_size) // 16 * 16)
    if tile < 16:
        raise ValueError(f"records of {layout.in_size} + {out_size} B are "
                         "too wide for csrc/records.cu's tiles")
    out = torch.empty((n, out_size), dtype=torch.uint8, device=records.device)
    if n == 0:
        return out
    segs = torch.from_numpy(layout.segments).to(records.device)
    bad = torch.zeros(1, dtype=torch.int32, device=records.device)
    frame_off, frame_size, frame_signed = layout.frame
    n_frames = table.shape[0]
    k = table.shape[1] if table.dim() == 2 else 0
    with torch.cuda.device(records.device):
        stream = torch.cuda.current_stream(records.device).cuda_stream
        status = _build.library().picasso_apply_drift_records(
            records.data_ptr(), n, layout.in_size, out.data_ptr(), out_size,
            segs.data_ptr(), n_segs, frame_off, frame_size, int(frame_signed),
            table.data_ptr(), n_frames, k, tile, _granule(layout),
            bad.data_ptr(), stream,
        )
    _build.check(status, "apply_drift_records")
    _build.count_launch(apply_drift_records)
    if bad.item():
        raise _out_of_bounds(n_frames)
    return out


apply_drift_records.launches = 0
