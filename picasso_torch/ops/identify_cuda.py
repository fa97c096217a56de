"""Wrappers of the CUDA identify kernels (csrc/identify.cu and
csrc/identify_anybox.cu), K4.

Counterpart of picasso_tpu/ops/identify_pallas.identify_tiles_pallas: per
frame batch, the (T, T)-tile (mask, loc, ng) arrays that the compaction
reads. The kernel walks column strips (one thread a column of R centre
rows, see the note in csrc/identify.cu); its instances are the boxes of
:data:`BOXES`, and a CUDA batch at any other box >= 3 goes to
:func:`identify_tiles_anybox` (one thread a pixel, the box a launch
argument). A CUDA tensor launches a kernel or raises; a CPU tensor runs
the plain version (ops/identify.identify_tiles_plain).
``identify_tiles.launches`` and ``identify_tiles_anybox.launches`` count
the two kernels' launches; ``kernel_info`` describes an instance of the
first.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from picasso_torch import _build
from picasso_torch.ops._fit_common import MIN_BOX
from picasso_torch.ops.identify import (
    _unit_vector_masks, identify_tiles_plain,
)

BOXES = (3, 5, 7, 9, 11, 13, 15)
_DTYPES = {torch.uint16: 0, torch.float32: 1}
_MAX_FRAMES = 65535  # grid.z of one launch
#: fields of kernel_info, in csrc/identify.cu's picasso_identify_info order
KERNEL_INFO = ("threads", "rows", "columns", "shared_bytes", "registers",
               "local_bytes", "blocks_per_sm")


def _check(frames: torch.Tensor, box: int) -> bool:
    """True for a CUDA batch that passes a launch's checks, False for a
    CPU one; raises otherwise."""
    if frames.device.type == "cpu":
        return False
    if frames.device.type != "cuda":
        raise ValueError(f"no identify kernel for tensors on {frames.device}")
    if frames.ndim != 3:
        raise ValueError(f"frames must be (B, Y, X), got {tuple(frames.shape)}")
    if frames.dtype not in _DTYPES or not frames.is_contiguous():
        raise ValueError(
            f"the identify kernel takes contiguous uint16 or float32 "
            f"frames, got {frames.dtype}"
        )
    if box < MIN_BOX:
        raise ValueError(
            f"the identify kernels take boxes >= {MIN_BOX}, got {box}")
    if frames.shape[0] > _MAX_FRAMES:
        raise ValueError(
            f"at most {_MAX_FRAMES} frames per launch, got {frames.shape[0]}")
    return True


def _tiles(frames: torch.Tensor, box: int, fill):
    """The (mask, loc, ng) outputs of one launch, made by ``fill``
    (torch.empty or torch.zeros)."""
    B, Y, X = frames.shape
    T = box // 2 + 1
    shape = (B, -(-Y // T), -(-X // T))
    dev = frames.device
    return (fill(shape, dtype=torch.bool, device=dev),
            fill(shape, dtype=torch.int32, device=dev),
            fill(shape, dtype=torch.float32, device=dev))


def identify_tiles(frames: torch.Tensor, minimum_ng, box: int):
    """(B, Y, X) frames -> (tile_mask bool, tile_loc i32, tile_ng f32),
    each (B, ceil(Y/T), ceil(X/T)), T = box//2 + 1. A CUDA batch at a box
    outside :data:`BOXES` goes to :func:`identify_tiles_anybox`."""
    if not _check(frames, box):
        return identify_tiles_plain(frames, minimum_ng, box)
    if box not in BOXES:
        return identify_tiles_anybox(frames, minimum_ng, box)
    mask, loc, ng = _tiles(frames, box, torch.empty)
    B, Y, X = frames.shape
    if B == 0 or Y == 0 or X == 0:
        return mask, loc, ng
    dev = frames.device
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.picasso_identify_tiles(
            frames.data_ptr(), _DTYPES[frames.dtype], B, Y, X, box,
            float(np.float32(minimum_ng)), mask.data_ptr(), loc.data_ptr(),
            ng.data_ptr(), stream,
        )
    _build.count_launch(identify_tiles)
    _build.check(status, "identify_tiles")
    return mask, loc, ng


identify_tiles.launches = 0


@functools.cache
def _unit_vectors(box: int, device: torch.device) -> torch.Tensor:
    """The (2, box, box) f32 unit vectors (uy, ux) of the plain version,
    on ``device``."""
    return torch.from_numpy(np.stack(_unit_vector_masks(box))).to(device)


def identify_tiles_anybox(frames: torch.Tensor, minimum_ng, box: int):
    """K4 at any box >= 3 (csrc/identify_anybox.cu): one thread a pixel,
    the box a launch argument, the tiles zeroed here and a hit's tile
    written by its pixel. Returns what :func:`identify_tiles` returns; at
    the boxes of :data:`BOXES` its tiles equal identify.cu's bit for bit.
    A CPU tensor runs the plain version, uncounted."""
    if not _check(frames, box):
        return identify_tiles_plain(frames, minimum_ng, box)
    mask, loc, ng = _tiles(frames, box, torch.zeros)
    B, Y, X = frames.shape
    if B == 0 or Y == 0 or X == 0:
        return mask, loc, ng
    dev = frames.device
    uv = _unit_vectors(box, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _build.library().picasso_identify_anybox(
            frames.data_ptr(), _DTYPES[frames.dtype], B, Y, X, box,
            float(np.float32(minimum_ng)), uv[0].data_ptr(),
            uv[1].data_ptr(), mask.data_ptr(), loc.data_ptr(), ng.data_ptr(),
            stream,
        )
    _build.count_launch(identify_tiles_anybox)
    _build.check(status, "identify_anybox")
    return mask, loc, ng


identify_tiles_anybox.launches = 0


def kernel_info(dtype: torch.dtype, box: int, lib=None) -> dict:
    """What the identify kernel's instance for ``dtype`` frames and
    ``box`` is on the current card: the :data:`KERNEL_INFO` fields
    (threads a block, centre rows and columns a block, static shared
    bytes, registers and local spill bytes a thread, resident blocks per
    SM). ``lib``: a library built from csrc/identify.cu, by default the
    package's."""
    lib = lib or _build.library()
    fn = lib.picasso_identify_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(KERNEL_INFO))()
    status = fn(_DTYPES[dtype], box, info)
    if status != 0:
        raise RuntimeError(f"identify_info: CUDA error {status}")
    return dict(zip(KERNEL_INFO, info))
