"""Wrapper of the CUDA identify kernel (csrc/identify.cu), K4.

Counterpart of picasso_tpu/ops/identify_pallas.identify_tiles_pallas: per
frame batch, the (T, T)-tile (mask, loc, ng) arrays that the compaction
reads. The kernel walks column strips (one thread a column of R centre
rows, see the note in csrc/identify.cu). A CUDA tensor launches the
kernel or raises; a CPU tensor runs the plain version
(ops/identify.identify_tiles_plain). ``identify_tiles.launches`` counts
kernel launches; ``kernel_info`` describes a kernel instance.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from picasso_torch import _build
from picasso_torch.ops.identify import identify_tiles_plain

BOXES = (3, 5, 7, 9, 11, 13, 15)
_DTYPES = {torch.uint16: 0, torch.float32: 1}
_MAX_FRAMES = 65535  # grid.z of one launch
#: fields of kernel_info, in csrc/identify.cu's picasso_identify_info order
KERNEL_INFO = ("threads", "rows", "columns", "shared_bytes", "registers",
               "local_bytes", "blocks_per_sm")


def identify_tiles(frames: torch.Tensor, minimum_ng, box: int):
    """(B, Y, X) frames -> (tile_mask bool, tile_loc i32, tile_ng f32),
    each (B, ceil(Y/T), ceil(X/T)), T = box//2 + 1."""
    if frames.device.type == "cpu":
        return identify_tiles_plain(frames, minimum_ng, box)
    if frames.device.type != "cuda":
        raise ValueError(f"no identify kernel for tensors on {frames.device}")
    if frames.ndim != 3:
        raise ValueError(f"frames must be (B, Y, X), got {tuple(frames.shape)}")
    if frames.dtype not in _DTYPES or not frames.is_contiguous():
        raise ValueError(
            f"the identify kernel takes contiguous uint16 or float32 "
            f"frames, got {frames.dtype}"
        )
    if box not in BOXES:
        raise ValueError(f"the identify kernel takes boxes {BOXES}, got {box}")
    B, Y, X = frames.shape
    if B > _MAX_FRAMES:
        raise ValueError(f"at most {_MAX_FRAMES} frames per launch, got {B}")
    T = box // 2 + 1
    shape = (B, -(-Y // T), -(-X // T))
    dev = frames.device
    mask = torch.empty(shape, dtype=torch.bool, device=dev)
    loc = torch.empty(shape, dtype=torch.int32, device=dev)
    ng = torch.empty(shape, dtype=torch.float32, device=dev)
    if B == 0 or Y == 0 or X == 0:
        return mask, loc, ng
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
