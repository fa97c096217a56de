"""Wrappers of the CUDA identify kernels (csrc/identify.cu and
csrc/identify_anybox.cu), K4.

Counterpart of picasso_tpu/ops/identify_pallas.identify_tiles_pallas: per
frame batch, the (T, T)-tile (mask, loc, ng) arrays that the compaction
reads. The kernel walks column strips (one thread a column of R centre
rows, see the note in csrc/identify.cu); its instances are the boxes of
:data:`BOXES`, and a CUDA batch at any other box >= 3 goes to
:func:`identify_tiles_anybox` (the box a launch argument, a block an
output tile staged in shared memory, separable running maxima, the net
gradient only at the maxima; its tile shape :func:`anybox_tile_shape`).
Where no tile fits in a block's shared memory (boxes of 96 and above),
the batch goes to the direct kernel, one thread a pixel
(:func:`identify_tiles_anybox_direct`), which is also the fixed point
the any-box kernel equals bit for bit.
A CUDA tensor launches a kernel or raises; a CPU tensor runs the plain
version (ops/identify.identify_tiles_plain). ``identify_tiles.launches``,
``identify_tiles_anybox.launches`` and
``identify_tiles_anybox_direct.launches`` count the kernels' launches;
``kernel_info`` describes an instance of the first.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from picasso_torch import _build
from picasso_torch.ops._fit_common import SHARED_LIMIT
from picasso_torch.ops.identify import (
    _unit_vector_masks, check_box, identify_tiles_plain,
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
    check_box(box)
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
    outside :data:`BOXES` goes to :func:`identify_tiles_anybox`, or where
    no tile of it fits (:func:`anybox_tile_fits`) to
    :func:`identify_tiles_anybox_direct`."""
    if not _check(frames, box):
        return identify_tiles_plain(frames, minimum_ng, box)
    if box not in BOXES:
        if anybox_tile_fits(box):
            return identify_tiles_anybox(frames, minimum_ng, box)
        return identify_tiles_anybox_direct(frames, minimum_ng, box)
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


#: the any-box kernel's output tile (rows, columns) a block, the measured
#: choice of tests/torch_anybox_sweep.py (PERF.md; csrc/identify_anybox.cu)
ANYBOX_TILE = (64, 32)


def anybox_tile_bytes(box: int, oy: int, ox: int) -> int:
    """Shared bytes of a block of the any-box kernel with an oy x ox
    output tile (csrc/identify_anybox.cu's Layout): the staged pixels
    with a halo of h + 1 (odd pitch), the prefix and suffix maxima of the
    window rows (odd pitch), the whole-row maxima, the unit vectors, the
    list of local maxima (one an (h + 1) x (h + 1) cell at most) and its
    count, a byte a centre."""
    h = box // 2
    wr, m = oy + 2 * h, ox + 2 * h
    cap = -(-oy // (h + 1)) * -(-ox // (h + 1))
    floats = ((wr + 2) * ((m + 2) | 1) + 2 * wr * (m | 1) + wr * ox
              + 2 * box * box + cap + 1)
    return 4 * floats + oy * ox


def anybox_tile_fits(box: int) -> bool:
    """Whether the any-box kernel's smallest tile, 1 x 32, fits in
    :data:`SHARED_LIMIT` at ``box`` (boxes below 96)."""
    return anybox_tile_bytes(box, 1, 32) <= SHARED_LIMIT


def anybox_tile_shape(box: int) -> tuple[int, int]:
    """The any-box kernel's output tile at ``box``: :data:`ANYBOX_TILE`,
    its longer side halved (its columns, a power of two, not below 32)
    until a block's shared bytes fit in half of :data:`SHARED_LIMIT` (two
    blocks a SM), or where no tile does, in all of it. Raises where none
    fits at all (:func:`anybox_tile_fits`)."""
    for budget in (SHARED_LIMIT // 2, SHARED_LIMIT):
        oy, ox = ANYBOX_TILE
        while anybox_tile_bytes(box, oy, ox) > budget:
            if ox > 32 and (ox >= oy or oy == 1):
                ox //= 2
            elif oy > 1:
                oy = (oy + 1) // 2
            else:
                break
        if anybox_tile_bytes(box, oy, ox) <= budget:
            return oy, ox
    raise ValueError(f"no tile of the any-box K4 fits box {box}")


def _anybox_launch(frames, minimum_ng, box: int, tile=None):
    """One launch of the any-box kernel in a ``tile`` (rows, columns)
    output tile (by default :func:`anybox_tile_shape`'s), or of the direct
    kernel where ``tile`` is "direct", into tiles zeroed here."""
    mask, loc, ng = _tiles(frames, box, torch.zeros)
    B, Y, X = frames.shape
    if B == 0 or Y == 0 or X == 0:
        return mask, loc, ng
    dev = frames.device
    uv = _unit_vectors(box, dev)
    args = (frames.data_ptr(), _DTYPES[frames.dtype], B, Y, X, box,
            float(np.float32(minimum_ng)), uv[0].data_ptr(), uv[1].data_ptr())
    outs = (mask.data_ptr(), loc.data_ptr(), ng.data_ptr())
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tile == "direct":
            status = lib.picasso_identify_anybox_direct(*args, *outs, stream)
        else:
            oy, ox = tile or anybox_tile_shape(box)
            status = lib.picasso_identify_anybox(
                *args, oy, ox.bit_length() - 1, *outs, stream)
    _build.check(status, "identify_anybox" + (
        "_direct" if tile == "direct" else ""))
    return mask, loc, ng


def identify_tiles_anybox(frames: torch.Tensor, minimum_ng, box: int):
    """K4 at any box >= 3 (csrc/identify_anybox.cu): a block an output
    tile (:func:`anybox_tile_shape`'s) staged in shared memory with its
    halo,
    the local maxima from separable running maxima, the net gradient only
    at the maxima, the tiles zeroed here and a hit's tile written by its
    pixel. Returns what :func:`identify_tiles` returns; equal to
    :func:`identify_tiles_anybox_direct` bit for bit, and at the boxes of
    :data:`BOXES` to identify.cu's. Raises at a box where no tile fits. A
    CPU tensor runs the plain version, uncounted."""
    if not _check(frames, box):
        return identify_tiles_plain(frames, minimum_ng, box)
    out = _anybox_launch(frames, minimum_ng, box)
    _build.count_launch(identify_tiles_anybox)
    return out


identify_tiles_anybox.launches = 0


def identify_tiles_anybox_direct(frames: torch.Tensor, minimum_ng, box: int):
    """The direct any-box kernel (csrc/identify_anybox.cu, the first
    form of :func:`identify_tiles_anybox`): one thread a pixel testing
    its window's neighbours through L1, the net gradient at its maxima.
    :func:`identify_tiles` routes a box here where no tile of
    :func:`identify_tiles_anybox` fits (96 and above); at every box it is
    the fixed point that kernel equals bit for bit. A CPU tensor runs the
    plain version, uncounted."""
    if not _check(frames, box):
        return identify_tiles_plain(frames, minimum_ng, box)
    out = _anybox_launch(frames, minimum_ng, box, "direct")
    _build.count_launch(identify_tiles_anybox_direct)
    return out


identify_tiles_anybox_direct.launches = 0


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
