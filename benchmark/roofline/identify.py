"""Identification (local maxima, net gradient, threshold) of a u16
movie: what the work needs, whatever kernel does it.

- Operations: the separable first-maximum test, 14 compares at each
  pixel that can hold a spot (along each axis the prefix and suffix
  maxima and two window maxima, 8; the whole row's, 2; the centre's four
  comparisons, 4), and the net gradient (4 operations a window pixel
  and 2) at each identified spot at least.
- Bytes: the frames read once (2 B a pixel) and each identification
  written once (frame, y, x as int32 and the net gradient as f32).
"""

from __future__ import annotations

from roofline.peaks import bound_s

#: kernels of the group, by a part of their name on the device
KERNELS = ("identify_kernel", "identify_any_kernel",
           "identify_any_direct_kernel")
SEPARABLE_COMPARES = 14
ID_BYTES = 16


def work(box: int, frames: int, height: int, width: int,
         spots: int) -> tuple[float, float]:
    """(operations, bytes) of identifying ``spots`` in ``frames`` frames
    of height x width at ``box``."""
    h = box // 2
    tested = frames * max(height - 2 * h - 1, 0) * max(width - 2 * h - 1, 0)
    flops = tested * SEPARABLE_COMPARES + spots * (4 * (box * box - 1) + 2)
    nbytes = frames * height * width * 2 + spots * ID_BYTES
    return float(flops), float(nbytes)


def least_s(box: int, calls: list[dict]) -> float:
    """The least time of the identification of every call's movie."""
    flops = nbytes = 0.0
    for c in calls:
        f, b = work(box, c["frames"], c["height"], c["width"], c["work"])
        flops, nbytes = flops + f, nbytes + b
    return bound_s(flops, nbytes)[0]
