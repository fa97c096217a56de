"""The cut, photon conversion and MLE fit (sigmaxy) of identified spots:
what the work needs, whatever kernel does it.

- Operations: one Newton step of one spot, counted analytically
  (2341 at box 7; exp and erfc at 8 operations each), for each step the
  plain reference needs and one more a spot for the start and the final
  pass (the Cramer-Rao bounds and the likelihood).
- Bytes: each spot's u16 window and its (frame, y, x) as int32 read
  once, its six parameters and six bounds (f32), likelihood and
  iteration count written once.
"""

from __future__ import annotations

from roofline.peaks import bound_s

#: kernels of the group, by a part of their name on the device: the
#: windowed MLE work queue with its CRLB/LL launch (templated boxes), the
#: any-box cut and MLE queue (other boxes)
KERNELS = ("mle_queue_kernel", "winfit_mle_kernel", "cut_any_kernel",
           "cut_any_direct_kernel", "mle_any_queue_kernel", "mle_any_kernel")
OUT_BYTES = 6 * 4 * 2 + 4 + 4


def mle_flops_per_spot_iter(box: int) -> float:
    """Operations of one Newton step of one spot at ``box``."""
    s = box
    return float(s * s * 29 + 17 * 2 * s + 2 * (s + 1) * 2 * 8
                 + 2 * s * 24 + 90)


def work(box: int, spots: int, mean_steps: float) -> tuple[float, float]:
    """(operations, bytes) of fitting ``spots`` spots that take
    ``mean_steps`` Newton steps each on average."""
    flops = spots * (mean_steps + 1.0) * mle_flops_per_spot_iter(box)
    nbytes = spots * (box * box * 2 + 3 * 4 + OUT_BYTES)
    return float(flops), float(nbytes)


def least_s(box: int, spots: int, mean_steps: float) -> float:
    return bound_s(*work(box, spots, mean_steps))[0]
