"""The identification kernels' share of their roofline, in %: the least
time the window's movies need for it (``roofline/identify.py``) over the
device time of the group's kernels in the traced window."""

from core.trace import device_seconds
from roofline import identify


def read(record):
    trace = record["trace"]
    if trace is None or trace.window is None:
        return None
    t = device_seconds(trace, identify.KERNELS)
    if t <= 0:
        return None
    least = identify.least_s(record["config"]["fit"]["box"], record["calls"])
    return 100.0 * least / t
