"""The cut and fit kernels' share of their roofline, in %: the least
time the window's spots need for the MLE fit (``roofline/fit.py``, with
the mean Newton steps of the plain reference's fits of the sampled
spots) over the device time of the group's kernels in the traced
window. Only for the MLE fit of ``sigmaxy``."""

from core.trace import device_seconds
from roofline import fit


def read(record):
    trace, cfg = record["trace"], record["config"]["fit"]
    steps = record["reference"].get("mean_iterations")
    if trace is None or trace.window is None or steps is None or (
            cfg["fitting_method"], cfg["mle_method"]) != ("gaussmle",
                                                          "sigmaxy"):
        return None
    t = device_seconds(trace, fit.KERNELS)
    if t <= 0:
        return None
    spots = sum(c["work"] for c in record["calls"])
    return 100.0 * fit.least_s(cfg["box"], spots, steps) / t
