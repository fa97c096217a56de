"""Seconds a correction spends on the pair correlations: the empty
segments' readback, the f64 FFTs, the pair products and their crops to
the host (the program's span ``picasso.undrift.xcorr``), in the traced
window, mean a correction."""

from core.spans import per_call


def read(record):
    return per_call(record, "picasso.undrift.xcorr")
