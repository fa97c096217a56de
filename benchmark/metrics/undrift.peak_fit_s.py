"""Seconds a correction spends in the host's 5x5 Gaussian fits of the
pair correlations' peaks (the program's span
``picasso.undrift.peak_fit``), in the traced window, mean a
correction."""

from core.spans import per_call


def read(record):
    return per_call(record, "picasso.undrift.peak_fit")
