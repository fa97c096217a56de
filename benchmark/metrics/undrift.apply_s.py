"""Seconds a correction spends subtracting the drift from the locs
(``apply_drift``, the program's span ``picasso.undrift.apply``), in the
traced window, mean a correction."""

from core.spans import per_call


def read(record):
    return per_call(record, "picasso.undrift.apply")
