"""Seconds a correction spends sending the locs' columns to the card
and rendering its segments (the program's span
``picasso.undrift.segment``), in the traced window, mean a
correction."""

from core.spans import per_call


def read(record):
    return per_call(record, "picasso.undrift.segment")
