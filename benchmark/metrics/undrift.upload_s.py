"""Seconds a correction spends sending the locs' records to the card
(the program's span ``picasso.undrift.upload``), in the traced window,
mean a correction. None where the program opens no such span."""

from core.spans import per_call


def read(record):
    return per_call(record, "picasso.undrift.upload")
