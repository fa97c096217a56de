"""Seconds a movie spends building its locs table from the fits (the
program's span ``picasso.localize.locs_table``:
``gaussmle.locs_from_fits``), in the traced window, mean a movie."""

from core.spans import per_call


def read(record):
    return per_call(record, "picasso.localize.locs_table")
