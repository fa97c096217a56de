"""Seconds a movie spends after its chunk loop gathering the chunks'
payloads into the identifications and fit columns (the program's span
``picasso.localize.gather``: the concatenation, ``make_ids`` and the
column copies), in the traced window, mean a movie."""

from core.spans import per_call


def read(record):
    return per_call(record, "picasso.localize.gather")
