"""Seconds a movie's chunk loop waits for the next decoded chunk (the
program's span ``picasso.stream.decode_wait`` around the prefetcher's
queue; the decode itself runs in a thread the trace does not record),
in the traced window, mean a movie."""

from core.spans import per_call


def read(record):
    return per_call(record, "picasso.stream.decode_wait")
