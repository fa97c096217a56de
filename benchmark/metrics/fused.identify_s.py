"""Seconds a movie's host spends in identification: K4's launch and
the compaction of its maxima, whose ``torch.nonzero`` waits for K4 (the
program's span ``picasso.fused.identify``), in the traced window, mean
a movie."""

from core.spans import per_call


def read(record):
    return per_call(record, "picasso.fused.identify")
