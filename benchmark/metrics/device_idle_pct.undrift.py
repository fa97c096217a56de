"""The share of the traced window, in %, in which no kernel, copy or
fill ran on the card (the union of their intervals on the CUPTI
timeline), in the drift correction cells."""

from core.trace import idle_pct


def read(record):
    return idle_pct(record["trace"])
