"""The frames' upload rate, in GB/s: the bytes of frames the window's
movies uploaded (the program's ``perf["upload_bytes"]``) over the time
of the program's upload spans in the traced window
(``picasso.stream.upload``: pageable host to device copies). Totals over
the window, not a mean of calls: the calls' clock is not the trace's."""

from core.spans import seconds


def read(record):
    s = seconds(record["trace"], "picasso.stream.upload")
    sizes = [c["perf"]["upload_bytes"] for c in record["calls"]
             if c.get("perf") and "upload_bytes" in c["perf"]]
    if not s or not sizes:
        return None
    return sum(sizes) / s / 1e9
