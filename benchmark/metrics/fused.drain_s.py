"""Seconds a movie's host spends blocked on the chain of each chunk and
its readback (``ops/fused.localize_fused``, the program's
``perf["drain_s"]``), mean a movie."""


def read(record):
    vals = [c["perf"]["drain_s"] for c in record["calls"]
            if c.get("perf") and "drain_s" in c["perf"]]
    return sum(vals) / len(vals) if vals else None
