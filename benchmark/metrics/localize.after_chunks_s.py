"""Seconds a movie spends in ``localize.localize`` after its chunk loop
(the concatenation of the chunks' results, the identifications and
``gaussmle.locs_from_fits``): the benchmark's host clock around each
call less the call's own loop time (``perf["total_s"]``), mean a movie."""


def read(record):
    vals = [c["host_s"] - c["perf"]["total_s"] for c in record["calls"]
            if c.get("perf") and "total_s" in c["perf"]]
    return sum(vals) / len(vals) if vals else None
