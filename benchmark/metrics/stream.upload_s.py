"""Seconds a movie spends uploading its frame chunks
(``stream.device_chunks``, the program's ``perf["upload_dispatch_s"]``),
mean a movie."""


def read(record):
    vals = [c["perf"]["upload_dispatch_s"] for c in record["calls"]
            if c.get("perf") and "upload_dispatch_s" in c["perf"]]
    return sum(vals) / len(vals) if vals else None
