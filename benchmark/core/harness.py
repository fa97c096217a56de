"""One run of one cell: set-up, the measured window, the check against
the reference, the metrics, the result line.

The driver of the cell's traffic does the work of one call (one movie,
one correction); the harness times the window around its calls, reads
the card, decides ``correct`` from the driver's numbers and the cell's
limits (``benchmark/limits/<workload>.json``), and has the per-layer
metrics read, each by its own reader, from the run's record.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from core import device as dev_info
from core import trace as trace_mod
from core.spec import Cell


def worst(numbers: list[dict]) -> dict:
    """Each number's worst value over the calls (the largest)."""
    out: dict = {}
    for n in numbers:
        for k, v in n.items():
            out[k] = v if k not in out else max(out[k], v)
    return out


def failed_calls(numbers: list[dict], limits: dict) -> int:
    """The calls with a number over its limit, or without a number that
    has a limit."""
    return sum(any(not (k in n and n[k] <= limits[k]) for k in limits)
               for n in numbers)


def checked_calls(n: int, most: int, seed: int) -> list[int]:
    """The calls whose answers are checked: all of them, or ``most``
    drawn from the seed."""
    if n <= most:
        return list(range(n))
    rng = np.random.default_rng([int(seed) % (1 << 63), n])
    return sorted(rng.choice(n, most, replace=False).tolist())


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float | None = None, device=None,
             sizes: dict | None = None, check_device: bool = True,
             spec: dict | None = None) -> dict:
    """Run the cell ``name`` and return the result line as a dict. The
    set-up is timed from ``t_start`` (the process's start). ``device``,
    ``sizes`` and ``check_device=False`` are for the tests' small runs
    on the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, spec)
    chips = int(cell.entry["chips"])
    if check_device:
        dev_info.require_cuda(chips)
    device = torch.device(device if device is not None else "cuda:0")
    driver_mod = cell.driver()
    driver = driver_mod.Driver(cell.config, cell.traffic, seed, device, sizes)
    t_import = time.perf_counter()
    driver.setup(cell.generator())
    setup_s = time.perf_counter() - t_start
    timing = {"import_s": t_import - t_start, **driver.setup_parts}

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    calls, error = [], None
    with trace_mod.profiled(trace) as box:
        with torch.profiler.record_function(trace_mod.WINDOW_SPAN):
            t0 = time.perf_counter()
            i = 0
            while True:
                try:
                    calls.append(driver.call(i))
                except Exception as exc:  # a failed call ends the window
                    error = exc
                    break
                i += 1
                if time.perf_counter() - t0 >= seconds:
                    break
    timing["window_s"] = time.perf_counter() - t0
    device_line = dev_info.describe(device, chips)
    driver.release()

    t_check = time.perf_counter()
    checked = checked_calls(len(calls), cell.traffic["check"]["calls"], seed)
    limits = cell.limits
    numbers, ref_info = (driver.check([calls[i] for i in checked], limits)
                         if calls else ([], {}))
    timing["check_s"] = time.perf_counter() - t_check
    failed = failed_calls(numbers, limits) + (error is not None)
    correct = bool(calls) and error is None and failed == 0
    most = worst(numbers)
    checks = {k: {"value": (most[k] if math.isfinite(most[k])
                            else repr(most[k])) if k in most else "missing",
                  "limit": v} for k, v in limits.items()}

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    values = driver_mod.Driver.end_to_end(calls) if calls else {}
    values["setup_s"] = setup_s
    if not trace:
        metrics = {k: {"value": values[k], "unit": units[k]}
                   for k in units if k in values}
    result = {"correct": correct, "attempted": len(calls) + (error is not None),
              "failed": failed, "metrics": metrics, "device": device_line}
    if trace:
        tr = box.get("trace")
        record = {"cell": cell.entry, "config": cell.config,
                  "traffic": cell.traffic, "trace": tr,
                  "calls": [{k: v for k, v in c.items() if k != "output"}
                            for c in calls],
                  "reference": ref_info, "power_limit_w":
                  device_line.get("power_limit_w")}
        readers = cell.metric_readers()
        for m in cell.per_layer:
            v = readers[m["name"]].read(record)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None and tr.window is not None:
            device_line["busy_s"] = trace_mod.busy_s(tr)
            device_line["window_s"] = tr.window_s
            result["breakdown"] = trace_mod.breakdown(tr)
    if error is not None:
        print(f"a call raised: {type(error).__name__}: {error}",
              file=sys.stderr)
    print("timing " + " ".join(f"{k}={v:.3f}" for k, v in timing.items()),
          file=sys.stderr)
    result["calls_s"] = [c["host_s"] for c in calls]
    result["checked"] = checked
    result["checks"] = checks
    return result
