"""The traced run: a torch.profiler trace of the window, read from its
Chrome trace into device and host intervals.

Device intervals are the kernels, copies and fills on the CUPTI
timeline; host intervals are the torch ops and the benchmark's own spans
(``record_function``). Times are seconds on the trace's clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW_SPAN = "bench.window"


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (name, start, end)
    host: list = field(default_factory=list)  # (name, start, end)
    window: tuple[float, float] | None = None

    @property
    def window_s(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]


def from_chrome(events: list[dict]) -> Trace:
    """A :class:`Trace` of Chrome trace events (``traceEvents``: complete
    events with ``ts`` and ``dur`` in microseconds)."""
    out = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        start = float(ev["ts"]) * 1e-6
        end = start + float(ev["dur"]) * 1e-6
        name = str(ev.get("name", ""))
        if cat in DEVICE_CATS:
            out.device.append((name, start, end))
        elif cat in HOST_CATS:
            out.host.append((name, start, end))
            if name == WINDOW_SPAN and cat == "user_annotation":
                out.window = (start, end)
    out.device.sort(key=lambda e: e[1])
    out.host.sort(key=lambda e: e[1])
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the block with CPU and CUDA activity when ``enabled``;
    yields a dict that gets ``trace`` (a :class:`Trace`) once the block
    is left. The Chrome trace goes to a temporary file and is deleted."""
    box: dict = {}
    if not enabled:
        yield box
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        yield box
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            box["trace"] = from_chrome(json.load(fh)["traceEvents"])
    finally:
        os.unlink(path)


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, merged and sorted."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy(trace: Trace) -> list[tuple[float, float]]:
    """The device's busy intervals inside the window."""
    lo, hi = trace.window
    return union(clip([(a, b) for _, a, b in trace.device], lo, hi))


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy(trace))


def device_seconds(trace: Trace, patterns) -> float:
    """Summed device time inside the window of the kernels whose name
    holds one of ``patterns``."""
    lo, hi = trace.window
    return sum(min(b, hi) - max(a, lo) for name, a, b in trace.device
               if b > lo and a < hi and any(p in name for p in patterns))


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """The intervals of the window in which no device operation ran."""
    lo, hi = trace.window
    gaps, t = [], lo
    for a, b in busy(trace):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_label(trace: Trace, t: float) -> str:
    """The innermost host op or benchmark span that holds the time ``t``
    (the latest to start among those that hold it)."""
    label = "no host span"
    for name, a, b in trace.host:
        if a > t:
            break
        if b >= t:
            label = name
    return label


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time inside the window, and
    the longest idle gaps named by what the host was doing halfway
    through them."""
    lo, hi = trace.window
    totals: dict[str, float] = {}
    for name, a, b in trace.device:
        if b > lo and a < hi:
            totals[name] = totals.get(name, 0.0) + min(b, hi) - max(a, lo)
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[host_label(trace, (a + b) / 2), b - a]
                          for a, b in gaps]}


def idle_pct(trace: Trace | None) -> float | None:
    """The share of the window (%) with no device operation, or None
    without a trace or a device operation in it."""
    if trace is None or trace.window is None or trace.window_s <= 0:
        return None
    b = busy_s(trace)
    return None if b <= 0 else 100.0 * (1.0 - b / trace.window_s)
