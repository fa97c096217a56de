"""The program's spans in a traced window: ``picasso.<layer>.<step>``
host intervals that ``picasso_torch/profiling.span`` puts on the
profiler's clock (``Trace.host``), read by exact name.

A metric of one span is its seconds inside the window over the calls of
the window (every call lies inside the window's span). Intervals of one
name are merged before they are summed, so a span nested in another of
its name counts once and repeated spans add up. Without a trace, or
without a span of the name in the window, there is nothing to read:
None, as from a program that opens no such span.
"""

from __future__ import annotations

from core.trace import Trace, clip, idle_gaps, union

PREFIX = "picasso."


def intervals(trace: Trace | None, name: str) -> list[tuple[float, float]]:
    """The union of the host intervals named ``name``, clipped to the
    window."""
    if trace is None or trace.window is None:
        return []
    lo, hi = trace.window
    return union(clip([(a, b) for n, a, b in trace.host if n == name],
                      lo, hi))


def seconds(trace: Trace | None, name: str) -> float | None:
    """Seconds of the window inside spans named ``name``, or None."""
    got = intervals(trace, name)
    return sum(b - a for a, b in got) if got else None


def per_call(record: dict, name: str) -> float | None:
    """:func:`seconds` of ``name`` over the window's calls, or None."""
    s = seconds(record["trace"], name)
    calls = len(record["calls"])
    return s / calls if s is not None and calls else None


def idle_outside_share(trace: Trace | None,
                       prefix: str = PREFIX) -> float | None:
    """The share of the window's idle device time that lies in no host
    span whose name starts with ``prefix`` (idle seconds the program's
    spans do not name), or None without a trace or idle time."""
    if trace is None or trace.window is None:
        return None
    gaps = idle_gaps(trace)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    lo, hi = trace.window
    named = union(clip([(a, b) for n, a, b in trace.host
                        if n.startswith(prefix)], lo, hi))
    covered, j = 0.0, 0
    for a, b in gaps:
        while j < len(named) and named[j][1] <= a:
            j += 1
        k = j
        while k < len(named) and named[k][0] < b:
            covered += min(b, named[k][1]) - max(a, named[k][0])
            k += 1
    return 1.0 - covered / idle
