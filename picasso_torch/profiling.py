"""Tracing and stage timing of the port: a ``torch.profiler`` trace of a
block of code, named spans on its timeline, and a host wall-clock stage
log.

Counterpart of picasso_tpu/profiling.py (trace :32, annotate :52,
StageTimer :71), with torch.profiler in place of jax.profiler:

    from picasso_torch import profiling

    with profiling.trace("/tmp/picasso_trace"):
        locs = localize.localize(movie, camera_info, params)

    @profiling.annotate("fit-chunk")
    def my_stage(...): ...

or from the CLI: ``python -m picasso_torch localize movie.raw --profile
DIR``. The trace is a Chrome trace, ``DIR/trace.json``, of the host and,
where a card is present, of its kernels (CUPTI). Unlike JAX, no
environment variable turns tracing on: only the argument does.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None, create_perfetto_link: bool = False):
    """Profile the block's host work and, with a card, its CUDA kernels,
    into ``log_dir``/trace.json (written also when the block raises).
    Yields ``log_dir``; a no-op yielding None when it is None or empty.
    ``create_perfetto_link`` is accepted for JAX's signature and
    ignored: torch.profiler makes no link."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Decorator: run a function inside ``torch.profiler.record_function
    (name)``, a labelled span on the profile's timeline."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


class StageTimer:
    """Lightweight wall-clock stage log (host side): collects
    (stage, seconds) pairs for pipeline summaries."""

    def __init__(self):
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def report(self) -> str:
        total = sum(dt for _, dt in self.stages)
        lines = [
            f"{name}: {dt:.3f}s ({dt / total * 100:.0f}%)"
            for name, dt in self.stages
        ]
        lines.append(f"total: {total:.3f}s")
        return "\n".join(lines)
