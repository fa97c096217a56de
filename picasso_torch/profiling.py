"""Tracing of the port: a ``torch.profiler`` trace of a block of code,
and named spans on its timeline that also time their block on the host.

Counterpart of picasso_tpu/profiling.py (trace :32, annotate :52), with
torch.profiler in place of jax.profiler:

    from picasso_torch import profiling

    with profiling.trace("/tmp/picasso_trace"):
        locs = localize.localize(movie, camera_info, params)

    with profiling.span("picasso.stream.upload", perf, "upload_dispatch_s"):
        chunk = upload_frames(batch, device)

    @profiling.annotate("my-stage")
    def my_stage(...): ...

or from the CLI: ``python -m picasso_torch localize movie.raw --profile
DIR``. The trace is a Chrome trace, ``DIR/trace.json``, of the host and,
where a card is present, of its kernels (CUPTI). Unlike JAX, no
environment variable turns tracing on: only the argument does.

A span is a ``record_function`` on the profiler's clock, the clock of
the device's events in the same trace, opened only while a profiler is
recording (off, a span costs one flag read); with a ``perf`` dict it
also adds its block's host seconds to ``perf[key]``, profiler or not.
The program writes no trace itself: the profiler keeps the spans and
writes them when it stops. Spans are named ``picasso.<layer>.<step>``:

- localize: ``picasso.localize`` (the fused call), ``picasso.stream.
  decode_wait`` and ``picasso.stream.upload`` (each chunk),
  ``picasso.fused.chain`` (the chain of one chunk on one device:
  ``picasso.fused.identify``, ``.fit``, ``.pack``) or ``picasso.fused.
  mesh_chain`` (over a mesh's shards), ``picasso.fused.drain`` (its
  readback), then ``picasso.localize.gather`` (the payloads into ids
  and fit columns) and ``picasso.localize.locs_table``;
- undrift: ``picasso.undrift`` (the call), ``picasso.undrift.upload``
  (the locs' records to the device), ``.segment`` (the renders),
  ``.xcorr`` (the pair correlations to the host), ``.peak_fit`` (the
  host peak fits), ``.solve`` (least squares and the splines) and
  ``.apply`` (``apply_drift`` on the device and the records back).

A span is never left open across a generator's ``yield``, and spans
opened in a worker thread are not in the trace: they belong on the
thread that runs the profiled block.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


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


class span:
    """Context manager: the block as the span ``name`` on a recording
    profiler's timeline (no ``record_function`` otherwise), and, where
    ``perf`` is a dict, its host seconds added to ``perf[key]``."""

    __slots__ = ("name", "perf", "key", "_rf", "_t0")

    def __init__(self, name: str, perf: dict | None = None,
                 key: str | None = None):
        self.name, self.perf, self.key = name, perf, key

    def __enter__(self):
        self._rf = None
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.perf is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.perf is not None:
            self.perf[self.key] = (self.perf.get(self.key, 0.0)
                                   + time.perf_counter() - self._t0)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def annotate(name: str):
    """Decorator: run a function inside :class:`span` ``name``, a
    labelled span on a recording profile's timeline."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
