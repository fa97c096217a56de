"""Frame chunks of a (possibly lazy) movie on the device: background
decoding, so reading the movie overlaps the device work on the previous
chunk, and the single-pass identify + ROI cut of lazy movies.

Counterpart of picasso_tpu/stream.py (ChunkPrefetcher :33,
identify_and_cut :116) and of the chunking that picasso_tpu's
localize_fused and identify share. Each chunk uploads once: K4
identifies it and the ROIs are cut from the same device copy.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, Literal

import numpy as np


class ChunkPrefetcher:
    """Reads frame chunks of a (possibly lazy) movie into a bounded
    queue from a background thread. Iterating yields ``(first_frame,
    chunk)`` with ``chunk`` an array of its own: a view (of an in-RAM or
    memory-mapped movie) is copied, so a memory-mapped movie is read
    from disk in the background thread and not later by the consumer;
    the fresh array a lazy reader returns is passed on as it is. An
    error in the reader is raised by ``__next__``. Call :meth:`close`
    when done."""

    def __init__(self, movie, chunk_bounds: list[tuple[int, int]],
                 depth: int = 2):
        self.movie = movie
        self.bounds = chunk_bounds
        self.q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self.stop_event = threading.Event()
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        while not self.stop_event.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for lo, hi in self.bounds:
                if self.stop_event.is_set():
                    break
                batch = self.movie[lo:hi]
                if not (isinstance(batch, np.ndarray) and batch.flags.owndata
                        and not isinstance(batch, np.memmap)):
                    batch = np.array(batch)
                if not self._put((lo, batch)):
                    break
        except BaseException as exc:  # surfaced in __next__
            self.error = exc
        finally:
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item

    def close(self):
        self.stop_event.set()
        try:  # drain so the producer can leave its put()
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=5)


def frame_range(n_frames: int, frame_bounds) -> list[int]:
    """The frames within ``frame_bounds``, whose upper bound is inclusive
    as in the reference (picasso/localize.py:394-401)."""
    lo, hi = 0, n_frames
    if frame_bounds is not None:
        if frame_bounds[0] is not None:
            lo = max(frame_bounds[0], 0)
        if frame_bounds[1] is not None:
            hi = min(frame_bounds[1], n_frames)
    return [f for f in range(n_frames) if lo <= f <= hi]


def frame_chunk_for(n_frames: int, height: int, width: int) -> int:
    """Frames a chunk by default (picasso_tpu/ops/fused.py:1190-1195):
    ~64 MB of f32 frames (localize._id_frame_chunk), the ``n_frames``
    split evenly, rounded up to 32 frames when there is more than one
    chunk, so no chunk is a short tail."""
    from picasso_torch.localize import _id_frame_chunk

    n_chunks = max(1, -(-n_frames // _id_frame_chunk(height, width)))
    frame_chunk = -(-n_frames // n_chunks)
    if n_chunks > 1:
        frame_chunk = -(-frame_chunk // 32) * 32
    return frame_chunk


def chunk_bounds(frames_idx: list[int],
                 frame_chunk: int) -> list[tuple[int, int]]:
    """(first, end) frames of each chunk of ``frame_chunk`` frames."""
    return [(frames_idx[s],
             frames_idx[min(s + frame_chunk, len(frames_idx)) - 1] + 1)
            for s in range(0, len(frames_idx), frame_chunk)]


def device_chunks(movie, device, *, roi=None, frame_bounds=None,
                  frame_chunk: int | None = None, prefetch_depth: int = 2,
                  progress_callback=None, description: str = "",
                  perf: dict | None = None):
    """Yield ``(first_frame, chunk)`` for the frames within
    ``frame_bounds``: each chunk (B, Y, X), cropped to ``roi``, uploaded
    once to ``device`` by ops/identify.upload_frames (or, for ``device``
    None, the host array, as a mesh's shards upload their parts) while
    the next one decodes in the background. ``perf``, where given, gets
    the chunk geometry (``n_chunks``, ``frame_chunk``) and accumulates
    the seconds spent waiting for decoded chunks (``decode_wait_s``,
    span ``picasso.stream.decode_wait``), uploading them
    (``upload_dispatch_s``, span ``picasso.stream.upload``) and the
    bytes uploaded (``upload_bytes``)."""
    from picasso_torch import lib
    from picasso_torch.ops.identify import upload_frames
    from picasso_torch.profiling import span

    frames_idx = frame_range(len(movie), frame_bounds)
    if not frames_idx:
        return
    height, width = np.asarray(movie[0]).shape[-2:]
    if roi is not None:
        (y0, x0), (y1, x1) = roi
        height, width = y1 - y0, x1 - x0
    if frame_chunk is None:
        frame_chunk = frame_chunk_for(len(frames_idx), height, width)
    bounds = chunk_bounds(frames_idx, frame_chunk)
    if perf is not None:
        perf.update(n_chunks=len(bounds), frame_chunk=frame_chunk,
                    decode_wait_s=0.0, upload_dispatch_s=0.0,
                    upload_bytes=0)
    prefetcher = ChunkPrefetcher(movie, bounds, prefetch_depth)
    try:
        with lib.progress_reporter(progress_callback, len(frames_idx),
                                   description) as rep:
            done = 0
            while True:
                with span("picasso.stream.decode_wait", perf,
                          "decode_wait_s"):
                    item = next(prefetcher, None)
                if item is None:
                    break
                offset, batch = item
                if roi is not None:
                    batch = batch[:, y0:y1, x0:x1]
                if device is None:
                    chunk = batch
                else:
                    with span("picasso.stream.upload", perf,
                              "upload_dispatch_s"):
                        chunk = upload_frames(batch, device)
                    if perf is not None:
                        perf["upload_bytes"] += int(batch.nbytes)
                yield offset, chunk
                done += len(batch)
                rep.set_value(done)
                if callable(progress_callback):
                    progress_callback(done)
    finally:
        prefetcher.close()


def identify_and_cut(
    movie,
    minimum_ng: float,
    box: int,
    *,
    roi: tuple[tuple[int, int], tuple[int, int]] | None = None,
    frame_bounds: tuple[int, int] | None = None,
    frame_chunk: int | None = None,
    prefetch_depth: int = 2,
    progress_callback: Callable[[int], None] | Literal["console"] | None = None,
    abort_callback: Callable[[], bool] | None = None,
    device="cuda",
):
    """One pass over the movie: each chunk is identified on ``device``
    (K4) while the next decodes, and its ROIs are cut from the same
    device copy. Returns ``(identifications, spots)``: the structured
    identifications of ops/fused (frame-sorted) and the raw (N, box, box)
    ROIs, u16 for a u16 movie and f32 otherwise (the dtypes of
    ops/identify.upload_frames), equal to ``localize.identify`` +
    ``localize.get_spots_raw``; ``(None, None)`` if aborted."""
    from picasso_torch import lib
    from picasso_torch.ops.fused import make_ids
    from picasso_torch.ops.identify import compact
    from picasso_torch.ops.identify_cuda import identify_tiles
    from picasso_torch.ops.winfit_cuda import cut_rois_t

    device = lib.resolve_device(device)
    hits, spots = [], []
    with contextlib.closing(device_chunks(
            movie, device, roi=roi, frame_bounds=frame_bounds,
            frame_chunk=frame_chunk, prefetch_depth=prefetch_depth,
            progress_callback=progress_callback,
            description="Identifying spots")) as chunks:
        for offset, chunk in chunks:
            if abort_callback is not None and abort_callback():
                return None, None
            f, y, x, ng = compact(*identify_tiles(chunk, minimum_ng, box), box)
            rois = cut_rois_t(chunk, f, y, x, box).permute(2, 0, 1)
            hits.append((offset, *(a.cpu().numpy() for a in (f, y, x, ng))))
            spots.append(rois.cpu().numpy())
    u16 = np.asarray(movie[0]).dtype == np.uint16
    dtype = np.uint16 if u16 else np.float32
    ids = make_ids(hits, roi)
    if not spots:
        return ids, np.zeros((0, box, box), dtype)
    return ids, np.concatenate(spots).astype(dtype, copy=False)
