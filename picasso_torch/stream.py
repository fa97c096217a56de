"""Background decoding of frame chunks, so reading the movie overlaps
the device work on the previous chunk.

Counterpart of picasso_tpu/stream.py ChunkPrefetcher (:33).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class ChunkPrefetcher:
    """Reads frame chunks of a (possibly lazy) movie into a bounded
    queue from a background thread. Iterating yields ``(first_frame,
    chunk)`` with ``chunk`` a private, writable copy, so a memory-mapped
    movie is read from disk in the background thread and not later by
    the consumer; an error in the reader is raised by ``__next__``. Call
    :meth:`close` when done."""

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
                if not self._put((lo, np.array(self.movie[lo:hi]))):
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
