"""The JAX package's native library (picasso_tpu.native), loaded for the
port's tests that hold the host walks to it.

picasso_tpu.native builds libpicasso_native.so with g++ when it is first
imported and the file is missing. When several test processes import it
at the same moment on a fresh checkout, one of them may find a file that
another is still writing, and is left with ``AVAILABLE`` false: the JAX
package then falls back to Python, but a test that calls the library
directly would fail. :func:`loaded_native` loads it once more in such a
process, after the build that won has written the file.
"""

from __future__ import annotations

import fcntl
import os
import tempfile

LOCK_NAME = "picasso_native_load.lock"


def loaded_native():
    """picasso_tpu.native with its library loaded. A process that lost
    the build race takes an exclusive lock under the temporary directory
    and loads the library again; if that fails too, it raises."""
    from picasso_tpu import native

    if not native.AVAILABLE or native._lib is None:
        lock = os.path.join(tempfile.gettempdir(), LOCK_NAME)
        with open(lock, "a") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                native._load()
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)
    if not native.AVAILABLE or native._lib is None:
        raise RuntimeError(
            "picasso_tpu.native: libpicasso_native.so could not be built "
            f"or loaded from {native._LIB}")
    return native
