"""Build and load the port's CUDA kernels (picasso_torch/csrc).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links the objects into one shared
library with a plain C interface, which ``ctypes`` loads. The build runs
at first use, into ``picasso_torch/.build/<hash of the sources>/``, so a
checkout builds itself and an edited source rebuilds. There is no
prebuilt fallback: without ``nvcc`` the build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / ".build"
CUDA_ROOT = "/usr/local/cuda"
LIB_NAME = "libpicasso_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures of the entries in csrc/*.cu (all return cudaError_t)
SIGNATURES = {
    "picasso_mle_fit": [
        _P, _LL, _I, _F, _I, _I, _LL,          # spots, n, box, eps, k, mode, n_valid
        _I,                                    # method: 0 sigmaxy, 1 sigma
        _P, _P, _P, _P, _P,                    # carry: theta old done iters max_step
        _P, _P, _P, _P,                        # out: theta, crlb, ll, iters
        _P,                                    # stream
    ],
    "picasso_lq_fit": [
        _P, _LL, _I, _F, _I, _LL,              # spots, n, box, ftol, k, n_valid
        _P, _P,                                # theta out, stream
    ],
    "picasso_winfit_mle": [
        _P, _I, _LL, _LL, _LL,                 # frames, dtype, B, Y, X
        _P, _LL, _I, _F, _F,                   # hits, n, box, baseline, factor
        _F, _I, _I, _I,                        # eps, k, mode, method
        _P, _P, _P, _P, _P,                    # carry: theta old done iters max_step
        _P, _P, _P, _P,                        # out: theta, crlb, ll, iters
        _P,                                    # stream
    ],
    "picasso_winfit_mle_queue": [
        _P, _I, _LL, _LL, _LL,                 # frames, dtype, B, Y, X
        _P, _LL, _I, _F, _F,                   # hits, n, box, baseline, factor
        _F, _I, _I, _P,                        # eps, max_it, method, counter
        _P, _P, _P, _P, _P,                    # carry: theta old done iters max_step
        _P,                                    # stream
    ],
    "picasso_winfit_mle_queue_info": [
        _I, _I, _I, _P,                        # dtype, box, method, int info[8]
    ],
    "picasso_winfit_lq_queue": [
        _P, _I, _LL, _LL, _LL,                 # frames, dtype, B, Y, X
        _P, _LL, _I, _F, _F,                   # hits, n, box, baseline, factor
        _F, _I, _P,                            # ftol, max_it, counter
        _P, _P,                                # theta out, coop steps or null
        _P,                                    # stream
    ],
    "picasso_winfit_lq_queue_info": [
        _I, _I, _P,                            # dtype, box, int info[7]
    ],
    "picasso_roi_mle_fit": [
        _P, _LL, _I, _F, _I, _LL,              # spots, n, box, eps, max_it, n_valid
        _I, _P,                                # method, counters and flags
        _P, _P, _P, _P,                        # out: theta, crlb, ll, iters
        _P,                                    # coop steps or null
        _P,                                    # stream
    ],
    "picasso_roi_mle_fit_info": [
        _I, _I, _P,                            # box, method, int info[8]
    ],
    "picasso_roi_lq_queue": [
        _P, _LL, _I, _F, _I, _LL,              # spots, n, box, ftol, max_it, n_valid
        _P, _P, _P,                            # counter, theta out, coop steps or null
        _P,                                    # stream
    ],
    "picasso_roi_lq_queue_info": [
        _I, _P,                                # box, int info[7]
    ],
    "picasso_mle_anybox": [
        _P, _LL, _I, _F, _I, _LL, _I,          # spots, n, box, eps, max_it,
        _P, _P, _P, _P, _P,                    # n_valid, method; work, out:
        _P,                                    # theta crlb ll iters; stream
    ],
    "picasso_mle_anybox_queue": [
        _P, _LL, _I, _F, _I, _LL, _I,          # spots, n, box, eps, max_it,
                                               # n_valid, method
        _I, _I, _I,                            # group, stage, cols in shared
        _P, _P, _LL,                           # counters and flags; work,
                                               # its slots
        _P, _P, _P, _P,                        # out: theta, crlb, ll, iters
        _P, _P,                                # coop steps or null, stream
    ],
    "picasso_mle_anybox_queue_info": [
        _I, _I, _I, _I, _P,                    # box, method, stage, cols,
    ],                                         # int info[6]
    "picasso_lq_anybox": [
        _P, _LL, _I, _F, _I, _LL,              # spots, n, box, ftol, max_it,
        _P, _P, _P,                            # n_valid; work, theta, stream
    ],
    "picasso_lq_anybox_queue": [
        _P, _LL, _I, _F, _I, _LL,              # spots, n, box, ftol, max_it,
                                               # n_valid
        _I, _I,                                # stage, threads
        _P, _P, _P,                            # counter, theta out, stream
    ],
    "picasso_lq_anybox_queue_info": [
        _I, _I, _I, _P,                        # box, stage, threads,
    ],                                         # int info[7]
    "picasso_cut_anybox": [
        _P, _I, _LL, _LL, _LL,                 # frames, dtype, B, Y, X
        _P, _LL, _P, _LL, _P, _LL,             # int64 rows f, y, x, strides
        _LL, _I, _F, _F,                       # n, box, baseline, factor
        _I, _I,                                # hits a tile, rows a band
        _P, _P,                                # out (box, box, n), stream
    ],
    "picasso_cut_anybox_direct": [
        _P, _I, _LL, _LL, _LL,                 # frames, dtype, B, Y, X
        _P, _LL, _I, _F, _F,                   # hits, n, box, baseline, factor
        _P, _P,                                # out (box, box, n), stream
    ],
    "picasso_identify_anybox": [
        _P, _I, _LL, _LL, _LL, _I, _F,         # frames, dtype, B, Y, X, box, min_ng
        _P, _P,                                # unit vectors uy, ux (box, box)
        _I, _I,                                # tile rows, log2 tile columns
        _P, _P, _P,                            # tile mask, loc, ng (zeroed)
        _P,                                    # stream
    ],
    "picasso_identify_anybox_direct": [
        _P, _I, _LL, _LL, _LL, _I, _F,         # frames, dtype, B, Y, X, box, min_ng
        _P, _P,                                # unit vectors uy, ux (box, box)
        _P, _P, _P,                            # tile mask, loc, ng (zeroed)
        _P,                                    # stream
    ],
    "picasso_identify_tiles": [
        _P, _I, _LL, _LL, _LL, _I, _F,         # frames, dtype, B, Y, X, box, min_ng
        _P, _P, _P,                            # tile mask, loc, ng
        _P,                                    # stream
    ],
    "picasso_apply_drift_records": [
        _P, _LL, _I, _P, _I,                   # in, n, in_size, out, out_size
        _P, _I, _I, _I, _I,                    # segments, their count; frame
                                               # offset, bytes, signed
        _P, _LL, _I,                           # drift (frames, k) f64
        _I, _I, _P,                            # tile, word bytes, bad flag
        _P,                                    # stream
    ],
    "picasso_link_walk": [
        _P, _P, _LL, _P,                       # offsets, succ, n, out (host)
    ],
    "picasso_cluster_sweep": [
        _P, _P, _P, _P, _LL, _P,               # maxima, starts, stops, cols, m,
    ],                                         # labels (host)
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    CUDA_ROOT. Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), CUDA_ROOT):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        f"nvcc not found (PATH, CUDA_HOME, {CUDA_ROOT}): the CUDA "
        "kernels of picasso_torch cannot be built"
    )


def build() -> tuple[Path, float]:
    """Compile the kernels unless this source hash is built already.
    Returns (library path, seconds spent compiling; 0 when cached). The
    ptxas report (registers, spills) is kept in ``build.log`` beside the
    library."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib, 0.0
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
                   str(Path(tmp) / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp_lib),
                *[cmd[-2] for cmd, _ in jobs]]
        log, failed = [], []
        for cmd, proc in jobs:
            out, err = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp_lib, lib)
    return lib, time.perf_counter() - t0


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use) with its C
    signatures declared. Safe under threads (the mesh's shard workers,
    picasso_torch/parallel/mesh.py): the first caller builds and loads it
    while the others wait."""
    with _LIBRARY_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.picasso_error_string.argtypes = [ctypes.c_int]
    lib.picasso_error_string.restype = ctypes.c_char_p
    return lib


_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


def count_launch(fn, n: int = 1) -> None:
    """Add ``n`` to the launch count ``fn.launches`` of a kernel wrapper,
    exactly under threads, and to the tally of the calling thread where
    :func:`tally` opened one."""
    with _COUNT_LOCK:
        fn.launches += n
    counts = getattr(_TALLY, "counts", None)
    if counts is not None:
        key = f"{fn.__module__}.{fn.__name__}"
        counts[key] = counts.get(key, 0) + n


@contextlib.contextmanager
def tally():
    """Count the launches made by this thread inside the block: yields a
    dict {"module.wrapper": launches} that fills as it runs."""
    outer = getattr(_TALLY, "counts", None)
    _TALLY.counts = counts = {}
    try:
        yield counts
    finally:
        _TALLY.counts = outer
        if outer is not None:
            for key, n in counts.items():
                outer[key] = outer.get(key, 0) + n


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if status != 0:
        msg = library().picasso_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
