#!/usr/bin/env python3
"""Sweep of the K5 MLE work-queue kernel's compile-time constants on one
NVIDIA GPU, at box 7 from u16 chunks:

    python3 tests/torch_k5_queue_sweep.py

The constants are those of picasso_torch/csrc/mle_queue.cuh: the
refill threshold R (PICASSO_K5Q_REFILL: free slots of a warp that refill
together) and the launch bounds (PICASSO_K5Q_THREADS a block,
PICASSO_K5Q_MIN_BLOCKS resident a SM), as a grid. The script builds the
package's kernels (picasso_torch/_build.py) and, alongside, one shared
library per variant from winfit_mle_queue.cu restricted to box 7 (one
nvcc per variant, all started together), into picasso_torch/.build/.
Each variant is held to K1 bit for bit (sigmaxy and sigma) on 131,072
make_spots and on the hits of the first 256-frame chunk of
chip_smoke.py's movie, then the variants are timed there in rounds
(each round visits every variant once; the median of 5 CUDA-event runs
a visit, the median over the rounds reported): queue launch + the
CRLB/LL pass, as ops/winfit_cuda.fit_mle_queue_t runs them. Prints the
card, then one JSON line a variant (its registers, local bytes, resident
blocks a SM and times); exits non-zero without a CUDA device or on any
mismatch.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX, EPS, MAX_IT, MIN_NG = 7, 1e-3, 100, 4000
# (refill, threads, min blocks)
VARIANTS = [(r, t, b) for r in (1, 4, 8, 16, 32)
            for t, b in ((128, 2), (128, 3), (256, 2), (256, 3))]
ROUNDS = 3
STUB = """#include "winfit_mle_queue.cuh"
// the sweep's libraries take u16 chunks only
int picasso_winfit_mle_queue_f32(const float*, int, int,
                                 const WinfitMleQueueArgs&) {
  return (int)cudaErrorInvalidValue;
}
"""


def _median_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_variants(out_dir) -> dict:
    """Compile every (R, threads, min blocks) variant; returns variant ->
    library path. Raises with nvcc's message if one fails."""
    from picasso_torch import _build

    nvcc = _build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)]
    stub = out_dir / "stub.cu"
    stub.write_text(STUB)
    jobs = {"stub": subprocess.Popen(
        [nvcc, *flags, "-c", "-o", str(out_dir / "stub.o"), str(stub)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for key in VARIANTS:
        refill, threads, min_blocks = key
        jobs[key] = subprocess.Popen(
            [nvcc, *flags, f"-DPICASSO_K5Q_ONLY_BOX={BOX}",
             f"-DPICASSO_K5Q_REFILL={refill}",
             f"-DPICASSO_K5Q_THREADS={threads}",
             f"-DPICASSO_K5Q_MIN_BLOCKS={min_blocks}", "-c", "-o",
             str(out_dir / "{}_{}_{}.o".format(*key)),
             str(_build.CSRC / "winfit_mle_queue.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    logs = {}
    for key, proc in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err[-4000:]}")
        logs[key] = out + err
    libs = {}
    for key in jobs:
        if key == "stub":
            continue
        lib = out_dir / "libk5q_{}_{}_{}.so".format(*key)
        proc = subprocess.run(
            [nvcc, "-shared", *_build.NVCC_FLAGS[:2], "-o", str(lib),
             str(out_dir / "{}_{}_{}.o".format(*key)),
             str(out_dir / "stub.o")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"link failed for {key}:\n{proc.stderr}")
        libs[key] = lib
    (out_dir / "sweep_build.log").write_text(
        "\n".join(f"{k}:\n{v}" for k, v in logs.items()))
    return libs


def main() -> int:
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from picasso_torch import _build
    from picasso_torch.ops import identify, identify_cuda, mle_cuda
    from picasso_torch.ops import winfit_cuda as wc
    from picasso_torch.ops._fit_common import FINISH
    from torch_data import make_bench_movie, make_spots, spots_chunk

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    main_build = threading.Thread(target=_build.build)  # alongside
    main_build.start()
    libs = build_variants(_build.BUILD_ROOT
                          / f"k5q-sweep-{_build.source_hash()}")
    main_build.join()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    loaded = {k: ctypes.CDLL(str(p)) for k, p in libs.items()}
    for lib in loaded.values():
        for name in ("picasso_winfit_mle_queue",
                     "picasso_winfit_mle_queue_info"):
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int

    spots = make_spots(131072, BOX, seed=0)
    frames, hits = spots_chunk(spots, np.uint16)
    inputs = {"make_spots": (torch.from_numpy(frames).to(dev),
                             [torch.from_numpy(h).to(dev) for h in hits])}
    movie = make_bench_movie(2048, 256, 1200, 0.5, np.random.default_rng(13))
    chunk = identify.upload_frames(movie[:256], dev)
    inputs["chunk 0"] = (chunk, list(identify.compact(
        *identify_cuda.identify_tiles(chunk, MIN_NG, BOX), BOX)[:3]))
    # the (3, N) int32 hit list the kernels take
    hit_lists = {what: torch.stack(h).to(torch.int32).contiguous()
                 for what, (_, h) in inputs.items()}

    def fit(lib, frames, h, method):
        carry = wc._launch_queue(lib, frames, h, 0.0, 1.0, BOX, EPS, MAX_IT,
                                 method)
        return wc._launch_mle(FINISH, frames, h, 0.0, 1.0, BOX, EPS, 0,
                              method, carry)

    cases = [(what, method) for what in inputs
             for method in ("sigmaxy", "sigma")]
    for what, method in cases:
        frames, hits = inputs[what]
        k1 = [a.cpu().numpy() for a in mle_cuda.fit_one_pass_t(
            wc.photons_t(frames, *hits, BOX, 0.0, 1.0), EPS, MAX_IT, method)]
        for key, lib in loaded.items():
            got = [a.cpu().numpy()
                   for a in fit(lib, frames, hit_lists[what], method)]
            for a, b in zip(got, k1):
                if not np.array_equal(a, b, equal_nan=True):
                    raise AssertionError(f"variant {key} != K1 on {what} "
                                         f"{method}")
    print(f"every variant == K1 bit for bit ({', '.join(inputs)}; sigmaxy, "
          "sigma)")

    times = {(key, case): [] for key in loaded for case in cases}
    for _ in range(ROUNDS):
        for key, lib in loaded.items():
            for what, method in cases:
                frames, h = inputs[what][0], hit_lists[what]
                times[key, (what, method)].append(_median_ms(
                    lambda: fit(lib, frames, h, method)))
    for key, lib in loaded.items():
        row = dict(zip(("refill", "threads", "min_blocks"), key))
        for method in ("sigmaxy", "sigma"):
            info = wc.queue_info(torch.uint16, BOX, method, lib)
            row[method] = {k: info[k] for k in ("registers", "local_bytes",
                                                "blocks_per_sm")}
        row["ms"] = {f"{what} {method}": round(statistics.median(
            times[key, (what, method)]), 4) for what, method in cases}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
