#!/usr/bin/env python3
"""Sweep of the K5 LM work-queue kernel's compile-time constants on one
NVIDIA GPU, at box 7 from u16 chunks, and the straggler tail of the LM
fit:

    python3 tests/torch_k5_lq_sweep.py [--against OLD/winfit_lq.cu]
                                       [--variants all|none|R,T;...]

The constants are those of picasso_torch/csrc/lq_queue.cuh: the
refill threshold R (PICASSO_K5LQ_REFILL: free slots of a warp that
refill together) and the threads a block T (PICASSO_K5LQ_THREADS), as
a grid. The script builds the package's kernels (picasso_torch/_build.py)
and, alongside, one shared library per variant from winfit_lq_queue.cu
restricted to box 7 (one nvcc per variant, all started together), into
picasso_torch/.build/. ``--against`` builds the one-pass kernel of
earlier commits, winfit_lq.cu (one thread a spot, C entry
picasso_winfit_lq; for example an earlier commit's, unpacked with ``git
archive``; its headers are read from its own directory) to time it in
the same call; whether it equals K3 bit for bit is printed, not
required.

Inputs: 131,072 make_spots laid out as a u16 chunk, and the hits of the
first 256-frame chunk of chip_smoke.py's movie. Printed: the card; the
ptxas rows of the LM kernels and the SASS opcode counts of the box-7 u16
queue instance and, with ``--against``, one-pass instance (where
cuobjdump is found); the plain
version's step counts on both inputs (chip_smoke.lq_step_stats); every
queue (the package's and each variant) held to K3 (csrc/lq_fit.cu on the
gather route's ROIs) bit for bit on both inputs, with its cooperative
steps; the tail split of chunk 0 for every build (chip_smoke.
lq_tail_split: the hits that run to max_it alone, those of more than
LONG_FIT steps alone, the rest alone, in turns); one max_it hit alone
through the queue (cooperative at once) and the ``--against`` kernel
(one thread);
then every build timed in rounds (each round visits every build once;
chip_smoke's median of 5 CUDA-event runs a visit, the median over the
rounds reported), one JSON line a build with its registers, local
bytes and resident blocks a SM. Exits non-zero without a CUDA device or
on any mismatch.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX, MAX_IT, MIN_NG, FTOL = 7, 100, 4000, 1e-6
# (refill R, threads T)
VARIANTS = [(r, t) for t in (128, 64) for r in (16, 8, 1)]
ROUNDS = 3
#: the C entry of an earlier one-pass winfit_lq.cu (``--against``)
ONE_PASS = "picasso_winfit_lq"
ONE_PASS_SIGNATURE = [
    ctypes.c_void_p, ctypes.c_int, *[ctypes.c_longlong] * 3,  # frames..X
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,  # hits, n, box
    ctypes.c_float, ctypes.c_float, ctypes.c_float,  # baseline, factor, ftol
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # k, theta, stream
]
STUB = """#include "winfit_lq_queue.cuh"
// the sweep's libraries take u16 chunks only
int picasso_winfit_lq_queue_f32(const float*, int,
                                const WinfitLqQueueArgs&) {
  return (int)cudaErrorInvalidValue;
}
"""


def _name(key) -> str:
    return "R{}_T{}".format(*key) if isinstance(key, tuple) else key


def _parse_variants(text: str) -> list:
    if text == "all":
        return list(VARIANTS)
    if text == "none":
        return []
    return [tuple(int(v) for v in part.split(",")) for part in text.split(";")]


def build_variants(out_dir, variants, against: str | None) -> dict:
    """Compile every variant (and ``against``); returns key -> library
    path. Raises with nvcc's message if one fails."""
    from picasso_torch import _build

    nvcc = _build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)]
    stub = out_dir / "stub.cu"
    stub.write_text(STUB)
    jobs = {}
    if variants:
        jobs["stub"] = [stub]
    for key in variants:
        r, t = key
        jobs[key] = [f"-DPICASSO_K5LQ_ONLY_BOX={BOX}",
                     f"-DPICASSO_K5LQ_REFILL={r}",
                     f"-DPICASSO_K5LQ_THREADS={t}",
                     str(_build.CSRC / "winfit_lq_queue.cu")]
    if against:
        # quotes-includes resolve beside the file first: its own headers
        jobs["against"] = [os.path.abspath(against)]
    procs = {}
    for key, args in jobs.items():
        obj = out_dir / f"{_name(key)}.o"
        procs[key] = subprocess.Popen(
            [nvcc, *(flags if key != "against" else _build.NVCC_FLAGS),
             *map(str, args[:-1]), "-c", "-o", str(obj), str(args[-1])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    logs = {}
    for key, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err[-4000:]}")
        logs[key] = out + err
    libs = {}
    for key in jobs:
        if key == "stub":
            continue
        lib = out_dir / f"lib{_name(key)}.so"
        objs = [out_dir / f"{_name(key)}.o"]
        if key != "against":
            objs.append(out_dir / "stub.o")
        proc = subprocess.run(
            [nvcc, "-shared", *_build.NVCC_FLAGS[:2], "-o", str(lib),
             *map(str, objs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"link failed for {key}:\n{proc.stderr}")
        libs[key] = lib
    (out_dir / "sweep_build.log").write_text(
        "\n".join(f"{_name(k)}:\n{v}" for k, v in logs.items()))
    return libs


SASS_KERNELS = {"one pass": "winfit_lq_kernelILi7ELi128EtE",
                "queue": "lq_queue_kernelILi7ELi128ENS_12ChunkWindowsItEE"}


def sass_counts(lib_path, nvcc) -> dict:
    """Instruction and opcode counts of the box-7 u16 instances of the
    one-pass and the queue kernel that ``lib_path`` holds (cuobjdump
    -sass), or {} when cuobjdump is not beside nvcc."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120).stdout
    counts, inside = {k: collections.Counter() for k in SASS_KERNELS}, None
    for line in text.splitlines():
        if "Function :" in line:
            inside = next((k for k, v in SASS_KERNELS.items() if v in line),
                          None)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if inside and m:
            counts[inside][m.group(1).split(".")[0]] += 1
    return {k: {"all": sum(c.values()), **dict(c.most_common(12))}
            for k, c in counts.items() if c}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="WINFIT_LQ_CU",
                        help="another winfit_lq.cu to time beside them")
    parser.add_argument("--variants", default="all",
                        help="'all', 'none' or R,T;R,T;...")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from chip_smoke import (
        _median_ms, _ptxas_table, lq_iters, lq_step_stats, lq_tail_split,
    )
    from picasso_torch import _build
    from picasso_torch.ops import identify, identify_cuda, lq_cuda
    from picasso_torch.ops import winfit_cuda as wc
    from torch_data import make_bench_movie, make_spots, spots_chunk

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    variants = _parse_variants(args.variants)
    t0 = time.perf_counter()
    main_build = threading.Thread(target=_build.build)  # alongside
    main_build.start()
    libs = build_variants(_build.BUILD_ROOT
                          / f"k5lq-sweep-{_build.source_hash()}", variants,
                          args.against)
    main_build.join()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for row in _ptxas_table((_build.build()[0].parent
                             / "build.log").read_text()):
        if "lq" in row:
            print("  ptxas:", row)
    sass = sass_counts(_build.build()[0], _build.find_nvcc())
    if "against" in libs:
        sass.update(sass_counts(libs["against"], _build.find_nvcc()))
    print("SASS, box-7 u16 instances:", json.dumps(sass))
    loaded = {}
    for key, path in libs.items():
        lib = ctypes.CDLL(str(path))
        names = ([ONE_PASS] if key == "against" else
                 ["picasso_winfit_lq_queue", "picasso_winfit_lq_queue_info"])
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = (ONE_PASS_SIGNATURE if name == ONE_PASS
                           else _build.SIGNATURES[name])
            fn.restype = ctypes.c_int
        loaded[key] = lib
        if key != "against":
            print(f"{_name(key)}: {wc.lq_queue_info(torch.uint16, BOX, lib)}")

    spots = make_spots(131072, BOX, seed=0)
    frames, hits = spots_chunk(spots, np.uint16)
    inputs = {"make_spots": (torch.from_numpy(frames).to(dev),
                             [torch.from_numpy(h).to(dev) for h in hits])}
    movie = make_bench_movie(2048, 256, 1200, 0.5, np.random.default_rng(13))
    chunk = identify.upload_frames(movie[:256], dev)
    inputs["chunk 0"] = (chunk, list(identify.compact(
        *identify_cuda.identify_tiles(chunk, MIN_NG, BOX), BOX)[:3]))
    rois = {what: wc.photons_t(fr, *h, BOX, 0.0, 1.0)
            for what, (fr, h) in inputs.items()}
    k3 = {what: lq_cuda.fit_t(r, MAX_IT, FTOL).cpu().numpy()
          for what, r in rois.items()}
    steps = {}
    for what, r in rois.items():
        it, rejected, reused = lq_iters(r, MAX_IT, FTOL)
        steps[what] = it
        print(f"{what}: plain LM steps "
              f"{json.dumps(lq_step_stats(it, MAX_IT, rejected, reused))}")

    def hit_list(h):
        return torch.stack(h).to(torch.int32).contiguous()

    def one_pass(lib):
        def fit(fr, h):
            hits = hit_list(h)
            n = hits.shape[1]
            theta = torch.empty((6, n), dtype=torch.float32, device=dev)
            status = getattr(lib, ONE_PASS)(
                fr.data_ptr(), 0, *fr.shape, hits.data_ptr(), n, BOX, 0.0,
                1.0, FTOL, MAX_IT, theta.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            _build.check(status, ONE_PASS)
            return theta
        return fit

    def queue(lib, coop=None):
        return lambda fr, h: wc._launch_lq_queue(
            lib, fr, hit_list(h), 0.0, 1.0, BOX, MAX_IT, FTOL, coop)

    package = _build.library()
    queues = {"queue": package, **{_name(k): lib for k, lib in loaded.items()
                                   if k != "against"}}
    fits = {name: queue(lib) for name, lib in queues.items()}
    if "against" in loaded:
        fits["against"] = one_pass(loaded["against"])

    # every build against K3 on both inputs: the queues bit for bit (with
    # their cooperative steps), the --against kernel as it is
    coop, bad = {}, []
    for name, fit in fits.items():
        for what, (fr, h) in inputs.items():
            if name in queues:
                counter = torch.zeros(1, dtype=torch.int32, device=dev)
                got = queue(queues[name], counter)(fr, h).cpu().numpy()
                coop[name, what] = int(counter.item())
            else:
                got = fit(fr, h).cpu().numpy()
            diff = ~((got == k3[what]) | (np.isnan(got)
                                          & np.isnan(k3[what]))).all(0)
            if name == "against":
                dxy = np.abs(got[:2] - k3[what][:2])
                print(f"against on {what}: == K3 bit for bit: "
                      f"{not diff.any()}; spots differing {int(diff.sum())},"
                      f" x/y max |d| {float(np.nanmax(dxy, initial=0.0))}")
            elif diff.any():
                bad.append(f"{name} on {what}: {int(diff.sum())} spots, "
                           f"steps {steps[what][diff][:20].tolist()}")
    if bad:
        raise AssertionError("!= K3 bit for bit: " + "; ".join(bad))
    print("the package's queue and every variant == K3 bit for bit "
          "(make_spots, chunk 0); cooperative steps "
          f"{json.dumps({f'{n} {w}': c for (n, w), c in coop.items()})}")

    # the tail split of chunk 0, and the latency of one max_it hit alone
    fr0, h0 = inputs["chunk 0"]
    for name, fit in fits.items():
        print(f"tail split {name} (ms alone, in turns): "
              f"{json.dumps(lq_tail_split(fit, fr0, h0, steps['chunk 0']))}")
    slow = [h[torch.from_numpy(steps["chunk 0"] == MAX_IT).to(dev)][:1]
            for h in h0]
    if slow[0].numel():
        for name in ("queue", *(["against"] if "against" in loaded else [])):
            lat = _median_ms(lambda: fits[name](fr0, slow))
            print(f"one max_it hit alone, {name}: {lat:.4f} ms for {MAX_IT} "
                  f"steps, {lat / MAX_IT * 1e3:.3f} us a step")

    times = {(b, w): [] for b in fits for w in inputs}
    for _ in range(ROUNDS):
        for b, fit in fits.items():
            for what, (fr, h) in inputs.items():
                times[b, what].append(_median_ms(lambda: fit(fr, h)))
    keys = {_name(k): k for k in loaded if k != "against"}
    for b in fits:
        row = {"build": b}
        if b in queues:
            if b in keys:
                row.update(zip(("refill", "threads"), keys[b]))
            info = wc.lq_queue_info(torch.uint16, BOX, queues[b])
            row.update({k: info[k] for k in ("registers", "local_bytes",
                                             "blocks_per_sm", "group")})
            row["coop_steps"] = {w: coop[b, w] for w in inputs}
        row["ms"] = {w: round(statistics.median(times[b, w]), 4)
                     for w in inputs}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
