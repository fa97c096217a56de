#!/usr/bin/env python3
"""Sweep of the any-box kernels' launch configurations on one NVIDIA GPU:

    python3 tests/torch_anybox_sweep.py [--rounds N] [--spots N]
        [--boxes 9,17,21] [--lq-boxes 16,17,21] [--only mle,k4,lq,cut]

The any-box MLE work queue (csrc/mle_anybox_queue.cu,
ops/mle_cuda.fit_anybox_t) keeps its threads a block, its refill
threshold and the busy slots a group at which a drained warp's tail
starts as compile-time constants: this script builds csrc/
mle_anybox_queue.cu once a variant of them with -DPICASSO_ANYQ_THREADS,
_REFILL and _TAIL (threads 64, 128 and 256; refill 8 and 24; the tail
from 0 (none), 2 and 8 busy slots a group), all builds at once. Where
the slots read a spot's pixels (the batch, or a stage in shared memory)
and whether the x axis's column factors sit in shared memory or in a
per-slot global scratch are launch arguments (ops/mle_cuda.
anybox_queue_config works them out from the box): every build runs
every pair of them whose shared bytes fit, both methods, at each box of
``--boxes``. K4 at any box (csrc/identify_anybox.cu) takes its output
tile as launch arguments (ops/identify_cuda.anybox_tile_shape works it
out from the box): rows x columns of a block at boxes 17 and 21.

Inputs: make_spots(``--spots``, box, seed=0) (131,072 by default) for the
fits; for K4 a 256-frame 256 x 256 u16 chunk of
make_wide_movie(256, 256, 100, 0.5, rng(23)) (the recipe of
chip_smoke.py's wide movie, 256 frames of it), min. net gradient 5000.
Every variant is held to the one-thread pass (ops/mle_cuda.
fit_anybox_one_pass_t) or the direct K4 (identify_tiles_anybox_direct)
bit for bit, and the direct K4 to the plain version
(torch_parity.compare_tiles). Then every variant is timed in ``--rounds``
rounds, each visiting the variants in the order A B C ... C B A (a
visit: the median of 5 CUDA-event runs of one call after a warm-up);
the median over the visits is reported, beside the one-thread pass or
the direct kernel in the same rounds; K4's fastest tile and the direct
kernel also in runs of 20 calls and by their device time in a
torch.profiler trace, and the clock cycles of each of K4's steps (a
build of csrc/identify_anybox.cu alone with -DPICASSO_K4ANY_CLOCKS).
The any-box LM work queue (csrc/lq_anybox_queue.cu, ops/lq_cuda.
fit_anybox_t) keeps its group (8 lanes) and its claim (all a warp's free
groups together) as compile-time constants, and takes where its pixels
live and its threads a block as launch arguments (ops/lq_cuda.
anybox_queue_config works them out from the box): at each box of
``--lq-boxes`` the package's build at its configuration, at 32 threads
and with the pixels read from the batch, beside builds of
csrc/lq_anybox_queue.cu alone with -DPICASSO_LQANY_GROUP=4, 16 and 32
(below the box a group's lanes loop over the points and rows),
-DPICASSO_LQANY_REFILL=1 (each group claiming alone) at groups of 4, 8
and 16, and -DPICASSO_LQANY_MIN_BLOCKS=1 and 8 (resident blocks a SM
asked of ptxas; the package's asks 6), each held to the one-thread pass
(ops/lq_cuda.fit_anybox_one_pass_t) bit for bit and timed in rounds
beside it; then a build with -DPICASSO_LQANY_CLOCKS gives a trip's clock
cycles split into the claim, the stage, the initialiser, the axis
points, the rows and their fold, the solve (dot sums, assembly, damped
step, acceptance) and the cost. (A lane a spot, the measured alternative
to the groups, lost at box 17 and left the source; PERF.md has its
times.) The any-box cut (csrc/cut_anybox.cu, ops/winfit_cuda.
cut_anybox_t) takes its hits a tile and rows a band as launch
arguments: at the same boxes on spots_chunk(make_spots(``--spots``, box,
0)) as a u16 chunk and its int64 hit rows, tiles of 8, 16 and 32 hits,
whole windows and bands of 4 rows, and builds of csrc/cut_anybox.cu
alone with -DPICASSO_CUT_BATCH=8 and 16 (a lane's reads in flight; the
package's 4), beside its direct kernel (cut_anybox_direct_t), each held
to photons_t bit for bit. ``--only``
picks the kernels swept (all by default).
Prints the card, each variant's registers, spills, shared bytes and
resident blocks a SM, the cooperative tail's spot-steps, one JSON line
a variant, and the fastest configuration a box and method; exits
non-zero without a CUDA device or on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS, MAX_IT, MIN_NG, FTOL = 1e-3, 100, 5000, 1e-6
# compile-time variants of the MLE queue beside the package's build
# (threads 32, refill 16, the tail from 4 busy slots a group): their
# PICASSO_ANYQ_THREADS, _REFILL and _TAIL
MLE_BUILDS = {"t64": (64, 16, 4), "t128": (128, 16, 4),
              "t256": (256, 16, 4), "refill 8": (32, 8, 4),
              "refill 24": (32, 24, 4), "no tail": (32, 16, 0),
              "tail at 2 a group": (32, 16, 2),
              "tail at 8 a group": (32, 16, 8)}
K4_BOXES = (17, 21)
K4_TILES = ((8, 32), (16, 32), (32, 32), (64, 32), (8, 64), (16, 64),
            (32, 64), (64, 64), (16, 128), (32, 128), (8, 256))


def median_ms(fn, reps: int = 5, calls: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``calls`` back-to-back
    calls of ``fn`` after a warm-up call, per call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(fn, name: str, calls: int = 10) -> float | None:
    """The device time a call of the kernels whose name holds ``name``,
    from torch.profiler over ``calls`` calls after a warm-up, or None
    where the trace shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if name in ev.key:
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
    return total / calls / 1e3 if total else None


def in_rounds(fns: dict, rounds: int) -> dict:
    """Median over ``rounds`` rounds (A B ... B A order) of each
    function's median_ms."""
    keys = list(fns)
    got = {k: [] for k in keys}
    for _ in range(rounds):
        for k in keys + keys[::-1]:
            got[k].append(median_ms(fns[k]))
    return {k: statistics.median(v) for k, v in got.items()}


def sass_counts(lib_path, needle: str) -> dict:
    """Opcode counts of the first kernel whose mangled name holds
    ``needle`` in the library (cuobjdump -sass), or {} without
    cuobjdump."""
    import collections
    import re

    from picasso_torch import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, inside, seen = collections.Counter(), False, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = needle in line and not seen
            seen = seen or inside
            continue
        m = re.match(
            r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            line)
        if inside and m:
            counts[m.group(1).split(".")[0]] += 1
    return dict(counts.most_common(24))


def same(a, b, what: str) -> None:
    for x, y in zip(a, b):
        if not np.array_equal(x.cpu().numpy(), y.cpu().numpy(),
                              equal_nan=True):
            raise AssertionError(f"{what}: differs bit for bit")


def build_mle_variants() -> dict:
    """Build csrc/mle_anybox_queue.cu once a variant of MLE_BUILDS (all
    at once, into picasso_torch/.build/anybox-sweep/); returns name ->
    (threads, loaded library)."""
    import ctypes

    from picasso_torch import _build

    out_dir = _build.BUILD_ROOT / "anybox-sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (threads, refill, tail) in MLE_BUILDS.items():
        lib = out_dir / f"libanyq_{threads}_{refill}_{tail}.so"
        jobs[name] = (threads, lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
             f"-DPICASSO_ANYQ_THREADS={threads}",
             f"-DPICASSO_ANYQ_REFILL={refill}", f"-DPICASSO_ANYQ_TAIL={tail}",
             "-o", str(lib), str(_build.CSRC / "mle_anybox_queue.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (threads, path, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(path))
        for fn in ("picasso_mle_anybox_queue",
                   "picasso_mle_anybox_queue_info"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (threads, lib)
    return libs


def mle_variants(box: int, builds: dict) -> dict:
    """name -> (library, launch arguments) of the MLE queue at ``box``:
    the package's build at every place of the pixels and the column
    factors whose shared bytes fit, the thread-count builds likewise,
    and the other builds at the package's choice."""
    from picasso_torch import _build
    from picasso_torch.ops import mle_cuda

    base = mle_cuda.anybox_queue_config(box)
    out = {}
    for name, (threads, lib) in [("t32", (32, _build.library())),
                                 *builds.items()]:
        grid = name in ("t32", "t64", "t128", "t256")
        for stage in mle_cuda.STAGES if grid else (base["stage"],):
            for cols in (True, False) if grid else (base["cols_shared"],):
                if mle_cuda.anybox_queue_smem(box, stage, cols, threads) \
                        > mle_cuda.SHARED_LIMIT:
                    continue
                key = name if not grid else (
                    f"{name} {stage} cols{'shared' if cols else 'global'}")
                out[key] = (lib, dict(base, stage=stage, cols_shared=cols))
    return out


def sweep_mle(box: int, n: int, rounds: int, smi: str, builds: dict) -> dict:
    import torch

    from picasso_torch.ops import mle_cuda
    from torch_data import make_spots

    sp = torch.from_numpy(np.ascontiguousarray(
        make_spots(n, box, seed=0).transpose(1, 2, 0))).to("cuda")
    variants = mle_variants(box, builds)
    default = "t32 {} cols{}".format(
        *(lambda c: (c["stage"], "shared" if c["cols_shared"] else
                     "global"))(mle_cuda.anybox_queue_config(box)))
    out = {"box": box, "default": default, "card": smi}
    for method in ("sigmaxy", "sigma"):
        one = mle_cuda.fit_anybox_one_pass_t(sp, EPS, MAX_IT, method)
        at_max = int((one[3] == MAX_IT).sum())
        print(f"box {box} {method}: {n} make_spots, {at_max} fits at max_it "
              f"{MAX_IT}, {int(one[3].sum())} steps in all")
        coop, info = {}, {}
        for name, (lib, cfg) in variants.items():
            c = torch.zeros(1, dtype=torch.int32, device="cuda")
            same(mle_cuda._launch_anybox(lib, sp, EPS, MAX_IT, method, None,
                                         cfg, c), one,
                 f"box {box} {method} {name}")
            coop[name] = int(c)
            info[name] = mle_cuda.anybox_queue_info(box, method, cfg, lib)
        fns = {name: (lambda lib=lib, cfg=cfg: mle_cuda._launch_anybox(
            lib, sp, EPS, MAX_IT, method, None, cfg))
            for name, (lib, cfg) in variants.items()}
        fns["one-thread pass"] = lambda: mle_cuda.fit_anybox_one_pass_t(
            sp, EPS, MAX_IT, method)
        ms = in_rounds(fns, rounds)
        for name, (_, cfg) in variants.items():
            print(json.dumps({"kernel": "mle anybox queue", "box": box,
                              "method": method, "variant": name,
                              "config": cfg, "ms": ms[name],
                              "coop_steps": coop[name], **info[name],
                              "card": smi}))
        best = min(variants, key=ms.get)
        out[method] = {"fastest": best, "fastest_ms": ms[best],
                       "default_ms": ms[default],
                       "one_pass_ms": ms["one-thread pass"],
                       "ms": {k: v for k, v in ms.items()}}
    print(json.dumps({"mle anybox queue summary": out}))
    return out


def k4_steps(chunk, tiles=((64, 64), (32, 32), (16, 64))) -> list:
    """Where K4 at any box spends its cycles: csrc/identify_anybox.cu
    built alone with -DPICASSO_K4ANY_CLOCKS (thread 0 of each block adds
    each step's clock64 cycles; the package's build has none of it) into
    picasso_torch/.build/anybox-sweep/, run at box 17 on the chunk in the
    given tiles; returns, a tile, the mean cycles of steps 0-5 a block
    and the blocks."""
    import ctypes

    import torch

    from picasso_torch import _build
    from picasso_torch.ops import identify_cuda

    out_dir = _build.BUILD_ROOT / "anybox-sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libk4clocks.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    "-DPICASSO_K4ANY_CLOCKS", "-o", str(lib_path),
                    str(_build.CSRC / "identify_anybox.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.picasso_identify_anybox
    fn.argtypes = _build.SIGNATURES["picasso_identify_anybox"]
    fn.restype = ctypes.c_int
    clocks = (ctypes.c_ulonglong * 8)()
    B, Y, X = chunk.shape
    box = 17
    uv = identify_cuda._unit_vectors(box, chunk.device)
    rows = []
    for oy, ox in tiles:
        mask, loc, ng = identify_cuda._tiles(chunk, box, torch.zeros)
        lib.picasso_identify_anybox_clocks(clocks)  # zero them
        status = fn(chunk.data_ptr(), 0, B, Y, X, box, float(MIN_NG),
                    uv[0].data_ptr(), uv[1].data_ptr(), oy,
                    ox.bit_length() - 1, mask.data_ptr(), loc.data_ptr(),
                    ng.data_ptr(), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if status != 0:
            raise RuntimeError(f"K4 clocks build: CUDA error {status}")
        lib.picasso_identify_anybox_clocks(clocks)
        blocks = max(int(clocks[7]), 1)
        rows.append({"tile": f"{oy}x{ox}", "blocks": blocks,
                     "cycles_a_block": [round(clocks[k] / blocks)
                                        for k in range(6)]})
        print(json.dumps({"K4 anybox steps (0 stage, 1 row runs, 2 row "
                          "maxima, 3 column runs, 4 test, 5 net gradient)":
                          rows[-1]}))
    return rows


def sweep_k4(chunk, rounds: int, smi: str) -> list:
    from picasso_torch.ops import identify, identify_cuda
    from torch_parity import compare_tiles

    out = []
    for box in K4_BOXES:
        direct = identify_cuda.identify_tiles_anybox_direct(chunk, MIN_NG,
                                                            box)
        compare_tiles([a.cpu().numpy() for a in direct],
                      [a.cpu().numpy() for a in identify.identify_tiles_plain(
                          chunk, MIN_NG, box)], f"direct K4 at box {box}")
        fns = {"direct": lambda box=box: identify_cuda.
               identify_tiles_anybox_direct(chunk, MIN_NG, box)}
        for tile in K4_TILES:
            if identify_cuda.anybox_tile_bytes(box, *tile) > \
                    identify_cuda.SHARED_LIMIT:
                continue
            same(identify_cuda._anybox_launch(chunk, MIN_NG, box, tile),
                 direct, f"K4 any box {box} tile {tile}")
            fns[f"{tile[0]}x{tile[1]}"] = (
                lambda box=box, tile=tile: identify_cuda._anybox_launch(
                    chunk, MIN_NG, box, tile))
        ms = in_rounds(fns, rounds)
        for name, t in ms.items():
            print(json.dumps({"kernel": "K4 anybox", "box": box, "tile": name,
                              "ms": t, "shared_bytes": None if name ==
                              "direct" else identify_cuda.anybox_tile_bytes(
                                  box, *map(int, name.split("x"))),
                              "card": smi}))
        best = min((k for k in ms if k != "direct"), key=ms.get)
        # the best tile and the direct kernel in runs of 20 calls (one
        # call's host work behind the last call's kernel) and their
        # device time in the profiler's trace
        runs = {k: median_ms(fns[k], calls=20) for k in (best, "direct")}
        dev = {k: device_ms(fns[k], "identify_any") for k in (best, "direct")}
        out.append({"box": box, "fastest": best, "fastest_ms": ms[best],
                    "direct_ms": ms["direct"], "runs_of_20_ms": runs,
                    "device_ms": dev, "card": smi})
        print(json.dumps({"K4 anybox summary": out[-1]}))
    return out


# builds of csrc/lq_anybox_queue.cu alone beside the package's (a group
# of 8 lanes, all a warp's free groups claiming together, 6 blocks a SM
# asked of ptxas): their -D flags
LQ_BUILDS = {
    **{f"g{g}": [f"-DPICASSO_LQANY_GROUP={g}"] for g in (4, 16, 32)},
    **{f"g{g} each alone": [f"-DPICASSO_LQANY_GROUP={g}",
                            "-DPICASSO_LQANY_REFILL=1"] for g in (4, 8, 16)},
    "min blocks 1": ["-DPICASSO_LQANY_MIN_BLOCKS=1"],
    "min blocks 8": ["-DPICASSO_LQANY_MIN_BLOCKS=8"],
    "clocks": ["-DPICASSO_LQANY_CLOCKS"]}
# builds of csrc/cut_anybox.cu alone: their -D flags
CUT_BUILDS = {"batch 8": ["-DPICASSO_CUT_BATCH=8"],
              "batch 16": ["-DPICASSO_CUT_BATCH=16"]}
CUT_TILES = (8, 16, 32)
CUT_BAND = 4  # rows a band of the banded cut variants


def build_alone(source: str, builds: dict, entries, tag: str) -> dict:
    """Build csrc/``source`` alone once a variant of ``builds`` (name ->
    -D flags; all at once, into picasso_torch/.build/anybox-sweep/),
    print their ptxas rows; returns name -> loaded library with the C
    signatures of ``entries``."""
    import ctypes

    from chip_smoke import _ptxas_table
    from picasso_torch import _build

    out_dir = _build.BUILD_ROOT / "anybox-sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, flags in builds.items():
        lib = out_dir / f"lib{tag}_{name.replace(' ', '_')}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", *flags,
             "-o", str(lib), str(_build.CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
        for row in _ptxas_table(out + err):
            print(f"  ptxas ({name}):", row)
        lib = ctypes.CDLL(str(path))
        for fn in entries:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def lq_variants(box: int, builds: dict) -> dict:
    """name -> (library, launch arguments) of the LM queue at ``box``: the
    package's build at its configuration, at 32 threads a block and with
    the pixels read from the batch; every -D build of LQ_BUILDS but the
    clocks at the configuration (the pixels staged: at these boxes every
    group's stages fit)."""
    from picasso_torch import _build
    from picasso_torch.ops import lq_cuda

    base = lq_cuda.anybox_queue_config(box)
    out = {"package": (_build.library(), base),
           "package t32": (_build.library(), dict(base, threads=32)),
           "package batch": (_build.library(), dict(base, stage="batch"))}
    for name, lib in builds.items():
        if name != "clocks":
            out[name] = (lib, base)
    return out


def sweep_lq(box: int, n: int, rounds: int, smi: str, builds: dict) -> dict:
    import torch

    from picasso_torch.ops import lq_cuda
    from torch_data import make_spots

    sp = torch.from_numpy(np.ascontiguousarray(
        make_spots(n, box, seed=0).transpose(1, 2, 0))).to("cuda")
    default = "package"
    one = lq_cuda.fit_anybox_one_pass_t(sp, MAX_IT, FTOL)
    variants = lq_variants(box, builds)
    info = {}
    for name, (lib, cfg) in variants.items():
        got = lq_cuda._launch_anybox(lib, sp, MAX_IT, FTOL, None, cfg)
        if not torch.equal(got.nan_to_num(7.0), one.nan_to_num(7.0)):
            raise AssertionError(f"LM queue box {box} {name}: differs from "
                                 "the one-thread pass bit for bit")
        info[name] = lq_cuda.anybox_queue_info(box, cfg, lib)
    fns = {name: (lambda lib=lib, cfg=cfg: lq_cuda._launch_anybox(
        lib, sp, MAX_IT, FTOL, None, cfg))
        for name, (lib, cfg) in variants.items()}
    fns["one-thread pass"] = lambda: lq_cuda.fit_anybox_one_pass_t(
        sp, MAX_IT, FTOL)
    ms = in_rounds(fns, rounds)
    for name, (_, cfg) in variants.items():
        print(json.dumps({"kernel": "lq anybox queue", "box": box,
                          "variant": name, "config": cfg, "ms": ms[name],
                          **info[name], "card": smi}))
    best = min(variants, key=ms.get)
    out = {"box": box, "default": default, "fastest": best,
           "fastest_ms": ms[best], "default_ms": ms[default],
           "one_pass_ms": ms["one-thread pass"], "card": smi}
    print(json.dumps({"lq anybox queue summary": out}))
    return out


def lq_clocks(box: int, n: int, lib) -> dict:
    """A trip's clock cycles of the LM queue's clocks build at ``box``
    (lane 0 of each warp sums each part; the package's group and claim):
    the mean cycles of a warp's trip in each part, the trips and
    warps."""
    import ctypes

    import torch

    from picasso_torch.ops import lq_cuda
    from torch_data import make_spots

    fn = lib.picasso_lq_anybox_queue_clocks
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sp = torch.from_numpy(np.ascontiguousarray(
        make_spots(n, box, seed=0).transpose(1, 2, 0))).to("cuda")
    clocks = (ctypes.c_ulonglong * 10)()
    parts = ("claim", "stage", "initialiser", "axis points",
             "rows and fold", "solve", "cost", "rest")
    fn(clocks)  # zero them
    lq_cuda._launch_anybox(lib, sp, MAX_IT, FTOL, None,
                           lq_cuda.anybox_queue_config(box))
    torch.cuda.synchronize()
    fn(clocks)
    trips = max(int(clocks[8]), 1)
    row = {"box": box, "group": lq_cuda.ANYBOX_GROUP,
           "warps": int(clocks[9]), "trips": int(clocks[8]),
           "cycles_a_trip": {p: round(clocks[k] / trips, 1)
                             for k, p in enumerate(parts)}}
    print(json.dumps({"lq anybox queue trip": row}))
    return row


def sweep_cut(box: int, n: int, rounds: int, smi: str,
              builds: dict) -> dict:
    import torch

    from picasso_torch.ops import winfit_cuda
    from torch_data import make_spots, spots_chunk

    frames, hits = spots_chunk(make_spots(n, box, seed=0), np.uint16)
    frames = torch.from_numpy(frames).to("cuda")
    hits = [torch.from_numpy(h).to("cuda") for h in hits]  # int64 rows
    plain = winfit_cuda.photons_t(frames, *hits, box, 0.0, 1.0)
    base = winfit_cuda.anybox_cut_config(box)
    fns = {"direct": lambda: winfit_cuda.cut_anybox_direct_t(
        frames, *hits, box, 0.0, 1.0)}
    cfgs = {}
    for tile in CUT_TILES:
        for rows in (base["rows"], CUT_BAND):
            cfg = {"hits": tile, "rows": min(rows, box)}
            if winfit_cuda.anybox_cut_smem(box, **cfg) > \
                    winfit_cuda.SHARED_LIMIT:
                continue
            cfgs[f"hits {tile} rows {cfg['rows']}"] = cfg
    from picasso_torch import _build

    libs = {name: _build.library() for name in cfgs}
    for build, lib in builds.items():
        cfgs[build] = dict(base)
        libs[build] = lib
    for name, cfg in cfgs.items():
        if not torch.equal(winfit_cuda._launch_cut(
                libs[name], frames, hits, box, 0.0, 1.0, cfg), plain):
            raise AssertionError(f"cut box {box} {name}: differs from "
                                 "photons_t")
        fns[name] = (lambda cfg=cfg, lib=libs[name]: winfit_cuda._launch_cut(
            lib, frames, hits, box, 0.0, 1.0, cfg))
    if not torch.equal(fns["direct"](), plain):
        raise AssertionError(f"direct cut box {box} differs from photons_t")
    ms = in_rounds(fns, rounds)
    for name, t in ms.items():
        print(json.dumps({"kernel": "cut anybox", "box": box, "variant": name,
                          "config": cfgs.get(name), "ms": t,
                          "shared_bytes": None if name == "direct" else
                          winfit_cuda.anybox_cut_smem(
                              box, cfgs[name]["hits"], cfgs[name]["rows"]),
                          "card": smi}))
    best = min(cfgs, key=ms.get)
    out = {"box": box, "default": base, "fastest": best,
           "fastest_ms": ms[best],
           "default_ms": ms[f"hits {base['hits']} rows {base['rows']}"],
           "direct_ms": ms["direct"], "card": smi}
    print(json.dumps({"cut anybox summary": out}))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--spots", type=int, default=131072)
    ap.add_argument("--boxes", default="9,17,21")
    ap.add_argument("--lq-boxes", default="16,17,21")
    ap.add_argument("--only", default="mle,k4,lq,cut")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("torch_anybox_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from picasso_torch import _build
    from picasso_torch.ops import identify
    from torch_data import make_wide_movie

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print("card (nvidia-smi name, power.limit):", smi)
    t0 = time.perf_counter()
    builds, lq_builds, cut_builds = {}, {}, {}
    jobs = [threading.Thread(target=lambda: builds.update(
        build_mle_variants()))] if "mle" in only else []
    if "lq" in only:
        jobs.append(threading.Thread(target=lambda: lq_builds.update(
            build_alone("lq_anybox_queue.cu", LQ_BUILDS, (
                "picasso_lq_anybox_queue", "picasso_lq_anybox_queue_info"),
                "lqany"))))
    if "cut" in only:
        jobs.append(threading.Thread(target=lambda: cut_builds.update(
            build_alone("cut_anybox.cu", CUT_BUILDS, ("picasso_cut_anybox",),
                        "cut"))))
    for job in jobs:
        job.start()  # alongside the package's build
    lib_path, build_s = _build.build()
    for job in jobs:
        job.join()
    if "mle" in only and len(builds) != len(MLE_BUILDS):
        raise RuntimeError("a variant of the MLE queue did not build")
    if "lq" in only and len(lq_builds) != len(LQ_BUILDS):
        raise RuntimeError("a variant of the LM queue did not build")
    if "cut" in only and len(cut_builds) != len(CUT_BUILDS):
        raise RuntimeError("a variant of the cut did not build")
    print(f"build: {build_s:.1f} s -> {lib_path}; the variants "
          f"{time.perf_counter() - t0:.1f} s")
    from chip_smoke import _ptxas_table

    for row in _ptxas_table((lib_path.parent / "build.log").read_text()):
        if row.startswith(("mle_any_queue", "identify_any", "lq_any_queue",
                           "cut_any")):
            print("  ptxas:", row)
    # the SASS of the sigmaxy queue with its stage and column factors in
    # shared memory, of K4 at any box on u16 frames, of the LM queue (a
    # group of 32, shared stage) and of the cut on u16 frames
    for needle in ("mle_any_queue_kernelILb0ELi1ELb1E",
                   "identify_any_kernelIt", "lq_any_queue_kernelILi8ELi1E",
                   "cut_any_kernelItiE"):
        print("  SASS", needle, json.dumps(sass_counts(lib_path, needle)))
    summaries = []
    if "mle" in only:
        summaries += [sweep_mle(int(b), args.spots, args.rounds, smi, builds)
                      for b in args.boxes.split(",") if b]
    if "lq" in only:
        for b in args.lq_boxes.split(","):
            summaries.append(sweep_lq(int(b), args.spots, args.rounds, smi,
                                      lq_builds))
        summaries.append({"LM queue trips at box 17": lq_clocks(
            17, args.spots, lq_builds["clocks"])})
    if "cut" in only:
        summaries += [sweep_cut(int(b), args.spots, args.rounds, smi,
                                cut_builds)
                      for b in args.lq_boxes.split(",")]
    if "k4" in only:
        movie = make_wide_movie(256, 256, 100, 0.5,
                                np.random.default_rng(23))
        chunk = identify.upload_frames(movie, torch.device("cuda"))
        summaries += sweep_k4(chunk, args.rounds, smi)
        summaries.append({"K4 steps at box 17": k4_steps(chunk)})
    print(json.dumps({"summaries": summaries,
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
