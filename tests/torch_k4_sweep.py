#!/usr/bin/env python3
"""Sweep of the K4 identify kernel's compile-time constants on one NVIDIA
GPU, at box 7:

    python3 tests/torch_k4_sweep.py [--against OTHER/identify.cu]

The constants are those of picasso_torch/csrc/identify.cu: the strip
rows in tiles (PICASSO_K4_RT, R = RT * T centre rows a thread) and the
warps a block (PICASSO_K4_WARPS, 32 columns each), as a grid. The script
builds identify.cu alone (not the package's other kernels): one shared
library per variant restricted to box 7, plus the defaults at every box,
one nvcc per library, all started together, into picasso_torch/.build/.
``--against`` builds another version of identify.cu with the same C
entry (for example an earlier commit's, unpacked with ``git archive``)
at its own defaults beside them, to time it in the same call.

Every variant is held to the plain version (torch_parity.compare_tiles:
tile mask and loc equal, ng within rtol 1e-5) and to the others bit for
bit, on the first 256-frame 256x256 u16 chunk of chip_smoke.py's movie
(u16 and f32), on a (32, 2048, 2048) u16 chunk tiled 8x8 from that
chunk's frames, and on torch_data.K4_SHAPES (frames smaller than the
halo, odd sizes; u16, and f32 with NaN pixels). The ``--against``
version is held to the plain version, and whether it equals the
variants bit for bit is printed. Then every build is timed in rounds on
both chunks (each round visits every build once; a visit takes
chip_smoke's median of 5 CUDA-event runs, of one launch and of 20
back-to-back launches per launch; the median over the rounds reported).
Prints the card, each variant's registers, spills, shared bytes and
resident blocks per SM, the defaults' at every box, the SASS opcode
counts of the default box-7 u16 instance (where cuobjdump is found) and
one JSON line a build; exits non-zero without a CUDA device or on any
mismatch.
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
BOX, MIN_NG = 7, 4000
# (strip rows in tiles, warps a block)
VARIANTS = [(rt, w) for w in (1, 2, 4) for rt in (2, 3, 4)]
DEFAULT = (3, 2)  # identify.cu's defaults
ROUNDS = 3
CALLS = 20  # launches between two events


def _name(key) -> str:
    return "rt{}_w{}".format(*key) if isinstance(key, tuple) else key


def build_variants(out_dir, nvcc_flags, nvcc,
                   against: str | None = None) -> tuple[dict, dict]:
    """Compile identify.cu once per variant (box 7), once with its
    defaults (every box) and, given ``against``, that source with its
    own defaults; returns (key -> library path, key -> ptxas log).
    Raises with nvcc's message if one fails."""
    from picasso_torch import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src = str(_build.CSRC / "identify.cu")
    builds = {key: (src, [f"-DPICASSO_K4_ONLY_BOX={BOX}",
                          f"-DPICASSO_K4_RT={key[0]}",
                          f"-DPICASSO_K4_WARPS={key[1]}"])
              for key in VARIANTS}
    builds["all boxes"] = (src, [])
    if against:
        builds["against"] = (os.path.abspath(against), [])
    jobs = {}
    for key, (path, flags) in builds.items():
        lib = out_dir / f"libk4_{_name(key).replace(' ', '_')}.so"
        jobs[key] = (lib, subprocess.Popen(
            [nvcc, *nvcc_flags, "-shared", *flags, "-o", str(lib), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs, logs = {}, {}
    for key, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err[-4000:]}")
        libs[key], logs[key] = lib, out + err
    (out_dir / "sweep_build.log").write_text(
        "\n".join(f"{k}:\n{v}" for k, v in logs.items()))
    return libs, logs


def sass_counts(lib_path, nvcc) -> dict:
    """Opcode counts of the box-7 u16 instance in ``lib_path``
    (cuobjdump -sass), or {} when cuobjdump is not beside nvcc."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "identify_kernelILi7EtE" in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if inside and m:
            counts[m.group(1).split(".")[0]] += 1
    return dict(counts.most_common())


def launcher(lib, frames, box):
    """A closure that launches ``lib``'s kernel on ``frames`` into
    outputs allocated once; returns (launch, outputs)."""
    import torch

    from picasso_torch.ops import identify_cuda

    fn = lib.picasso_identify_tiles
    B, Y, X = frames.shape
    T = box // 2 + 1
    shape = (B, -(-Y // T), -(-X // T))
    out = (torch.empty(shape, dtype=torch.bool, device=frames.device),
           torch.empty(shape, dtype=torch.int32, device=frames.device),
           torch.empty(shape, dtype=torch.float32, device=frames.device))
    dtype = identify_cuda._DTYPES[frames.dtype]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        status = fn(frames.data_ptr(), dtype, B, Y, X, box,
                    float(np.float32(MIN_NG)), *(a.data_ptr() for a in out),
                    stream)
        if status != 0:
            raise RuntimeError(f"identify_tiles: CUDA error {status}")

    return launch, out


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", metavar="IDENTIFY_CU",
                        help="another identify.cu (same C entry) to hold "
                        "and time beside the variants")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from chip_smoke import _median_ms
    from picasso_torch import _build
    from picasso_torch.ops import identify, identify_cuda
    from torch_data import (
        K4_SHAPES, make_bench_movie, small_frames, tiled_chunk,
    )
    from torch_parity import compare_tiles

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    movie = {}
    maker = threading.Thread(target=lambda: movie.setdefault(
        "m", make_bench_movie(2048, 256, 1200, 0.5,
                              np.random.default_rng(13))))
    maker.start()  # alongside the build
    nvcc = _build.find_nvcc()
    libs, logs = build_variants(
        _build.BUILD_ROOT / f"k4-sweep-{_build.source_hash()}",
        _build.NVCC_FLAGS, nvcc, args.against)
    maker.join()
    print(f"build + movie: {time.perf_counter() - t0:.1f} s")
    loaded = {k: ctypes.CDLL(str(p)) for k, p in libs.items()}
    for lib in loaded.values():
        fn = lib.picasso_identify_tiles
        fn.argtypes = _build.SIGNATURES["picasso_identify_tiles"]
        fn.restype = ctypes.c_int
    for key, lib in loaded.items():
        spill = re.findall(r"(\d+) bytes spill stores", logs[key])
        if key == "against":  # an older source may lack the info entry
            regs = re.findall(r"Used (\d+) registers", logs[key])
            print(f"against {args.against}: ptxas registers per instance "
                  f"{regs}")
            boxes = ()
        else:
            boxes = (3, 5, 7, 9, 11, 13, 15) if key == "all boxes" else (BOX,)
        for box in boxes:
            for dt in (torch.uint16, torch.float32):
                info = identify_cuda.kernel_info(dt, box, lib)
                print(f"{_name(key)} box {box} {str(dt).split('.')[-1]}: "
                      f"{info}")
        print(f"  ptxas spill stores (bytes, per instance): {spill}")
    counts = sass_counts(libs[DEFAULT], nvcc)
    print("SASS opcodes, default box-7 u16 instance:", json.dumps(counts))

    chunk = identify.upload_frames(movie["m"][:256], dev)
    inputs = {"chunk 0 u16": chunk, "chunk 0 f32": chunk.to(torch.float32),
              "tiled 32x2048x2048 u16": tiled_chunk(chunk)}
    rng = np.random.default_rng(1)
    for shape in K4_SHAPES:
        frames = small_frames(shape, rng, nan=2e-3)
        inputs[f"edge {shape} u16"] = identify.upload_frames(
            np.nan_to_num(frames).astype(np.uint16), dev)
        inputs[f"edge {shape} f32 NaN"] = identify.upload_frames(frames, dev)
    ref = {what: [a.cpu().numpy() for a in
                  identify.identify_tiles_plain(x, MIN_NG, BOX)]
           for what, x in inputs.items()}
    variants = list(VARIANTS)
    first, against_equal = {}, True
    for key in [*variants, "all boxes", *(["against"] if args.against
                                            else [])]:
        for what, x in inputs.items():
            launch, out = launcher(loaded[key], x, BOX)
            launch()
            got = [a.cpu().numpy() for a in out]
            compare_tiles(got, ref[what], f"{_name(key)} on {what}")
            if what not in first:
                first[what] = got
                continue
            a, b = first[what], got
            same = (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                    and np.array_equal(a[2].view(np.uint32),
                                       b[2].view(np.uint32)))
            if key == "against":
                against_equal &= same
            elif not same:
                raise AssertionError(f"{_name(key)} != {_name(variants[0])} "
                                     f"bit for bit on {what}")
    hits = {w: int(r[0].sum()) for w, r in ref.items() if "edge" not in w}
    print(f"every variant == plain (mask, loc equal; ng rtol 1e-5) and == "
          f"each other bit for bit on {len(inputs)} inputs; hit tiles "
          f"{hits}")
    if args.against:
        print(f"against == plain on every input; == the variants bit for "
              f"bit: {against_equal}")

    timed = {w: inputs[w] for w in ("chunk 0 u16", "tiled 32x2048x2048 u16")}
    keys = [*variants, *(["against"] if args.against else [])]
    launches = {(key, w): launcher(loaded[key], x, BOX)[0]
                for key in keys for w, x in timed.items()}
    times = collections.defaultdict(list)
    for _ in range(ROUNDS):
        for key in keys:
            for w in timed:
                for calls in (1, CALLS):
                    times[key, w, calls].append(
                        _median_ms(launches[key, w], calls=calls))
    for key in keys:
        if key == "against":
            row = {"against": args.against}
        else:
            info = identify_cuda.kernel_info(torch.uint16, BOX, loaded[key])
            row = dict(zip(("rt", "warps"), key))
            row.update({k: info[k] for k in (
                "rows", "columns", "registers", "local_bytes",
                "shared_bytes", "blocks_per_sm")})
        for calls, name in ((CALLS, "ms"), (1, "ms_one_launch")):
            row[name] = {w: round(statistics.median(times[key, w, calls]), 5)
                         for w in timed}
            row[name + "_rounds"] = {
                w: [round(t, 5) for t in times[key, w, calls]] for w in timed}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
