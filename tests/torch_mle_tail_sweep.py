#!/usr/bin/env python3
"""The MLE work queues' cooperative tail and the MLE body's pinned
roundings against an earlier commit's kernels, on one NVIDIA GPU:

    python3 tests/torch_mle_tail_sweep.py [--against OLD_CSRC]

The script builds the package's kernels (picasso_torch/_build.py) and,
alongside (one nvcc per source, all started together), into
picasso_torch/.build/:
  - the K5 MLE work queue (csrc/winfit_mle_queue.cu, u16 chunks, box 7)
    with the cooperative tail of csrc/mle_queue.cuh for both methods and
    for none (PICASSO_K5Q_TAIL 3 and 0; the package's takes it for sigma
    only);
  - with ``--against``, the MLE kernels of an earlier commit's csrc
    directory (for example ``git archive HEAD picasso_torch/csrc``
    unpacked; its mle_fit.cu, winfit_mle.cu, winfit_mle_f32.cu,
    winfit_mle_queue.cu, winfit_mle_queue_f32.cu and error.cu, each
    with its own headers) as one library.

The SASS opcode counts of the box-7 u16 sigmaxy K5 queue and K1
instances of each build are printed (their listings written to the
sweep's build folder, sass/) where cuobjdump is beside nvcc.

Inputs: 131,072 make_spots (box 7); the hits of the first 256-frame
chunk of chip_smoke.py's movie and their ROIs; the first 262,144 of the
movie's hits as fit2D cuts them. Printed: the card; with ``--against``,
for each input and method, how many fits of the earlier K1 differ from
this K1 (theta, crlb, ll or iters), the largest |dx|, |dy| (px and f32
ulps) and how many iteration counts differ, and on chunk 0 and the
fit2D block both K1s against the plain fit (torch_parity.compare_fits,
printed, not required); then the K5 queue on chunk
0 (sigmaxy and sigma) for every build (the package's, tail on, tail
off, and the earlier one), each held to its own K1 bit for bit, with the
cooperative steps of the package's, then timed in ROUNDS rounds (each
round visits every build once, in the order A B C D D C B A; the median
of 5 CUDA-event runs a visit, the median over the visits reported), as
ops/winfit_cuda.fit_mle_queue_t runs it: the queue launch and the
CRLB/LL pass of the same build. Exits non-zero without a CUDA device or
on any mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX, EPS, MAX_IT, MIN_NG, BLOCK = 7, 1e-3, 100, 4000, 262144
ROUNDS = 3
STUB = """#include "winfit_mle_queue.cuh"
// the sweep's libraries take u16 chunks only
int picasso_winfit_mle_queue_f32(const float*, int, int,
                                 const WinfitMleQueueArgs&) {
  return (int)cudaErrorInvalidValue;
}
"""
OLD_SOURCES = ("mle_fit.cu", "winfit_mle.cu", "winfit_mle_f32.cu",
               "winfit_mle_queue.cu", "winfit_mle_queue_f32.cu", "error.cu")
OLD_ENTRIES = ("picasso_mle_fit", "picasso_winfit_mle",
               "picasso_winfit_mle_queue", "picasso_winfit_mle_queue_info")


def build(out_dir, against: str | None) -> dict:
    """Compile the tail variants (and the earlier kernels); returns name
    -> library path. Raises with nvcc's message if one fails."""
    from picasso_torch import _build

    nvcc = _build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    stub = out_dir / "stub.cu"
    stub.write_text(STUB)
    inc = ["-I", str(_build.CSRC)]
    objs = {"stub": ([*inc, str(stub)], "stub.o")}
    for tail in (3, 0):
        objs[f"tail {tail}"] = (
            [*inc, f"-DPICASSO_K5Q_ONLY_BOX={BOX}",
             f"-DPICASSO_K5Q_TAIL={tail}",
             str(_build.CSRC / "winfit_mle_queue.cu")], f"tail{tail}.o")
    if against:
        for src in OLD_SOURCES:  # quotes-includes resolve beside the file
            objs[f"old {src}"] = ([os.path.join(os.path.abspath(against),
                                                src)], f"old_{src}.o")
    procs = {k: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *args[:-1], "-c", "-o",
         str(out_dir / obj), args[-1]], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, (args, obj) in objs.items()}
    log = []
    for key, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err[-4000:]}")
        log.append(f"{key}:\n{out}{err}")
    (out_dir / "sweep_build.log").write_text("\n".join(log))
    links = {f"tail {t}": [f"tail{t}.o", "stub.o"] for t in (3, 0)}
    if against:
        links["earlier"] = [f"old_{src}.o" for src in OLD_SOURCES]
    libs = {}
    for name, parts in links.items():
        lib = out_dir / f"lib{name.replace(' ', '')}.so"
        proc = subprocess.run(
            [nvcc, "-shared", *_build.NVCC_FLAGS[:2], "-o", str(lib),
             *[str(out_dir / p) for p in parts]], capture_output=True,
            text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"link failed for {name}:\n{proc.stderr}")
        libs[name] = lib
    return libs


#: the box-7 u16 sigmaxy instances whose SASS is counted: name ->
#: substrings of the mangled kernel name
SASS_KERNELS = {
    "K5 queue": ("queue_kernelILi7ELb0ELi128E", "ChunkWindowsIt"),
    "K5 queue (earlier)": ("winfit_mle_queue_kernelILi7ELb0ELi128EtE",),
    "K1": ("mle_fit_kernelILi7ELb0E",),
}


def sass(lib_path, nvcc, out_dir) -> dict:
    """Opcode counts of the SASS_KERNELS instances that ``lib_path``
    holds (cuobjdump -sass, when it is beside nvcc), each instance's
    listing written to ``out_dir``."""
    import collections
    import re

    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, inside, lines = {}, None, collections.defaultdict(list)
    for line in text.splitlines():
        if "Function :" in line:
            inside = next((k for k, subs in SASS_KERNELS.items()
                           if all(x in line for x in subs)), None)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if inside and m:
            counts.setdefault(inside, collections.Counter())[
                m.group(1).split(".")[0]] += 1
            lines[inside].append(line)
    os.makedirs(out_dir, exist_ok=True)
    for k, ls in lines.items():
        with open(os.path.join(out_dir, f"{os.path.basename(str(lib_path))}_"
                               f"{k.replace(' ', '_')}.sass"), "w") as f:
            f.write("\n".join(ls))
    return {k: {"all": sum(c.values()), **dict(c.most_common(16))}
            for k, c in counts.items()}


def ulps(a, b) -> np.ndarray:
    """|a - b| in f32 ulps (same-sign finite values; 0 where equal)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def moved(old, new) -> dict:
    """How the earlier K1's fits differ from this one's."""
    th_o, th_n = old[0], new[0]
    differ = np.zeros(th_o.shape[1], bool)
    for a, b in zip(old, new):
        d = ~((a == b) | (np.isnan(a) & np.isnan(b)))
        differ |= d.reshape(-1, th_o.shape[1]).any(0) if d.ndim > 1 else d
    both = np.isfinite(th_o[:2]).all(0) & np.isfinite(th_n[:2]).all(0)
    dxy = np.abs(th_o[:2, both] - th_n[:2, both])
    u = ulps(th_o[:2, both], th_n[:2, both])
    return {"fits": int(th_o.shape[1]), "differ": int(differ.sum()),
            "share": round(float(differ.mean()), 6),
            "iters_differ": int((old[3] != new[3]).sum()),
            "max_dxy_px": float(dxy.max(initial=0.0)),
            "max_dxy_ulps": int(u.max(initial=0)),
            "p99_dxy_ulps": float(np.percentile(u, 99)) if u.size else 0.0}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="OLD_CSRC",
                        help="an earlier commit's picasso_torch/csrc")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import threading

    from chip_smoke import _median_ms
    from picasso_torch import _build, localize
    from picasso_torch.ops import identify, identify_cuda, mle, mle_cuda
    from picasso_torch.ops import winfit_cuda as wc
    from picasso_torch.ops._fit_common import FINISH, FULL
    from torch_data import make_bench_movie, make_spots
    from torch_parity import compare_fits

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    main_build = threading.Thread(target=_build.build)  # alongside
    main_build.start()
    out_dir = _build.BUILD_ROOT / f"mle-tail-{_build.source_hash()}"
    paths = build(out_dir, args.against)
    main_build.join()
    libs = {"package": _build.library()}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for entry in (OLD_ENTRIES if name == "earlier"
                      else OLD_ENTRIES[2:]):
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, path in (("package", _build.build()[0]), *paths.items()):
        print(f"SASS {name}:", json.dumps(sass(
            path, _build.find_nvcc(), out_dir / "sass")))

    as_np = lambda out: [a.cpu().numpy() for a in out]  # noqa: E731
    movie = make_bench_movie(2048, 256, 1200, 0.5, np.random.default_rng(13))
    chunk = identify.upload_frames(movie[:256], dev)
    hits = identify.compact(*identify_cuda.identify_tiles(chunk, MIN_NG, BOX),
                            BOX)[:3]
    h32 = torch.stack(hits).to(torch.int32).contiguous()
    ids = localize.identify(movie, MIN_NG, BOX, device="cuda")[:BLOCK]
    block = identify.as_float32(torch.from_numpy(localize.get_spots_raw(
        movie, ids, BOX, device="cuda")).to(dev)).permute(1, 2, 0).contiguous()
    inputs = {
        "make_spots": torch.from_numpy(np.ascontiguousarray(
            make_spots(131072, BOX, seed=0).transpose(1, 2, 0))).to(dev),
        "chunk 0": wc.photons_t(chunk, *hits, BOX, 0.0, 1.0),
        "fit2D block": block,
    }
    methods = ("sigmaxy", "sigma")
    k1 = {(what, m): as_np(mle_cuda.fit_one_pass_t(sp, EPS, MAX_IT, m))
          for what, sp in inputs.items() for m in methods}
    if "earlier" in libs:
        for (what, m), new in k1.items():
            old = as_np(mle_cuda._launch(FULL, inputs[what], EPS, MAX_IT,
                                         None, m, lib=libs["earlier"]))
            print(f"earlier K1 vs this K1, {what} {m}:",
                  json.dumps(moved(old, new)))
            if what == "make_spots":
                continue
            plain = as_np(mle._fit_core(inputs[what], EPS, MAX_IT, m))
            for name, fits in (("earlier", old), ("this", new)):
                try:
                    verdict = compare_fits(plain, fits, MAX_IT)
                except AssertionError as e:
                    verdict = f"OUT OF TOLERANCE {e}"
                print(f"  plain vs {name} K1 ({what} {m}):", verdict)

    def fit(name, method):
        lib = libs[name]
        carry = wc._launch_queue(lib, chunk, h32, 0.0, 1.0, BOX, EPS, MAX_IT,
                                 method)
        return wc._launch_mle(FINISH, chunk, h32, 0.0, 1.0, BOX, EPS, 0,
                              method, carry,
                              lib=lib if name == "earlier" else None)

    ref_old = {}
    for m in methods:
        if "earlier" in libs:
            ref_old[m] = as_np(mle_cuda._launch(
                FULL, inputs["chunk 0"], EPS, MAX_IT, None, m,
                lib=libs["earlier"]))
        for name in libs:
            want = ref_old[m] if name == "earlier" else k1["chunk 0", m]
            got = as_np(fit(name, m))
            for a, b in zip(got, want):
                if not np.array_equal(a, b, equal_nan=True):
                    raise AssertionError(f"{name} K5 queue != its K1 on "
                                         f"chunk 0 ({m})")
        info = {name: wc.queue_info(torch.uint16, BOX, m, libs[name])
                for name in libs}
        print(f"K5 queue {m} on chunk 0 ({h32.shape[1]} hits): every build "
              f"== its K1 bit for bit; instances:", json.dumps(
                  {k: {f: v[f] for f in ("registers", "local_bytes",
                                         "blocks_per_sm", "group")}
                   for k, v in info.items()}))
    names = list(libs)
    order = names + names[::-1]
    times = {(n, m): [] for n in names for m in methods}
    for _ in range(ROUNDS):
        for m in methods:
            for n in order:
                times[n, m].append(_median_ms(lambda: fit(n, m)))
    for m in methods:
        print(f"K5 queue {m} on chunk 0, ms (median over {ROUNDS} rounds of "
              "2 visits, each the median of 5):", json.dumps(
                  {n: {"median": round(statistics.median(times[n, m]), 4),
                       "visits": [round(t, 4) for t in times[n, m]]}
                   for n in names}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
