#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (picasso_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
1. environment: torch/CUDA versions, the card's name and power limit;
2. build: the CUDA kernels from picasso_torch/csrc (nvcc, sm_90a);
3. kernels against their plain PyTorch versions on the card, at the
   main path's shapes: the MLE fit kernel in its single-pass mode (K1)
   and in the phase schedule (K2) on 131,072 spots of bench.make_spots,
   K2 == K1 bit for bit, the identify kernel (K4) on one 256-frame
   256x256 u16 chunk; times are medians of 5 CUDA-event runs;
4. the slice: picasso_torch.localize.localize (MLE sigmaxy, box 7) on a
   2048-frame 256x256 u16 movie of bench.make_bench_movie, with the
   launch count of every kernel on its path (K4, K2) checked; then its
   first chunk re-run through the plain versions on the card and held
   to the tolerances of tests/torch_parity.py, K1 against K2 on that
   chunk's ROIs, and the time of each stage of one chunk.
The line before the last is the JSON record of the kernels on the main
path; the last line is {"ok": true, "device": {...}}. Without a CUDA
device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BOX = 7
EPS = 1e-3
MAX_IT = 100
MIN_NG = 4000
N_SPOTS = 131072
CHUNK = 256  # frames per chunk that localize_fused forms at 256x256


def _median_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from bench import make_bench_movie, make_spots
    from picasso_torch import _build, gaussmle, localize
    from picasso_torch.ops import fused, identify, identify_cuda, mle, mle_cuda
    from torch_parity import compare_fits, compare_hits

    dev = torch.device("cuda")

    # 1. environment -----------------------------------------------------
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print("card (nvidia-smi name, power.limit):")
    print(smi)

    # 2. build -----------------------------------------------------------
    lib_path, build_s = _build.build()
    print(f"build: {build_s:.1f} s -> {lib_path}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    _build.library()

    # 3. kernels against their plain versions ----------------------------
    spots = make_spots(N_SPOTS, BOX, seed=0)
    spots_t = torch.from_numpy(
        np.ascontiguousarray(spots.transpose(1, 2, 0))
    ).to(dev)
    as_np = lambda out: [a.cpu().numpy() for a in out]  # noqa: E731
    plain = as_np(mle._fit_core(spots_t, EPS, MAX_IT))
    k1 = as_np(mle_cuda.fit_t(spots_t, EPS, MAX_IT))
    torch.cuda.synchronize()
    k1_stats = compare_fits(plain, k1, MAX_IT, "K1 vs plain")
    k2 = as_np(mle_cuda.fit_boundary_t(spots_t, EPS, MAX_IT))
    for a, b, name in zip(k1, k2, ("theta", "crlb", "ll", "iters")):
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"K2 != K1 bit for bit ({name})")
    k2_stats = compare_fits(plain, k2, MAX_IT, "K2 vs plain")
    print("K1 vs plain:", json.dumps(k1_stats))
    print("K2 vs plain:", json.dumps(k2_stats), "| K2 == K1 bit for bit")
    ms = {
        "plain_fit": _median_ms(lambda: mle._fit_core(spots_t, EPS, MAX_IT)),
        "K1": _median_ms(lambda: mle_cuda.fit_t(spots_t, EPS, MAX_IT)),
        "K2": _median_ms(
            lambda: mle_cuda.fit_boundary_t(spots_t, EPS, MAX_IT)
        ),
    }

    t0 = time.perf_counter()
    movie = make_bench_movie(2048, 256, 1200, 0.5, np.random.default_rng(13))
    print(f"movie {movie.shape} {movie.dtype}: "
          f"{time.perf_counter() - t0:.1f} s to generate")
    chunk = identify.upload_frames(movie[:CHUNK], dev)
    tiles_p = [a.cpu().numpy() for a in
               identify.identify_tiles_plain(chunk, MIN_NG, BOX)]
    tiles_k = [a.cpu().numpy() for a in
               identify_cuda.identify_tiles(chunk, MIN_NG, BOX)]
    if not (np.array_equal(tiles_p[0], tiles_k[0])
            and np.array_equal(tiles_p[1], tiles_k[1])):
        raise AssertionError("K4: tile mask/loc differ from the plain version")
    if not np.allclose(tiles_k[2], tiles_p[2], rtol=1e-5, atol=0):
        raise AssertionError("K4: tile ng beyond rtol 1e-5")
    k4_err = float(np.abs(tiles_k[2] - tiles_p[2]).max())
    print(f"K4 vs plain: {int(tiles_k[0].sum())} hit tiles equal, "
          f"ng max abs err {k4_err}")
    ms["plain_identify"] = _median_ms(
        lambda: identify.identify_tiles_plain(chunk, MIN_NG, BOX)
    )
    ms["K4"] = _median_ms(
        lambda: identify_cuda.identify_tiles(chunk, MIN_NG, BOX)
    )
    print(f"K1 fit {N_SPOTS} spots: kernel {ms['K1']:.3f} ms, "
          f"plain {ms['plain_fit']:.3f} ms")
    print(f"K2 fit {N_SPOTS} spots: kernel {ms['K2']:.3f} ms, "
          f"plain {ms['plain_fit']:.3f} ms")
    print(f"K4 identify ({CHUNK}, 256, 256) u16: kernel {ms['K4']:.3f} ms, "
          f"plain {ms['plain_identify']:.3f} ms")

    # 4. the slice -------------------------------------------------------
    counters = (mle_cuda.fit_t, mle_cuda.fit_boundary_t,
                identify_cuda.identify_tiles)
    for c in counters:
        c.launches = 0
    camera = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    params = {"Min. Net Gradient": MIN_NG, "Box Size": BOX}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    locs = localize.localize(movie, camera, params,
                             fitting_method="gaussmle", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    print(f"slice: {len(locs)} locs from {len(movie)} frames in {wall:.3f} s "
          f"= {len(movie) / wall:.1f} frames/s, {len(locs) / wall:.0f} "
          f"spots/s; launches {launches}")
    # the main path fits through the phase schedule (K2), as the JAX
    # package does; the single-pass mode (K1) is not on it
    on_path = ("fit_boundary_t", "identify_tiles")
    if min(launches[k] for k in on_path) <= 0 or len(locs) == 0:
        raise AssertionError(f"slice did not run through every kernel: "
                             f"{launches}, {len(locs)} locs")
    for name in ("x", "y", "photons", "sx", "sy", "bg"):
        if not np.isfinite(locs[name]).all():
            raise AssertionError(f"slice: non-finite {name}")

    # the slice's wall split: the chunk loop, then the locs table
    t0 = time.perf_counter()
    ids, fits = fused.localize_fused(movie, MIN_NG, BOX, camera,
                                     device="cuda")
    t1 = time.perf_counter()
    gaussmle.locs_from_fits(ids, *fits, BOX)
    t2 = time.perf_counter()
    print(f"slice split: localize_fused {t1 - t0:.3f} s, locs_from_fits "
          f"{t2 - t1:.3f} s")

    # the first chunk again: kernels (same calls as the slice) and plain
    ker = [a.cpu().numpy() for a in fused.identify_cut_fit(
        chunk, MIN_NG, 0.0, 1.0, box=BOX, eps=EPS, max_it=MAX_IT)]
    first = locs[locs["frame"] < CHUNK]
    if len(first) != ker[0].shape[0] or not np.array_equal(
        first["x"], (ker[4][0] + ker[2] - BOX // 2).astype(np.float32)
    ):
        raise AssertionError("slice's first chunk differs from a re-run")
    f, y, x, ng = identify.compact(
        *identify.identify_tiles_plain(chunk, MIN_NG, BOX), BOX
    )
    roi = fused.cut_rois_t(chunk, f, y, x, BOX).to(torch.float32)
    pl = [a.cpu().numpy() for a in
          (f, y, x, ng, *mle._fit_core(roi.contiguous(), EPS, MAX_IT))]
    pairs = compare_hits(pl[:4], ker[:4], MIN_NG, "slice chunk 0 hits")
    pi, ki = pairs[:, 0], pairs[:, 1]
    chunk_stats = compare_fits(
        [pl[4][:, pi], pl[5][:, pi], pl[6][pi], pl[7][pi]],
        [ker[4][:, ki], ker[5][:, ki], ker[6][ki], ker[7][ki]],
        MAX_IT, "slice chunk 0 fits",
    )
    print(f"slice chunk 0 vs plain: {len(pl[0])} plain hits, {len(ker[0])} "
          f"kernel hits, {len(pairs)} matched;", json.dumps(chunk_stats))

    # K1 against K2 on the chunk's real ROIs, where some spots run to
    # max_it: same results, and the time the phase schedule saves
    dense = roi.contiguous()
    k1d = as_np(mle_cuda.fit_t(dense, EPS, MAX_IT))
    k2d = as_np(mle_cuda.fit_boundary_t(dense, EPS, MAX_IT))
    for a, b, name in zip(k1d, k2d, ("theta", "crlb", "ll", "iters")):
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"chunk 0: K2 != K1 bit for bit ({name})")
    dense_ms = [
        _median_ms(lambda: mle_cuda.fit_t(dense, EPS, MAX_IT)),
        _median_ms(lambda: mle_cuda.fit_boundary_t(dense, EPS, MAX_IT)),
        _median_ms(lambda: mle_cuda.fit_boundary_t(dense, EPS, MAX_IT)),
        _median_ms(lambda: mle_cuda.fit_t(dense, EPS, MAX_IT)),
    ]
    it = k1d[3]
    print(f"chunk 0 ROIs ({dense.shape[-1]} spots, iterations p50 "
          f"{np.percentile(it, 50):.0f} p90 {np.percentile(it, 90):.0f}, "
          f"{np.mean(it == MAX_IT):.4f} at max_it): K2 == K1 bit for bit; "
          f"ms in turn K1 {dense_ms[0]:.3f}, K2 {dense_ms[1]:.3f}, "
          f"K2 {dense_ms[2]:.3f}, K1 {dense_ms[3]:.3f}")

    # the stages of one chunk on the card, each alone
    fk, yk, xk, _ = identify.compact(
        *identify_cuda.identify_tiles(chunk, MIN_NG, BOX), BOX)
    tiles = identify_cuda.identify_tiles(chunk, MIN_NG, BOX)
    stages = {
        "upload": lambda: identify.upload_frames(movie[:CHUNK], dev),
        "K4 identify": lambda: identify_cuda.identify_tiles(
            chunk, MIN_NG, BOX),
        "compact": lambda: identify.compact(*tiles, BOX),
        "cut+photons": lambda: fused.cut_rois_t(
            chunk, fk, yk, xk, BOX).to(torch.float32).contiguous(),
        "K2 fit": lambda: mle_cuda.fit_boundary_t(dense, EPS, MAX_IT),
        "packed chunk + readback": lambda: fused.identify_cut_fit_packed(
            chunk, MIN_NG, 0.0, 1.0, box=BOX, eps=EPS, max_it=MAX_IT,
        ).cpu(),
    }
    print("chunk stages (ms, median of 5):", json.dumps(
        {k: round(_median_ms(fn), 4) for k, fn in stages.items()}))

    # K1 is built and checked in phase 3 but is not on the main path
    print("off the main path:", json.dumps({
        "name": "K1 mle_fit (single pass)", "route": "cuda",
        "source": "picasso_torch/csrc/mle_fit.cu",
        "replaces": "picasso_tpu/ops/mle_pallas.py:36",
        "launches": launches["fit_t"],
        "max_abs_err": k1_stats["xy_max_all"],
        "ms": ms["K1"], "plain_ms": ms["plain_fit"]}))
    kernels = [
        {"name": "K2 mle_fit (phases 16/50/100)", "route": "cuda",
         "source": "picasso_torch/csrc/mle_fit.cu",
         "replaces": "picasso_tpu/ops/mle_pallas.py:256",
         "launches": launches["fit_boundary_t"],
         "max_abs_err": k2_stats["xy_max_all"],
         "ms": ms["K2"], "plain_ms": ms["plain_fit"]},
        {"name": "K4 identify_tiles", "route": "cuda",
         "source": "picasso_torch/csrc/identify.cu",
         "replaces": "picasso_tpu/ops/identify_pallas.py:58",
         "launches": launches["identify_tiles"], "max_abs_err": k4_err,
         "ms": ms["K4"], "plain_ms": ms["plain_identify"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
