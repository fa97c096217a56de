#!/usr/bin/env python3
"""Where K1's work queue runs a finished spot's CRLB and log-likelihood,
and what the MLE body's roundings do to the fits, on one NVIDIA GPU:

    python3 tests/torch_k1_queue_sweep.py [--rounds N] [--f64]

Four ways to end a fit with its CRLB/LL are built and held against each
other and against the one-thread pass (csrc/mle_fit.cu FULL,
ops/mle_cuda.fit_one_pass_t):
  - the handoff (the package's: csrc/roi_mle_fit.cu, ops/mle_cuda.fit_t):
    a finished spot writes its theta and a ready flag, and a warp whose
    fits are done runs the CRLB/LL of 32 consecutive spots at a time;
  - at the refill (REFILL_SOURCE below): a finished slot keeps its spot
    and its staged pixels until the warp next refills, runs the
    cooperative tail or ends, and the finished slots then run the
    epilogue together from their own stage columns;
  - from a list (LIST_SOURCE below): a finished slot appends its spot,
    theta and iteration count to its warp's list in shared memory and is
    refilled at once; whenever the list holds 32 entries the whole warp
    runs their epilogue, one entry a lane, reading each ROI again;
  - the K2 queue (QUEUE_SOURCE below, two launches): the same queue
    writing each spot's carry, then mle_fit.cu's FINISH mode at k = 0
    runs the CRLB/LL of all spots.
Beside them, csrc/roi_mle_fit.cu built from patched copies of the
package's csrc (VARIANTS): at 2 blocks a SM, without the CRLB/LL (theta
only, to time what it costs), and with other roundings of the body's
a * b + c sites (BODIES: each site of csrc/fit_mle.cuh fused, one
__fmaf_rn, or unfused, the product rounded first, for both methods;
the package unfuses a row's model and its column sums for sigma only).
Every build, at box 7 only, goes into picasso_torch/.build/k1-queue-<hash>/
beside the package, one nvcc per source, all started together.

Inputs: 131,072 make_spots (box 7) and the blocks of 262,144 ROIs of
chip_smoke.py's movie as fit2D cuts them (four, the last 172,976), both
methods. Printed:
the card; the SASS instructions of each build's box-7 kernels
(cuobjdump); registers, local (spill) bytes and resident blocks a SM
(every box for the package, box 7 for the rest); every build that
computes the same numbers == the one-thread pass bit for bit on
make_spots and the first block at max_it 100 and 6, the package's also
at boxes 5, 9, 11, 13 and 15 (8192 make_spots); then the times on
make_spots and the first block in ``--rounds`` rounds, each visiting
every build in the order A B C ... C B A (each visit the median of 5
CUDA-event runs of one call; the median over the visits reported); with
``--f64``, on every block, the package's and every body's fits against
the plain fit in f32 and in f64 (torch_parity.fit_stats, with whether
they pass compare_fits and compare_fits_dense), and the plain fit's own
f32 error; the package's must pass compare_fits_dense on each. Exits
non-zero without a CUDA device or on any mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX, EPS, MAX_IT, MIN_NG, BLOCK = 7, 1e-3, 100, 4000, 262144
STRAGGLER_IT = 6  # most fit2D MLE fits run to max_it at 6
# The rest of a variant's launch (after its kernel and its stage bytes),
# its dispatch on box and method and its C entries.
LAUNCH_TAIL = r"""  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T,
                                                        smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (a.info != nullptr) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    const int info[kMleQueueInfo] = {T, per_sm, attr.numRegs,
                                     (int)attr.localSizeBytes, kRefill,
                                     kMinBlocks, sms, mle_group<S>()};
    for (int i = 0; i < kMleQueueInfo; ++i) a.info[i] = info[i];
    return 0;
  }
  const long long need = (a.n + T - 1) / T;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned int blocks =
      (unsigned int)(need < resident ? need : resident);
  kernel<<<blocks, T, smem, a.stream>>>(src, a.n, a.eps, a.max_it, a.next,
                                        a.coop_steps, a.theta_o, a.crlb_o,
                                        a.ll_o, a.iters_o);
  return (int)cudaGetLastError();
}

int variant_dispatch(const RoiBatch& src, int box, int method,
                  const MleQueueArgs& a) {
  switch (box) {
#define VARIANT_CASE(S)                                                     \
  case S:                                                                \
    return method == 1 ? variant_launch<S, true>(src, a)                    \
                       : variant_launch<S, false>(src, a);
#ifdef PICASSO_K5Q_ONLY_BOX
    VARIANT_CASE(PICASSO_K5Q_ONLY_BOX)
#else
    VARIANT_CASE(5)
    VARIANT_CASE(7)
    VARIANT_CASE(9)
    VARIANT_CASE(11)
    VARIANT_CASE(13)
    VARIANT_CASE(15)
#endif
#undef VARIANT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int picasso_roi_mle_fit(const void* spots, long long n, int box,
                                   float eps, int max_it, long long n_valid,
                                   int method, void* next, void* theta_out,
                                   void* crlb_out, void* ll_out,
                                   void* iters_out, void* coop_steps,
                                   void* stream) {
  if (n <= 0 || n > (1LL << 30) || max_it < 0 || method < 0 || method > 1)
    return (int)cudaErrorInvalidValue;
  const RoiBatch src{static_cast<const float*>(spots), n, n_valid};
  MleQueueArgs a{};
  a.n = n;
  a.eps = eps;
  a.max_it = max_it;
  a.next = static_cast<int*>(next);
  a.coop_steps = static_cast<int*>(coop_steps);
  a.stream = static_cast<cudaStream_t>(stream);
  a.theta_o = static_cast<float*>(theta_out);
  a.crlb_o = static_cast<float*>(crlb_out);
  a.ll_o = static_cast<float*>(ll_out);
  a.iters_o = static_cast<int*>(iters_out);
  return variant_dispatch(src, box, method, a);
}

extern "C" int picasso_roi_mle_fit_info(int box, int method, void* info) {
  if (info == nullptr || method < 0 || method > 1)
    return (int)cudaErrorInvalidValue;
  MleQueueArgs a{};
  a.info = static_cast<int*>(info);
  return variant_dispatch(RoiBatch{}, box, method, a);
}
"""
# The list variant: the queue of csrc/mle_queue.cuh with the ROI source,
# its cooperative tail in the mode that hands theta back to the slot's
# owner, and the epilogue of fit_mle.cuh, run from a per-warp list; the
# same C entries as csrc/roi_mle_fit.cu, so ops/mle_cuda._launch_fit and
# queue_info take either library.
LIST_SOURCE = r"""
#include "mle_queue.cuh"

namespace {

constexpr int kList = 64;  // entries of a warp's list: 32 + the 32 slots
constexpr int kEntry = 8;  // floats an entry: n (its bits), theta, iters

template <int S, bool SIG, int T>
__global__ void __launch_bounds__(T, kMinBlocks) mle_list_kernel(
    const RoiBatch src, long long N, float eps, int max_it,
    int* __restrict__ next, int* coop_steps, float* theta_o, float* crlb_o,
    float* ll_o, int* iters_o) {
  extern __shared__ float stage[];
  constexpr int R = SIG ? 5 : 6;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  float* mine = stage + threadIdx.x;
  float* list = stage + S * S * T + (threadIdx.x >> 5) * kList * kEntry;
  const Staged<S, T> px{mine};
  const float limit = (float)max_it;
  float th[6], old[6], ms[6], done = 0.0f, iters = 0.0f;
  long long n = -1;
  bool drained = false;
  int count = 0;  // entries in the warp's list (uniform in the warp)
  // the epilogue of the last k <= 32 entries, one a lane
  auto flush = [&](int k) {
    __syncwarp();
    if ((int)lane < k) {
      const float* e = list + (count - k + (int)lane) * kEntry;
      const long long m = (long long)__float_as_int(e[0]);
      float t[6];
#pragma unroll
      for (int p = 0; p < 6; ++p) t[p] = e[1 + p];
      mle_epilogue<S, SIG>(LanesLast<S>{src.spots + m, N}, m, N, t, e[7],
                           theta_o, crlb_o, ll_o, iters_o);
    }
    __syncwarp();
    count -= k;
  };
  // the slots whose spot finished append it; a full list is run
  auto push = [&](bool finished) {
    const unsigned f = __ballot_sync(kAll, finished);
    if (finished) {
      float* e = list + (count + __popc(f & below)) * kEntry;
      e[0] = __int_as_float((int)n);
#pragma unroll
      for (int p = 0; p < 6; ++p) e[1 + p] = th[p];
      e[7] = iters;
    }
    count += __popc(f);
    if (count >= 32) flush(32);
  };
  while (true) {
    unsigned busy = __ballot_sync(kAll, n >= 0);
    const int n_free = 32 - __popc(busy);
    if (!drained && (n_free >= kRefill || n_free == 32)) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next, n_free);
      base = __shfl_sync(kAll, base, 0);
      drained = (long long)base + n_free >= N;
      const long long i = (long long)base + __popc(~busy & below);
      if (n < 0 && i < N) {
        n = i;
        src.template stage<S, T>(n, mine);
        init_theta<S, SIG>(px, th, ms);
#pragma unroll
        for (int p = 0; p < R; ++p) old[p] = th[p];
        done = src.starts_done(n) ? 1.0f : 0.0f;
        iters = 0.0f;
      }
      busy = __ballot_sync(kAll, n >= 0);
    }
    if (busy == 0u && drained) {
      if (count > 0) flush(count);
      break;
    }
    if (drained && __popc(busy) <= 32 / mle_group<S>()) {
      mle_coop_tail<S, SIG, T, true>(stage, busy, th, old, ms, done, iters,
                                     n, N, limit, eps, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, coop_steps);
      push(n >= 0);
      if (count > 0) flush(count);
      break;
    }
    bool finished = false;
    if (n >= 0) {
      if (iters < limit && !(done > 0.5f))
        newton_trip<S, SIG>(px, th, old, done, iters, ms, eps);
      finished = done > 0.5f || !(iters < limit);
    }
    push(finished);
    if (finished) n = -1;
  }
}

template <int S, bool SIG>
int variant_launch(const RoiBatch& src, const MleQueueArgs& a) {
  constexpr int T = queue_threads<S>();
  constexpr int smem = (S * S * T + (T / 32) * kList * kEntry) * 4;
  const auto kernel = mle_list_kernel<S, SIG, T>;
""" + LAUNCH_TAIL

# The refill variant: the queue of csrc/mle_queue.cuh with the ROI source,
# in which a finished slot keeps its spot, its theta and its staged pixels
# until the warp next refills, runs the cooperative tail or ends; the
# finished slots then run the epilogue of fit_mle.cuh together from their
# own stage columns, before new spots are staged. The same C entries as
# csrc/roi_mle_fit.cu.
REFILL_SOURCE = r"""
#include "mle_queue.cuh"

namespace {

template <int S, bool SIG, int T>
__global__ void __launch_bounds__(T, kMinBlocks) mle_refill_kernel(
    const RoiBatch src, long long N, float eps, int max_it,
    int* __restrict__ next, int* coop_steps, float* theta_o, float* crlb_o,
    float* ll_o, int* iters_o) {
  extern __shared__ float stage[];
  constexpr int R = SIG ? 5 : 6;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  float* mine = stage + threadIdx.x;
  const Staged<S, T> px{mine};
  const float limit = (float)max_it;
  float th[6], old[6], ms[6], done = 0.0f, iters = 0.0f;
  long long n = -1;
  bool fin = false;  // the spot is finished, its epilogue not yet run
  bool drained = false;
  while (true) {
    const unsigned busy = __ballot_sync(kAll, n >= 0 && !fin);
    const int n_free = 32 - __popc(busy);
    const bool refill = !drained && (n_free >= kRefill || n_free == 32);
    const bool last = drained && busy == 0u;
    const bool tail =
        drained && busy != 0u && __popc(busy) <= 32 / mle_group<S>();
    if ((refill || last || tail) && __any_sync(kAll, fin)) {
      if (fin)
        mle_epilogue<S, SIG>(px, n, N, th, iters, theta_o, crlb_o, ll_o,
                             iters_o);
      if (fin) n = -1;
      fin = false;
    }
    if (last) break;
    if (tail) {
      mle_coop_tail<S, SIG, T, true>(stage, busy, th, old, ms, done, iters,
                                     n, N, limit, eps, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, coop_steps);
      fin = n >= 0;
      continue;
    }
    if (refill) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next, n_free);
      base = __shfl_sync(kAll, base, 0);
      drained = (long long)base + n_free >= N;
      const long long i = (long long)base + __popc(~busy & below);
      if (n < 0 && i < N) {
        n = i;
        src.template stage<S, T>(n, mine);
        init_theta<S, SIG>(px, th, ms);
#pragma unroll
        for (int p = 0; p < R; ++p) old[p] = th[p];
        done = src.starts_done(n) ? 1.0f : 0.0f;
        iters = 0.0f;
      }
    }
    if (n >= 0 && !fin) {
      if (iters < limit && !(done > 0.5f))
        newton_trip<S, SIG>(px, th, old, done, iters, ms, eps);
      fin = done > 0.5f || !(iters < limit);
    }
  }
}

template <int S, bool SIG>
int variant_launch(const RoiBatch& src, const MleQueueArgs& a) {
  constexpr int T = queue_threads<S>();
  constexpr int smem = S * S * T * 4;
  const auto kernel = mle_refill_kernel<S, SIG, T>;
""" + LAUNCH_TAIL

# The K2 queue: csrc/mle_queue.cuh's queue with the ROI source and the
# cooperative tail, writing each spot's carry (theta, old, max_step (R, n),
# done, iters (n,) f32) at its index for mle_fit.cu's FINISH mode at k = 0.
QUEUE_SOURCE = r"""
#include "mle_queue.cuh"

extern "C" int picasso_roi_mle_queue(const void* spots, long long n, int box,
                                     float eps, int max_it,
                                     long long n_valid, int method,
                                     void* next, void* theta_c, void* old_c,
                                     void* done_c, void* iters_c, void* ms_c,
                                     void* stream) {
  if (n <= 0 || n > (1LL << 30) || max_it < 0 || method < 0 || method > 1)
    return (int)cudaErrorInvalidValue;
  const RoiBatch src{static_cast<const float*>(spots), n, n_valid};
  MleQueueArgs a{};
  a.n = n;
  a.eps = eps;
  a.max_it = max_it;
  a.next = static_cast<int*>(next);
  a.theta_c = static_cast<float*>(theta_c);
  a.old_c = static_cast<float*>(old_c);
  a.done_c = static_cast<float*>(done_c);
  a.iters_c = static_cast<float*>(iters_c);
  a.ms_c = static_cast<float*>(ms_c);
  a.stream = static_cast<cudaStream_t>(stream);
  return mle_queue_dispatch<true, true>(src, box, method, a);
}
"""
QUEUE_ENTRY = "picasso_roi_mle_queue"
QUEUE_SIGNATURE = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, *[ctypes.c_void_p] * 7]
ENTRIES = ("picasso_roi_mle_fit", "picasso_roi_mle_fit_info")


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"the package's csrc no longer holds {old!r}")
    return text.replace(old, new)


# csrc/fit_mle.cuh's a * b + c sites. A row's model and its column sums
# (row_fma): the package's call, the unfused and the fused form; the
# package unfuses them for sigma only. The others are fused in the
# package; unfused, every __fmaf_rn of the function that holds them
# becomes unfused_fma.
ROW_SITES = {"model": ("row_fma<SIG>(pg, f[1][i], bg)",
                       "__fadd_rn(__fmul_rn(pg, f[1][i]), bg)",
                       "__fmaf_rn(pg, f[1][i], bg)"),
             "sums": ("row_fma<SIG>(v, fa, c[t])",
                      "__fadd_rn(__fmul_rn(v, fa), c[t])",
                      "__fmaf_rn(v, fa, c[t])")}
FUNCTION_SITES = {"erfc": "float erfc_from_exp(", "point": "void mle_point(",
                  "fold": "void mle_fold(", "update": "void mle_update("}
UNFUSED_FMA = """__device__ __forceinline__ float unfused_fma(float a, float b,
                                               float c) {
  return __fadd_rn(__fmul_rn(a, b), c);
}

"""


def body(unfused: set):
    """The patch of fit_mle.cuh that leaves the sites in ``unfused``
    unfused and fuses the rest, for both methods."""
    def patch(text: str) -> str:
        for site, (package, plain, fused) in ROW_SITES.items():
            text = _replace(text, package,
                            plain if site in unfused else fused)
        for site, head in FUNCTION_SITES.items():
            if site in unfused:
                i = text.index(head)
                j = text.index("\n}\n", i)
                text = text[:i] + text[i:j].replace("__fmaf_rn(",
                                                    "unfused_fma(") + text[j:]
        anchor = "__device__ __forceinline__ float erfc_from_exp("
        return _replace(text, anchor, UNFUSED_FMA + anchor)
    return patch


# the bodies built beside the package's, each for both methods: all
# fused (the package's sigmaxy), each site alone unfused, a row's model
# and sums unfused (the package's sigma), all unfused
BODIES = {"fused": set(), **{f"unfused {s}": {s}
                              for s in ("erfc", "point", "model", "fold",
                                        "update", "sums")},
          "unfused row": set(ROW_SITES),
          "unfused all": {*ROW_SITES, *FUNCTION_SITES}}
HANDOFF = """  if constexpr (CRLB)
    handoff_epilogue<S, SIG>(src.spots, N, next2, ready, theta_o, crlb_o,
                             ll_o);
"""
# box-7 builds of csrc/roi_mle_fit.cu from patched copies of the csrc:
# name -> {file: patch}
VARIANTS = {
    "handoff 2 blocks": {"mle_queue.cuh": lambda t: _replace(
        t, "constexpr int kFitMinBlocks = 3;", "constexpr int kFitMinBlocks = 2;")},
    "theta only": {"mle_queue.cuh": lambda t: _replace(t, HANDOFF, "")},
    **{name: {"fit_mle.cuh": body(u)} for name, u in BODIES.items()},
}
# builds that are timed (and, as bodies, held to the plain fit) but not
# held to the one pass bit for bit
TIMING_ONLY = ("theta only", *BODIES)


def build(out_dir) -> dict:
    """Compile REFILL_SOURCE, LIST_SOURCE, QUEUE_SOURCE and the VARIANTS
    at box 7, each into its own library, one nvcc each, all started
    together; returns name -> library path. Raises with nvcc's message if
    one fails."""
    from picasso_torch import _build

    nvcc = _build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in (("refill", REFILL_SOURCE), ("list", LIST_SOURCE),
                       ("K2 queue", QUEUE_SOURCE)):
        src = out_dir / f"k1_{name.replace(' ', '_')}.cu"
        src.write_text(text)
        jobs[name] = (_build.CSRC, src)
    for name, patches in VARIANTS.items():
        csrc = out_dir / f"csrc_{name.replace(' ', '_')}"
        csrc.mkdir(exist_ok=True)
        for path in _build.CSRC.iterdir():
            if path.suffix in (".cu", ".cuh"):
                text = path.read_text()
                if path.name in patches:
                    text = patches[path.name](text)
                (csrc / path.name).write_text(text)
        jobs[name] = (csrc, csrc / "roi_mle_fit.cu")
    procs, libs = {}, {}
    for name, (include, src) in jobs.items():
        libs[name] = out_dir / f"lib{name.replace(' ', '_')}.so"
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(include),
             "-DPICASSO_K5Q_ONLY_BOX=7", "-o", str(libs[name]), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    log = []
    for name, proc in procs.items():
        out, err = proc.communicate()
        log.append(f"{name}:\n{out}{err}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-4000:]}")
    (out_dir / "sweep_build.log").write_text("\n".join(log))
    return libs


#: box-7 sigmaxy kernels whose SASS instructions are counted: name ->
#: substrings of the mangled name
SASS = {"K2 queue": ("queue_kernelILi7ELb0ELi128ELb1ELb0E", "RoiBatch"),
        "K1": ("queue_kernelILi7ELb0ELi128ELb1ELb1E", "RoiBatch"),
        "K1 sigma": ("queue_kernelILi7ELb1ELi128ELb1ELb1E", "RoiBatch"),
        "K5 queue": ("queue_kernelILi7ELb0ELi128ELb0ELb0E", "ChunkWindowsIt"),
        "one pass": ("mle_fit_kernelILi7ELb0E",),
        "refill": ("refill_kernelILi7ELb0E",),
        "list": ("list_kernelILi7ELb0E",)}


def sass_counts(lib_path, nvcc) -> dict:
    """Instructions of each SASS kernel that ``lib_path`` holds (cuobjdump
    -sass beside nvcc; empty without it)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, inside = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            inside = next((k for k, subs in SASS.items()
                           if all(x in line for x in subs)), None)
            continue
        if inside and re.match(r"\s*/\*[0-9a-f]+\*/\s+\S", line):
            counts[inside] = counts.get(inside, 0) + 1
    return counts


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--f64", action="store_true",
                        help="also hold the card's fits on the fit2D blocks "
                        "to the plain fit in f64")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from chip_smoke import _assert_equal, _median_ms
    from picasso_torch import _build, localize
    from picasso_torch.ops import identify, mle, mle_cuda
    from picasso_torch.ops._fit_common import FINISH
    from torch_data import make_bench_movie, make_spots
    from torch_parity import compare_fits, compare_fits_dense, fit_stats

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    movie_job = pool.submit(make_bench_movie, 2048, 256, 1200, 0.5,
                            np.random.default_rng(13))
    main_build = threading.Thread(target=_build.build)  # alongside
    main_build.start()
    paths = build(_build.BUILD_ROOT / f"k1-queue-{_build.source_hash()}")
    main_build.join()
    builds = {"handoff": _build.library()}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        entries = ({QUEUE_ENTRY: QUEUE_SIGNATURE} if name == "K2 queue" else
                   {e: _build.SIGNATURES[e] for e in ENTRIES})
        for entry, signature in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = signature
            fn.restype = ctypes.c_int
        builds[name] = lib
    queue_lib = builds.pop("K2 queue")
    print(f"build: {time.perf_counter() - t0:.1f} s")
    nvcc = _build.find_nvcc()
    for name, path in (("package", _build.build()[0]), *paths.items()):
        print(f"SASS instructions, {name}:", json.dumps(sass_counts(path,
                                                                    nvcc)))
    for box in (5, 7, 9, 11, 13, 15):
        rows = {(name, m): mle_cuda.queue_info(box, m, lb)
                for name, lb in builds.items() for m in ("sigmaxy", "sigma")
                if box == BOX or name == "handoff"}
        print(f"box {box} (registers, local bytes, blocks a SM):", json.dumps(
            {f"{k[0]} {k[1]}": (v["registers"], v["local_bytes"],
                                v["blocks_per_sm"]) for k, v in rows.items()}))

    as_np = lambda out: [a.cpu().numpy() for a in out]  # noqa: E731

    def k2_queue(sp, method, max_it):
        """The K2 queue's carry, then the package's FINISH at k = 0."""
        s, _, n = sp.shape
        r = 5 if method == "sigma" else 6
        carry = [torch.empty(shape, dtype=torch.float32, device=dev)
                 for shape in ((r, n), (r, n), (1, n), (1, n), (r, n))]
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        _build.check(queue_lib.picasso_roi_mle_queue(
            sp.data_ptr(), n, s, EPS, max_it, n, int(method == "sigma"),
            counter.data_ptr(), *[c.data_ptr() for c in carry],
            torch.cuda.current_stream().cuda_stream), "roi_mle_queue")
        return mle_cuda._launch(FINISH, sp, EPS, 0, None, method, carry)

    def fit(name, sp, method, max_it=MAX_IT):
        if name == "one pass":
            return mle_cuda.fit_one_pass_t(sp, EPS, max_it, method)
        if name == "K2 queue":
            return k2_queue(sp, method, max_it)
        return mle_cuda._launch_fit(builds[name], sp, EPS, max_it, method,
                                    None)

    names = ("one pass", "K2 queue", *builds)
    for box in (5, 9, 11, 13, 15):
        sp = torch.from_numpy(np.ascontiguousarray(
            make_spots(8192, box, seed=box).transpose(1, 2, 0))).to(dev)
        for m in ("sigmaxy", "sigma"):
            _assert_equal(as_np(fit("handoff", sp, m)),
                          as_np(fit("one pass", sp, m)),
                          f"box {box} {m}: the package's K1 vs the one pass")
    print("boxes 5, 9, 11, 13, 15 (8192 make_spots): the package's K1 == the"
          " one pass bit for bit, both methods")
    movie = movie_job.result()
    pool.shutdown()
    ids = localize.identify(movie, MIN_NG, BOX, device="cuda")

    def block(k):
        raw = localize.get_spots_raw(movie, ids[k * BLOCK:(k + 1) * BLOCK],
                                     BOX, device="cuda")
        return identify.as_float32(torch.from_numpy(raw).to(dev)).permute(
            1, 2, 0).contiguous()

    inputs = {
        "make_spots": torch.from_numpy(np.ascontiguousarray(
            make_spots(131072, BOX, seed=0).transpose(1, 2, 0))).to(dev),
        "fit2D block": block(0),
    }
    later = [block(k) for k in range(1, -(-len(ids) // BLOCK))]
    del movie
    for what, sp in inputs.items():
        for m in ("sigmaxy", "sigma"):
            for max_it in (MAX_IT, STRAGGLER_IT):
                want = as_np(fit("one pass", sp, m, max_it))
                for name in names[1:]:
                    if name in TIMING_ONLY:
                        continue
                    _assert_equal(as_np(fit(name, sp, m, max_it)), want,
                                  f"{what} {m} max_it {max_it}: {name} vs "
                                  "the one pass")
    print("make_spots (131,072) and the fit2D block (262,144), max_it "
          f"{MAX_IT} and {STRAGGLER_IT}: every build == the one pass bit for "
          "bit, both methods")
    order = names + names[::-1]
    for what, sp in inputs.items():
        for m in ("sigmaxy", "sigma"):
            times = {n: [] for n in names}
            for _ in range(args.rounds):
                for n in order:
                    times[n].append(_median_ms(lambda: fit(n, sp, m)))
            print(f"{what} {m}, ms (median over {args.rounds} rounds of 2 "
                  "visits, each the median of 5):", json.dumps(
                      {n: {"median": round(statistics.median(t), 4),
                           "visits": [round(x, 4) for x in t]}
                       for n, t in times.items()}))
    if not args.f64:
        return 0
    # the card's fits on every dense block against the plain fit in f32
    # and in f64 (the plain fit's own f32 error beside them); the
    # package's held to compare_fits_dense
    blocks = {"fit2D block": inputs["fit2D block"],
              **{f"fit2D block {k + 2}": b for k, b in enumerate(later)}}
    for what, sp in blocks.items():
        for m in ("sigmaxy", "sigma"):
            f32 = as_np(mle._fit_core(sp, EPS, MAX_IT, m))
            f64 = as_np(mle._fit_core(sp.double(), EPS, MAX_IT, m))
            print(f"{what} {m}, plain vs plain f64:",
                  json.dumps(fit_stats(f64, f32, MAX_IT)))
            for variant in ("handoff", *BODIES):
                card = as_np(fit(variant, sp, m))
                for name, ref in (("plain", f32), ("plain f64", f64)):
                    gates = {}
                    for gate in (compare_fits, compare_fits_dense):
                        try:
                            gate(ref, card, MAX_IT)
                            gates[gate.__name__] = True
                        except AssertionError:
                            gates[gate.__name__] = False
                    print(f"{what} {m}, {variant} vs {name}:", json.dumps(
                        {**gates, **fit_stats(ref, card, MAX_IT)}))
                if variant == "handoff":
                    compare_fits_dense(f32, card, MAX_IT,
                                       f"{what} {m}: the package vs plain")
    return 0


if __name__ == "__main__":
    sys.exit(main())
