// K5 MLE as a work queue (sm_90a): the fused cut + photon conversion +
// MLE fit (sigmaxy and sigma) of a whole hit list in one persistent
// launch with lane refill, for one frame dtype at a time:
// winfit_mle_queue.cu instantiates it for uint16 chunks,
// winfit_mle_queue_f32.cu for float32 chunks (one nvcc per source).
//
// Replaces the Pallas TPU kernel picasso_tpu/ops/winfit_pallas.py
// _mle_kernel (fit_mle_t) on the main path, and with it the phase
// schedule that the TPU needs (K2's START/RESUME/FINISH with host
// permutes between phases, picasso_tpu/ops/mle_pallas.py
// fit_pallas_boundary_t). A TPU lane cannot take new work when its spot
// converges, so the JAX package reorders lanes stragglers first between
// launches. A SIMT lane can: here each warp owns 32 lane slots, and a
// slot whose spot has converged (or reached max_it) takes the next hit
// from a device-side counter.
//
// What bounds it on the card: issued FP32 instructions (about 2,950 a
// Newton step of a box-7 spot), not bytes: each spot's window is read
// from the chunk once and its carry written once. Before this kernel the
// fit lost its time to warp divergence (a warp of one thread per spot
// issues until its slowest spot is done), to the host permutes between
// phases, and to restaging every window at every phase. The design:
//   - one launch of SMs x resident blocks (cudaOccupancy...), capped at
//     what N needs; every lane stays in the loop until the queue is empty
//     and its warp holds no spot, so the warp collectives below always
//     see the full mask;
//   - a free slot stages its window in shared memory as [pixel][thread]
//     (fit_common.cuh stage_window, the layout of K5 one pass) and runs
//     init_theta; then every trip of the warp's loop takes one
//     newton_trip (fit_mle.cuh) for each busy slot;
//   - free slots refill together, only when kRefill of the warp's 32 are
//     free or none is busy: one atomicAdd on the counter per refill,
//     warp-aggregated (__ballot_sync, __popc, __shfl_sync of the base),
//     so the divergent stage + init of a refill is shared by several
//     slots;
//   - a finished spot writes the carry of K2 (theta, old, done, iters,
//     max_step) at its own index, in input order; the CRLB and
//     log-likelihood then run for all N spots as K5's FINISH mode at
//     k = 0 (winfit_mle.cu), uniform work with no permutation.
// Each spot runs the same template instances in the same order as K1
// (clamp, stage, init_theta, Newton steps with the test against `old`,
// crlb_ll); only which lane runs it, and when, differs. So the result
// equals K1, K2 and the gather route bit for bit.
//
// What it does not remove: a spot's steps run one after the other in one
// thread, so a fit that runs to max_it, claimed late, ends the launch
// max_it step latencies after its claim (the straggler tail, PERF.md).
// Shortening that needs the steps of one spot spread over lanes.
//
// Left out, on purpose:
//   - tensor cores: the per-pixel work (model, 1/model, two
//     NaN-propagating clamps) is nonlinear; what stays bilinear after it
//     is 11 FMAs a pixel on a 7x7 grid, and TF32 would lose the digits
//     the fit's tolerances rest on;
//   - TMA / cp.async prefetch of the next window: a window is staged once
//     a spot (98 bytes of u16 at box 7) and then read from shared memory
//     at each of its Newton steps, so its load is a small share of a
//     spot's time; a u16 row at an arbitrary x is only 2-byte aligned, so
//     a tiled TMA box of S x 8 u16 would be the form.
//
// The three constants below are the measured choice (PERF.md); the
// macros only let tests/torch_k5_queue_sweep.py build the variants it
// times. PICASSO_K5Q_ONLY_BOX restricts a variant to one box.

#pragma once

#include "fit_mle.cuh"

#ifndef PICASSO_K5Q_REFILL
#define PICASSO_K5Q_REFILL 16
#endif
#ifndef PICASSO_K5Q_THREADS
#define PICASSO_K5Q_THREADS 128
#endif
#ifndef PICASSO_K5Q_MIN_BLOCKS
#define PICASSO_K5Q_MIN_BLOCKS 2
#endif

// Arguments of one queue launch (see picasso_winfit_mle_queue in
// winfit_mle_queue.cu). With info set, the launch helper describes the
// instance (threads, resident blocks per SM, registers, local bytes,
// refill, min blocks, SMs) and launches nothing.
struct WinfitMleQueueArgs {
  long long B, Y, X;
  const int* hits;
  long long n;
  float baseline, factor, eps;
  int max_it;
  int* next;  // the queue's counter, zero before the launch
  float *theta_c, *old_c, *done_c, *iters_c, *ms_c;
  int* info;
  cudaStream_t stream;
};

namespace {

// free slots of a warp that refill together
constexpr int kRefill = PICASSO_K5Q_REFILL;
// __launch_bounds__' minimum resident blocks per SM
constexpr int kMinBlocks = PICASSO_K5Q_MIN_BLOCKS;
// the stage of a block stays within this, so two blocks fit on an SM
constexpr int kStageBytes = 113 * 1024;

template <int S>
constexpr int queue_threads() {
  int t = PICASSO_K5Q_THREADS;
  while (t > 32 && S * S * t * 4 > kStageBytes) t /= 2;
  return t;
}

template <int S, bool SIG, int T, typename Tin>
__global__ void __launch_bounds__(T, kMinBlocks) winfit_mle_queue_kernel(
    const Tin* __restrict__ frames, long long B, long long Y, long long X,
    const int* __restrict__ hits, long long N, float baseline, float factor,
    float eps, int max_it, int* __restrict__ next, float* theta_c,
    float* old_c, float* done_c, float* iters_c, float* ms_c) {
  extern __shared__ float stage[];
  constexpr int R = SIG ? 5 : 6;
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  float* mine = stage + threadIdx.x;
  const Staged<S, T> px{mine};
  const float limit = (float)max_it;
  float th[6], old[6], ms[6], done = 0.0f, iters = 0.0f;
  long long n = -1;      // this slot's hit; -1 while the slot is free
  bool drained = false;  // the counter has passed N (uniform in the warp)
  while (true) {
    const unsigned free_mask = __ballot_sync(kAll, n < 0);
    const int n_free = __popc(free_mask);
    if (!drained && (n_free >= kRefill || n_free == 32)) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next, n_free);
      base = __shfl_sync(kAll, base, 0);
      drained = (long long)base + n_free >= N;
      const long long i = (long long)base + __popc(free_mask & below);
      if (n < 0 && i < N) {
        n = i;
        stage_window<S, T>(frames, B, Y, X, hits, N, n, baseline, factor,
                           mine);
        init_theta<S, SIG>(px, th, ms);
#pragma unroll
        for (int p = 0; p < R; ++p) old[p] = th[p];
        done = 0.0f;
        iters = 0.0f;
      }
    }
    const bool busy = n >= 0;
    if (__ballot_sync(kAll, busy) == 0u && drained) break;
    if (busy) {
      if (iters < limit)
        newton_trip<S, SIG>(px, th, old, done, iters, ms, eps);
      if (done > 0.5f || !(iters < limit)) {
#pragma unroll
        for (int p = 0; p < R; ++p) {
          theta_c[p * N + n] = th[p];
          old_c[p * N + n] = old[p];
          ms_c[p * N + n] = ms[p];
        }
        done_c[n] = done;
        iters_c[n] = iters;
        n = -1;
      }
    }
  }
}

template <int S, bool SIG, typename Tin>
int queue_launch(const Tin* frames, const WinfitMleQueueArgs& a) {
  constexpr int T = queue_threads<S>();
  constexpr int smem = S * S * T * (int)sizeof(float);
  const auto kernel = winfit_mle_queue_kernel<S, SIG, T, Tin>;
  cudaError_t err = cudaSuccess;
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
    const int info[7] = {T,       per_sm,     attr.numRegs,
                         (int)attr.localSizeBytes,
                         kRefill, kMinBlocks, sms};
    for (int i = 0; i < 7; ++i) a.info[i] = info[i];
    return 0;
  }
  const long long need = (a.n + T - 1) / T;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned int blocks =
      (unsigned int)(need < resident ? need : resident);
  winfit_mle_queue_kernel<S, SIG, T, Tin><<<blocks, T, smem, a.stream>>>(
      frames, a.B, a.Y, a.X, a.hits, a.n, a.baseline, a.factor, a.eps,
      a.max_it, a.next, a.theta_c, a.old_c, a.done_c, a.iters_c, a.ms_c);
  return (int)cudaGetLastError();
}

// Dispatch on box and method; cudaErrorInvalidValue for a box without
// an instance.
template <typename Tin>
int winfit_mle_queue_dispatch(const Tin* frames, int box, int method,
                              const WinfitMleQueueArgs& a) {
  switch (box) {
#define PICASSO_K5Q_CASE(S)                                   \
  case S:                                                     \
    return method == 1 ? queue_launch<S, true>(frames, a)     \
                       : queue_launch<S, false>(frames, a);
#ifdef PICASSO_K5Q_ONLY_BOX
    PICASSO_K5Q_CASE(PICASSO_K5Q_ONLY_BOX)
#else
    PICASSO_K5Q_CASE(5)
    PICASSO_K5Q_CASE(7)
    PICASSO_K5Q_CASE(9)
    PICASSO_K5Q_CASE(11)
    PICASSO_K5Q_CASE(13)
    PICASSO_K5Q_CASE(15)
#endif
#undef PICASSO_K5Q_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The float32 half, defined in winfit_mle_queue_f32.cu.
int picasso_winfit_mle_queue_f32(const float* frames, int box, int method,
                                 const WinfitMleQueueArgs& a);
