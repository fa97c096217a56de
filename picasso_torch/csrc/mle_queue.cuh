// The MLE fit (sigmaxy and sigma) as a work queue (sm_90a): one
// persistent launch with lane refill and a warp-cooperative straggler
// tail, templated on where a spot's pixels come from (fit_common.cuh's
// source policies) and on where the CRLB/LL runs. Two sources
// instantiate it:
//   ChunkWindows  K5, the fused cut + photon conversion + fit of a hit
//                 list from a frame chunk (winfit_mle_queue.cu, _f32.cu);
//   RoiBatch      the fit of a cut (S, S, N) f32 ROI batch, K1 and K7,
//                 as one launch with the CRLB/LL in the queue
//                 (roi_mle_fit.cu).
//
// Replaces, on the main paths, the Pallas TPU kernels
// picasso_tpu/ops/winfit_pallas.py _mle_kernel (fit_mle_t) and
// picasso_tpu/ops/mle_pallas.py _tile_kernel (fit_pallas_t) and the
// rounds of fit_pallas_multiround, and with them the phase schedule that
// the TPU needs (launches ending at given steps with host permutes
// between them). A TPU lane cannot take new work when its spot converges, so the
// JAX package reorders lanes stragglers first between launches. A SIMT
// lane can: each warp owns 32 lane slots, and a slot whose spot has
// converged (or reached max_it) takes the next spot from a device-side
// counter.
//
// What bounds it on the card: issued FP32 instructions (about 2,950 a
// Newton step of a box-7 spot), not bytes: each spot's pixels are read
// from global memory once and its carry written once. One thread a spot
// (K1, K2) loses its time three ways: warp divergence (a warp issues
// until its slowest spot is done), the pixels read again from global
// memory at every step and every phase, and the straggler tail (a spot
// that runs to max_it takes max_it steps one after the other in one
// thread, and ends the launch long after the bulk). The design:
//   - one launch of SMs x resident blocks (cudaOccupancy...), capped at
//     what N needs; every lane stays in the loop until its warp is done,
//     so the warp collectives below always see the full mask;
//   - a free slot stages its spot in shared memory as [pixel][thread]
//     (the source's stage) and runs init_theta; then every trip of the
//     warp's loop takes one newton_trip (fit_mle.cuh) for each busy slot,
//     with the pixels read from shared memory;
//   - free slots refill together, only when kRefill of the warp's 32 are
//     free or none is busy: one atomicAdd on the counter per refill,
//     warp-aggregated (__ballot_sync, __popc, __shfl_sync of the base),
//     so the divergent stage + init of a refill is shared by several
//     slots, and the claimed indices are consecutive (a ROI batch's stage
//     load coalesces);
//   - with TAIL, the cooperative tail: once the counter is drained for a
//     warp and at most 32/G of its slots are busy, its lanes form groups
//     of G (G >= S + 1: 8 at boxes 3-7, 16 at 9-15) and group g runs the
//     g-th busy slot's spot to its end. The carry comes by __shfl_sync
//     from the slot's owner, the pixels from the owner's column of the
//     stage. One Newton step splits so: lane k <= S forms edge k of both
//     axes (its exponential and erfc), lane k < S point k from edges k
//     and k + 1, and the group broadcasts the points; lane j < S forms
//     row j's eleven column sums; every lane folds the nineteen row dots
//     in row order from shuffled operands (the row sums and the y
//     factors, not their products) and runs the same update, clamps,
//     constraints and convergence test, so the group holds one theta;
//   - K5: a finished spot writes its carry (theta, old, done, iters,
//     max_step) at its own index, in input order; the CRLB and
//     log-likelihood then run for all N spots as winfit_mle.cu's FINISH
//     mode at k = 0, uniform work with no permutation;
//   - with CRLB (K1, K7: roi_mle_fit.cu), the handoff: a finished spot
//     writes its theta and iteration count and a ready flag, and each
//     warp whose fits are done runs the CRLB/LL of 32 consecutive spots
//     at a time, one a lane, reading each ROI again from the batch, while
//     other warps still fit their stragglers: no carry is written and no
//     second launch.
// Each spot runs the same pieces of fit_mle.cuh in the same order as the
// one-thread pass (init_theta, Newton steps with the test against `old`,
// crlb_ll), with the same correctly rounded operations; only which lanes
// run them, and when, differs. So the result equals the one-thread pass
// (mle_fit.cu FULL), K2's phases and the gather route bit for bit.
//
// Left out, on purpose:
//   - tensor cores: the per-pixel work (model, 1/model, two
//     NaN-propagating clamps) is nonlinear; what stays bilinear after it
//     is 11 FMAs a pixel on a 7x7 grid, and TF32 would lose the digits
//     the fit's tolerances rest on;
//   - TMA / cp.async for the stage: a spot's 196 B (a ROI) or 98 B (a
//     u16 window) is staged once and then read from shared memory at each
//     of its Newton steps, so its load is a small share of a spot's time;
//     a u16 row at an arbitrary x is only 2-byte aligned, so a tiled TMA
//     box of S x 8 u16 would be the form.
//
// The constants below are the measured choice (PERF.md); the macros only
// let tests/torch_k5_queue_sweep.py build the variants it times (and
// winfit_mle_queue.cuh's PICASSO_K5Q_TAIL tests/torch_mle_tail_sweep.py).
// The ROI queue (roi_mle_fit.cu) takes the tail for both methods.
// PICASSO_K5Q_ONLY_BOX restricts a build to one box.

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

// Arguments of one queue launch, whatever the source: n spots, the
// counter `next` (zero before the launch), the carry (K5) written at each
// spot's index (theta, old, max_step (R, n), done, iters (n,) f32), and
// coop_steps (one int32 on the card, or null), which gains the
// spot-steps taken in the cooperative tail. With info set, the launch
// helper describes the instance (threads, resident blocks per SM,
// registers, local bytes, refill, min blocks, SMs, the lanes of a
// cooperative group or 0 without the tail) and launches nothing. A
// queue with the CRLB in it (CRLB below) writes the outputs theta_o,
// crlb_o (6, n), ll_o (n,) f32 and iters_o (n,) int32 instead of the
// carry, with a second counter next2 and a ready flag a spot (ready),
// all zero before the launch.
struct MleQueueArgs {
  long long n;
  float eps;
  int max_it;
  int* next;
  float *theta_c, *old_c, *done_c, *iters_c, *ms_c;
  int* coop_steps;
  int* info;
  cudaStream_t stream;
  float *theta_o, *crlb_o, *ll_o;
  int* iters_o;
  int *next2, *ready;
};

namespace {

// free slots of a warp that refill together
constexpr int kRefill = PICASSO_K5Q_REFILL;
// __launch_bounds__' minimum resident blocks per SM
constexpr int kMinBlocks = PICASSO_K5Q_MIN_BLOCKS;
// The __launch_bounds__ minimum of the queue with the CRLB/LL in it at
// boxes <= 7: the CRLB/LL after the fit loop would take the kernel to
// 174-178 registers and 2 blocks a SM, where the loop itself runs in
// 156-160 and 3 (PERF.md).
constexpr int kFitMinBlocks = 3;

// the stage of a block stays within this, so two blocks fit on an SM
constexpr int kStageBytes = 113 * 1024;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMleQueueInfo = 8;

template <int S>
constexpr int queue_threads() {
  int t = PICASSO_K5Q_THREADS;
  while (t > 32 && S * S * t * 4 > kStageBytes) t /= 2;
  return t;
}

// lanes of a cooperative group: a power of two >= S + 1, so that the
// S + 1 edges of an axis fit in one group
template <int S>
__host__ __device__ constexpr int mle_group() {
  return S + 1 <= 8 ? 8 : 16;
}

// One Newton step of the group's spot at theta th, spread over its G
// lanes (gl = 0..G-1); every lane ends with the same theta.
template <int S, bool SIG, int G, class Src>
__device__ __forceinline__ void coop_newton_step(const Src& px, int gl,
                                                 float* th,
                                                 const float* ms) {
  const int ke = gl < S ? gl : S;     // the edge this lane forms
  const int k = gl < S ? gl : S - 1;  // its point and its row
  const float sx = th[4], sy = th[SIG ? 4 : 5];
  float isx, nx, isy, ny;
  axis_scale(sx, isx, nx);
  axis_scale(sy, isy, ny);
  float ax, ex, qx, ay, ey, qy;
  mle_edge(S, ke, th[0], isx, ax, ex, qx);
  mle_edge(S, ke, th[1], isy, ay, ey, qy);
  auto at = [](float v, int src) { return __shfl_sync(kAll, v, src, G); };
  float pt_x[5], pt_y[5];  // psf, dmu, d2mu, dsig, d2sig at point k
  mle_point<SIG>(k, th[0], sx, isx, nx, at(ax, k), at(ax, k + 1), at(ex, k),
                 at(ex, k + 1), at(qx, k), at(qx, k + 1), pt_x[0], pt_x[1],
                 pt_x[2], pt_x[3], pt_x[4]);
  mle_point<SIG>(k, th[1], sy, isy, ny, at(ay, k), at(ay, k + 1), at(ey, k),
                 at(ey, k + 1), at(qy, k), at(qy, k + 1), pt_y[0], pt_y[1],
                 pt_y[2], pt_y[3], pt_y[4]);
  float fx[5][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int t = 0; t < 5; ++t) fx[t][i] = at(pt_x[t], i);
  float f[kCols][S];
  mle_columns<S>(fx[0], fx[1], fx[2], fx[3], fx[4], f);
  float c[11];
  mle_row<S, SIG>(px, k, th[2] * pt_y[0], th[3], f, c);
  float a[kDots];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float cj[11];
#pragma unroll
    for (int t = 0; t < 11; ++t) cj[t] = at(c[t], j);
    mle_fold(j == 0, at(pt_y[0], j), at(pt_y[1], j), at(pt_y[2], j),
             at(pt_y[3], j), at(pt_y[4], j), cj, a);
  }
  mle_update<SIG>(S, a, th, ms);
}

// Write a finished spot's carry at its index n.
template <int R>
__device__ __forceinline__ void store_carry(long long n, long long N,
                                            const float* th,
                                            const float* old,
                                            const float* ms, float done,
                                            float iters, float* theta_c,
                                            float* old_c, float* done_c,
                                            float* iters_c, float* ms_c) {
#pragma unroll
  for (int p = 0; p < R; ++p) {
    theta_c[p * N + n] = th[p];
    old_c[p * N + n] = old[p];
    ms_c[p * N + n] = ms[p];
  }
  done_c[n] = done;
  iters_c[n] = iters;
}

// The cooperative tail of a drained warp whose busy slots (the lanes of
// busy, at most 32/G) carry th, old, ms, done, iters, n: group g adopts
// the g-th busy slot and runs its spot to convergence or max_it, then
// writes its carry, or with RET hands its theta and iteration count
// back to the slot's owner (th, iters of the owner's lane; other lanes'
// th, old, ms, done and iters are left meaningless). Called by the
// whole warp; returns with every slot finished.
template <int S, bool SIG, int T, bool RET>
__device__ __forceinline__ void mle_coop_tail(
    const float* stage, unsigned busy, float* th, float* old, float* ms,
    float& done, float& iters, long long n, long long N, float limit,
    float eps, float* theta_c, float* old_c, float* done_c, float* iters_c,
    float* ms_c, int* coop_steps) {
  constexpr int G = mle_group<S>();
  constexpr int R = SIG ? 5 : 6;
  const int lane = threadIdx.x & 31;
  const int g = lane / G, gl = lane % G;
  __syncwarp();  // the owners' stage columns, written lane by lane
  const bool adopted = g < __popc(busy);
  // group g's owner is the g-th busy lane; a group without a slot
  // shadows the first busy slot, running its steps but writing and
  // counting nothing, so that every lane computes on a real spot
  unsigned rest = busy;
  for (int i = 0; i < g; ++i) rest &= rest - 1u;
  const int owner = __ffs(adopted ? rest : busy) - 1;
#pragma unroll
  for (int p = 0; p < R; ++p) {
    th[p] = __shfl_sync(kAll, th[p], owner);
    old[p] = __shfl_sync(kAll, old[p], owner);
    ms[p] = __shfl_sync(kAll, ms[p], owner);
  }
  done = __shfl_sync(kAll, done, owner);
  iters = __shfl_sync(kAll, iters, owner);
  n = __shfl_sync(kAll, n, owner);
  const Staged<S, T> px{stage + (threadIdx.x - lane) + owner};
  bool active = true;
  int taken = 0;
  while (__any_sync(kAll, active)) {
    const bool go = active && !(done > 0.5f) && iters < limit;
    if (active && !go) {
      if (!RET && adopted && gl == 0)
        store_carry<R>(n, N, th, old, ms, done, iters, theta_c, old_c,
                       done_c, iters_c, ms_c);
      active = false;
    }
    if (!__any_sync(kAll, go)) continue;
    float nt[6];
#pragma unroll
    for (int p = 0; p < R; ++p) nt[p] = th[p];
    coop_newton_step<S, SIG, G>(px, gl, nt, ms);
    if (go) {
#pragma unroll
      for (int p = 0; p < R; ++p) th[p] = nt[p];
      mle_converge<SIG>(th, old, done, iters, eps);
      ++taken;
    }
  }
  if (coop_steps != nullptr && adopted && gl == 0)
    atomicAdd(coop_steps, taken);
  if constexpr (RET) {
    // a busy lane's spot is its group's: the group's first lane holds it
    const int from = (__popc(busy & ((1u << lane) - 1u)) * G) & 31;
#pragma unroll
    for (int p = 0; p < R; ++p) th[p] = __shfl_sync(kAll, th[p], from);
    iters = __shfl_sync(kAll, iters, from);
  }
}

// The queue with the CRLB/LL in it: a finished spot's theta (with SIG
// the sigma row twice) and iteration count.
template <bool SIG>
__device__ __forceinline__ void store_fit(long long n, long long N,
                                          const float* th, float iters,
                                          float* theta_o, int* iters_o) {
#pragma unroll
  for (int p = 0; p < 6; ++p) theta_o[p * N + n] = th[SIG && p == 5 ? 4 : p];
  iters_o[n] = (int)iters;
}

// Set the ready flag of spot pub (if >= 0) after this lane's earlier
// writes (its theta and iters): one fence for the warp's lanes whose spots
// finished in its last trip. Called by the whole warp.
__device__ __forceinline__ void publish(int* ready, long long pub) {
  __threadfence();
  if (pub >= 0) atomicExch(ready + pub, 1);
}

// The CRLB/LL of the queue with it in it: a warp whose fits are done
// takes 32 consecutive spots at a time from the second counter next2
// (one a lane), waits until each is finished (its ready flag, set by
// whichever warp fitted it), and runs its CRLB and log-likelihood from
// its theta and its ROI in the batch. Every spot is claimed by a running
// warp before any warp gets here (the first counter has passed N), so
// each wait ends.
template <int S, bool SIG>
__device__ __forceinline__ void handoff_epilogue(
    const float* __restrict__ spots, long long N, int* next2,
    const int* ready, const float* theta_o, float* crlb_o, float* ll_o) {
  const unsigned lane = threadIdx.x & 31u;
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next2, 32);
    base = __shfl_sync(kAll, base, 0);
    if ((long long)base >= N) break;
    const long long m = (long long)base + lane;
    if (m < N) {
      int flag = 0;
      while (true) {
        asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                     : "=r"(flag)
                     : "l"(ready + m)
                     : "memory");
        if (flag != 0) break;
        __nanosleep(64);
      }
      float th[6], crlb[6], ll;
#pragma unroll
      for (int p = 0; p < 6; ++p) th[p] = __ldcg(theta_o + p * N + m);
      crlb_ll<S, SIG>(LanesLast<S>{spots + m, N}, th, crlb, ll);
#pragma unroll
      for (int p = 0; p < 6; ++p) crlb_o[p * N + m] = crlb[p];
      ll_o[m] = ll;
    }
  }
}

// The queue. Without CRLB (K5) a finished spot writes its carry at once
// and frees its slot; the CRLB/LL pass is a second launch (FINISH). With
// CRLB (roi_mle_fit.cu) a finished spot writes its theta and iteration
// count and sets its ready flag; once a warp's fits are done it runs the
// CRLB/LL of 32 spots at a time (handoff_epilogue), while other warps
// still fit their stragglers.
template <int S, bool CRLB>
constexpr int queue_min_blocks() {
  return CRLB && S <= 7 ? kFitMinBlocks : kMinBlocks;
}

template <int S, bool SIG, int T, bool TAIL, bool CRLB, class Source>
__global__ void __launch_bounds__(T, (queue_min_blocks<S, CRLB>()))
    mle_queue_kernel(const Source src, long long N, float eps, int max_it,
                     int* __restrict__ next, float* theta_c, float* old_c,
                     float* done_c, float* iters_c, float* ms_c,
                     int* coop_steps, float* theta_o, float* crlb_o,
                     float* ll_o, int* iters_o, int* next2, int* ready) {
  extern __shared__ float stage[];
  constexpr int R = SIG ? 5 : 6;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  float* mine = stage + threadIdx.x;
  const Staged<S, T> px{mine};
  const float limit = (float)max_it;
  float th[6], old[6], ms[6], done = 0.0f, iters = 0.0f;
  long long n = -1;      // this slot's spot; -1 while the slot is free
  long long pub = -1;    // CRLB: its spot finished last trip, flag unset
  bool drained = false;  // the counter has passed N (uniform in the warp)
  while (true) {
    const unsigned free_mask = __ballot_sync(kAll, n < 0);
    const int n_free = __popc(free_mask);
    const bool refill = !drained && (n_free >= kRefill || n_free == 32);
    if constexpr (CRLB) {
      if (__any_sync(kAll, pub >= 0)) {
        publish(ready, pub);
        pub = -1;
      }
    }
    if (refill) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next, n_free);
      base = __shfl_sync(kAll, base, 0);
      drained = (long long)base + n_free >= N;
      const long long i = (long long)base + __popc(free_mask & below);
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
    const unsigned busy = __ballot_sync(kAll, n >= 0);
    if (busy == 0u && drained) break;
    if constexpr (TAIL) {
      if (drained && __popc(busy) <= 32 / mle_group<S>()) {
        mle_coop_tail<S, SIG, T, CRLB>(stage, busy, th, old, ms, done, iters,
                                       n, N, limit, eps, theta_c, old_c,
                                       done_c, iters_c, ms_c, coop_steps);
        if constexpr (CRLB) {
          if (n >= 0) store_fit<SIG>(n, N, th, iters, theta_o, iters_o);
          publish(ready, n);
        }
        break;
      }
    }
    if (n >= 0) {
      // a slot of a K5 chunk is never done here: its spot starts running
      bool run = iters < limit;
      if constexpr (Source::kMayStartDone) run = run && !(done > 0.5f);
      if (run) newton_trip<S, SIG>(px, th, old, done, iters, ms, eps);
      if (done > 0.5f || !(iters < limit)) {
        if constexpr (CRLB) {
          store_fit<SIG>(n, N, th, iters, theta_o, iters_o);
          pub = n;
        } else {
          store_carry<R>(n, N, th, old, ms, done, iters, theta_c, old_c,
                         done_c, iters_c, ms_c);
        }
        n = -1;
      }
    }
  }
  if constexpr (CRLB)
    handoff_epilogue<S, SIG>(src.spots, N, next2, ready, theta_o, crlb_o,
                             ll_o);
}

template <int S, bool SIG, bool TAIL, bool CRLB, class Source>
int mle_queue_launch(const Source& src, const MleQueueArgs& a) {
  constexpr int T = queue_threads<S>();
  constexpr int smem = S * S * T * (int)sizeof(float);
  const auto kernel = mle_queue_kernel<S, SIG, T, TAIL, CRLB, Source>;
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
    const int info[kMleQueueInfo] = {
        T,       per_sm,     attr.numRegs, (int)attr.localSizeBytes,
        kRefill, queue_min_blocks<S, CRLB>(), sms,
        TAIL ? mle_group<S>() : 0};
    for (int i = 0; i < kMleQueueInfo; ++i) a.info[i] = info[i];
    return 0;
  }
  const long long need = (a.n + T - 1) / T;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned int blocks =
      (unsigned int)(need < resident ? need : resident);
  kernel<<<blocks, T, smem, a.stream>>>(
      src, a.n, a.eps, a.max_it, a.next, a.theta_c, a.old_c, a.done_c,
      a.iters_c, a.ms_c, a.coop_steps, a.theta_o, a.crlb_o, a.ll_o,
      a.iters_o, a.next2, a.ready);
  return (int)cudaGetLastError();
}

// Dispatch on box and method (0 sigmaxy, 1 sigma; TAIL_XY / TAIL_SIG:
// whether that method's instances take the cooperative tail; CRLB: the
// CRLB/LL in the queue, not the carry out); cudaErrorInvalidValue for a
// box without an instance.
template <bool TAIL_XY, bool TAIL_SIG, bool CRLB = false, class Source>
int mle_queue_dispatch(const Source& src, int box, int method,
                       const MleQueueArgs& a) {
  if (method < 0 || method > 1) return (int)cudaErrorInvalidValue;
  switch (box) {
#define PICASSO_MLEQ_CASE(S)                                               \
  case S:                                                                  \
    return method == 1 ? mle_queue_launch<S, true, TAIL_SIG, CRLB>(src, a) \
                       : mle_queue_launch<S, false, TAIL_XY, CRLB>(src, a);
#ifdef PICASSO_K5Q_ONLY_BOX
    PICASSO_MLEQ_CASE(PICASSO_K5Q_ONLY_BOX)
#else
    PICASSO_MLEQ_CASE(3)
    PICASSO_MLEQ_CASE(5)
    PICASSO_MLEQ_CASE(7)
    PICASSO_MLEQ_CASE(9)
    PICASSO_MLEQ_CASE(11)
    PICASSO_MLEQ_CASE(13)
    PICASSO_MLEQ_CASE(15)
#endif
#undef PICASSO_MLEQ_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
