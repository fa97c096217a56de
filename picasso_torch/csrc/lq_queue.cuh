// The LM fit as a work queue (sm_90a): the Levenberg-Marquardt fit of
// a whole list of spots in one persistent launch with lane refill and a
// cooperative straggler tail, templated on where a spot's pixels come
// from (fit_common.cuh's source policies). Two sources instantiate it:
//   ChunkWindows  K5, the fused cut + photon conversion + fit of a hit
//                 list from a frame chunk (winfit_lq_queue.cu, _f32.cu);
//   RoiBatch      K3 as a queue, the fit of a cut (S, S, N) f32 ROI batch
//                 (roi_lq_queue.cu), fit2D's LM.
//
// Replaces, on the main paths, the Pallas TPU kernels
// picasso_tpu/ops/winfit_pallas.py _lq_kernel (fit_lq_t) and
// picasso_tpu/ops/lq_pallas.py _tile_kernel (fit_pallas_t). A TPU lane
// cannot take new work when its spot converges; a SIMT lane can, and a
// warp's lanes can also share one spot's work.
//
// What bounds it on the card: issued FP32 instructions (~1,860 FLOPs an
// LM step of a box-7 spot), not bytes: each spot's pixels are read from
// global memory once and theta written once. One thread a spot loses its
// time three ways (PERF.md): warp divergence (a warp issues until its
// slowest spot is done: 2.4-3.4x the mean steps on the smoke's inputs),
// the straggler tail (a spot that runs all max_it steps, one after the
// other in one thread, ends the launch long after the bulk), and work
// repeated after a rejected step (30-51% of the steps; fit_lq.cuh reuses
// the normal equations there). The design:
//   - one launch of SMs x resident blocks (cudaOccupancy...), capped at
//     what N needs; every lane stays in the loop until its warp is done,
//     so the warp collectives below always see the full mask;
//   - each warp owns 32 slots; free slots refill together, only when
//     kLqRefill of them are free or none is busy: one atomicAdd on the
//     counter per refill, warp-aggregated (__ballot_sync, __popc,
//     __shfl_sync of the base), so the claimed indices are consecutive;
//     a slot that claims a spot stages it as [pixel][thread] (the
//     source's stage) and runs lq_init_theta and cost; each trip of the
//     loop then takes one LM step for each busy slot, and a finished slot
//     writes theta at its spot's index;
//   - the cooperative tail: once the counter is drained for a warp and
//     at most 32/G of its slots are busy, its lanes form groups of G
//     (G >= S: 8 at boxes 3-7, 16 at 9-15) and group g runs the g-th
//     busy slot's spot to its end. The carry comes by __shfl_sync from
//     the slot's owner, the pixels are read from the owner's column of
//     the stage. Lane k < S forms point k of both axes and the group
//     broadcasts them; lane j < S forms row j's column sums of J^T r and
//     row j of the trial cost; the rows are folded in row order by
//     shuffles of the row sums (the operands, not their products), with
//     fit_lq.cuh's fold. Every lane of the group then runs the dot
//     products, the damped step and the acceptance with the same
//     arithmetic, so the group holds one theta.
// Each spot runs the same pieces of fit_lq.cuh in the same order as K3
// (stage, lq_init_theta, cost, then per step the normal equations when
// theta moved, the damped step, the trial cost, the acceptance), with
// the same correctly rounded operations; which lanes form a row, and
// when, differs. So theta equals K3 and K6 bit for bit.
//
// Left out, on purpose: tensor cores (the per-pixel work is nonlinear;
// TF32 would lose the digits the LM's acceptance test rests on), and
// TMA / cp.async for the stage (a spot is staged once, then read from
// shared memory at each step).
//
// The two constants below are the measured choice (PERF.md); the macros
// only let tests/torch_k5_lq_sweep.py build the variants it times. Its
// earlier runs also built the queue without the cooperative tail,
// without the reuse of the normal equations, and at 4 or 8 blocks a SM
// (128 registers); none won (PERF.md), and their switches are gone.
// PICASSO_K5LQ_ONLY_BOX restricts a build to one box.

#pragma once

#include "fit_lq.cuh"

#ifndef PICASSO_K5LQ_REFILL
#define PICASSO_K5LQ_REFILL 16
#endif
#ifndef PICASSO_K5LQ_THREADS
#define PICASSO_K5LQ_THREADS 128
#endif

// Arguments of one queue launch, whatever the source: n spots, the
// counter `next` (zero before the launch), theta (6, n) out at each
// spot's index, and coop_steps (one int32 on the card, or null), which
// gains the spot-steps taken in the cooperative tail. With info set, the
// launch helper describes the instance (threads, resident blocks per SM,
// registers, local bytes, refill, group, SMs) and launches nothing.
struct LqQueueArgs {
  int n;
  float ftol;
  int max_it;
  int* next;
  float* theta;
  int* coop_steps;
  int* info;
  cudaStream_t stream;
};

namespace {

// free slots of a warp that refill together
constexpr int kLqRefill = PICASSO_K5LQ_REFILL;
// __launch_bounds__' minimum resident blocks per SM
constexpr int kLqMinBlocks = 2;
// the stage of a block stays within this, so two blocks fit on an SM
constexpr int kLqStageBytes = 113 * 1024;
constexpr unsigned kLqAll = 0xffffffffu;

template <int S>
constexpr int lq_queue_threads() {
  int t = PICASSO_K5LQ_THREADS;
  while (t > 32 && S * S * t * 4 > kLqStageBytes) t /= 2;
  return t;
}

// lanes of a cooperative group: a power of two >= S
template <int S>
__host__ __device__ constexpr int lq_group() {
  return S <= 8 ? 8 : 16;
}

// The normal equations of the group's spot at theta th: lane gl forms
// axis point k = min(gl, S-1) of both axes and row k of J^T r; the group
// broadcasts the points and folds the rows in order. Every lane ends
// with the same (a, jtr); they are stored only where upd.
template <int S, int G, class Src>
__device__ __forceinline__ void coop_normal_equations(
    const Src& px, int k, const float* th, bool upd, float* a, float* jtr) {
  float mx, mdx, msx, my, mdy, msy;
  axis_point<true>(S / 2, k, th[0], __fdiv_rn(1.0f, th[4]), mx, mdx, msx);
  axis_point<true>(S / 2, k, th[1], __fdiv_rn(1.0f, th[5]), my, mdy, msy);
  float gx[S], gy[S], dgx[S], dgy[S], dsx[S], dsy[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    gx[i] = __shfl_sync(kLqAll, mx, i, G);
    dgx[i] = __shfl_sync(kLqAll, mdx, i, G);
    dsx[i] = __shfl_sync(kLqAll, msx, i, G);
    gy[i] = __shfl_sync(kLqAll, my, i, G);
    dgy[i] = __shfl_sync(kLqAll, mdy, i, G);
    dsy[i] = __shfl_sync(kLqAll, msy, i, G);
  }
  const float ph = th[2];
  float c[4];
  jtr_row<S>(px, k, __fmul_rn(ph, my), th[3], gx, dgx, dsx, c);
  float jd[6];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float cj[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) cj[q] = __shfl_sync(kLqAll, c[q], j, G);
    jtr_fold(j == 0, gy[j], dgy[j], dsy[j], cj, jd);
  }
  float na[21], nj[6];
  normal_matrix<S>(gx, dgx, dsx, gy, dgy, dsy, ph, jd, na, nj);
#pragma unroll
  for (int p = 0; p < 21; ++p) a[p] = upd ? na[p] : a[p];
#pragma unroll
  for (int p = 0; p < 6; ++p) jtr[p] = upd ? nj[p] : jtr[p];
}

// The cost of the group's spot at theta th: lane gl forms axis point k
// and row k; the group folds the rows in order. Every lane returns it.
template <int S, int G, class Src>
__device__ __forceinline__ float coop_cost(const Src& px, int k,
                                           const float* th) {
  float mx, my, unused;
  axis_point<false>(S / 2, k, th[0], __fdiv_rn(1.0f, th[4]), mx, unused,
                    unused);
  axis_point<false>(S / 2, k, th[1], __fdiv_rn(1.0f, th[5]), my, unused,
                    unused);
  float gx[S];
#pragma unroll
  for (int i = 0; i < S; ++i) gx[i] = __shfl_sync(kLqAll, mx, i, G);
  const float row = cost_row<S>(px, k, __fmul_rn(th[2], my), th[3], gx);
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float v = __shfl_sync(kLqAll, row, j, G);
    total = j == 0 ? v : __fadd_rn(total, v);
  }
  return total;
}

// The cooperative tail of a drained warp whose busy slots (the lanes of
// busy, at most 32/G) are carried in th, lam, cst, done, steps, n: group
// g adopts the g-th busy slot and runs its spot to done or max_it, then
// writes its theta. Called by the whole warp; returns with every slot
// finished.
template <int S, int T>
__device__ __forceinline__ void lq_coop_tail(
    const float* stage, unsigned busy, float* th, float lam, float cst,
    float done, int steps, int n, int N, int max_it, float ftol,
    float* theta, int* coop_steps) {
  constexpr int G = lq_group<S>();
  const int lane = threadIdx.x & 31;
  const int g = lane / G, gl = lane % G;
  __syncwarp();  // the owners' stage columns, written lane by lane
  const bool adopted = g < __popc(busy);
  // group g's owner is the g-th busy lane; a group without a slot
  // shadows the first busy slot, running its steps but writing and
  // counting nothing, so that every lane computes on a real spot: garbage
  // operands (zeros, inf) would send its divisions and square roots down
  // their slow paths, which the whole warp then waits for
  unsigned rest = busy;
  for (int i = 0; i < g; ++i) rest &= rest - 1u;
  const int owner = __ffs(adopted ? rest : busy) - 1;
#pragma unroll
  for (int p = 0; p < 6; ++p) th[p] = __shfl_sync(kLqAll, th[p], owner);
  lam = __shfl_sync(kLqAll, lam, owner);
  cst = __shfl_sync(kLqAll, cst, owner);
  done = __shfl_sync(kLqAll, done, owner);
  steps = __shfl_sync(kLqAll, steps, owner);
  n = __shfl_sync(kLqAll, n, owner);
  const Staged<S, T> px{stage + (threadIdx.x - lane) + owner};
  const int k = gl < S ? gl : S - 1;
  float a[21] = {}, jtr[6] = {};
  bool fresh = true, active = true;
  int taken = 0;
  while (__any_sync(kLqAll, active)) {
    const bool go = active && !(done > 0.5f) && steps < max_it;
    if (active && !go) {
      if (adopted && gl == 0) {
#pragma unroll
        for (int p = 0; p < 6; ++p) theta[(long long)p * N + n] = th[p];
      }
      active = false;
    }
    if (!__any_sync(kLqAll, go)) continue;
    const bool form = go && fresh;
    if (__any_sync(kLqAll, form))
      coop_normal_equations<S, G>(px, k, th, form, a, jtr);
    float trial[6];
    const bool finite = damped_trial(a, jtr, th, lam, trial);
    const float tc = coop_cost<S, G>(px, k, trial);
    if (go) {
      fresh = lm_accept(tc, finite, trial, th, lam, cst, done, ftol);
      ++steps;
      ++taken;
    }
  }
  if (coop_steps != nullptr && adopted && gl == 0)
    atomicAdd(coop_steps, taken);
}

template <int S, int T, class Source>
__global__ void __launch_bounds__(T, kLqMinBlocks) lq_queue_kernel(
    const Source src, int N, float ftol, int max_it, int* __restrict__ next,
    float* theta, int* coop_steps) {
  extern __shared__ float stage[];
  constexpr int G = lq_group<S>();
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  float* mine = stage + threadIdx.x;
  const Staged<S, T> px{mine};
  float th[6] = {}, lam = 0.0f, cst = 0.0f, done = 0.0f;
  float a[21] = {}, jtr[6] = {};
  bool fresh = true;
  int steps = 0;
  int n = -1;            // this slot's hit; -1 while the slot is free
  bool drained = false;  // the counter has passed N (uniform in the warp)
  while (true) {
    const unsigned free_mask = __ballot_sync(kLqAll, n < 0);
    const int n_free = __popc(free_mask);
    if (!drained && (n_free >= kLqRefill || n_free == 32)) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next, n_free);
      base = __shfl_sync(kLqAll, base, 0);
      drained = (long long)base + n_free >= N;
      const long long i = (long long)base + __popc(free_mask & below);
      if (n < 0 && i < N) {
        n = (int)i;
        src.template stage<S, T>(n, mine);
        lq_init_theta<S>(px, th);
        cst = cost<S>(px, th);
        lam = 1e-3f;
        done = src.starts_done(n) ? 1.0f : 0.0f;
        steps = 0;
        fresh = true;
      }
    }
    const unsigned busy = __ballot_sync(kLqAll, n >= 0);
    if (busy == 0u && drained) break;
    if (drained && __popc(busy) <= 32 / G) {
      lq_coop_tail<S, T>(stage, busy, th, lam, cst, done, steps, n, N,
                         max_it, ftol, theta, coop_steps);
      break;
    }
    if (n >= 0) {
      if (!(done > 0.5f) && steps < max_it) {
        lm_step<S>(px, th, lam, cst, done, ftol, a, jtr, fresh);
        ++steps;
      }
      if (done > 0.5f || steps >= max_it) {
#pragma unroll
        for (int p = 0; p < 6; ++p) theta[(long long)p * N + n] = th[p];
        n = -1;
      }
    }
  }
}

template <int S, class Source>
int lq_queue_launch(const Source& src, const LqQueueArgs& a) {
  constexpr int T = lq_queue_threads<S>();
  constexpr int smem = S * S * T * (int)sizeof(float);
  const auto kernel = lq_queue_kernel<S, T, Source>;
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
    const int info[7] = {T,         per_sm,        attr.numRegs,
                         (int)attr.localSizeBytes,
                         kLqRefill, lq_group<S>(), sms};
    for (int i = 0; i < 7; ++i) a.info[i] = info[i];
    return 0;
  }
  const long long need = ((long long)a.n + T - 1) / T;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned int blocks =
      (unsigned int)(need < resident ? need : resident);
  kernel<<<blocks, T, smem, a.stream>>>(src, a.n, a.ftol, a.max_it, a.next,
                                        a.theta, a.coop_steps);
  return (int)cudaGetLastError();
}

// Dispatch on box; cudaErrorInvalidValue for a box without an instance.
template <class Source>
int lq_queue_dispatch(const Source& src, int box, const LqQueueArgs& a) {
  switch (box) {
#define PICASSO_LQQ_CASE(S) \
  case S:                   \
    return lq_queue_launch<S>(src, a);
#ifdef PICASSO_K5LQ_ONLY_BOX
    PICASSO_LQQ_CASE(PICASSO_K5LQ_ONLY_BOX)
#else
    PICASSO_LQQ_CASE(3)
    PICASSO_LQQ_CASE(5)
    PICASSO_LQQ_CASE(7)
    PICASSO_LQQ_CASE(9)
    PICASSO_LQQ_CASE(11)
    PICASSO_LQQ_CASE(13)
    PICASSO_LQQ_CASE(15)
#endif
#undef PICASSO_LQQ_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
