// The MLE fit (sigmaxy and sigma) with its CRLB and log-likelihood at any
// box, the box a launch argument, as one work-queue launch (sm_90a): what
// roi_mle_fit.cu (mle_queue.cuh) does at the templated boxes 3-15, for
// every other box >= 1, on a lanes-last (s, s, N) f32 ROI batch.
//
// Replaces, at the boxes that mle_fit.cu and roi_mle_fit.cu are not
// built for, the Pallas TPU kernels of picasso_tpu/ops/mle_pallas.py:
//   K1  _tile_kernel (fit_pallas_t);
//   K2  _start_phase_kernel, _resume_phase_kernel, _finish_phase_kernel
//       (fit_pallas_boundary_t): one launch, which the phases equal by
//       construction (a spot's trajectory does not depend on the phase
//       boundaries);
//   K7  _first_round_kernel, _resume_round_kernel, _finalize_kernel
//       (fit_pallas_multiround), likewise one launch;
// and, fed by cut_anybox.cu's ROIs, the MLE half of K5
// (picasso_tpu/ops/winfit_pallas.py _mle_kernel).
//
// What bounds it on the card: issued FP32 instructions (about 10,400
// FLOPs a Newton step of a box-17 spot). Its first form (mle_anybox.cu,
// one thread a spot, off every path since) lost its time three ways: a
// warp lasted as long as its slowest spot (on 131,072 make_spots at box
// 17, 2,110 run to max_it), and every Newton step read the ROI and a
// (9, s, N) workspace of column factors from global memory, 10 loads a
// pixel. The design is mle_queue.cuh's with the box at run time:
//   - one launch of SMs x resident blocks; each warp owns 32 slots, and
//     a free slot claims the next spot from a device counter, warp-
//     aggregated (one atomicAdd a refill), when kAnyRefill of the warp's
//     32 are free or none is busy;
//   - a claimed spot is staged once in dynamic shared memory as
//     [pixel][slot] with a pixel stride of threads + 1 words, and every
//     Newton step reads it from there (a warp's read of one pixel
//     touches 32 banks; the tail's lanes, reading one spot's rows, fall
//     on s distinct banks at an odd box). Where even one warp's stage
//     would pass the 232,448 bytes a block may hold on an H100 (s above
//     41), the slots read the pixels from the batch (kPxBatch), and the
//     queue and the tail are the same. The stage (1,156 bytes a slot at
//     box 17) holds a SM to 4 warps: reading from the batch (or from a
//     per-slot global stage, a variant measured and dropped) lets 12-16
//     warps run and is still 1.2-2x slower (tests/torch_anybox_sweep.py,
//     PERF.md);
//   - the x axis's five column factors of a step (fit_mle_any.cuh
//     kAnyCols) live in shared memory (COLS) or in a per-slot global
//     scratch, a warp's read of one factor coalesced either way;
//   - the cooperative tail: once the counter is drained and at most
//     kAnyTail x 32 / G of a warp's slots are busy, groups of G lanes
//     (G a power of two >= s + 1: 8, 16 or 32; at s > 31 a whole warp
//     that loops over the points and rows, 32 a round) step the busy
//     slots' spots in turn to their end (any_coop_tail,
//     any_coop_newton_step): a lone straggler's step takes a warp's
//     lanes instead of one;
//   - the CRLB/LL handoff of roi_mle_fit.cu: a finished spot writes its
//     theta, its iteration count and a ready flag, and a warp whose fits
//     are done runs the CRLB/LL of 32 consecutive spots at a time, one a
//     lane, from their ROIs in the batch: no second launch.
// Each spot runs the pieces of fit_mle.cuh / fit_mle_any.cuh in the
// one-thread order with the same explicitly rounded operations, so the
// result equals the one-thread pass (mle_anybox.cu) bit for bit, and
// through it the templated queues at 5-15.
//
// Threads a block, the refill threshold and the busy slots a group at
// which a drained warp's tail starts are compile-time constants below,
// the measured choice; the macros only let tests/torch_anybox_sweep.py
// build the variants it times. Where the pixels and the column factors
// live and the group G are launch arguments, worked out from the box by
// picasso_torch/ops/mle_cuda.anybox_queue_config; this entry checks them.
// Measured (tests/torch_anybox_sweep.py on 131,072 make_spots a box,
// medians in rounds; NVIDIA H100 80GB HBM3, 700 W; PERF.md): sigmaxy in
// the chosen build, the stage and the column factors in shared memory,
// 0.632 / 5.515 / 18.971 ms at boxes 9 / 17 / 21, the one-thread pass
// 0.953 / 18.352 / 38.642 ms in the same rounds. Against it: the pixels
// from the batch 0.881 / 9.295 / 23.819 ms, the column factors in global
// memory 0.819 / 9.344 / 24.258, both 1.102 / 10.900 / 30.461. Sigma
// (no stragglers): 0.405 / 2.856 / 5.584 ms, the one pass 0.617 / 2.914
// / 4.736: at box 21 the queue loses to it.

#include "fit_mle_any.cuh"
#include "mle_queue.cuh"

// threads a block: one warp, as a box-17 stage holds a SM to 4 warps
// (sigmaxy with 64 threads: 0.663 / 5.455 / 26.807 ms at 9 / 17 / 21)
#ifndef PICASSO_ANYQ_THREADS
#define PICASSO_ANYQ_THREADS 32
#endif
// free slots of a warp that refill together (8: 0.652 / 5.830 / 17.628
// ms; 24: 0.587 / 5.182 / 25.749)
#ifndef PICASSO_ANYQ_REFILL
#define PICASSO_ANYQ_REFILL 16
#endif
// a drained warp's tail starts at this many busy slots a group (0, no
// tail: 0.702 / 5.944 / 19.483 ms; 2: 0.630 / 5.624 / 19.335; 8: 0.675
// / 5.528 / 18.664)
#ifndef PICASSO_ANYQ_TAIL
#define PICASSO_ANYQ_TAIL 4
#endif

// Arguments of one launch: n spots of the lanes-last (s, s, n) batch, the
// queue's two counters and a ready flag a spot at next[0], next[1],
// next[2..] (zero before the launch), the column factors' per-slot
// global scratch (5, s, work_slots) f32 when they are not in shared
// memory, the outputs theta, crlb (6, n), ll (n,) f32 and iters
// (n,) int32, and coop_steps (one int32, or null), which gains the
// spot-steps taken in the cooperative tail.
struct AnyQueueArgs {
  const float* spots;
  long long n, n_valid;
  int s;
  float eps;
  int max_it;
  int group;  // lanes of a cooperative group
  int* next;
  float* work;
  long long work_slots;
  float *theta_o, *crlb_o, *ll_o;
  int* iters_o;
  int* coop_steps;
};

namespace {

constexpr int kAnyThreads = PICASSO_ANYQ_THREADS;
constexpr int kAnyRefill = PICASSO_ANYQ_REFILL;
constexpr int kAnyTail = PICASSO_ANYQ_TAIL;
constexpr int kAnyQueueInfo = 6;
static_assert(kAnyThreads % 32 == 0 && kAnyThreads <= 1024, "threads");
static_assert(kAnyRefill >= 1 && kAnyRefill <= 32, "refill");

// Where a slot's pixels are read from: the lanes-last batch, a stage in
// shared memory.
enum { kPxBatch = 0, kPxShared = 1 };

// A slot's spot at box s: its pixels at p[(y * s + x) * ps] (PX: the
// batch through the read-only cache, or the stage in shared memory),
// and the x axis's column factors at w[(row * s + i) * ws].
template <int PX>
struct AnySlot {
  const float* p;
  float* w;
  long long ps, ws;
  int s;
  __device__ __forceinline__ float operator()(int y, int x) const {
    if constexpr (PX == kPxShared)
      return p[(y * s + x) * (int)ps];
    else
      return __ldg(p + (long long)(y * s + x) * ps);
  }
  __device__ __forceinline__ float& at(int row, int i) const {
    return w[(long long)(row * s + i) * ws];
  }
};

// One Newton step of the group's spot at theta th, spread over its G
// lanes (gl = 0..G-1); every lane ends with the same theta. Points and
// rows go 32 a round where s > G. In round r lane gl forms edge k = r*G
// + gl of an axis and takes edge k + 1 from the next lane (the round's
// last lane forms it too), so point k is formed from both; lane gl's
// row r*G + gl sums its eleven column sums over i in order from the x
// points, shuffled in one at a time; every lane folds the rows in order
// from shuffled operands and runs the same update, as the one-thread
// step does.
template <bool SIG, class Px>
__device__ __forceinline__ void any_coop_newton_step(const Px& px, int s,
                                                     int G, int gl,
                                                     float* th,
                                                     const float* ms) {
  const float sx = th[4], sy = th[SIG ? 4 : 5];
  float isx, nx, isy, ny;
  axis_scale(sx, isx, nx);
  axis_scale(sy, isy, ny);
  auto at = [G](float v, int src) { return __shfl_sync(kAll, v, src, G); };
  // point r*G + gl of an axis: psf, dmu, d2mu, dsig, d2sig
  auto point = [&](int r, float mu, float sg, float is, float nm,
                   float* pt) {
    const int k = r * G + gl;
    float a0, e0, q0;
    mle_edge(s, min(k, s), mu, is, a0, e0, q0);
    float a1 = __shfl_down_sync(kAll, a0, 1, G);
    float e1 = __shfl_down_sync(kAll, e0, 1, G);
    float q1 = __shfl_down_sync(kAll, q0, 1, G);
    if (gl == G - 1 && k < s) mle_edge(s, k + 1, mu, is, a1, e1, q1);
    mle_point<SIG>(min(k, s - 1), mu, sg, is, nm, a0, a1, e0, e1, q0, q1,
                   pt[0], pt[1], pt[2], pt[3], pt[4]);
  };
  const int rounds = (s + G - 1) / G;
  float a[kDots];
  for (int rr = 0; rr < rounds; ++rr) {
    float py[5], c[11];
    point(rr, th[1], sy, isy, ny, py);
    const int j = min(rr * G + gl, s - 1);  // this lane's row
    const float pg = th[2] * py[0];
    for (int r = 0; r < rounds; ++r) {
      float pt[5];
      point(r, th[0], sx, isx, nx, pt);
      const int m = min(G, s - r * G);
#pragma unroll 4
      for (int ii = 0; ii < m; ++ii) {
        float f[kCols];
        mle_column(at(pt[0], ii), at(pt[1], ii), at(pt[2], ii),
                   at(pt[3], ii), at(pt[4], ii), f);
        mle_pixel<SIG>(r == 0 && ii == 0, px(j, r * G + ii), pg, th[3], f,
                       c);
      }
    }
    const int m = min(G, s - rr * G);
    for (int jj = 0; jj < m; ++jj) {
      float cj[11];
#pragma unroll
      for (int t = 0; t < 11; ++t) cj[t] = at(c[t], jj);
      mle_fold(rr == 0 && jj == 0, at(py[0], jj), at(py[1], jj),
               at(py[2], jj), at(py[3], jj), at(py[4], jj), cj, a);
    }
  }
  mle_update<SIG>(s, a, th, ms);
}

// The cooperative tail of a drained warp whose busy slots (the lanes of
// busy) carry th, old, ms, done, iters, n. The warp's 32 / G groups of G
// lanes are workers without state: group g takes the busy slots of rank
// g, g + 32/G, ... in turn, one Newton step of one running spot a trip
// (its theta and max_step shuffled in from the slot's owner, its pixels
// from the owner's stage column, stage_warp being the warp's first
// column with pixel stride ps, or from the batch); the owner takes the
// new theta back from its group and runs the convergence test on its own
// old, done and iters. A group with no running slot shadows the first
// running one, writing nothing. So with at most 32 / G busy slots each
// group runs one spot to its end (mle_queue.cuh's tail), and with more
// each spot advances every few trips. Returns with every slot finished,
// each busy lane holding its spot's theta and iteration count.
template <bool SIG, int PX>
__device__ __forceinline__ void any_coop_tail(const AnyQueueArgs& a,
                                              const float* stage_warp,
                                              long long ps, unsigned busy,
                                              float* th, float* old,
                                              float* ms, float& done,
                                              float& iters, long long n) {
  constexpr int R = SIG ? 5 : 6;
  const int G = a.group, ng = 32 / G;
  const int lane = threadIdx.x & 31;
  const int g = lane / G, gl = lane % G;
  const int nb = __popc(busy);
  const bool mine = (busy >> lane) & 1u;
  // this lane's spot is stepped by group rank % ng
  const int from = (__popc(busy & ((1u << lane) - 1u)) % ng) * G;
  // this group's slots: ranks g + j * ng, j < cnt; the next to try jc
  const int cnt = g < nb ? (nb - 1 - g) / ng + 1 : 0;
  int jc = 0;
  const float limit = (float)a.max_it;
  int taken = 0;
  __syncwarp();  // the owners' stage columns, written lane by lane
  while (true) {
    const bool running = mine && !(done > 0.5f) && iters < limit;
    const unsigned run = __ballot_sync(kAll, running);
    if (run == 0u) break;
    int pick = -1;
    for (int k = 0; k < cnt; ++k) {
      const int j = (jc + k) % cnt;
      const int l = (int)__fns(busy, 0, g + j * ng + 1);
      if ((run >> l) & 1u) {
        pick = l;
        jc = (j + 1) % cnt;
        break;
      }
    }
    const int src = pick >= 0 ? pick : __ffs(run) - 1;
    float nt[6], sm[6];
#pragma unroll
    for (int p = 0; p < R; ++p) {
      nt[p] = __shfl_sync(kAll, th[p], src);
      sm[p] = __shfl_sync(kAll, ms[p], src);
    }
    const long long sn = __shfl_sync(kAll, n, src);
    const AnySlot<PX> px{PX == kPxBatch ? a.spots + sn : stage_warp + src,
                         nullptr, PX == kPxBatch ? a.n : ps, 0, a.s};
    any_coop_newton_step<SIG>(px, a.s, G, gl, nt, sm);
    // the owner of a stepped spot takes its new theta from its group
    const int picked = __shfl_sync(kAll, pick, from);
#pragma unroll
    for (int p = 0; p < R; ++p) nt[p] = __shfl_sync(kAll, nt[p], from);
    if (running && picked == lane) {
#pragma unroll
      for (int p = 0; p < R; ++p) th[p] = nt[p];
      mle_converge<SIG>(th, old, done, iters, a.eps);
      ++taken;
    }
  }
  if (a.coop_steps != nullptr && taken > 0) atomicAdd(a.coop_steps, taken);
}

// The CRLB/LL handoff (mle_queue.cuh's handoff_epilogue at a run-time
// box): a warp whose fits are done takes 32 consecutive spots at a time
// from the second counter, waits for each one's ready flag and runs its
// CRLB and log-likelihood from its theta and its ROI in the batch, one
// a lane, with the lane's column factors at w.
template <bool SIG>
__device__ __forceinline__ void any_handoff_epilogue(const AnyQueueArgs& a,
                                                     float* w,
                                                     long long ws) {
  const unsigned lane = threadIdx.x & 31u;
  int* next2 = a.next + 1;
  const int* ready = a.next + 2;
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next2, 32);
    base = __shfl_sync(kAll, base, 0);
    if ((long long)base >= a.n) break;
    const long long m = (long long)base + lane;
    if (m < a.n) {
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
      for (int p = 0; p < 6; ++p) th[p] = __ldcg(a.theta_o + p * a.n + m);
      any_crlb_ll<SIG>(AnySlot<kPxBatch>{a.spots + m, w, a.n, ws, a.s}, th,
                       crlb, ll);
#pragma unroll
      for (int p = 0; p < 6; ++p) a.crlb_o[p * a.n + m] = crlb[p];
      a.ll_o[m] = ll;
    }
  }
}

template <bool SIG, int PX, bool COLS>
__global__ void __launch_bounds__(kAnyThreads, 1)
    mle_any_queue_kernel(const AnyQueueArgs a) {
  extern __shared__ float smem[];
  constexpr int R = SIG ? 5 : 6;
  constexpr int T = kAnyThreads;
  const int s = a.s;
  const long long N = a.n;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  const long long slot = (long long)blockIdx.x * T + threadIdx.x;
  // this slot's stage column (pixel stride ps) and column factors
  float* stage = PX == kPxShared ? smem + threadIdx.x : nullptr;
  const long long ps = T + 1;
  float* w;
  long long ws;
  if constexpr (COLS) {
    w = smem + (PX == kPxShared ? s * s * (T + 1) : 0) + threadIdx.x;
    ws = T;
  } else {
    w = a.work + slot;
    ws = a.work_slots;
  }
  auto source = [&](long long m) {
    return AnySlot<PX>{PX == kPxBatch ? a.spots + m : stage, w,
                       PX == kPxBatch ? N : ps, ws, s};
  };
  int* ready = a.next + 2;
  const float limit = (float)a.max_it;
  float th[6], old[6], ms[6], done = 0.0f, iters = 0.0f;
  long long n = -1;      // this slot's spot; -1 while the slot is free
  long long pub = -1;    // its spot finished last trip, flag unset
  bool drained = false;  // the counter has passed N (uniform in the warp)
  while (true) {
    const unsigned free_mask = __ballot_sync(kAll, n < 0);
    const int n_free = __popc(free_mask);
    const bool refill = !drained && (n_free >= kAnyRefill || n_free == 32);
    if (__any_sync(kAll, pub >= 0)) {
      publish(ready, pub);
      pub = -1;
    }
    if (refill) {
      int base = 0;
      if (lane == 0) base = atomicAdd(a.next, n_free);
      base = __shfl_sync(kAll, base, 0);
      drained = (long long)base + n_free >= N;
      const long long i = (long long)base + __popc(free_mask & below);
      if (n < 0 && i < N) {
        n = i;
        // unrolled, so that several loads of the spot are in flight
        if constexpr (PX == kPxShared) {
#pragma unroll 8
          for (int p = 0; p < s * s; ++p)
            stage[p * ps] = __ldg(a.spots + (long long)p * N + n);
        }
        any_init_theta<SIG>(source(n), th, ms);
#pragma unroll
        for (int p = 0; p < R; ++p) old[p] = th[p];
        done = n >= a.n_valid ? 1.0f : 0.0f;
        iters = 0.0f;
      }
    }
    const unsigned busy = __ballot_sync(kAll, n >= 0);
    if (busy == 0u && drained) break;
    if (drained && __popc(busy) <= kAnyTail * (32 / a.group)) {
      any_coop_tail<SIG, PX>(a, PX == kPxBatch ? nullptr : stage - lane, ps,
                             busy, th, old, ms, done, iters, n);
      if (n >= 0) store_fit<SIG>(n, N, th, iters, a.theta_o, a.iters_o);
      publish(ready, n);
      break;
    }
    if (n >= 0) {
      if (iters < limit && !(done > 0.5f)) {
        any_newton_step<SIG>(source(n), th, ms);
        mle_converge<SIG>(th, old, done, iters, a.eps);
      }
      if (done > 0.5f || !(iters < limit)) {
        store_fit<SIG>(n, N, th, iters, a.theta_o, a.iters_o);
        pub = n;
        n = -1;
      }
    }
  }
  any_handoff_epilogue<SIG>(a, w, ws);
}

// The shared bytes a block takes at box s.
inline long long any_queue_smem(int s, int px, bool cols) {
  return 4LL * ((px == kPxShared ? (long long)s * s * (kAnyThreads + 1) : 0) +
                (cols ? (long long)kAnyCols * s * kAnyThreads : 0));
}

template <bool SIG, int PX, bool COLS>
int any_queue_launch(const AnyQueueArgs& a, int* info, cudaStream_t stream) {
  const auto kernel = mle_any_queue_kernel<SIG, PX, COLS>;
  const long long bytes = any_queue_smem(a.s, PX, COLS);
  int dev = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > limit) return (int)cudaErrorInvalidValue;
  const int smem = (int)bytes;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kAnyThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    const int v[kAnyQueueInfo] = {kAnyThreads,  per_sm,
                                  attr.numRegs, (int)attr.localSizeBytes,
                                  smem,         sms};
    for (int i = 0; i < kAnyQueueInfo; ++i) info[i] = v[i];
    return 0;
  }
  long long blocks = (a.n + kAnyThreads - 1) / kAnyThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  if (!COLS && blocks > a.work_slots / kAnyThreads)
    blocks = a.work_slots / kAnyThreads;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kAnyThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int any_queue_dispatch(const AnyQueueArgs& a, int method, int px, bool cols,
                       int* info, cudaStream_t stream) {
#define PICASSO_ANYQ(SIG, PX)                                 \
  return cols ? any_queue_launch<SIG, PX, true>(a, info, stream) \
              : any_queue_launch<SIG, PX, false>(a, info, stream)
  if (method == 1) {
    if (px == kPxShared) PICASSO_ANYQ(true, kPxShared);
    PICASSO_ANYQ(true, kPxBatch);
  }
  if (px == kPxShared) PICASSO_ANYQ(false, kPxShared);
  PICASSO_ANYQ(false, kPxBatch);
#undef PICASSO_ANYQ
}

bool any_queue_valid(int box, int method, int group, int stage) {
  return box >= 1 && method >= 0 && method <= 1 && stage >= kPxBatch &&
         stage <= kPxShared && (group == 8 || group == 16 || group == 32) &&
         (group >= box + 1 || group == 32);
}

}  // namespace

// Fit n spots, lanes-last (box, box, n) f32, box >= 1, through the work
// queue with the CRLB/LL in it. Launch configuration: group (the lanes
// of a cooperative group: 8, 16 or 32, >= box + 1 unless 32), stage
// (where the slots read the pixels: 0 the batch, 1 a stage in shared
// memory), cols (the column factors in shared memory, else in work, (5,
// box, work_slots) f32, work_slots >= the block's threads; null if
// unused). next: n + 2 int32 on the card, zero before the launch. Spots
// at index >= n_valid start converged. Outputs theta, crlb (6, n) f32, ll
// (n,) f32, iters (n,) int32, as mle_anybox.cu writes them. method 0
// sigmaxy, 1 sigma. coop_steps: one int32 on the card, or null. Returns
// cudaErrorInvalidValue for a configuration it does not take (its shared
// bytes above what a block may opt in to on the card too), else
// cudaGetLastError() after the launch.
extern "C" int picasso_mle_anybox_queue(
    const void* spots, long long n, int box, float eps, int max_it,
    long long n_valid, int method, int group, int stage, int cols,
    void* next, void* work, long long work_slots, void* theta_out,
    void* crlb_out, void* ll_out, void* iters_out, void* coop_steps,
    void* stream) {
  if (n <= 0 || n > (1LL << 30) || max_it < 0 ||
      !any_queue_valid(box, method, group, stage) ||
      (!cols && (work == nullptr || work_slots < kAnyThreads)))
    return (int)cudaErrorInvalidValue;
  AnyQueueArgs a{};
  a.spots = static_cast<const float*>(spots);
  a.n = n;
  a.n_valid = n_valid;
  a.s = box;
  a.eps = eps;
  a.max_it = max_it;
  a.group = group;
  a.next = static_cast<int*>(next);
  a.work = static_cast<float*>(work);
  a.work_slots = work_slots;
  a.theta_o = static_cast<float*>(theta_out);
  a.crlb_o = static_cast<float*>(crlb_out);
  a.ll_o = static_cast<float*>(ll_out);
  a.iters_o = static_cast<int*>(iters_out);
  a.coop_steps = static_cast<int*>(coop_steps);
  return any_queue_dispatch(a, method, stage, cols != 0, nullptr,
                            static_cast<cudaStream_t>(stream));
}

// Describe the instance for (box, method, stage, cols) on the current
// device: info[0..5] = threads a block, resident blocks per SM, registers
// a thread, local (spill) bytes a thread, shared bytes a block, SMs.
// Launches nothing.
extern "C" int picasso_mle_anybox_queue_info(int box, int method, int stage,
                                             int cols, void* info) {
  if (info == nullptr || !any_queue_valid(box, method, 32, stage))
    return (int)cudaErrorInvalidValue;
  AnyQueueArgs a{};
  a.s = box;
  return any_queue_dispatch(a, method, stage, cols != 0,
                            static_cast<int*>(info), nullptr);
}
