// What the fit kernels share (sm_90a): the kernel modes, NaN-propagating
// max / min / sign, and the two pixel sources a fit body reads through.
//
// A fit body (fit_mle.cuh, fit_lq.cuh) reads its spot's box x box photons
// only as src(y, x). Two sources exist:
//   LanesLast  the (S, S, N) f32 batch of mle_fit.cu / lq_fit.cu (K1/K2,
//              K3/K6): neighbouring spots on neighbouring addresses, so
//              a warp's read of one pixel coalesces;
//   Staged     a spot staged once in shared memory as [pixel][thread]
//              (a warp's read of one pixel touches 32 consecutive
//              banks): by the fused cut+fit kernels (K5, winfit_mle*.cu,
//              winfit_*_queue.cu) from the frame chunk, converted to
//              photons, and by the ROI work queues (roi_*_queue.cu) from
//              the (S, S, N) batch.
// The body is the same template for both, so a source changes where a
// pixel comes from and nothing of the arithmetic. The any-box bodies
// (fit_mle_any.cuh, fit_lq_any.cuh) read through AnyBox, the lanes-last
// batch at a run-time box.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kFull = 0, kStart = 1, kResume = 2, kFinish = 3 };

// NaN-propagating max / min / sign, as jnp.maximum / jnp.minimum /
// jnp.sign (fmaxf would drop a NaN operand).
__device__ __forceinline__ float nmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}
__device__ __forceinline__ float nsign(float a) {
  return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : a);
}

template <int S>
struct LanesLast {
  const float* p;  // spots + n
  long long N;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return __ldg(p + (long long)(y * S + x) * N);
  }
};

// The any-box bodies (fit_any.cuh): a spot of the lanes-last (s, s, N)
// batch at a box s known only at run time, read from global memory at
// each use, and the spot's column of a lanes-last (rows, s, N) f32
// workspace (the per-axis factors that the templated bodies keep in
// S-sized register arrays).
struct AnyBox {
  const float* p;  // spots + n
  float* w;        // work + n
  long long N;
  int s;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return __ldg(p + (long long)(y * s + x) * N);
  }
  __device__ __forceinline__ float& at(int row, int i) const {
    return w[(long long)(row * s + i) * N];
  }
};

template <int S, int T>
struct Staged {
  const float* p;  // stage + threadIdx.x
  __device__ __forceinline__ float operator()(int y, int x) const {
    return p[(y * S + x) * T];
  }
};

// Threads a block of a staging kernel: the stage (S*S*T*4 bytes) stays
// within the 48 KB of static shared memory (41,472 B at box 9, 43,264 at
// 13, 28,800 at 15).
template <int S>
constexpr int stage_threads() {
  return S <= 9 ? 128 : (S <= 13 ? 64 : 32);
}

// Load spot n's box x box window from a (B, Y, X) chunk once and stage its
// photons (raw - baseline) * factor at dst[(y*S + x) * T]. The hit list
// is (3, N) int32 rows f, y, x; the centre is clamped as the JAX
// package's gather_wincols clamps it (f to [0, B-1], y to [r, Y-r-1], x
// to [r, X-r-1]), so the window never leaves the chunk. The conversion
// is two correctly rounded f32 operations, as the gather route's
// elementwise subtract and multiply: no contraction to an FMA.
template <int S, int T, typename Tin>
__device__ __forceinline__ void stage_window(
    const Tin* __restrict__ frames, long long B, long long Y, long long X,
    const int* __restrict__ hits, long long N, long long n, float baseline,
    float factor, float* dst) {
  constexpr int r = S / 2;
  const long long f = min(max((long long)hits[n], 0LL), B - 1);
  const long long y = min(max((long long)hits[N + n], (long long)r), Y - r - 1);
  const long long x =
      min(max((long long)hits[2 * N + n], (long long)r), X - r - 1);
  const Tin* src = frames + (f * Y + (y - r)) * X + (x - r);
#pragma unroll
  for (int yy = 0; yy < S; ++yy)
#pragma unroll
    for (int xx = 0; xx < S; ++xx)
      dst[(yy * S + xx) * T] = __fmul_rn(
          __fsub_rn(static_cast<float>(src[yy * X + xx]), baseline), factor);
}

// Where a slot of a work queue (mle_queue.cuh, lq_queue.cuh) takes its
// spot from, as a source policy: stage<S, T>(n, dst) writes spot n's
// box x box photons at dst[(y*S + x) * T] (its column of the block's
// stage), and starts_done(n) says whether the spot starts converged.
// The queue body is the same template for both sources.

// K5: the window of a (B, Y, X) chunk around hit n (stage_window).
template <typename Tin>
struct ChunkWindows {
  const Tin* frames;
  long long B, Y, X;
  const int* hits;  // (3, N) rows f, y, x
  long long N;
  float baseline, factor;
  static constexpr bool kMayStartDone = false;
  template <int S, int T>
  __device__ __forceinline__ void stage(long long n, float* dst) const {
    stage_window<S, T>(frames, B, Y, X, hits, N, n, baseline, factor, dst);
  }
  __device__ __forceinline__ bool starts_done(long long) const {
    return false;
  }
};

// The ROI work queues (K1 and K7, roi_mle_fit.cu; K3, roi_lq_queue.cu):
// spot n of the lanes-last (S, S, N) f32 photon
// batch, copied as it is. A refill claims consecutive spot indices, so
// the claiming lanes of a warp read each pixel from neighbouring
// addresses. Spots at or above n_valid start converged, as in K1/K3.
struct RoiBatch {
  const float* spots;
  long long N, n_valid;
  static constexpr bool kMayStartDone = true;
  template <int S, int T>
  __device__ __forceinline__ void stage(long long n, float* dst) const {
#pragma unroll
    for (int p = 0; p < S * S; ++p)
      dst[p * T] = __ldg(spots + (long long)p * N + n);
  }
  __device__ __forceinline__ bool starts_done(long long n) const {
    return n >= n_valid;
  }
};

}  // namespace
