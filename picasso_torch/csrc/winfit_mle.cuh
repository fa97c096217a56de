// The fused cut + photon conversion + MLE fit kernel K5 (sm_90a), for
// one frame dtype at a time: winfit_mle.cu instantiates it for uint16
// chunks, winfit_mle_f32.cu for float32 chunks, so the two halves build
// in parallel (one nvcc per source).
//
// Replaces the Pallas TPU kernel picasso_tpu/ops/winfit_pallas.py
// _mle_kernel (fit_mle_t). That kernel takes one gathered row of
// box * X raw pixels per spot (ops/fused.gather_wincols), extracts the
// spot's columns with a barrel of selects, converts them to photons
// (raw - baseline) * factor and runs the K1 fit body. The card needs
// neither the row gather nor the barrel: each thread reads its hit
// (f, y, x), clamps the centre as gather_wincols does, loads its
// box x box window straight from the (B, Y, X) chunk ONCE, converts it,
// and stages the photons in shared memory as [pixel][thread]
// (fit_common.cuh stage_window). The fit body of K1/K2 (fit_mle.cuh)
// then reads them from there at every Newton step. So the chain never
// writes the (S, S, N) f32 ROI batch the gather route builds (196 bytes
// a spot at box 7) and reads 98 bytes of u16 window a spot instead.
//
// The four modes are K1/K2's: FULL, and START/RESUME/FINISH so that the
// stragglers-first phase schedule runs on K5 too (ops/winfit_cuda.py);
// between phases the host permutes the carry and the (3, N) hit list,
// and each phase stages its window anew.
//
// What bounds it on the card: as K1/K2, issued FP32 instructions. The
// window load is a scattered read (box rows of box pixels a spot); it
// happens once a launch, against box*box shared-memory reads at every
// Newton step. Threads a block shrink with the box (stage_threads) so
// the stage fits the 48 KB of static shared memory.

#pragma once

#include "fit_mle.cuh"

// Arguments of one K5 MLE launch (see picasso_winfit_mle in
// winfit_mle.cu). A named type, shared by the two sources.
struct WinfitMleArgs {
  long long B, Y, X;
  const int* hits;
  long long n;
  float baseline, factor, eps;
  int k, mode;
  float *theta_c, *old_c, *done_c, *iters_c, *ms_c;
  float *theta_out, *crlb_out, *ll_out;
  int* iters_out;
  cudaStream_t stream;
};

namespace {

template <int S, bool SIG, int T, typename Tin>
__global__ void __launch_bounds__(T) winfit_mle_kernel(
    const Tin* __restrict__ frames, long long B, long long Y, long long X,
    const int* __restrict__ hits, long long N, float baseline, float factor,
    float eps, int k, int mode, float* theta_c,
    float* old_c, float* done_c, float* iters_c, float* ms_c,
    float* theta_out, float* crlb_out, float* ll_out, int* iters_out) {
  __shared__ float stage[S * S * T];
  const long long n = (long long)blockIdx.x * T + threadIdx.x;
  if (n >= N) return;
  float* mine = stage + threadIdx.x;
  stage_window<S, T>(frames, B, Y, X, hits, N, n, baseline, factor, mine);
  mle_fit_spot<S, SIG>(Staged<S, T>{mine}, n, N, eps, k, mode, N,
                       theta_c, old_c, done_c, iters_c, ms_c, theta_out,
                       crlb_out, ll_out, iters_out);
}

template <int S, bool SIG, typename Tin>
void winfit_mle_launch(const Tin* frames, const WinfitMleArgs& a) {
  constexpr int T = stage_threads<S>();
  const unsigned int blocks = (unsigned int)((a.n + T - 1) / T);
  winfit_mle_kernel<S, SIG, T, Tin><<<blocks, T, 0, a.stream>>>(
      frames, a.B, a.Y, a.X, a.hits, a.n, a.baseline, a.factor, a.eps, a.k,
      a.mode, a.theta_c, a.old_c, a.done_c, a.iters_c, a.ms_c,
      a.theta_out, a.crlb_out, a.ll_out, a.iters_out);
}

// Dispatch on box and method; returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a box without an instance.
template <typename Tin>
int winfit_mle_dispatch(const Tin* frames, int box, int method,
                        const WinfitMleArgs& a) {
  switch (box) {
#define PICASSO_WINFIT_CASE(S)                          \
  case S:                                               \
    if (method == 1)                                    \
      winfit_mle_launch<S, true>(frames, a);            \
    else                                                \
      winfit_mle_launch<S, false>(frames, a);           \
    break;
    PICASSO_WINFIT_CASE(3)
    PICASSO_WINFIT_CASE(5)
    PICASSO_WINFIT_CASE(7)
    PICASSO_WINFIT_CASE(9)
    PICASSO_WINFIT_CASE(11)
    PICASSO_WINFIT_CASE(13)
    PICASSO_WINFIT_CASE(15)
#undef PICASSO_WINFIT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The float32 half, defined in winfit_mle_f32.cu.
int picasso_winfit_mle_f32(const float* frames, int box, int method,
                           const WinfitMleArgs& a);
