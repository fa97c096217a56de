// The fused cut + photon conversion + LM fit kernel K5 (sm_90a).
//
// Replaces the Pallas TPU kernel picasso_tpu/ops/winfit_pallas.py
// _lq_kernel (fit_lq_t): the window extraction of the wincols row gather
// and its barrel, the photon conversion (raw - baseline) * factor, then
// the K3 fit body. As the MLE twin (winfit_mle.cuh): each thread reads
// its hit (f, y, x), clamps the centre as gather_wincols does, loads its
// box x box window from the (B, Y, X) chunk once, stages the photons in
// shared memory as [pixel][thread] (fit_common.cuh stage_window), and
// runs the K3 body (fit_lq.cuh) on them. Mode FULL only: the phase
// schedule of the LM fit (K6) lost to its single pass on the H100, the
// permutes costing more than the thin iteration tail saves.
//
// What bounds it on the card: as K3, issued FP32 instructions; the
// window is read from device memory once, 2 * box * box shared-memory
// reads per iteration after that.

#include "fit_lq.cuh"

namespace {

template <int S, int T, typename Tin>
__global__ void __launch_bounds__(T) winfit_lq_kernel(
    const Tin* __restrict__ frames, long long B, long long Y, long long X,
    const int* __restrict__ hits, long long N, float baseline, float factor,
    float ftol, int k, float* theta) {
  __shared__ float stage[S * S * T];
  const long long n = (long long)blockIdx.x * T + threadIdx.x;
  if (n >= N) return;
  float* mine = stage + threadIdx.x;
  stage_window<S, T>(frames, B, Y, X, hits, N, n, baseline, factor, mine);
  lq_fit_spot<S>(Staged<S, T>{mine}, n, N, ftol, k, kFull, N, theta,
                 nullptr, nullptr, nullptr);
}

template <int S, typename Tin>
void launch(const Tin* frames, long long B, long long Y, long long X,
            const int* hits, long long n, float baseline, float factor,
            float ftol, int k, float* theta, cudaStream_t stream) {
  constexpr int T = stage_threads<S>();
  const unsigned int blocks = (unsigned int)((n + T - 1) / T);
  winfit_lq_kernel<S, T, Tin><<<blocks, T, 0, stream>>>(
      frames, B, Y, X, hits, n, baseline, factor, ftol, k, theta);
}

template <typename Tin>
int dispatch(const Tin* frames, long long B, long long Y, long long X,
             const int* hits, long long n, int box, float baseline,
             float factor, float ftol, int k, float* theta,
             cudaStream_t stream) {
  switch (box) {
#define PICASSO_WINFIT_LQ_CASE(S)                                       \
  case S:                                                               \
    launch<S>(frames, B, Y, X, hits, n, baseline, factor, ftol, k,      \
              theta, stream);                                           \
    break;
    PICASSO_WINFIT_LQ_CASE(5)
    PICASSO_WINFIT_LQ_CASE(7)
    PICASSO_WINFIT_LQ_CASE(9)
    PICASSO_WINFIT_LQ_CASE(11)
    PICASSO_WINFIT_LQ_CASE(13)
    PICASSO_WINFIT_LQ_CASE(15)
#undef PICASSO_WINFIT_LQ_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// LM-fit n hits of a (B, Y, X) chunk (dtype 0 uint16, 1 float32) in one
// pass. hits is (3, n) int32, rows f, y, x; baseline and factor convert
// raw counts to photons. theta (6, n) f32 out, x/y relative to the box
// centre. Returns cudaGetLastError() after the launch.
extern "C" int picasso_winfit_lq(const void* frames, int dtype, long long B,
                                 long long Y, long long X, const void* hits,
                                 long long n, int box, float baseline,
                                 float factor, float ftol, int k,
                                 void* theta, void* stream) {
  if (n <= 0 || n > (long long)0x7fffffff * 32 || B <= 0 || Y < box ||
      X < box)
    return (int)cudaErrorInvalidValue;
  const int* h = static_cast<const int*>(hits);
  float* th = static_cast<float*>(theta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch(static_cast<const uint16_t*>(frames), B, Y, X, h, n, box,
                    baseline, factor, ftol, k, th, st);
  if (dtype == 1)
    return dispatch(static_cast<const float*>(frames), B, Y, X, h, n, box,
                    baseline, factor, ftol, k, th, st);
  return (int)cudaErrorInvalidValue;
}
