// Levenberg-Marquardt fit of the plain elliptic 2D Gaussian on a
// lanes-last spot batch, one thread per spot (sm_90a).
//
// Replaces the Pallas TPU kernels of picasso_tpu/ops/lq_pallas.py:
//   K3  _tile_kernel                        (fit_pallas_t)
//   K6  _lm_start_kernel, _lm_resume_kernel (fit_pallas_boundary_t)
// The fit itself is fit_lq.cuh (shared with the work queues of K5 and of
// K3, lq_queue.cuh); this file reads the spots from the (S, S, N) f32
// batch, where neighbouring spots sit on neighbouring addresses, so
// each iteration's box*box reads coalesce. The phase schedule (host
// side) stops threads of converged spots from sitting idle in warps that
// still iterate.
//
// Boxes 5-15 are instantiated, as for the MLE fit.

#include "fit_lq.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(128)
    lq_fit_kernel(const float* __restrict__ spots, long long N, float ftol,
                  int k, int mode, long long n_valid, float* theta,
                  float* lam_c, float* cost_c, float* done_c) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  lq_fit_spot<S>(LanesLast<S>{spots + n, N}, n, N, ftol, k, mode, n_valid,
                 theta, lam_c, cost_c, done_c);
}

}  // namespace

// LM-fit n spots, lanes-last (box, box, n) f32. mode 0 FULL: init, k
// iterations, theta (6, n) out. 1 START: init, k iterations, carry out.
// 2 RESUME: carry in, k iterations, carry out (in place). Carry: theta
// (6, n), lam/cost/done (n,) f32 (unused by FULL). Returns
// cudaGetLastError() after the launch.
extern "C" int picasso_lq_fit(const void* spots, long long n, int box,
                              float ftol, int k, int mode, long long n_valid,
                              void* theta, void* lam, void* cost, void* done,
                              void* stream) {
  if (n <= 0 || n > (long long)0x7fffffff * 128 || mode < kFull ||
      mode > kResume || (mode != kFull && (!lam || !cost || !done)))
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(spots);
  float* th = static_cast<float*>(theta);
  float* la = static_cast<float*>(lam);
  float* co = static_cast<float*>(cost);
  float* dn = static_cast<float*>(done);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  switch (box) {
#define PICASSO_LQ_CASE(S)                                                  \
  case S:                                                                   \
    lq_fit_kernel<S><<<blocks, threads, 0, st>>>(s, n, ftol, k, mode,       \
                                                 n_valid, th, la, co, dn); \
    break;
    PICASSO_LQ_CASE(5)
    PICASSO_LQ_CASE(7)
    PICASSO_LQ_CASE(9)
    PICASSO_LQ_CASE(11)
    PICASSO_LQ_CASE(13)
    PICASSO_LQ_CASE(15)
#undef PICASSO_LQ_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
