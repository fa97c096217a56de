// Levenberg-Marquardt fit of the plain elliptic 2D Gaussian on a
// lanes-last spot batch, one thread per spot (sm_90a): the one pass of
// K3 (picasso_tpu/ops/lq_pallas.py _tile_kernel, fit_pallas_t), kept off
// every path as the fixed point that the work queues (roi_lq_queue.cu:
// K3 on fit2D, and K6, lq_pallas.py _lm_start/_lm_resume_kernel, in one
// launch; winfit_lq_queue.cu: K5) equal bit for bit.
// The fit itself is fit_lq.cuh (shared with the queues, lq_queue.cuh);
// this file reads the spots from the (S, S, N) f32 batch, where
// neighbouring spots sit on neighbouring addresses, so each iteration's
// box*box reads coalesce.
//
// The odd boxes 3-15 are instantiated, as for the MLE fit (other boxes:
// lq_anybox.cu).

#include "fit_lq.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(128)
    lq_fit_kernel(const float* __restrict__ spots, long long N, float ftol,
                  int k, long long n_valid, float* theta) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  lq_fit_spot<S>(LanesLast<S>{spots + n, N}, n, N, ftol, k, n_valid, theta);
}

}  // namespace

// LM-fit n spots, lanes-last (box, box, n) f32: init, up to k
// iterations, theta (6, n) f32 out; spots at index >= n_valid start done.
// Returns cudaGetLastError() after the launch.
extern "C" int picasso_lq_fit(const void* spots, long long n, int box,
                              float ftol, int k, long long n_valid,
                              void* theta, void* stream) {
  if (n <= 0 || n > (long long)0x7fffffff * 128)
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(spots);
  float* th = static_cast<float*>(theta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  switch (box) {
#define PICASSO_LQ_CASE(S)                                                  \
  case S:                                                                   \
    lq_fit_kernel<S><<<blocks, threads, 0, st>>>(s, n, ftol, k, n_valid,   \
                                                 th);                      \
    break;
    PICASSO_LQ_CASE(3)
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
