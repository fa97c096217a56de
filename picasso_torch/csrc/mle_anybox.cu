// The MLE fit (sigmaxy and sigma) with its CRLB and log-likelihood at
// any box, the box a launch argument, one thread a spot (sm_90a): the
// any-box one-thread pass, on a lanes-last (S, S, N) f32 batch. The body
// is fit_mle_any.cuh, which forms fit_mle.cuh's numbers in its order
// without S-sized register arrays.
//
// It was the first port, at the boxes that mle_fit.cu and roi_mle_fit.cu
// are not built for, of the Pallas TPU kernels of
// picasso_tpu/ops/mle_pallas.py (K1 _tile_kernel, K2's phase kernels, K7's
// round kernels) and of K5's MLE half; mle_anybox_queue.cu replaces it
// on every path. It stays off every path, as mle_fit.cu's FULL mode does
// at the templated boxes: the fixed point the any-box work queue equals
// bit for bit (ops/mle_cuda.fit_anybox_one_pass_t).

#include "fit_mle_any.cuh"

namespace {

template <bool SIG>
__global__ void __launch_bounds__(128)
    mle_any_kernel(const float* __restrict__ spots, long long N, int s,
                   float eps, int max_it, long long n_valid, float* work,
                   float* theta, float* crlb, float* ll, int* iters) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  any_mle_fit_spot<SIG>(AnyBox{spots + n, work + n, N, s}, n, eps, max_it,
                        n_valid, theta, crlb, ll, iters);
}

}  // namespace

// Fit n spots, lanes-last (box, box, n) f32, box >= 1, one thread a spot:
// init, up to max_it Newton steps, CRLB and LL. method 0 sigmaxy, 1
// sigma. work is (5, box, n) f32 on the card, scratch. Outputs as
// picasso_mle_fit's FULL mode: theta, crlb (6, n) f32, ll (n,) f32,
// iters (n,) int32; spots at index >= n_valid start converged. Returns
// cudaGetLastError() after the launch.
extern "C" int picasso_mle_anybox(const void* spots, long long n, int box,
                                  float eps, int max_it, long long n_valid,
                                  int method, void* work, void* theta,
                                  void* crlb, void* ll, void* iters,
                                  void* stream) {
  if (n <= 0 || n > (long long)0x7fffffff * 128 || box < 1 || max_it < 0 ||
      method < 0 || method > 1 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  const auto kernel = method == 1 ? mle_any_kernel<true>
                                  : mle_any_kernel<false>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spots), n, box, eps, max_it, n_valid,
      static_cast<float*>(work), static_cast<float*>(theta),
      static_cast<float*>(crlb), static_cast<float*>(ll),
      static_cast<int*>(iters));
  return (int)cudaGetLastError();
}
