// The Levenberg-Marquardt fit of the plain elliptic 2D Gaussian at any
// box, the box a launch argument (sm_90a): one launch, one thread a
// spot, on a lanes-last (S, S, N) f32 batch. The body is fit_lq_any.cuh,
// which forms fit_lq.cuh's numbers in its order without S-sized register
// arrays.
//
// Replaces, at the boxes that lq_fit.cu and roi_lq_queue.cu are not
// built for, the Pallas TPU kernels of picasso_tpu/ops/lq_pallas.py:
//   K3  _tile_kernel (fit_pallas_t);
//   K6  _lm_start_kernel, _lm_resume_kernel (fit_pallas_boundary_t): one
//       launch, which the phases equal by construction;
// and, fed by cut_anybox.cu's ROIs, the LM half of K5
// (picasso_tpu/ops/winfit_pallas.py _lq_kernel).

#include "fit_lq_any.cuh"

namespace {

__global__ void __launch_bounds__(128)
    lq_any_kernel(const float* __restrict__ spots, long long N, int s,
                  float ftol, int max_it, long long n_valid, float* work,
                  float* theta) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  any_lq_fit_spot(AnyBox{spots + n, work + n, N, s}, n, ftol, max_it,
                  n_valid, theta);
}

}  // namespace

// LM-fit n spots, lanes-last (box, box, n) f32, box >= 1, one thread a
// spot: init, up to max_it iterations, theta (6, n) f32 out, x/y
// relative to the box centre; spots at index >= n_valid start done. work
// is (7, box, n) f32 on the card, scratch. Returns cudaGetLastError()
// after the launch.
extern "C" int picasso_lq_anybox(const void* spots, long long n, int box,
                                 float ftol, int max_it, long long n_valid,
                                 void* work, void* theta, void* stream) {
  if (n <= 0 || n > (long long)0x7fffffff * 128 || box < 1 || max_it < 0 ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  lq_any_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spots), n, box, ftol, max_it, n_valid,
      static_cast<float*>(work), static_cast<float*>(theta));
  return (int)cudaGetLastError();
}
