// MLE fit of the integrated 2D Gaussian on a lanes-last spot batch, one
// thread per spot (sm_90a).
//
// Replaces the Pallas TPU kernels of picasso_tpu/ops/mle_pallas.py:
//   K2  _start_phase_kernel, _resume_phase_kernel, _finish_phase_kernel
//       (fit_pallas_boundary_t), as the START/RESUME/FINISH modes
// and its FULL mode, the one-thread pass of K1 (_tile_kernel,
// fit_pallas_t), is the fixed point that the work queues equal bit for
// bit (ops/mle_cuda.fit_one_pass_t, on no path): K1 and K7 run as
// roi_mle_fit.cu's queue. The fit itself is fit_mle.cuh (shared with
// the fused cut+fit kernel K5, winfit_mle.cu, and the work queues of
// mle_queue.cuh); this file reads the spots from the (S, S, N) f32 batch,
// where neighbouring spots sit on neighbouring addresses, so each Newton
// step's box*box reads coalesce. The phase schedule (host side) stops
// threads of converged spots from sitting idle in warps that still
// iterate.
//
// The odd boxes 3-15 are instantiated; every other box >= 3 takes the
// any-box kernel (mle_anybox.cu). At box 3 the sigmaxy fit has six
// parameters for nine pixels and mostly runs to max_it, so its f32 paths
// drift apart from any other summation order's (JAX's, the plain
// version's); the work queues still equal this pass bit for bit there.

#include "fit_mle.cuh"

namespace {

template <int S, bool SIG>
__global__ void __launch_bounds__(128)
    mle_fit_kernel(const float* __restrict__ spots, long long N, float eps,
                   int k, int mode, long long n_valid, float* theta_c,
                   float* old_c, float* done_c, float* iters_c, float* ms_c,
                   float* theta_out, float* crlb_out, float* ll_out,
                   int* iters_out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  mle_fit_spot<S, SIG>(LanesLast<S>{spots + n, N}, n, N, eps, k, mode,
                       n_valid, theta_c, old_c, done_c, iters_c, ms_c,
                       theta_out, crlb_out, ll_out, iters_out);
}

template <int S, bool SIG>
void launch(const float* spots, long long n, float eps, int k, int mode,
            long long n_valid, float* theta_c, float* old_c, float* done_c,
            float* iters_c, float* ms_c, float* theta_out, float* crlb_out,
            float* ll_out, int* iters_out, cudaStream_t stream) {
  const int threads = 128;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  mle_fit_kernel<S, SIG><<<blocks, threads, 0, stream>>>(
      spots, n, eps, k, mode, n_valid, theta_c, old_c, done_c, iters_c, ms_c,
      theta_out, crlb_out, ll_out, iters_out);
}

}  // namespace

// Fit n spots, lanes-last (box, box, n) f32. method 0 sigmaxy (R = 6),
// 1 sigma (R = 5). mode 0 FULL: init, k iterations, outputs. 1 START:
// init, k iterations, carry out. 2 RESUME: carry in, k iterations, carry
// out (in place). 3 FINISH: carry in, k iterations, outputs. Carry:
// theta/old/max_step (R, n), done/iters (n,) f32. Outputs: theta/crlb
// (6, n) f32, ll (n,) f32, iters (n,) i32. Returns cudaGetLastError()
// after the launch.
extern "C" int picasso_mle_fit(const void* spots, long long n, int box,
                               float eps, int k, int mode, long long n_valid,
                               int method, void* theta_c, void* old_c,
                               void* done_c, void* iters_c, void* ms_c,
                               void* theta_out, void* crlb_out, void* ll_out,
                               void* iters_out, void* stream) {
  if (n <= 0 || n > (long long)0x7fffffff * 128 || mode < kFull ||
      mode > kFinish || method < 0 || method > 1)
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(spots);
  float* tc = static_cast<float*>(theta_c);
  float* oc = static_cast<float*>(old_c);
  float* dc = static_cast<float*>(done_c);
  float* ic = static_cast<float*>(iters_c);
  float* mc = static_cast<float*>(ms_c);
  float* to = static_cast<float*>(theta_out);
  float* co = static_cast<float*>(crlb_out);
  float* lo = static_cast<float*>(ll_out);
  int* io = static_cast<int*>(iters_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (box) {
#define PICASSO_FIT_CASE(S)                                                  \
  case S:                                                                    \
    if (method == 1)                                                         \
      launch<S, true>(s, n, eps, k, mode, n_valid, tc, oc, dc, ic, mc, to,   \
                      co, lo, io, st);                                       \
    else                                                                     \
      launch<S, false>(s, n, eps, k, mode, n_valid, tc, oc, dc, ic, mc, to,  \
                       co, lo, io, st);                                      \
    break;
    PICASSO_FIT_CASE(3)
    PICASSO_FIT_CASE(5)
    PICASSO_FIT_CASE(7)
    PICASSO_FIT_CASE(9)
    PICASSO_FIT_CASE(11)
    PICASSO_FIT_CASE(13)
    PICASSO_FIT_CASE(15)
#undef PICASSO_FIT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
