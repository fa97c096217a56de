// K5, the fused cut + photon conversion + MLE fit (winfit_mle.cuh): the
// uint16 instances and the C entry.

#include "winfit_mle.cuh"

// Fit n hits of a (B, Y, X) chunk (dtype 0 uint16, 1 float32). hits is
// (3, n) int32, rows f, y, x; baseline and factor convert raw counts to
// photons. box, method, mode, the carry and the outputs are those of
// picasso_mle_fit (mle_fit.cu). Returns cudaGetLastError() after the
// launch.
extern "C" int picasso_winfit_mle(
    const void* frames, int dtype, long long B, long long Y, long long X,
    const void* hits, long long n, int box, float baseline, float factor,
    float eps, int k, int mode, int method, void* theta_c,
    void* old_c, void* done_c, void* iters_c, void* ms_c, void* theta_out,
    void* crlb_out, void* ll_out, void* iters_out, void* stream) {
  if (n <= 0 || n > (long long)0x7fffffff * 32 || B <= 0 || Y < box ||
      X < box || mode < kFull || mode > kFinish || method < 0 || method > 1)
    return (int)cudaErrorInvalidValue;
  const WinfitMleArgs a{
      B, Y, X, static_cast<const int*>(hits), n, baseline, factor, eps, k,
      mode, static_cast<float*>(theta_c), static_cast<float*>(old_c),
      static_cast<float*>(done_c), static_cast<float*>(iters_c),
      static_cast<float*>(ms_c), static_cast<float*>(theta_out),
      static_cast<float*>(crlb_out), static_cast<float*>(ll_out),
      static_cast<int*>(iters_out), static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return winfit_mle_dispatch(static_cast<const uint16_t*>(frames), box,
                               method, a);
  if (dtype == 1)
    return picasso_winfit_mle_f32(static_cast<const float*>(frames), box,
                                  method, a);
  return (int)cudaErrorInvalidValue;
}
