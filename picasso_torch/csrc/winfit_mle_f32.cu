// K5, the fused cut + photon conversion + MLE fit (winfit_mle.cuh): the
// float32 instances, called by picasso_winfit_mle (winfit_mle.cu).

#include "winfit_mle.cuh"

int picasso_winfit_mle_f32(const float* frames, int box, int method,
                           const WinfitMleArgs& a) {
  return winfit_mle_dispatch(frames, box, method, a);
}
