// K5 MLE as a work queue (winfit_mle_queue.cuh): the float32 instances,
// called by picasso_winfit_mle_queue (winfit_mle_queue.cu).

#include "winfit_mle_queue.cuh"

int picasso_winfit_mle_queue_f32(const float* frames, int box, int method,
                                 const WinfitMleQueueArgs& a) {
  return winfit_mle_queue_dispatch(frames, box, method, a);
}
