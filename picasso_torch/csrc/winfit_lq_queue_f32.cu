// K5 LM as a work queue (winfit_lq_queue.cuh): the float32 instances,
// called by picasso_winfit_lq_queue (winfit_lq_queue.cu).

#include "winfit_lq_queue.cuh"

int picasso_winfit_lq_queue_f32(const float* frames, int box,
                                const WinfitLqQueueArgs& a) {
  return winfit_lq_queue_dispatch(frames, box, a);
}
