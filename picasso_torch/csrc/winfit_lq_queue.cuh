// K5 LM as a work queue (sm_90a): the queue of lq_queue.cuh with the
// ChunkWindows source, the fused cut + photon conversion +
// Levenberg-Marquardt fit of a whole hit list in one persistent launch
// with lane refill and a cooperative straggler tail, for one frame dtype
// at a time: winfit_lq_queue.cu instantiates it for uint16 chunks,
// winfit_lq_queue_f32.cu for float32 chunks (one nvcc per source).
//
// Replaces the Pallas TPU kernel picasso_tpu/ops/winfit_pallas.py
// _lq_kernel (fit_lq_t) (lq_queue.cuh says how).

#pragma once

#include "lq_queue.cuh"

// The chunk and camera constants of one K5 LM queue launch (see
// picasso_winfit_lq_queue in winfit_lq_queue.cu) and the queue's own.
struct WinfitLqQueueArgs {
  long long B, Y, X;
  const int* hits;
  float baseline, factor;
  LqQueueArgs q;
};

namespace {

template <typename Tin>
int winfit_lq_queue_dispatch(const Tin* frames, int box,
                             const WinfitLqQueueArgs& a) {
  const ChunkWindows<Tin> src{frames, a.B,    a.Y,        a.X,
                              a.hits, a.q.n, a.baseline, a.factor};
  return lq_queue_dispatch(src, box, a.q);
}

}  // namespace

// The float32 half, defined in winfit_lq_queue_f32.cu.
int picasso_winfit_lq_queue_f32(const float* frames, int box,
                                const WinfitLqQueueArgs& a);
