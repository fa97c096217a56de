// K5 MLE as a work queue (sm_90a): the queue of mle_queue.cuh with the
// ChunkWindows source, the fused cut + photon conversion + MLE fit
// (sigmaxy and sigma) of a whole hit list in one persistent launch, for
// one frame dtype at a time: winfit_mle_queue.cu instantiates it for
// uint16 chunks, winfit_mle_queue_f32.cu for float32 chunks (one nvcc
// per source). Its CRLB/LL pass is K5's FINISH mode (winfit_mle.cu).
//
// Replaces the Pallas TPU kernel picasso_tpu/ops/winfit_pallas.py
// _mle_kernel (fit_mle_t) on the main path (mle_queue.cuh says how).
//
// Which of K5's instances take the cooperative straggler tail of
// mle_queue.cuh is the measured choice (PERF.md): sigma's, whose queue
// it made ~23% faster on the smoke movie's first chunk, and not
// sigmaxy's, whose queue was as fast or slightly faster without it.
// PICASSO_K5Q_TAIL (bit 0 sigmaxy, bit 1 sigma) only lets
// tests/torch_mle_tail_sweep.py build the others.

#pragma once

#include "mle_queue.cuh"

#ifndef PICASSO_K5Q_TAIL
#define PICASSO_K5Q_TAIL 2
#endif

// The chunk and camera constants of one K5 queue launch (see
// picasso_winfit_mle_queue in winfit_mle_queue.cu) and the queue's own.
struct WinfitMleQueueArgs {
  long long B, Y, X;
  const int* hits;
  float baseline, factor;
  MleQueueArgs q;
};

namespace {

constexpr bool kK5TailXY = (PICASSO_K5Q_TAIL & 1) != 0;
constexpr bool kK5TailSig = (PICASSO_K5Q_TAIL & 2) != 0;

template <typename Tin>
int winfit_mle_queue_dispatch(const Tin* frames, int box, int method,
                              const WinfitMleQueueArgs& a) {
  const ChunkWindows<Tin> src{frames, a.B,    a.Y,        a.X,
                              a.hits, a.q.n, a.baseline, a.factor};
  return mle_queue_dispatch<kK5TailXY, kK5TailSig>(src, box, method, a.q);
}

}  // namespace

// The float32 half, defined in winfit_mle_queue_f32.cu.
int picasso_winfit_mle_queue_f32(const float* frames, int box, int method,
                                 const WinfitMleQueueArgs& a);
