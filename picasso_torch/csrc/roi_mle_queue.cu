// K2 as a work queue (sm_90a): the MLE fit (sigmaxy and sigma) of a cut
// lanes-last (S, S, N) f32 ROI batch in one persistent launch with lane
// refill and the warp-cooperative straggler tail, the queue of
// mle_queue.cuh with the RoiBatch source (each slot stages its spot's
// photons from the batch as they are). Its CRLB/LL pass is mle_fit.cu's
// FINISH mode at k = 0.
//
// Replaces the Pallas TPU kernels picasso_tpu/ops/mle_pallas.py
// _start/_resume/_finish_phase_kernel (fit_pallas_boundary_t) on fit2D's
// MLE path, where the port ran them as mle_fit.cu's START/RESUME/FINISH
// modes with host permutes between phases (3 launches a block); here 2
// (mle_queue.cuh says what the queue and its tail do). Boxes 5-15 are
// instantiated, as for mle_fit.cu.

#include "mle_queue.cuh"

// Fit n spots, lanes-last (box, box, n) f32, through the work queue:
// next is one int32 on the card, zero before the launch; spots at index
// >= n_valid start converged; each spot's carry (theta, old, max_step
// (R, n), done, iters (n,) f32, R = 6 sigmaxy, 5 sigma) is written at its
// own index, ready for mle_fit.cu's FINISH mode at k = 0
// (picasso_mle_fit). method 0 sigmaxy, 1 sigma. coop_steps (one int32 on
// the card, or null) gains the spot-steps taken in the cooperative tail.
// Returns cudaGetLastError() after the launch.
extern "C" int picasso_roi_mle_queue(const void* spots, long long n, int box,
                                     float eps, int max_it,
                                     long long n_valid, int method,
                                     void* next, void* theta_c, void* old_c,
                                     void* done_c, void* iters_c, void* ms_c,
                                     void* coop_steps, void* stream) {
  if (n <= 0 || n > (1LL << 30) || max_it < 0 || method < 0 || method > 1)
    return (int)cudaErrorInvalidValue;
  const RoiBatch src{static_cast<const float*>(spots), n, n_valid};
  const MleQueueArgs a{n,
                       eps,
                       max_it,
                       static_cast<int*>(next),
                       static_cast<float*>(theta_c),
                       static_cast<float*>(old_c),
                       static_cast<float*>(done_c),
                       static_cast<float*>(iters_c),
                       static_cast<float*>(ms_c),
                       static_cast<int*>(coop_steps),
                       nullptr,
                       static_cast<cudaStream_t>(stream)};
  return mle_queue_dispatch<true, true>(src, box, method, a);
}

// Describe the instance for (box, method) on the current device:
// info[0..7] = threads a block, resident blocks per SM, registers a
// thread, local (spill) bytes a thread, refill threshold,
// __launch_bounds__ min blocks, SMs, lanes of a cooperative group.
// Launches nothing.
extern "C" int picasso_roi_mle_queue_info(int box, int method, void* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  MleQueueArgs a{};
  a.info = static_cast<int*>(info);
  return mle_queue_dispatch<true, true>(RoiBatch{}, box, method, a);
}
