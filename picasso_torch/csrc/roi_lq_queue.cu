// K3 as a work queue (sm_90a): the Levenberg-Marquardt fit of a cut
// lanes-last (S, S, N) f32 ROI batch in one persistent launch with lane
// refill and the cooperative straggler tail, the queue of lq_queue.cuh
// with the RoiBatch source (each slot stages its spot's photons from the
// batch as they are).
//
// Replaces the Pallas TPU kernels of picasso_tpu/ops/lq_pallas.py:
//   K3  _tile_kernel (fit_pallas_t), on fit2D's LM path, where the port
//       ran it as lq_fit.cu's one pass, one thread a spot;
//   K6  _lm_start_kernel, _lm_resume_kernel (fit_pallas_boundary_t), the
//       same fit in phases with the unconverged lanes moved to the front
//       between them, since a TPU lane cannot take new work; here a slot
//       takes the next spot when its own is done, so K6 is one launch of
//       this queue (ops/lq_cuda.fit_boundary_t) and has no phases.
// lq_queue.cuh says what the queue and its tail do. Bound by operations
// (the LM steps; a box-7 ROI is 196 B read once). The odd boxes 3-15
// are instantiated, as for lq_fit.cu.

#include "lq_queue.cuh"

// LM-fit n spots, lanes-last (box, box, n) f32, through the work queue:
// next is one int32 on the card, zero before the launch; spots at index
// >= n_valid start done; theta (6, n) f32 out, x/y relative to the box
// centre, each spot at its own index. coop_steps (one int32 on the card,
// or null) gains the spot-steps taken in the cooperative tail. Returns
// cudaGetLastError() after the launch.
extern "C" int picasso_roi_lq_queue(const void* spots, long long n, int box,
                                    float ftol, int max_it,
                                    long long n_valid, void* next,
                                    void* theta, void* coop_steps,
                                    void* stream) {
  if (n <= 0 || n > (1LL << 30) || max_it < 0)
    return (int)cudaErrorInvalidValue;
  const RoiBatch src{static_cast<const float*>(spots), n, n_valid};
  const LqQueueArgs a{(int)n,
                      ftol,
                      max_it,
                      static_cast<int*>(next),
                      static_cast<float*>(theta),
                      static_cast<int*>(coop_steps),
                      nullptr,
                      static_cast<cudaStream_t>(stream)};
  return lq_queue_dispatch(src, box, a);
}

// Describe the instance for box on the current device: info[0..6] =
// threads a block, resident blocks per SM, registers a thread, local
// (spill) bytes a thread, refill threshold, lanes of a cooperative
// group, SMs. Launches nothing.
extern "C" int picasso_roi_lq_queue_info(int box, void* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  LqQueueArgs a{};
  a.info = static_cast<int*>(info);
  return lq_queue_dispatch(RoiBatch{}, box, a);
}
