// K1 and K7 as one work-queue launch (sm_90a): the MLE fit (sigmaxy and
// sigma) of a cut lanes-last (S, S, N) f32 ROI batch with its CRLB and
// log-likelihood in the same launch, the queue of mle_queue.cuh with the
// RoiBatch source, the cooperative straggler tail and CRLB = true: a
// finished spot writes its theta and iteration count and a ready flag,
// and a warp whose fits are done runs the CRLB/LL of 32 consecutive
// spots at a time, one a lane, from their thetas and their ROIs in the
// batch, while other warps still fit their stragglers. No carry is
// written and no second launch reads the batch again.
//
// Where the CRLB/LL runs was measured (tests/torch_k1_queue_sweep.py,
// PERF.md; NVIDIA H100, both methods, make_spots and the smoke movie's
// first fit2D block): by the finished slots at the warp's next refill,
// from their staged pixels (the first design), or by a warp from a list
// of its finished spots, both took 1.4-1.9x this handoff's time; at 2
// blocks a SM instead of 3 (the CRLB/LL's registers), this one took
// 1.10-1.16x.
//
// Replaces the Pallas TPU kernels picasso_tpu/ops/mle_pallas.py
// _tile_kernel (fit_pallas_t, K1: fit, CRLB and LL in one kernel) and
// _first_round_kernel, _resume_round_kernel, _finalize_kernel
// (fit_pallas_multiround, K7: the sigmaxy fit in rounds of 8 with the
// lanes compacted between rounds, then the CRLB/LL pass). A TPU lane
// cannot take new work, so K7 compacts lanes between launches; a slot of
// this queue takes the next spot as soon as its own is done, so one
// launch does what K7's rounds do. The one-thread pass (mle_fit.cu
// FULL, ops/mle_cuda.fit_one_pass_t) stays the fixed point this kernel
// equals bit for bit. The odd boxes 3-15 are instantiated (other boxes:
// mle_anybox.cu).

#include "mle_queue.cuh"

// Fit n spots, lanes-last (box, box, n) f32, through the work queue with
// the CRLB/LL in it: next is n + 2 int32 on the card, zero before the
// launch (the queue's two counters and a ready flag a spot); spots at
// index >= n_valid start converged; outputs theta,
// crlb (6, n) f32, ll (n,) f32, iters (n,) int32, as mle_fit.cu's FULL
// mode writes them. method 0 sigmaxy, 1 sigma. coop_steps (one int32 on
// the card, or null) gains the spot-steps taken in the cooperative tail.
// Returns cudaGetLastError() after the launch.
extern "C" int picasso_roi_mle_fit(const void* spots, long long n, int box,
                                   float eps, int max_it, long long n_valid,
                                   int method, void* next, void* theta_out,
                                   void* crlb_out, void* ll_out,
                                   void* iters_out, void* coop_steps,
                                   void* stream) {
  if (n <= 0 || n > (1LL << 30) || max_it < 0 || method < 0 || method > 1)
    return (int)cudaErrorInvalidValue;
  const RoiBatch src{static_cast<const float*>(spots), n, n_valid};
  MleQueueArgs a{};
  a.n = n;
  a.eps = eps;
  a.max_it = max_it;
  a.next = static_cast<int*>(next);
  a.next2 = a.next + 1;
  a.ready = a.next + 2;
  a.coop_steps = static_cast<int*>(coop_steps);
  a.stream = static_cast<cudaStream_t>(stream);
  a.theta_o = static_cast<float*>(theta_out);
  a.crlb_o = static_cast<float*>(crlb_out);
  a.ll_o = static_cast<float*>(ll_out);
  a.iters_o = static_cast<int*>(iters_out);
  return mle_queue_dispatch<true, true, true>(src, box, method, a);
}

// Describe the instance for (box, method) on the current device:
// info[0..7] = threads a block, resident blocks per SM, registers a
// thread, local (spill) bytes a thread, refill threshold,
// __launch_bounds__ min blocks, SMs, lanes of a cooperative group.
// Launches nothing.
extern "C" int picasso_roi_mle_fit_info(int box, int method, void* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  MleQueueArgs a{};
  a.info = static_cast<int*>(info);
  return mle_queue_dispatch<true, true, true>(RoiBatch{}, box, method, a);
}
