// K5 MLE as a work queue (winfit_mle_queue.cuh): the uint16 instances
// and the C entries.

#include "winfit_mle_queue.cuh"

namespace {

int queue_entry(const void* frames, int dtype, int box, int method,
                const WinfitMleQueueArgs& a) {
  if (dtype == 0)
    return winfit_mle_queue_dispatch(static_cast<const uint16_t*>(frames),
                                     box, method, a);
  if (dtype == 1)
    return picasso_winfit_mle_queue_f32(static_cast<const float*>(frames),
                                        box, method, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Fit n hits of a (B, Y, X) chunk (dtype 0 uint16, 1 float32) through
// the work queue: hits is (3, n) int32 rows f, y, x; next is one int32
// on the card, zero before the launch; each spot's carry
// (theta, old, max_step (R, n), done, iters (n,) f32, R = 6 sigmaxy, 5
// sigma) is written at its own index, ready for K5's FINISH mode at k = 0
// (picasso_winfit_mle). method 0 sigmaxy, 1 sigma. Returns
// cudaGetLastError() after the launch.
extern "C" int picasso_winfit_mle_queue(
    const void* frames, int dtype, long long B, long long Y, long long X,
    const void* hits, long long n, int box, float baseline, float factor,
    float eps, int max_it, int method, void* next, void* theta_c,
    void* old_c, void* done_c, void* iters_c, void* ms_c, void* stream) {
  if (n <= 0 || n > (1LL << 30) || B <= 0 || Y < box || X < box ||
      method < 0 || method > 1)
    return (int)cudaErrorInvalidValue;
  const WinfitMleQueueArgs a{
      B, Y, X, static_cast<const int*>(hits), baseline, factor,
      MleQueueArgs{n, eps, max_it, static_cast<int*>(next),
                   static_cast<float*>(theta_c), static_cast<float*>(old_c),
                   static_cast<float*>(done_c), static_cast<float*>(iters_c),
                   static_cast<float*>(ms_c), nullptr, nullptr,
                   static_cast<cudaStream_t>(stream)}};
  return queue_entry(frames, dtype, box, method, a);
}

// Describe the queue kernel's instance for (dtype, box, method) on the
// current device: info[0..7] = threads a block, resident blocks per SM,
// registers a thread, local (spill) bytes a thread, refill threshold,
// __launch_bounds__ min blocks, SMs, lanes of a cooperative group (0
// without the tail). Launches nothing.
extern "C" int picasso_winfit_mle_queue_info(int dtype, int box, int method,
                                             void* info) {
  if (method < 0 || method > 1 || info == nullptr)
    return (int)cudaErrorInvalidValue;
  WinfitMleQueueArgs a{};
  a.q.info = static_cast<int*>(info);
  return queue_entry(nullptr, dtype, box, method, a);
}
