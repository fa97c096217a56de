// K5 LM as a work queue (winfit_lq_queue.cuh): the uint16 instances and
// the C entries.

#include "winfit_lq_queue.cuh"

namespace {

int lq_queue_entry(const void* frames, int dtype, int box,
                   const WinfitLqQueueArgs& a) {
  if (dtype == 0)
    return winfit_lq_queue_dispatch(static_cast<const uint16_t*>(frames),
                                    box, a);
  if (dtype == 1)
    return picasso_winfit_lq_queue_f32(static_cast<const float*>(frames),
                                       box, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// LM-fit n hits of a (B, Y, X) chunk (dtype 0 uint16, 1 float32) through
// the work queue: hits is (3, n) int32 rows f, y, x; baseline and factor
// convert raw counts to photons; next is one int32 on the card, zero
// before the launch; theta (6, n) f32 out, x/y relative to the box
// centre, each spot at its own index. coop_steps (one int32 on the card,
// or null) gains the spot-steps taken in the cooperative tail. Returns
// cudaGetLastError() after the launch.
extern "C" int picasso_winfit_lq_queue(
    const void* frames, int dtype, long long B, long long Y, long long X,
    const void* hits, long long n, int box, float baseline, float factor,
    float ftol, int max_it, void* next, void* theta, void* coop_steps,
    void* stream) {
  if (n <= 0 || n > (1LL << 30) || B <= 0 || Y < box || X < box ||
      max_it < 0)
    return (int)cudaErrorInvalidValue;
  const WinfitLqQueueArgs a{
      B, Y, X, static_cast<const int*>(hits), baseline, factor,
      LqQueueArgs{(int)n, ftol, max_it, static_cast<int*>(next),
                  static_cast<float*>(theta), static_cast<int*>(coop_steps),
                  nullptr, static_cast<cudaStream_t>(stream)}};
  return lq_queue_entry(frames, dtype, box, a);
}

// Describe the queue kernel's instance for (dtype, box) on the current
// device: info[0..6] = threads a block, resident blocks per SM,
// registers a thread, local (spill) bytes a thread, refill threshold,
// lanes of a cooperative group, SMs. Launches nothing.
extern "C" int picasso_winfit_lq_queue_info(int dtype, int box, void* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  WinfitLqQueueArgs a{};
  a.q.info = static_cast<int*>(info);
  return lq_queue_entry(nullptr, dtype, box, a);
}
