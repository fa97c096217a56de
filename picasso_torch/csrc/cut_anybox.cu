// The window cut and photon conversion of K5 at any box (sm_90a): the
// box x box windows around a hit list of a (B, Y, X) u16 or f32 chunk,
// converted to photons (raw - baseline) * factor, written as a
// lanes-last (box, box, N) f32 ROI batch for mle_anybox.cu or
// lq_anybox.cu. One thread a pixel of a ROI, the spot index fastest, so
// a warp writes 32 neighbouring addresses.
//
// Replaces, at the boxes that winfit_mle*.cu and winfit_lq_queue*.cu are
// not built for, the window load of the Pallas TPU kernels of
// picasso_tpu/ops/winfit_pallas.py (_mle_kernel :108, _lq_kernel :96)
// with the row gather that feeds them (picasso_tpu/ops/fused.py
// gather_wincols :609). The centre is clamped as there and as
// fit_common.cuh's stage_window clamps it (f to [0, B-1], y to [r,
// Y-r-1], x to [r, X-r-1], r = box / 2), and the conversion is the same
// two correctly rounded operations, so its ROIs are those the templated
// K5 stages, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Tin>
__global__ void __launch_bounds__(256)
    cut_any_kernel(const Tin* __restrict__ frames, long long B, long long Y,
                   long long X, const int* __restrict__ hits, long long N,
                   int s, float baseline, float factor, float* out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * s * s) return;
  const long long n = idx % N;
  const int p = (int)(idx / N), yy = p / s, xx = p % s;
  const long long r = s / 2;
  const long long f = min(max((long long)hits[n], 0LL), B - 1);
  const long long y = min(max((long long)hits[N + n], r), Y - r - 1);
  const long long x = min(max((long long)hits[2 * N + n], r), X - r - 1);
  const Tin v = frames[(f * Y + (y - r + yy)) * X + (x - r + xx)];
  out[idx] = __fmul_rn(__fsub_rn(static_cast<float>(v), baseline), factor);
}

}  // namespace

// Cut n hits of a (B, Y, X) chunk (dtype 0 uint16, 1 float32): hits is
// (3, n) int32 rows f, y, x; out is (box, box, n) f32. Returns
// cudaGetLastError() after the launch.
extern "C" int picasso_cut_anybox(const void* frames, int dtype, long long B,
                                  long long Y, long long X, const void* hits,
                                  long long n, int box, float baseline,
                                  float factor, void* out, void* stream) {
  if (n <= 0 || box < 1 || B <= 0 || Y < box || X < box ||
      n * box * box > (long long)0x7fffffff * 256)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned int blocks =
      (unsigned int)((n * box * box + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* h = static_cast<const int*>(hits);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    cut_any_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const uint16_t*>(frames), B, Y, X, h, n, box, baseline,
        factor, o);
  else if (dtype == 1)
    cut_any_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const float*>(frames), B, Y, X, h, n, box, baseline,
        factor, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
