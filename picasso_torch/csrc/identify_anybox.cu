// K4 at any box, the box a launch argument (sm_90a): spot identification
// on frame tiles, one thread a pixel, the chunk read through L1.
//
// Replaces, at the boxes that identify.cu is not built for (above 15, and
// even boxes), the Pallas TPU kernel picasso_tpu/ops/identify_pallas.py:58
// _identify_band_kernel (identify_tiles_pallas). It computes
// picasso_torch/ops/identify.identify_tiles_plain, with identify.cu's
// rules:
//   - first-argmax local maxima over the window [-h, h]^2, h = box / 2:
//     the centre is strictly greater than every EARLIER pixel in
//     row-major order and >= every later one; a NaN in the window means
//     "not a maximum";
//   - the net gradient over window positions (i, j), i, j = 0..box-1 at
//     offsets (i - h, j - h), skipping (h, h): one fmaf of gy, then one
//     of gx, a position, i and j ascending, from 0 (identify.cu's order,
//     so at an odd box ng is its float), with the unit vectors toward the
//     centre computed on the host as the plain version's numpy does
//     (ops/identify._unit_vector_masks; the kernel reads them as uy, ux
//     (box, box) f32) and row/col -1 wrapped to Y-1/X-1;
//   - eligibility h <= y < Y-h-1, h <= x < X-h-1, then ng > min_ng;
//   - the (T, T) tile of a hit, T = h + 1, gets mask 1, loc = ly*T + lx
//     and ng; hits are at least h + 1 apart, so a tile holds at most one,
//     and the tiles start zeroed (the caller's).
// A pixel tests the maxima first and forms the net gradient only where
// it is one. What bounds it: the maxima test's loads (up to (2h + 1)^2 a
// pixel, most pixels leave at the first larger neighbour), served from
// L1; a simple kernel, not yet designed for the card (identify.cu's
// column strips are the model).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

template <typename Tin>
__global__ void __launch_bounds__(256) identify_any_kernel(
    const Tin* __restrict__ frames, int Y, int X, int box, float min_ng,
    const float* __restrict__ uy, const float* __restrict__ ux,
    unsigned char* __restrict__ tile_mask, int* __restrict__ tile_loc,
    float* __restrict__ tile_ng, int Ty, int Tx) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)Y * X) return;
  const int y = (int)(idx / X), x = (int)(idx % X), h = box / 2;
  if (y < h || y >= Y - h - 1 || x < h || x >= X - h - 1) return;
  const Tin* f = frames + (size_t)blockIdx.y * (size_t)Y * (size_t)X;
  auto px = [&](int r, int c) {
    return static_cast<float>(__ldg(f + (size_t)r * X + c));
  };
  const float c = px(y, x);
  for (int dy = -h; dy <= h; ++dy)
    for (int dx = -h; dx <= h; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float w = px(y + dy, x + dx);
      const bool earlier = dy < 0 || (dy == 0 && dx < 0);
      if (!(earlier ? c > w : c >= w)) return;
    }
  float acc = 0.0f;
  for (int i = 0; i < box; ++i) {
    const int r = y - h + i;
    const int up = r > 0 ? r - 1 : Y - 1;
    for (int j = 0; j < box; ++j) {
      if (i == h && j == h) continue;
      const int cc = x - h + j;
      const int lf = cc > 0 ? cc - 1 : X - 1;
      const float gy = px(r + 1, cc) - px(up, cc);
      const float gx = px(r, cc + 1) - px(r, lf);
      acc = fmaf(gy, __ldg(uy + i * box + j), acc);
      acc = fmaf(gx, __ldg(ux + i * box + j), acc);
    }
  }
  if (!(acc > min_ng)) return;
  const int T = h + 1;
  const size_t o = ((size_t)blockIdx.y * Ty + y / T) * Tx + x / T;
  tile_mask[o] = 1;
  tile_loc[o] = (y % T) * T + x % T;
  tile_ng[o] = 0.0f + acc;  // a sum over the one hit
}

}  // namespace

// Tile (mask, loc, ng) of B frames (B, Y, X) at any box >= 3, each output
// (B, ceil(Y/T), ceil(X/T)), zero before the launch: mask u8, loc i32, ng
// f32. dtype 0: uint16 frames, 1: float32 frames. uy, ux: the (box, box)
// unit vectors on the card. Returns cudaGetLastError() after the launch.
extern "C" int picasso_identify_anybox(const void* frames, int dtype,
                                       long long B, long long Y, long long X,
                                       int box, float min_ng, const void* uy,
                                       const void* ux, void* tile_mask,
                                       void* tile_loc, void* tile_ng,
                                       void* stream) {
  if (B <= 0 || B > 65535 || Y <= 0 || X <= 0 || Y * X > INT_MAX || box < 3)
    return (int)cudaErrorInvalidValue;
  const long long T = box / 2 + 1;
  const int Ty = (int)((Y + T - 1) / T), Tx = (int)((X + T - 1) / T);
  const int threads = 256;
  const dim3 grid((unsigned)((Y * X + threads - 1) / threads), (unsigned)B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vy = static_cast<const float*>(uy);
  const float* vx = static_cast<const float*>(ux);
  unsigned char* m = static_cast<unsigned char*>(tile_mask);
  int* l = static_cast<int*>(tile_loc);
  float* g = static_cast<float*>(tile_ng);
  if (dtype == 0)
    identify_any_kernel<<<grid, threads, 0, st>>>(
        static_cast<const uint16_t*>(frames), (int)Y, (int)X, box, min_ng,
        vy, vx, m, l, g, Ty, Tx);
  else if (dtype == 1)
    identify_any_kernel<<<grid, threads, 0, st>>>(
        static_cast<const float*>(frames), (int)Y, (int)X, box, min_ng, vy,
        vx, m, l, g, Ty, Tx);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
