// Spot identification on frame tiles (sm_90a).
//
// Replaces the Pallas TPU kernel picasso_tpu/ops/identify_pallas.py
// _identify_band_kernel (identify_tiles_pallas), which computes the same
// function as picasso_tpu/ops/identify.identify_maps plus the tile stage
// of _identify_compact:
//   - first-argmax local maxima: a centre is strictly greater than every
//     EARLIER pixel of its (box, box) window in row-major order and >=
//     every later one;
//   - the net gradient: sum over the window of the central-difference
//     gradient (gy, gx) dotted with unit vectors pointing at the centre,
//     where row/col -1 wraps to Y-1/X-1 (the reference's numba
//     negative-index quirk);
//   - eligibility h <= y < Y-h-1 and h <= x < X-h-1 (the reference's
//     extra -1 on the high border), then ng > minimum_ng;
//   - the reduction of each aligned (T, T) tile, T = h+1, to (mask, loc =
//     ly*T+lx, ng). Hits are at least h+1 apart, so a tile holds at most
//     one.
//
// What bounds it on the card: bytes. Per frame pixel the kernel reads two
// bytes (u16) and writes nothing but the 1/T^2-resolution tile arrays,
// while it does ~150 FP32 operations per pixel in shared memory: at
// 3.35 TB/s a 256-frame 256x256 u16 chunk is ~10 us of reads against
// ~0.3 GFLOP. The design reads each pixel from device memory once: one
// block per (frame, tile of TPY*T x TPX*T centres) stages its pixels
// plus a halo of h+1 in shared memory as f32 (wrapping rows and columns
// modulo the frame), derives gy/gx there once, and each thread tests
// one centre with 2*box*box direct FMAs against the unit-vector masks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  return static_cast<float>(v);
}

template <int BOX, typename Tin>
__global__ void identify_kernel(const Tin* __restrict__ frames, long long Y,
                                long long X, float min_ng,
                                unsigned char* __restrict__ tile_mask,
                                int* __restrict__ tile_loc,
                                float* __restrict__ tile_ng, long long Ty,
                                long long Tx) {
  constexpr int H = BOX / 2;
  constexpr int T = H + 1;
  constexpr int TPX = 32 / T > 0 ? 32 / T : 1;  // tiles per block along x
  constexpr int TPY = 16 / T > 0 ? 16 / T : 1;  // tiles per block along y
  constexpr int CX = TPX * T, CY = TPY * T;     // centres per block
  constexpr int PX = CX + 2 * H + 2, PY = CY + 2 * H + 2;  // pixels
  constexpr int GX = CX + 2 * H, GY = CY + 2 * H;          // gradients
  __shared__ float pix[PY][PX];
  __shared__ float gy[GY][GX];
  __shared__ float gx[GY][GX];
  __shared__ unsigned char hit[CY][CX];
  __shared__ float hng[CY][CX];

  const long long b = blockIdx.z;
  const long long y0 = (long long)blockIdx.y * CY;
  const long long x0 = (long long)blockIdx.x * CX;
  const Tin* f = frames + b * Y * X;
  const int tid = threadIdx.y * CX + threadIdx.x;

  // pixels (y0 - h - 1 + ly, x0 - h - 1 + lx), wrapped into the frame
  for (int idx = tid; idx < PY * PX; idx += CX * CY) {
    const int ly = idx / PX, lx = idx % PX;
    long long r = (y0 - (H + 1) + ly) % Y;
    long long c = (x0 - (H + 1) + lx) % X;
    if (r < 0) r += Y;
    if (c < 0) c += X;
    pix[ly][lx] = to_f32(f[r * X + c]);
  }
  __syncthreads();
  // gradients at (y0 - h + ly, x0 - h + lx)
  for (int idx = tid; idx < GY * GX; idx += CX * CY) {
    const int ly = idx / GX, lx = idx % GX;
    gy[ly][lx] = pix[ly + 2][lx + 1] - pix[ly][lx + 1];
    gx[ly][lx] = pix[ly + 1][lx + 2] - pix[ly + 1][lx];
  }
  __syncthreads();

  const int ty = threadIdx.y, tx = threadIdx.x;
  const long long yy = y0 + ty, xx = x0 + tx;
  const bool eligible = yy >= H && yy < Y - H - 1 && xx >= H && xx < X - H - 1;
  unsigned char m = 0;
  float ng = 0.0f;
  if (eligible) {
    const float c = pix[ty + H + 1][tx + H + 1];
    bool is_max = true;
#pragma unroll
    for (int dy = -H; dy <= H; ++dy)
#pragma unroll
      for (int dx = -H; dx <= H; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const float v = pix[ty + H + 1 + dy][tx + H + 1 + dx];
        const bool earlier = dy < 0 || (dy == 0 && dx < 0);
        is_max = is_max && (earlier ? c > v : c >= v);
      }
#pragma unroll
    for (int i = 0; i < BOX; ++i)
#pragma unroll
      for (int j = 0; j < BOX; ++j) {
        if (i == H && j == H) continue;
        // unit vector from window position (i, j) toward the centre
        const float vy = (float)(H - i), vx = (float)(H - j);
        const float nrm = sqrtf(vx * vx + vy * vy);
        ng = fmaf(gy[ty + i][tx + j], vy / nrm, ng);
        ng = fmaf(gx[ty + i][tx + j], vx / nrm, ng);
      }
    m = (is_max && ng > min_ng) ? 1 : 0;
  }
  hit[ty][tx] = m;
  hng[ty][tx] = ng;
  __syncthreads();

  if (ty < TPY && tx < TPX) {
    const long long tyg = y0 / T + ty, txg = x0 / T + tx;
    if (tyg < Ty && txg < Tx) {
      unsigned char any = 0;
      int loc = 0;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int j = 0; j < T; ++j) {
          if (hit[ty * T + i][tx * T + j]) {
            any = 1;
            loc += i * T + j;
            s += hng[ty * T + i][tx * T + j];
          }
        }
      const long long o = (b * Ty + tyg) * Tx + txg;
      tile_mask[o] = any;
      tile_loc[o] = loc;
      tile_ng[o] = s;
    }
  }
}

template <int BOX, typename Tin>
void launch(const Tin* frames, long long B, long long Y, long long X,
            float min_ng, unsigned char* mask, int* loc, float* ng,
            cudaStream_t stream) {
  constexpr int T = BOX / 2 + 1;
  constexpr int TPX = 32 / T > 0 ? 32 / T : 1;
  constexpr int TPY = 16 / T > 0 ? 16 / T : 1;
  const long long Ty = (Y + T - 1) / T, Tx = (X + T - 1) / T;
  const dim3 block(TPX * T, TPY * T);
  const dim3 grid((unsigned int)((Tx + TPX - 1) / TPX),
                  (unsigned int)((Ty + TPY - 1) / TPY), (unsigned int)B);
  identify_kernel<BOX, Tin><<<grid, block, 0, stream>>>(
      frames, Y, X, min_ng, mask, loc, ng, Ty, Tx);
}

template <typename Tin>
int dispatch(const Tin* frames, long long B, long long Y, long long X,
             int box, float min_ng, unsigned char* mask, int* loc, float* ng,
             cudaStream_t stream) {
  switch (box) {
#define PICASSO_ID_CASE(S)                                        \
  case S:                                                         \
    launch<S, Tin>(frames, B, Y, X, min_ng, mask, loc, ng, stream); \
    break;
    PICASSO_ID_CASE(3)
    PICASSO_ID_CASE(5)
    PICASSO_ID_CASE(7)
    PICASSO_ID_CASE(9)
    PICASSO_ID_CASE(11)
    PICASSO_ID_CASE(13)
    PICASSO_ID_CASE(15)
#undef PICASSO_ID_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Tile (mask, loc, ng) of B frames (B, Y, X), each output
// (B, ceil(Y/T), ceil(X/T)): mask u8, loc i32, ng f32. dtype 0: uint16
// frames, 1: float32 frames. Returns cudaGetLastError() after the launch.
extern "C" int picasso_identify_tiles(const void* frames, int dtype,
                                      long long B, long long Y, long long X,
                                      int box, float min_ng, void* tile_mask,
                                      void* tile_loc, void* tile_ng,
                                      void* stream) {
  if (B <= 0 || B > 65535 || Y <= 0 || X <= 0)
    return (int)cudaErrorInvalidValue;
  unsigned char* m = static_cast<unsigned char*>(tile_mask);
  int* l = static_cast<int*>(tile_loc);
  float* g = static_cast<float*>(tile_ng);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch(static_cast<const uint16_t*>(frames), B, Y, X, box,
                    min_ng, m, l, g, st);
  if (dtype == 1)
    return dispatch(static_cast<const float*>(frames), B, Y, X, box, min_ng,
                    m, l, g, st);
  return (int)cudaErrorInvalidValue;
}
