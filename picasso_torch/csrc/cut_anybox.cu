// The window cut and photon conversion of K5 at any box (sm_90a): the
// box x box windows around a hit list of a (B, Y, X) u16 or f32 chunk,
// converted to photons (raw - baseline) * factor, written as a
// lanes-last (box, box, N) f32 ROI batch for the any-box fits
// (mle_anybox_queue.cu, lq_anybox_queue.cu).
//
// Replaces, at the boxes that winfit_mle*.cu and winfit_lq_queue*.cu are
// not built for, the window load of the Pallas TPU kernels of
// picasso_tpu/ops/winfit_pallas.py (_extract_photons :78, in _mle_kernel
// :108 and _lq_kernel :96) with the row gather that feeds them
// (picasso_tpu/ops/fused.py gather_wincols :609). The centre is clamped
// as there and as fit_common.cuh's stage_window clamps it (f to [0, B-1],
// y to [r, Y-r-1], x to [r, X-r-1], r = box / 2), and the conversion is
// the same two correctly rounded operations, so its ROIs are those the
// templated K5 stages, bit for bit.
//
// What bounds it on the card: bytes (each window's pixels read once, the
// f32 batch written once). Its first form (cut_any_direct_kernel below,
// one thread a pixel with the spot index fastest, off every path since)
// did a 64-bit division a pixel, loaded and clamped its hit's (f, y, x)
// at every pixel, and a warp's 32 reads fell in 32 windows, so each 2-B
// u16 read cost a 32-B sector: ~16x the bytes the function needs through
// L2. The design: a block takes a tile of up to 32 consecutive hits,
// reads each hit's centre once from the int64 rows f, y, x as
// compaction gives them (three pointers, each with its stride: no stack
// or cast of the list before the launch) and clamps it, loads each
// window with a warp's lanes along its pixels in row-major order (a
// warp's read covers a row or two of the window: a row's 2 s bytes in
// one or two sectors), converts them, stores them in shared memory as
// [pixel][hit] (a pixel's hits padded to an odd stride, so the loads'
// stores and the pixel reads fall on distinct banks), then writes each
// pixel's hits as one coalesced store to the lanes-last batch (32 hits:
// 128 B). Where a
// tile's windows pass its shared budget, the tile takes fewer hits (at
// least 8: a 32-B sector a store) or the windows go in bands of rows;
// ops/winfit_cuda.anybox_cut_config works both out from the box. Index
// arithmetic is 32-bit where N * box^2 allows it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCutThreads = 256;

// The hit list's rows f, y, x, int64, each with its stride in elements.
struct HitRows {
  const long long* f;
  const long long* y;
  const long long* x;
  long long sf, sy, sx;
};

// pixels a lane loads of each of its two hits before it stores them:
// twice that many reads in flight. 4 (45 registers) beat 8 (56) and 16
// (77) at boxes 16 and 17, where the paths cut, and lost 5% to 8 at 21
// (tests/torch_anybox_sweep.py builds the others)
#ifndef PICASSO_CUT_BATCH
#define PICASSO_CUT_BATCH 4
#endif
constexpr int kCutBatch = PICASSO_CUT_BATCH;

// A block: hits h0 .. h0 + H - 1 (H = hits, fewer in the last tile), their
// windows in bands of `rows` rows, a band staged at band[p * (H + 1) + h].
// A warp loads two hits' bands at a time, lane l their pixels p = l + 32 k
// in row-major order (each step of 32 pixels advanced by (32 / s, 32 % s)
// rows and columns, no division), so a warp's read covers a row or two.
template <typename Tin, typename Idx>
__global__ void __launch_bounds__(kCutThreads)
    cut_any_kernel(const Tin* __restrict__ frames, long long B, long long Y,
                   long long X, const HitRows hits, int N, int s, int H,
                   int rows, float baseline, float factor,
                   float* __restrict__ out) {
  __shared__ long long origin[32];
  extern __shared__ float band[];
  const int h0 = blockIdx.x * H;
  const int nh = min(H, N - h0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int warps = kCutThreads / 32;
  if (threadIdx.x < nh) {
    const int n = h0 + threadIdx.x;
    const long long r = s / 2;
    const long long f = min(max(__ldg(hits.f + n * hits.sf), 0LL), B - 1);
    const long long y = min(max(__ldg(hits.y + n * hits.sy), r), Y - r - 1);
    const long long x =
        min(max(__ldg(hits.x + n * hits.sx), r), X - r - 1);
    origin[threadIdx.x] = (f * Y + (y - r)) * X + (x - r);
  }
  const int hs = H + 1;  // a pixel's stride in the band
  const int dy = 32 / s, dx = 32 % s, y1 = lane / s, x1 = lane % s;
  for (int y0 = 0; y0 < s; y0 += rows) {
    const int ry = min(rows, s - y0), np = ry * s;
    __syncthreads();  // the origins; the last band's reads
    // two hits a warp at a time: 2 kCutBatch reads in flight
    for (int h = warp; h < nh; h += 2 * warps) {
      const int h2 = h + warps;
      const Tin* src = frames + origin[h] + (long long)y0 * X;
      const Tin* src2 =
          frames + origin[h2 < nh ? h2 : h] + (long long)y0 * X;
      int y = y1, x = x1;
      for (int p0 = lane; p0 < np; p0 += 32 * kCutBatch) {
        Tin v[kCutBatch], w[kCutBatch];
        int at[kCutBatch];
#pragma unroll
        for (int k = 0; k < kCutBatch; ++k) {
          const int p = p0 + 32 * k;
          at[k] = p < np ? p * hs + h : -1;
          if (p < np) {
            const long long o = (long long)y * X + x;
            v[k] = src[o];
            if (h2 < nh) w[k] = src2[o];
          }
          y += dy;
          x += dx;
          if (x >= s) {
            x -= s;
            ++y;
          }
        }
#pragma unroll
        for (int k = 0; k < kCutBatch; ++k)
          if (at[k] >= 0) {
            band[at[k]] = __fmul_rn(
                __fsub_rn(static_cast<float>(v[k]), baseline), factor);
            if (h2 < nh)
              band[at[k] + warps] = __fmul_rn(
                  __fsub_rn(static_cast<float>(w[k]), baseline), factor);
          }
      }
    }
    __syncthreads();
    // each pixel's hits as one store: 32 / H pixels a warp instruction
    const int per = 32 / H, pp = lane / H, hh = lane - pp * H;
    for (int p = warp * per + pp; p < np; p += warps * per)
      if (hh < nh)
        out[(Idx)(y0 * s + p) * (Idx)N + (Idx)(h0 + hh)] = band[p * hs + hh];
  }
}

// The first form, one thread a pixel of a ROI, the spot index fastest
// (chip_smoke.py times it against cut_any_kernel; on no path).
template <typename Tin>
__global__ void __launch_bounds__(256)
    cut_any_direct_kernel(const Tin* __restrict__ frames, long long B,
                          long long Y, long long X,
                          const int* __restrict__ hits, long long N, int s,
                          float baseline, float factor, float* out) {
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

bool cut_args_valid(long long n, int box, long long B, long long Y,
                    long long X) {
  return n > 0 && box >= 1 && B > 0 && Y >= box && X >= box;
}

// Dynamic shared bytes a block of the tiled cut takes (its band).
long long cut_smem(int box, int hits, int rows) {
  return 4LL * rows * box * (hits + 1);
}

template <typename Tin>
int cut_launch(const Tin* frames, long long B, long long Y, long long X,
               const HitRows& hits, long long n, int box, int tile, int rows,
               float baseline, float factor, float* out, cudaStream_t st) {
  const long long bytes = cut_smem(box, tile, rows);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > limit) return (int)cudaErrorInvalidValue;
  const bool small = n * box * box <= 0x7fffffffLL;
  const auto kernel = small ? cut_any_kernel<Tin, int>
                            : cut_any_kernel<Tin, long long>;
  if (bytes > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + tile - 1) / tile);
  kernel<<<blocks, kCutThreads, (int)bytes, st>>>(
      frames, B, Y, X, hits, (int)n, box, tile, rows, baseline, factor, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Cut n hits of a (B, Y, X) chunk (dtype 0 uint16, 1 float32): f, y, x
// are the hits' int64 rows, each at its stride (in elements, >= 0);
// out is (box, box, n) f32. tile: hits a block (1, 2, 4, 8, 16 or 32),
// rows: window rows a band (1 .. box), from
// ops/winfit_cuda.anybox_cut_config. Returns cudaErrorInvalidValue for
// arguments it does not take (its shared bytes above what a block may opt
// in to on the card too), else cudaGetLastError() after the launch.
extern "C" int picasso_cut_anybox(const void* frames, int dtype, long long B,
                                  long long Y, long long X, const void* f,
                                  long long sf, const void* y, long long sy,
                                  const void* x, long long sx, long long n,
                                  int box, float baseline, float factor,
                                  int tile, int rows, void* out,
                                  void* stream) {
  if (!cut_args_valid(n, box, B, Y, X) || n > (1LL << 30) || tile < 1 ||
      tile > 32 || (tile & (tile - 1)) != 0 || rows < 1 || rows > box ||
      sf < 0 || sy < 0 || sx < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HitRows h{static_cast<const long long*>(f),
                  static_cast<const long long*>(y),
                  static_cast<const long long*>(x), sf, sy, sx};
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return cut_launch(static_cast<const uint16_t*>(frames), B, Y, X, h, n,
                      box, tile, rows, baseline, factor, o, st);
  if (dtype == 1)
    return cut_launch(static_cast<const float*>(frames), B, Y, X, h, n, box,
                      tile, rows, baseline, factor, o, st);
  return (int)cudaErrorInvalidValue;
}

// The first form (one thread a pixel): hits is (3, n) int32 rows f, y,
// x; the other arguments picasso_cut_anybox's but the tile. Returns
// cudaGetLastError() after the launch.
extern "C" int picasso_cut_anybox_direct(const void* frames, int dtype,
                                         long long B, long long Y,
                                         long long X, const void* hits,
                                         long long n, int box,
                                         float baseline, float factor,
                                         void* out, void* stream) {
  if (!cut_args_valid(n, box, B, Y, X) ||
      n * box * box > (long long)0x7fffffff * 256)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned int blocks =
      (unsigned int)((n * box * box + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* h = static_cast<const int*>(hits);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    cut_any_direct_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const uint16_t*>(frames), B, Y, X, h, n, box, baseline,
        factor, o);
  else if (dtype == 1)
    cut_any_direct_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const float*>(frames), B, Y, X, h, n, box, baseline,
        factor, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
