// K4 at any box, the box a launch argument (sm_90a): spot identification
// on frame tiles, a block an output tile staged in shared memory, the
// local maxima from separable running maxima, the net gradient only at
// the maxima.
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
//
// What bounds it on the card: the bytes of the chunk (2 a u16 pixel, read
// once); the function needs a constant number of compares a pixel for
// the maxima and the net gradient's 2 (box^2 - 1) FMAs at the local
// maxima only (34,894 of the 14.6 M tested pixels of the smoke's wide
// chunk at box 17). Its first form (the direct kernel below) tested up
// to box^2 - 1 neighbours a pixel through L1; identify.cu's column strips
// hold a register ring of box + 2 pixels and FMA the dense net gradient
// at every pixel, neither of which carries over to a run-time box of 17
// or 21 (576 FMAs a pixel). The design, a block an OY x OX output tile
// (launch arguments, ops/identify_cuda.anybox_tile_shape):
//   0. the tile plus a halo of h + 1 is staged as f32 in dynamic shared
//      memory, coalesced, kStage loads a thread in flight at a time
//      (indices wrapped into the frame as identify.cu wraps them);
//   1. per window row, running maxima in blocks of h (van Herk /
//      Gil-Werman): the prefix and suffix maxima of each block, so the
//      max of any h consecutive pixels is max(suffix[a], prefix[a+h-1]),
//      O(1) a pixel whatever the box;
//   2. per window row and centre column: the max of the left part (x-h
//      .. x-1), of the right part (x+1 .. x+h) and of the whole row;
//      on a centre row, whether the centre passes its own row (> left,
//      >= right);
//   3. per centre column, the same running maxima of the whole-row
//      maxima down the rows;
//   4. per centre: the rows above (> their max) and below (>= their
//      max); a maximum joins the block's list in shared memory;
//   5. a warp a listed maximum: its lanes form 32 window positions'
//      gradients and unit vectors at a time from the stage, and every
//      lane runs the net gradient's FMAs in their order from shuffled
//      operands (a maximum's 2 (box^2 - 1) dependent FMAs, ~2,300
//      cycles at box 17, are the step's floor); then the threshold and
//      the tile. A thread a maximum was 5-20% slower in the sweep.
// The maxima are NaN-propagating (PTX max.NaN.f32), exact and
// associative, so the test equals the direct one; the net gradient is
// the same FMAs in the same order. So the tiles equal the direct
// kernel's and, at 3-15, identify.cu's bit for bit.
//
// The tile is the measured choice (tests/torch_anybox_sweep.py on a
// 256-frame 256 x 256 u16 chunk of the wide movie's recipe, medians in
// rounds; NVIDIA H100 80GB HBM3, 700 W): 64 x 32, 0.580 ms at box 17
// and 0.688 at 21 (the direct kernel 2.327 / 2.774 ms in the same
// rounds); 32 x 64 0.585 / 0.704, 64 x 64 0.641 / 0.695, 32 x 32
// 0.608 / 0.751, 8 x 64 0.874 / 1.039. Its steps' clock cycles a block
// at box 17 (PICASSO_K4ANY_CLOCKS; 64 x 64): staging ~27,000, the row
// and column runs and maxima ~12,000, the test ~5,000, the net gradient
// ~28,000 of wall time, which did not follow the step's own work (a
// thread or a warp a maximum, its operands loaded ahead or not); what
// the block waits on there is open (PERF.md).
//
// The direct kernel (picasso_identify_anybox_direct, one thread a pixel
// testing its window's neighbours through L1, the net gradient at its
// maxima) takes the boxes at which no tile fits in a block's shared
// memory (96 and above on an H100, where even a 1 x 32 tile's halo rows
// and unit vectors pass 232,448 bytes; ops/identify_cuda.identify_tiles
// chooses), and is the fixed point chip_smoke.py holds this kernel to at
// every box, and times in turns with it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// pixels a thread stages at a time, and values of a run of maxima (runs)
// loaded at a time, before their stores
constexpr int kStage = 8;
constexpr int kRun = 8;

// With PICASSO_K4ANY_CLOCKS (tests/torch_anybox_sweep.py builds this
// file alone so), thread 0 of each block adds the clock cycles of each
// step of identify_any_kernel to k4any_clocks[step] (read with
// picasso_identify_anybox_clocks); else the marks are empty.
#ifdef PICASSO_K4ANY_CLOCKS
__device__ unsigned long long k4any_clocks[8];
#define K4ANY_MARK(k)                                                  \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const long long now = clock64();                                 \
      if ((k) > 0) atomicAdd(k4any_clocks + (k) - 1,                   \
                             (unsigned long long)(now - k4any_t));     \
      else atomicAdd(k4any_clocks + 7, 1ULL);                          \
      k4any_t = now;                                                   \
    }                                                                  \
  } while (0)
#else
#define K4ANY_MARK(k) \
  do {                \
  } while (0)
#endif

// max that returns NaN when either operand is NaN (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// v modulo n, in [0, n) (identify.cu's wrap)
__device__ __forceinline__ int wrap(int v, int n) {
  if (v < 0)
    v += n;
  else if (v >= n)
    v -= n;
  if (v < 0 || v >= n) {
    v %= n;
    if (v < 0) v += n;
  }
  return v;
}

// The prefix (into p) and the suffix (into q) maxima of the n values at
// src[0], src[d], ..., src[(n - 1) d], NaN-propagating; kRun values are
// loaded at a time before their maxima are stored, so that their loads
// are in flight together.
__device__ __forceinline__ void runs(const float* src, float* p, float* q,
                                     int n, int d) {
  float v = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kRun) {
    float x[kRun];
#pragma unroll
    for (int u = 0; u < kRun; ++u) x[u] = src[min(k0 + u, n - 1) * d];
#pragma unroll
    for (int u = 0; u < kRun; ++u)
      if (k0 + u < n) {
        v = k0 + u == 0 ? x[u] : max_nan(v, x[u]);
        p[(k0 + u) * d] = v;
      }
  }
  for (int k0 = n - 1; k0 >= 0; k0 -= kRun) {
    float x[kRun];
#pragma unroll
    for (int u = 0; u < kRun; ++u) x[u] = src[max(k0 - u, 0) * d];
#pragma unroll
    for (int u = 0; u < kRun; ++u)
      if (k0 - u >= 0) {
        v = k0 - u == n - 1 ? x[u] : max_nan(v, x[u]);
        q[(k0 - u) * d] = v;
      }
  }
}

// The block's shared-memory layout at box (h = box / 2) for an oy x ox
// output tile, in floats: the staged pixels (oy + 2h + 2 rows, pitch
// pp), the prefix and the suffix maxima of the window rows (oy + 2h rows
// of the ox + 2h columns that the centres' windows cover, odd pitch mp;
// in step 3 those of the whole-row maxima, pitch ox), the whole-row
// maxima ((oy + 2h) x ox), the unit vectors uy, ux (box x box each),
// the list of the tile's local maxima (at most cap: two maxima are more
// than h apart along y or x, so an (h + 1) x (h + 1) cell holds at most
// one) and its count, then a byte a centre (its own row passed).
struct Layout {
  int h, wr, m, py, px, pp, mp, cap;
  long long pix, pre, suf, whole, uy, ux, list, rowok, bytes;
  __host__ __device__ Layout(int box, int oy, int ox) {
    h = box / 2;
    wr = oy + 2 * h;
    m = ox + 2 * h;
    py = wr + 2;
    px = m + 2;
    pp = px | 1;
    mp = m | 1;
    cap = ((oy + h) / (h + 1)) * ((ox + h) / (h + 1));
    pix = 0;
    pre = pix + (long long)py * pp;
    suf = pre + (long long)wr * mp;
    whole = suf + (long long)wr * mp;
    uy = whole + (long long)wr * ox;
    ux = uy + (long long)box * box;
    list = ux + (long long)box * box;
    rowok = list + cap + 1;
    bytes = 4 * rowok + (long long)oy * ox;
  }
};

template <typename Tin>
__global__ void __launch_bounds__(kThreads) identify_any_kernel(
    const Tin* __restrict__ frames, int Y, int X, int box, float min_ng,
    const float* __restrict__ uy, const float* __restrict__ ux,
    unsigned char* __restrict__ tile_mask, int* __restrict__ tile_loc,
    float* __restrict__ tile_ng, int Ty, int Tx, int oy, int lg_ox) {
  extern __shared__ float sm[];
#ifdef PICASSO_K4ANY_CLOCKS
  long long k4any_t = 0;
#endif
  const int ox = 1 << lg_ox;
  const Layout L(box, oy, ox);
  const int h = L.h, wr = L.wr, m = L.m, pp = L.pp, mp = L.mp;
  float* pix = sm + L.pix;
  float* pre = sm + L.pre;
  float* suf = sm + L.suf;
  float* whole = sm + L.whole;
  float* wy = sm + L.uy;
  float* wx = sm + L.ux;
  int* list = reinterpret_cast<int*>(sm + L.list);
  int* count = list + L.cap;
  unsigned char* rowok = reinterpret_cast<unsigned char*>(sm + L.rowok);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int y0 = blockIdx.y * oy, x0 = blockIdx.x * ox;
  const Tin* f = frames + (size_t)blockIdx.z * (size_t)Y * (size_t)X;
  K4ANY_MARK(0);

  // 0. stage pixels (y0 - h - 1 + r, x0 - h - 1 + c), wrapped, kStage
  // a thread at a time, their loads issued before their stores (so that
  // they are in flight together; (r, c) steps on by kThreads without a
  // division), and the unit vectors
  const int total = L.py * L.px;
  const int dr = kThreads / L.px, dc = kThreads - dr * L.px;
  int r = t / L.px, c = t - r * L.px;
  for (int base = t; base < total; base += kStage * kThreads) {
    float v[kStage];
    int at[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      at[k] = -1;
      if (base + k * kThreads < total) {
        v[k] = static_cast<float>(f[(size_t)wrap(y0 - h - 1 + r, Y) * X +
                                    wrap(x0 - h - 1 + c, X)]);
        at[k] = r * pp + c;
      }
      r += dr;
      c += dc;
      if (c >= L.px) {
        c -= L.px;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k)
      if (at[k] >= 0) pix[at[k]] = v[k];
  }
  for (int i = t; i < box * box; i += kThreads) {
    wy[i] = __ldg(uy + i);
    wx[i] = __ldg(ux + i);
  }
  if (t == 0) *count = 0;
  __syncthreads();
  K4ANY_MARK(1);

  // 1. prefix and suffix maxima in blocks of h along each window row k =
  // 0..m-1 (frame column x0 - h + k); window row w is pixel row w + 1
  const int nb = (m + h - 1) / h;
  for (int it = t; it < nb * wr; it += kThreads) {
    const int b = it / wr, w = it - b * wr;
    const int k0 = b * h, o = w * mp + k0;
    runs(pix + (w + 1) * pp + 1 + k0, pre + o, suf + o, min(h, m - k0), 1);
  }
  __syncthreads();
  K4ANY_MARK(2);

  // 2. per window row and centre column cx (k = cx + h): the left part
  // k - h .. k - 1, the right part k + 1 .. k + h, the whole row
  for (int it = t; it < wr * ox; it += kThreads) {
    const int w = it >> lg_ox, cx = it & (ox - 1);
    const float* p = pre + w * mp;
    const float* q = suf + w * mp;
    const float left = max_nan(q[cx], p[cx + h - 1]);
    const float right = max_nan(q[cx + h + 1], p[cx + 2 * h]);
    const float c = pix[(w + 1) * pp + cx + h + 1];
    whole[it] = max_nan(max_nan(left, c), right);
    const int cy = w - h;
    if (cy >= 0 && cy < oy) rowok[(cy << lg_ox) + cx] = c > left && c >= right;
  }
  __syncthreads();
  K4ANY_MARK(3);

  // 3. prefix and suffix maxima of the whole-row maxima down each column,
  // in blocks of h rows (over steps 1's arrays, pitch ox)
  const int nbv = (wr + h - 1) / h;
  for (int it = t; it < nbv * ox; it += kThreads) {
    const int b = it >> lg_ox, cx = it & (ox - 1);
    const int o = (b * h << lg_ox) + cx;
    runs(whole + o, pre + o, suf + o, min(h, wr - b * h), ox);
  }
  __syncthreads();
  K4ANY_MARK(4);

  // 4. per centre (cy, cx), window row ry = cy + h: the rows above (ry -
  // h .. ry - 1), below (ry + 1 .. ry + h); a maximum joins the list
  for (int it = t; it < oy * ox; it += kThreads) {
    const int cy = it >> lg_ox, cx = it & (ox - 1);
    const int y = y0 + cy, x = x0 + cx;
    if (y < h || y >= Y - h - 1 || x < h || x >= X - h - 1 || !rowok[it])
      continue;
    const int ry = cy + h;
    const float c = pix[(ry + 1) * pp + cx + h + 1];
    const float above = max_nan(suf[(cy << lg_ox) + cx],
                                pre[((ry - 1) << lg_ox) + cx]);
    const float below = max_nan(suf[((ry + 1) << lg_ox) + cx],
                                pre[((ry + h) << lg_ox) + cx]);
    if (c > above && c >= below) {
      const int k = atomicAdd(count, 1);
      if (k < L.cap) list[k] = it;
    }
  }
  __syncthreads();
  K4ANY_MARK(5);

  // 5. the net gradient of each listed maximum, a warp each: its lanes
  // form 32 window positions' gradients and weights at a time (position
  // p = i * box + j, row-major), and every lane runs the same FMAs, one
  // of gy then one of gx a position, in order, from shuffled operands, so
  // every lane holds the sum; then the threshold and the tile
  const int T = h + 1, n_max = min(*count, L.cap), n_pos = box * box;
  for (int k = warp; k < n_max; k += kThreads / 32) {
    const int it = list[k];
    const int cy = it >> lg_ox, cx = it & (ox - 1);
    const int y = y0 + cy, x = x0 + cx;
    float acc = 0.0f;
    for (int p0 = 0; p0 < n_pos; p0 += 32) {
      float gy = 0.0f, gx = 0.0f, vy = 0.0f, vx = 0.0f;
      const int p = p0 + lane;
      if (p < n_pos) {
        const int i = p / box, j = p - i * box;
        const float* up = pix + (cy + i) * pp + cx;  // pixel row cy + i
        gy = up[2 * pp + j + 1] - up[j + 1];
        gx = up[pp + j + 2] - up[pp + j];
        vy = wy[p];
        vx = wx[p];
      }
      const int n = min(32, n_pos - p0);
#pragma unroll 8
      for (int u = 0; u < n; ++u) {
        const float a = __shfl_sync(0xffffffffu, gy, u);
        const float b = __shfl_sync(0xffffffffu, vy, u);
        const float e = __shfl_sync(0xffffffffu, gx, u);
        const float d = __shfl_sync(0xffffffffu, vx, u);
        if (p0 + u != h * box + h) {  // the centre's position is skipped
          acc = fmaf(a, b, acc);
          acc = fmaf(e, d, acc);
        }
      }
    }
    if (lane != 0 || !(acc > min_ng)) continue;
    const size_t o = ((size_t)blockIdx.z * Ty + y / T) * Tx + x / T;
    tile_mask[o] = 1;
    tile_loc[o] = (y % T) * T + x % T;
    tile_ng[o] = 0.0f + acc;  // a sum over the one hit
  }
#ifdef PICASSO_K4ANY_CLOCKS
  __syncthreads();
  K4ANY_MARK(6);
#endif
}

// The direct test, one thread a pixel through L1 (the first form of this
// kernel, off every path): a pixel tests its window's neighbours in
// row-major order, leaving at the first that beats it, and forms the net
// gradient only where it is a maximum.
template <typename Tin>
__global__ void __launch_bounds__(256) identify_any_direct_kernel(
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

bool valid(long long B, long long Y, long long X, int box) {
  return B > 0 && B <= 65535 && Y > 0 && X > 0 && Y * X <= INT_MAX &&
         box >= 3;
}

}  // namespace

// Tile (mask, loc, ng) of B frames (B, Y, X) at any box >= 3, each output
// (B, ceil(Y/T), ceil(X/T)), zero before the launch: mask u8, loc i32, ng
// f32. dtype 0: uint16 frames, 1: float32 frames. uy, ux: the (box, box)
// unit vectors on the card. A block takes an oy x ox output tile, ox = 2^
// lg_ox (32 to 256), oy >= 1, whose shared bytes stay within what a
// block may opt in to on the card (232,448 on an H100).
// Returns cudaErrorInvalidValue for arguments it does not take, else
// cudaGetLastError() after the launch.
extern "C" int picasso_identify_anybox(const void* frames, int dtype,
                                       long long B, long long Y, long long X,
                                       int box, float min_ng, const void* uy,
                                       const void* ux, int oy, int lg_ox,
                                       void* tile_mask, void* tile_loc,
                                       void* tile_ng, void* stream) {
  if (!valid(B, Y, X, box) || oy < 1 || lg_ox < 5 || lg_ox > 8)
    return (int)cudaErrorInvalidValue;
  const long long ox = 1LL << lg_ox;
  const Layout layout(box, oy, (int)ox);
  const long long gy = (Y + oy - 1) / oy;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (layout.bytes > limit || gy > 65535) return (int)cudaErrorInvalidValue;
  const int smem = (int)layout.bytes;
  const long long T = box / 2 + 1;
  const int Ty = (int)((Y + T - 1) / T), Tx = (int)((X + T - 1) / T);
  const dim3 grid((unsigned)((X + ox - 1) / ox), (unsigned)gy, (unsigned)B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vy = static_cast<const float*>(uy);
  const float* vx = static_cast<const float*>(ux);
  unsigned char* m = static_cast<unsigned char*>(tile_mask);
  int* l = static_cast<int*>(tile_loc);
  float* g = static_cast<float*>(tile_ng);
  if (dtype == 0) {
    const auto kernel = identify_any_kernel<uint16_t>;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const uint16_t*>(frames), (int)Y, (int)X, box, min_ng,
        vy, vx, m, l, g, Ty, Tx, oy, lg_ox);
  } else if (dtype == 1) {
    const auto kernel = identify_any_kernel<float>;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(frames), (int)Y, (int)X, box, min_ng, vy,
        vx, m, l, g, Ty, Tx, oy, lg_ox);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The direct kernel's tiles, with picasso_identify_anybox's arguments but
// the tile shape.
extern "C" int picasso_identify_anybox_direct(
    const void* frames, int dtype, long long B, long long Y, long long X,
    int box, float min_ng, const void* uy, const void* ux, void* tile_mask,
    void* tile_loc, void* tile_ng, void* stream) {
  if (!valid(B, Y, X, box)) return (int)cudaErrorInvalidValue;
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
    identify_any_direct_kernel<<<grid, threads, 0, st>>>(
        static_cast<const uint16_t*>(frames), (int)Y, (int)X, box, min_ng,
        vy, vx, m, l, g, Ty, Tx);
  else if (dtype == 1)
    identify_any_direct_kernel<<<grid, threads, 0, st>>>(
        static_cast<const float*>(frames), (int)Y, (int)X, box, min_ng, vy,
        vx, m, l, g, Ty, Tx);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

#ifdef PICASSO_K4ANY_CLOCKS
// The summed cycles of each step of identify_any_kernel (0-5) and the
// blocks counted (7) since the last call, into out[8]; zeroes them.
extern "C" int picasso_identify_anybox_clocks(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k4any_clocks,
                                         8 * sizeof(unsigned long long));
  const unsigned long long zero[8] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(k4any_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif
