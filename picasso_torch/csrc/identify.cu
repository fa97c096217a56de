// K4: spot identification on frame tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel picasso_tpu/ops/identify_pallas.py:58
// _identify_band_kernel (identify_tiles_pallas). It computes the same
// function as picasso_torch/ops/identify.identify_tiles_plain:
//   - first-argmax local maxima: a centre is strictly greater than every
//     EARLIER pixel of its (box, box) window in row-major order and >=
//     every later one; a NaN in the window means "not a maximum";
//   - the net gradient: sum over the window of the central-difference
//     gradient (gy, gx) dotted with unit vectors pointing at the centre,
//     where row/col -1 wraps to Y-1/X-1 (the reference's numba
//     negative-index quirk);
//   - eligibility h <= y < Y-h-1 and h <= x < X-h-1 (the reference's
//     extra -1 on the high border), then ng > minimum_ng;
//   - the reduction of each aligned (T, T) tile, T = h+1, to (mask, loc =
//     ly*T+lx, ng). Hits are at least h+1 apart, so a tile holds at most
//     one, and the tile's ng is its hit's (0 without one).
//
// What bounds it on the card: the FP32 pipe. The net gradient is
// 2 (box^2 - 1) FMAs a pixel (96 at box 7) in a fixed order, against 2
// bytes read a pixel (u16) and 9 bytes written a tile; with the gradient
// differences that is 117 of the ~200 instructions a pixel the box-7
// instance issues. The first port tested one centre a thread, reading
// its whole window from shared memory (~144 shared loads a pixel), and
// was bound by the shared-memory load pipe instead.
//
// The design: column strips.
//   - A block is WARPS whole warps side by side. Lane l of warp w owns
//     centre column w*CW + l, CW = 32/T*T, so a warp holds whole tiles;
//     its 32 - CW spare lanes (none at boxes 3, 7, 15) stage pixels and
//     mirror the warp's last column, but find no hit. Each thread owns
//     R = RT*T consecutive rows of its column.
//   - The block stages its (R + 2h + 2) x (C + 2h + 2) pixels as f32 in
//     shared memory once, coalesced row by row. Indices within a frame
//     are 32-bit (the entry refuses frames of 2^31 pixels or more) and
//     wrap by one conditional add or subtract; frames smaller than the
//     halo take an exact modulo.
//   - Each thread walks its strip top to bottom. Each pixel row's box + 2
//     pixels are read from shared memory once into a three-row register
//     ring (neighbouring lanes read neighbouring words: no bank
//     conflicts), gy/gx are formed there, and each gradient is FMA'd into
//     every accumulator whose window covers it. A centre's FMAs keep the
//     order i, j ascending, gy before gx, one fmaf each, so ng is the
//     same float whatever R or WARPS are: (R + 2h + 2)(box + 2) / R
//     shared loads a centre (15 at box 7, R = 12) instead of ~144. The
//     unit vectors are computed on the host in IEEE f32 (as the plain
//     version's numpy does) and passed as a kernel parameter, so every
//     FMA reads its weight from the constant bank.
//   - Maxima from separable exact maxima, NaN-propagating (PTX
//     max.NaN.f32): per row, the max of the window row's left part, its
//     right part and the whole; a centre's 'above' and 'below' are the
//     max of the whole-row maxima over the h rows before and after it.
//   - The tile reduction: as a tile row of the strip completes, one warp
//     ballot finds the tile's hit, two shuffles bring its row and ng to
//     the tile's first lane, and that lane writes the tile.
//
// Compile-time knobs (tests/torch_k4_sweep.py builds variants of this file
// alone): PICASSO_K4_RT (strip rows in tiles), PICASSO_K4_WARPS (warps a
// block), PICASSO_K4_ONLY_BOX (build one box). Forming gy/gx in registers
// beat reading them from shared gradient arrays by 19-35% in that sweep.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifndef PICASSO_K4_RT
#define PICASSO_K4_RT 3
#endif
#ifndef PICASSO_K4_WARPS
#define PICASSO_K4_WARPS 2
#endif
#ifdef PICASSO_K4_ONLY_BOX
#define PICASSO_K4_BOXES(M) M(PICASSO_K4_ONLY_BOX)
#else
#define PICASSO_K4_BOXES(M) M(3) M(5) M(7) M(9) M(11) M(13) M(15)
#endif

namespace {

constexpr int kWarps = PICASSO_K4_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <int BOX>
struct Geometry {
  static constexpr int H = BOX / 2;
  static constexpr int T = H + 1;
  static constexpr int CW = 32 / T * T;  // centre columns a warp
  static constexpr int C = kWarps * CW;  // centre columns a block
  // strip rows in tiles; fewer at large boxes, so that a strip's unrolled
  // FMAs (R * 2 (box^2 - 1)) stay under 4096
  static constexpr int RT_CAP =
      2048 / (T * BOX * BOX) > 0 ? 2048 / (T * BOX * BOX) : 1;
  static constexpr int RT = PICASSO_K4_RT < RT_CAP ? PICASSO_K4_RT : RT_CAP;
  static constexpr int R = RT * T;  // centre rows a block
  static constexpr int PY = R + 2 * H + 2, PX = C + 2 * H + 2;  // pixels
  static constexpr int SMEM = 4 * PY * PX;
  static_assert(SMEM <= 48 * 1024, "K4 block exceeds static shared memory");
};

// unit vectors from window position (i, j) toward the centre; 0 at it
template <int BOX>
struct UnitVectors {
  float y[BOX][BOX], x[BOX][BOX];
};

template <int BOX>
UnitVectors<BOX> unit_vectors() {
  constexpr int H = BOX / 2;
  UnitVectors<BOX> u;
  for (int i = 0; i < BOX; ++i)
    for (int j = 0; j < BOX; ++j) {
      const float vy = (float)(H - i), vx = (float)(H - j);
      const float nrm = sqrtf(vx * vx + vy * vy);
      const bool centre = i == H && j == H;
      u.y[i][j] = centre ? 0.0f : vy / nrm;
      u.x[i][j] = centre ? 0.0f : vx / nrm;
    }
  return u;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  return static_cast<float>(v);
}

// max that returns NaN when either operand is NaN (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// v modulo n, in [0, n): one conditional add or subtract covers every
// index of a frame at least as large as the halo; smaller frames take
// the exact modulo
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

template <int BOX, typename Tin>
__global__ void __launch_bounds__(kThreads)
    identify_kernel(const Tin* __restrict__ frames, int Y, int X,
                    float min_ng, const UnitVectors<BOX> u,
                    unsigned char* __restrict__ tile_mask,
                    int* __restrict__ tile_loc, float* __restrict__ tile_ng,
                    int Ty, int Tx) {
  using G = Geometry<BOX>;
  constexpr int H = G::H, T = G::T, CW = G::CW, C = G::C, R = G::R;
  constexpr int PY = G::PY, PX = G::PX;
  constexpr int NQ = (PX + kThreads - 1) / kThreads;  // columns a thread
  __shared__ float pix[PY][PX];

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * R, x0 = blockIdx.x * C;
  const Tin* f = frames + (size_t)blockIdx.z * (size_t)Y * (size_t)X;

  // stage pixels (y0 - h - 1 + ly, x0 - h - 1 + lx), wrapped into the frame
  int col[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) col[q] = wrap(x0 - H - 1 + tid + q * kThreads, X);
#pragma unroll 4
  for (int ly = 0; ly < PY; ++ly) {
    const Tin* row = f + wrap(y0 - H - 1 + ly, Y) * X;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int lx = tid + q * kThreads;
      if (lx < PX) pix[ly][lx] = to_f32(row[col[q]]);
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const bool active = lane < CW;
  const int cx = warp * CW + (active ? lane : CW - 1);  // centre column
  const int x = x0 + cx;
  const bool col_ok = active && x >= H && x < X - H - 1;
  const int lead = lane / T * T;  // first lane of this lane's tile

  // pixel row ring: shared columns cx .. cx + box + 1 of rows k, k+1, k+2
  float prv[BOX + 2], cur[BOX + 2], nxt[BOX + 2];
#pragma unroll
  for (int c = 0; c < BOX + 2; ++c) {
    prv[c] = pix[0][cx + c];
    cur[c] = pix[1][cx + c];
  }
  float acc[R], above[R], below[R], centre[R];
  bool flag[R];
  bool thit = false;  // a hit in this column of the current tile row
  int tly = 0;
  float tng = 0.0f;

  // gradient row k: global row y0 - h + k, shared pixel row k + 1; it is
  // window row i = k - m of strip centre m
#pragma unroll
  for (int k = 0; k < R + 2 * H; ++k) {
    float gyv[BOX], gxv[BOX], row[BOX];
#pragma unroll
    for (int c = 0; c < BOX + 2; ++c) nxt[c] = pix[k + 2][cx + c];
#pragma unroll
    for (int j = 0; j < BOX; ++j) {
      gyv[j] = nxt[j + 1] - prv[j + 1];
      gxv[j] = cur[j + 2] - cur[j];
      row[j] = cur[j + 1];
    }
    float left = row[0];
#pragma unroll
    for (int j = 1; j < H; ++j) left = max_nan(left, row[j]);
    float right = row[H + 1];
#pragma unroll
    for (int j = H + 2; j < BOX; ++j) right = max_nan(right, row[j]);
    const float whole = max_nan(max_nan(left, row[H]), right);

#pragma unroll
    for (int i = 0; i < BOX; ++i) {
      const int m = k - i;
      if (m < 0 || m >= R) continue;
      if (i < H) {
        above[m] = i == 0 ? whole : max_nan(above[m], whole);
      } else if (i == H) {
        centre[m] = row[H];
        flag[m] = centre[m] > above[m] && centre[m] > left &&
                  centre[m] >= right;
      } else {
        below[m] = i == H + 1 ? whole : max_nan(below[m], whole);
      }
      if (i == 0) acc[m] = 0.0f;
#pragma unroll
      for (int j = 0; j < BOX; ++j) {
        if (i == H && j == H) continue;
        acc[m] = fmaf(gyv[j], u.y[i][j], acc[m]);
        acc[m] = fmaf(gxv[j], u.x[i][j], acc[m]);
      }
      if (i == BOX - 1) {  // centre m's window is complete
        const int y = y0 + m;
        const bool hit = col_ok && flag[m] && centre[m] >= below[m] &&
                         y >= H && y < Y - H - 1 && acc[m] > min_ng;
        if (hit) {
          thit = true;
          tly = m % T;
          tng = acc[m];
        }
      }
    }

    // a tile row is complete with its last centre
    const int done = k - (BOX - 1);
    if (done >= 0 && done % T == T - 1) {
      const unsigned seg =
          (__ballot_sync(kFull, thit) >> lead) & ((1u << T) - 1u);
      const int j = __ffs(seg) - 1;  // the hit's column in the tile
      const int src = seg ? lead + j : lane;
      const int hly = __shfl_sync(kFull, tly, src);
      const float hng = __shfl_sync(kFull, tng, src);
      const int tyg = y0 / T + done / T, txg = (x0 + warp * CW + lead) / T;
      if (active && lane == lead && tyg < Ty && txg < Tx) {
        const size_t o = ((size_t)blockIdx.z * Ty + tyg) * Tx + txg;
        tile_mask[o] = seg != 0;
        tile_loc[o] = seg ? hly * T + j : 0;
        tile_ng[o] = seg ? 0.0f + hng : 0.0f;  // a sum over the one hit
      }
      thit = false;
    }
#pragma unroll
    for (int c = 0; c < BOX + 2; ++c) {
      prv[c] = cur[c];
      cur[c] = nxt[c];
    }
  }
}

template <int BOX, typename Tin>
int launch(const Tin* frames, long long B, long long Y, long long X,
           float min_ng, unsigned char* mask, int* loc, float* ng,
           cudaStream_t stream) {
  using G = Geometry<BOX>;
  const long long Ty = (Y + G::T - 1) / G::T, Tx = (X + G::T - 1) / G::T;
  const long long gx = (X + G::C - 1) / G::C, gy = (Y + G::R - 1) / G::R;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  static const UnitVectors<BOX> u = unit_vectors<BOX>();
  identify_kernel<BOX, Tin>
      <<<dim3((unsigned)gx, (unsigned)gy, (unsigned)B), kThreads, 0,
         stream>>>(frames, (int)Y, (int)X, min_ng, u, mask, loc, ng, (int)Ty,
                   (int)Tx);
  return (int)cudaGetLastError();
}

template <int BOX, typename Tin>
int describe(int* info) {
  using G = Geometry<BOX>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, identify_kernel<BOX, Tin>);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, identify_kernel<BOX, Tin>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const int v[7] = {kThreads,     G::R,
                    G::C,         (int)attr.sharedSizeBytes,
                    attr.numRegs, (int)attr.localSizeBytes,
                    per_sm};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
  return 0;
}

template <typename Tin>
int dispatch(const Tin* frames, long long B, long long Y, long long X,
             int box, float min_ng, unsigned char* mask, int* loc, float* ng,
             cudaStream_t stream) {
  switch (box) {
#define PICASSO_K4_CASE(S) \
  case S:                  \
    return launch<S, Tin>(frames, B, Y, X, min_ng, mask, loc, ng, stream);
    PICASSO_K4_BOXES(PICASSO_K4_CASE)
#undef PICASSO_K4_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename Tin>
int describe_box(int box, int* info) {
  switch (box) {
#define PICASSO_K4_CASE(S) \
  case S:                  \
    return describe<S, Tin>(info);
    PICASSO_K4_BOXES(PICASSO_K4_CASE)
#undef PICASSO_K4_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  if (B <= 0 || B > 65535 || Y <= 0 || X <= 0 || Y * X > INT_MAX)
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

// What the kernel instance for a dtype (0 u16, 1 f32) and box is on the
// current card, as int info[7]: threads a block, centre rows and columns
// a block, static shared bytes, registers and local (spill) bytes a
// thread, resident blocks per SM.
extern "C" int picasso_identify_info(int dtype, int box, int* info) {
  if (info == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return describe_box<uint16_t>(box, info);
  if (dtype == 1) return describe_box<float>(box, info);
  return (int)cudaErrorInvalidValue;
}
