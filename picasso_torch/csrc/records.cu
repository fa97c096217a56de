// apply_drift on the card (sm_90a): locs records rewritten with the
// per-frame drift subtracted from x, y (and z), record by record, in
// the byte layout numpy gives the output.
//
// Replaces no TPU kernel: the JAX package's apply_drift
// (picasso_tpu/postprocess.py:1351) is pandas on the host. It exists
// because the host's field-by-field rewrite of a structured array (a
// strided pass over every record for each of its fields) took ~2 s of a
// ~2.6 s RCC correction of 6.1 M MLE locs, while the records cross PCIe
// once each way in a tenth of that (ops/records.py).
//
// What bounds it on the card: bytes (each input record read once, each
// output record written once; the drift table, (frames, k) f64, stays in
// L2). The design: a block takes a tile of `tile` consecutive records
// (a multiple of 16, so each tile's input and output spans start
// 16-B aligned), stages the tile's contiguous input span in shared memory
// with 16-B loads, lets each thread assemble whole output records there
// from the layout's segments, then writes the tile's contiguous output
// span with 16-B stores; the ragged ends of the last tile go by bytes.
// Segments (ops/records.drift_layout) are rows (kind, in_off, out_off,
// bytes, column): kind 0 copies a run of bytes; kind 1 reads an f32 or
// f64 (`bytes` 4 or 8) and writes the f64 (double)v - drift[row * k +
// column], which rounds as numpy's f32 -> f64 promotion and f64
// subtraction do. The row is the record's frame, read at its offset as
// an integer of 1, 2, 4 or 8 bytes (signed or not); a negative frame of
// a signed type counts from the end, as numpy's indexing does, and a
// frame outside [-frames, frames) sets *bad (the wrapper raises
// IndexError). Shared memory is read and written in words of `gran`
// bytes (4, 2 or 1: the largest that every offset, run and record size
// is a multiple of), little-endian, as host and card both are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRecordThreads = 256;

template <int G> struct Word;
template <> struct Word<1> { using T = unsigned char; };
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<4> { using T = unsigned int; };

template <int G>
__device__ __forceinline__ void copy_words(unsigned char* dst,
                                           const unsigned char* src,
                                           int nbytes) {
  using W = typename Word<G>::T;
  W* d = reinterpret_cast<W*>(dst);
  const W* s = reinterpret_cast<const W*>(src);
  for (int i = 0; i < nbytes / G; ++i) d[i] = s[i];
}

// the nbytes (<= 8) at src as a little-endian integer
template <int G>
__device__ __forceinline__ unsigned long long load_bits(
    const unsigned char* src, int nbytes) {
  using W = typename Word<G>::T;
  const W* s = reinterpret_cast<const W*>(src);
  unsigned long long bits = 0;
  for (int i = 0; i < nbytes / G; ++i)
    bits |= static_cast<unsigned long long>(s[i]) << (8 * G * i);
  return bits;
}

template <int G>
__device__ __forceinline__ void store_f64(unsigned char* dst, double v) {
  using W = typename Word<G>::T;
  const unsigned long long bits =
      static_cast<unsigned long long>(__double_as_longlong(v));
  W* d = reinterpret_cast<W*>(dst);
#pragma unroll
  for (int i = 0; i < 8 / G; ++i) d[i] = static_cast<W>(bits >> (8 * G * i));
}

// The drift table's row of the frame at src; false where it is out of
// bounds.
__device__ __forceinline__ bool frame_row(const unsigned char* src,
                                          int size, int is_signed,
                                          long long n_frames,
                                          long long* row) {
  const unsigned long long bits = load_bits<1>(src, size);
  long long f;
  if (is_signed && size < 8) {
    const int shift = 64 - 8 * size;
    f = static_cast<long long>(bits << shift) >> shift;
  } else {
    f = static_cast<long long>(bits);
    // an unsigned 64-bit frame of 2^63 or more
    if (!is_signed && f < 0) return false;
  }
  if (f < 0) f += n_frames;
  *row = f;
  return f >= 0 && f < n_frames;
}

template <int G>
__global__ void __launch_bounds__(kRecordThreads) apply_drift_kernel(
    const unsigned char* __restrict__ in, long long n, int in_size,
    unsigned char* __restrict__ out, int out_size,
    const int* __restrict__ segs, int n_segs, int frame_off, int frame_size,
    int frame_signed, const double* __restrict__ drift, long long n_frames,
    int k, int tile, int* __restrict__ bad) {
  extern __shared__ uint4 smem[];
  unsigned char* s_in = reinterpret_cast<unsigned char*>(smem);
  unsigned char* s_out = s_in + tile * in_size;
  int* s_seg = reinterpret_cast<int*>(s_out + tile * out_size);
  for (int i = threadIdx.x; i < 5 * n_segs; i += blockDim.x)
    s_seg[i] = segs[i];

  const long long r0 = static_cast<long long>(blockIdx.x) * tile;
  const int count = static_cast<int>(min(static_cast<long long>(tile),
                                         n - r0));
  const unsigned char* g_in = in + r0 * in_size;
  const int in_span = count * in_size;
  const uint4* g_in16 = reinterpret_cast<const uint4*>(g_in);
  for (int i = threadIdx.x; i < in_span / 16; i += blockDim.x)
    smem[i] = __ldcs(g_in16 + i);
  for (int i = in_span / 16 * 16 + threadIdx.x; i < in_span; i += blockDim.x)
    s_in[i] = g_in[i];
  __syncthreads();

  bool any_bad = false;
  for (int r = threadIdx.x; r < count; r += blockDim.x) {
    const unsigned char* src = s_in + r * in_size;
    unsigned char* dst = s_out + r * out_size;
    long long row = 0;
    bool ok = true, have_row = false;
    for (int s = 0; s < n_segs; ++s) {
      const int* e = s_seg + 5 * s;
      if (e[0] == 0) {
        copy_words<G>(dst + e[2], src + e[1], e[3]);
        continue;
      }
      if (!have_row) {
        ok = frame_row(src + frame_off, frame_size, frame_signed, n_frames,
                       &row);
        any_bad |= !ok;
        have_row = true;
      }
      const unsigned long long bits = load_bits<G>(src + e[1], e[3]);
      const double v = e[3] == 4
          ? static_cast<double>(__int_as_float(static_cast<int>(bits)))
          : __longlong_as_double(static_cast<long long>(bits));
      const double d = ok ? drift[row * k + e[4]] : 0.0;
      store_f64<G>(dst + e[2], v - d);
    }
  }
  if (any_bad) *bad = 1;
  __syncthreads();

  unsigned char* g_out = out + r0 * out_size;
  const int out_span = count * out_size;
  uint4* g_out16 = reinterpret_cast<uint4*>(g_out);
  const uint4* s_out16 = reinterpret_cast<const uint4*>(s_out);
  for (int i = threadIdx.x; i < out_span / 16; i += blockDim.x)
    __stcs(g_out16 + i, s_out16[i]);
  for (int i = out_span / 16 * 16 + threadIdx.x; i < out_span;
       i += blockDim.x)
    g_out[i] = s_out[i];
}

}  // namespace

// in:    (n, in_size) records, 16-B aligned; out: (n, out_size), 16-B
//        aligned; segs: (n_segs, 5) int32 on the card; drift: (n_frames,
//        k) f64; tile: records a block, a multiple of 16, whose shared
//        memory tile * (in_size + out_size) + 20 * n_segs the wrapper
//        keeps within 48 KB; gran: 4, 2 or 1; bad: one int32, zeroed.
// Returns cudaGetLastError() after the launch.
extern "C" int picasso_apply_drift_records(
    const void* in, long long n, int in_size, void* out, int out_size,
    const int* segs, int n_segs, int frame_off, int frame_size,
    int frame_signed, const double* drift, long long n_frames, int k,
    int tile, int gran, int* bad, void* stream) {
  const long long blocks = (n + tile - 1) / tile;
  const size_t shared = static_cast<size_t>(tile) * (in_size + out_size) +
                        sizeof(int) * 5 * n_segs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const unsigned char*>(in);
  auto* dst = static_cast<unsigned char*>(out);
#define PICASSO_APPLY_DRIFT(G)                                              \
  apply_drift_kernel<G><<<static_cast<unsigned>(blocks), kRecordThreads,    \
                          shared, s>>>(                                     \
      src, n, in_size, dst, out_size, segs, n_segs, frame_off, frame_size,  \
      frame_signed, drift, n_frames, k, tile, bad)
  switch (gran) {
    case 4: PICASSO_APPLY_DRIFT(4); break;
    case 2: PICASSO_APPLY_DRIFT(2); break;
    case 1: PICASSO_APPLY_DRIFT(1); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PICASSO_APPLY_DRIFT
  return static_cast<int>(cudaGetLastError());
}
