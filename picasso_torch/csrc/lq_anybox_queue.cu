// The Levenberg-Marquardt fit at any box as one work-queue launch
// (sm_90a): what roi_lq_queue.cu (lq_queue.cuh) does at the templated
// boxes 3-15, for every other box >= 1 (1, 2, even, or above 15), on a
// lanes-last (s, s, N) f32 ROI batch, the box a launch argument.
//
// Replaces, at the boxes that lq_fit.cu and roi_lq_queue.cu are not built
// for, the Pallas TPU kernels of picasso_tpu/ops/lq_pallas.py:
//   K3  _tile_kernel :25 (fit_pallas_t, called at :54);
//   K6  _lm_start_kernel :93, _lm_resume_kernel :108
//       (fit_pallas_boundary_t, called at :159/:179): one launch, which
//       the phases equal by construction;
// and, fed by cut_anybox.cu's ROIs, the LM half of K5
// (picasso_tpu/ops/winfit_pallas.py :96 _lq_kernel, called at :168).
//
// What bounds it on the card: issued instructions (6,636 FLOPs an LM step
// of a box-17 spot), not bytes. Its first form (lq_anybox.cu, one thread
// a spot, off every path since) lost its time three ways: a warp lasted
// as long as the slowest of its 32 spots; every step read each pixel
// twice and seven axis-factor rows from global memory, ~780 loads from
// L1/L2 a spot-step at box 17; and its per-spot arrays spilled. The
// design:
//   - groups: G = 8 lanes step one spot (PICASSO_LQANY_GROUP, a
//     compile-time constant: 4, 8, 16 or 32), their lanes looping over
//     the points and rows, G a round. Lane
//     k forms axis point k of both axes and row k's column sums of J^T r
//     and of the cost; the rows are folded in row order by shuffles of
//     the row sums (the operands, not their products), fit_lq.cuh's
//     jtr_fold and the cost's __fadd_rn chain; each of the 20
//     one-dimensional dot sums of J^T J is formed over k in order by one
//     lane and broadcast; every lane then runs normal_assemble,
//     damped_trial and lm_accept with the same arithmetic, so the group
//     holds one theta (lq_queue.cuh's tail). A warp steps 4 spots side by
//     side: the serial part of a step (the fold, the dot sums, the damped
//     Cholesky solve with its divisions and square roots) is issued once
//     for 4 spots, not once a spot as a group of 32 would;
//   - the stage: a group's spot is staged once in dynamic shared memory
//     (s rows of an odd stride s | 1, so the lanes reading one column of
//     s rows fall on distinct banks, the warp's 4 groups too at box 17)
//     beside its seven axis-factor rows (0-2 gx, dgx, dsx and 3-5 gy, dgy,
//     dsy of the normal equations, 6 the trial's gx of the cost): 1,632 B
//     at box 17, where a lane a spot would need 52 KB a warp. Where a
//     warp's groups' stages pass the shared bytes a block may hold (box
//     >= 118), the groups read the pixels from the batch;
//   - the claim: the free groups of a warp claim consecutive spots from a
//     device counter with one atomicAdd once all of them are free
//     (PICASSO_LQANY_REFILL, by default 32 / G: so that their stages and
//     initialisers run side by side instead of one after the other while
//     the other groups wait), stage them, run the initialiser (the
//     background as row minima folded in row order, exact for a
//     NaN-propagating minimum; the moment sums on the group's lane 0 in
//     the one-thread order) and form the cost, then step them; when a
//     spot ends (done, or max_it steps) lane 0 of its group writes
//     theta. Spots at index >= n_valid start done. A group without a
//     spot shadows the first busy group of its warp (its theta, damping
//     and flags by shuffle, its pixels from that group's stage) and
//     writes nothing: garbage operands would send the divisions and
//     square roots down their slow paths, which the warp would wait for.
// Each spot runs the pieces of fit_lq.cuh in the one-thread order with
// the same explicitly rounded operations, so theta equals the one-thread
// pass (lq_anybox.cu) bit for bit, and through it the templated K3 queue
// at 5-15 (chip_smoke.py holds both).
//
// Measured (tests/torch_anybox_sweep.py, 131,072 make_spots a box,
// medians in rounds; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): the
// chosen configuration 2.349 / 2.522 / 3.244 ms at boxes 17 / 16 / 21,
// the one-thread pass 4.385 / 4.365 / 7.318 in the same rounds; groups of
// 32 (the least power of two >= the box) 4.625 at 17, of 4 2.345, each
// group claiming alone 3.480; a lane a spot (the measured alternative:
// its spot and factor rows staged, the tail in groups; removed) 2.796
// against 2.323-2.392 for the groups in one run. The clocks of a box-17
// trip (a warp's 4 spots; the build without a bound on its registers):
// claim 52, stage 834, initialiser 1,613, axis points 596, rows and fold
// 2,551, dot sums and solve 3,812, cost 4,025, the rest 707 cycles.
//
// Launch arguments (where the pixels live, threads a block), worked out
// from the box by picasso_torch/ops/lq_cuda.anybox_queue_config; this
// entry checks them. The group and the claim are compile-time constants
// (tests/torch_anybox_sweep.py builds the others with -D).
// With PICASSO_LQANY_CLOCKS (tests/torch_anybox_sweep.py builds this file
// so) lane 0 of each warp sums the clock cycles of each part of a trip
// (read with picasso_lq_anybox_queue_clocks).

#include "fit_lq_any.cuh"

namespace {

constexpr unsigned kLqAnyAll = 0xffffffffu;
constexpr int kLqAnyMaxThreads = 128;
// __launch_bounds__' minimum resident blocks a SM: 6 holds a thread to
// 80 registers (32 B spilled), faster than the unbounded build's 120 at
// boxes 16 and 17 and within 3% at 21; 8 (64 registers) wins at 17 and
// loses 9% at 21 (tests/torch_anybox_sweep.py builds the others)
#ifndef PICASSO_LQANY_MIN_BLOCKS
#define PICASSO_LQANY_MIN_BLOCKS 6
#endif
// lanes a group: 8 beat 16 and 32 at boxes 16, 17 and 21 and tied 4
// (tests/torch_anybox_sweep.py builds the others)
#ifndef PICASSO_LQANY_GROUP
#define PICASSO_LQANY_GROUP 8
#endif
constexpr int kLqAnyGroup = PICASSO_LQANY_GROUP;
static_assert(kLqAnyGroup == 4 || kLqAnyGroup == 8 || kLqAnyGroup == 16 ||
                  kLqAnyGroup == 32,
              "a group is 4, 8, 16 or 32 lanes");
// the free groups of a warp that claim together: all of them (32 / G);
// each alone (1) took 3.48 ms at box 17 against 2.35
// (tests/torch_anybox_sweep.py)
#ifndef PICASSO_LQANY_REFILL
#define PICASSO_LQANY_REFILL (32 / PICASSO_LQANY_GROUP)
#endif
constexpr int kLqAnyRefill = PICASSO_LQANY_REFILL;
static_assert(kLqAnyRefill >= 1 && kLqAnyRefill <= 32 / kLqAnyGroup,
              "a claim takes 1 .. 32 / G free groups");
// where a group reads its spot's pixels: the lanes-last batch, a stage in
// shared memory
enum { kLqBatch = 0, kLqShared = 1 };
constexpr int kLqAnyInfo = 7;

#ifdef PICASSO_LQANY_CLOCKS
// summed cycles: 0 the claim, 1 the stage, 2 the initialiser, 3 axis
// points, 4 rows and fold, 5 dot sums, assembly, damped step and
// acceptance, 6 cost, 7 the rest; counts: 8 trips, 9 warps
constexpr int kLqClocks = 10;
__device__ unsigned long long lqany_clocks[kLqClocks];
struct LqClock {
  long long t;
  unsigned long long c[kLqClocks];
  __device__ __forceinline__ void start() {
    t = clock64();
    for (int k = 0; k < kLqClocks; ++k) c[k] = 0;
  }
  __device__ __forceinline__ void mark(int k) {
    const long long now = clock64();
    c[k] += (unsigned long long)(now - t);
    t = now;
  }
  __device__ __forceinline__ void count(int k) { ++c[k]; }
  __device__ __forceinline__ void flush() {
    if ((threadIdx.x & 31) == 0)
      for (int k = 0; k < kLqClocks; ++k) atomicAdd(lqany_clocks + k, c[k]);
  }
};
#else
struct LqClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void count(int) {}
  __device__ __forceinline__ void flush() {}
};
#endif

// A group's spot: its pixels (y, x) at p[y * rs + x] in a stage, or
// through the read-only cache from the lanes-last batch at p[(y * s + x)
// * rs] (p = spots + n, rs = N).
template <int PX>
struct GroupPx {
  const float* p;
  long long rs;
  int s;
  __device__ __forceinline__ float operator()(int y, int x) const {
    if constexpr (PX == kLqShared)
      return p[y * (int)rs + x];
    else
      return __ldg(p + (long long)(y * s + x) * rs);
  }
};

// loads a lane has in flight while it stages a spot
constexpr int kLqStageBatch = 16;

// lane src of a group of G
template <int G>
__device__ __forceinline__ float gshfl(float v, int src) {
  return __shfl_sync(kLqAnyAll, v, src, G);
}

// Dot sum d of J^T J's 1D products (dot_point's sa for d < 10, then sb),
// over k in order from the factor rows f: row factors {gy, dgy, 1, dsy}
// (rows 3, 4, ones, 5), column factors {dgx, gx, 1, dsx} (1, 0, ones,
// 2), pairs (u, v) with u <= v. A pair's rows are packed three bits a d
// (7: ones), so a lane's d picks them from registers.
// the pairs (u, v), two bits each a pair e < 10
constexpr unsigned kDotU = 0b11101001010100000000u;  // 0 0 0 0 1 1 1 2 2 3
constexpr unsigned kDotV = 0b11111011100111100100u;    // 0 1 2 3 1 2 3 2 3 3
constexpr unsigned long long dot_rows(bool second) {
  const int ra[4] = {3, 4, 7, 5}, cb[4] = {1, 0, 7, 2};
  unsigned long long w = 0;
  for (int d = 0; d < 20; ++d) {
    const int* r = d < 10 ? ra : cb;
    const int e = d < 10 ? d : d - 10;
    w |= (unsigned long long)r[((second ? kDotV : kDotU) >> (2 * e)) & 3]
         << (3 * d);
  }
  return w;
}
constexpr unsigned long long kDotRowU = dot_rows(false);
constexpr unsigned long long kDotRowV = dot_rows(true);

__device__ __forceinline__ float dot_sum(const float* f, int s, int d) {
  const int ru = (int)(kDotRowU >> (3 * d)) & 7;
  const int rv = (int)(kDotRowV >> (3 * d)) & 7;
  const float* pu = f + min(ru, 5) * s;
  const float* pv = f + min(rv, 5) * s;
  float acc = __fmul_rn(ru == 7 ? 1.0f : pu[0], rv == 7 ? 1.0f : pv[0]);
  for (int k = 1; k < s; ++k)
    acc = __fmaf_rn(ru == 7 ? 1.0f : pu[k], rv == 7 ? 1.0f : pv[k], acc);
  return acc;
}

// Dot sums gl, gl + G, ... (< 20) into out[0..D-1], over k in order.
template <int G, int D>
__device__ __forceinline__ void dot_sums(const float* f, int s, int gl,
                                         float* out) {
  if constexpr (D > 4) {  // groups of 4: one sum after the other
#pragma unroll
    for (int t = 0; t < D; ++t) out[t] = dot_sum(f, s, min(t * G + gl, 19));
    return;
  }
  const float* pu[D];
  const float* pv[D];
  bool ou[D], ov[D];
#pragma unroll
  for (int t = 0; t < D; ++t) {
    const int d = min(t * G + gl, 19);
    const int ru = (int)(kDotRowU >> (3 * d)) & 7;
    const int rv = (int)(kDotRowV >> (3 * d)) & 7;
    pu[t] = f + min(ru, 5) * s;
    pv[t] = f + min(rv, 5) * s;
    ou[t] = ru == 7;
    ov[t] = rv == 7;
    out[t] = __fmul_rn(ou[t] ? 1.0f : pu[t][0], ov[t] ? 1.0f : pv[t][0]);
  }
  for (int k = 1; k < s; ++k)
#pragma unroll
    for (int t = 0; t < D; ++t)
      out[t] = __fmaf_rn(ou[t] ? 1.0f : pu[t][k], ov[t] ? 1.0f : pv[t][k],
                         out[t]);
}

// The normal equations of a group's spot at theta th (any_normal_
// equations' numbers), spread over its G lanes (gl = 0..G-1), the
// group's factor rows at f; every lane ends with the same (a, jtr),
// stored only where upd.
template <int G, class Px>
__device__ __forceinline__ void grp_normal_equations(
    const Px& px, float* f, int s, int gl, const float* th, bool upd,
    float* a, float* jtr, LqClock& clk) {
  const int half = s / 2;
  const float ix = __fdiv_rn(1.0f, th[4]), iy = __fdiv_rn(1.0f, th[5]);
  __syncwarp();  // the last reads of the rows
  for (int k = gl; k < s; k += G) {
    float g, dg, ds;
    axis_point<true>(half, k, th[0], ix, g, dg, ds);
    f[k] = g;
    f[s + k] = dg;
    f[2 * s + k] = ds;
    axis_point<true>(half, k, th[1], iy, g, dg, ds);
    f[3 * s + k] = g;
    f[4 * s + k] = dg;
    f[5 * s + k] = ds;
  }
  __syncwarp();
  clk.mark(3);
  const float ph = th[2], bg = th[3];
  float jd[6];
  const int rounds = (s + G - 1) / G;
  for (int r = 0; r < rounds; ++r) {
    const int j = min(r * G + gl, s - 1);  // this lane's row
    const float pg = __fmul_rn(ph, f[3 * s + j]);
    float c[4];
    jtr_pixel(true, px(j, 0), pg, bg, f[0], f[s], f[2 * s], c);
    for (int i = 1; i < s; ++i)
      jtr_pixel(false, px(j, i), pg, bg, f[i], f[s + i], f[2 * s + i], c);
    const int m = min(G, s - r * G);
#pragma unroll 4
    for (int jj = 0; jj < m; ++jj) {
      float cj[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) cj[q] = gshfl<G>(c[q], jj);
      const int row = r * G + jj;
      jtr_fold(row == 0, f[3 * s + row], f[4 * s + row], f[5 * s + row], cj,
               jd);
    }
  }
  clk.mark(4);
  // the 20 dot sums, lane gl forming those of index gl, gl + G, ...,
  // each over k in order, side by side
  constexpr int D = (20 + G - 1) / G;
  float mine[D];
  dot_sums<G, D>(f, s, gl, mine);
  float sa[4][4], sb[4][4];
#pragma unroll
  for (int d = 0; d < 20; ++d) {
    const float v = gshfl<G>(mine[d / G], d % G);
    const int e = d < 10 ? d : d - 10;
    const int u = (kDotU >> (2 * e)) & 3, w = (kDotV >> (2 * e)) & 3;
    if (d < 10)
      sa[u][w] = v;
    else
      sb[u][w] = v;
  }
  float na[21], nj[6];
  normal_assemble(sa, sb, ph, jd, na, nj);
#pragma unroll
  for (int p = 0; p < 21; ++p) a[p] = upd ? na[p] : a[p];
#pragma unroll
  for (int p = 0; p < 6; ++p) jtr[p] = upd ? nj[p] : jtr[p];
}

// The sum of squared residuals of a group's spot at theta th (any_cost's
// number): factor row 6 takes the x axis's factor, lane j forms row j's
// y factor and sum; every lane returns the total.
template <int G, class Px>
__device__ __forceinline__ float grp_cost(const Px& px, float* f, int s,
                                          int gl, const float* th) {
  const int half = s / 2;
  const float ix = __fdiv_rn(1.0f, th[4]), iy = __fdiv_rn(1.0f, th[5]);
  float unused;
  __syncwarp();
  for (int k = gl; k < s; k += G)
    axis_point<false>(half, k, th[0], ix, f[6 * s + k], unused, unused);
  __syncwarp();
  float total = 0.0f;
  const int rounds = (s + G - 1) / G;
  for (int r = 0; r < rounds; ++r) {
    const int j = min(r * G + gl, s - 1);
    float gy;
    axis_point<false>(half, j, th[1], iy, gy, unused, unused);
    const float pg = __fmul_rn(th[2], gy);
    float row = cost_pixel(true, px(j, 0), pg, th[3], f[6 * s], 0.0f);
    for (int i = 1; i < s; ++i)
      row = cost_pixel(false, px(j, i), pg, th[3], f[6 * s + i], row);
    const int m = min(G, s - r * G);
#pragma unroll 4
    for (int jj = 0; jj < m; ++jj) {
      const float v = gshfl<G>(row, jj);
      total = r == 0 && jj == 0 ? v : __fadd_rn(total, v);
    }
  }
  return total;
}

// The initialiser of a group's spot (any_lq_init_theta's numbers), the
// group's lanes gmask, its theta into th on each lane. The background is
// the NaN-propagating minimum over the pixels in row-major order, which
// selects the first NaN, else the last of the least values, however its
// pixels are bracketed: lane j forms row j's minimum in order, and lane 0
// folds the rows' minima in row order (through factor row 6). The moment
// sums are formed on lane 0 in the one-thread order, then theta goes to
// the group through factor row 0.
template <int G, class Px>
__device__ __forceinline__ void grp_init(const Px& px, float* f, int s,
                                         int gl, unsigned gmask, float* th) {
  for (int j = gl; j < s; j += G) {
    float m = px(j, 0);
    for (int x = 1; x < s; ++x) m = nmin(m, px(j, x));
    f[6 * s + j] = m;
  }
  __syncwarp(gmask);
  if (gl == 0) {
    float bg = f[6 * s];
    for (int j = 1; j < s; ++j) bg = nmin(bg, f[6 * s + j]);
    float total = 0.0f, ysum = 0.0f, xsum = 0.0f;
    for (int y = 0; y < s; ++y)
#pragma unroll 4
      for (int x = 0; x < s; ++x)
        lq_moments(y == 0 && x == 0, px(y, x) - bg, y, x, total, ysum, xsum);
    float y_com, x_com;
    lq_com(s, total, ysum, xsum, y_com, x_com);
    float syy = 0.0f, sxx = 0.0f;
    for (int y = 0; y < s; ++y)
#pragma unroll 4
      for (int x = 0; x < s; ++x)
        lq_moments2(y == 0 && x == 0, px(y, x) - bg, y, x, y_com, x_com, syy,
                    sxx);
    lq_init_store(s / 2, x_com, y_com, total, bg, sxx, syy, f);
  }
  __syncwarp(gmask);
#pragma unroll
  for (int p = 0; p < 6; ++p) th[p] = f[p];
  __syncwarp(gmask);  // before the group writes its factor rows again
}

// A spot's fit as a group carries it (the same on each of its lanes).
struct LqFit {
  float th[6];
  float lam, cst, done;
  int steps;
  bool fresh;  // the normal equations are to be formed (theta moved)
  bool init;   // the cost at the initial theta is still to be formed
};

// One trip of a group: the cost at the initial theta of a spot just
// taken, or one LM step (lm_step's pieces: the normal equations when
// theta moved, the damped step, the trial cost, the acceptance).
template <int G, class Px>
__device__ __forceinline__ void grp_trip(const Px& px, float* f, int s,
                                         int gl, float ftol, LqFit& q,
                                         float* a, float* jtr,
                                         LqClock& clk) {
  const bool form = !q.init && q.fresh;
  if (__any_sync(kLqAnyAll, form))
    grp_normal_equations<G>(px, f, s, gl, q.th, form, a, jtr, clk);
  float trial[6];
  bool finite = false;
  if (!q.init) {
    finite = damped_trial(a, jtr, q.th, q.lam, trial);
  } else {
#pragma unroll
    for (int p = 0; p < 6; ++p) trial[p] = q.th[p];
  }
  clk.mark(5);
  const float tc = grp_cost<G>(px, f, s, gl, trial);
  clk.mark(6);
  if (q.init) {
    q.cst = tc;
    q.init = false;
  } else {
    q.fresh = lm_accept(tc, finite, trial, q.th, q.lam, q.cst, q.done, ftol);
    ++q.steps;
  }
  clk.mark(5);
}

}  // namespace

// Arguments of one launch: n spots of the lanes-last (s, s, n) batch;
// area: floats of shared memory a group takes, its seven factor rows
// and, with a shared stage, its pixels; next: the claim counter, zero
// before the launch; theta (6, n) out.
struct LqAnyArgs {
  const float* spots;
  int n, n_valid;
  int s;
  float ftol;
  int max_it;
  int area;
  int* next;
  float* theta;
};

namespace {

// The pixels of the group (lane) of area ai: its stage, or the batch at
// its spot sn.
template <int PX>
__device__ __forceinline__ GroupPx<PX> area_px(const LqAnyArgs& a,
                                               float* smem, int ai, int sn) {
  if constexpr (PX == kLqShared)
    return GroupPx<PX>{smem + (long long)ai * a.area + 7 * a.s,
                       (long long)(a.s | 1), a.s};
  else
    return GroupPx<PX>{a.spots + sn, (long long)a.n, a.s};
}

// Stage spot sn's pixels in area ai's stage, the group's G lanes along
// the pixels.
template <int G>
__device__ __forceinline__ void stage_spot(const LqAnyArgs& a, float* smem,
                                           int ai, int sn, int gl) {
  const int s = a.s, rs = s | 1, nn = s * s;
  float* st = smem + (long long)ai * a.area + 7 * s;
  const float* src = a.spots + sn;
  constexpr int B = kLqStageBatch;
  // pixel p = gl + j * G at (y, x), stepped by (G / s, G % s)
  const int dy = G / s, dx = G % s;
  int y = gl / s, x = gl % s;
  for (int p0 = gl; p0 < nn; p0 += B * G) {
    float v[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int p = p0 + k * G;
      v[k] = p < nn ? __ldg(src + (long long)p * a.n) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (p0 + k * G < nn) st[y * rs + x] = v[k];
      y += dy;
      x += dx;
      if (x >= s) {
        x -= s;
        ++y;
      }
    }
  }
}

template <int G, int PX>
__global__ void __launch_bounds__(kLqAnyMaxThreads, PICASSO_LQANY_MIN_BLOCKS)
    lq_any_queue_kernel(const LqAnyArgs a) {
  extern __shared__ float smem[];
  LqClock clk;
  clk.start();
  const int s = a.s, N = a.n;
  const int lane = threadIdx.x & 31, gl = lane % G;
  const int ai = threadIdx.x / G;  // this group's area in the block
  const int lead = lane - gl;      // the group's lane 0
  float* const f = smem + (long long)ai * a.area;
  const unsigned gmask =
      G == 32 ? kLqAnyAll : ((1u << G) - 1u) << lead;  // the group's lanes
  bool drained = false;  // the counter has passed N (uniform in the warp)
  // the group's fit; its spot n (-1: none), the area and spot its pixels
  // come from (its own, or the group it shadows)
  LqFit q{{0.0f, 0.0f, 1.0f, 0.0f, 1.0f, 1.0f}, 1e-3f, 0.0f, 1.0f, 0,
          true, false};
  float aa[21] = {}, jtr[6] = {};
#pragma unroll
  for (int p = 0; p < 6; ++p) aa[p * (p + 1) / 2 + p] = 1.0f;
  int n = -1, src_area = ai, src_n = 0;
  clk.count(9);
  while (true) {
    const unsigned free_l = __ballot_sync(kLqAnyAll, gl == 0 && n < 0);
    const int nfree = __popc(free_l);
    if (!drained && nfree >= kLqAnyRefill) {
      // the free groups claim consecutive spots with one atomicAdd, in
      // the order of their lanes
      int base = 0;
      if (lane == 0) base = atomicAdd(a.next, nfree);
      base = __shfl_sync(kLqAnyAll, base, 0);
      drained = (long long)base + nfree >= N;
      const long long idx =
          (long long)base + __popc(free_l & ((1u << lead) - 1u));
      const bool got = n < 0 && idx < N;
      clk.mark(0);
      __syncwarp();  // the last reads of the stages
      if (got) {
        n = src_n = (int)idx;
        src_area = ai;
        q.lam = 1e-3f;
        q.cst = 0.0f;
        q.done = n >= a.n_valid ? 1.0f : 0.0f;
        q.steps = 0;
        q.fresh = true;
        q.init = true;
        if constexpr (PX == kLqShared) stage_spot<G>(a, smem, ai, n, gl);
      }
      __syncwarp();
      clk.mark(1);
      if (got) grp_init<G>(area_px<PX>(a, smem, ai, n), f, s, gl, gmask, q.th);
      __syncwarp();
      clk.mark(2);
    }
    clk.mark(7);
    const unsigned busy_l = __ballot_sync(kLqAnyAll, gl == 0 && n >= 0);
    if (busy_l == 0u && drained) break;
    // a group without a spot follows the first busy group of the warp
    if (__any_sync(kLqAnyAll, n < 0)) {
      const int o = __ffs(busy_l) - 1;
      LqFit t;
#pragma unroll
      for (int p = 0; p < 6; ++p) t.th[p] = __shfl_sync(kLqAnyAll, q.th[p], o);
      t.lam = __shfl_sync(kLqAnyAll, q.lam, o);
      t.cst = __shfl_sync(kLqAnyAll, q.cst, o);
      t.done = __shfl_sync(kLqAnyAll, q.done, o);
      t.steps = __shfl_sync(kLqAnyAll, q.steps, o);
      t.fresh = __shfl_sync(kLqAnyAll, (int)q.fresh, o) != 0;
      t.init = __shfl_sync(kLqAnyAll, (int)q.init, o) != 0;
      const int on = __shfl_sync(kLqAnyAll, n, o);
      if (n < 0) {
        q = t;
        src_n = on;
        src_area = (threadIdx.x - lane + o) / G;
      }
    }
    clk.mark(7);
    clk.count(8);
    grp_trip<G>(area_px<PX>(a, smem, src_area, src_n), f, s, gl, a.ftol, q,
                aa, jtr, clk);
    if (n >= 0 && (q.done > 0.5f || q.steps >= a.max_it)) {
      if (gl == 0) {
#pragma unroll
        for (int p = 0; p < 6; ++p) a.theta[(long long)p * N + n] = q.th[p];
      }
      n = -1;
    }
    clk.mark(7);
  }
  clk.flush();
}

template <int G, int PX>
int lq_any_launch(LqAnyArgs a, int threads, int* info, cudaStream_t stream) {
  const auto kernel = lq_any_queue_kernel<G, PX>;
  const long long bytes = 4LL * a.area * (threads / G);
  int dev = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > limit) return (int)cudaErrorInvalidValue;
  const int smem = (int)bytes;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    const int v[kLqAnyInfo] = {threads,
                               per_sm,
                               attr.numRegs,
                               (int)attr.localSizeBytes,
                               smem,
                               sms,
                               G};
    for (int i = 0; i < kLqAnyInfo; ++i) info[i] = v[i];
    return 0;
  }
  const int per_block = threads / G;
  long long blocks = ((long long)a.n + per_block - 1) / per_block;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The floats of shared memory a group takes: its seven factor rows and,
// with a shared stage, s rows of stride s | 1.
long long lq_any_area(int s, int stage) {
  return 7LL * s + (stage == kLqShared ? (long long)s * (s | 1) : 0);
}

bool lq_any_valid(int box, int stage, int threads) {
  return box >= 1 && (stage == kLqBatch || stage == kLqShared) &&
         (threads == 32 || threads == 64 || threads == 128);
}

int lq_any_run(const LqAnyArgs& a, int stage, int threads, int* info,
               cudaStream_t stream) {
  return stage == kLqShared
             ? lq_any_launch<kLqAnyGroup, kLqShared>(a, threads, info,
                                                     stream)
             : lq_any_launch<kLqAnyGroup, kLqBatch>(a, threads, info,
                                                    stream);
}

}  // namespace

// LM-fit n spots, lanes-last (box, box, n) f32, box >= 1, through the
// any-box work queue: theta (6, n) f32 out, x/y relative to the box
// centre, each spot at its own index; spots at index >= n_valid start
// done. Launch configuration (ops/lq_cuda.anybox_queue_config): stage,
// where a group reads the pixels (0 the batch, 1 a stage in shared
// memory); threads a block (32, 64 or 128). next: one int32 on the card,
// zero before the launch. Returns cudaErrorInvalidValue for a
// configuration it does not take (its shared bytes above what a block
// may opt in to on the card too), else cudaGetLastError() after the
// launch.
extern "C" int picasso_lq_anybox_queue(const void* spots, long long n,
                                       int box, float ftol, int max_it,
                                       long long n_valid, int stage,
                                       int threads, void* next, void* theta,
                                       void* stream) {
  if (n <= 0 || n > (1LL << 30) || max_it < 0 || next == nullptr ||
      !lq_any_valid(box, stage, threads))
    return (int)cudaErrorInvalidValue;
  LqAnyArgs a{};
  a.spots = static_cast<const float*>(spots);
  a.n = (int)n;
  a.n_valid = (int)(n_valid < n ? (n_valid < 0 ? 0 : n_valid) : n);
  a.s = box;
  a.ftol = ftol;
  a.max_it = max_it;
  a.area = (int)lq_any_area(box, stage);
  a.next = static_cast<int*>(next);
  a.theta = static_cast<float*>(theta);
  return lq_any_run(a, stage, threads, nullptr,
                    static_cast<cudaStream_t>(stream));
}

// Describe the instance for (box, stage, threads) on the current device:
// info[0..6] = threads a block, resident blocks per SM, registers a
// thread, local (spill) bytes a thread, shared bytes a block, SMs, and
// the lanes a group (the compile-time G). Launches nothing.
extern "C" int picasso_lq_anybox_queue_info(int box, int stage, int threads,
                                            void* info) {
  if (info == nullptr || !lq_any_valid(box, stage, threads))
    return (int)cudaErrorInvalidValue;
  LqAnyArgs a{};
  a.s = box;
  a.area = (int)lq_any_area(box, stage);
  return lq_any_run(a, stage, threads, static_cast<int*>(info), nullptr);
}

#ifdef PICASSO_LQANY_CLOCKS
// The summed cycles of each part of a trip (0-7), the trips (8) and the
// warps (9) since the last call, into out[10]; zeroes them.
extern "C" int picasso_lq_anybox_queue_clocks(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, lqany_clocks,
                                         sizeof(lqany_clocks));
  const unsigned long long zero[kLqClocks] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(lqany_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif
