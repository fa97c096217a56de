// MLE fit of the integrated 2D Gaussian for one spot, one thread per
// spot (sm_90a): the body of the K1/K2 kernels (mle_fit.cu), of the
// fused cut+fit kernel K5 (winfit_mle.cu) and of the MLE work queues
// (mle_queue.cuh: K5's and K1's), templated on the source the spot's
// pixels come from (fit_common.cuh). Its pieces (an edge and a point of
// an axis, a row of the Newton sums, the fold of a row, the update) are
// the units the work queues' cooperative tail spreads over a group of
// lanes; its epilogue (CRLB, log-likelihood, the outputs) ends K1's one
// pass, K2's FINISH phase and the K1/K7 work queue (roi_mle_fit.cu).
// The any-box body (fit_mle_any.cuh) is built from the same pieces, with
// the box a run-time value (mle_edge, mle_update and the per-pixel and
// per-row pieces take it so).
//
// It runs picasso_tpu/ops/mle._fit_core: moment initialiser, up to
// max_it Newton steps with per-parameter max_step clamps, per-spot
// convergence against `old`, lanes at or above n_valid starting
// converged, then the CRLB from the equilibrated Fisher matrix and the
// Poisson log-likelihood. Two methods, as template instances: "sigmaxy"
// (R = 6 parameters [x, y, photons, bg, sx, sy], convergence on rows
// 0, 1, 4, 5) and "sigma" (R = 5, [x, y, photons, bg, sigma],
// convergence on rows 0, 1, with the reference's two quirks: a zero
// denominator steps by sign(num * max_step) = +-1, and photons multiply
// only the first term of d2udt2_sigma; theta and CRLB padded to 6 rows).
// One body serves all four modes (FULL = K1; START/RESUME/FINISH = K2's
// phases), so a phase schedule reproduces FULL bit for bit.
//
// What bounds it on the card: issued FP32 instructions, not bytes. Each
// Newton step reads the spot's box*box photons once and then spends ~40
// FLOPs per pixel plus (box+1) expf and erfc rational evaluations per
// axis. Every per-spot quantity stays in registers: the Newton sums run
// row by row (outer loop over y), so each row's column sums are scalars
// that fold straight into the sixteen numerator/denominator
// accumulators, and the (S, S) C/D grids are never stored.
//
// Numerics follow the JAX package, not CUDA's libm shortcuts: the erf
// is the Abramowitz & Stegun rational form in erfc-complement evaluation
// (not erff/erfcf), maxima and minima propagate NaN like jnp.maximum,
// and the build uses IEEE division, sqrt, expf and logf (no fast math).

#pragma once

#include "fit_common.cuh"

namespace {

constexpr float kSqrt2Pi = 2.5066282746310002f;
constexpr float kInvSqrt2 = 0.70710678118654757f;
constexpr float kSqrtPi = 1.7724538509055159f;
constexpr float kInvSqrtPi = 0.56418958354775628f;  // 1 / sqrt(pi)

// The Newton step's arithmetic below never leaves the compiler a product
// that it could contract into a later add (nvcc contracts a * b + c to
// an FMA by default): every sum of products is an explicit __fmaf_rn,
// and a product that meets an add is either __fmul_rn or meets an
// __fadd_rn / __fsub_rn (explicitly rounded operations are never fused).
// One thread a spot (K1, K2, K7, a slot of a work queue) and the work
// queues' cooperative tail (mle_queue.cuh), whose lanes form one axis
// point and one row each and fold the rows by shuffles, then form the
// same numbers: a contraction would depend on what the compiler sees of
// both operations, and so on the place. The other products and sums stay
// plain operators (correctly rounded, never reordered without fast math):
// ptxas schedules explicitly rounded ones conservatively, and pinning the
// pixel loop's whole arithmetic that way made K5's queue ~20% slower
// (PERF.md). A reciprocal is __frcp_rn, correctly rounded as IEEE 1 / x
// (and the instruction nvcc picks for 1.0f / x): __fdiv_rn(1.0f, x) gives
// the same number through the general division's longer sequence, ~20%
// more again.

// A row's model and its column sums, pg * psf + bg and v * fa + c
// (mle_row): for sigma the product is rounded before the add, as the
// plain version and the JAX package form them; for sigmaxy, as every
// other a * b + c of the body, they are one __fmaf_rn. Fused, the sigma
// fits on the first of the smoke movie's dense fit2D blocks sat 2.8x
// further from the plain fit than JAX's (x/y 5.0e-4 px against 1.8e-4) and 3.4x
// further from the plain fit in f64 than the plain f32 fit; unfused
// (both; either alone is not enough) they are within
// torch_parity.compare_fits there. The sigmaxy fits gain nothing from it
// on the movie's four blocks (unfused, their sx/sy leave compare_fits on
// one, fused on none), and would pay 8-11% more time. The other bodies
// are built by tests/torch_k1_queue_sweep.py (PERF.md).
template <bool SIG>
__device__ __forceinline__ float row_fma(float a, float b, float c) {
  return SIG ? __fadd_rn(__fmul_rn(a, b), c) : __fmaf_rn(a, b, c);
}

__device__ __forceinline__ float erfc_from_exp(float a, float e) {
  const float x = __fmul_rn(fabsf(a), kInvSqrt2);
  const float t = __frcp_rn(__fmaf_rn(0.3275911f, x, 1.0f));
  float p = __fmaf_rn(t, 1.061405429f, -1.453152027f);
  p = __fmaf_rn(t, p, 1.421413741f);
  p = __fmaf_rn(t, p, -0.284496736f);
  p = __fmaf_rn(t, p, 0.254829592f);
  return __fmul_rn(__fmul_rn(t, p), e);
}

// Edge k = 0..s of an axis of box s (ops/gaussian.py fused_axis_terms):
// the standardised edge a = (k - mu - 1/2) / sigma (the last, k = s, is
// (s - 1 - mu + 1/2) / sigma), its exponential and its erfc.
__device__ __forceinline__ void mle_edge(int s, int k, float mu, float inv_s,
                                         float& a, float& e, float& q) {
  a = k < s ? __fmul_rn(__fsub_rn(__fsub_rn((float)k, mu), 0.5f), inv_s)
            : __fmul_rn(__fadd_rn(__fsub_rn((float)(s - 1), mu), 0.5f),
                        inv_s);
  e = expf(__fmul_rn(__fmul_rn(-0.5f, a), a));
  q = erfc_from_exp(a, e);
}

// Point k = 0..S-1 of an axis from its two edges (am, eb, qb at k; ap,
// ea, qa at k + 1): psf, dmu, d2mu, and dsig, d2sig (with ISO the
// isotropic model's dPSF and d2PSF, fused_axis_terms_iso).
template <bool ISO>
__device__ __forceinline__ void mle_point(int k, float mu, float sigma,
                                          float inv_s, float norm, float am,
                                          float ap, float eb, float ea,
                                          float qb, float qa, float& psf,
                                          float& dmu, float& d2mu,
                                          float& dsig, float& d2sig) {
  psf = 0.5f * (am >= 0.0f ? qb - qa : (ap <= 0.0f ? qa - qb
                                                     : (2.0f - qa) - qb));
  const float d = __fsub_rn((float)k, mu);
  const float dm = __fsub_rn(d, 0.5f), dp = __fadd_rn(d, 0.5f);
  dmu = __fmul_rn(__fsub_rn(eb, ea), norm);
  // u * eb - v * ea, the product of eb fused into the difference
  auto edge_diff = [&](float u, float v) {
    return __fmaf_rn(u, eb, -__fmul_rn(v, ea));
  };
  const float g1 = __fmul_rn(edge_diff(dm, dp), norm);
  d2mu = __fmul_rn(__fmul_rn(g1, inv_s), inv_s);
  if constexpr (ISO) {
    const float F = __fmul_rn(edge_diff(am, ap), kInvSqrt2);
    dsig = __fdiv_rn(F, __fmul_rn(kSqrtPi, sigma));
    const float dF = __fmul_rn(
        __fmul_rn(__fsub_rn(__fmul_rn(__fmul_rn(ap, ea),
                                      __fmaf_rn(-ap, ap, 1.0f)),
                            __fmul_rn(__fmul_rn(am, eb),
                                      __fmaf_rn(-am, am, 1.0f))),
                  kInvSqrt2),
        inv_s);
    d2sig = __fmul_rn(kInvSqrtPi, __fmaf_rn(__fmul_rn(-F, inv_s), inv_s,
                                            __fmul_rn(dF, inv_s)));
  } else {
    dsig = __fmul_rn(g1, inv_s);
    const float g3 = __fmul_rn(edge_diff(__fmul_rn(__fmul_rn(dm, dm), dm),
                                         __fmul_rn(__fmul_rn(dp, dp), dp)),
                               norm);
    d2sig = __fmul_rn(
        __fmul_rn(__fmaf_rn(__fmul_rn(g3, inv_s), inv_s,
                            -__fmul_rn(2.0f, g1)),
                  inv_s),
        inv_s);
  }
}

// 1 / sigma and the Gaussian's norm 1 / (sigma sqrt(2 pi)) of an axis.
__device__ __forceinline__ void axis_scale(float sigma, float& inv_s,
                                           float& norm) {
  inv_s = __frcp_rn(sigma);
  norm = __fdiv_rn(inv_s, kSqrt2Pi);
}

// Per-axis factors (psf, dmu, d2mu, dsig, d2sig) on the grid k - mu,
// k = 0..S-1, from the S+1 shared exponentials (ops/gaussian.py
// fused_axis_terms); with ISO the last two are the isotropic model's
// dPSF and d2PSF (fused_axis_terms_iso).
template <int S, bool ISO>
__device__ __forceinline__ void axis_terms(float mu, float sigma, float* psf,
                                           float* dmu, float* d2mu,
                                           float* dsig, float* d2sig) {
  float inv_s, norm;
  axis_scale(sigma, inv_s, norm);
  float a8[S + 1], e8[S + 1], q8[S + 1];
#pragma unroll
  for (int k = 0; k <= S; ++k) mle_edge(S, k, mu, inv_s, a8[k], e8[k], q8[k]);
#pragma unroll
  for (int k = 0; k < S; ++k)
    mle_point<ISO>(k, mu, sigma, inv_s, norm, a8[k], a8[k + 1], e8[k],
                   e8[k + 1], q8[k], q8[k + 1], psf[k], dmu[k], d2mu[k],
                   dsig[k], d2sig[k]);
}

// The centre of mass of a box s from its sums (a box without photons
// takes its middle and 0.01 photons).
__device__ __forceinline__ void init_com(int s, float& total, float ysum,
                                        float xsum, float& y_com,
                                        float& x_com) {
  y_com = ysum / total;
  x_com = xsum / total;
  if (total <= 0.0f) {
    total = 0.01f;
    y_com = x_com = (s - 1) / 2.0f;
  }
}

// theta and max_step of the initialiser from its moments: the widths
// from the second moments of the centre column (cnum / cden) and row
// (rnum / rden).
template <bool SIG>
__device__ __forceinline__ void init_store(float x_com, float y_com,
                                          float photons, float bg,
                                          float cnum, float cden, float rnum,
                                          float rden, float* th, float* ms) {
  float sy = sqrtf(cnum / cden), sx = sqrtf(rnum / rden);
  if (!(isfinite(sy) && sy != 0.0f)) sy = 0.01f;
  if (!(isfinite(sx) && sx != 0.0f)) sx = 0.01f;
  th[0] = x_com;
  th[1] = y_com;
  th[2] = photons;
  th[3] = bg;
  ms[2] = 0.1f * photons;
  ms[3] = 0.1f * bg;
  if constexpr (SIG) {
    const float s0 = (sx + sy) / 2.0f;
    th[4] = s0;
    ms[0] = s0;
    ms[1] = s0;
    ms[4] = 0.2f * s0;
  } else {
    th[4] = sx;
    th[5] = sy;
    ms[0] = sx;
    ms[1] = sx;
    ms[4] = 0.2f * sx;
    ms[5] = 0.2f * sy;
  }
}

// The initialiser's sums, explicitly rounded like the Newton step (the
// unrolled template and the any-box loop then form the same numbers: as
// plain operators, a diagonal pixel's v * y and v * x are one product,
// which the compiler fuses into neither sum): pixel (y, x) with photons
// v into the total and the first moments, and a second moment's term.
__device__ __forceinline__ void moment_pixel(float v, int y, int x,
                                             float& total, float& ysum,
                                             float& xsum) {
  total = __fadd_rn(total, v);
  ysum = __fmaf_rn(v, (float)y, ysum);
  xsum = __fmaf_rn(v, (float)x, xsum);
}

__device__ __forceinline__ float moment2(bool first, float d2, float c,
                                         float acc) {
  return first ? __fmul_rn(d2, c) : __fmaf_rn(d2, c, acc);
}

// Photons from the total less the background of s x s pixels.
__device__ __forceinline__ float init_photons(int s, float total, float bg) {
  return nmax(__fmaf_rn(-(float)(s * s), bg, total), 1.0f);
}

// Moment initialiser (ops/mle.py initial_theta_sigmaxy_t, _init_state)
// and max_step.
template <int S, bool SIG, class Src>
__device__ void init_theta(const Src& px, float* th, float* ms) {
  float total = 0.0f, ysum = 0.0f, xsum = 0.0f;
#pragma unroll
  for (int y = 0; y < S; ++y)
#pragma unroll
    for (int x = 0; x < S; ++x) moment_pixel(px(y, x), y, x, total, ysum, xsum);
  float y_com, x_com;
  init_com(S, total, ysum, xsum, y_com, x_com);
  // background: min of the 3x3 edge-clipped mean filter
  float rows[S][S];
#pragma unroll
  for (int y = 0; y < S; ++y)
#pragma unroll
    for (int x = 0; x < S; ++x) {
      const float up = y > 0 ? px(y - 1, x) : 0.0f;
      const float dn = y < S - 1 ? px(y + 1, x) : 0.0f;
      rows[y][x] = (up + px(y, x)) + dn;
    }
  float bg = 0.0f;
#pragma unroll
  for (int y = 0; y < S; ++y)
#pragma unroll
    for (int x = 0; x < S; ++x) {
      const float lf = x > 0 ? rows[y][x - 1] : 0.0f;
      const float rt = x < S - 1 ? rows[y][x + 1] : 0.0f;
      const float cy = (y == 0 || y == S - 1) ? 2.0f : 3.0f;
      const float cx = (x == 0 || x == S - 1) ? 2.0f : 3.0f;
      const float v = ((lf + rows[y][x]) + rt) / (cy * cx);
      bg = (y == 0 && x == 0) ? v : nmin(bg, v);
    }
  const float photons = init_photons(S, total, bg);
  // second moments of the centre column (along y) and row (along x)
  constexpr int half = S / 2;
  float cnum = 0.0f, cden = 0.0f, rnum = 0.0f, rden = 0.0f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float d2 = (float)((k - half) * (k - half));
    const float c = px(k, half) - bg;
    const float r = px(half, k) - bg;
    cnum = moment2(k == 0, d2, c, cnum);
    cden = k == 0 ? c : cden + c;
    rnum = moment2(k == 0, d2, r, rnum);
    rden = k == 0 ? r : rden + r;
  }
  init_store<SIG>(x_com, y_com, photons, bg, cnum, cden, rnum, rden, th, ms);
}

// The column factors of the Newton sums, over i = 0..S-1, formed once a
// step from the x axis's: rows dmu, psf, dsig, d2mu, d2sig, then the
// products dmu^2, psf^2, dsig^2 and dsig * psf (sigma's d3 factor).
constexpr int kCols = 9;
__device__ __forceinline__ void mle_column(float psf, float dmu, float d2mu,
                                           float dsig, float d2sig,
                                           float* f) {
  f[0] = dmu;
  f[1] = psf;
  f[2] = dsig;
  f[3] = d2mu;
  f[4] = d2sig;
  f[5] = dmu * dmu;
  f[6] = psf * psf;
  f[7] = dsig * dsig;
  f[8] = dsig * psf;
}

template <int S>
__device__ __forceinline__ void mle_columns(const float* psf_x,
                                            const float* dmu_x,
                                            const float* d2mu_x,
                                            const float* dsig_x,
                                            const float* d2sig_x,
                                            float (&f)[kCols][S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float col[kCols];
    mle_column(psf_x[i], dmu_x[i], d2mu_x[i], dsig_x[i], d2sig_x[i], col);
#pragma unroll
    for (int t = 0; t < kCols; ++t) f[t][i] = col[t];
  }
}

// Pixel i of row j of the Newton sums: its data, pg = photons *
// psf_y[j], bg and its column factors f (mle_column) into the eleven
// column sums c0..c5, d0..d4 (first: the row's first pixel). sigmaxy: d3
// = d4 = sum df; sigma: d3 = sum df * dPSF * psf.
template <bool SIG>
__device__ __forceinline__ void mle_pixel(bool first, float data, float pg,
                                          float bg, const float* f,
                                          float* c) {
  const float model = row_fma<SIG>(pg, f[1], bg);
  const bool valid = model > 10e-3f;
  const float r = __frcp_rn(model);
  const float dr = data * r;
  const float cf = nmin(valid ? __fsub_rn(dr, 1.0f) : 0.0f, 10e4f);
  const float df = nmin(valid ? dr * r : 0.0f, 10e4f);
  const float e3 = SIG ? __fmul_rn(df, f[8]) : df;
#pragma unroll
  for (int t = 0; t < 11; ++t) {
    // c0..c4 and d0..d2 take a column factor (rows 0-4 and 5-7 of f);
    // c5, d3, d4 are plain sums (of cf, e3, df)
    const float v = t < 6 ? cf : (t == 9 ? e3 : df);
    const float fa = f[t < 5 ? t : t - 1];
    if (t == 5 || t >= 9)
      c[t] = first ? v : c[t] + v;
    else
      c[t] = first ? v * fa : row_fma<SIG>(v, fa, c[t]);
  }
}

// Row j of the Newton sums (the JAX package's row accumulators
// Tc/Td[j]): the eleven column sums over i = 0..S-1, in order, with the
// column factors f (mle_columns).
template <int S, bool SIG, class Src>
__device__ __forceinline__ void mle_row(const Src& px, int j, float pg,
                                        float bg,
                                        const float (&f)[kCols][S],
                                        float* c) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float fi[kCols];
#pragma unroll
    for (int t = 0; t < kCols; ++t) fi[t] = f[t][i];
    mle_pixel<SIG>(i == 0, px(j, i), pg, bg, fi, c);
  }
}

// The nineteen row dots sum_j A[j] * T[j], folded row by row in order:
// row j's column sums c (mle_row) and its y factors (psf, dmu, d2mu,
// dsig, d2sig at j). The y factors' squares are formed here, from the
// operands.
constexpr int kDots = 19;
__device__ __forceinline__ void mle_fold(bool first, float py, float dy,
                                         float d2y, float sy, float s2y,
                                         const float* c, float* a) {
  const float py2 = py * py, dy2 = dy * dy, sy2 = sy * sy, pys = py * sy;
  // (row factor, column sum); a factor 0 marks a plain sum
  const float fa[kDots] = {py,  dy,  py, 0.0f, py,  sy,  py,  py2, d2y, dy2,
                           py2, 0.0f, py, py2, s2y, sy2, sy,  pys, 0.0f};
  const int ci[kDots] = {0, 1, 1, 5, 2, 1, 3, 6, 1, 7,
                         7, 9, 4, 8, 1, 7, 2, 9, 10};
  const bool plain[kDots] = {false, false, false, true,  false, false, false,
                             false, false, false, false, true,  false, false,
                             false, false, false, false, true};
#pragma unroll
  for (int t = 0; t < kDots; ++t) {
    const float v = c[ci[t]];
    if (plain[t])
      a[t] = first ? v : a[t] + v;
    else
      a[t] = first ? fa[t] * v : __fmaf_rn(fa[t], v, a[t]);
  }
}

// The update from the row dots (ops/mle.py _newton_step_sigmaxy, or
// with SIG _newton_step_sigma): numerators and denominators, the clamped
// step, the constraints (picasso/gaussmle.py:880-884); sigma is held
// within the box s.
template <bool SIG>
__device__ __forceinline__ void mle_update(int s, const float* a, float* th,
                                           const float* ms) {
  constexpr int R = SIG ? 5 : 6;
  enum {
    py_c0, dy_c1, py_c1, c5, py_c2, sy_c1, py_c3, py2_d0, d2y_c1, dy2_d1,
    py2_d1, d3, py_c4, py2_d2, s2y_c1, sy2_d1, sy_c2, pys_d3, d4
  };
  const float ph = th[2];
  const float ph2 = __fmul_rn(ph, ph);
  auto diff = [&](float u, int p, float v, int q) {
    return __fmaf_rn(u, a[p], -__fmul_rn(v, a[q]));
  };
  float num[R], den[R];
  num[0] = __fmul_rn(ph, a[py_c0]);
  num[1] = __fmul_rn(ph, a[dy_c1]);
  num[2] = a[py_c1];
  num[3] = a[c5];
  den[0] = diff(ph, py_c3, ph2, py2_d0);
  den[1] = diff(ph, d2y_c1, ph2, dy2_d1);
  den[2] = -a[py2_d1];
  if constexpr (SIG) {
    den[3] = -a[d4];
    num[4] = __fmul_rn(ph, __fadd_rn(a[py_c2], a[sy_c1]));
    // d2udt2_sigma: photons multiply only the first term (reference quirk)
    const float cf_sig = __fadd_rn(
        __fmaf_rn(ph, a[py_c4], __fmul_rn(2.0f, a[sy_c2])), a[s2y_c1]);
    const float df_sig = __fmul_rn(
        ph2, __fadd_rn(__fadd_rn(a[py2_d2], __fmul_rn(2.0f, a[pys_d3])),
                       a[sy2_d1]));
    den[4] = __fsub_rn(cf_sig, df_sig);
  } else {
    den[3] = -a[d3];
    num[4] = __fmul_rn(ph, a[py_c2]);
    num[5] = __fmul_rn(ph, a[sy_c1]);
    den[4] = diff(ph, py_c4, ph2, py2_d2);
    den[5] = diff(ph, s2y_c1, ph2, sy2_d1);
  }
#pragma unroll
  for (int p = 0; p < R; ++p) {
    // sigma's zero-denominator step is sign(num * max_step), i.e. +-1
    const float zero_step = SIG ? nsign(__fmul_rn(num[p], ms[p]))
                                : __fmul_rn(nsign(num[p]), ms[p]);
    const float upd =
        den[p] == 0.0f ? zero_step
                       : nmin(nmax(__fdiv_rn(num[p], den[p]), -ms[p]), ms[p]);
    th[p] = __fsub_rn(th[p], upd);
  }
  th[2] = nmax(th[2], 1.0f);
  th[3] = nmax(th[3], 0.01f);
  if constexpr (SIG) {
    th[4] = nmin(nmax(th[4], 0.01f), (float)s);
  } else {
    th[4] = nmax(th[4], 0.01f);
    th[5] = nmax(th[5], 0.01f);
  }
}

// One Newton update, one thread: both axes' factors, then row by row
// (outer loop over y = j) the column sums, folded straight into the
// nineteen row dots, so the (S, S) C/D grids are never stored. With SIG,
// dsig/d2sig hold the isotropic dPSF/d2PSF and the fifth parameter is
// sigma.
template <int S, bool SIG, class Src>
__device__ void newton_step(const Src& px, float* th, const float* ms) {
  float psf_x[S], dmu_x[S], d2mu_x[S], dsig_x[S], d2sig_x[S];
  float psf_y[S], dmu_y[S], d2mu_y[S], dsig_y[S], d2sig_y[S];
  axis_terms<S, SIG>(th[0], th[4], psf_x, dmu_x, d2mu_x, dsig_x, d2sig_x);
  axis_terms<S, SIG>(th[1], th[SIG ? 4 : 5], psf_y, dmu_y, d2mu_y, dsig_y,
                     d2sig_y);
  float f[kCols][S];
  mle_columns<S>(psf_x, dmu_x, d2mu_x, dsig_x, d2sig_x, f);
  float a[kDots];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float c[11];
    mle_row<S, SIG>(px, j, th[2] * psf_y[j], th[3], f, c);
    mle_fold(j == 0, psf_y[j], dmu_y[j], d2mu_y[j], dsig_y[j], d2sig_y[j], c,
             a);
  }
  mle_update<SIG>(S, a, th, ms);
}

// After a Newton step of a lane that has not converged (ops/mle.py
// _run_newton_rounds, one iteration of one lane): iters counts before
// the convergence test, which compares rows (0, 1, 4, 5) (sigma: 0, 1)
// against `old`; a converged lane keeps its theta and old.
template <bool SIG>
__device__ __forceinline__ void mle_converge(const float* th, float* old,
                                             float& done, float& iters,
                                             float eps) {
  constexpr int R = SIG ? 5 : 6;
  iters = iters + (1.0f - done);
  bool conv = fabsf(__fsub_rn(old[0], th[0])) < eps &&
              fabsf(__fsub_rn(old[1], th[1])) < eps;
  if constexpr (!SIG)
    conv = conv && fabsf(__fsub_rn(old[4], th[4])) < eps &&
           fabsf(__fsub_rn(old[5], th[5])) < eps;
  if (conv) {
    done = 1.0f;
  } else {
#pragma unroll
    for (int p = 0; p < R; ++p) old[p] = th[p];
  }
}

// One Newton step of a lane that has not converged, one thread.
template <int S, bool SIG, class Src>
__device__ __forceinline__ void newton_trip(const Src& px, float* th,
                                            float* old, float& done,
                                            float& iters, const float* ms,
                                            float eps) {
  newton_step<S, SIG>(px, th, ms);
  mle_converge<SIG>(th, old, done, iters, eps);
}

// Up to k Newton steps from a carried state (ops/mle.py
// _run_newton_rounds, for one lane).
template <int S, bool SIG, class Src>
__device__ void run_rounds(const Src& px, float* th, float* old, float& done,
                           float& iters, const float* ms, float eps, int k) {
  for (int kk = 0; kk < k; ++kk) {
    if (done > 0.5f) break;
    newton_trip<S, SIG>(px, th, old, done, iters, ms, eps);
  }
}

// CRLB (diag of the inverse equilibrated Fisher matrix, unrolled
// Cholesky of ops/linalg.py) and Poisson log-likelihood (ops/mle.py
// _crlb_and_likelihood). Fisher entry (p, q) is
// sp*sq * sum_j Ap[j]*Aq[j] * sum_i W[j,i] * Bp[i]*Bq[i].
//
// Like the Newton step, its arithmetic leaves no product that meets an
// add to the compiler: every product that is summed is __fmul_rn and
// every such sum __fadd_rn / __fsub_rn, in the plain version's order, so
// each of its callers (the one-thread pass and FINISH of mle_fit.cu and
// winfit_mle.cu, and the epilogue of roi_mle_fit.cu's queue) forms the
// same numbers wherever the compiler places it. The rows run in a loop
// that is not unrolled, each row's y factors formed from its two edges
// (the previous row's upper edge carried): unrolled, the box x box
// pixels with their two logarithms were ~6,200 of the 13,000 SASS
// instructions of the queue kernel that holds it (NVIDIA H100, box 7
// sigmaxy), and that kernel ran at half the speed of the same queue
// without it (PERF.md).
__device__ __forceinline__ int bcol(int p) {
  return p == 0 ? 0 : (p == 3 ? 2 : (p == 4 ? 3 : 1));
}

// Pixel i of row j of the CRLB/LL sums: the W-weighted products of the
// column factors (dmu_x, psf_x, 1, dsig_x), upper triangle, and the
// pixel's log-likelihood term, pgy = photons * psf_y[j].
__device__ __forceinline__ void crlb_pixel(bool first, float data, float pgy,
                                           float psf, float dmu, float dsig,
                                           float bg, float (&t)[4][4],
                                           float& ll_row) {
  const float model = __fadd_rn(__fmul_rn(pgy, psf), bg);
  const float w = __frcp_rn(model);
  const float b[4] = {dmu, psf, 1.0f, dsig};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = a; c < 4; ++c) {
      const float v = __fmul_rn(w, __fmul_rn(b[a], b[c]));
      t[a][c] = first ? v : __fadd_rn(t[a][c], v);
    }
  float lli = data > 0.0f
                  ? __fadd_rn(__fsub_rn(__fsub_rn(__fmul_rn(data, logf(model)),
                                                  model),
                                        __fmul_rn(data, logf(data))),
                              data)
                  : -model;
  if (!(model > 0.0f)) lli = 0.0f;
  ll_row = first ? lli : __fadd_rn(ll_row, lli);
}

// Fold row j's sums t (crlb_pixel) with its y factors (psf, dmu, dsig at
// j) into the term-pair sums m (first: row 0).
__device__ __forceinline__ void crlb_fold(bool first, float py, float dy,
                                          float sgy, const float (&t)[4][4],
                                          float (&m)[6][6]) {
  const float A[6] = {py, dy, py, 1.0f, py, sgy};
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q) {
      const int a = min(bcol(p), bcol(q));
      const int c = max(bcol(p), bcol(q));
      const float v = __fmul_rn(__fmul_rn(A[p], A[q]), t[a][c]);
      m[p][q] = first ? v : __fadd_rn(m[p][q], v);
    }
}

// The CRLB from the term-pair sums m: the Fisher matrix, its
// equilibration and Cholesky factor, and the diagonal of its inverse.
template <bool SIG>
__device__ __forceinline__ void crlb_solve(const float (&m)[6][6], float ph,
                                           float* crlb) {
  constexpr int P = SIG ? 5 : 6;
  const float sc[6] = {ph, ph, 1.0f, 1.0f, ph, ph};
  // Fisher matrix (upper triangle): sum over the term pairs of each
  // parameter pair, in the order of ops/mle.py _crlb_and_likelihood
  float M[P][P];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int q = p; q < P; ++q)
      M[p][q] = __fmul_rn(__fmul_rn(sc[p], sc[q]), m[p][q]);
  if constexpr (SIG) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float s4 = __fmul_rn(sc[p], ph);
      M[p][4] = __fadd_rn(__fmul_rn(s4, m[p][4]), __fmul_rn(s4, m[p][5]));
    }
    const float pp = __fmul_rn(ph, ph);
    M[4][4] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(pp, m[4][4]), __fmul_rn(pp, m[4][5])),
                  __fmul_rn(pp, m[4][5])),
        __fmul_rn(pp, m[5][5]));
  }
  float dinv[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    dinv[p] = M[p][p] > 0.0f ? 1.0f / sqrtf(M[p][p]) : 1.0f;
  // lower triangle of the equilibrated matrix, then Cholesky
  float L[P][P];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      L[i][j] = __fmul_rn(__fmul_rn(M[j][i], dinv[i]), dinv[j]);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float s = L[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(L[j][k], L[j][k]));
    L[j][j] = sqrtf(s);
    const float inv_d = 1.0f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      float si = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k)
        si = __fsub_rn(si, __fmul_rn(L[i][k], L[j][k]));
      L[i][j] = __fmul_rn(si, inv_d);
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float z[P];
    z[k] = 1.0f / L[k][k];
    float acc = __fmul_rn(z[k], z[k]);
#pragma unroll
    for (int j = k + 1; j < P; ++j) {
      float s = -__fmul_rn(L[j][k], z[k]);
#pragma unroll
      for (int mm = k + 1; mm < j; ++mm)
        s = __fsub_rn(s, __fmul_rn(L[j][mm], z[mm]));
      z[j] = s / L[j][j];
      acc = __fadd_rn(acc, __fmul_rn(z[j], z[j]));
    }
    crlb[k] = __fmul_rn(acc, __fmul_rn(dinv[k], dinv[k]));
  }
  if constexpr (SIG) crlb[5] = crlb[4];
}

template <int S, bool SIG, class Src>
__device__ void crlb_ll(const Src& px, const float* th, float* crlb,
                        float& ll) {
  const float ph = th[2], bg = th[3];
  const float sy = th[SIG ? 4 : 5];
  float psf_x[S], dmu_x[S], d2mu_x[S], dsig_x[S], d2sig_x[S];
  axis_terms<S, SIG>(th[0], th[4], psf_x, dmu_x, d2mu_x, dsig_x, d2sig_x);
  float isy, ny;
  axis_scale(sy, isy, ny);
  // Separable first-derivative terms t = 0..5: row factor A[t], column
  // factor bcol(t), scale sc[t]. sigmaxy: term t is parameter t. sigma:
  // terms 4 and 5 are the two halves of d/dsigma (parameter 4). Distinct
  // column factors: 0 dmu_x, 1 psf_x, 2 ones, 3 dsig_x.
  float m[6][6];
  float ll_acc = 0.0f;
  float a0, e0, q0;  // row j's lower edge
  mle_edge(S, 0, th[1], isy, a0, e0, q0);
#pragma unroll 1
  for (int j = 0; j < S; ++j) {
    float a1, e1, q1;  // its upper edge
    mle_edge(S, j + 1, th[1], isy, a1, e1, q1);
    float py, dy, d2y, sgy, s2y;
    mle_point<SIG>(j, th[1], sy, isy, ny, a0, a1, e0, e1, q0, q1, py, dy,
                   d2y, sgy, s2y);
    a0 = a1;
    e0 = e1;
    q0 = q1;
    const float pgy = __fmul_rn(ph, py);
    float t[4][4];
    float ll_row = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i)
      crlb_pixel(i == 0, px(j, i), pgy, psf_x[i], dmu_x[i], dsig_x[i], bg, t,
                 ll_row);
    crlb_fold(j == 0, py, dy, sgy, t, m);
    ll_acc = j == 0 ? ll_row : __fadd_rn(ll_acc, ll_row);
  }
  crlb_solve<SIG>(m, ph, crlb);
  ll = ll_acc;
}

// A finished spot's outputs: its CRLB and log-likelihood (crlb_ll) and
// theta (with SIG sx == sy, the sigma row twice), written with its
// iteration count at index n of theta/crlb (6, N), ll and iters (N,).
template <int S, bool SIG, class Src>
__device__ __forceinline__ void mle_epilogue(const Src& px, long long n,
                                             long long N, float* th,
                                             float iters, float* theta_out,
                                             float* crlb_out, float* ll_out,
                                             int* iters_out) {
  float crlb[6], ll;
  crlb_ll<S, SIG>(px, th, crlb, ll);
  if (SIG) th[5] = th[4];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    theta_out[p * N + n] = th[p];
    crlb_out[p * N + n] = crlb[p];
  }
  ll_out[n] = ll;
  iters_out[n] = (int)iters;
}

// The fit of spot n in one mode. FULL/START initialise from the pixels,
// RESUME/FINISH load the carry (theta/old/max_step (R, N), done/iters
// (N,)); START/RESUME store the carry after k steps, FULL/FINISH write
// theta/crlb (6, N), ll and iters (N,).
template <int S, bool SIG, class Src>
__device__ __forceinline__ void mle_fit_spot(
    const Src& px, long long n, long long N, float eps, int k, int mode,
    long long n_valid, float* theta_c, float* old_c, float* done_c,
    float* iters_c, float* ms_c, float* theta_out, float* crlb_out,
    float* ll_out, int* iters_out) {
  constexpr int R = SIG ? 5 : 6;
  float th[6], old[6], ms[6], done, iters;
  if (mode == kFull || mode == kStart) {
    init_theta<S, SIG>(px, th, ms);
#pragma unroll
    for (int p = 0; p < R; ++p) old[p] = th[p];
    done = n >= n_valid ? 1.0f : 0.0f;
    iters = 0.0f;
  } else {
#pragma unroll
    for (int p = 0; p < R; ++p) {
      th[p] = theta_c[p * N + n];
      old[p] = old_c[p * N + n];
      ms[p] = ms_c[p * N + n];
    }
    done = done_c[n];
    iters = iters_c[n];
  }
  run_rounds<S, SIG>(px, th, old, done, iters, ms, eps, k);
  if (mode == kStart || mode == kResume) {
#pragma unroll
    for (int p = 0; p < R; ++p) {
      theta_c[p * N + n] = th[p];
      old_c[p * N + n] = old[p];
      ms_c[p * N + n] = ms[p];
    }
    done_c[n] = done;
    iters_c[n] = iters;
    return;
  }
  mle_epilogue<S, SIG>(px, n, N, th, iters, theta_out, crlb_out, ll_out,
                       iters_out);
}

}  // namespace
