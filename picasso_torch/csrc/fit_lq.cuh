// Least-squares fit of the plain elliptic 2D Gaussian by
// Levenberg-Marquardt for one spot (sm_90a): the body of K3's one pass
// (lq_fit.cu, one thread a spot) and of the LM work queues
// (lq_queue.cuh: K5's, and K3's and K6's), templated on the source the
// spot's pixels come from (fit_common.cuh). Its pieces
// (an axis point, a row of J^T r, a row of the cost, the fold of a row,
// the damped step) are the units the work queue's cooperative tail
// spreads over a group of lanes. The any-box body (fit_lq_any.cuh) is
// built from the same pieces, with the box a run-time value.
//
// It runs picasso_tpu/ops/lq._lm_core: moment initialiser, then up to
// max_it LM iterations on the damped 6x6 normal equations (Marquardt
// damping of the diagonal, unrolled Cholesky solve), a step taken only
// when it lowers the sum of squared residuals, convergence when the
// relative drop is below ftol, and a lane done once its damping reaches
// 1e7. Lanes at or above n_valid start done. One body serves the three
// modes (FULL = K3; START/RESUME = K6's phases), so a phase schedule
// reproduces FULL bit for bit: a done lane's theta, lam and cost are
// frozen in the reference, so a thread may stop at its own done.
//
// What bounds it on the card: issued FP32 instructions, not bytes. Each
// iteration reads the spot's box*box photons twice (normal equations,
// then the trial cost) and spends ~30 FLOPs per pixel plus 2*box expf
// per theta. Every per-spot quantity stays in registers: the J^T r sums
// run row by row (outer loop over y), so each row's column sums are
// scalars folded into six accumulators, and J^T J is built from 1D dot
// products of the separable axis factors (the model's Jacobian columns
// are row factor x column factor). The normal equations (J^T r and the
// undamped lower triangle of J^T J, 27 values, ~64% of a box-7 step's
// FLOPs) are kept in registers across steps and formed anew only after
// a step that moved theta: a rejected step leaves theta, and so them,
// as they were.
//
// Numerics follow the JAX package: sums in its order (per-row sums over
// the columns, then over the rows), IEEE division and sqrt, expf without
// fast math, NaN-propagating maxima and minima (fmaxf would drop a NaN).

#pragma once

#include "fit_common.cuh"

namespace {

constexpr float kNorm = 0.3989422804014327f;  // 1 / sqrt(2 pi)

// The arithmetic below is written with the correctly rounded intrinsics
// (__fmul_rn, __fadd_rn, __fsub_rn, __fmaf_rn, __fdiv_rn), which the
// compiler never contracts or reorders. The same numbers are formed in
// three places: one thread a spot (K3, K6, a slot of a work queue),
// the work queues' cooperative tail (lq_queue.cuh), whose lanes
// form one row each and fold the rows by shuffles, and a cache that carries the normal
// equations across steps. Contraction of a product into a later add
// would depend on what the compiler sees of both, and so on the place.

// Point k of an axis factor (ops/lq._axis_factors): g = norm/sigma *
// exp(-u^2/2), u = (k - half - mu)/sigma with half = box / 2, inv =
// 1/sigma; when D, its derivatives dg = d/dmu and ds = d/dsigma.
template <bool D>
__device__ __forceinline__ void axis_point(int half, int k, float mu,
                                           float inv, float& g, float& dg,
                                           float& ds) {
  const float d = __fsub_rn((float)(k - half), mu);
  const float u = __fmul_rn(d, inv);
  const float uu = __fmul_rn(u, u);
  g = __fmul_rn(__fmul_rn(kNorm, inv), expf(__fmul_rn(-0.5f, uu)));
  if constexpr (D) {
    dg = __fmul_rn(__fmul_rn(__fmul_rn(g, d), inv), inv);
    ds = __fmul_rn(__fmul_rn(g, inv), __fsub_rn(uu, 1.0f));
  }
}

// Pixel i of row j of the J^T r pass, r = data - (pg * gx + bg), into
// the row's column sums of r * dgx, r * gx, r * dsx and r.
__device__ __forceinline__ void jtr_pixel(bool first, float data, float pg,
                                          float bg, float gx, float dgx,
                                          float dsx, float* c) {
  const float r = __fsub_rn(data, __fmaf_rn(pg, gx, bg));
  if (first) {
    c[0] = __fmul_rn(r, dgx);
    c[1] = __fmul_rn(r, gx);
    c[2] = __fmul_rn(r, dsx);
    c[3] = r;
  } else {
    c[0] = __fmaf_rn(r, dgx, c[0]);
    c[1] = __fmaf_rn(r, gx, c[1]);
    c[2] = __fmaf_rn(r, dsx, c[2]);
    c[3] = __fadd_rn(c[3], r);
  }
}

// Row j of the J^T r pass: the column sums over i, in order.
template <int S, class Src>
__device__ __forceinline__ void jtr_row(const Src& px, int j, float pg,
                                        float bg, const float* gx,
                                        const float* dgx, const float* dsx,
                                        float* c) {
#pragma unroll
  for (int i = 0; i < S; ++i)
    jtr_pixel(i == 0, px(j, i), pg, bg, gx[i], dgx[i], dsx[i], c);
}

// Fold row j's column sums c into the six row dots, rows in order.
__device__ __forceinline__ void jtr_fold(bool first, float gy, float dgy,
                                         float dsy, const float* c,
                                         float* jd) {
  if (first) {
    jd[0] = __fmul_rn(gy, c[0]);
    jd[1] = __fmul_rn(dgy, c[1]);
    jd[2] = __fmul_rn(gy, c[1]);
    jd[3] = c[3];
    jd[4] = __fmul_rn(gy, c[2]);
    jd[5] = __fmul_rn(dsy, c[1]);
  } else {
    jd[0] = __fmaf_rn(gy, c[0], jd[0]);
    jd[1] = __fmaf_rn(dgy, c[1], jd[1]);
    jd[2] = __fmaf_rn(gy, c[1], jd[2]);
    jd[3] = __fadd_rn(jd[3], c[3]);
    jd[4] = __fmaf_rn(gy, c[2], jd[4]);
    jd[5] = __fmaf_rn(dsy, c[1], jd[5]);
  }
}

// Point k's step of the 1D dot products: the row factors' (ra) and the
// column factors' (cb) pair products, upper triangle, into sa / sb.
__device__ __forceinline__ void dot_point(bool first, const float* ra,
                                          const float* cb, float (&sa)[4][4],
                                          float (&sb)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = u; v < 4; ++v) {
      sa[u][v] = first ? __fmul_rn(ra[u], ra[v])
                       : __fmaf_rn(ra[u], ra[v], sa[u][v]);
      sb[u][v] = first ? __fmul_rn(cb[u], cb[v])
                       : __fmaf_rn(cb[u], cb[v], sb[u][v]);
    }
}

// J^T r and the lower triangle of J^T J from the row dots jd and the dot
// products sa / sb (upper triangle).
__device__ __forceinline__ void normal_assemble(float (&sa)[4][4],
                                                float (&sb)[4][4], float ph,
                                                const float* jd, float* a,
                                                float* jtr) {
  jtr[0] = __fmul_rn(ph, jd[0]);
  jtr[1] = __fmul_rn(ph, jd[1]);
  jtr[2] = jd[2];
  jtr[3] = jd[3];
  jtr[4] = __fmul_rn(ph, jd[4]);
  jtr[5] = __fmul_rn(ph, jd[5]);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < u; ++v) {
      sa[u][v] = sa[v][u];
      sb[u][v] = sb[v][u];
    }
  const int ar[6] = {0, 1, 0, 2, 0, 3};
  const int bc[6] = {0, 1, 1, 2, 3, 1};
  const float sc[6] = {ph, ph, 1.0f, 1.0f, ph, ph};
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = 0; q <= p; ++q)
      a[p * (p + 1) / 2 + q] =
          __fmul_rn(__fmul_rn(__fmul_rn(sc[q], sc[p]), sa[ar[q]][ar[p]]),
                    sb[bc[q]][bc[p]]);
}

// J^T r from the row dots, and the undamped lower triangle of J^T J
// (a[p * (p + 1) / 2 + q], q <= p) from 1D dot products of the axis
// factors. Row factors (over y): 0 gy, 1 dgy, 2 ones, 3 dsy; column
// factors (over x): 0 dgx, 1 gx, 2 ones, 3 dsx. Parameter p uses row
// factor ar[p], column factor bc[p] and scale photons (x, y, sx, sy) or
// 1 (photons, bg) (normal_assemble).
template <int S>
__device__ __forceinline__ void normal_matrix(
    const float* gx, const float* dgx, const float* dsx, const float* gy,
    const float* dgy, const float* dsy, float ph, const float* jd, float* a,
    float* jtr) {
  float sa[4][4], sb[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = u; v < 4; ++v) {
      float acc_a = 0.0f, acc_b = 0.0f;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const float ra[4] = {gy[k], dgy[k], 1.0f, dsy[k]};
        const float cb[4] = {dgx[k], gx[k], 1.0f, dsx[k]};
        acc_a = k == 0 ? __fmul_rn(ra[u], ra[v])
                       : __fmaf_rn(ra[u], ra[v], acc_a);
        acc_b = k == 0 ? __fmul_rn(cb[u], cb[v])
                       : __fmaf_rn(cb[u], cb[v], acc_b);
      }
      sa[u][v] = acc_a;
      sb[u][v] = acc_b;
    }
  normal_assemble(sa, sb, ph, jd, a, jtr);
}

// The normal equations of one spot at theta th, one thread
// (ops/lq._normal_equations): J^T r (6) and the undamped lower triangle
// of J^T J (21). The J^T r sums run row by row, so each row's column
// sums are scalars folded into six accumulators.
template <int S, class Src>
__device__ __forceinline__ void normal_equations(const Src& px,
                                                 const float* th, float* a,
                                                 float* jtr) {
  float gx[S], gy[S], dgx[S], dgy[S], dsx[S], dsy[S];
  const float ix = __fdiv_rn(1.0f, th[4]), iy = __fdiv_rn(1.0f, th[5]);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    axis_point<true>(S / 2, k, th[0], ix, gx[k], dgx[k], dsx[k]);
    axis_point<true>(S / 2, k, th[1], iy, gy[k], dgy[k], dsy[k]);
  }
  const float ph = th[2], bg = th[3];
  float jd[6];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float c[4];
    jtr_row<S>(px, j, __fmul_rn(ph, gy[j]), bg, gx, dgx, dsx, c);
    jtr_fold(j == 0, gy[j], dgy[j], dsy[j], c, jd);
  }
  normal_matrix<S>(gx, dgx, dsx, gy, dgy, dsy, ph, jd, a, jtr);
}

// Pixel i of row j of the sum of squared residuals.
__device__ __forceinline__ float cost_pixel(bool first, float data, float pg,
                                            float bg, float gx, float row) {
  const float r = __fsub_rn(data, __fmaf_rn(pg, gx, bg));
  return first ? __fmul_rn(r, r) : __fmaf_rn(r, r, row);
}

// Row j of the sum of squared residuals: over i in order.
template <int S, class Src>
__device__ __forceinline__ float cost_row(const Src& px, int j, float pg,
                                          float bg, const float* gx) {
  float row = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i)
    row = cost_pixel(i == 0, px(j, i), pg, bg, gx[i], row);
  return row;
}

// Sum of squared residuals (ops/lq._cost): the rows' sums, rows in
// order.
template <int S, class Src>
__device__ float cost(const Src& px, const float* th) {
  float gx[S], gy[S], unused;
  const float ix = __fdiv_rn(1.0f, th[4]), iy = __fdiv_rn(1.0f, th[5]);
#pragma unroll
  for (int k = 0; k < S; ++k) {
    axis_point<false>(S / 2, k, th[0], ix, gx[k], unused, unused);
    axis_point<false>(S / 2, k, th[1], iy, gy[k], unused, unused);
  }
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float row = cost_row<S>(px, j, __fmul_rn(th[2], gy[j]), th[3], gx);
    total = j == 0 ? row : __fadd_rn(total, row);
  }
  return total;
}

// The initialiser's sums, explicitly rounded like the LM step (the
// unrolled template and the any-box loop, fit_lq_any.cuh, then form the
// same numbers whatever the compiler would fuse): pixel (y, x) with
// photons above the background v into the total and the first moments
// (lq_moments), and into the second moments about the centre of mass
// (lq_moments2).
__device__ __forceinline__ void lq_moments(bool first, float v, int y, int x,
                                           float& total, float& ysum,
                                           float& xsum) {
  total = first ? v : __fadd_rn(total, v);
  ysum = first ? __fmul_rn(v, (float)y) : __fmaf_rn(v, (float)y, ysum);
  xsum = first ? __fmul_rn(v, (float)x) : __fmaf_rn(v, (float)x, xsum);
}

__device__ __forceinline__ void lq_moments2(bool first, float v, int y,
                                            int x, float y_com, float x_com,
                                            float& syy, float& sxx) {
  const float dy = __fsub_rn((float)y, y_com), dx = __fsub_rn((float)x, x_com);
  const float yy = __fmul_rn(dy, dy), xx = __fmul_rn(dx, dx);
  syy = first ? __fmul_rn(v, yy) : __fmaf_rn(v, yy, syy);
  sxx = first ? __fmul_rn(v, xx) : __fmaf_rn(v, xx, sxx);
}

// The centre of mass of a box s (a box without photons takes its middle
// and 0.01 photons).
__device__ __forceinline__ void lq_com(int s, float& total, float ysum,
                                      float xsum, float& y_com,
                                      float& x_com) {
  y_com = ysum / total;
  x_com = xsum / total;
  if (total <= 0.0f) {
    total = 0.01f;
    y_com = x_com = (s - 1) / 2.0f;
  }
}

// theta of the initialiser, x/y relative to the box centre half.
__device__ __forceinline__ void lq_init_store(int half, float x_com,
                                              float y_com, float total,
                                              float bg, float sxx, float syy,
                                              float* th) {
  th[0] = x_com - (float)half;
  th[1] = y_com - (float)half;
  th[2] = nmax(total, 1.0f);
  th[3] = bg;
  th[4] = sqrtf(sxx / total);
  th[5] = sqrtf(syy / total);
}

// Moment initialiser (ops/lq.initial_parameters_t).
template <int S, class Src>
__device__ void lq_init_theta(const Src& px, float* th) {
  float bg = 0.0f;
#pragma unroll
  for (int y = 0; y < S; ++y)
#pragma unroll
    for (int x = 0; x < S; ++x) {
      const float v = px(y, x);
      bg = (y == 0 && x == 0) ? v : nmin(bg, v);
    }
  float total = 0.0f, ysum = 0.0f, xsum = 0.0f;
#pragma unroll
  for (int y = 0; y < S; ++y)
#pragma unroll
    for (int x = 0; x < S; ++x)
      lq_moments(y == 0 && x == 0, px(y, x) - bg, y, x, total, ysum, xsum);
  float y_com, x_com;
  lq_com(S, total, ysum, xsum, y_com, x_com);
  float syy = 0.0f, sxx = 0.0f;
#pragma unroll
  for (int y = 0; y < S; ++y)
#pragma unroll
    for (int x = 0; x < S; ++x)
      lq_moments2(y == 0 && x == 0, px(y, x) - bg, y, x, y_com, x_com, syy,
                  sxx);
  lq_init_store(S / 2, x_com, y_com, total, bg, sxx, syy, th);
}

// The damped step from the normal equations (a, jtr) and the damping
// lam (ops/lq._lm_step): Marquardt damping of the diagonal, Cholesky
// factorisation (ops/linalg.py), forward and back solve, trial theta.
// Returns whether the step is finite; a non-finite step is dropped.
__device__ __forceinline__ bool damped_trial(const float* a,
                                             const float* jtr,
                                             const float* th, float lam,
                                             float* trial) {
  float L[6][6];
  const float damp = __fadd_rn(1.0f, lam);
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = 0; q <= p; ++q) {
      const float v = a[p * (p + 1) / 2 + q];
      L[p][q] = p == q ? __fmul_rn(v, damp) : v;
    }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = L[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = __fmaf_rn(-L[j][k], L[j][k], s);
    L[j][j] = __fsqrt_rn(s);
    const float inv_d = __fdiv_rn(1.0f, L[j][j]);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float si = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) si = __fmaf_rn(-L[i][k], L[j][k], si);
      L[i][j] = __fmul_rn(si, inv_d);
    }
  }
  float z[6], delta[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = jtr[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = __fmaf_rn(-L[i][k], z[k], s);
    z[i] = __fdiv_rn(s, L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = z[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = __fmaf_rn(-L[k][i], delta[k], s);
    delta[i] = __fdiv_rn(s, L[i][i]);
  }
  bool finite = true;
#pragma unroll
  for (int p = 0; p < 6; ++p) finite = finite && isfinite(delta[p]);
#pragma unroll
  for (int p = 0; p < 6; ++p)
    trial[p] = __fadd_rn(th[p], finite ? delta[p] : 0.0f);
  return finite;
}

// Take the trial theta if its cost tc is lower, and update the damping
// and done. Returns whether the step was taken (theta moved).
__device__ __forceinline__ bool lm_accept(float tc, bool finite,
                                          const float* trial, float* th,
                                          float& lam, float& cst,
                                          float& done, float ftol) {
  const bool improved = finite && tc < cst;
  if (improved) {
    const float rel = __fdiv_rn(fabsf(__fsub_rn(cst, tc)), nmax(cst, 1e-20f));
#pragma unroll
    for (int p = 0; p < 6; ++p) th[p] = trial[p];
    cst = tc;
    lam = nmax(__fmul_rn(lam, 0.1f), 1e-9f);
    if (rel < ftol) done = 1.0f;
  } else {
    lam = nmin(__fmul_rn(lam, 10.0f), 1e7f);
  }
  if (lam >= 1e7f) done = 1.0f;
  return improved;
}

// One LM iteration of a lane that is not done (ops/lq._lm_step), one
// thread. The normal equations (a, jtr) are formed anew when fresh (the
// first step, or the previous step was taken) and reused otherwise:
// after a rejected step theta is unchanged, so they are the same
// numbers. fresh is updated for the next step.
template <int S, class Src>
__device__ __forceinline__ void lm_step(const Src& px, float* th,
                                        float& lam, float& cst, float& done,
                                        float ftol, float* a, float* jtr,
                                        bool& fresh) {
  if (fresh) normal_equations<S>(px, th, a, jtr);
  float trial[6];
  const bool finite = damped_trial(a, jtr, th, lam, trial);
  fresh = lm_accept(cost<S>(px, trial), finite, trial, th, lam, cst, done,
                    ftol);
}

// The LM fit of spot n in one pass (one thread): initialise from the
// pixels, up to k iterations, theta (6, N) out. Spots at index >= n_valid
// start done.
template <int S, class Src>
__device__ __forceinline__ void lq_fit_spot(const Src& px, long long n,
                                            long long N, float ftol, int k,
                                            long long n_valid,
                                            float* theta) {
  float th[6];
  lq_init_theta<S>(px, th);
  float cst = cost<S>(px, th);
  float lam = 1e-3f;
  float done = n >= n_valid ? 1.0f : 0.0f;
  float a[21], jtr[6];
  bool fresh = true;
  for (int kk = 0; kk < k; ++kk) {
    if (done > 0.5f) break;
    lm_step<S>(px, th, lam, cst, done, ftol, a, jtr, fresh);
  }
#pragma unroll
  for (int p = 0; p < 6; ++p) theta[p * N + n] = th[p];
}

}  // namespace
