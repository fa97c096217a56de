// The MLE fit (sigmaxy and sigma) of one spot at a box known only at run
// time (sm_90a): the body of the any-box work queue (mle_anybox_queue.cu,
// a slot's spot) and of the one-thread pass (mle_anybox.cu), for the
// boxes that fit_mle.cuh's templates are not built for (any box >= 1
// but the odd boxes 3-15).
//
// It forms the same numbers as fit_mle.cuh's one-thread pass, in the
// same order, from the same pieces (mle_edge, mle_point, mle_column,
// mle_pixel, mle_fold, mle_update, mle_converge, crlb_pixel, crlb_fold,
// crlb_solve); only where the per-spot arrays live differs. The
// templated body holds the ROI and the x axis's column factors in
// S-sized register arrays, which a run-time box cannot size. Here a
// source B (AnyBox below; the queue's slot sources) gives the pixels
// as b(y, x) and five column factors of the x axis as b.at(row, i),
// formed once a step; the y axis's factors are formed row by row from
// the row's two edges, the lower carried from the row before (as crlb_ll
// does). The one-thread pass reads the pixels from the lanes-last
// (s, s, N) batch in each pixel loop and keeps the column factors in a
// lanes-last (5, s, N) workspace; the queue reads the pixels from its
// stage and the column factors from shared memory. At boxes 5-15
// chip_smoke.py holds both to the templated queue bit for bit.
//
// Every sum of products is explicitly rounded, here and in the template
// (the initialiser's too: moment_pixel, moment2, init_photons), so the
// unrolled template and these loops form the same numbers whatever the
// compiler would fuse; the loops whose first trip differs (the first
// pixel of a row, the first row) are peeled as the template unrolls
// them.
//
// What bounds it on the card: as the templated body, issued FP32
// instructions; through AnyBox also the pixel and column-factor loads
// from L1/L2 at every Newton step (6 loads a pixel), which the queue
// coalesces and moves to shared memory.

#pragma once

#include "fit_mle.cuh"

namespace {

// Moment initialiser (init_theta) at box b.s.
template <bool SIG, class B>
__device__ __forceinline__ void any_init_theta(const B& b, float* th,
                                               float* ms) {
  const int s = b.s;
  float total = 0.0f, ysum = 0.0f, xsum = 0.0f;
  for (int y = 0; y < s; ++y)
    for (int x = 0; x < s; ++x) moment_pixel(b(y, x), y, x, total, ysum, xsum);
  float y_com, x_com;
  init_com(s, total, ysum, xsum, y_com, x_com);
  // background: min of the 3x3 edge-clipped mean filter; a column's
  // three-pixel sum is formed where it is used
  auto col3 = [&](int y, int x) {
    const float up = y > 0 ? b(y - 1, x) : 0.0f;
    const float dn = y < s - 1 ? b(y + 1, x) : 0.0f;
    return (up + b(y, x)) + dn;
  };
  float bg = 0.0f;
  for (int y = 0; y < s; ++y)
    for (int x = 0; x < s; ++x) {
      const float lf = x > 0 ? col3(y, x - 1) : 0.0f;
      const float rt = x < s - 1 ? col3(y, x + 1) : 0.0f;
      const float cy = (y == 0 || y == s - 1) ? 2.0f : 3.0f;
      const float cx = (x == 0 || x == s - 1) ? 2.0f : 3.0f;
      const float v = ((lf + col3(y, x)) + rt) / (cy * cx);
      bg = (y == 0 && x == 0) ? v : nmin(bg, v);
    }
  const float photons = init_photons(s, total, bg);
  // second moments of the centre column (along y) and row (along x)
  const int half = s / 2;
  float cnum = 0.0f, cden = 0.0f, rnum = 0.0f, rden = 0.0f;
  for (int k = 0; k < s; ++k) {
    const float d2 = (float)((k - half) * (k - half));
    const float c = b(k, half) - bg;
    const float r = b(half, k) - bg;
    cnum = moment2(k == 0, d2, c, cnum);
    cden = k == 0 ? c : cden + c;
    rnum = moment2(k == 0, d2, r, rnum);
    rden = k == 0 ? r : rden + r;
  }
  init_store<SIG>(x_com, y_com, photons, bg, cnum, cden, rnum, rden, th, ms);
}

// The column factors that the any-box bodies keep a column: the first
// five of mle_column's (dmu, psf, dsig, d2mu, d2sig); the four products
// after them are formed again where a pixel reads them (any_mle_row),
// the same products of the same operands.
constexpr int kAnyCols = 5;

// The x axis's column factors (mle_column's first kAnyCols) at mu,
// sigma into workspace rows 0-4.
template <bool SIG, class B>
__device__ __forceinline__ void any_columns(const B& b, float mu,
                                            float sigma) {
  float inv_s, norm;
  axis_scale(sigma, inv_s, norm);
  float a0, e0, q0;
  mle_edge(b.s, 0, mu, inv_s, a0, e0, q0);
  for (int k = 0; k < b.s; ++k) {
    float a1, e1, q1;
    mle_edge(b.s, k + 1, mu, inv_s, a1, e1, q1);
    float p[5], f[kCols];
    mle_point<SIG>(k, mu, sigma, inv_s, norm, a0, a1, e0, e1, q0, q1, p[0],
                   p[1], p[2], p[3], p[4]);
    mle_column(p[0], p[1], p[2], p[3], p[4], f);
#pragma unroll
    for (int t = 0; t < kAnyCols; ++t) b.at(t, k) = f[t];
    a0 = a1;
    e0 = e1;
    q0 = q1;
  }
}

// The y axis's point j (psf, dmu, d2mu, dsig, d2sig) from its lower edge
// (a0, e0, q0), which moves on to the upper.
template <bool SIG>
__device__ __forceinline__ void any_row_point(int s, int j, float mu,
                                              float sigma, float inv_s,
                                              float norm, float& a0,
                                              float& e0, float& q0,
                                              float* p) {
  float a1, e1, q1;
  mle_edge(s, j + 1, mu, inv_s, a1, e1, q1);
  mle_point<SIG>(j, mu, sigma, inv_s, norm, a0, a1, e0, e1, q0, q1, p[0],
                 p[1], p[2], p[3], p[4]);
  a0 = a1;
  e0 = e1;
  q0 = q1;
}

// Row j of the Newton sums (mle_row) from the workspace's column factors.
template <bool SIG, class B>
__device__ __forceinline__ void any_mle_row(const B& b, int j, float pg,
                                            float bg, float* c) {
  auto pixel = [&](bool first, int i) {
    float f[kCols];
    mle_column(b.at(1, i), b.at(0, i), b.at(3, i), b.at(2, i), b.at(4, i),
               f);
    mle_pixel<SIG>(first, b(j, i), pg, bg, f, c);
  };
  pixel(true, 0);
  // unrolled: independent pixels overlap their latency; each column sum
  // still adds its pixels in order
#pragma unroll 4
  for (int i = 1; i < b.s; ++i) pixel(false, i);
}

// One Newton update (newton_step) at box b.s.
template <bool SIG, class B>
__device__ __forceinline__ void any_newton_step(const B& b, float* th,
                                                const float* ms) {
  any_columns<SIG>(b, th[0], th[4]);
  const float sy = th[SIG ? 4 : 5];
  float isy, ny;
  axis_scale(sy, isy, ny);
  float a0, e0, q0;
  mle_edge(b.s, 0, th[1], isy, a0, e0, q0);
  float a[kDots];
  auto row = [&](bool first, int j) {
    float p[5], c[11];
    any_row_point<SIG>(b.s, j, th[1], sy, isy, ny, a0, e0, q0, p);
    any_mle_row<SIG>(b, j, th[2] * p[0], th[3], c);
    mle_fold(first, p[0], p[1], p[2], p[3], p[4], c, a);
  };
  row(true, 0);
  for (int j = 1; j < b.s; ++j) row(false, j);
  mle_update<SIG>(b.s, a, th, ms);
}

// CRLB and log-likelihood (crlb_ll) at box b.s; overwrites the
// workspace's column factors with those at th.
template <bool SIG, class B>
__device__ __forceinline__ void any_crlb_ll(const B& b, const float* th,
                                            float* crlb, float& ll) {
  const float ph = th[2], bg = th[3];
  const float sy = th[SIG ? 4 : 5];
  any_columns<SIG>(b, th[0], th[4]);
  float isy, ny;
  axis_scale(sy, isy, ny);
  float m[6][6];
  float ll_acc = 0.0f;
  float a0, e0, q0;
  mle_edge(b.s, 0, th[1], isy, a0, e0, q0);
  for (int j = 0; j < b.s; ++j) {
    float p[5];
    any_row_point<SIG>(b.s, j, th[1], sy, isy, ny, a0, e0, q0, p);
    const float pgy = __fmul_rn(ph, p[0]);
    float t[4][4];
    float ll_row = 0.0f;
    // column factors: 0 dmu, 1 psf, 2 dsig (mle_column)
    crlb_pixel(true, b(j, 0), pgy, b.at(1, 0), b.at(0, 0), b.at(2, 0), bg, t,
               ll_row);
#pragma unroll 4
    for (int i = 1; i < b.s; ++i)
      crlb_pixel(false, b(j, i), pgy, b.at(1, i), b.at(0, i), b.at(2, i), bg,
                 t, ll_row);
    crlb_fold(j == 0, p[0], p[1], p[3], t, m);
    ll_acc = j == 0 ? ll_row : __fadd_rn(ll_acc, ll_row);
  }
  crlb_solve<SIG>(m, ph, crlb);
  ll = ll_acc;
}

// The fit of spot n in one pass (mle_fit_spot's FULL mode): initialise,
// up to max_it Newton steps, CRLB and LL, theta/crlb (6, N), ll and
// iters (N,) out. Spots at index >= n_valid start converged.
template <bool SIG>
__device__ void any_mle_fit_spot(const AnyBox& b, long long n, float eps,
                                 int max_it, long long n_valid,
                                 float* theta_out, float* crlb_out,
                                 float* ll_out, int* iters_out) {
  constexpr int R = SIG ? 5 : 6;
  float th[6], old[6], ms[6];
  any_init_theta<SIG>(b, th, ms);
#pragma unroll
  for (int p = 0; p < R; ++p) old[p] = th[p];
  float done = n >= n_valid ? 1.0f : 0.0f, iters = 0.0f;
  for (int kk = 0; kk < max_it; ++kk) {
    if (done > 0.5f) break;
    any_newton_step<SIG>(b, th, ms);
    mle_converge<SIG>(th, old, done, iters, eps);
  }
  float crlb[6], ll;
  any_crlb_ll<SIG>(b, th, crlb, ll);
  if (SIG) th[5] = th[4];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    theta_out[p * b.N + n] = th[p];
    crlb_out[p * b.N + n] = crlb[p];
  }
  ll_out[n] = ll;
  iters_out[n] = (int)iters;
}

}  // namespace
