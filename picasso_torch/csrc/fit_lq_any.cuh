// The Levenberg-Marquardt fit of one spot at a box known only at run
// time, one thread a spot (sm_90a): the body of lq_anybox.cu, for the
// boxes that fit_lq.cuh's templates are not built for.
//
// It forms fit_lq.cuh's numbers in its order from the same pieces
// (axis_point, jtr_pixel, jtr_fold, dot_point's products, normal_assemble,
// cost_pixel, damped_trial, lm_accept); only where the per-spot arrays
// live differs. The pixels are read from the lanes-last (s, s, N) batch
// in each pixel loop, and the axis factors go to the spot's column of a
// lanes-last (7, s, N) workspace: rows 0-2 gx, dgx, dsx and 3-5 gy, dgy,
// dsy of the normal equations, row 6 the trial's gx of the cost. Its
// operations are all explicitly rounded, as the template's are, so the
// two form the same numbers. At boxes 5-15 chip_smoke.py holds it to the
// templated queue bit for bit. What bounds it: as fit_lq.cuh, issued FP32
// instructions, now with the loads of every pixel and factor from L1/L2.

#pragma once

#include "fit_lq.cuh"

namespace {

// Moment initialiser (lq_init_theta) at box b.s: the pixels in row-major
// order, as the template's.
__device__ void any_lq_init_theta(const AnyBox& b, float* th) {
  const int s = b.s;
  float bg = b(0, 0);
  for (int y = 0; y < s; ++y)
    for (int x = y == 0 ? 1 : 0; x < s; ++x) bg = nmin(bg, b(y, x));
  float total = 0.0f, ysum = 0.0f, xsum = 0.0f;
  for (int y = 0; y < s; ++y)
    for (int x = 0; x < s; ++x)
      lq_moments(y == 0 && x == 0, b(y, x) - bg, y, x, total, ysum, xsum);
  float y_com, x_com;
  lq_com(s, total, ysum, xsum, y_com, x_com);
  float syy = 0.0f, sxx = 0.0f;
  for (int y = 0; y < s; ++y)
    for (int x = 0; x < s; ++x)
      lq_moments2(y == 0 && x == 0, b(y, x) - bg, y, x, y_com, x_com, syy,
                  sxx);
  lq_init_store(s / 2, x_com, y_com, total, bg, sxx, syy, th);
}

// The normal equations at theta th (normal_equations): J^T r (6) and the
// lower triangle of J^T J (21).
__device__ void any_normal_equations(const AnyBox& b, const float* th,
                                     float* a, float* jtr) {
  const int s = b.s, half = s / 2;
  const float ix = __fdiv_rn(1.0f, th[4]), iy = __fdiv_rn(1.0f, th[5]);
  for (int k = 0; k < s; ++k) {
    axis_point<true>(half, k, th[0], ix, b.at(0, k), b.at(1, k), b.at(2, k));
    axis_point<true>(half, k, th[1], iy, b.at(3, k), b.at(4, k), b.at(5, k));
  }
  const float ph = th[2], bg = th[3];
  float jd[6];
  auto row = [&](bool first, int j) {
    const float pg = __fmul_rn(ph, b.at(3, j));
    float c[4];
    jtr_pixel(true, b(j, 0), pg, bg, b.at(0, 0), b.at(1, 0), b.at(2, 0), c);
    for (int i = 1; i < s; ++i)
      jtr_pixel(false, b(j, i), pg, bg, b.at(0, i), b.at(1, i), b.at(2, i),
                c);
    jtr_fold(first, b.at(3, j), b.at(4, j), b.at(5, j), c, jd);
  };
  row(true, 0);
  for (int j = 1; j < s; ++j) row(false, j);
  // the 1D dot products, each summed over k in order
  float sa[4][4], sb[4][4];
  auto point = [&](bool first, int k) {
    const float ra[4] = {b.at(3, k), b.at(4, k), 1.0f, b.at(5, k)};
    const float cb[4] = {b.at(1, k), b.at(0, k), 1.0f, b.at(2, k)};
    dot_point(first, ra, cb, sa, sb);
  };
  point(true, 0);
  for (int k = 1; k < s; ++k) point(false, k);
  normal_assemble(sa, sb, ph, jd, a, jtr);
}

// Sum of squared residuals at theta th (cost): workspace row 6 takes
// the x axis's factor, the y axis's is formed row by row.
__device__ float any_cost(const AnyBox& b, const float* th) {
  const int s = b.s, half = s / 2;
  const float ix = __fdiv_rn(1.0f, th[4]), iy = __fdiv_rn(1.0f, th[5]);
  float unused;
  for (int k = 0; k < s; ++k)
    axis_point<false>(half, k, th[0], ix, b.at(6, k), unused, unused);
  float total = 0.0f;
  for (int j = 0; j < s; ++j) {
    float gy;
    axis_point<false>(half, j, th[1], iy, gy, unused, unused);
    const float pg = __fmul_rn(th[2], gy);
    float row = cost_pixel(true, b(j, 0), pg, th[3], b.at(6, 0), 0.0f);
    for (int i = 1; i < s; ++i)
      row = cost_pixel(false, b(j, i), pg, th[3], b.at(6, i), row);
    total = j == 0 ? row : __fadd_rn(total, row);
  }
  return total;
}

// The LM fit of spot n in one pass (lq_fit_spot): initialise, up to k
// iterations, theta (6, N) out. Spots at index >= n_valid start done.
__device__ void any_lq_fit_spot(const AnyBox& b, long long n, float ftol,
                                int k, long long n_valid, float* theta) {
  float th[6];
  any_lq_init_theta(b, th);
  float cst = any_cost(b, th);
  float lam = 1e-3f;
  float done = n >= n_valid ? 1.0f : 0.0f;
  float a[21], jtr[6];
  bool fresh = true;
  for (int kk = 0; kk < k; ++kk) {
    if (done > 0.5f) break;
    if (fresh) any_normal_equations(b, th, a, jtr);
    float trial[6];
    const bool finite = damped_trial(a, jtr, th, lam, trial);
    fresh = lm_accept(any_cost(b, trial), finite, trial, th, lam, cst, done,
                      ftol);
  }
#pragma unroll
  for (int p = 0; p < 6; ++p) theta[p * b.N + n] = th[p];
}

}  // namespace
