// Least-squares fit of the plain elliptic 2D Gaussian by
// Levenberg-Marquardt for one spot, one thread per spot (sm_90a): the
// body of the K3/K6 kernels (lq_fit.cu) and of the fused cut+fit kernel
// K5 (winfit_lq.cu), templated on the source the spot's pixels come from
// (fit_common.cuh).
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
// are row factor x column factor).
//
// Numerics follow the JAX package: sums in its order (per-row sums over
// the columns, then over the rows), IEEE division and sqrt, expf without
// fast math, NaN-propagating maxima and minima (fmaxf would drop a NaN).

#pragma once

#include "fit_common.cuh"

namespace {

constexpr float kNorm = 0.3989422804014327f;  // 1 / sqrt(2 pi)

// Axis factor g(k) = norm/sigma * exp(-u^2/2), u = (k - S/2 - mu)/sigma,
// and, when D, its derivatives d/dmu and d/dsigma (ops/lq._axis_factors).
template <int S, bool D>
__device__ __forceinline__ void axis(float mu, float sigma, float* g,
                                     float* dg, float* ds) {
  constexpr int half = S / 2;
  const float inv = 1.0f / sigma;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float d = (float)(k - half) - mu;
    const float u = d * inv;
    g[k] = (kNorm * inv) * expf(-0.5f * (u * u));
    if constexpr (D) {
      dg[k] = ((g[k] * d) * inv) * inv;
      ds[k] = (g[k] * inv) * (u * u - 1.0f);
    }
  }
}

// Sum of squared residuals (ops/lq._cost).
template <int S, class Src>
__device__ float cost(const Src& px, const float* th) {
  float gx[S], gy[S];
  axis<S, false>(th[0], th[4], gx, nullptr, nullptr);
  axis<S, false>(th[1], th[5], gy, nullptr, nullptr);
  const float ph = th[2], bg = th[3];
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float pg = ph * gy[j];
    float row = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float r = px(j, i) - (pg * gx[i] + bg);
      row = i == 0 ? r * r : row + r * r;
    }
    total = j == 0 ? row : total + row;
  }
  return total;
}

// Moment initialiser (ops/lq.initial_parameters_t).
template <int S, class Src>
__device__ void lq_init_theta(const Src& px, float* th) {
  constexpr int half = S / 2;
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
    for (int x = 0; x < S; ++x) {
      const float v = px(y, x) - bg;
      const bool first = y == 0 && x == 0;
      total = first ? v : total + v;
      ysum = first ? v * (float)y : ysum + v * (float)y;
      xsum = first ? v * (float)x : xsum + v * (float)x;
    }
  float y_com = ysum / total, x_com = xsum / total;
  if (total <= 0.0f) {
    total = 0.01f;
    y_com = x_com = (S - 1) / 2.0f;
  }
  float syy = 0.0f, sxx = 0.0f;
#pragma unroll
  for (int y = 0; y < S; ++y)
#pragma unroll
    for (int x = 0; x < S; ++x) {
      const float v = px(y, x) - bg;
      const float dy = (float)y - y_com, dx = (float)x - x_com;
      const bool first = y == 0 && x == 0;
      syy = first ? v * (dy * dy) : syy + v * (dy * dy);
      sxx = first ? v * (dx * dx) : sxx + v * (dx * dx);
    }
  th[0] = x_com - (float)half;
  th[1] = y_com - (float)half;
  th[2] = nmax(total, 1.0f);
  th[3] = bg;
  th[4] = sqrtf(sxx / total);
  th[5] = sqrtf(syy / total);
}

// One LM iteration of a lane that is not done (ops/lq._lm_step).
template <int S, class Src>
__device__ void lm_step(const Src& px, float* th, float& lam, float& cst,
                        float& done, float ftol) {
  float gx[S], gy[S], dgx[S], dgy[S], dsx[S], dsy[S];
  axis<S, true>(th[0], th[4], gx, dgx, dsx);
  axis<S, true>(th[1], th[5], gy, dgy, dsy);
  const float ph = th[2], bg = th[3];

  // J^T r: per row j the column sums over i, folded into the row dots
  float j0 = 0, j1 = 0, j2 = 0, j3 = 0, j4 = 0, j5 = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float pg = ph * gy[j];
    float c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float r = px(j, i) - (pg * gx[i] + bg);
      if (i == 0) {
        c0 = r * dgx[i];
        c1 = r * gx[i];
        c2 = r * dsx[i];
        c3 = r;
      } else {
        c0 = c0 + r * dgx[i];
        c1 = c1 + r * gx[i];
        c2 = c2 + r * dsx[i];
        c3 = c3 + r;
      }
    }
    if (j == 0) {
      j0 = gy[j] * c0;
      j1 = dgy[j] * c1;
      j2 = gy[j] * c1;
      j3 = c3;
      j4 = gy[j] * c2;
      j5 = dsy[j] * c1;
    } else {
      j0 = j0 + gy[j] * c0;
      j1 = j1 + dgy[j] * c1;
      j2 = j2 + gy[j] * c1;
      j3 = j3 + c3;
      j4 = j4 + gy[j] * c2;
      j5 = j5 + dsy[j] * c1;
    }
  }
  const float jtr[6] = {ph * j0, ph * j1, j2, j3, ph * j4, ph * j5};

  // J^T J from dot products of the axis factors. Row factors (over y):
  // 0 gy, 1 dgy, 2 ones, 3 dsy; column factors (over x): 0 dgx, 1 gx,
  // 2 ones, 3 dsx. Parameter p uses row factor ar[p], column factor
  // bc[p] and scale photons (x, y, sx, sy) or 1 (photons, bg).
  float sa[4][4], sb[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = u; v < 4; ++v) {
      float acc_a = 0.0f, acc_b = 0.0f;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const float a[4] = {gy[k], dgy[k], 1.0f, dsy[k]};
        const float b[4] = {dgx[k], gx[k], 1.0f, dsx[k]};
        acc_a = k == 0 ? a[u] * a[v] : acc_a + a[u] * a[v];
        acc_b = k == 0 ? b[u] * b[v] : acc_b + b[u] * b[v];
      }
      sa[u][v] = sa[v][u] = acc_a;
      sb[u][v] = sb[v][u] = acc_b;
    }
  const int ar[6] = {0, 1, 0, 2, 0, 3};
  const int bc[6] = {0, 1, 1, 2, 3, 1};
  const float sc[6] = {ph, ph, 1.0f, 1.0f, ph, ph};
  // lower triangle of the damped matrix, then Cholesky (ops/linalg.py)
  float L[6][6];
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = 0; q <= p; ++q) {
      const float v = ((sc[q] * sc[p]) * sa[ar[q]][ar[p]]) * sb[bc[q]][bc[p]];
      L[p][q] = p == q ? v * (1.0f + lam) : v;
    }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = L[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(s);
    const float inv_d = 1.0f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float si = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) si = si - L[i][k] * L[j][k];
      L[i][j] = si * inv_d;
    }
  }
  float z[6], delta[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = jtr[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * z[k];
    z[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = z[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * delta[k];
    delta[i] = s / L[i][i];
  }
  bool finite = true;
#pragma unroll
  for (int p = 0; p < 6; ++p) finite = finite && isfinite(delta[p]);
  float trial[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) trial[p] = th[p] + (finite ? delta[p] : 0.0f);
  const float tc = cost<S>(px, trial);
  const bool improved = finite && tc < cst;
  if (improved) {
    const float rel = fabsf(cst - tc) / nmax(cst, 1e-20f);
#pragma unroll
    for (int p = 0; p < 6; ++p) th[p] = trial[p];
    cst = tc;
    lam = nmax(lam * 0.1f, 1e-9f);
    if (rel < ftol) done = 1.0f;
  } else {
    lam = nmin(lam * 10.0f, 1e7f);
  }
  if (lam >= 1e7f) done = 1.0f;
}

// The LM fit of spot n in one mode. FULL/START initialise from the
// pixels, RESUME loads the carry (theta (6, N), lam/cost/done (N,)); FULL
// writes theta only, START/RESUME the whole carry.
template <int S, class Src>
__device__ __forceinline__ void lq_fit_spot(const Src& px, long long n,
                                            long long N, float ftol, int k,
                                            int mode, long long n_valid,
                                            float* theta, float* lam_c,
                                            float* cost_c, float* done_c) {
  float th[6], lam, cst, done;
  if (mode == kResume) {
#pragma unroll
    for (int p = 0; p < 6; ++p) th[p] = theta[p * N + n];
    lam = lam_c[n];
    cst = cost_c[n];
    done = done_c[n];
  } else {
    lq_init_theta<S>(px, th);
    cst = cost<S>(px, th);
    lam = 1e-3f;
    done = n >= n_valid ? 1.0f : 0.0f;
  }
  for (int kk = 0; kk < k; ++kk) {
    if (done > 0.5f) break;
    lm_step<S>(px, th, lam, cst, done, ftol);
  }
#pragma unroll
  for (int p = 0; p < 6; ++p) theta[p * N + n] = th[p];
  if (mode == kFull) return;
  lam_c[n] = lam;
  cost_c[n] = cst;
  done_c[n] = done;
}

}  // namespace
