// MLE fit of the integrated 2D Gaussian for one spot, one thread per
// spot (sm_90a): the body of the K1/K2 kernels (mle_fit.cu) and of the
// fused cut+fit kernel K5 (winfit_mle.cu), templated on the source the
// spot's pixels come from (fit_common.cuh).
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

__device__ __forceinline__ float erfc_from_exp(float a, float e) {
  const float x = fabsf(a) * kInvSqrt2;
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return poly * e;
}

// Per-axis factors (psf, dmu, d2mu, dsig, d2sig) on the grid k - mu,
// k = 0..S-1, from the S+1 shared exponentials (ops/gaussian.py
// fused_axis_terms); with ISO the last two are the isotropic model's
// dPSF and d2PSF (fused_axis_terms_iso).
template <int S, bool ISO>
__device__ __forceinline__ void axis_terms(float mu, float sigma, float* psf,
                                           float* dmu, float* d2mu,
                                           float* dsig, float* d2sig) {
  const float inv_s = 1.0f / sigma;
  float a8[S + 1], e8[S + 1], q8[S + 1];
#pragma unroll
  for (int k = 0; k < S; ++k) a8[k] = (((float)k - mu) - 0.5f) * inv_s;
  a8[S] = (((float)(S - 1) - mu) + 0.5f) * inv_s;
#pragma unroll
  for (int k = 0; k <= S; ++k) {
    e8[k] = expf(-0.5f * a8[k] * a8[k]);
    q8[k] = erfc_from_exp(a8[k], e8[k]);
  }
  const float norm = inv_s / kSqrt2Pi;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float ap = a8[k + 1], am = a8[k];
    const float ea = e8[k + 1], eb = e8[k];
    const float qa = q8[k + 1], qb = q8[k];
    psf[k] = am >= 0.0f ? 0.5f * (qb - qa)
                        : (ap <= 0.0f ? 0.5f * (qa - qb)
                                      : 0.5f * (2.0f - qa - qb));
    const float d = (float)k - mu;
    const float dm = d - 0.5f, dp = d + 0.5f;
    dmu[k] = (eb - ea) * norm;
    const float g1 = (dm * eb - dp * ea) * norm;
    d2mu[k] = g1 * inv_s * inv_s;
    if constexpr (ISO) {
      const float F = (am * eb - ap * ea) * kInvSqrt2;
      dsig[k] = F / (kSqrtPi * sigma);
      const float dF =
          ((ap * ea) * (1.0f - ap * ap) - (am * eb) * (1.0f - am * am)) *
          kInvSqrt2 * inv_s;
      d2sig[k] = kInvSqrtPi * ((-F * inv_s) * inv_s + dF * inv_s);
    } else {
      dsig[k] = g1 * inv_s;
      const float g3 = (dm * dm * dm * eb - dp * dp * dp * ea) * norm;
      d2sig[k] = (g3 * inv_s * inv_s - 2.0f * g1) * inv_s * inv_s;
    }
  }
}

// Moment initialiser (ops/mle.py initial_theta_sigmaxy_t, _init_state)
// and max_step.
template <int S, bool SIG, class Src>
__device__ void init_theta(const Src& px, float* th, float* ms) {
  float total = 0.0f, ysum = 0.0f, xsum = 0.0f;
#pragma unroll
  for (int y = 0; y < S; ++y)
#pragma unroll
    for (int x = 0; x < S; ++x) {
      const float v = px(y, x);
      total += v;
      ysum += v * (float)y;
      xsum += v * (float)x;
    }
  float y_com = ysum / total, x_com = xsum / total;
  if (total <= 0.0f) {
    total = 0.01f;
    y_com = x_com = (S - 1) / 2.0f;
  }
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
  const float photons = nmax(total - (float)(S * S) * bg, 1.0f);
  // second moments of the centre column (along y) and row (along x)
  constexpr int half = S / 2;
  float cnum = 0.0f, cden = 0.0f, rnum = 0.0f, rden = 0.0f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float d2 = (float)((k - half) * (k - half));
    const float c = px(k, half) - bg;
    const float r = px(half, k) - bg;
    cnum = k == 0 ? d2 * c : cnum + d2 * c;
    cden = k == 0 ? c : cden + c;
    rnum = k == 0 ? d2 * r : rnum + d2 * r;
    rden = k == 0 ? r : rden + r;
  }
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

// One Newton update (ops/mle.py _newton_step_sigmaxy, or with SIG
// _newton_step_sigma). Outer loop over rows y = j; each row's sums over
// the columns i are the JAX package's row accumulators Tc/Td[j], formed
// in the same order, then folded into the row dots. With SIG, dsig/d2sig
// hold the isotropic dPSF/d2PSF and the fifth parameter is sigma.
template <int S, bool SIG, class Src>
__device__ void newton_step(const Src& px, float* th, const float* ms) {
  constexpr int R = SIG ? 5 : 6;
  const float ph = th[2], bg = th[3];
  float psf_x[S], dmu_x[S], d2mu_x[S], dsig_x[S], d2sig_x[S];
  float psf_y[S], dmu_y[S], d2mu_y[S], dsig_y[S], d2sig_y[S];
  axis_terms<S, SIG>(th[0], th[4], psf_x, dmu_x, d2mu_x, dsig_x, d2sig_x);
  axis_terms<S, SIG>(th[1], th[SIG ? 4 : 5], psf_y, dmu_y, d2mu_y, dsig_y,
                     d2sig_y);
  const float ph2 = ph * ph;

  // row dots: sum_j A[j] * T[j]
  float a_py_c0 = 0, a_dy_c1 = 0, a_py_c1 = 0, a_c5 = 0, a_py_c2 = 0,
        a_sy_c1 = 0, a_py_c3 = 0, a_py2_d0 = 0, a_d2y_c1 = 0,
        a_dy2_d1 = 0, a_py2_d1 = 0, a_d3 = 0, a_py_c4 = 0, a_py2_d2 = 0,
        a_s2y_c1 = 0, a_sy2_d1 = 0, a_sy_c2 = 0, a_pys_d3 = 0, a_d4 = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float c0 = 0, c1 = 0, c2 = 0, c3 = 0, c4 = 0, c5 = 0;
    float d0 = 0, d1 = 0, d2 = 0, d3 = 0, d4 = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float data = px(j, i);
      const float model = ph * psf_y[j] * psf_x[i] + bg;
      const bool valid = model > 10e-3f;
      const float r = 1.0f / model;
      const float dr = data * r;
      const float cf = nmin(valid ? dr - 1.0f : 0.0f, 10e4f);
      const float df = nmin(valid ? dr * r : 0.0f, 10e4f);
      // sigmaxy: d3 = df; sigma: d3 = df * dPSF*psf, d4 = df
      const float e3 = SIG ? df * (dsig_x[i] * psf_x[i]) : df;
      if (i == 0) {
        c0 = cf * dmu_x[i];
        c1 = cf * psf_x[i];
        c2 = cf * dsig_x[i];
        c3 = cf * d2mu_x[i];
        c4 = cf * d2sig_x[i];
        c5 = cf;
        d0 = df * (dmu_x[i] * dmu_x[i]);
        d1 = df * (psf_x[i] * psf_x[i]);
        d2 = df * (dsig_x[i] * dsig_x[i]);
        d3 = e3;
        d4 = df;
      } else {
        c0 = c0 + cf * dmu_x[i];
        c1 = c1 + cf * psf_x[i];
        c2 = c2 + cf * dsig_x[i];
        c3 = c3 + cf * d2mu_x[i];
        c4 = c4 + cf * d2sig_x[i];
        c5 = c5 + cf;
        d0 = d0 + df * (dmu_x[i] * dmu_x[i]);
        d1 = d1 + df * (psf_x[i] * psf_x[i]);
        d2 = d2 + df * (dsig_x[i] * dsig_x[i]);
        d3 = d3 + e3;
        d4 = d4 + df;
      }
    }
    const float py = psf_y[j], py2 = psf_y[j] * psf_y[j];
    const float dy2 = dmu_y[j] * dmu_y[j], sy2 = dsig_y[j] * dsig_y[j];
    const float pys = psf_y[j] * dsig_y[j];
    if (j == 0) {
      a_py_c0 = py * c0;
      a_dy_c1 = dmu_y[j] * c1;
      a_py_c1 = py * c1;
      a_c5 = c5;
      a_py_c2 = py * c2;
      a_sy_c1 = dsig_y[j] * c1;
      a_py_c3 = py * c3;
      a_py2_d0 = py2 * d0;
      a_d2y_c1 = d2mu_y[j] * c1;
      a_dy2_d1 = dy2 * d1;
      a_py2_d1 = py2 * d1;
      a_d3 = d3;
      a_py_c4 = py * c4;
      a_py2_d2 = py2 * d2;
      a_s2y_c1 = d2sig_y[j] * c1;
      a_sy2_d1 = sy2 * d1;
      a_sy_c2 = dsig_y[j] * c2;
      a_pys_d3 = pys * d3;
      a_d4 = d4;
    } else {
      a_py_c0 = a_py_c0 + py * c0;
      a_dy_c1 = a_dy_c1 + dmu_y[j] * c1;
      a_py_c1 = a_py_c1 + py * c1;
      a_c5 = a_c5 + c5;
      a_py_c2 = a_py_c2 + py * c2;
      a_sy_c1 = a_sy_c1 + dsig_y[j] * c1;
      a_py_c3 = a_py_c3 + py * c3;
      a_py2_d0 = a_py2_d0 + py2 * d0;
      a_d2y_c1 = a_d2y_c1 + d2mu_y[j] * c1;
      a_dy2_d1 = a_dy2_d1 + dy2 * d1;
      a_py2_d1 = a_py2_d1 + py2 * d1;
      a_d3 = a_d3 + d3;
      a_py_c4 = a_py_c4 + py * c4;
      a_py2_d2 = a_py2_d2 + py2 * d2;
      a_s2y_c1 = a_s2y_c1 + d2sig_y[j] * c1;
      a_sy2_d1 = a_sy2_d1 + sy2 * d1;
      a_sy_c2 = a_sy_c2 + dsig_y[j] * c2;
      a_pys_d3 = a_pys_d3 + pys * d3;
      a_d4 = a_d4 + d4;
    }
  }
  float num[R], den[R];
  num[0] = ph * a_py_c0;
  num[1] = ph * a_dy_c1;
  num[2] = a_py_c1;
  num[3] = a_c5;
  den[0] = ph * a_py_c3 - ph2 * a_py2_d0;
  den[1] = ph * a_d2y_c1 - ph2 * a_dy2_d1;
  den[2] = -a_py2_d1;
  if constexpr (SIG) {
    den[3] = -a_d4;
    num[4] = ph * (a_py_c2 + a_sy_c1);
    // d2udt2_sigma: photons multiply only the first term (reference quirk)
    const float cf_sig = (ph * a_py_c4 + 2.0f * a_sy_c2) + a_s2y_c1;
    const float df_sig = ph2 * ((a_py2_d2 + 2.0f * a_pys_d3) + a_sy2_d1);
    den[4] = cf_sig - df_sig;
  } else {
    den[3] = -a_d3;
    num[4] = ph * a_py_c2;
    num[5] = ph * a_sy_c1;
    den[4] = ph * a_py_c4 - ph2 * a_py2_d2;
    den[5] = ph * a_s2y_c1 - ph2 * a_sy2_d1;
  }
#pragma unroll
  for (int p = 0; p < R; ++p) {
    // sigma's zero-denominator step is sign(num * max_step), i.e. +-1
    const float zero_step =
        SIG ? nsign(num[p] * ms[p]) : nsign(num[p]) * ms[p];
    const float upd = den[p] == 0.0f
                          ? zero_step
                          : nmin(nmax(num[p] / den[p], -ms[p]), ms[p]);
    th[p] = th[p] - upd;
  }
  // constraints (picasso/gaussmle.py:880-884)
  th[2] = nmax(th[2], 1.0f);
  th[3] = nmax(th[3], 0.01f);
  if constexpr (SIG) {
    th[4] = nmin(nmax(th[4], 0.01f), (float)S);
  } else {
    th[4] = nmax(th[4], 0.01f);
    th[5] = nmax(th[5], 0.01f);
  }
}

// One Newton step of a lane that has not converged (ops/mle.py
// _run_newton_rounds, one iteration of one lane): iters counts before
// the convergence test, which compares rows (0, 1, 4, 5) (sigma: 0, 1)
// against `old`; a converged lane keeps its theta and old.
template <int S, bool SIG, class Src>
__device__ __forceinline__ void newton_trip(const Src& px, float* th,
                                            float* old, float& done,
                                            float& iters, const float* ms,
                                            float eps) {
  constexpr int R = SIG ? 5 : 6;
  newton_step<S, SIG>(px, th, ms);
  iters = iters + (1.0f - done);
  bool conv = fabsf(old[0] - th[0]) < eps && fabsf(old[1] - th[1]) < eps;
  if constexpr (!SIG)
    conv = conv && fabsf(old[4] - th[4]) < eps && fabsf(old[5] - th[5]) < eps;
  if (conv) {
    done = 1.0f;
  } else {
#pragma unroll
    for (int p = 0; p < R; ++p) old[p] = th[p];
  }
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
__device__ __forceinline__ int bcol(int p) {
  return p == 0 ? 0 : (p == 3 ? 2 : (p == 4 ? 3 : 1));
}

template <int S, bool SIG, class Src>
__device__ void crlb_ll(const Src& px, const float* th, float* crlb,
                        float& ll) {
  constexpr int P = SIG ? 5 : 6;
  const float ph = th[2], bg = th[3];
  float psf_x[S], dmu_x[S], d2mu_x[S], dsig_x[S], d2sig_x[S];
  float psf_y[S], dmu_y[S], d2mu_y[S], dsig_y[S], d2sig_y[S];
  axis_terms<S, SIG>(th[0], th[4], psf_x, dmu_x, d2mu_x, dsig_x, d2sig_x);
  axis_terms<S, SIG>(th[1], th[SIG ? 4 : 5], psf_y, dmu_y, d2mu_y, dsig_y,
                     d2sig_y);
  // Separable first-derivative terms t = 0..5: row factor A[t], column
  // factor bcol(t), scale sc[t]. sigmaxy: term t is parameter t. sigma:
  // terms 4 and 5 are the two halves of d/dsigma (parameter 4). Distinct
  // column factors: 0 dmu_x, 1 psf_x, 2 ones, 3 dsig_x.
  float m[6][6];
  float ll_acc = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    float t[4][4];
    float ll_row = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float data = px(j, i);
      const float model = ph * psf_y[j] * psf_x[i] + bg;
      const float w = 1.0f / model;
      const float b[4] = {dmu_x[i], psf_x[i], 1.0f, dsig_x[i]};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = a; c < 4; ++c) {
          const float v = w * (b[a] * b[c]);
          t[a][c] = i == 0 ? v : t[a][c] + v;
        }
      float lli = data > 0.0f
                      ? ((data * logf(model) - model) - data * logf(data)) +
                            data
                      : -model;
      if (!(model > 0.0f)) lli = 0.0f;
      ll_row = i == 0 ? lli : ll_row + lli;
    }
    const float A[6] = {psf_y[j], dmu_y[j], psf_y[j],
                        1.0f,     psf_y[j], dsig_y[j]};
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int q = p; q < 6; ++q) {
        const int a = min(bcol(p), bcol(q));
        const int c = max(bcol(p), bcol(q));
        const float v = (A[p] * A[q]) * t[a][c];
        m[p][q] = j == 0 ? v : m[p][q] + v;
      }
    ll_acc = j == 0 ? ll_row : ll_acc + ll_row;
  }
  const float sc[6] = {ph, ph, 1.0f, 1.0f, ph, ph};
  // Fisher matrix (upper triangle): sum over the term pairs of each
  // parameter pair, in the order of ops/mle.py _crlb_and_likelihood
  float M[P][P];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int q = p; q < P; ++q) M[p][q] = (sc[p] * sc[q]) * m[p][q];
  if constexpr (SIG) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      M[p][4] = (sc[p] * ph) * m[p][4] + (sc[p] * ph) * m[p][5];
    const float pp = ph * ph;
    M[4][4] = ((pp * m[4][4] + pp * m[4][5]) + pp * m[4][5]) + pp * m[5][5];
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
    for (int j = 0; j <= i; ++j) L[i][j] = (M[j][i] * dinv[i]) * dinv[j];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float s = L[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(s);
    const float inv_d = 1.0f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      float si = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) si = si - L[i][k] * L[j][k];
      L[i][j] = si * inv_d;
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float z[P];
    z[k] = 1.0f / L[k][k];
    float acc = z[k] * z[k];
#pragma unroll
    for (int j = k + 1; j < P; ++j) {
      float s = -(L[j][k] * z[k]);
#pragma unroll
      for (int mm = k + 1; mm < j; ++mm) s = s - L[j][mm] * z[mm];
      z[j] = s / L[j][j];
      acc = acc + z[j] * z[j];
    }
    crlb[k] = acc * (dinv[k] * dinv[k]);
  }
  if constexpr (SIG) crlb[5] = crlb[4];
  ll = ll_acc;
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

}  // namespace
