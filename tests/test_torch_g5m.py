"""G5M of the port held against picasso_tpu on the CPU: the batched EM's
functions (picasso_torch.ops.gmm), one EM from the same centers, the
kmeans++ sampler, the host route (G5M models, model selection, sum_G5Ms,
the bootstrap, g5m below 8 groups), the batched route (g5m from 8
groups), the g5m verb, and the device rule of the entry points.

Inputs: clusters of 1-3 molecules 0.15-0.6 px apart, 60-200 locs each,
precisions 0.02-0.04 px (2D), and with z (nm) for 3D.

Tolerances, with what was measured on the CPU (numpy 2, torch 2.13, jax
0.9; f32 on both sides, torch's exp/log/sums against XLA's):
- _log_gaussian within LOGP_REL of max(|value|, 1) (measured 2.0e-6; a
  log density near 0 takes the error of its terms), _e_step's
  lower bound within LB_ABS (1.9e-6) and log responsibilities within
  RESP_ABS (1.5e-5), _m_step within MSTEP_REL relative (1.4e-6),
  bic_batched within BIC_REL (2.1e-7); pad_clusters equal;
- _sparrow_ok's flags equal but for clusters with a pair whose strongest
  local minimum lies within SPARROW_ULPS f32 ulps of none (printed);
- one EM from the same centers against a loop over JAX's _e_step and
  _m_step with its freeze rule and 100-step cap: converged flags and
  valid components equal; where K is at most the cluster's molecules,
  weights within EM_W (measured 3.9e-5), means within EM_M px (7.6e-6,
  2 f32 ulps at 30 px), covariances within EM_CV relative (1.7e-4),
  lower bounds within EM_LB (8.6e-6); where K exceeds them the EM walks
  a flat likelihood that amplifies the rounding: within OVER_W (1.9e-3),
  OVER_M px (1.4e-3), OVER_CV (2.2e-2) and OVER_LB (9.4e-4);
- the host route equal to JAX's, field for field and dtype for dtype
  (both run the same numpy f64 code with the same default_rng(42)
  draws);
- the batched route (whose draws are not jax.random's) against JAX's: the
  same molecule count per group_input, centers within BATCH_PX px (the
  bound of JAX's own batched-against-serial test) and both within
  TRUTH_PX px of the truth; the port's size buckets equal one bucket
  bit for bit.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from picasso_tpu import g5m as jg
from picasso_tpu.ops import gmm as jgmm
from picasso_torch import g5m as tg
from picasso_torch.ops import gmm as tgmm

LOGP_REL = 1e-5
LB_ABS = 1e-5
RESP_ABS = 1e-4
MSTEP_REL = 1e-5
BIC_REL = 1e-6
SPARROW_ULPS = 8
EM_W, EM_M, EM_CV, EM_LB = 1e-4, 2e-5, 5e-4, 3e-5
OVER_W, OVER_M, OVER_CV, OVER_LB = 5e-3, 5e-3, 0.1, 3e-3
BATCH_PX, TRUTH_PX = 0.02, 0.05
INFO = [{"Frames": 1000, "Height": 64, "Width": 64, "Pixelsize": 130}]
CALIB = {"X Coefficients": [1.0], "Y Coefficients": [1.0],
         "Magnification factor": 0.79}
BOUNDS = (0.8, 1.5)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """JAX's default routes (no override), torch on few threads."""
    monkeypatch.delenv("PICASSO_TPU_G5M", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _clusters(seed: int, n: int, D: int = 2, sizes=(60, 200)):
    """(points, precisions, molecules) of ``n`` clusters on a 3 px grid:
    cluster i holds 1 + i % 3 molecules 0.15-0.6 px apart (z in px)."""
    rng = np.random.default_rng(seed)
    Xs, lps, truth = [], [], []
    for i in range(n):
        k = 1 + i % 3
        centre = np.array([5 + 3 * (i % 10), 5 + 3 * (i // 10)] + [0] * (
            D - 2), np.float64)
        mols = centre + np.vstack([np.zeros(D)] + [
            rng.uniform(0.15, 0.3, D) * rng.choice([-1, 1], D)
            for _ in range(k - 1)])
        size = int(rng.integers(*sizes))
        lp = rng.uniform(0.02, 0.04, size)
        pts = mols[rng.integers(0, k, size)] + rng.normal(0, 1, (
            size, D)) * lp[:, None]
        Xs.append(pts)
        lps.append(lp if D == 2 else np.column_stack([lp, lp, lp]))
        truth.append(mols)
    return Xs, lps, truth


def _locs(Xs, lps, seed: int = 5, D: int = 2) -> np.ndarray:
    """The clusters as a grouped locs table (z in nm), events spread over
    time."""
    rng = np.random.default_rng(seed)
    fields = [("frame", np.uint32), ("x", np.float32), ("y", np.float32)]
    fields += [("z", np.float32)] if D == 3 else []
    fields += [("photons", np.float32), ("lpx", np.float32),
               ("lpy", np.float32)]
    fields += [("lpz", np.float32)] if D == 3 else []
    fields += [("group", np.int32)]
    out = []
    for g, (pts, lp) in enumerate(zip(Xs, lps)):
        t = np.zeros(len(pts), fields)
        t["frame"] = np.sort(rng.integers(0, 950, len(pts)))
        t["x"], t["y"] = pts[:, 0], pts[:, 1]
        lp1 = lp if lp.ndim == 1 else lp[:, 0]
        t["lpx"], t["lpy"] = lp1, lp1
        if D == 3:
            t["z"] = pts[:, 2] * 130
            t["lpz"] = 2 * lp1 * 130
        t["photons"] = rng.uniform(500, 5000, len(pts))
        t["group"] = g
        out.append(t)
    return np.concatenate(out)


def _df(locs):
    return pd.DataFrame.from_records(locs)


def _records(df):
    return df.to_records(index=False)


def _assert_tables_equal(got, want):
    """A port table and a JAX DataFrame: the same fields in the same
    order, each of the same dtype and equal."""
    want = _records(want)
    assert got.dtype.names == want.dtype.names
    for n in got.dtype.names:
        assert got.dtype[n] == want.dtype[n], n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def _padded(seed: int, D: int, K: int = 3, G: int = 12):
    Xs, lps, _ = _clusters(seed, G, D)
    X, mask, lp = tgmm.pad_clusters(Xs, lps, 256)
    rng = np.random.default_rng(seed + 1)
    means = X[:, :K].copy()
    shape = (G, K) if D == 2 else (G, K, D)
    prec = rng.uniform(20, 40, shape).astype(np.float32)
    w = rng.uniform(0.2, 1, (G, K)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    return Xs, lps, X, mask, lp, means, prec, w


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _j(*a):
    return [jnp.asarray(x) for x in a]


# --- ops/gmm against JAX's functions ------------------------------------


@pytest.mark.parametrize("D", [2, 3])
def test_gmm_functions_match_jax(D):
    """_log_gaussian, _e_step, _m_step (local and absolute bounds),
    bic_batched and pad_clusters on the same padded inputs, masks
    included."""
    iso = D == 2
    Xs, lps, X, mask, lp, means, prec, w = _padded(D, D)
    jX, jm, jl = jgmm.pad_clusters(Xs, lps, 256)
    for a, b in ((X, jX), (mask, jm), (lp, jl)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    a = np.asarray(jgmm._log_gaussian(*_j(X, means, prec), iso))
    b = tgmm._log_gaussian(*_t(X, means, prec), iso).numpy()
    rel = np.max(np.abs(a - b) / np.maximum(np.abs(a), 1))
    assert rel <= LOGP_REL
    lb_j, lr_j = jgmm._e_step(*_j(X, mask, w, means, prec), iso)
    lb_t, lr_t = tgmm._e_step(*_t(X, mask, w, means, prec), iso)
    d_lb = np.max(np.abs(np.asarray(lb_j) - lb_t.numpy()))
    d_lr = np.max(np.abs(np.asarray(lr_j) - lr_t.numpy()))
    assert d_lb <= LB_ABS and d_lr <= RESP_ABS
    worst = 0.0
    for local in (True, False):
        want = jgmm._m_step(*_j(X, mask, lr_j, lp), (
            jnp.float32(BOUNDS[0]), jnp.float32(BOUNDS[1])), local, iso)
        got = tgmm._m_step(*_t(X, mask, np.asarray(lr_j), lp), tuple(
            torch.tensor(b) for b in BOUNDS), local, iso)
        for x, y in zip(want, got):
            x = np.asarray(x)
            assert x.shape == y.shape and y.dtype == torch.float32
            worst = max(worst, float(np.max(np.abs(x - y.numpy())
                                            / np.abs(x))))
    assert worst <= MSTEP_REL
    valid = np.ones(w.shape, bool)
    valid[::3, -1] = False
    bj = np.asarray(jgmm.bic_batched(*_j(X, mask, w, means, prec, valid),
                                     iso))
    bt = tgmm.bic_batched(*_t(X, mask, w, means, prec, valid), iso).numpy()
    d_bic = np.max(np.abs(bj - bt) / np.abs(bj))
    assert d_bic <= BIC_REL
    print(f"{D}D: log_gaussian {rel:.2e} rel, e-step lb {d_lb:.2e} log resp "
          f"{d_lr:.2e}, m-step {worst:.2e} rel, bic {d_bic:.2e} rel")


def _strongest_minimum(means, weights, prec, i, j, iso) -> float:
    """The pair (i, j)'s strongest strict local minimum of the two
    components' pdf along their line, relative to the pdf there, in f64
    (< 0: none)."""
    D = means.shape[-1]
    t = np.linspace(0, 1, 40)
    line = means[i] + (means[j] - means[i]) * t[:, None]
    pdf = np.zeros(40)
    for k in (i, j):
        p = np.broadcast_to(prec[k], (D,)).astype(np.float64)
        q = np.sum(((line - means[k]) * p) ** 2, 1)
        pdf += weights[k] * np.prod(p) / (2 * np.pi) ** (D / 2) * np.exp(
            -0.5 * q)
    inner = pdf[1:-1]
    margin = np.minimum(pdf[:-2] - inner, pdf[2:] - inner) / inner
    return float(margin.max())


@pytest.mark.parametrize("D", [2, 3])
def test_sparrow_flags_match_jax(D):
    """The batched Sparrow check on 400 clusters of 4 components whose
    neighbours lie 1.5-2.5 sigma apart (around the Sparrow limit): flags
    equal JAX's but where a pair's strongest minimum is within
    SPARROW_ULPS f32 ulps of none."""
    iso = D == 2
    rng = np.random.default_rng(D)
    G, K = 400, 4
    sigma = rng.uniform(0.02, 0.04, (G, K) if iso else (G, K, D))
    prec = (1 / sigma).astype(np.float32)
    step = rng.uniform(1.5, 2.5, (G, K, 1)) * 0.03
    direction = rng.normal(0, 1, (G, K, D))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    means = np.cumsum(step * direction, 1).astype(np.float32)
    w = rng.uniform(0.1, 1, (G, K)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    valid = rng.random((G, K)) < 0.9
    want = np.asarray(jgmm._sparrow_ok(*_j(means, w, prec, valid), iso))
    got = tgmm._sparrow_ok(*_t(means, w, prec, valid), iso).numpy()
    differ = np.nonzero(want != got)[0]
    for g in differ:
        pairs = [(i, j) for i in range(K) for j in range(i + 1, K)
                 if valid[g, i] and valid[g, j]]
        closest = min(abs(_strongest_minimum(means[g], w[g], prec[g], i, j,
                                             iso)) for i, j in pairs)
        assert closest <= SPARROW_ULPS * 2.0**-23, (g, closest)
    print(f"{D}D: {want.sum()} of {G} clusters pass, {len(differ)} flags "
          "differ (each at a pair within the ulps)")
    assert 0 < want.sum() < G


def _jax_em(X, mask, lp, centers, iso, local=True):
    """JAX's loop body (ops/gmm.py:256-291) over its _e_step and _m_step,
    step by step."""
    X, mask, lp, centers = _j(X, mask, lp, centers)
    K = centers.shape[1]
    G = X.shape[0]
    d2 = jnp.sum((X[:, :, None] - centers[:, None]) ** 2, -1)
    one_hot = jax.nn.one_hot(jnp.argmin(d2, 2), K, dtype=X.dtype)
    b = (jnp.float32(BOUNDS[0]), jnp.float32(BOUNDS[1]))
    params = jgmm._m_step(X, mask, jnp.log(one_hot + 1e-300), lp, b, local,
                          iso)
    prev = jnp.full((G,), -jnp.inf, X.dtype)
    conv = jnp.zeros(G, bool)
    it = 0
    while it < 100 and not bool(jnp.all(conv)):
        lb, lr = jgmm._e_step(X, mask, params[0], params[1], params[3], iso)
        new = jgmm._m_step(X, mask, lr, lp, b, local, iso)
        params = tuple(jnp.where(conv.reshape((G,) + (1,) * (o.ndim - 1)),
                                 o, n) for o, n in zip(params, new))
        new_conv = jnp.abs(lb - prev) < 1e-3
        prev = jnp.where(conv, prev, lb)
        conv = conv | new_conv
        it += 1
    return [np.asarray(a) for a in params] + [np.asarray(prev),
                                              np.asarray(conv)]


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("D", [2, 3])
def test_em_from_the_same_centers_matches_jax(D, K):
    """The port's EM (blocks of STEP_BLOCK steps, converged rows dropped
    between blocks) from kmeans++ centers against JAX's loop from them:
    weights, means, covariances, lower bounds, converged flags and valid
    components."""
    iso = D == 2
    Xs, lps, _ = _clusters(10 + D, 16, D)
    X, mask, lp = tgmm.pad_clusters(Xs, lps, 256)
    u = torch.from_numpy(np.random.default_rng(K).random((16, K)))
    centers = tgmm._kmeanspp(*_t(X, mask), u)
    want = _jax_em(X, mask, lp, centers.numpy(), iso)
    got = [a.numpy() for a in tgmm._em(
        *_t(X, mask, lp), centers, tuple(torch.tensor(b) for b in BOUNDS),
        True, iso)[:7]]
    np.testing.assert_array_equal(got[5], want[5])
    posed = K <= 1 + np.arange(16) % 3
    for rows, (bw, bm, bcv, blb) in ((posed, (EM_W, EM_M, EM_CV, EM_LB)), (
            ~posed, (OVER_W, OVER_M, OVER_CV, OVER_LB))):
        np.testing.assert_allclose(got[0][rows], want[0][rows], rtol=0,
                                   atol=bw)
        np.testing.assert_allclose(got[1][rows], want[1][rows], rtol=0,
                                   atol=bm)
        np.testing.assert_allclose(got[2][rows], want[2][rows], rtol=bcv,
                                   atol=0)
        np.testing.assert_allclose(got[4][rows], want[4][rows], rtol=0,
                                   atol=blb)
    n = mask.sum(1)[:, None]
    np.testing.assert_array_equal(np.round(got[0] * n) >= 10,
                                  np.round(want[0] * n) >= 10)
    assert got[6].max() <= 100 and (got[6] >= 1).all()


@pytest.mark.parametrize("D", [2, 3])
def test_em_margin_leaves_the_fit_alone(D):
    """With ``stats`` the EM also returns each row's distance from a
    convergence near tie and changes no bit of the fit; the margin is at
    most the distance of the step that converged the row; fit_g5m_batched
    gives each cluster's best_tie, none negative."""
    iso = D == 2
    Xs, lps, _ = _clusters(20 + D, 12, D)
    X, mask, lp = tgmm.pad_clusters(Xs, lps, 256)
    u = torch.from_numpy(np.random.default_rng(3).random((12, 2)))
    centers = tgmm._kmeanspp(*_t(X, mask), u)
    bounds = tuple(torch.tensor(b) for b in BOUNDS)
    plain = tgmm._em(*_t(X, mask, lp), centers, bounds, True, iso)
    stats = {}
    got = tgmm._em(*_t(X, mask, lp), centers, bounds, True, iso, stats)
    assert plain[7] is None
    for a, b in zip(plain[:7], got[:7]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    margin, conv = got[7].numpy(), got[5].numpy()
    assert conv.any() and (margin >= 0).all()
    assert (margin[conv] <= tgmm._CONV_TOL).all()
    uu = torch.from_numpy(np.random.default_rng(4).random((3, 12, 2)))
    tgmm.fit_g5m_batched(*_t(X, mask, lp), uu, K=2, sigma_bounds=BOUNDS,
                         isotropic=iso, loc_local=True, min_locs=10,
                         stats=stats)
    tie = stats["best_tie"].numpy()
    assert tie.shape == (12,) and (tie >= 0).all()


# --- the kmeans++ sampler -----------------------------------------------


def test_kmeanspp_picks_only_valid_points():
    Xs, lps, _ = _clusters(3, 8)
    X, mask, _ = tgmm.pad_clusters(Xs, lps, 256)
    X[~mask] = 1e3  # padding far away: it would be drawn first
    u = torch.from_numpy(np.random.default_rng(0).random((8, 6)))
    c = tgmm._kmeanspp(*_t(X, mask), u).numpy()
    for g in range(8):
        pts = X[g][mask[g]]
        d = np.min(np.abs(pts[:, None, :] - c[g][None]).sum(-1), 0)
        assert (d == 0).all()


def test_kmeanspp_falls_back_to_uniform():
    """A cluster whose points coincide (all d^2 = 0 after the first
    center) draws each next center uniformly: index floor(u * n)."""
    n = 37
    ones = torch.ones((5, 64), dtype=torch.float64)
    ones[:, n:] = 0
    u = torch.tensor([0.0, 0.3, 0.5, 0.99, 1 - 2.0**-53],
                     dtype=torch.float64)
    idx = tgmm._pick(ones, torch.full((5,), n), u).numpy()
    np.testing.assert_array_equal(idx, np.minimum(np.floor(
        u.numpy() * n), n - 1))
    X = np.zeros((1, 64, 2), np.float32)
    X[0, :n] = 2.5
    mask = np.zeros((1, 64), bool)
    mask[0, :n] = True
    c = tgmm._kmeanspp(*_t(X, mask), u[None, :4])
    assert (c.numpy() == 2.5).all()


def test_kmeanspp_draws_by_weight():
    """The second center of one cluster (four points at squared
    distances 0, 1, 4 and 9 from the first) over 20,000 draws: each
    point's share within 4 standard errors of d^2 / 14."""
    X = np.array([[[0, 0], [1, 0], [2, 0], [3, 0]]], np.float32)
    X = np.repeat(X, 20000, 0)
    mask = np.ones(X.shape[:2], bool)
    u = np.random.default_rng(7).random((20000, 2))
    u[:, 0] = 0.0  # the first center at point 0
    c = tgmm._kmeanspp(*_t(X, mask), torch.from_numpy(u)).numpy()
    share = np.bincount(c[:, 1, 0].astype(int), minlength=4) / 20000
    p = np.array([0, 1, 4, 9]) / 14
    assert np.all(np.abs(share - p) <= 4 * np.sqrt(p * (1 - p) / 20000))


def test_kmeanspp_does_not_depend_on_the_bucket():
    Xs, lps, _ = _clusters(4, 10)
    u = torch.from_numpy(np.random.default_rng(1).random((10, 5)))
    out = [tgmm._kmeanspp(*_t(*tgmm.pad_clusters(Xs, lps, b)[:2]), u).numpy()
           for b in (256, 1024)]
    np.testing.assert_array_equal(out[0], out[1])


# --- the host route -----------------------------------------------------


@pytest.mark.parametrize("D", [2, 3])
def test_g5m_model_fit_matches_jax(D):
    """G5M_2D/G5M_3D.fit on the same points, then bic, predict and sample:
    equal."""
    Xs, lps, _ = _clusters(20 + D, 3, D)
    X, lp = Xs[2], lps[2]
    cls = (tg.G5M_2D, jg.G5M_2D) if D == 2 else (tg.G5M_3D, jg.G5M_3D)
    for K in (1, 2, 3, 4):
        a = cls[0](K, 10, BOUNDS).fit(X, lp)
        b = cls[1](K, 10, BOUNDS).fit(X, lp)
        assert (a is None) == (b is None)
        if a is None:
            continue
        for n in ("weights_", "means_", "covariances_",
                  "precisions_cholesky_", "valid_idx", "n_locs"):
            np.testing.assert_array_equal(getattr(a, n), getattr(b, n), n)
        assert a.converged == b.converged and a.bic(X) == b.bic(X)
        np.testing.assert_array_equal(a.predict(X), b.predict(X))
        for x, y in zip(a.sample(50), b.sample(50)):
            np.testing.assert_array_equal(x, y)


def test_find_optimal_and_sum_g5ms_match_jax():
    Xs, lps, _ = _clusters(30, 3)
    kw = dict(min_locs=10, sigma_bounds=BOUNDS)
    a = [tg._find_optimal_G5M(x, lp=lp, **kw) for x, lp in zip(Xs, lps)]
    b = [jg._find_optimal_G5M(x, lp=lp, **kw) for x, lp in zip(Xs, lps)]
    assert [len(m.valid_idx) for m in a] == [1, 2, 3]
    for x, y in zip(a + [tg.sum_G5Ms(a)], b + [jg.sum_G5Ms(b)]):
        for n in ("weights_", "means_", "covariances_",
                  "precisions_cholesky_", "valid_idx"):
            np.testing.assert_array_equal(getattr(x, n), getattr(y, n), n)
        assert x.converged == y.converged


@pytest.mark.parametrize("postprocess", [False, True])
@pytest.mark.parametrize("D", [2, 3])
def test_g5m_host_route_matches_jax(D, postprocess):
    """g5m below 8 groups (the host route) on both sides: centers,
    clustered locs and info equal, field for field and dtype for dtype."""
    Xs, lps, _ = _clusters(40 + D, 4, D)
    locs = _locs(Xs, lps, D=D)
    kw = dict(postprocess=postprocess, calibration=CALIB if D == 3 else None)
    got = tg.g5m(locs, INFO, device="cpu", **kw)
    want = jg.g5m(_df(locs), INFO, **kw)
    assert len(got[0]) >= 4
    _assert_tables_equal(got[0], want[0])
    _assert_tables_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("D", [2, 3])
def test_g5m_bootstrap_matches_jax(D):
    Xs, lps, _ = _clusters(50 + D, 2, D, sizes=(80, 120))
    locs = _locs(Xs, lps, D=D)
    kw = dict(postprocess=False, bootstrap_check=True,
              calibration=CALIB if D == 3 else None)
    got = tg.g5m(locs, INFO, device="cpu", **kw)
    want = jg.g5m(_df(locs), INFO, **kw)
    _assert_tables_equal(got[0], want[0])
    _assert_tables_equal(got[1], want[1])


# --- the batched route --------------------------------------------------


@pytest.fixture(scope="module")
def batched():
    """g5m on 10 clusters (2D) and 8 (3D) of 130-250 locs, JAX's batched
    route and the port's, without the postprocess filter (one size bucket:
    JAX compiles its EM once a K and bucket)."""
    out = {}
    for D, n in ((2, 10), (3, 8)):
        Xs, lps, truth = _clusters(60 + D, n, D, sizes=(130, 250))
        locs = _locs(Xs, lps, D=D)
        kw = dict(postprocess=False, calibration=CALIB if D == 3 else None)
        record = {}
        got = tg.g5m(locs, INFO, device="cpu", record=record, **kw)
        want = jg.g5m(_df(locs), INFO, **kw)
        out[D] = locs, truth, got, want, record, kw
    return out


@pytest.mark.parametrize("D", [2, 3])
def test_g5m_batched_matches_jax(batched, D):
    """The same molecule count per group_input, centers within BATCH_PX px
    of JAX's and both within TRUTH_PX px of the truth; the same fields
    and dtypes; the record holds the route's split."""
    locs, truth, got, want, record, _ = batched[D]
    centers, want_c = got[0], _records(want[0])
    assert centers.dtype == want_c.dtype
    assert got[1].dtype == _records(want[1]).dtype
    np.testing.assert_array_equal(
        np.bincount(centers["group_input"]),
        np.bincount(want_c["group_input"]))
    cols = ["x", "y"] + (["z"] if D == 3 else [])
    scale = np.array([1, 1, 1 / 130][:D])

    def xyz(t):
        return np.column_stack([t[c] for c in cols]) * scale

    d, _ = cKDTree(xyz(want_c)).query(xyz(centers))
    assert d.max() < BATCH_PX
    true = np.vstack(truth)
    for c in (centers, want_c):
        d, _ = cKDTree(true).query(xyz(c))
        assert d.max() < TRUTH_PX
    assert len(centers) == len(true)
    assert set(record) >= {"em", "bic", "host", "convert", "steps",
                           "models", "fit", "bics", "tie"}
    assert record["host_clusters"] == 0 and record["steps"] > 0


def test_compare_g5m_holds_the_card_to_the_cpu(batched):
    """torch_parity.compare_g5m, the gate of the card against the CPU, on
    one fit against itself: it passes; a center moved by ten times its
    ulp bound fails; another step count fails unless the record puts the
    fit at an EM near tie, where it is listed."""
    from torch_parity import compare_g5m

    locs, _, got, _, record, _ = batched[2]
    centers = got[0]
    out = compare_g5m(centers, record, centers.copy(), record, locs)
    assert out["worst_same"] == 0 and not out["stepped"]
    assert not out["bic_ties"] and out["n_locs_half"] == 0
    moved = centers.copy()
    moved["x"][0] += 10 * out["same_px"]
    with pytest.raises(AssertionError, match="fit alike"):
        compare_g5m(moved, record, centers, record, locs)
    g = int(centers["group_input"][0])
    i = record["group_input"].index(g)
    K, start, steps = record["fit"][i]
    other = dict(record, fit=dict(record["fit"]), tie=dict(record["tie"]))
    other["fit"][i] = (K, start, steps + 1)
    other["tie"][i] = np.inf
    ref = dict(record, tie=dict(record["tie"]))
    ref["tie"][i] = np.inf
    with pytest.raises(AssertionError, match="EM tie"):
        compare_g5m(moved, other, centers, ref, locs)
    other["tie"][i] = 0.0
    out = compare_g5m(moved, other, centers, ref, locs)
    assert [t[0] for t in out["stepped"]] == [g]


def test_g5m_batched_skips_small_clusters():
    """A cluster under min_locs among 10 others (the fixture's shapes,
    so JAX reuses its compiled EM) yields no molecule on either side."""
    Xs, lps, _ = _clusters(70, 11, sizes=(130, 250))
    Xs[4] = Xs[4][:5]
    lps[4] = lps[4][:5]
    locs = _locs(Xs, lps)
    centers, _, _ = tg.g5m(locs, INFO, postprocess=False, device="cpu")
    want, _, _ = jg.g5m(_df(locs), INFO, postprocess=False)
    assert set(centers["group_input"]) == set(range(11)) - {4}
    assert set(centers["group_input"]) == set(want["group_input"])


@pytest.mark.parametrize("D", [2, 3])
def test_batched_size_buckets_equal_one_bucket(D, monkeypatch):
    """The port's size buckets (128 and 256 here) against
    one bucket of 256 on the CPU: the same tables bit for bit (draws by
    cluster index, the CPU's sums over the points padding-invariant),
    with the postprocess filter. On a card the padding changes the
    reduction order (tests/torch_g5m_bucket_sweep.py)."""
    Xs, lps, _ = _clusters(65 + D, 9, D, sizes=(40, 250))
    locs = _locs(Xs, lps, D=D)
    assert len(tg._buckets([len(x) for x in Xs])) > 1
    kw = dict(calibration=CALIB if D == 3 else None, device="cpu")
    got = tg.g5m(locs, INFO, **kw)
    monkeypatch.setattr(tg, "_buckets", lambda sizes: {
        256: list(range(len(sizes)))})
    one = tg.g5m(locs, INFO, **kw)
    assert len(got[0]) > 0
    for a, b in zip(got[:2], one[:2]):
        assert a.dtype == b.dtype
        for n in a.dtype.names:
            np.testing.assert_array_equal(a[n], b[n], err_msg=n)


# --- the verb and the device rule ----------------------------------------


def test_g5m_verb_matches_the_jax_cli(tmp_path, capsys):
    """``g5m`` (--device cpu) and the JAX CLI's on 4 groups: the same
    message, files, fields and info."""
    import h5py

    from picasso_torch import __main__ as tmain
    from picasso_torch import io as tio
    from picasso_tpu import __main__ as jmain

    Xs, lps, _ = _clusters(80, 4)
    locs = _locs(Xs, lps)
    out = {}
    for d, main, extra in (("t", tmain.main, ["--device", "cpu"]),
                           ("j", jmain.main, [])):
        folder = tmp_path / d
        folder.mkdir()
        tio.save_locs(str(folder / "x_dbscan.hdf5"), locs, INFO)
        main(["g5m", str(folder / "x_dbscan.hdf5")] + extra)
        out[d] = capsys.readouterr().out.replace(str(folder), "")
    assert out["t"] == out["j"] and "G5M ->" in out["t"]
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert "x_dbscan_g5m.hdf5" in names and "x_dbscan_g5m_locs.hdf5" in names
    for name in ("x_dbscan_g5m.hdf5", "x_dbscan_g5m_locs.hdf5"):
        with h5py.File(tmp_path / "t" / name) as f, \
                h5py.File(tmp_path / "j" / name) as g:
            a, b = f["locs"][()], g["locs"][()]
        assert a.dtype == b.dtype and len(a) > 0
        for n in a.dtype.names:
            np.testing.assert_array_equal(a[n], b[n], err_msg=n)
        assert tio.load_info(str(tmp_path / "t" / name)) == tio.load_info(
            str(tmp_path / "j" / name))


def test_g5m_needs_a_card_by_default(tmp_path):
    """device defaults to cuda: without a card g5m raises on both routes
    (4 and 10 groups), as does the verb, which writes no file."""
    from picasso_torch import __main__ as cli
    from picasso_torch import io

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for n in (4, 10):
        Xs, lps, _ = _clusters(90, n)
        locs = _locs(Xs, lps)
        with pytest.raises(RuntimeError, match="cuda"):
            tg.g5m(locs, INFO)
    path = str(tmp_path / "x_locs.hdf5")
    io.save_locs(path, locs, INFO)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["g5m", path])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "x_locs.hdf5", "x_locs.yaml"]
