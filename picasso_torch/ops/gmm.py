"""Batched constrained Gaussian-mixture EM on a torch device: every
cluster of a size bucket, and every start of one component count, fit at
once.

Counterpart of picasso_tpu/ops/gmm.py (_log_gaussian :34, _logsumexp
:53, _e_step :61, _m_step :72, _kmeanspp :119, _sparrow_ok :160,
fit_g5m_batched :215, bic_batched :319, pad_clusters :340). Points are
padded to (G, P, D) f32 with a validity mask, and every EM quantity
carries a leading row axis; the arithmetic is JAX's, in f32, with its
traps: ``log(one_hot + 1e-300)`` and ``log(wv + 1e-300)`` take log(0) =
-inf (1e-300 is 0 in f32), and the component counts round half to even.

Where the port differs from JAX:
- the kmeans++ draws are uniforms made on the host by
  ``np.random.default_rng((seed, K, start))`` for every cluster, each
  center picked by inverse CDF in f64 over the valid points' weights
  d^2 + 1e-30 (the distribution of JAX's categorical over log(d^2 +
  1e-30)), so the draws depend on the seed, K, the start and the
  cluster's own index, not on the device or the bucketing, and a fit on
  another device or in another bucket differs only by the rounding of
  its sums (on the CPU not at all across buckets); jax.random's
  threefry draws are not reproduced;
- the starts of one K run as rows of one batch (as many as ROW_BUDGET
  allows), and JAX's ``while_loop`` is a Python loop of blocks of
  STEP_BLOCK steps with no host sync inside a block: after a block one
  readback of the convergence flags ends the loop or drops the rows that
  have converged. A converged row is frozen and the cap of _MAX_ITER
  steps is a multiple of the block, so every row takes the steps it
  takes in JAX's loop.
"""

from __future__ import annotations

import numpy as np
import torch

_SPARROW_T = 40  # line samples per component pair (g5m.py:631)
_MAX_ITER = 100
_CONV_TOL = 1e-3
#: E+M steps between two readbacks of the convergence flags; divides
#: _MAX_ITER
STEP_BLOCK = 10
#: elements of the largest (rows, P, K, D) or (rows, K, K, T, D)
#: temporary: starts and rows beyond it run one after another
ROW_BUDGET = 1 << 26
# f32 log(2 pi), as JAX forms it (jnp.log of the f32 constant)
_LOG_2PI = np.float32(np.log(2 * np.pi))
# the line parameter of the Sparrow scan, as jnp.linspace forms it
_T = np.linspace(0.0, 1.0, _SPARROW_T).astype(np.float32)


def _sqsum(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, added left to right (the same
    order on every device)."""
    out = d[..., 0] * d[..., 0]
    for c in range(1, d.shape[-1]):
        out = out + d[..., c] * d[..., c]
    return out


def _log_gaussian(X, means, prec, isotropic):
    """Log N(x | mu, cov) -> (G, P, K).

    X: (G, P, D); means: (G, K, D); prec = 1/sigma: (G, K) isotropic or
    (G, K, D) diagonal."""
    D = X.shape[-1]
    diff = X[:, :, None, :] - means[:, None, :, :]  # (G, P, K, D)
    if isotropic:
        quad = _sqsum(diff) * (prec**2)[:, None, :]
        log_det = D * torch.log(prec)[:, None, :]
    else:
        quad = _sqsum(diff * prec[:, None, :, :])
        log_det = _sum_log(prec)[:, None, :]
    c = float(np.float32(D) * _LOG_2PI)
    return -0.5 * (c + quad) + log_det


def _sum_log(prec: torch.Tensor) -> torch.Tensor:
    """Sum of log(prec) over the last axis, added left to right."""
    lg = torch.log(prec)
    out = lg[..., 0]
    for c in range(1, lg.shape[-1]):
        out = out + lg[..., c]
    return out


def _logsumexp(a, axis):
    m = torch.amax(a, dim=axis, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(a - m).sum(axis)) + m.squeeze(axis)


def _e_step(X, mask, weights, means, prec, isotropic):
    wlp = _log_gaussian(X, means, prec, isotropic) + torch.log(
        weights)[:, None, :]
    log_norm = _logsumexp(wlp, 2)  # (G, P)
    n_valid = torch.clamp(mask.sum(1), min=1)
    lb = torch.where(mask, log_norm, torch.zeros_like(log_norm)).sum(
        1) / n_valid
    log_resp = wlp - log_norm[:, :, None]
    return lb, log_resp


def _m_step(X, mask, log_resp, lp, sigma_bounds, loc_local, isotropic):
    """Batched M step with SMLM sigma clipping (g5m.py:772).

    lp: (G, P) mean precision (isotropic) or (G, P, D) per axis;
    sigma_bounds: two f32 0-d tensors."""
    resp = torch.exp(log_resp) * mask[:, :, None]  # (G, P, K)
    nk = resp.sum(1) + 1e-10  # (G, K)
    # sums over the points as products and one reduction (no matmul),
    # so that a cluster's sums do not depend on its padding
    means = (resp[..., None] * X[:, :, None, :]).sum(1) / nk[:, :, None]
    diff = X[:, :, None, :] - means[:, None, :, :]
    D = X.shape[-1]
    lo, hi = sigma_bounds
    if isotropic:
        var = (resp * _sqsum(diff)).sum(1) / nk / D
        if loc_local:
            mean_lp = (resp * lp[:, :, None]).sum(1) / nk
            min_v = lo**2 * mean_lp**2
            max_v = hi**2 * mean_lp**2
        else:
            min_v = (lo**2).expand_as(var)
            max_v = (hi**2).expand_as(var)
        cov = torch.clamp(var, min_v, max_v)
    else:
        cov_d = (resp[..., None] * (diff * diff)).sum(1) / nk[:, :, None]
        if loc_local:
            mean_lp = (resp[..., None] * lp[:, :, None, :]).sum(1) / nk[
                :, :, None]
            min_v = lo**2 * mean_lp**2
            max_v = hi**2 * mean_lp**2
        else:
            min_v = (lo**2).expand_as(cov_d)
            max_v = (hi**2).expand_as(cov_d)
        cov = torch.clamp(cov_d, min_v, max_v)
    prec = 1.0 / torch.sqrt(cov)
    weights = nk / nk.sum(1, keepdim=True)
    return weights, means, cov, prec


def _pick(weights: torch.Tensor, n_valid: torch.Tensor,
          u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw of one index a row: ``weights`` (G, P) f64, zero
    on padding; ``u`` (G,) f64 in [0, 1). The first index whose
    cumulative weight exceeds u * total, at most the row's last valid
    point."""
    cdf = torch.cumsum(weights, 1)
    target = (u * cdf[:, -1])[:, None].contiguous()
    idx = torch.searchsorted(cdf, target, right=True)[:, 0]
    return torch.minimum(idx, n_valid - 1)


def _kmeanspp(X, mask, u):
    """Batched kmeans++ seeding -> centers (G, K, D).

    u: (G, K) f64 uniforms on X's device. The first center is uniform
    over the valid points; each next one is drawn with weight d^2 + 1e-30
    over the valid points (d^2 the f32 squared distance to the nearest
    center so far), uniform again where those d^2 sum to 0."""
    G, P, D = X.shape
    K = u.shape[1]
    n_valid = mask.sum(1)
    ones = mask.to(torch.float64)
    rows = torch.arange(G, device=X.device)
    idx = _pick(ones, n_valid, u[:, 0])
    centers = torch.empty((G, K, D), dtype=X.dtype, device=X.device)
    centers[:, 0] = X[rows, idx]
    d2 = _sqsum(X - centers[:, 0][:, None, :])  # (G, P)
    for k in range(1, K):
        d2m = torch.where(mask, d2, torch.zeros_like(d2))
        total = d2m.sum(1, keepdim=True)
        w = torch.where(total > 0,
                        (d2m.to(torch.float64) + 1e-30) * ones, ones)
        idx = _pick(w, n_valid, u[:, k])
        centers[:, k] = X[rows, idx]
        d2 = torch.minimum(d2, _sqsum(X - centers[:, k][:, None, :]))
    return centers


def _sparrow_ok(means, weights, prec, valid, isotropic):
    """Batched Sparrow-limit check (g5m.py:631): every valid component
    pair must have a strict local minimum of the 2-component mixture PDF
    along the connecting line. -> (G,) bool."""
    G, K, D = means.shape
    t = torch.from_numpy(_T).to(means.device)
    mi = means[:, :, None, None, :]
    mj = means[:, None, :, None, :]
    line = mi + (mj - mi) * t[None, None, None, :, None]  # (G, K, K, T, D)
    di = line - mi
    dj = line - mj
    if isotropic:
        pi = prec[:, :, None, None]
        pj = prec[:, None, :, None]
        qi = _sqsum(di) * pi**2
        qj = _sqsum(dj) * pj**2
        ldi = D * torch.log(pi)
        ldj = D * torch.log(pj)
    else:
        qi = _sqsum(di * prec[:, :, None, None, :])
        qj = _sqsum(dj * prec[:, None, :, None, :])
        ldi = _sum_log(prec)[:, :, None, None]
        ldj = _sum_log(prec)[:, None, :, None]
    c = float(np.float32(-0.5 * D) * _LOG_2PI)
    lw = torch.log(weights)
    li = c + ldi - 0.5 * qi + lw[:, :, None, None]
    lj = c + ldj - 0.5 * qj + lw[:, None, :, None]
    pdf = torch.exp(li) + torch.exp(lj)  # (G, K, K, T)
    interior = pdf[..., 1:-1]
    has_min = ((interior < pdf[..., :-2]) & (interior < pdf[..., 2:])).any(-1)
    upper = torch.ones((K, K), dtype=torch.bool,
                       device=means.device).triu(1)
    pair_needed = valid[:, :, None] & valid[:, None, :] & upper
    ok = (~pair_needed | has_min).all(2).all(1)
    # the reference returns False when no component is valid
    return ok & (valid.sum(1) > 0)


def _step(X, mask, lp, bounds, loc_local, isotropic, params, prev_lb, conv,
          n_steps):
    """One E+M step of JAX's loop body: converged rows keep their
    parameters and lower bound; ``n_steps`` counts each row's steps up to
    the one that converged it."""
    w, m, cv, pc = params
    lb, log_resp = _e_step(X, mask, w, m, pc, isotropic)
    new = _m_step(X, mask, log_resp, lp, bounds, loc_local, isotropic)
    params = tuple(
        torch.where(conv.reshape((-1,) + (1,) * (o.ndim - 1)), o, n)
        for o, n in zip(params, new))
    new_conv = torch.abs(lb - prev_lb) < _CONV_TOL
    prev_lb = torch.where(conv, prev_lb, lb)
    return params, prev_lb, conv | new_conv, n_steps + ~conv


def _em(X, mask, lp, centers, bounds, loc_local, isotropic, stats=None):
    """EM from kmeans++ ``centers`` on every row to convergence or
    _MAX_ITER steps -> (weights, means, cov, prec, lower bound,
    converged, steps a row took, margin). With ``stats`` ``margin`` is
    each row's smallest distance of a step's |change of the lower bound|
    from _CONV_TOL (how near its convergence test came to another
    answer), else None."""
    K = centers.shape[1]
    d2 = _sqsum(X[:, :, None, :] - centers[:, None, :, :])
    one_hot = torch.nn.functional.one_hot(d2.argmin(2), K).to(X.dtype)
    # 1e-300 is 0 in f32: log(0) = -inf off the nearest center, as in JAX
    log_resp0 = torch.log(one_hot + 1e-300)
    params = _m_step(X, mask, log_resp0, lp, bounds, loc_local, isotropic)
    R = X.shape[0]
    lb = torch.full((R,), -torch.inf, dtype=X.dtype, device=X.device)
    conv = torch.zeros(R, dtype=torch.bool, device=X.device)
    n_steps = torch.zeros(R, dtype=torch.int32, device=X.device)
    margin = (torch.full((R,), torch.inf, dtype=X.dtype, device=X.device)
              if stats is not None else None)
    rows = None  # the active rows' indices into ``full``, None: all
    full = None
    Xa, ma, la, state = X, mask, lp, (params, lb, conv, n_steps, margin)
    steps = 0
    while steps < _MAX_ITER:
        for _ in range(STEP_BLOCK):
            lb0, c0 = state[1], state[2]
            state = _step(Xa, ma, la, bounds, loc_local, isotropic,
                          *state[:4]) + (state[4],)
            if margin is not None:
                near = torch.abs(torch.abs(state[1] - lb0) - _CONV_TOL)
                state = state[:4] + (torch.fmin(state[4], torch.where(
                    c0, torch.inf, near)),)
        steps += STEP_BLOCK
        if stats is not None:
            stats["steps"] = stats.get("steps", 0) + STEP_BLOCK
            stats["row_steps"] = (stats.get("row_steps", 0)
                                  + STEP_BLOCK * len(Xa))
        ca = state[2]
        left = torch.nonzero(~ca)[:, 0].cpu()  # the block's one readback
        if len(left) == len(ca) and steps < _MAX_ITER:
            continue
        # write the active rows back, then keep those not converged
        cur = list(state[0]) + list(state[1:])
        if rows is None:
            full = cur
        else:
            for f, c in zip(full, cur):
                if f is not None:
                    f[rows] = c
        if len(left) == 0 or steps >= _MAX_ITER:
            break
        sel = left.to(X.device)
        rows = sel if rows is None else rows[sel]
        Xa, ma, la = X[rows], mask[rows], lp[rows]
        state = (tuple(p[sel] for p in state[0]),) + tuple(
            None if t is None else t[sel] for t in state[1:])
    return tuple(full)


def fit_g5m_batched(X, mask, lp, u, *, K, sigma_bounds, isotropic,
                    loc_local, min_locs, stats=None):
    """Fit a K-component constrained GMM to every padded cluster.

    X: (G, P, D) f32; mask: (G, P) bool; lp: (G, P) isotropic or (G, P,
    D) diagonal localization precisions; u: (n_init, G, K) f64 uniforms
    in [0, 1) on X's device, one kmeans++ start each (n_init = max(K, 3)
    in g5m). The best start of a cluster by lower bound among the starts
    that pass the Sparrow check, the first on a tie; start 0 where none
    passes (g5m.py:482 + 2127).

    Returns (weights, means, cov, prec, lower_bound, converged, valid,
    ok): leading axis G throughout; ``ok`` marks clusters where at least
    one start passed. ``stats``, where given, counts the E+M steps run
    (``steps``) and the rows they ran on (``row_steps``), and holds each
    cluster's best start (``best_start``), the steps it took
    (``best_steps``) and how near its fit came to another (``best_tie``:
    the least, over the starts, of a step's distance of |change of the
    lower bound| from the convergence tolerance, and the gap between the
    best and the next candidate start's lower bound)."""
    S, G = u.shape[0], X.shape[0]
    P, D = X.shape[1], X.shape[2]
    n_pts = mask.sum(1)
    bounds = tuple(torch.tensor(b, dtype=X.dtype, device=X.device)
                   for b in sigma_bounds)
    per_start = max(G * P * K * D, G * K * K * _SPARROW_T * D, 1)
    s_per = int(np.clip(ROW_BUDGET // per_start, 1, S))
    outs, margins = [], []
    for s0 in range(0, S, s_per):
        n = min(S, s0 + s_per) - s0
        Xr = X.repeat(n, 1, 1)
        mr = mask.repeat(n, 1)
        lr = lp.repeat((n,) + (1,) * (lp.ndim - 1))
        centers = _kmeanspp(Xr, mr, u[s0:s0 + n].reshape(n * G, K))
        w, m, cv, pc, lb, conv, n_steps, margin = _em(
            Xr, mr, lr, centers, bounds, loc_local, isotropic, stats)
        # round half to even, as jnp.round
        n_assigned = torch.round(w * n_pts.repeat(n)[:, None].to(w.dtype))
        valid = n_assigned.to(torch.int32) >= min_locs
        ok = torch.cat([
            _sparrow_ok(m[r:r + G], w[r:r + G], pc[r:r + G], valid[r:r + G],
                        isotropic) for r in range(0, n * G, G)])
        outs.append((w, m, cv, pc, lb, conv, valid, ok, n_steps))
        margins.append(margin)
    w, m, cv, pc, lb, conv, valid, ok, n_steps = (
        torch.cat(t).reshape((S, G) + t[0].shape[1:]) for t in zip(*outs))
    # JAX's sequential rule: a start replaces the best so far where it
    # passes and its lower bound is strictly larger (NaN never is)
    cand = ok & (lb > -torch.inf)
    score = torch.where(cand, lb, torch.full_like(lb, -torch.inf))
    best = torch.where(cand.any(0), score.argmax(0), torch.zeros_like(
        score.argmax(0)))
    g = torch.arange(G, device=X.device)
    w, m, cv, pc, lb, conv, valid = (
        t[best, g] for t in (w, m, cv, pc, lb, conv, valid))
    if stats is not None:
        stats["best_start"], stats["best_steps"] = best, n_steps[best, g]
        top = score.topk(min(S, 2), dim=0).values
        gap = (top[0] - top[-1] if S > 1 else torch.full_like(top[0],
                                                              torch.inf))
        stats["best_tie"] = torch.fmin(
            torch.cat(margins).reshape(S, G).amin(0),
            torch.nan_to_num(gap, nan=torch.inf))
    return w, m, cv, pc, lb, conv, valid, ok.any(0)


def bic_batched(X, mask, weights, means, prec, valid, isotropic):
    """Per-cluster BIC over VALID components with renormalized weights
    (g5m.py:455 via G5M.bic): (G,)."""
    zero = torch.zeros_like(weights)
    wv = torch.where(valid, weights, zero)
    wv = wv / torch.clamp(wv.sum(1, keepdim=True), min=1e-30)
    logg = _log_gaussian(X, means, prec, isotropic)
    # 1e-300 is 0 in f32: log(0) = -inf for a valid component of weight
    # 0, as in JAX
    wlp = logg + torch.where(valid, torch.log(wv + 1e-300),
                             torch.full_like(wv, -torch.inf))[:, None, :]
    score = _logsumexp(wlp, 2)
    n = torch.clamp(mask.sum(1), min=1).to(X.dtype)
    mean_score = torch.where(mask, score, torch.zeros_like(score)).sum(1) / n
    Kv = valid.sum(1).to(X.dtype)
    D = X.shape[-1]
    if isotropic:
        n_params = Kv * D + Kv + Kv - 1
    else:
        n_params = Kv * D * 2 + Kv - 1
    return n_params * torch.log(n) - 2 * mean_score * n


def kmeans_uniforms(G: int, K: int, n_init: int, seed: int) -> np.ndarray:
    """(n_init, G, K) f64 kmeans++ uniforms keyed by cluster index: start
    s's rows from ``default_rng((seed, K, s))``, so a cluster draws the
    same on every device and in any batch."""
    return np.stack([np.random.default_rng((seed, K, s)).random((G, K))
                     for s in range(n_init)])


def pad_clusters(Xs, lps, bucket: int):
    """Stack variable-size clusters into (G, bucket, ...) + mask."""
    G = len(Xs)
    D = Xs[0].shape[1]
    X = np.zeros((G, bucket, D), np.float32)
    mask = np.zeros((G, bucket), bool)
    lp0 = np.asarray(lps[0])
    lp_shape = (G, bucket) if lp0.ndim == 1 else (G, bucket, D)
    lp = np.ones(lp_shape, np.float32)
    for g, (x, l) in enumerate(zip(Xs, lps)):
        n = len(x)
        X[g, :n] = x
        mask[g, :n] = True
        lp[g, :n] = l
    return X, mask, lp
