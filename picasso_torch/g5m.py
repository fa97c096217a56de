"""G5M molecular mapping: Gaussian-mixture EM with SMLM constraints
(component sigmas bounded by the localization precision), BIC model
selection and per-cluster fitting of grouped locs.

Counterpart of picasso_tpu/g5m.py (_kmeans_plusplus :44,
_log_gaussian_prob :72, _e_step :101, _m_step :108, _check_resolution
:152, G5M :186, G5M_2D/G5M_3D :352/:357, sum_G5Ms :362,
_find_optimal_G5M :388, _approximate_sem :438, _bootstrap_sem :447,
_convert_results :482, _prep_group :649, _run_g5m_group :683,
_model_from_params :731, _fit_clusters_batched :751, g5m :940). Locs are
numpy structured arrays. Two routes, where JAX takes them:

- below 8 groups the host route: one EM per cluster per component count
  in numpy f64, line for line JAX's, with its ``default_rng(42)`` draws,
  so the models are JAX's bit for bit;
- from 8 groups the batched route (ops/gmm.py): all clusters of a size
  bucket and all starts of one K fit at once on ``device`` in f32, the
  BIC growth over K on the host. Clusters are padded into power-of-two
  size buckets on every device. Clusters whose K cap exceeds
  _BATCH_K_CAP go to the host route.

The result tables (``_convert_results``) are formed on the host in numpy,
with the fields and dtypes that JAX's DataFrames save.
"""

from __future__ import annotations

import time
from typing import Literal

import numpy as np
import torch
from scipy.special import erf

from picasso_torch import __version__, lib
from picasso_torch.ops import gmm

MIN_LOCS = 10
MAX_ROUNDS_WITHOUT_BEST_BIC = 3
MIN_SIGMA_FACTOR = 0.8
MAX_SIGMA_FACTOR = 1.5
N_COMPONENTS_MAX = 100
# the reference's process-pool chunk size (picasso/g5m.py:58); the port
# fits clusters in batches, and keeps the name for the reference's API
N_TASKS = 500
# groups from which g5m takes the batched route, as JAX (g5m.py:983-986)
BATCH_MIN_GROUPS = 8


# ---------------------------------------------------------------------------
# kmeans++ initialization
# ---------------------------------------------------------------------------


def _kmeans_plusplus(X: np.ndarray, n_components: int,
                     rng: np.random.Generator) -> np.ndarray:
    """kmeans++ seeding: first center uniform, subsequent centers
    sampled with probability proportional to squared distance from the
    nearest chosen center (cf. picasso/g5m.py:253)."""
    n = len(X)
    indices = np.empty(n_components, int)
    indices[0] = rng.integers(n)
    d2 = np.sum((X - X[indices[0]]) ** 2, axis=1)
    for k in range(1, n_components):
        total = d2.sum()
        if total <= 0:
            indices[k] = rng.integers(n)
        else:
            probs = d2 / total
            indices[k] = rng.choice(n, p=probs)
        d2 = np.minimum(d2, np.sum((X - X[indices[k]]) ** 2, axis=1))
    return indices


# ---------------------------------------------------------------------------
# EM steps (vectorized; diagonal/isotropic covariances)
# ---------------------------------------------------------------------------


def _log_gaussian_prob(X, means, prec_chol):
    """Log N(X | means, cov) for isotropic (2D: prec_chol (K,)) or
    per-axis diagonal (3D: prec_chol (K, D)) models. Returns
    (n_samples, K)."""
    D = X.shape[1]
    if prec_chol.ndim == 1:  # isotropic
        log_det = D * np.log(prec_chol)
        d2 = (np.sum(X**2, axis=1)[:, None] - 2 * X @ means.T
              + np.sum(means**2, axis=1)[None, :])
        quad = d2 * prec_chol[None, :] ** 2
    else:  # diagonal
        log_det = np.sum(np.log(prec_chol), axis=1)
        quad = np.zeros((len(X), len(means)))
        for d in range(D):
            diff = X[:, d][:, None] - means[:, d][None, :]
            quad += (diff * prec_chol[None, :, d]) ** 2
    return -0.5 * (D * np.log(2 * np.pi) + quad) + log_det[None, :]


def _logsumexp(a, axis):
    m = np.max(a, axis=axis, keepdims=True)
    return np.log(np.sum(np.exp(a - m), axis=axis)) + np.squeeze(m, axis)


def _e_step(X, weights, means, prec_chol):
    wlp = _log_gaussian_prob(X, means, prec_chol) + np.log(weights)
    log_norm = _logsumexp(wlp, axis=1)
    log_resp = wlp - log_norm[:, None]
    return np.mean(log_norm), log_resp


def _m_step(X, log_resp, sigma_bounds, lp, loc_prec_handle,
            isotropic: bool):
    """M step with SMLM sigma constraints: per-component covariances
    clipped to [min, max] * (local mean loc. precision)^2 or absolute
    bounds (picasso/g5m.py:772)."""
    resp = np.exp(log_resp)
    nk = resp.sum(axis=0) + 1e-10
    means = (resp.T @ X) / nk[:, None]
    D = X.shape[1]
    if isotropic:
        var = np.zeros(len(nk))
        for d in range(D):
            diff = X[:, d][:, None] - means[:, d][None, :]
            var += (resp * diff**2).sum(axis=0) / nk
        var /= D
        if loc_prec_handle == "local":
            mean_lp = (resp * lp[:, None]).sum(axis=0) / nk
            min_v = sigma_bounds[0] ** 2 * mean_lp**2
            max_v = sigma_bounds[1] ** 2 * mean_lp**2
        else:
            min_v = np.full(len(nk), sigma_bounds[0] ** 2)
            max_v = np.full(len(nk), sigma_bounds[1] ** 2)
        var = np.clip(var, min_v, max_v)
        prec_chol = 1.0 / np.sqrt(var)
        cov = var
    else:
        cov = np.zeros((len(nk), D))
        for d in range(D):
            diff = X[:, d][:, None] - means[:, d][None, :]
            cov[:, d] = (resp * diff**2).sum(axis=0) / nk
        if loc_prec_handle == "local":
            mean_lp = (resp.T @ lp) / nk[:, None]  # (K, D)
            min_v = sigma_bounds[0] ** 2 * mean_lp**2
            max_v = sigma_bounds[1] ** 2 * mean_lp**2
        else:
            min_v = np.full_like(cov, sigma_bounds[0] ** 2)
            max_v = np.full_like(cov, sigma_bounds[1] ** 2)
        cov = np.clip(cov, min_v, max_v)
        prec_chol = 1.0 / np.sqrt(cov)
    weights = nk / nk.sum()
    return weights, means, cov, prec_chol


def _check_resolution(means, weights, prec_chol, isotropic):
    """Sparrow-limit check: every component pair must show a local
    minimum of the mixture PDF along the connecting line
    (picasso/g5m.py:631)."""
    K = means.shape[0]
    if K == 0:
        return False
    if K == 1:
        return True
    for i in range(K):
        for j in range(i + 1, K):
            t = np.linspace(0, 1, 40)
            line = means[i][None, :] + (means[j] - means[i])[None, :] * (
                t[:, None])
            pc = prec_chol[[i, j]] if prec_chol.ndim >= 1 else prec_chol
            ll = _log_gaussian_prob(line, means[[i, j]], pc) + np.log(
                weights[[i, j]])
            pdf = np.exp(ll).sum(axis=1)
            if not len(lib.find_local_minima(pdf)):
                return False
    return True


# ---------------------------------------------------------------------------
# G5M model classes
# ---------------------------------------------------------------------------


class G5M:
    """Constrained Gaussian mixture (cf. picasso/g5m.py:322)."""

    n_dimensions = 2
    isotropic = True

    def __init__(self, n_components: int, min_locs: int,
                 sigma_bounds: tuple[float, float], *,
                 means_init: np.ndarray | None = None,
                 calibration: dict | None = None):
        assert sigma_bounds[0] >= 0 and sigma_bounds[1] >= sigma_bounds[0]
        self.n_components = int(n_components)
        self.min_locs = int(min_locs)
        self.sigma_bounds = sigma_bounds
        self.n_init = max(int(n_components), 3)
        self.random_state = 42
        self.converged = False
        self.means_init = means_init
        self.loc_prec_handle = "local"
        self.calibration = calibration
        self.valid_idx = np.arange(n_components).astype(int)
        self.n_locs = np.zeros(n_components, dtype=int)

    # -- properties over valid components --
    @property
    def weights(self):
        w = self.weights_[self.valid_idx]
        return w / w.sum()

    @property
    def means(self):
        return self.means_[self.valid_idx]

    @property
    def covariances(self):
        return self.covariances_[self.valid_idx]

    @property
    def precisions_cholesky(self):
        return self.precisions_cholesky_[self.valid_idx]

    def n_parameters(self) -> int:
        K = len(self.valid_idx)
        if self.isotropic:
            return int(K * self.n_dimensions + K + K - 1)
        return int(K * self.n_dimensions * 2 + K - 1)

    def estimate_log_prob(self, X):
        return _log_gaussian_prob(X, self.means, self.precisions_cholesky)

    def estimate_weighted_log_prob(self, X):
        return self.estimate_log_prob(X) + np.log(self.weights)

    def score_samples(self, X):
        return _logsumexp(self.estimate_weighted_log_prob(X), axis=1)

    def bic(self, X) -> float:
        return (self.n_parameters() * np.log(X.shape[0])
                - 2 * self.score_samples(X).mean() * X.shape[0])

    def predict(self, X):
        return np.argmax(self.estimate_weighted_log_prob(X), axis=1)

    def sample(self, n: int):
        rng = np.random.default_rng(self.random_state)
        counts = rng.multinomial(n, self.weights)
        out = []
        for k, c in enumerate(counts):
            sd = np.sqrt(self.covariances[k])
            if self.isotropic:
                out.append(rng.normal(self.means[k], sd,
                                      (c, self.n_dimensions)))
            else:
                out.append(rng.normal(self.means[k], sd, (c, len(sd))))
        X = np.concatenate(out) if out else np.zeros((0, self.n_dimensions))
        return X, np.repeat(np.arange(len(counts)), counts)

    def fit(self, X, lp, loc_prec_handle="local"):
        """Multi-init EM with per-component sigma constraints; keeps
        the best-likelihood init that passes the Sparrow check
        (picasso/g5m.py:482 + _fit_G5M :2127)."""
        assert X.shape[1] == self.n_dimensions
        X = np.ascontiguousarray(np.float64(X))
        lp = np.ascontiguousarray(np.float64(lp))
        self.loc_prec_handle = loc_prec_handle
        rng = np.random.default_rng(self.random_state)
        n = len(X)
        K = self.n_components

        max_lower_bound = -np.inf
        best = None
        best_valid = self.valid_idx
        converged = False
        for _ in range(self.n_init):
            # init responsibilities via kmeans++ hard assignment
            if self.means_init is not None:
                means = np.array(self.means_init, np.float64)
            else:
                means = X[_kmeans_plusplus(X, K, rng)]
            # initial cov from nearest-center assignment
            d2 = (np.sum(X**2, 1)[:, None] - 2 * X @ means.T
                  + np.sum(means**2, 1)[None, :])
            assign = np.argmin(d2, axis=1)
            resp = np.zeros((n, K))
            resp[np.arange(n), assign] = 1.0
            weights, means, cov, prec_chol = _m_step(
                X, np.log(resp + 1e-300), self.sigma_bounds, lp,
                loc_prec_handle, self.isotropic)
            lower_bound = -np.inf
            converged_ = False
            for _it in range(100):
                prev = lower_bound
                lower_bound, log_resp = _e_step(X, weights, means, prec_chol)
                weights, means, cov, prec_chol = _m_step(
                    X, log_resp, self.sigma_bounds, lp, loc_prec_handle,
                    self.isotropic)
                if abs(lower_bound - prev) < 1e-3:
                    converged_ = True
                    break
            n_assigned = np.round(weights * n).astype(int)
            valid_idx = np.nonzero(n_assigned >= self.min_locs)[0]
            if _check_resolution(
                    means[valid_idx], weights[valid_idx],
                    prec_chol[valid_idx], self.isotropic,
            ) and lower_bound > max_lower_bound:
                max_lower_bound = lower_bound
                best = (weights, means, cov, prec_chol)
                best_valid = valid_idx
                converged = converged_
        if best is None:
            return None
        (self.weights_, self.means_, self.covariances_,
         self.precisions_cholesky_) = best
        self.valid_idx = best_valid
        self.converged = converged
        self.n_locs = np.round(self.weights * len(X)).astype(int)
        return self


class G5M_2D(G5M):
    n_dimensions = 2
    isotropic = True


class G5M_3D(G5M):
    n_dimensions = 3
    isotropic = False


def sum_G5Ms(g5ms: list[G5M]) -> G5M:
    """Combine several fitted G5Ms into one mixture
    (picasso/g5m.py:2067)."""
    K = sum(len(g.valid_idx) for g in g5ms)
    out = type(g5ms[0])(n_components=K, min_locs=g5ms[0].min_locs,
                        sigma_bounds=g5ms[0].sigma_bounds)
    out.weights_ = np.concatenate([g.weights for g in g5ms])
    out.weights_ /= out.weights_.sum()
    out.means_ = np.concatenate([g.means for g in g5ms])
    out.covariances_ = np.concatenate([g.covariances for g in g5ms])
    out.precisions_cholesky_ = np.concatenate(
        [g.precisions_cholesky for g in g5ms])
    out.valid_idx = np.arange(K)
    out.converged = all(g.converged for g in g5ms)
    return out


# ---------------------------------------------------------------------------
# Model selection (picasso/g5m.py:820)
# ---------------------------------------------------------------------------


def _find_optimal_G5M(X, min_locs, sigma_bounds, *, lp,
                      loc_prec_handle="local",
                      max_rounds_without_best_bic=MAX_ROUNDS_WITHOUT_BEST_BIC,
                      model_cls=G5M_2D, calibration=None):
    """Grow n_components until the BIC stalls for
    max_rounds_without_best_bic rounds; return the best model."""
    n_components = 1
    rounds = 0
    best_bic = np.inf
    n_max = min(N_COMPONENTS_MAX, len(X) // min_locs)
    g5ms, bics = [], []
    while n_components <= n_max and rounds < max_rounds_without_best_bic:
        model = model_cls(
            n_components=n_components, min_locs=min_locs,
            sigma_bounds=sigma_bounds, calibration=calibration,
        ).fit(X, lp=lp, loc_prec_handle=loc_prec_handle)
        if model is None:
            rounds += 1
        else:
            current = model.bic(X)
            if current < best_bic:
                best_bic = current
                rounds = 0
            else:
                rounds += 1
            g5ms.append(model)
            bics.append(current)
        n_components += 1
    if g5ms:
        return g5ms[int(np.argmin(bics))]
    return None


_find_optimal_G5M_2D = _find_optimal_G5M


# ---------------------------------------------------------------------------
# SEM and result conversion (picasso/g5m.py:1743-2060)
# ---------------------------------------------------------------------------


def _approximate_sem(model: G5M, locs: np.ndarray) -> np.ndarray:
    weights = model.weights
    cov = model.covariances
    if cov.ndim == 1:
        cov = np.repeat(cov, 2).reshape(-1, 2)
    N = len(locs) * weights.reshape(len(weights), -1)
    return np.sqrt(cov / N)


def _bootstrap_sem(model: G5M, locs: np.ndarray,
                   n_bootstraps: int = 20) -> np.ndarray:
    boot_means = []
    for i in range(n_bootstraps):
        model.random_state = 42 + i
        X_boot, _ = model.sample(len(locs))
        boot = type(model)(
            n_components=len(model.valid_idx), min_locs=model.min_locs,
            sigma_bounds=model.sigma_bounds, means_init=model.means,
            calibration=model.calibration)
        if model.n_dimensions == 3:
            lp = np.column_stack([locs["lpx"], locs["lpy"], locs["lpz"]])
        else:
            # DataFrame.mean(axis=1) of the two columns, in their dtype
            lp = (locs["lpx"] + locs["lpy"]) / locs["lpx"].dtype.type(2)
        # bootstrap sample size may differ from len(lp); resample lp
        idx = np.random.default_rng(i).integers(0, len(lp), len(X_boot))
        fitted = boot.fit(X_boot, lp=np.asarray(lp)[idx],
                          loc_prec_handle=model.loc_prec_handle)
        if fitted is not None:
            boot_means.append(fitted.means_)
    model.random_state = 42
    if not boot_means:
        return _approximate_sem(model, locs)
    min_k = min(m.shape[0] for m in boot_means)
    return np.std([m[:min_k] for m in boot_means], axis=0)


def _assign(locs: np.ndarray, group_input: int, labels: np.ndarray,
            log_likelihood: np.ndarray) -> np.ndarray:
    """``locs`` as ``DataFrame.assign(group_input=..., group=labels,
    log_likelihood=...)`` forms it: ``group`` replaced in its place by
    the int64 labels, then ``group_input`` (int64) and ``log_likelihood``
    (f64) appended."""
    fields = [(n, np.int64 if n == "group" else locs.dtype[n])
              for n in locs.dtype.names]
    fields += [("group_input", np.int64), ("log_likelihood", np.float64)]
    out = np.empty(len(locs), fields)
    for n in locs.dtype.names:
        out[n] = labels if n == "group" else locs[n]
    out["group_input"] = group_input
    out["log_likelihood"] = log_likelihood
    return out


def _convert_results(model: G5M, locs_group: np.ndarray,
                     pixelsize: float = 130.0, bootstrap: bool = False):
    """Extract components as a locs table with p-values, per-molecule
    log-likelihoods, binding-event counts etc. (picasso/g5m.py:1830);
    returns (centers, the group's locs with their component labels)."""
    names = locs_group.dtype.names
    has_z = "z" in names
    means = model.means
    cov = model.covariances
    weights = model.weights
    x_arr = locs_group["x"].astype(np.float64)
    y_arr = locs_group["y"].astype(np.float64)
    if has_z:
        X = np.column_stack(
            [x_arr, y_arr, locs_group["z"].astype(np.float64) / pixelsize])
    else:
        X = np.column_stack([x_arr, y_arr])
    log_prob = model.estimate_weighted_log_prob(X)
    sample_scores = _logsumexp(log_prob, axis=1)
    group_ll = np.full(len(model.valid_idx), np.mean(sample_scores))
    _, log_resp = _e_step(X, model.weights_, model.means_,
                          model.precisions_cholesky_)
    resp = np.exp(log_resp[:, model.valid_idx])
    rsum = resp.sum(0) + 1e-12
    mol_ll = (resp * log_prob).sum(0) / rsum
    D = X.shape[1]
    if D == 2:
        expected = np.log(weights / (2 * np.pi * cov)) - 1
    else:
        expected = np.log(
            weights / ((2 * np.pi) ** 1.5 * np.sqrt(cov).prod(1))) - 1.5
    stdev = np.sqrt(D * 0.5 / (len(X) * weights))
    p_val = (0.5 * (1 + erf((mol_ll - expected)
                            / (stdev * np.sqrt(2))))).reshape(-1)

    sem = (_bootstrap_sem(model, locs_group) if bootstrap
           else _approximate_sem(model, locs_group))
    lpx = sem[:, 0]
    lpy = sem[:, 1]

    frames_arr = locs_group["frame"]
    frames_locs = frames_arr.reshape(-1, 1)
    frame = (resp * frames_locs).sum(0) / rsum
    std_frame = np.sqrt((resp * (frames_locs - frame) ** 2).sum(0)
                        / ((resp.shape[0] - 1) * rsum / resp.shape[0]))
    # predict/score_samples over the already-computed weighted log
    # probabilities
    labels = np.argmax(log_prob, axis=1)
    g_in = int(locs_group["group"][0])
    group_input = g_in * np.ones(len(frame), dtype=int)
    locs_group = _assign(locs_group, g_in, labels, sample_scores)

    # binding events: split by >3 dark frames, assign each event's COM
    # to its nearest component
    starts = np.concatenate([[0], np.where(np.diff(frames_arr) > 3)[0] + 1])
    counts_ev = np.diff(np.concatenate([starts, [len(frames_arr)]]))
    x_ev = np.add.reduceat(x_arr, starts) / counts_ev
    y_ev = np.add.reduceat(y_arr, starts) / counts_ev
    if has_z:
        z_ev = (np.add.reduceat(locs_group["z"], starts) / counts_ev
                / pixelsize)
        X_ev = np.stack((x_ev, y_ev, z_ev)).T
    else:
        X_ev = np.stack((x_ev, y_ev)).T
    ev_labels = model.predict(X_ev)
    found, counts = np.unique(ev_labels, return_counts=True)
    count_dict = dict(zip(found, counts))
    n_events = np.array(
        [count_dict.get(k, 0) for k in range(len(model.valid_idx))])

    cols = {
        "frame": frame.astype(np.float32),
        "std_frame": std_frame.astype(np.float32),
        "x": means[:, 0].astype(np.float32),
        "y": means[:, 1].astype(np.float32),
    }
    if has_z:
        cols["z"] = (means[:, 2] * pixelsize).astype(np.float32)
    cols["lpx"] = lpx.astype(np.float32)
    cols["lpy"] = lpy.astype(np.float32)
    if has_z:
        cols["lpz"] = (sem[:, 2] * pixelsize).astype(np.float32)
        sigma_xyz = np.sqrt(cov) * pixelsize
        cols["fitted_sigma_x"] = sigma_xyz[:, 0].astype(np.float32)
        cols["fitted_sigma_y"] = sigma_xyz[:, 1].astype(np.float32)
        cols["fitted_sigma_z"] = sigma_xyz[:, 2].astype(np.float32)
        lp3 = np.column_stack(
            [locs_group["lpx"], locs_group["lpy"], locs_group["lpz"]])
        wlp = (resp.T @ lp3) / rsum[:, None]
        cols["rel_sigma_x"] = (sigma_xyz[:, 0] / wlp[:, 0]
                               / pixelsize).astype(np.float32)
        cols["rel_sigma_y"] = (sigma_xyz[:, 1] / wlp[:, 1]
                               / pixelsize).astype(np.float32)
        cols["rel_sigma_z"] = (sigma_xyz[:, 2] / wlp[:, 2]).astype(
            np.float32)
    else:
        sigma = np.sqrt(cov) * pixelsize
        lp = (locs_group["lpx"].astype(np.float64)
              + locs_group["lpy"].astype(np.float64)) / 2
        wlp = (resp * lp[:, None]).sum(0) / rsum
        cols["fitted_sigma"] = sigma.astype(np.float32)
        cols["rel_sigma"] = (sigma / wlp / pixelsize).astype(np.float32)
    cols["p_val"] = p_val.astype(np.float32)
    cols["mol_log_likelihood"] = mol_ll.astype(np.float32)
    cols["group_log_likelihood"] = group_ll.astype(np.float32)
    cols["n_locs"] = model.n_locs[: len(means)].astype(np.int32)
    cols["n_events"] = n_events.astype(np.int32)
    cols["group_input"] = group_input.astype(np.int32)
    # carry the resp-weighted means of the other numeric fields (e.g.
    # photons), in the locs' field order
    ignore = {"frame", "x", "y", "z", "lpx", "lpy", "lpz", "group",
              "group_input", "log_likelihood"}
    for col in locs_group.dtype.names:
        if col in ignore or col in cols:
            continue
        if np.issubdtype(locs_group.dtype[col], np.number):
            vals = locs_group[col].reshape(-1, 1)
            cols[col] = ((resp * vals).sum(0) / rsum).astype(np.float32)
    centers = np.empty(len(means), [(k, v.dtype) for k, v in cols.items()])
    for k, v in cols.items():
        centers[k] = v
    return centers, locs_group


# ---------------------------------------------------------------------------
# Public entry (picasso/g5m.py:2511)
# ---------------------------------------------------------------------------


def _prep_group(locs_group, *, min_locs, pixelsize, max_locs_per_cluster,
                loc_prec_handle):
    """Extract (X, lp, model_cls) for one cluster, or None if the
    cluster is out of the fit-size window."""
    n_locs = len(locs_group)
    if n_locs < min_locs or n_locs > max_locs_per_cluster:
        return None
    has_z = "z" in locs_group.dtype.names
    x = locs_group["x"].astype(np.float64)
    y = locs_group["y"].astype(np.float64)
    lpx = locs_group["lpx"].astype(np.float64)
    lpy = locs_group["lpy"].astype(np.float64)
    if has_z:
        X = np.column_stack(
            [x, y, locs_group["z"].astype(np.float64) / pixelsize])
        lp = np.column_stack(
            [lpx, lpy, locs_group["lpz"].astype(np.float64) / pixelsize])
        model_cls = G5M_3D
    else:
        X = np.column_stack([x, y])
        lp = (lpx + lpy) / 2
        model_cls = G5M_2D
    if loc_prec_handle != "local":
        lp = np.ones_like(lp)
    return X, lp, model_cls


def _run_g5m_group(locs_group, *, min_locs, loc_prec_handle, sigma_bounds,
                   pixelsize, max_rounds_without_best_bic, bootstrap_check,
                   calibration, max_locs_per_cluster):
    prep = _prep_group(locs_group, min_locs=min_locs, pixelsize=pixelsize,
                       max_locs_per_cluster=max_locs_per_cluster,
                       loc_prec_handle=loc_prec_handle)
    if prep is None:
        return None, None
    X, lp, model_cls = prep
    model = _find_optimal_G5M(
        X, min_locs=min_locs, sigma_bounds=sigma_bounds, lp=lp,
        loc_prec_handle=loc_prec_handle,
        max_rounds_without_best_bic=max_rounds_without_best_bic,
        model_cls=model_cls, calibration=calibration)
    if model is None or len(model.valid_idx) == 0:
        return None, None
    return _convert_results(model, locs_group, pixelsize, bootstrap_check)


# ---------------------------------------------------------------------------
# Batched per-cluster fitting (device; replaces the reference's
# ProcessPool _run_g5m_parallel, picasso/g5m.py:2301-2365)
# ---------------------------------------------------------------------------

# Clusters whose BIC growth wants more components than this are handed
# back to the host route (the Sparrow pair scan is O(K^2 * 40) per
# cluster and such clusters are rare).
_BATCH_K_CAP = 32


def _model_from_params(model_cls, params, n, min_locs, sigma_bounds,
                       calibration):
    w, m, cv, pc, valid, conv = params
    model = model_cls(n_components=len(w), min_locs=min_locs,
                      sigma_bounds=sigma_bounds, calibration=calibration)
    model.weights_ = np.asarray(w, np.float64)
    model.means_ = np.asarray(m, np.float64)
    model.covariances_ = np.asarray(cv, np.float64)
    model.precisions_cholesky_ = np.asarray(pc, np.float64)
    model.valid_idx = np.nonzero(np.asarray(valid))[0]
    model.converged = bool(conv)
    model.n_locs = np.round(model.weights * n).astype(int)
    return model


def _buckets(sizes) -> dict[int, list[int]]:
    """Clusters by padded size: power-of-two buckets of at least 32 on
    every device, since the EM's work grows with the padding."""
    buckets: dict[int, list[int]] = {}
    for i, n in enumerate(sizes):
        b = max(32, 1 << int(np.ceil(np.log2(max(n, 1)))))
        buckets.setdefault(b, []).append(i)
    return buckets


def _fit_clusters_batched(Xs, lps, *, min_locs, sigma_bounds,
                          loc_prec_handle, max_rounds_without_best_bic,
                          model_cls, calibration, seed=42, progress=None,
                          device="cuda", record=None):
    """Fit all clusters with the batched EM (ops/gmm.py) on ``device``
    (or split over the shards of a mesh, parallel/mesh.route).

    Each bucket runs the BIC growth over K on the host with per-cluster
    rounds; each K fits the bucket's clusters still growing, all their
    starts at once, with one readback of the BICs. The kmeans++ draws of
    start s at K are ``default_rng((seed, K, s))``'s uniforms, one row a
    cluster by its index in ``Xs``. Returns a list of fitted models (None
    where no component count passed the checks).

    ``record``, where given, gains the seconds of the EM per K (``em``:
    {K: s}), of the BICs and their readbacks (``bic``) and of the host
    route's clusters (``host``), the E+M steps run (``steps``,
    ``row_steps``), the clusters handed to the host route
    (``host_clusters``), each cluster's BIC per K (``bics``: {index: {K:
    bic}}), the K, start and steps of its best fit (``fit``: {index:
    (K, start, steps)}) and that fit's distance from an EM near tie
    (``tie``: {index: ops/gmm.fit_g5m_batched's ``best_tie``}). Only
    with ``record`` is the card synchronized after each K's EM, to time
    it.
    """
    from picasso_torch.parallel.mesh import g5m_shards, route

    device, mesh = route(device, spread=False)
    sync = (torch.cuda.synchronize
            if device.type == "cuda" and record is not None
            else (lambda *a: None))
    isotropic = model_cls.isotropic
    loc_local = loc_prec_handle == "local"
    models = [None] * len(Xs)
    stats = {} if record is not None else None
    wall = {"em": {}, "bic": 0.0, "host": 0.0, "host_clusters": 0,
            "bics": {}, "fit": {}, "tie": {}}
    done = 0
    for bucket, idxs in sorted(_buckets([len(x) for x in Xs]).items()):
        idxs = np.asarray(idxs)
        X, mask, lp = gmm.pad_clusters([Xs[i] for i in idxs],
                                       [lps[i] for i in idxs], bucket)
        if mesh is None:
            Xd, maskd, lpd = (torch.from_numpy(a).to(device)
                              for a in (X, mask, lp))
        n_pts = np.array([len(Xs[i]) for i in idxs])
        n_max = np.minimum(N_COMPONENTS_MAX, n_pts // min_locs)
        G = len(idxs)
        best_bic = np.full(G, np.inf)
        rounds = np.zeros(G, int)
        best_params: list = [None] * G
        K = 1
        while True:
            active = ((rounds < max_rounds_without_best_bic) & (K <= n_max)
                      & (K <= _BATCH_K_CAP))
            if not active.any():
                break
            act = np.nonzero(active)[0]
            u = gmm.kmeans_uniforms(len(Xs), K, max(K, 3), seed)[
                :, idxs[act]]
            t0 = time.perf_counter()
            if mesh is not None:
                # the clusters split over the shards, each fit with its
                # BICs on its device (the shards' walls count as EM)
                w, m, cv, pc, lb, conv, valid, ok, bic = g5m_shards(
                    X[act], mask[act], lp[act], u, K=K,
                    sigma_bounds=sigma_bounds, isotropic=isotropic,
                    loc_local=loc_local, min_locs=min_locs, mesh=mesh,
                    bic=True, stats=stats)
                t1 = t2 = time.perf_counter()
            else:
                sel = torch.from_numpy(act).to(device)
                res = gmm.fit_g5m_batched(
                    Xd[sel], maskd[sel], lpd[sel],
                    torch.from_numpy(u).to(device), K=K,
                    sigma_bounds=tuple(sigma_bounds), isotropic=isotropic,
                    loc_local=loc_local, min_locs=min_locs, stats=stats)
                sync()
                t1 = time.perf_counter()
                w, m, cv, pc, lb, conv, valid, ok = res
                bic = gmm.bic_batched(Xd[sel], maskd[sel], w, m, pc, valid,
                                      isotropic).cpu().numpy()
                w, m, cv, pc, lb, conv, valid, ok = (
                    a.cpu().numpy()
                    for a in (w, m, cv, pc, lb, conv, valid, ok))
                t2 = time.perf_counter()
            wall["em"][K] = wall["em"].get(K, 0.0) + t1 - t0
            wall["bic"] += t2 - t1
            if record is not None:
                start, steps, tie = (
                    np.asarray(stats[k].cpu() if torch.is_tensor(stats[k])
                               else stats[k])
                    for k in ("best_start", "best_steps", "best_tie"))
                for j, gi in enumerate(act):
                    wall["bics"].setdefault(int(idxs[gi]), {})[K] = float(
                        bic[j])
            ok = ok & valid.any(axis=1) & np.isfinite(bic)
            improved = ok & (bic < best_bic[act])
            for j in np.nonzero(improved)[0]:
                gi = act[j]
                best_bic[gi] = bic[j]
                best_params[gi] = (w[j], m[j], cv[j], pc[j], valid[j],
                                   conv[j])
                if record is not None:
                    wall["fit"][int(idxs[gi])] = (K, int(start[j]),
                                                  int(steps[j]))
                    wall["tie"][int(idxs[gi])] = float(tie[j])
            step_up = np.zeros(G, bool)
            step_up[act[improved]] = True
            rounds = np.where(step_up, 0, rounds + active.astype(int))
            K += 1
        for gi, i in enumerate(idxs):
            if (rounds[gi] < max_rounds_without_best_bic
                    and n_max[gi] > _BATCH_K_CAP):
                t0 = time.perf_counter()
                models[i] = _find_optimal_G5M(
                    Xs[i], min_locs=min_locs, sigma_bounds=sigma_bounds,
                    lp=lps[i], loc_prec_handle=loc_prec_handle,
                    max_rounds_without_best_bic=max_rounds_without_best_bic,
                    model_cls=model_cls, calibration=calibration)
                wall["host"] += time.perf_counter() - t0
                wall["host_clusters"] += 1
            elif best_params[gi] is not None:
                models[i] = _model_from_params(
                    model_cls, best_params[gi], len(Xs[i]), min_locs,
                    sigma_bounds, calibration)
            done += 1
            if progress is not None:
                progress(done)
    if record is not None:
        record.update(wall, **{k: stats[k] for k in ("steps", "row_steps")
                               if k in stats})
    return models


def g5m(locs: np.ndarray, info: list[dict], *, min_locs: int = MIN_LOCS,
        loc_prec_handle: Literal["local", "abs"] = "local",
        sigma_bounds: tuple[float, float] = (MIN_SIGMA_FACTOR,
                                             MAX_SIGMA_FACTOR),
        max_rounds_without_best_bic: int = MAX_ROUNDS_WITHOUT_BEST_BIC,
        bootstrap_check: bool = False, calibration: dict | None = None,
        postprocess: bool = True, max_locs_per_cluster: float = np.inf,
        asynch: bool = True, callback_parent=None, device="cuda",
        record: dict | None = None):
    """Run G5M over all clusters (groups) of ``locs``; returns (centers,
    clustered_locs, info) (picasso/g5m.py:2511). From BATCH_MIN_GROUPS
    groups the batched EM runs on ``device``; below, the host route. The
    device is resolved first, whatever the route: ``"cuda"`` without a
    card raises. ``asynch`` is accepted for the reference's API and
    ignored, as JAX does. ``"cuda"`` is one card however many are
    visible; a mesh given (parallel/mesh.route) splits each batched EM's
    clusters over its shards.
    ``record``, where given, gains the batched route's split and fits
    (_fit_clusters_batched; a cluster's index there is its place in
    ``group_input``), its ``models`` and the seconds of the result tables
    (``convert``)."""
    from picasso_torch.parallel.mesh import route

    device, mesh = route(device, spread=False)
    assert loc_prec_handle in ("local", "abs")
    assert len(sigma_bounds) == 2
    assert sigma_bounds[0] <= sigma_bounds[1]
    assert "group" in locs.dtype.names, (
        "Localizations must be grouped. Use DBSCAN or similar.")
    pixelsize = lib.get_from_metadata(info, "Pixelsize")
    if pixelsize is None:
        raise ValueError("Camera pixel size must be provided in info.")
    if "z" in locs.dtype.names and calibration is None:
        raise ValueError(
            "Calibration dictionary must be provided for 3D data.")
    groups, rows = lib.group_rows(locs["group"])
    centers_list, clustered_list = [], []
    with lib.progress_reporter(
            "console" if callback_parent == "console" else None,
            len(groups), "Running G5M") as rep:
        if len(groups) >= BATCH_MIN_GROUPS:
            group_locs, preps = [], []
            for r in rows:
                lg = locs[r]
                prep = _prep_group(
                    lg, min_locs=min_locs, pixelsize=pixelsize,
                    max_locs_per_cluster=max_locs_per_cluster,
                    loc_prec_handle=loc_prec_handle)
                if prep is not None:
                    group_locs.append(lg)
                    preps.append(prep)
            if preps:
                models = _fit_clusters_batched(
                    [p[0] for p in preps], [p[1] for p in preps],
                    min_locs=min_locs, sigma_bounds=sigma_bounds,
                    loc_prec_handle=loc_prec_handle,
                    max_rounds_without_best_bic=max_rounds_without_best_bic,
                    model_cls=preps[0][2], calibration=calibration,
                    progress=rep.set_value,
                    device=device if mesh is None else mesh, record=record)
                t0 = time.perf_counter()
                for lg, model in zip(group_locs, models):
                    if model is None or len(model.valid_idx) == 0:
                        continue
                    c, cl = _convert_results(model, lg, pixelsize,
                                             bootstrap_check)
                    if c is not None and len(c):
                        centers_list.append(c)
                        clustered_list.append(cl)
                if record is not None:
                    record["convert"] = time.perf_counter() - t0
                    record["models"] = models
                    record["group_input"] = [int(lg["group"][0])
                                             for lg in group_locs]
        else:
            for i, r in enumerate(rows):
                c, cl = _run_g5m_group(
                    locs[r], min_locs=min_locs,
                    loc_prec_handle=loc_prec_handle,
                    sigma_bounds=sigma_bounds, pixelsize=pixelsize,
                    max_rounds_without_best_bic=max_rounds_without_best_bic,
                    bootstrap_check=bootstrap_check, calibration=calibration,
                    max_locs_per_cluster=max_locs_per_cluster)
                if c is not None and len(c):
                    centers_list.append(c)
                    clustered_list.append(cl)
                rep.set_value(i + 1)
    if not centers_list:
        empty = np.zeros(0, np.dtype([]))
        return empty, empty.copy(), info
    # re-label groups sequentially across clusters
    offset = 0
    for c, cl in zip(centers_list, clustered_list):
        cl["group"] += offset
        offset += len(c)
    centers = np.concatenate(centers_list)
    clustered_locs = np.concatenate(clustered_list)

    new_info = {
        "Generated by": f"Picasso v{__version__} G5M",
        "Min. locs": min_locs,
        "Sigma bounds": list(sigma_bounds),
        "Sigma bounds method": (
            "Local loc. prec." if loc_prec_handle == "local" else "Abs"),
    }
    if "z" in locs.dtype.names:
        new_info["X Coefficients"] = calibration["X Coefficients"]
        new_info["Y Coefficients"] = calibration["Y Coefficients"]
        new_info["Magnification factor"] = calibration[
            "Magnification factor"]
    info = info + [new_info]
    if postprocess:
        # filter likely sticky events / poor fits (g5m.py:2687-2705)
        n_frames = info[0]["Frames"]
        min_std_frame = 0.1 * n_frames
        min_pval = 0.015
        min_n_events = 3
        idx = ((centers["std_frame"] > min_std_frame)
               & (centers["p_val"] > min_pval)
               & (centers["n_events"] > min_n_events))
        keep_groups = np.arange(len(idx))[idx]
        centers = centers[idx]
        clustered_locs = clustered_locs[
            np.isin(clustered_locs["group"], keep_groups)]
        info[-1]["Filtered"] = True
        info[-1]["Filter; min. std frame"] = min_std_frame
        info[-1]["Filter; min. p value"] = min_pval
        info[-1]["Filter; min. n_events"] = min_n_events
    return centers, clustered_locs, info
