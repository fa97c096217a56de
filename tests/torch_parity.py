"""The tolerances the PyTorch port is held to, in one place: the CPU tests
hold the plain versions to the JAX package with them, and chip_smoke.py
and tests/test_torch_cuda.py hold the CUDA kernels to the plain versions
with them on the card.

Hit lists (frame, y, x): equal, except a hit whose net gradient lies
within 1e-5 relative of the threshold, where another summation order of
ng may flip the threshold test; ng within rtol 1e-5, in the same order.

Fits (theta (6, N) rows [x, y, photons, bg, sx, sy], crlb (6, N), ll
(N,), iters (N,)). Convergence at eps 1e-3 can move by one iteration
under another f32 summation order or another expf/logf, and a spot that
stops one step earlier keeps that step's photons/bg/width update (those
rows are not part of the convergence test). So:
- iters equal for >= 99% of spots; x/y RMS <= 1e-3 px over all spots;
- spots converged at the same iteration: x/y |d| <= 2e-4 px, photons
  rtol 2e-4, sx/sy |d| <= 5e-4, crlb rtol 2e-3; bg rtol 1e-3 plus atol
  1e-3 photons/pixel (bg is clamped at 0.01, where a relative error says
  nothing); ll rtol 1e-4 plus atol 5e-3 (ll sums box^2 terms
  data*ln(model) of ~1e4, each rounded at ~1e-3 before they cancel);
- spots that run to max_it on both sides (they never converge, and
  their paths amplify f32 differences): |d x/y| p90 <= 1e-4 px, p99 <=
  1e-3 px and max <= 0.1 px.
JAX's own fit on the CPU and the plain PyTorch fit differ by as much on
dense DNA-PAINT ROIs (the measured maxima are in PERF.md, Findings), so
these bounds hold the port to the spread of the fit itself.
"""

from __future__ import annotations

import numpy as np

XY_SAME = 2e-4
PHOTONS_REL = 2e-4
SXY_SAME = 5e-4
CRLB_REL = 2e-3
STUCK_XY = {90: 1e-4, 99: 1e-3, 100: 0.1}  # percentile -> px


def compare_fits(ref, got, max_it: int = 100, what: str = "fits") -> dict:
    """Hold ``got`` to ``ref`` (numpy theta, crlb, ll, iters). Raises
    AssertionError with the measured maxima when out of tolerance;
    returns them otherwise (``*_all``: over all spots; ``stuck_*``: over
    the spots at max_it on both sides)."""
    th_r, cr_r, ll_r, it_r = (np.asarray(a) for a in ref)
    th_g, cr_g, ll_g, it_g = (np.asarray(a) for a in got)
    same = (it_r == it_g) & (it_r < max_it)
    stuck = (it_r == max_it) & (it_g == max_it)
    dxy = np.abs(th_r[:2] - th_g[:2])
    dxy_spot = dxy.max(axis=0, initial=0.0)
    rel_ph = np.abs(th_r[2] - th_g[2]) / np.abs(th_r[2])
    dbg = np.abs(th_r[3] - th_g[3])
    dsxy = np.abs(th_r[4:6] - th_g[4:6])
    rel_cr = np.abs(cr_r - cr_g) / np.abs(cr_r)
    dll = np.abs(ll_r - ll_g)
    stats = {
        "n": int(th_r.shape[1]),
        "iters_equal": float(np.mean(it_r == it_g)),
        "converged": float(np.mean(it_r < max_it)),
        "xy_rms_all": float(np.sqrt(np.mean(dxy**2))),
        "xy_max": float(dxy[:, same].max(initial=0.0)),
        "photons_rel": float(rel_ph[same].max(initial=0.0)),
        "bg_abs": float(dbg[same].max(initial=0.0)),
        "sxy_max": float(dsxy[:, same].max(initial=0.0)),
        "crlb_rel": float(rel_cr[:, same].max(initial=0.0)),
        "ll_abs": float(dll[same].max(initial=0.0)),
        "n_stuck": int(stuck.sum()),
        **{f"stuck_xy_p{q}": float(np.percentile(dxy_spot[stuck], q))
           if stuck.any() else 0.0 for q in STUCK_XY},
        "xy_max_all": float(dxy.max(initial=0.0)),
    }
    ok = (
        stats["iters_equal"] >= 0.99
        and stats["xy_rms_all"] <= 1e-3
        and stats["xy_max"] <= XY_SAME
        and stats["photons_rel"] <= PHOTONS_REL
        and bool(np.all(dbg[same] <= 1e-3 + 1e-3 * np.abs(th_r[3, same])))
        and stats["sxy_max"] <= SXY_SAME
        and stats["crlb_rel"] <= CRLB_REL
        and bool(np.all(dll[same] <= 5e-3 + 1e-4 * np.abs(ll_r[same])))
        and all(stats[f"stuck_xy_p{q}"] <= b for q, b in STUCK_XY.items())
    )
    if not ok:
        raise AssertionError(f"{what}: out of tolerance: {stats}")
    return stats


def compare_hits(ref, got, thresh: float, what: str = "hits") -> np.ndarray:
    """Hold hit list ``got`` to ``ref`` (numpy frame, y, x, ng). Raises
    AssertionError when out of tolerance; returns the (n, 2) index pairs
    (ref row, got row) of the matched hits."""
    key_r = {k: i for i, k in enumerate(zip(*(np.asarray(a).tolist()
                                              for a in ref[:3])))}
    key_g = {k: i for i, k in enumerate(zip(*(np.asarray(a).tolist()
                                              for a in got[:3])))}
    for keys, ng, other in ((key_r, ref[3], key_g), (key_g, got[3], key_r)):
        for k, i in keys.items():
            if k not in other and abs(ng[i] - thresh) > 1e-5 * thresh:
                raise AssertionError(f"{what}: hit {k} (ng {ng[i]}) unmatched")
    pairs = np.array(
        [(i, key_g[k]) for k, i in key_r.items() if k in key_g],
        dtype=np.int64,
    ).reshape(-1, 2)
    if np.any(np.diff(pairs[:, 1]) <= 0):
        raise AssertionError(f"{what}: hit order differs")
    ng_r = np.asarray(ref[3])[pairs[:, 0]]
    ng_g = np.asarray(got[3])[pairs[:, 1]]
    if not np.allclose(ng_g, ng_r, rtol=1e-5, atol=0):
        raise AssertionError(f"{what}: ng beyond rtol 1e-5")
    return pairs
