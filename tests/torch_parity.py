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
dense DNA-PAINT ROIs of chunk 0 (the measured maxima are in PERF.md,
Findings), so these bounds hold the port to the spread of the fit
itself there and on make_spots. On fit2D's dense blocks (the ROIs of
the smoke movie, where JAX and the plain fit differ beyond these bounds)
the fits are held by :func:`compare_fits_dense`.

LQ fits (theta (6, N) rows [x, y, photons, bg, sx, sy], x/y relative to
the box centre): see :func:`compare_lq_fits`.

avg photons (ROI sums): see :func:`compare_avg_photons`. Movie readers,
raw conversion, identify's hit lists through the port's chunking, the
ROI cuts and each photon-conversion route equal picasso_tpu bit for bit
(tests/test_torch_io.py, tests/test_torch_localize.py). The z fit
(picasso_torch/zfit.py) equals picasso_tpu bit for bit on the same locs,
and the card the CPU; end to end, z differs only where a 2D fit's width
does, by at most tests/test_torch_zfit.Z_DIFF_NM.

The pick analyses and the Mask tool (tests/test_torch_{picks,masking}.py):
bit for bit with JAX on the CPU the lib pick geometry and kinetic fits,
FRET, the thresholds and masks, generate_image, remove_locs_in_picks'
surviving rows, and the events, dark times and kinetic fits of
combine_locs_in_picks, pick_kinetics, evaluate_picks and pick_properties
given JAX's row order (one loc a frame in a pick, or
tests/test_torch_link.jax_order); pick_properties' group statistics
within one f32 ulp (as groupprops, :func:`compare_tables_ulps`); the
card against the CPU the same, its events within one ulp; pick_similar
by :func:`compare_similar_picks`.
"""

from __future__ import annotations

import numpy as np

XY_SAME = 2e-4
PHOTONS_REL = 2e-4
SXY_SAME = 5e-4
CRLB_REL = 2e-3
STUCK_XY = {90: 1e-4, 99: 1e-3, 100: 0.1}  # percentile -> px
# make_spots(131072, 17, 0) at max_it 100: 2110 spots run to max_it on
# both sides, and one of them (spot 129202) ends 0.159 px from the plain
# fit both in JAX (CPU) and in the any-box kernel (card); p99 1.2e-5 px.
# compare_fits(stuck_max=) holds that input's stuck spots at twice it.
# It replaces only the largest stuck distance: a kernel wrong beyond
# rounding still fails there on the 98.4% of spots that converge
# (iters_equal 0.99, XY_SAME, PHOTONS_REL, SXY_SAME, CRLB_REL, bg, ll) and
# on the stuck spots' p90 / p99 (1e-4 / 1e-3 px: about the 211th / 22nd
# largest of the 2110)
STUCK_XY_MAX_BOX17 = 0.32


def fit_stats(ref, got, max_it: int = 100) -> dict:
    """The distances between two MLE fits (numpy theta, crlb, ll, iters)
    that :func:`compare_fits` and :func:`compare_fits_dense` bound
    (``*_all``: over all spots; ``stuck_*``: over the spots at max_it on
    both sides; ``bg_excess`` / ``ll_excess``: the largest |d bg| / (1e-3
    + 1e-3 |bg|) and |d ll| / (5e-3 + 1e-4 |ll|) over the spots converged
    at the same iteration, at most 1 within compare_fits)."""
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
    return {
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
        "bg_excess": float((dbg[same] / (1e-3 + 1e-3 * np.abs(
            th_r[3, same]))).max(initial=0.0)),
        "ll_excess": float((dll[same] / (5e-3 + 1e-4 * np.abs(
            ll_r[same]))).max(initial=0.0)),
        "n_stuck": int(stuck.sum()),
        **{f"stuck_xy_p{q}": float(np.percentile(dxy_spot[stuck], q))
           if stuck.any() else 0.0 for q in STUCK_XY},
        "xy_max_all": float(dxy.max(initial=0.0)),
    }


def compare_fits(ref, got, max_it: int = 100, what: str = "fits",
                 stuck_max: float = None) -> dict:
    """Hold ``got`` to ``ref`` (numpy theta, crlb, ll, iters). Raises
    AssertionError with the measured maxima when out of tolerance;
    returns them otherwise (:func:`fit_stats`). ``stuck_max`` replaces
    the max of STUCK_XY (:data:`STUCK_XY_MAX_BOX17`)."""
    th_r, ll_r, it_r = (np.asarray(ref[i]) for i in (0, 2, 3))
    th_g, ll_g, it_g = (np.asarray(got[i]) for i in (0, 2, 3))
    same = (it_r == it_g) & (it_r < max_it)
    dbg = np.abs(th_r[3] - th_g[3])
    dll = np.abs(ll_r - ll_g)
    stats = fit_stats(ref, got, max_it)
    ok = (
        stats["iters_equal"] >= 0.99
        and stats["xy_rms_all"] <= 1e-3
        and stats["xy_max"] <= XY_SAME
        and stats["photons_rel"] <= PHOTONS_REL
        and bool(np.all(dbg[same] <= 1e-3 + 1e-3 * np.abs(th_r[3, same])))
        and stats["sxy_max"] <= SXY_SAME
        and stats["crlb_rel"] <= CRLB_REL
        and bool(np.all(dll[same] <= 5e-3 + 1e-4 * np.abs(ll_r[same])))
        and all(stats[f"stuck_xy_p{q}"] <= (
            stuck_max if q == 100 and stuck_max is not None else b)
            for q, b in STUCK_XY.items())
    )
    if not ok:
        raise AssertionError(f"{what}: out of tolerance: {stats}")
    return stats


# compare_fits_dense: the JAX-vs-plain maxima on fit2D's dense blocks
# (both methods, four blocks, tests/torch_fit2d_block_spread.py) and the
# margin
DENSE_MEASURED = {"xy_max": 1.762e-4, "photons_rel": 1.143e-3,
                  "bg_excess": 2.415, "sxy_max": 4.796e-4,
                  "crlb_rel": 1.367e-3, "ll_excess": 5.592,
                  "xy_rms_all": 2.135e-4, "stuck_xy_p90": 8.821e-6,
                  "stuck_xy_p99": 1.616e-4, "stuck_xy_p100": 3.558e-2}
DENSE_MARGIN = 2.0
# compare_fits' own bounds, in fit_stats' keys
_FIT_BOUNDS = {"xy_max": XY_SAME, "photons_rel": PHOTONS_REL,
               "bg_excess": 1.0, "sxy_max": SXY_SAME, "crlb_rel": CRLB_REL,
               "ll_excess": 1.0, "xy_rms_all": 1e-3,
               **{f"stuck_xy_p{q}": b for q, b in STUCK_XY.items()}}
DENSE_FITS = {k: max(_FIT_BOUNDS[k], DENSE_MARGIN * v)
              for k, v in DENSE_MEASURED.items()}


def compare_fits_dense(ref, got, max_it: int = 100,
                       what: str = "dense fits") -> dict:
    """Hold ``got`` to ``ref`` on dense ROIs (overlapping emitters, fitted
    widths and backgrounds far from make_spots'), where the fit itself is
    less well conditioned than on the ROIs :func:`compare_fits` was set
    on: the same distances (:func:`fit_stats`), each bounded by the
    larger of compare_fits' bound and DENSE_MARGIN times the largest
    distance between two references on such ROIs; iters equal for >= 99%
    of spots, as there. Raises AssertionError with the distances when out
    of tolerance; returns them otherwise.

    The references: picasso_tpu's gaussmle (JAX on the CPU) against the
    port's plain fit (ops/mle._fit_core, CPU) on the ROIs of chip_smoke.py's
    movie as fit2D cuts them (box 7, eps 1e-3, max_it 100), in its four
    blocks of 262,144 (the last 172,976) ROIs
    (tests/torch_fit2d_block_spread.py --block 0..3), the largest over the
    blocks of each method (sigmaxy / sigma): same-step x/y 1.61e-4 /
    1.76e-4 px, photons 4.45e-4 / 1.14e-3 relative, bg 2.42 / 1.23 times
    compare_fits' bound, sx/sy 2.78e-4 / 4.80e-4, CRLB 7.60e-4 / 1.37e-3
    relative, ll 0.71 / 5.59 times compare_fits' bound; x/y RMS over all
    spots 2.1e-4 / 1.9e-4; at max_it x/y p90 8.8e-6 / 2.5e-6, p99 1.6e-4
    / 7.4e-5, max 1.2e-2 / 3.6e-2 px; iters equal >= 99.92% / 99.95%.
    A maximum over one block is a poor estimate of this heavy-tailed
    spread: the first block alone gave sigma's photons 1.8e-4 and ll 0.67,
    and the second block's sigma fits then fell outside a gate set on the
    first (photons 1.14e-3, ll 5.59; the other blocks 0.50-0.67). Neither
    reference is the exact fit: against the plain fit in f64 (the larger
    over the first two blocks) the plain f32 fit is at x/y 1.07e-4 / 7.9e-5 and JAX at 5.5e-5
    / 2.5e-4, so two f32 fits differ by about the sum of such errors. The
    margin of 2 covers the sampling spread of a maximum over a block; a
    third implementation further from the plain fit than that is a fault
    to find, not a wider bound. So the gate is: x/y 3.52e-4 px, photons
    2.29e-3, bg 4.83 and ll 11.2 times compare_fits' bound, sx/sy 9.59e-4,
    CRLB 2.73e-3; the RMS and the max_it percentiles keep compare_fits'
    bounds, which are the larger."""
    stats = fit_stats(ref, got, max_it)
    bad = {k: (stats[k], b) for k, b in DENSE_FITS.items() if stats[k] > b}
    if stats["iters_equal"] < 0.99:
        bad["iters_equal"] = (stats["iters_equal"], 0.99)
    if bad:
        raise AssertionError(f"{what}: out of the dense tolerance "
                             f"(distance, bound) {bad}: {stats}")
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


def compare_tiles(got, plain, what: str = "tiles") -> None:
    """Hold K4's (tile mask, loc, ng) ``got`` to the plain version's
    ``plain`` (numpy): mask and loc equal, ng within rtol 1e-5 (the
    kernel's FMA order against the plain version's separate products
    and sums)."""
    if not (np.array_equal(got[0], plain[0])
            and np.array_equal(got[1], plain[1])):
        raise AssertionError(f"{what}: tile mask/loc differ from plain")
    if not np.allclose(got[2], plain[2], rtol=1e-5, atol=0):
        raise AssertionError(f"{what}: tile ng beyond rtol 1e-5")


# LQ: percentile -> bound over the spots that are sane on both sides
LQ_XY = {50: 1e-6, 90: 1e-4, 99: 2e-3, 100: 1.0}  # px
LQ_REL_P99 = 2e-3  # photons, sx, sy
LQ_BG_P99 = 1e-2  # |d bg| / max(|bg|, 1 photon)
LQ_COST_REL_P99 = 1e-5
# (threshold, largest share of spots beyond it): the few far-apart fits
LQ_XY_FAR = (1e-2, 5e-3)  # px
LQ_COST_FAR = (1e-3, 5e-3)  # relative
LQ_SANE_BOTH = 0.99
LQ_SANE_ONE_SIDE = 5e-4


def lq_sane(theta: np.ndarray, box: int) -> np.ndarray:
    """Fits that stayed in the box: |x|, |y| < box/2, photons > 0 and
    0 < sx, sy < box."""
    h = box / 2
    with np.errstate(invalid="ignore"):
        return ((np.abs(theta[0]) < h) & (np.abs(theta[1]) < h)
                & (theta[2] > 0) & (theta[4] > 0) & (theta[4] < box)
                & (theta[5] > 0) & (theta[5] < box))


def lq_cost(theta: np.ndarray, spots_t: np.ndarray) -> np.ndarray:
    """Sum of squared residuals of the LQ model, in f64, per spot."""
    s = spots_t.shape[0]
    g = np.arange(s) - s // 2
    th = theta.astype(np.float64)
    with np.errstate(all="ignore"):
        gx = np.exp(-0.5 * ((g[:, None] - th[0]) / th[4]) ** 2) / (
            th[4] * np.sqrt(2 * np.pi))
        gy = np.exp(-0.5 * ((g[:, None] - th[1]) / th[5]) ** 2) / (
            th[5] * np.sqrt(2 * np.pi))
        model = th[2] * gy[:, None, :] * gx[None, :, :] + th[3]
        return ((spots_t - model) ** 2).sum(axis=(0, 1))


def compare_lq_fits(ref, got, spots_t, what: str = "lq fits",
                    box3: bool = False) -> dict:
    """Hold LQ theta ``got`` (6, N) to ``ref`` on the lanes-last spots
    ``spots_t`` (S, S, N). Raises AssertionError with the measured
    numbers when out of tolerance; returns them otherwise.

    The LM fit stops when one accepted step lowers the cost by less than
    ftol = 1e-6 relative, and takes a step only if it lowers the f32 cost.
    Both tests sit on a knife edge: another summation order or another
    expf moves the cost by ~1e-7 relative, so the step at which a spot
    stops, and on a flat cost surface the point where it stops, differ
    between JAX, the plain version and the kernel. Most spots agree to
    f32 rounding; a few dense-field ROIs (overlapping emitters, fitted
    width near the box) end far apart. So the bounds are percentiles,
    and shares of far-apart spots (which, unlike a p99.9, do not depend
    on the sample size):
    - x/y |d| over the spots sane on both sides (:func:`lq_sane`): p50
      <= 1e-6, p90 <= 1e-4, p99 <= 2e-3, max <= 1 px, and <= 0.5% of
      them beyond 1e-2 px;
    - photons, sx, sy relative |d| p99 <= 2e-3; bg |d|/max(|bg|, 1) p99
      <= 1e-2 (LQ bg may sit near or below 0);
    - the final cost (f64, :func:`lq_cost`) relative |d| p99 <= 1e-5,
      and <= 0.5% of the spots beyond 1e-3, over the spots finite on
      both sides;
    - >= 99% of spots sane on both sides, <= 0.05% sane on one side only,
      and the same spots non-finite.
    Measured JAX (XLA, CPU) vs the plain version on the CPU (PERF.md,
    Findings): on the first 256-frame chunk of the smoke movie
    (119,770 dense DNA-PAINT ROIs, box 7, max_it 100) x/y p50 7.6e-8,
    p90 6.7e-6, p99 4.1e-4, max 0.247 px, 12 spots (0.010%) beyond 1e-2
    px; photons/sx/sy rel p99 4.5e-4/3.4e-4/3.4e-4; bg p99 2.1e-3; cost
    rel p99 5.5e-7, max 0.15, 5 spots (0.004%) beyond 1e-3; 99.64% sane
    on both sides, 1 spot on one side only. On the 508 ROIs of the
    32-frame test movie: x/y p99 4.5e-4, max 8.3e-3 px; cost rel max
    3.9e-4. On 8192 make_spots (all converge within 20 iterations) x/y
    max 9.6e-5 px, photons rel max 1.7e-4, cost rel max 1.6e-6.
    With ``box3`` the cost's and bg's p99 bounds are
    :data:`LQ_COST_REL_P99_BOX3` and :data:`LQ_BG_P99_BOX3`.
    """
    stats = lq_stats(ref, got, spots_t)
    if not _lq_within(stats, _lq_bounds(box3)):
        raise AssertionError(f"{what}: out of tolerance: {stats}")
    return stats


def _lq_bounds(box3: bool = False) -> dict:
    """compare_lq_fits' bounds on the distances of :func:`lq_stats`."""
    return {**{f"xy_p{q}": b for q, b in LQ_XY.items()},
            "photons_rel_p99": LQ_REL_P99, "sx_rel_p99": LQ_REL_P99,
            "sy_rel_p99": LQ_REL_P99,
            "bg_p99": LQ_BG_P99_BOX3 if box3 else LQ_BG_P99,
            "xy_far": LQ_XY_FAR[1],
            "cost_rel_p99": LQ_COST_REL_P99_BOX3 if box3 else LQ_COST_REL_P99,
            "cost_far": LQ_COST_FAR[1]}


def _lq_within(stats: dict, bounds: dict, finite_differ: float = 0,
               unsane: float = 1 - LQ_SANE_BOTH,
               one_side: float = LQ_SANE_ONE_SIDE) -> bool:
    """compare_lq_fits' test of :func:`lq_stats`' ``stats`` against the
    distance ``bounds`` (:func:`_lq_bounds`) and the shares: at most
    ``finite_differ`` spots finite on one side only, at most ``unsane``
    of them not sane on both sides, at most ``one_side`` sane on one
    side only."""
    return (stats["finite_differ"] <= finite_differ
            and 1 - stats["sane_both"] <= unsane
            and stats["sane_one_side"] <= one_side
            and all(stats[k] <= b for k, b in bounds.items()))


def lq_stats(ref, got, spots_t) -> dict:
    """The distances and shares between two LQ fits (6, N) on the
    lanes-last spots ``spots_t`` that :func:`compare_lq_fits` bounds
    (``finite_differ``: the spots finite on one side only)."""
    ref, got = np.asarray(ref), np.asarray(got)
    box = spots_t.shape[0]
    fin_r, fin_g = np.isfinite(ref).all(0), np.isfinite(got).all(0)
    sane_r, sane_g = lq_sane(ref, box), lq_sane(got, box)
    ok = sane_r & sane_g
    dxy = np.abs(ref[:2] - got[:2]).max(axis=0)[ok]
    rel = np.abs(ref[[2, 4, 5]] - got[[2, 4, 5]]) / np.abs(ref[[2, 4, 5]])
    dbg = np.abs(ref[3] - got[3]) / np.maximum(np.abs(ref[3]), 1.0)
    c_r, c_g = lq_cost(ref, spots_t), lq_cost(got, spots_t)
    both = np.isfinite(c_r) & np.isfinite(c_g) & (c_r > 0)
    c_rel = np.abs(c_r - c_g)[both] / c_r[both]

    def pct(a, q):
        return float(np.percentile(a, q)) if a.size else 0.0

    stats = {
        "n": int(ref.shape[1]),
        "sane_both": float(ok.mean()) if ok.size else 1.0,
        "sane_one_side": float(np.mean(sane_r ^ sane_g)) if ok.size else 0.0,
        "nonfinite": int((~fin_r).sum()),
        **{f"xy_p{q}": pct(dxy, q) for q in LQ_XY},
        "photons_rel_p99": pct(rel[0][ok], 99),
        "sx_rel_p99": pct(rel[1][ok], 99),
        "sy_rel_p99": pct(rel[2][ok], 99),
        "bg_p99": pct(dbg[ok], 99),
        "xy_far": float(np.mean(dxy > LQ_XY_FAR[0])) if dxy.size else 0.0,
        "cost_rel_p99": pct(c_rel, 99),
        "cost_rel_max": pct(c_rel, 100),
        "cost_far": (float(np.mean(c_rel > LQ_COST_FAR[0]))
                     if c_rel.size else 0.0),
        "xy_max_all": float(np.nanmax(np.abs(ref[:2] - got[:2]), initial=0.0)),
        "finite_differ": int((fin_r != fin_g).sum()),
    }
    return stats


# box 3: six parameters on nine pixels. The LM fit's final cost and its
# bg spread more there: JAX vs the plain version on make_spots (2048 at
# seed 3, 8192 at seed 0) cost rel p99 1.5e-5 and 2.2e-5, bg p99 5.9e-3
# and 5.3e-3; in fit2D on 296 spots of make_bench_movie's first 16
# frames cost rel p99 2.5e-5, bg p99 1.1e-2; every other field of
# compare_lq_fits within its bound
LQ_COST_REL_P99_BOX3 = 1e-4
LQ_BG_P99_BOX3 = 3e-2
# box 3 MLE fits, held at a max_it where every spot is still on its way
# (compare_fits_max_it): relative p99 of photons, bg, sx and sy
MAX_IT_REL_P99 = 1e-4


def compare_fits_max_it(ref, got, max_it: int, what: str = "fits") -> dict:
    """Hold MLE fits of spots that run to max_it, compare_fits' max_it
    branch for all of them: box 3, where the sigmaxy fit has six
    parameters for nine pixels and the sigma fit's width steps by +-1 px
    (the reference's zero-denominator quirk), so most spots never
    converge and their f32 paths drift apart with every step (JAX vs the
    plain version at max_it 100: x/y p99 0.64 px). Held at a small
    max_it (5), over all spots: iters equal for >= 99%; x/y |d| p90 <=
    1e-4, p99 <= 1e-3, max <= 0.1 px (STUCK_XY); photons, bg, sx, sy
    relative |d| p99 <= :data:`MAX_IT_REL_P99`; ll at p99 within
    compare_fits' bound (5e-3 + 1e-4 |ll|). The CRLB is not held:
    the Fisher matrix is near singular there (NaN on one side only for
    up to 5% of the spots, relative p99 0.1-1 on the rest). Measured JAX
    vs plain on make_spots (2048 at seed 3, 8192 at seed 0), max_it 5:
    iters all equal, x/y p99 1.9e-6-7.2e-6, max 1.5e-2 px; photons, bg,
    sx, sy rel p99 <= 1.4e-5."""
    stats = max_it_stats(ref, got, max_it)
    ok = (stats["iters_equal"] >= 0.99
          and all(stats[k] <= b for k, b in MAX_IT_BOUNDS.items()))
    if not ok:
        raise AssertionError(f"{what}: out of tolerance: {stats}")
    return stats


#: compare_fits_max_it's bounds on the distances of :func:`max_it_stats`
MAX_IT_BOUNDS = {**{f"xy_p{q}": b for q, b in STUCK_XY.items()},
                 "rel_p99": MAX_IT_REL_P99, "ll_excess_p99": 1.0}


def max_it_stats(ref, got, max_it: int) -> dict:
    """The distances between two MLE fits (numpy theta, crlb, ll, iters)
    that :func:`compare_fits_max_it` bounds, over all spots."""
    th_r, ll_r, it_r = (np.asarray(ref[i]) for i in (0, 2, 3))
    th_g, ll_g, it_g = (np.asarray(got[i]) for i in (0, 2, 3))
    dxy = np.abs(th_r[:2] - th_g[:2]).max(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(th_r[2:6] - th_g[2:6]) / np.abs(th_r[2:6])
        ll_excess = np.abs(ll_r - ll_g) / (5e-3 + 1e-4 * np.abs(ll_r))
    return {
        "n": int(th_r.shape[1]),
        "iters_equal": float(np.mean(it_r == it_g)),
        "at_max_it": float(np.mean((it_r == max_it) & (it_g == max_it))),
        **{f"xy_p{q}": float(np.percentile(dxy, q)) for q in STUCK_XY},
        "xy_far": float(np.mean(dxy > STUCK_XY[100])),
        "rel_p99": float(np.nanpercentile(rel, 99, axis=1).max()),
        "ll_excess_p99": float(np.nanpercentile(ll_excess, 99)),
    }


# boxes 1 and 2 (six parameters on one or four pixels): how much further
# from the fit in f64 an f32 fit may lie than the reference's f32 fit
ROUNDING_MARGIN = 2.0


def compare_fits_rounding(exact, ref, got, max_it: int,
                          what: str = "fits") -> dict:
    """Hold f32 MLE fits ``got`` where f32 rounding alone moves a fit
    beyond :func:`compare_fits_max_it`'s bounds: box 2, where the sigmaxy
    fit has six parameters for four pixels and a Newton step's clamp
    flips its sign on the rounding of a near-zero denominator (the port's
    plain fit in f32 against the same fit in f64 on 4096 make_spots at
    max_it 5: rel p99 0.17, x/y p99 9.9e-3 px,
    tests/test_torch_anybox.py). ``exact`` is the fit in f64 and ``ref`` the
    reference's fit in f32 (numpy theta, crlb, ll, iters): ``got`` must
    lie as close to ``exact`` as ``ref`` does, up to ROUNDING_MARGIN (two
    f32 fits, each a rounding of the f64 one), or within
    compare_fits_max_it's bounds: each distance of :func:`max_it_stats`
    but the largest, d(exact, got) <= max(bound, ROUNDING_MARGIN *
    d(exact, ref)); the share of spots further than compare_fits_max_it's
    largest distance (0.1 px) from exact at most max(LQ_XY_FAR's share,
    ROUNDING_MARGIN times ref's); the share of spots whose iteration
    count differs from exact's at most max(1%, ROUNDING_MARGIN times
    ref's). The largest distance is reported, not bounded: one runaway
    fit decides it (on the card, one of 131,072 box-2 sigma fits ended
    17.2 px from the f64 fit, the plain f32 fit's furthest 4.0 px, while
    the two f32 fits were within 1.2e-6 px at p99). ``exact`` must be
    the same fit: its own f64 counterpart is held to it by
    compare_fits_max_it (the JAX package's and the port's plain fits in
    f64 at box 2, max_it 5: x/y within 7.6e-11 px). The CRLB is not
    held, as in
    compare_fits_max_it. Returns the three max_it_stats: ``ref`` and
    ``got`` against exact, and ``pair`` (ref against got)."""
    s_ref = max_it_stats(exact, ref, max_it)
    s_got = max_it_stats(exact, got, max_it)
    limits = {k: max(b, ROUNDING_MARGIN * s_ref[k])
              for k, b in MAX_IT_BOUNDS.items() if k != "xy_p100"}
    limits["xy_far"] = max(LQ_XY_FAR[1], ROUNDING_MARGIN * s_ref["xy_far"])
    ok = (1 - s_got["iters_equal"] <= max(
        0.01, ROUNDING_MARGIN * (1 - s_ref["iters_equal"]))
        and all(s_got[k] <= b for k, b in limits.items()))
    stats = {"ref": s_ref, "got": s_got,
             "pair": max_it_stats(ref, got, max_it)}
    if not ok:
        raise AssertionError(f"{what}: further from the f64 fit than "
                             f"{ROUNDING_MARGIN} x the reference: {stats}")
    return stats


def compare_lq_fits_rounding(exact, ref, got, spots_t,
                             what: str = "lq fits") -> dict:
    """Hold f32 LQ fits ``got`` (6, N) where f32 rounding alone moves a
    fit beyond :func:`compare_lq_fits`' bounds: box 2, six parameters on
    four pixels, where the LM drives the cost towards 0 (so its relative
    distance says little) and some fits leave the box (the port's plain
    LM in f32 against the same in f64 on 4096 make_spots: photons rel
    p99 2.0e-2 at max_it 30). As :func:`compare_fits_rounding`: ``exact``
    is the fit in f64,
    ``ref`` the reference's in f32, and each distance of :func:`lq_stats`
    but the largest (reported, not bounded: its share beyond 1e-2 px is)
    d(exact, got) <= max(compare_lq_fits' box-3 bound, ROUNDING_MARGIN *
    d(exact, ref)); the spots finite on one side only, the share not sane
    on both sides and the share sane on one side only each at most
    ROUNDING_MARGIN times ref's, or compare_lq_fits' limit. Returns the
    three lq_stats (``ref``, ``got``, ``pair``)."""
    s_ref = lq_stats(exact, ref, spots_t)
    s_got = lq_stats(exact, got, spots_t)
    limits = {k: max(b, ROUNDING_MARGIN * s_ref[k])
              for k, b in _lq_bounds(True).items() if k != "xy_p100"}
    ok = _lq_within(
        s_got, limits, ROUNDING_MARGIN * s_ref["finite_differ"],
        max(1 - LQ_SANE_BOTH, ROUNDING_MARGIN * (1 - s_ref["sane_both"])),
        max(LQ_SANE_ONE_SIDE, ROUNDING_MARGIN * s_ref["sane_one_side"]))
    stats = {"ref": s_ref, "got": s_got,
             "pair": lq_stats(ref, got, spots_t)}
    if not ok:
        raise AssertionError(f"{what}: further from the f64 fit than "
                             f"{ROUNDING_MARGIN} x the reference: {stats}")
    return stats


# avg photons: |d| <= AVG_PHOTONS_REL * sum |pixel| of the ROI
AVG_PHOTONS_REL = 1e-6


def compare_avg_photons(ref, got, spots, what: str = "avg photons") -> float:
    """Hold the ``avg`` method's photons ``got`` (N,) to ``ref`` on the
    photon-converted (N, S, S) ``spots``. The port sums each ROI in f64
    and rounds once (the correctly rounded sum, up to 2^-53); picasso_tpu
    sums in f32 in numpy's pairwise order, which for S^2 <= 225 terms
    rounds about 8 times, each error at most half an f32 ulp (6e-8) of a
    partial sum no larger than the sum of the |pixels|. So |d| <=
    AVG_PHOTONS_REL * sum |pixel| bounds the reference's own error with
    margin (measured: <= 2.4e-7 relative on the test movies, PERF.md).
    Returns the largest |d| / sum |pixel|."""
    scale = np.abs(np.asarray(spots, np.float64)).sum(axis=(1, 2))
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    rel = d / np.maximum(scale, np.finfo(np.float32).tiny)
    worst = float(rel.max(initial=0.0))
    if worst > AVG_PHOTONS_REL:
        raise AssertionError(f"{what}: |d| / sum|pixel| {worst} > "
                             f"{AVG_PHOTONS_REL}")
    return worst


#: cluster centers (clusterer.find_cluster_centers) of one table on two
#: devices, or against pandas, in f32 ulps of each value: a mean is an f64
#: segment sum rounded to f32 once on either side (pandas: an f32 Kahan
#: sum, tests/test_torch_cluster.py); the ellipticity, sx / sy of two means
#: below 1, moves by two ulps where a mean moves by one
CENTERS_ULPS = 4


def compare_tables_ulps(got: np.ndarray, ref: np.ndarray, ulps: int = 1,
                        what: str = "table") -> int:
    """Hold a locs table ``got`` to ``ref`` (same fields and dtypes):
    integer fields equal, float fields within ``ulps`` of their dtype's
    spacing at ``ref`` (NaN where ``ref`` has NaN). Where the card sums
    f64 with atomics (postprocess._link_loc_groups, groupprops) the order
    differs from the CPU's index order, and a sum rounded to f32 may move
    by one ulp. Returns the number of float cells that differ."""
    if got.dtype != ref.dtype or len(got) != len(ref):
        raise AssertionError(f"{what}: dtype or length differ: {got.dtype} "
                             f"{len(got)} vs {ref.dtype} {len(ref)}")
    differ = 0
    for name in ref.dtype.names:
        a, b = got[name], ref[name]
        if ref.dtype[name].kind != "f":
            if not np.array_equal(a, b):
                raise AssertionError(f"{what}: {name} differs")
            continue
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"{what}: {name} NaN differ")
        ok = ~np.isnan(b)
        d = np.abs(a[ok].astype(np.float64) - b[ok])
        if np.any(d > ulps * np.spacing(np.abs(b[ok]))):
            raise AssertionError(f"{what}: {name} beyond {ulps} ulp(s)")
        differ += int(np.count_nonzero(d))
    return differ


#: G5M's batched route on two devices (g5m.g5m with ``record``): the
#: kmeans++ draws are the same by design, so a cluster's fit differs only
#: at a near tie. A cluster whose chosen K's BIC lies within G5M_BIC_TIE
#: (relative) of another K's may have another molecule count. A cluster
#: fit with the same (K, start, steps) on both devices has its centers
#: within G5M_SAME_ULPS f32 ulps of the largest coordinate: one EM from
#: the same centers moves them by 2 ulps at 30 px on the CPU
#: (tests/test_torch_g5m.EM_M, measured 7.6e-6 px), the card by 3.2 at
#: 128 px (4.83e-5 px on an H100, chip_smoke.py phase 18). A cluster fit
#: with another start or step count must sit within G5M_EM_TIE of a tie
#: in the lower bound (a step's |change| against the convergence
#: tolerance, or the two best starts; the bound of
#: tests/test_torch_g5m.EM_LB on two EMs' lower bounds) on either
#: device, and its centers within G5M_STEPPED_PX (the bound of the JAX
#: package's batched-against-serial test).
G5M_BIC_TIE = 1e-5
G5M_SAME_ULPS = 4
G5M_EM_TIE = 3e-5
G5M_STEPPED_PX = 0.02


def _center_distance(a: np.ndarray, b: np.ndarray, cols) -> float:
    """The largest distance from a center of ``a`` to the nearest of
    ``b`` and back."""
    from scipy.spatial import cKDTree

    pa = np.column_stack([a[c] for c in cols]).astype(np.float64)
    pb = np.column_stack([b[c] for c in cols]).astype(np.float64)
    return float(max(cKDTree(pb).query(pa)[0].max(),
                     cKDTree(pa).query(pb)[0].max()))


def compare_g5m(got: np.ndarray, got_record: dict, ref: np.ndarray,
                ref_record: dict, locs: np.ndarray,
                what: str = "G5M") -> dict:
    """Hold the centers ``got`` of g5m.g5m (postprocess=False) on one
    device to ``ref`` on another, both run on ``locs`` with ``record``,
    under the G5M_* bounds above. Molecules per cluster equal but at BIC
    near ties; for a cluster fit alike, centers within the ulp bound,
    ``n_events`` and ``group_input`` equal and ``n_locs`` equal but
    where a component's weight times the cluster's locs lies within 1e-3
    of a half (the count rounds half to even on a value a few ulps
    apart). Returns the BIC ties, the clusters fit with another start or
    step count (group, fit, fit, px), the bound and the largest distance
    of the clusters fit alike, and the n_locs a half apart."""
    cols = ["x", "y"] + (["z"] if "z" in locs.dtype.names else [])
    same_px = G5M_SAME_ULPS * float(np.spacing(np.float32(max(
        np.abs(locs[c]).max() for c in cols))))
    if got_record["group_input"] != ref_record["group_input"]:
        raise AssertionError(f"{what}: other clusters fit")

    def bic_tie(r, i):
        b = r["bics"].get(i, {})
        k = r["fit"][i][0] if i in r["fit"] else None
        if k is None or len(b) < 2:
            return False
        other = min(v for kk, v in b.items() if kk != k)
        return abs(b[k] - other) <= G5M_BIC_TIE * abs(b[k])

    out = {"bic_ties": [], "stepped": [], "same_px": same_px,
           "worst_same": 0.0, "n_locs_half": 0}
    for i, g in enumerate(got_record["group_input"]):
        a, b = got[got["group_input"] == g], ref[ref["group_input"] == g]
        if bic_tie(got_record, i) or bic_tie(ref_record, i):
            out["bic_ties"].append((g, len(a), len(b)))
            continue
        if len(a) != len(b):
            raise AssertionError(f"{what}: cluster {g} has {len(a)} and "
                                 f"{len(b)} molecules")
        if not len(a):
            continue
        d = _center_distance(a, b, cols)
        fa, fb = got_record["fit"].get(i), ref_record["fit"].get(i)
        if fa != fb:
            tie = min(got_record["tie"].get(i, np.inf),
                      ref_record["tie"].get(i, np.inf))
            if tie > G5M_EM_TIE or d > G5M_STEPPED_PX:
                raise AssertionError(
                    f"{what}: cluster {g} fit {fa} and {fb}, {tie:.2e} "
                    f"from an EM tie, centers {d:.3e} px apart")
            out["stepped"].append((g, fa, fb, d))
            continue
        out["worst_same"] = max(out["worst_same"], d)
        if d > same_px:
            raise AssertionError(f"{what}: cluster {g} fit alike {fa}, "
                                 f"centers {d:.3e} px apart (bound "
                                 f"{same_px:.3e})")
        order = np.argsort(a["x"]), np.argsort(b["x"])
        for n in ("n_events", "group_input"):
            if not np.array_equal(a[n][order[0]], b[n][order[1]]):
                raise AssertionError(f"{what}: {n} of cluster {g} differs")
        na, nb = a["n_locs"][order[0]], b["n_locs"][order[1]]
        if not np.array_equal(na, nb):
            n = np.count_nonzero(locs["group"] == g)
            frac = np.abs(got_record["models"][i].weights * n % 1 - 0.5)
            if not (np.abs(na - nb) <= 1).all() or frac.min() > 1e-3:
                raise AssertionError(f"{what}: n_locs of cluster {g} "
                                     "differ")
            out["n_locs_half"] += 1
    return out


# SPINNA's batched scorer on two devices (card and CPU) with one seed.
# The devices draw the same 32-bit words (ops/spinna_batch.py keys them by
# candidate); uniforms, the coordinates' f32 arithmetic, the per-axis kNN
# sums, the roots (correctly rounded on both) and the KS counts are exact.
# Only the f64 transcendentals of the draws (Box-Muller's log and cos, the
# angles' cos and sin, the quaternion's root) may differ by an ulp between
# the libms, and a coordinate moves by an f32 ulp only where that crosses
# an f32 rounding. A distance that then crosses a ground-truth value moves
# one KS statistic by one ECDF step, 1/n1; a score, a mean of statistics,
# may move by SPINNA_KS_STEPS such steps at most.
SPINNA_KS_STEPS = 4


def spinna_sample_sizes(scorer, masks: dict) -> np.ndarray:
    """The smallest KS sample of each candidate (the valid rows of its
    pairs over the repeats) of BatchedScorer.simulate's ``masks``."""
    sizes = []
    for i1, i2, _ in scorer.pair_keys:
        m1, m2 = (masks[scorer.targets[i]].cpu().numpy() for i in (i1, i2))
        eff = m1 & (m2.sum(1) > 0)[:, None]
        sizes.append(eff.reshape(-1, scorer.N_sim * m1.shape[1]).sum(1))
    return np.min(sizes, axis=0)


def compare_spinna_scores(got, ref, n1, what: str = "SPINNA scores") -> dict:
    """Hold scores ``got`` to ``ref`` of the same candidates and seed:
    each within SPINNA_KS_STEPS / n1 of its candidate's smallest sample
    n1 (:func:`spinna_sample_sizes`). Returns the largest difference, it
    in ECDF steps and the share of scores equal bit for bit."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    n1 = np.maximum(np.asarray(n1, np.float64), 1)
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: shapes {got.shape} / {ref.shape} or "
                             "non-finite scores")
    diff = np.abs(got - ref)
    steps = diff * n1
    if (steps > SPINNA_KS_STEPS).any():
        i = int(np.argmax(steps))
        raise AssertionError(f"{what}: candidate {i} {got[i]!r} / {ref[i]!r}"
                             f", {steps[i]:.2f} ECDF steps of 1/{n1[i]:.0f}")
    return {"max_abs": float(diff.max()), "max_steps": float(steps.max()),
            "equal": float(np.mean(diff == 0))}


# nanotron's MLP (picasso_torch/nanotron.py): two runs of the same
# training from the same weights on the same data (the port against JAX
# on the CPU, the card against the CPU) sum their f32 products in other
# orders, and Adam carries the differences on; the per-epoch mean losses
# stay within MLP_LOSS_REL of each other over a few epochs, and the
# predictions of every image are equal
MLP_LOSS_REL = 1e-4


def compare_mlp(got_curve, ref_curve, got_pred, ref_pred,
                what: str = "MLP") -> dict:
    """Hold a training run's loss curve and predictions to another's.
    Raises AssertionError with the measured numbers when out of
    tolerance; returns them otherwise."""
    got_curve, ref_curve = (np.asarray(c, np.float64)
                            for c in (got_curve, ref_curve))
    rel = np.abs(got_curve - ref_curve) / np.abs(ref_curve)
    stats = {"epochs": len(ref_curve), "loss_rel": float(rel.max(initial=0)),
             "predictions_differ": int(np.sum(np.asarray(got_pred)
                                              != np.asarray(ref_pred)))}
    if (got_curve.shape != ref_curve.shape or stats["loss_rel"] > MLP_LOSS_REL
            or stats["predictions_differ"]):
        raise AssertionError(f"{what}: out of tolerance: {stats}")
    return stats


# average3's scans (picasso_torch/average3.py): the correlations of two
# runs (the port's torch.fft against JAX's numpy FFT, the card's cuFFT
# against the CPU) differ in their last bits, so where a group's best
# and second-best correlation values lie within AVERAGE3_TIE_REL of each
# other the runs may pick other (angle, pixel)s; every other group must
# pick the same
AVERAGE3_TIE_REL = 1e-5


def compare_average3(differ, picks, what: str = "average3 picks") -> dict:
    """Hold two runs of one rotation-scan pass to each other: ``differ``
    (G,) marks the groups whose pick or moved coordinates differ, and
    ``picks`` lists the (best index, best value, second-best value)
    arrays (G,) of one or both runs. Each differing group must be a near
    tie (best - second <= AVERAGE3_TIE_REL |best|) in one of them.
    Raises AssertionError otherwise; returns the counts."""
    differ = np.asarray(differ, bool)
    tie = np.zeros(len(differ), bool)
    for _, val, second in picks:
        val, second = np.asarray(val, np.float64), np.asarray(second,
                                                              np.float64)
        tie |= val - second <= AVERAGE3_TIE_REL * np.abs(val)
    bad = np.nonzero(differ & ~tie)[0]
    stats = {"groups": len(differ), "differ": int(differ.sum()),
             "near_ties": int(tie.sum())}
    if len(bad):
        raise AssertionError(f"{what}: groups {bad.tolist()[:10]} differ "
                             f"and are not near ties: {stats}")
    return stats


def compare_average3_passes(picks_a, picks_b, what: str = "average3") -> str:
    """Hold two average3 runs' passes (their ``picks=`` lists) to each
    other with compare_average3 while their inputs are equal: up to and
    including the first pass whose picks differ (at near ties); later
    passes start from other locs. Returns what was held."""
    held = 0
    for k, (pa, pb) in enumerate(zip(picks_a, picks_b)):
        differ = np.asarray(pa[0]) != np.asarray(pb[0])
        compare_average3(differ, [pa, pb], what=f"{what} pass {k}")
        held += 1
        if differ.any():
            return (f"{held} passes held, pass {k} differs in "
                    f"{int(differ.sum())} near ties")
    if len(picks_a) != len(picks_b):
        raise AssertionError(f"{what}: {len(picks_a)} passes against "
                             f"{len(picks_b)}")
    return f"all {held} passes' picks equal"


#: pick_similar (postprocess.pick_similar) on two devices, or the port
#: against JAX's loop on the CPU. The statistics of the given picks and
#: the hex grid are the same numbers on both sides. A walk's centre is an
#: f32 mean: JAX sums the locs in f32 pairwise in cKDTree's order, the
#: port in f64 rounded once (atomics on the card), so a centre may differ
#: by an f32 ulp or so of the largest coordinate; the same picks come out
#: in the same order with centres within SIMILAR_SAME_ULPS such ulps
#: (measured: 1 ulp at 132 px on the CPU, make_origami_locs(1000, 0)).
#: A candidate may come out on one side only, or with its centre up to
#: SIMILAR_STEPPED_PX away, at a recorded near tie, where a centre that
#: differs by same_px (SIMILAR_SAME_ULPS ulps) may flip a test: a loc
#: within same_px of a ball's edge during the walk, a move within 2
#: same_px of the walk's tolerance (another step count), an rmsd within
#: SIMILAR_SAME_ULPS f32 ulps of its bound, a distance to an accepted
#: pick within 2 same_px of d, or the suppression by a pick that is a
#: near tie itself. The bounds on a count are integers against the same
#: f64 numbers on both sides, so a count flips only at a ball's edge.
SIMILAR_SAME_ULPS = 4
SIMILAR_STEPPED_PX = 0.01


def similar_ties(record: dict, same_px: float) -> np.ndarray:
    """The candidates of a pick_similar ``record`` at a near tie (above),
    in the candidates' order (a suppression inherits its pick's tie)."""
    lo_n, hi_n, lo_r, hi_r = record["bounds"]
    rmsd = record["rmsd"].astype(np.float64)
    with np.errstate(invalid="ignore"):
        tie = ((record["edge"] <= same_px)
               | (record["move"] <= 2 * same_px)
               | (np.abs(np.sqrt(record["dup_d2"].astype(np.float64))
                         - record["d"]) <= 2 * same_px))
        for b in (lo_r, hi_r):
            tie |= np.abs(rmsd - b) <= SIMILAR_SAME_ULPS * float(
                np.spacing(np.float32(abs(b))))
    tie &= record["started"]
    for k in np.nonzero(record["dup_of"] >= 0)[0]:
        tie[k] |= tie[record["dup_of"][k]]
    return tie


def compare_similar_picks(got: list, got_record: dict, ref: list,
                          ref_record: dict | None = None,
                          what: str = "pick_similar") -> dict:
    """Hold the picks ``got`` of pick_similar (with its ``record``) to
    ``ref`` (another device's with its record, or JAX's list) under the
    rule above: walked in order, a pair within same_px matches; a pick at
    a near tie of its side may pair with one up to SIMILAR_STEPPED_PX
    away or stand alone; a pick of ``ref`` alone is a near tie of
    ``ref_record``, or without one lies within SIMILAR_STEPPED_PX of a
    candidate of ``got_record`` at a near tie. Returns the matched count,
    the bound and the largest distance of the matches, and the picks
    paired at a tie or alone on either side."""
    cand = got_record["candidates"]
    same_px = SIMILAR_SAME_ULPS * float(np.spacing(np.float32(
        np.abs(cand).max())))
    g = np.array(got, np.float64).reshape(-1, 2)
    r = np.array(ref, np.float64).reshape(-1, 2)
    gk = np.nonzero(got_record["accepted"])[0]
    tie_g = similar_ties(got_record, same_px)
    if ref_record is not None:
        rk = np.nonzero(ref_record["accepted"])[0]
        tie_r = similar_ties(ref_record, same_px)
    tied_com = got_record["com"][tie_g].astype(np.float64)
    out = {"matched": 0, "same_px": same_px, "worst_px": 0.0,
           "stepped": [], "got_alone": [], "ref_alone": []}
    i = j = 0
    while i < len(g) or j < len(r):
        d = (np.abs(g[i] - r[j]).max() if i < len(g) and j < len(r)
             else np.inf)
        ti = i < len(g) and tie_g[gk[i]]
        tj = (j < len(r) and ref_record is not None and tie_r[rk[j]])
        if d <= same_px:
            out["matched"] += 1
            out["worst_px"] = max(out["worst_px"], float(d))
            i, j = i + 1, j + 1
        elif (ti or tj) and d <= SIMILAR_STEPPED_PX:
            out["stepped"].append((i, j, float(d)))
            i, j = i + 1, j + 1
        elif ti:
            out["got_alone"].append(i)
            i += 1
        elif j < len(r) and (tj or (ref_record is None and len(tied_com) and
                                    np.abs(tied_com - r[j]).max(1).min()
                                    <= SIMILAR_STEPPED_PX)):
            out["ref_alone"].append(j)
            j += 1
        else:
            raise AssertionError(
                f"{what}: pick {i} of {len(g)} and {j} of {len(r)} differ "
                f"by {d:.3e} px (bound {same_px:.3e}) at no near tie")
    return out
