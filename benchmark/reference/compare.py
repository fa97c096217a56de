"""The numbers that decide ``correct``: what a run produced against the
plain reference on the same inputs.

Localize, over every frame of a movie:
- ``ids_unmatched``: the identifications one side has more than the
  other in a frame, less those within :data:`TIE` of the threshold,
  where rounding may decide;
- ``ng_gap``: in the frames where both sides have as many, the widest
  relative gap between the net gradients of equal rank;
and over the spots of sampled frames, each reference fit matched to the
program's loc of its frame within ``ng_match`` of its net gradient (the
cell's ``ng_gap`` limit, at least :data:`NG_MATCH`), nearest in place:
- ``fits_unmatched``: the reference fits that no loc matches, less those
  within :data:`TIE` of the threshold;
- ``xy_far_share``: of the matched fits that converged on both sides
  (fewer than ``max_it`` steps), the share that lie more than
  :data:`FAR_PX` apart in x or y (a share, so that it reads alike at
  any number of sampled fits);
- ``xy_gap_px``, ``sxy_gap_px``: the q-quantile (``q`` the traffic's) of
  the larger gap of x and y, and of sx and sy, in px;
- ``photons_bg_gap``, ``crlb_gap``, ``ll_gap``: the q-quantile of the
  largest relative gap of photons and bg, of the six uncertainties, and
  of the log-likelihood.
Quantiles, because a fit that runs to ``max_it`` goes where its rounding
takes it (f32 and f64 end up to hundreds of px apart); the widest gap
of such fits is no steady number. The fit numbers cover the fields that
the reference fit of the configuration's fitter gives.
A field that is NaN on one side only counts as an infinite gap.
Besides, ``layout_mismatch`` counts the fields of the locs table whose
name or type is not those of the fitter's table in Picasso.

Undrift: ``drift_gap_px``, the widest gap of the drift of any frame;
``locs_gap_px``, the widest gap of any undrifted x or y; ``fields_changed``,
the other fields (and rows) that the correction changed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.locs import LOCS_DTYPE

#: relative distance to the threshold inside which an identification is
#: a tie that rounding decides
TIE = 1e-4
#: the least relative distance of two net gradients of one spot at which
#: a fit is matched (the program's are within 2.2e-6 of the reference's
#: on every seed read)
NG_MATCH = 1e-5


#: candidates on each side of a row's place in the other side's order
WINDOW = 8


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def match(a: dict, b: dict, device="cpu", tol: float = NG_MATCH
          ) -> np.ndarray:
    """For each row of ``a``, the row of ``b`` in the same frame with a
    net gradient within ``tol`` (relative) that lies nearest to it
    (``x``, ``y``), or -1; sorted and searched on ``device``. Two spots
    of a frame may share a net gradient that closely, so the place
    decides among them."""
    ka = _t(a["frame"], device) * 2.0 ** 26 + _t(a["net_gradient"], device)
    kb = _t(b["frame"], device) * 2.0 ** 26 + _t(b["net_gradient"], device)
    n = len(kb)
    if n == 0 or len(ka) == 0:
        return np.full(len(ka), -1, np.int64)
    kb_sorted, order = torch.sort(kb)
    pos = torch.searchsorted(kb_sorted, ka)
    cand = pos[:, None] + torch.arange(-WINDOW, WINDOW, device=device)
    ok = (cand >= 0) & (cand < n)
    cand = cand.clamp(0, n - 1)
    tol = tol * torch.clamp(_t(a["net_gradient"], device).abs(),
                                 min=1.0)
    ok &= (kb_sorted[cand] - ka[:, None]).abs() <= tol[:, None]
    rows = order[cand]
    dist = torch.hypot(_t(b["x"], device)[rows] - _t(a["x"], device)[:, None],
                       _t(b["y"], device)[rows] - _t(a["y"], device)[:, None])
    dist = torch.where(ok, dist, math.inf)
    best = dist.argmin(1)
    found = ok.gather(1, best[:, None])[:, 0]
    return torch.where(found, rows.gather(1, best[:, None])[:, 0],
                       -1).cpu().numpy()


def _gap(a, b, relative: bool) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.abs(a - b)
        if relative:
            d = d / np.maximum(np.abs(b), 1e-30)
    both = np.isnan(a) & np.isnan(b)
    one = np.isnan(a) ^ np.isnan(b)
    return np.where(both, 0.0, np.where(one, np.inf, d))


def _quantile(v: np.ndarray, q: float) -> float:
    return float(np.quantile(v, q)) if len(v) else 0.0


def layout_mismatch(dtype: np.dtype, layout: np.dtype = LOCS_DTYPE) -> int:
    """The fields of ``dtype`` missing from ``layout``, or there of
    another type, or not there."""
    names = dtype.names or ()
    missing = sum(n not in names or dtype[n] != layout[n]
                  for n in layout.names)
    return int(missing + sum(n not in layout.names for n in names))


def _ranked(frame, ng, n_frames: int, device):
    """(net gradients sorted by frame then value, each frame's count and
    first row)."""
    f = torch.as_tensor(np.asarray(frame, np.int64), device=device)
    g = _t(ng, device)
    order = torch.sort(f.to(torch.float64) * 2.0 ** 26 + g).indices
    counts = torch.bincount(f, minlength=n_frames)
    return g[order], counts, torch.cumsum(counts, 0) - counts


def identifications(p_frame, p_ng, r_frame, r_ng, threshold: float,
                    device="cpu") -> tuple[int, float]:
    """(``ids_unmatched``, ``ng_gap``) of the program's identifications
    (frame, net gradient) against the reference's."""
    n = max((int(np.max(f)) for f in (p_frame, r_frame) if len(f)),
            default=0)
    pg, pc, p0 = _ranked(p_frame, p_ng, n + 1, device)
    rg, rc, r0 = _ranked(r_frame, r_ng, n + 1, device)
    ties = torch.bincount(
        torch.cat([torch.as_tensor(np.asarray(f, np.int64), device=device)[
            (_t(g, device) - threshold).abs() <= TIE * threshold]
            for f, g in ((p_frame, p_ng), (r_frame, r_ng))]),
        minlength=n + 1)
    unmatched = int(torch.clamp((pc - rc).abs() - ties, min=0).sum())
    rf = torch.as_tensor(np.asarray(r_frame, np.int64), device=device)
    rf = torch.sort(rf).values
    same = (pc == rc)[rf]
    rank = torch.arange(len(rf), device=device) - r0[rf]
    pair = (p0[rf] + rank)[same]
    if len(pair) == 0:
        return unmatched, 0.0
    gap = ((pg[pair] - rg[same]).abs() / rg[same].abs().clamp(min=1e-30))
    return unmatched, float(gap.max())


#: the fit numbers: each the q-quantile over the matched fits of the
#: largest gap of its fields, absolute (px) or relative
FIT_GROUPS = {
    "xy_gap_px": (("x", "y"), False),
    "sxy_gap_px": (("sx", "sy"), False),
    "photons_bg_gap": (("photons", "bg"), True),
    "crlb_gap": (("lpx", "lpy", "photons_unc", "bg_unc", "sx_unc",
                  "sy_unc"), True),
    "ll_gap": (("log_likelihood",), True),
}
#: a position gap (px) far beyond the f32 rounding of a converged fit
#: (1e-5 px); only fits that converge slowly and stop at different steps
#: on the two sides reach it (0 to 4 of ~56,000 a sampled movie)
FAR_PX = 1e-3


def localize(locs: np.ndarray, ref_ids: dict, ref_fits: dict, fit: dict,
             q: float, device="cpu", *, layout: np.dtype = LOCS_DTYPE,
             ng_match: float = NG_MATCH) -> dict:
    """The numbers of one localized movie: ``locs`` (the run's table, of
    the ``layout`` its fitter writes), ``ref_ids`` (the reference's
    identifications of the whole movie), ``ref_fits`` (the reference's
    fits of the sampled frames' spots), ``fit`` (the configuration's
    fit: threshold, ``max_it``); the identifications matched on
    ``device``, a fit to a loc within ``ng_match`` of its net gradient."""
    threshold, max_it = fit["min_net_gradient"], fit["max_it"]
    names = locs.dtype.names or ()
    unmatched, ng_gap = identifications(
        locs["frame"], locs["net_gradient"], ref_ids["frame"],
        ref_ids["net_gradient"], threshold, device)
    m = match(ref_fits, locs, device, ng_match)
    ok = m >= 0
    tie = np.abs(np.asarray(ref_fits["net_gradient"], np.float64)
                 - threshold) <= TIE * threshold
    out = {"ids_unmatched": unmatched, "ng_gap": ng_gap,
           "layout_mismatch": layout_mismatch(locs.dtype, layout),
           "fits_unmatched": int((~ok & ~tie).sum())}
    groups = {k: [n for n in fields if n in ref_fits and n in names]
              for k, (fields, _) in FIT_GROUPS.items()}
    p = {n: np.asarray(locs[n])[m[ok]] for g in groups.values() for n in g}
    r = {n: np.asarray(ref_fits[n])[ok] for g in groups.values() for n in g}

    def worst(fields, relative):
        return np.max([_gap(p[n], r[n], relative) for n in fields], axis=0)

    for k, fields in groups.items():
        if fields:
            out[k] = (_quantile(worst(fields, FIT_GROUPS[k][1]), q)
                      if ok.any() else 0.0)
    if groups["xy_gap_px"] and "iterations" in ref_fits:
        p_it = (np.asarray(locs["iterations"])[m[ok]] if "iterations" in
                names else np.full(int(ok.sum()), max_it))
        both = (p_it < max_it) & (np.asarray(ref_fits["iterations"])[ok]
                                  < max_it)
        far = worst(groups["xy_gap_px"], False) > FAR_PX if ok.any() else ok
        out["xy_far_share"] = float((far & both).sum() / max(both.sum(), 1))
    return out


def undrift(locs_in: np.ndarray, drift: np.ndarray, locs_out: np.ndarray,
            ref_drift: np.ndarray, ref_x: np.ndarray,
            ref_y: np.ndarray) -> dict:
    """The numbers of one drift correction: the run's drift (a record
    array with fields x, y) and undrifted locs against the reference's
    drift (frames, 2) and undrifted x, y."""
    drift_gap = float(max(np.abs(drift["x"] - ref_drift[:, 0]).max(),
                          np.abs(drift["y"] - ref_drift[:, 1]).max())) if (
        len(drift) == len(ref_drift)) else float("inf")
    changed = 0
    if len(locs_out) != len(locs_in):
        changed = abs(len(locs_out) - len(locs_in)) + len(locs_in.dtype.names)
        locs_gap = float("inf")
    else:
        locs_gap = float(max(_gap(locs_out["x"], ref_x, False).max(),
                             _gap(locs_out["y"], ref_y, False).max()))
        for n in locs_in.dtype.names:
            if n in ("x", "y"):
                continue
            if n not in (locs_out.dtype.names or ()) or not np.array_equal(
                    locs_out[n], locs_in[n]):
                changed += 1
    return {"drift_gap_px": drift_gap, "locs_gap_px": locs_gap,
            "fields_changed": changed}
