"""The readings that the limits of ``correct`` are set from: for each
seed, the cell's timed entry on one input at the cell's size (the
program), and the reference put in its place in the precision below the
configuration's (the control), each compared with the reference by the
numbers of the cell's check. One JSON line a seed, then the largest
reading of the program and the smallest of the control per number.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 0|1] [--look 0|1]

With ``--look 1`` (a localize cell) it lists, for every movie and every
place of a checked call, the fits that converged on both sides and lie
more than ``compare.FAR_PX`` apart: both sides' parameters and steps,
the reference's precision, and the float64 log-likelihood of the spot at
the program's parameters against that at the reference's. It runs on the
card only, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from core import device as dev_info  # noqa: E402
from core.spec import Cell  # noqa: E402
from reference import compare  # noqa: E402
from reference import control  # noqa: E402
from reference import locs as ref_locs  # noqa: E402
from reference import mle as ref_mle  # noqa: E402


def fit_spread(driver, call: dict, ids: dict, fits: dict) -> dict:
    """Quantiles of the program's position gap over the sampled spots and
    the share of reference fits that ran to max_it."""
    locs = call["output"]
    m = compare.match(fits, locs, driver.device)
    ok = m >= 0
    gap = np.maximum(np.abs(locs["x"][m[ok]] - fits["x"][ok]),
                     np.abs(locs["y"][m[ok]] - fits["y"][ok]))
    q = {f"xy_q{p}": float(np.quantile(gap, p / 1000)) for p in
         (500, 900, 990, 999)} if ok.any() else {}
    q["xy_max"] = float(gap.max()) if ok.any() else None
    it = fits["iterations"]
    q["ref_at_max_it"] = float((it >= driver.fit["max_it"]).mean())
    q["prog_at_max_it"] = float(
        (locs["iterations"] >= driver.fit["max_it"]).mean())
    q["spots"], q["fitted"] = int(len(locs)), int(ok.sum())
    return q


def far_fits(driver, locs: np.ndarray, k: int, i: int, limits: dict,
             most: int = 12) -> dict:
    """The fits of call place ``i`` on movie ``k`` that converged on both
    sides and lie more than ``compare.FAR_PX`` apart, each with what
    tells why."""
    movie, fit, max_it = driver.movies[k], driver.fit, driver.fit["max_it"]
    ids, fits = driver.reference().ids_and_fits(k, i)
    rows = ref_locs.in_frames(ids["frame"],
                              driver.sampled_frames(i, len(movie)))
    box = ref_locs.select(ids, rows)
    m = compare.match(fits, locs, driver.device,
                      max(compare.NG_MATCH, limits.get("ng_gap", 0.0)))
    ok = np.nonzero(m >= 0)[0]
    pm = m[ok]
    gap = np.maximum(np.abs(locs["x"][pm] - fits["x"][ok]),
                     np.abs(locs["y"][pm] - fits["y"][ok]))
    conv = ((locs["iterations"][pm] < max_it)
            & (fits["iterations"][ok] < max_it))
    far = np.nonzero(conv & (gap > compare.FAR_PX))[0]
    out = {"movie": k, "place": i, "fits": int(len(fits["x"])),
           "converged_both": int(conv.sum()), "far": int(len(far)),
           "rows": []}
    h = fit["box"] // 2
    off = np.arange(fit["box"]) - h
    cam = driver.camera
    for j in far[np.argsort(-gap[far])][:most]:
        r, p = ok[j], pm[j]
        f, y, x = box["frame"][r], box["y"][r], box["x"][r]
        spot = movie[f, y + off[:, None], x + off[None, :]].astype(np.float64)
        spot = (spot - cam["Baseline"]) * cam["Sensitivity"] / cam["Gain"]
        spots = torch.as_tensor(spot[None], device=driver.device)

        def theta(t, name_x="x", name_y="y"):
            return [t[name_x] - (x - h), t[name_y] - (y - h), t["photons"],
                    t["bg"], t["sx"], t["sy"]]

        th = torch.tensor([theta({n: float(fits[n][r]) for n in
                                  ("x", "y", "photons", "bg", "sx", "sy")}),
                           theta({n: float(locs[n][p]) for n in
                                  ("x", "y", "photons", "bg", "sx", "sy")})],
                          dtype=torch.float64, device=driver.device)
        _, ll = ref_mle.crlb_and_ll(th, spots.expand(2, -1, -1))
        near = np.nonzero(box["frame"] == f)[0]
        d_near = np.hypot(box["x"][near] - x, box["y"][near] - y)
        out["rows"].append({
            "frame": int(f), "gap_px": float(gap[j]),
            "ref": [float(fits[n][r]) for n in ("x", "y", "photons", "bg",
                                                 "sx", "sy")],
            "prog": [float(locs[n][p]) for n in ("x", "y", "photons", "bg",
                                                  "sx", "sy")],
            "ref_steps": int(fits["iterations"][r]),
            "prog_steps": int(locs["iterations"][p]),
            "lpx_lpy": [float(fits["lpx"][r]), float(fits["lpy"][r])],
            "ll_f64_at_ref": float(ll[0]), "ll_f64_at_prog": float(ll[1]),
            "next_spot_px": float(np.sort(d_near)[1]) if len(near) > 1
            else None})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=1)
    parser.add_argument("--look", type=int, default=0)
    args = parser.parse_args(argv)
    dev_info.require_cuda(1)
    device = torch.device("cuda:0")
    cell = Cell(args.workload)
    mod = cell.driver()
    worst_prog: dict = {}
    least_ctrl: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        driver = mod.Driver(cell.config, cell.traffic, seed, device)
        driver.setup(cell.generator())
        call = driver.call(0)
        prog, info = driver.check([call], cell.limits)
        line = {"seed": seed, "program": prog[0], "reference": info,
                "host_s": call["host_s"]}
        if mod.KIND == "localize":
            ids, fits = driver.reference().ids_and_fits(0, 0)
            line["spread"] = fit_spread(driver, call, ids, fits)
        if args.look and mod.KIND == "localize":
            outs = [call["output"]] + [driver.call(k)["output"] for k in
                                       range(1, len(driver.movies))]
            line["look"] = [far_fits(driver, outs[k], k, i, cell.limits)
                            for k in range(len(outs)) for i in
                            range(cell.traffic["check"]["calls"])]
        if args.control:
            line["control"] = control.numbers(driver, mod.KIND, cell.limits)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        for k, v in prog[0].items():
            worst_prog[k] = max(worst_prog.get(k, v), v)
        for k, v in line.get("control", {}).items():
            least_ctrl[k] = min(least_ctrl.get(k, v), v)
        del driver
        torch.cuda.empty_cache()
    print(json.dumps({"program_largest": worst_prog,
                      "control_smallest": least_ctrl,
                      "kind": torch.cuda.get_device_name(0),
                      "power_limit_w": dev_info.power_limit_w()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
