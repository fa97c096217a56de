"""Time ops/link.successors (the candidate pairs of link on the device)
with the package's window_pairs against another version of
picasso_torch/ops/link.py, on one card, in turns (A B B A a round).

    python3 tests/torch_link_window_timing.py --against OLD/link.py

``OLD/link.py`` is an earlier commit's module, e.g. ``git show
<commit>:picasso_torch/ops/link.py > .checkout/link_old.py``; it is
loaded beside the package and uses the package's ops/neighbors.py.
Without ``--against`` only the package's version is timed.

The input is the shape of chip_smoke.py's link phase: N_SITES sites in
a 256 x 256 px field, each bound in a frame with probability P_ON over
N_FRAMES frames (about 0.96 M locs), a loc N(0, LP) px from its site,
``group`` the site, sorted by frame. Each version's CSR must equal the
package's. Prints the card's name and power limit, then one line a
(d_max, max_dark_time): the medians and all times in ms.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SITES, N_FRAMES, P_ON, LP, SIZE = 1200, 2048, 0.39, 0.03, 256
CASES = ((1.0, 1), (1.0, 3), (0.1, 3))


def make_locs(seed: int = 0):
    """(frame, x, y, group) of the synthetic field, sorted by frame."""
    rng = np.random.default_rng(seed)
    sites = rng.uniform(4, SIZE - 4, (N_SITES, 2))
    on = rng.random((N_FRAMES, N_SITES)) < P_ON
    frame, site = np.nonzero(on)
    x = sites[site, 0] + rng.normal(0, LP, len(site))
    y = sites[site, 1] + rng.normal(0, LP, len(site))
    return (frame.astype(np.int64), x.astype(np.float32),
            y.astype(np.float32), site.astype(np.int64))


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    from picasso_torch.ops import link

    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="another version of ops/link.py")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    versions = {"package": link}
    if args.against:
        spec = importlib.util.spec_from_file_location("link_against",
                                                      args.against)
        old = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(old)
        versions["against"] = old
    cols = [torch.from_numpy(a).cuda() for a in make_locs()]
    print(f"{len(cols[0])} locs, {N_SITES} groups, {N_FRAMES} frames")
    for d_max, tol in CASES:
        ref = [t.cpu() for t in link.successors(*cols, d_max, tol)]
        times = {k: [] for k in versions}
        order = list(versions)
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = versions[name].successors(*cols, d_max, tol)
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0))
                if not all(torch.equal(a.cpu(), b) for a, b in zip(out, ref)):
                    raise AssertionError(f"{name}: the CSR differs")
        print(f"d_max {d_max} max_dark_time {tol}: {len(ref[1])} successors;"
              + "; ".join(f" {k} median {statistics.median(v):.2f} ms "
                          f"({', '.join(f'{t:.2f}' for t in v)})"
                          for k, v in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
