#!/usr/bin/env python3
"""Times G5M's batched route (picasso_torch/g5m._fit_clusters_batched) on
one NVIDIA GPU with the clusters padded into power-of-two size buckets
(the package's rule) and into one bucket of the largest cluster's size, at
the shapes of chip_smoke.py's phase 18.

    python3 tests/torch_g5m_bucket_sweep.py [--origami 1000] [--turns 2]

The input is make_origami_locs(n, 0), each loc grouped to its origami.
Each turn runs g5m.g5m (postprocess off) once with each rule, in the
order A B B A. The kmeans++ draws go by the cluster's index, so the two
rules fit alike but where the padding's other reduction order on the card
moves a fit across a near tie: the script holds one rule's tables to the
other's with tests/torch_parity.compare_g5m, the gate of the card against
the CPU, and prints its summary. Prints the buckets, and for each rule
the median wall, its device EM (per K summed over the buckets), the E+M
steps and the rows they ran on, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from picasso_torch import g5m
    from torch_data import make_origami_locs, origami_groups
    from torch_parity import compare_g5m

    ap = argparse.ArgumentParser()
    ap.add_argument("--origami", type=int, default=1000)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    locs, info, truth = make_origami_locs(args.origami, 0)
    locs = origami_groups(locs, truth)
    sizes = np.bincount(locs["group"])
    sizes = sizes[sizes > 0]
    size_buckets = g5m._buckets
    one = max(32, 1 << int(np.ceil(np.log2(sizes.max()))))
    rules = {"size buckets": size_buckets,
             "one bucket": lambda s: {one: list(range(len(s)))}}
    runs = {n: [] for n in rules}
    fits = {}
    for _ in range(args.turns):
        for n in list(rules) + list(rules)[::-1]:
            g5m._buckets = rules[n]
            rec = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            centers = g5m.g5m(locs, info, postprocess=False, device="cuda",
                              record=rec)[0]
            torch.cuda.synchronize()
            runs[n].append((time.perf_counter() - t0,
                            sum(rec["em"].values()), rec["steps"],
                            rec["row_steps"]))
            fits.setdefault(n, (centers, rec))
    g5m._buckets = size_buckets
    (a, ra), (b, rb) = fits.values()
    bitwise = a.dtype == b.dtype and all(np.array_equal(a[f], b[f])
                                         for f in a.dtype.names)
    print(f"card: {smi}")
    print(f"{len(sizes)} origami, {len(locs)} locs; size buckets "
          + json.dumps({int(k): len(v) for k, v in
                        sorted(size_buckets(sizes).items())})
          + f", one bucket {one}; the same tables bit for bit: {bitwise}")
    print(json.dumps({n: {
        "wall_s": round(statistics.median(r[0] for r in v), 4),
        "em_s": round(statistics.median(r[1] for r in v), 4),
        "steps": v[0][2], "row_steps": v[0][3]} for n, v in runs.items()}))
    agree = compare_g5m(a, ra, b, rb, locs, what="size vs one bucket")
    print(f"held by compare_g5m: BIC near ties {agree['bic_ties']}; fit "
          f"alike within {agree['worst_same']:.3e} px (bound "
          f"{agree['same_px']:.3e}); another start or step count at an EM "
          f"near tie (group, fit, fit, px) {agree['stepped']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
