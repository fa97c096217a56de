#!/usr/bin/env python3
"""The spread of the MLE fit itself on fit2D's dense ROIs, on the CPU:
picasso_tpu's gaussmle (JAX on the CPU) against the port's plain fit
(ops/mle._fit_core) on a block of 262,144 ROIs of chip_smoke.py's movie
(by default the first; ``--block 1`` the second, which played no part in
setting the bounds), cut as fit2D cuts them, both methods: the distances of
torch_parity.fit_stats, whether they lie within compare_fits (they do
not) and within compare_fits_dense, whose bounds are these maxima times
its margin:

    JAX_PLATFORMS=cpu python3 tests/torch_fit2d_block_spread.py \
        [--block K] [--f64]

chip_smoke.py holds the card's fits of the same block to the plain fit;
this run says how far the reference itself is from the plain fit there
(about 3 min and 2 GB on 4 CPU threads).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX, EPS, MAX_IT, MIN_NG, BLOCK = 7, 1e-3, 100, 4000, 262144


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--f64", action="store_true",
                        help="also hold JAX and the plain fit to the plain "
                        "fit in float64 (about 3 min more)")
    parser.add_argument("--block", type=int, default=0,
                        help="which block of 262,144 hits (0: the first)")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch

    from picasso_torch import localize
    from picasso_torch.ops import mle
    from picasso_tpu import gaussmle as jmle
    from torch_data import make_bench_movie
    from torch_parity import compare_fits, compare_fits_dense, fit_stats

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    movie = make_bench_movie(2048, 256, 1200, 0.5, np.random.default_rng(13))
    ids = localize.identify(movie, MIN_NG, BOX, device="cpu")[
        args.block * BLOCK:(args.block + 1) * BLOCK]
    spots = localize.get_spots_raw(movie, ids, BOX,
                                   device="cpu").astype(np.float32)
    del movie
    print(f"block {args.block}: {len(spots)} ROIs cut in "
          f"{time.perf_counter() - t0:.1f} s")
    batch = torch.from_numpy(np.ascontiguousarray(spots.transpose(1, 2, 0)))
    for method in ("sigmaxy", "sigma"):
        plain = [a.numpy() for a in mle._fit_core(batch, EPS, MAX_IT, method)]
        theta, crlb, ll, iters = jmle.gaussmle(spots, EPS, MAX_IT, method)
        ref = [np.asarray(theta).T, np.asarray(crlb).T, np.asarray(ll),
               np.asarray(iters)]
        verdict = {}
        for gate in (compare_fits, compare_fits_dense):
            try:
                gate(ref, plain, MAX_IT)
                verdict[gate.__name__] = True
            except AssertionError:
                verdict[gate.__name__] = False
        print(f"{method}: JAX vs plain on fit2D block {args.block}:",
              json.dumps({**verdict, **fit_stats(ref, plain, MAX_IT)}))
        if not args.f64:
            continue
        f64 = [a.numpy() for a in mle._fit_core(batch.double(), EPS, MAX_IT,
                                                method)]
        for name, fits in (("JAX", ref), ("plain", plain)):
            print(f"{method}: {name} vs the plain fit in f64:",
                  json.dumps(fit_stats(f64, fits, MAX_IT)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
