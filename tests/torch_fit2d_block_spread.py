#!/usr/bin/env python3
"""The spread of the MLE fit itself on fit2D's dense ROIs, on the CPU:
picasso_tpu's gaussmle (JAX on the CPU) against the port's plain fit
(ops/mle._fit_core) on the first 262,144 ROIs of chip_smoke.py's movie,
cut as fit2D cuts them, both methods, held to torch_parity.compare_fits
and printed (not required):

    JAX_PLATFORMS=cpu python3 tests/torch_fit2d_block_spread.py

chip_smoke.py holds the card's fits of the same block to the plain fit;
this run says how far the reference itself is from the plain fit there
(about 3 min and 2 GB on 4 CPU threads).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX, EPS, MAX_IT, MIN_NG, BLOCK = 7, 1e-3, 100, 4000, 262144


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch

    from picasso_torch import localize
    from picasso_torch.ops import mle
    from picasso_tpu import gaussmle as jmle
    from torch_data import make_bench_movie
    from torch_parity import compare_fits

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    movie = make_bench_movie(2048, 256, 1200, 0.5, np.random.default_rng(13))
    ids = localize.identify(movie, MIN_NG, BOX, device="cpu")[:BLOCK]
    spots = localize.get_spots_raw(movie, ids, BOX,
                                   device="cpu").astype(np.float32)
    del movie
    print(f"{len(spots)} ROIs cut in {time.perf_counter() - t0:.1f} s")
    batch = torch.from_numpy(np.ascontiguousarray(spots.transpose(1, 2, 0)))
    for method in ("sigmaxy", "sigma"):
        plain = [a.numpy() for a in mle._fit_core(batch, EPS, MAX_IT, method)]
        theta, crlb, ll, iters = jmle.gaussmle(spots, EPS, MAX_IT, method)
        ref = [np.asarray(theta).T, np.asarray(crlb).T, np.asarray(ll),
               np.asarray(iters)]
        try:
            verdict = {"within": True, **compare_fits(ref, plain, MAX_IT)}
        except AssertionError as e:
            verdict = {"within": False, "message": str(e)}
        print(f"{method}: JAX vs plain on the fit2D block:",
              json.dumps(verdict))
    return 0


if __name__ == "__main__":
    sys.exit(main())
