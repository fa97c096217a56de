#!/usr/bin/env python3
"""The CPU run behind chip_smoke.AIM_Z_RESID: the smoke's AIM 3D recipe
on fewer frames.

    python3 tests/torch_aim_z_bound.py [--frames 512] [--threads 8]

Makes the astigmatic movie of tests/torch_data.make_astig_movie at the
smoke's density (256 x 256, 1200 sites, p_on 0.5, seed 17) with
``--frames`` frames, runs localize_3D (MLE) with the plain PyTorch
versions on the CPU, adds the smoke's drift (+0.8 px linear in x, a 0.5
px sine in y, a chip_smoke.AIM_Z_DRIFT nm sine in z, over the movie) and
prints AIM's residual RMS against it, after the mean, per axis.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> None:
    import torch

    from chip_smoke import AIM_SEGMENTATION, AIM_Z_DRIFT, BOX, MIN_NG
    from picasso_torch import aim, localize
    from torch_data import CALIB_3D, make_astig_movie

    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=512)
    parser.add_argument("--threads", type=int, default=8)
    args = parser.parse_args()
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    movie = make_astig_movie(args.frames, 256, 1200, 0.5,
                             np.random.default_rng(17))[0]
    n = len(movie)
    info = [{"Frames": n, "Height": 256, "Width": 256, "Pixelsize": 130}]
    camera = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
    locs, _ = localize.localize_3D(
        movie, movie_info=info, camera_info=camera, box=BOX,
        minimum_ng=MIN_NG, calibration_3d=CALIB_3D,
        fitting_method="gaussmle", device="cpu")
    t = np.arange(n, dtype=np.float64) / (n - 1)
    inj = {"x": 0.8 * t, "y": 0.5 * np.sin(2 * np.pi * t),
           "z": AIM_Z_DRIFT * np.sin(2 * np.pi * t)}
    for c, d in inj.items():
        locs[c] += d[locs["frame"]].astype(np.float32)
    _, _, drift = aim.aim(locs, info, segmentation=AIM_SEGMENTATION,
                          device="cpu")
    resid = {}
    for c, want in inj.items():
        d = drift[c] - want
        resid[c] = float(np.sqrt(np.mean((d - d.mean()) ** 2)))
    print(f"{n} frames, {len(locs)} locs, {time.perf_counter() - t0:.1f} s: "
          f"AIM residual RMS x {resid['x']:.5f} px, y {resid['y']:.5f} px, "
          f"z {resid['z']:.3f} nm")


if __name__ == "__main__":
    main()
