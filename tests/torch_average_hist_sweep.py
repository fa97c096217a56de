#!/usr/bin/env python3
"""Times the histogram step of averaging's device route
(picasso_torch/average._align_groups_device) on one NVIDIA GPU, in ways
that give the same images, at the shapes of chip_smoke.py's phase 18.

    python3 tests/torch_average_hist_sweep.py [--origami 1000]

The input is the first chunk of groups of make_origami_locs(n, 0), each
loc grouped to its origami, rotated by every angle of the workspace
(3 iterations' first, 5 nm display pixels). Variants of the histogram,
each held equal to the first:
- sink: one index_add_ of every (group, angle, loc) entry, those out of
  view or padding sent to one sink slot (the package's form);
- sink per image: the same with a sink slot for each (group, angle);
- compacted: only the entries in view, one index_add_;
- sorted: the entries in view sorted, counted by torch.unique and
  written once.
Prints the entries, the share that goes to the sink, and the median ms of
each variant over 5 turns (A B C D D C B A order), with the rotations and
the FFT and pick of the chunk for scale, beside the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from picasso_torch import average
    from torch_data import make_origami_locs, origami_groups

    ap = argparse.ArgumentParser()
    ap.add_argument("--origami", type=int, default=1000)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    locs, info, truth = make_origami_locs(args.origami, 0)
    locs = average.com_align(origami_groups(locs, truth))
    x, y, rows, angles, ov, t_min, t_max = average._workspace(locs, info,
                                                              5.0)
    P = int(np.ceil(ov * (t_max - t_min)))
    A = len(angles)
    Gb = int(np.clip(average.CHUNK_BUDGET // (A * P * P), 1, 256))
    rows = rows[:Gb]
    G = len(rows)
    L = 1 << int(np.ceil(np.log2(max(len(r) for r in rows))))
    xs = np.zeros((G, L), np.float32)
    ys = np.zeros((G, L), np.float32)
    mask = np.zeros((G, L), bool)
    for gi, r in enumerate(rows):
        xs[gi, :len(r)], ys[gi, :len(r)], mask[gi, :len(r)] = x[r], y[r], 1
    dev = torch.device("cuda")
    xs_t, ys_t, mask_t = (torch.from_numpy(a).to(dev) for a in (xs, ys,
                                                                mask))
    cos_a = torch.from_numpy(np.cos(angles).astype(np.float32)).to(dev)
    sin_a = torch.from_numpy(np.sin(angles).astype(np.float32)).to(dev)
    n_img = G * A * P * P

    def rotate():
        c3, s3 = cos_a[None, :, None], sin_a[None, :, None]
        xr = c3 * xs_t[:, None, :] - s3 * ys_t[:, None, :]
        yr = s3 * xs_t[:, None, :] + c3 * ys_t[:, None, :]
        ok = ((xr > t_min) & (yr > t_min) & (xr < t_max) & (yr < t_max)
              & mask_t[:, None, :])
        xi = torch.clamp((ov * (xr - t_min)).to(torch.int64), 0, P - 1)
        yi = torch.clamp((ov * (yr - t_min)).to(torch.int64), 0, P - 1)
        ga = torch.arange(G * A, device=dev).reshape(G, A, 1)
        return (ga * P + yi) * P + xi, ok, ga

    flat, ok, ga = rotate()
    ones = torch.ones(flat.numel(), dtype=torch.float32, device=dev)

    def sink():
        f = torch.where(ok, flat, torch.full_like(flat, n_img))
        return torch.zeros(n_img + 1, device=dev).index_add_(
            0, f.reshape(-1), ones)[:-1]

    def sink_per_image():
        f = torch.where(ok, flat, n_img + ga.expand_as(flat))
        return torch.zeros(n_img + G * A, device=dev).index_add_(
            0, f.reshape(-1), ones)[:n_img]

    def compacted():
        f = flat[ok]
        return torch.zeros(n_img, device=dev).index_add_(
            0, f, ones[:len(f)])

    def sorted_counts():
        vals, cnt = torch.unique(flat[ok], return_counts=True)
        out = torch.zeros(n_img, device=dev)
        out[vals] = cnt.to(torch.float32)
        return out

    variants = {"sink": sink, "sink per image": sink_per_image,
                "compacted": compacted, "sorted": sorted_counts}
    ref = sink()
    for name, fn in variants.items():
        if not torch.equal(fn(), ref):
            raise AssertionError(f"{name} differs from the sink histogram")

    def ms(fn) -> float:
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        fn()
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    images = ref.reshape(G, A, P, P)
    avg = torch.from_numpy(np.asarray(average._render_hist_square(
        x, y, ov, t_min, t_max)[1], np.float32)).to(dev)
    CF = torch.conj(torch.fft.fft2(avg))

    def fft_pick():
        F = torch.fft.fft2(images)
        xc = torch.fft.fftshift(torch.real(torch.fft.ifft2(F * CF)),
                                dim=(2, 3)).reshape(G, -1)
        return torch.argmax(xc, 1)

    names = list(variants)
    times = {n: [] for n in names}
    for _ in range(5):
        for n in names + names[::-1]:
            times[n].append(ms(variants[n]))
    in_view = int(ok.sum())
    print(f"card: {smi}")
    print(f"chunk: {G} groups x {A} angles x {L} locs = {flat.numel()} "
          f"entries, {in_view} in view ({1 - in_view / flat.numel():.1%} "
          f"to the sink), images {G} x {A} x {P} x {P}")
    print(json.dumps({
        "median_ms": {n: round(statistics.median(v), 4)
                      for n, v in times.items()},
        "rotate_ms": round(statistics.median(ms(rotate) for _ in range(5)),
                           4),
        "fft_pick_ms": round(statistics.median(ms(fft_pick)
                                               for _ in range(5)), 4)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
