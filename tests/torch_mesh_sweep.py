"""Where a mesh's time goes on one card: SPINNA's batched scorer and G5M
split over logical shards of one card (picasso_torch/parallel/mesh.py),
against the unsharded calls, in turns.

    python3 tests/torch_mesh_sweep.py [--shards 4] [--turns 3]

Needs a card. SPINNA: the cell-scale field of chip_smoke.py's phase 19
(tests/torch_data.SPINNA_CELL, 231 candidates, N_sim 3) scored (a) by
the scorer on one card, (b) over meshes of 1, 2 and ``--shards``
shards of cuda:0 as the package runs them (the shards of a device in
turns, each with the scorer's chunk), (c) over ``--shards`` shards at
once (the device lock bypassed) with a ``--shards``-th of the chunk and
with the whole chunk, and (d) in ``--shards`` parts one after another
on the calling thread with a ``--shards``-th of the chunk; then the
kernels and their device time of (a) and (b) by torch.profiler. G5M:
g5m on the first 64 origami of phase 18's field on one card, over a
one-shard mesh of it, over the mesh, and once over the mesh with its
shards at once. Prints one line a
measurement with the card's name and power limit; the walls are
medians over the turns.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


class _NoLock:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _wall(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profile(fn) -> dict:
    """Kernels launched, their summed device ms and the wall of one call
    of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels": sum(e.count for e in cuda),
            "device_ms": round(sum(e.self_device_time_total
                                   for e in cuda) / 1e3, 3),
            "wall_s (profiled)": round(wall, 4)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mesh_sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from picasso_torch import clusterer, g5m, lib, spinna
    from picasso_torch.parallel import mesh as pmesh
    from torch_data import SPINNA_CELL, make_origami_locs, spinna_cell

    one, seed, n = "cuda:0", 23, args.shards
    meshes = {s: pmesh.Mesh([one] * s) for s in sorted({1, 2, n})}

    mixer, gt = spinna_cell(spinna)
    rows = mixer.convert_N_structures_to_array(spinna.generate_N_structures(
        mixer.structures, {"A": sum(c * k for c, k in zip(
            SPINNA_CELL["counts"], (1, 2, 3)))}, 21))
    scorer = spinna.SPINNA(mixer, gt, N_sim=3,
                           device=one)._get_batched_scorer(rows)
    parts = pmesh._split(len(rows), n)

    shard_copy = scorer.on(one)

    def at_once(chunk):
        """The shards' threads at once (the device lock bypassed), each
        scorer copy with ``chunk``."""
        lock = pmesh._device_lock(torch.device(one))
        pmesh._DEVICE_LOCKS[torch.device(one)] = _NoLock()
        shard_copy.chunk = chunk
        try:
            return pmesh.spinna_score_sharded(scorer, rows, seed, meshes[n])
        finally:
            pmesh._DEVICE_LOCKS[torch.device(one)] = lock
            shard_copy.chunk = scorer.chunk

    def serial_parts(chunk):
        shard_copy.chunk = chunk
        try:
            return np.concatenate([shard_copy.score(rows[lo:hi], seed,
                                                    first=lo)
                                   for lo, hi in parts])
        finally:
            shard_copy.chunk = scorer.chunk

    ref = scorer.score(rows, seed)
    runs = {"one card": lambda: scorer.score(rows, seed)}
    for s, mesh in meshes.items():
        runs[f"mesh {s}"] = (lambda m=mesh: pmesh.spinna_score_sharded(
            scorer, rows, seed, m))
    small = max(1, scorer.chunk // n)
    runs[f"mesh {n}, shards at once, chunk {small}"] = lambda: at_once(small)
    runs[f"mesh {n}, shards at once, chunk {scorer.chunk}"] = (
        lambda: at_once(scorer.chunk))
    runs[f"{n} parts in turn on one thread, chunk {small}"] = (
        lambda: serial_parts(small))
    for name, fn in runs.items():
        if not np.array_equal(fn(), ref):
            raise AssertionError(f"SPINNA {name} != one card")
    walls = {k: [] for k in runs}
    for _ in range(args.turns):
        for name, fn in runs.items():
            walls[name].append(_wall(fn))
    print(f"SPINNA ({smi}): {len(rows)} candidates, N_sim 3, chunk "
          f"{scorer.chunk}; all equal bit for bit; walls s (median of "
          f"{args.turns}, in turns):")
    for name, w in walls.items():
        print(f"  {name}: {statistics.median(w):.4f} ({[round(x, 4) for x in w]})")
    for name in ("one card", f"mesh {n}"):
        print(f"  profiled {name}: {_profile(runs[name])}")

    locs, info, _ = make_origami_locs(1000, 0)
    clustered = clusterer.dbscan(locs, 0.1, 10, device=one)
    ids, _ = lib.group_rows(clustered["group"])
    sub = clustered[np.isin(clustered["group"], ids[:64])]
    g5m_runs = {
        "one card": lambda: g5m.g5m(sub, info, postprocess=False, device=one),
        "mesh 1": lambda: g5m.g5m(sub, info, postprocess=False,
                                  device=meshes[1]),
        f"mesh {n}": lambda: g5m.g5m(sub, info, postprocess=False,
                                     device=meshes[n]),
    }
    walls = {k: [] for k in g5m_runs}
    for _ in range(args.turns):
        for name, fn in g5m_runs.items():
            walls[name].append(_wall(fn))
    print(f"G5M ({smi}) on 64 origami ({len(sub)} locs), walls s (median "
          f"of {args.turns}, in turns):")
    for name, w in walls.items():
        print(f"  {name}: {statistics.median(w):.4f} ({[round(x, 4) for x in w]})")
    for name, fn in g5m_runs.items():
        print(f"  profiled {name}: {_profile(fn)}")
    lock = pmesh._device_lock(torch.device(one))
    pmesh._DEVICE_LOCKS[torch.device(one)] = _NoLock()
    try:
        w = _wall(g5m_runs[f"mesh {n}"])
    finally:
        pmesh._DEVICE_LOCKS[torch.device(one)] = lock
    print(f"  mesh {n}, shards at once (one run): {w:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
