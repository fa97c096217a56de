"""RCC drift correction of one acquisition after another, as ``picasso
localize -d 1000`` ends and ``picasso undrift`` runs: a closed loop with
one client over the locs sets of the traffic, in turn, each through
``picasso_torch.postprocess.undrift`` at the configuration's
segmentation.

End to end: ``undrift_s``, the whole window over the corrections
finished in it (the correction in flight when the window closes is
finished and counted). The check: every correction's drift of every
frame and its undrifted locs against the reference's RCC of the same
locs.
"""

from __future__ import annotations

import time

import torch

from reference import compare
from reference import rcc as ref_rcc

KIND = "undrift"


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 sizes: dict | None = None):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.sizes = seed, device, sizes or {}
        self.segmentation = int(config["undrift"]["segmentation"])
        self.sets: list = []

    def setup(self, generator) -> None:
        """Make the locs on the device and warm every shape with a
        correction of every ``warm_stride``-th loc of the first set."""
        from picasso_torch import postprocess

        self.undrift_fn = postprocess.undrift
        t0 = time.perf_counter()
        self.sets = generator.generate(self.config, self.traffic["params"],
                                       self.seed, self.device,
                                       self.sizes)["sets"]
        t1 = time.perf_counter()
        locs, info = self.sets[0]
        self.undrift_fn(locs[::int(self.traffic["warm_stride"])], info,
                        self.segmentation, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_parts = {"generate_s": t1 - t0,
                            "warm_s": time.perf_counter() - t1}

    def call(self, i: int) -> dict:
        k = i % len(self.sets)
        locs, info = self.sets[k]
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.undrift"):
            drift, undrifted = self.undrift_fn(locs, info, self.segmentation,
                                               device=self.device)
        t1 = time.perf_counter()
        return {"input": k, "t0": t0, "t1": t1, "host_s": t1 - t0,
                "perf": None, "work": 1, "output": (drift, undrifted)}

    @staticmethod
    def end_to_end(calls: list[dict]) -> dict:
        return {"undrift_s": (calls[-1]["t1"] - calls[0]["t0"]) / len(calls)}

    def release(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, k: int, dtype=torch.float64):
        locs, info = self.sets[k]
        return ref_rcc.undrift(locs, info, self.segmentation, dtype=dtype,
                               device=self.device)

    def check(self, calls: list[dict], limits: dict, dtype=torch.float64):
        refs: dict[int, tuple] = {}
        numbers = []
        for c in calls:
            k = c["input"]
            if k not in refs:
                refs[k] = self.reference(k, dtype)
            drift, undrifted = c["output"]
            numbers.append(compare.undrift(self.sets[k][0], drift, undrifted,
                                           *refs[k]))
        return numbers, {}

