"""A user localizing one movie after another, as ``picasso localize
"*.ome.tif"`` does: a closed loop with one client over the movies of the
traffic, in turn, each through ``picasso_torch.localize.localize`` with
the configuration's fitter, box, minimum net gradient and camera.

End to end: ``spots_per_s``, all spots of every movie finished in the
window over the time from the first movie's start to the last one's end
(the movie in flight when the window closes is finished and counted).
The check: every movie's identifications against the reference's, and
the fits of a sample of its frames (``check.frames`` a movie, drawn from
the seed) against the fits of the reference fit of the configuration's
fitter (``reference/fits/``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from reference import compare
from reference import locs as ref_locs

KIND = "localize"


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 sizes: dict | None = None):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.sizes = seed, device, sizes or {}
        self.fit = config["fit"]
        self.camera = dict(config["camera"])
        self.parameters = {"Min. Net Gradient": self.fit["min_net_gradient"],
                           "Box Size": self.fit["box"]}
        self.movies: list[np.ndarray] = []

    def setup(self, generator) -> None:
        """Make the movies on the device and warm every shape the window
        uses with a call on the first movie's first frames."""
        from picasso_torch import localize

        self.localize_fn = localize.localize
        t0 = time.perf_counter()
        self.movies = generator.generate(self.config, self.traffic["params"],
                                         self.seed, self.device,
                                         self.sizes)["movies"]
        t1 = time.perf_counter()
        warm = int(self.sizes.get("warm_frames",
                                  self.traffic["warm_frames"]))
        self._localize(self.movies[0][:warm], {})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_parts = {"generate_s": t1 - t0,
                            "warm_s": time.perf_counter() - t1}

    def _localize(self, movie, perf: dict):
        options = {k: self.fit[k] for k in ("fitting_method", "mle_method",
                                            "eps", "max_it") if k in self.fit}
        return self.localize_fn(movie, self.camera, self.parameters,
                                perf=perf, device=self.device, **options)

    def call(self, i: int) -> dict:
        k = i % len(self.movies)
        movie = self.movies[k]
        perf: dict = {}
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.localize"):
            locs = self._localize(movie, perf)
        t1 = time.perf_counter()
        return {"input": k, "t0": t0, "t1": t1, "host_s": t1 - t0,
                "perf": perf, "work": int(len(locs)),
                "frames": int(movie.shape[0]), "height": int(movie.shape[1]),
                "width": int(movie.shape[2]), "output": locs}

    @staticmethod
    def end_to_end(calls: list[dict]) -> dict:
        span = calls[-1]["t1"] - calls[0]["t0"]
        return {"spots_per_s": sum(c["work"] for c in calls) / span}

    def release(self) -> None:
        """Nothing of the program stays on the device between calls."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sampled_frames(self, i: int, n_frames: int) -> np.ndarray:
        """The frames of call ``i`` whose fits are checked: drawn from the
        seed, the same for every run of this seed."""
        rng = np.random.default_rng([int(self.seed) % (1 << 63), i])
        n = min(int(self.sizes.get("check_frames",
                                   self.traffic["check"]["frames"])),
                n_frames)
        return np.sort(rng.choice(n_frames, n, replace=False))

    def reference(self, dtype=torch.float64) -> "Reference":
        return Reference(self, dtype)

    def check(self, calls: list[dict], limits: dict, dtype=torch.float64):
        """(numbers of each call, what the reference learnt: the mean
        iterations of its fits of the sampled spots). A fit is matched
        to a loc within the cell's ``ng_gap`` limit of its net gradient,
        or within :data:`compare.NG_MATCH`, whichever is wider."""
        ref = self.reference(dtype)
        ng_match = max(compare.NG_MATCH, float(limits.get("ng_gap", 0.0)))
        layout = ref_locs.fitter(self.fit).LOCS_DTYPE
        numbers, iters = [], []
        for i, c in enumerate(calls):
            ids, fits = ref.ids_and_fits(c["input"], i)
            numbers.append(compare.localize(
                c["output"], ids, fits, self.fit,
                self.traffic["check"]["quantile"], self.device,
                layout=layout, ng_match=ng_match))
            iters.append(fits["iterations"])
        it = np.concatenate(iters) if iters else np.zeros(0)
        return numbers, {"mean_iterations": float(it.mean()) if len(it)
                         else None, "fitted_spots": int(len(it))}


class Reference:
    """The reference's identifications of each movie (worked out once a
    movie) and its fits of each call's sampled frames, in ``dtype``."""

    def __init__(self, driver: Driver, dtype):
        self.d, self.dtype = driver, dtype
        self.ids: dict[int, dict] = {}

    def ids_and_fits(self, k: int, i: int):
        d = self.d
        movie = d.movies[k]
        if k not in self.ids:
            self.ids[k] = ref_locs.ids_of(movie, d.fit, self.dtype, d.device)
        ids = self.ids[k]
        rows = ref_locs.in_frames(ids["frame"],
                                  d.sampled_frames(i, len(movie)))
        fits = ref_locs.fit_ids(movie, ref_locs.select(ids, rows), d.fit,
                                d.camera, self.dtype, d.device)
        return ids, fits
