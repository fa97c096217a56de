"""The control of ``correct``: the reference put in the program's place
and computed one precision below the configuration's (bfloat16 for its
float32 fit and renders), judged by the same numbers as the program. A
check that passes the control cannot tell a lower precision from the
program."""

from __future__ import annotations

import numpy as np
import torch

from reference import compare
from reference import locs as ref_locs
from reference import rcc as ref_rcc

CONTROL = torch.bfloat16


def localize_table(driver, k: int, i: int, dtype=CONTROL) -> np.ndarray:
    """The control's locs table of movie ``k``: the reference in
    ``dtype``, its identifications of every frame and its fits of call
    ``i``'s sampled frames (the other rows' fit fields NaN), in the
    layout of the configuration's fitter."""
    movie = driver.movies[k]
    layout = ref_locs.fitter(driver.fit).LOCS_DTYPE
    ids = ref_locs.ids_of(movie, driver.fit, dtype, driver.device)
    rows = ref_locs.in_frames(ids["frame"],
                              driver.sampled_frames(i, len(movie)))
    fits = ref_locs.fit_ids(movie, ref_locs.select(ids, rows), driver.fit,
                            driver.camera, dtype, driver.device)
    out = np.zeros(len(ids["frame"]), layout)
    for name in layout.names:
        if out.dtype[name].kind == "f":
            out[name] = np.nan
    out["frame"] = ids["frame"]
    out["net_gradient"] = ids["net_gradient"]
    idx = np.nonzero(rows)[0]
    for name, col in fits.items():
        if name in layout.names and name not in ("frame", "net_gradient"):
            out[name][idx] = col
    return out


def localize_numbers(driver, limits: dict, k: int = 0) -> dict:
    """The control's numbers in the place of the first checked call, on
    movie ``k``, against the float64 reference, as the cell's check
    reads them."""
    numbers, _ = driver.check([{"input": k,
                                "output": localize_table(driver, k, 0)}],
                              limits)
    return numbers[0]


def undrift_numbers(driver, k: int = 0) -> dict:
    locs, info = driver.sets[k]
    drift, x, y = ref_rcc.undrift(locs, info, driver.segmentation, CONTROL,
                                  driver.device)
    out = locs.astype([(n, np.float64 if n in ("x", "y") else locs.dtype[n])
                       for n in locs.dtype.names])
    out["x"], out["y"] = x, y
    rec = np.empty(len(drift), [("x", np.float64), ("y", np.float64)])
    rec["x"], rec["y"] = drift[:, 0], drift[:, 1]
    return compare.undrift(locs, rec, out, *driver.reference(k))


def numbers(driver, kind: str, limits: dict) -> dict:
    return localize_numbers(driver, limits) if kind == "localize" else (
        undrift_numbers(driver))
