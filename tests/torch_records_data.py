"""Locs of many record layouts and drifts of every form, for the tests of
apply_drift and its record kernel (tests/test_torch_undrift.py on the
CPU against the JAX package, tests/test_torch_records.py on the card).
Imports no JAX."""

from __future__ import annotations

import numpy as np

#: frames of every drift made here
N_FRAMES = 97

MLE = np.dtype([
    ("frame", np.uint32), ("x", np.float32), ("y", np.float32),
    ("photons", np.float32), ("sx", np.float32), ("sy", np.float32),
    ("bg", np.float32), ("lpx", np.float32), ("lpy", np.float32),
    ("ellipticity", np.float32), ("net_gradient", np.float32),
    ("log_likelihood", np.float32), ("iterations", np.uint32),
    ("photons_unc", np.float32), ("bg_unc", np.float32),
    ("sx_unc", np.float32), ("sy_unc", np.float32),
])
DTYPES = {
    "mle": MLE,
    "lq": np.dtype([(n, MLE[n]) for n in MLE.names[:11]]),
    "3d": np.dtype([(n, MLE[n]) for n in MLE.names[:11]]
                   + [("z", np.float32), ("d_zcalib", np.float32)]),
    "mle-int64-frame": np.dtype([("frame", np.int64)]
                                + [(n, MLE[n]) for n in MLE.names[1:]]),
    # padding after frame and flag, y already f64, 2-byte frames
    "aligned": np.dtype([("frame", np.uint16), ("x", np.float32),
                         ("flag", np.uint8), ("y", np.float64),
                         ("photons", np.float32)], align=True),
    # offsets of odd bytes: the kernel's 1-byte words
    "packed-odd": np.dtype([("frame", np.int64), ("flag", np.uint8),
                            ("x", np.float32), ("y", np.float32)]),
    # even offsets: 2-byte words
    "packed-even": np.dtype([("frame", np.uint16), ("x", np.float32),
                             ("y", np.float32), ("id", np.uint16)]),
}
DRIFT_FORMS = ("rec2", "rec3", "array2", "array3")


def make_locs(dtype: np.dtype, n: int, seed: int,
              negative_frames: bool = False) -> np.ndarray:
    """``n`` locs of ``dtype``, every field random; frames in [0,
    N_FRAMES), or in [-N_FRAMES, N_FRAMES) with ``negative_frames``."""
    rng = np.random.default_rng(seed)
    locs = np.zeros(n, dtype)
    for name in dtype.names:
        ft = dtype[name]
        if name == "frame":
            lo = -N_FRAMES if negative_frames else 0
            locs[name] = rng.integers(lo, N_FRAMES, n)
        elif ft.kind == "f":
            locs[name] = rng.uniform(-5, 300, n)
        else:
            locs[name] = rng.integers(0, np.iinfo(ft).max, n, dtype=ft,
                                      endpoint=True)
    return locs


def make_drift(form: str, seed: int):
    """A drift of N_FRAMES frames as a record array (x, y or x, y, z) or
    an (n, 2) or (n, 3) array."""
    cols = np.random.default_rng(seed).normal(0, 2, (N_FRAMES, 3))
    if form == "array2":
        return cols[:, :2]
    if form == "array3":
        return cols
    names = ("x", "y", "z") if form == "rec3" else ("x", "y")
    drift = np.empty(N_FRAMES, [(c, np.float64) for c in names])
    for i, c in enumerate(names):
        drift[c] = cols[:, i]
    return drift


def same_bytes(got: np.ndarray, want: np.ndarray) -> None:
    """``got`` is ``want``: dtype, shape and every byte."""
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()
