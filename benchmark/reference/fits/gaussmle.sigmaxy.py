"""The reference fit of ``fitting_method="gaussmle"``,
``mle_method="sigmaxy"``: the Newton MLE of :mod:`reference.mle`, and
the locs table that Picasso writes for it."""

from __future__ import annotations

import numpy as np

from reference import mle as ref_mle

#: the fields and types of Picasso's locs table of MLE fits (2D)
LOCS_DTYPE = np.dtype([
    ("frame", np.uint32), ("x", np.float32), ("y", np.float32),
    ("photons", np.float32), ("sx", np.float32), ("sy", np.float32),
    ("bg", np.float32), ("lpx", np.float32), ("lpy", np.float32),
    ("ellipticity", np.float32), ("net_gradient", np.float32),
    ("log_likelihood", np.float32), ("iterations", np.uint32),
    ("photons_unc", np.float32), ("bg_unc", np.float32),
    ("sx_unc", np.float32), ("sy_unc", np.float32),
])


def fit(spots, fit: dict) -> dict:
    """The locs fields of (N, S, S) photon spots in their dtype, as
    float64 numpy columns; x and y in the box's pixels."""
    theta, crlb, ll, iters = (t.double().cpu().numpy() for t in
                              ref_mle.fit(spots, fit["eps"], fit["max_it"]))
    with np.errstate(invalid="ignore"):
        unc = np.sqrt(crlb)
    return {"x": theta[:, 0], "y": theta[:, 1], "photons": theta[:, 2],
            "bg": theta[:, 3], "sx": theta[:, 4], "sy": theta[:, 5],
            "lpx": unc[:, 0], "lpy": unc[:, 1], "photons_unc": unc[:, 2],
            "bg_unc": unc[:, 3], "sx_unc": unc[:, 4], "sy_unc": unc[:, 5],
            "log_likelihood": ll, "iterations": iters}
