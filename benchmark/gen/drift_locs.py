"""Localizations of a drifting DNA-PAINT acquisition, made on the device
from a seed, in the layout that ``localize`` writes for MLE fits: binding
sites that blink on with a fixed probability each frame, each event a
loc at its site plus the stage drift of its frame plus Gaussian
localization noise of its own precision. The drift is smooth and known:
a slope and a slow sine on each axis, with amplitudes from the traffic
and phases from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.locs import LOCS_DTYPE


def drift_of(frames: np.ndarray, n_frames: int, params: dict,
             phases: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(dx, dy) px at ``frames``: slope * t + wobble * sin(2 pi cycles t
    + phase), t = frame / n_frames."""
    t = np.asarray(frames, np.float64) / n_frames
    w = 2.0 * np.pi * float(params["drift_cycles"]) * t
    dx = params["drift_slope"][0] * t + params["drift_wobble"][0] * np.sin(
        w + phases[0])
    dy = params["drift_slope"][1] * t + params["drift_wobble"][1] * np.sin(
        w + phases[1])
    return dx, dy


def one_set(gen, layout, config: dict, params: dict, movie: dict,
            n_sites: int, device):
    """(locs, info, truth): one acquisition's locs, its info chain and
    the true drift (n_frames, 2) of every frame; the sites and the
    drift's phases drawn from ``layout``, the rest from ``gen``."""
    n_frames, height, width = movie["frames"], movie["height"], movie["width"]
    f64 = dict(device=device, dtype=torch.float64)
    margin = float(params["margin"])
    u = torch.rand((n_sites, 2), generator=layout, **f64)
    sites = margin + u * torch.tensor([height - 2 * margin,
                                       width - 2 * margin], **f64)
    phases = (2 * np.pi * torch.rand(2, generator=layout, **f64)).cpu(
    ).numpy()
    on = torch.rand((n_frames, n_sites), generator=gen,
                    device=device) < params["p_on"]
    frame, site = torch.nonzero(on, as_tuple=True)
    n = len(frame)
    all_frames = np.arange(n_frames)
    dx, dy = drift_of(all_frames, n_frames, params, phases)
    drift = torch.from_numpy(np.stack([dx, dy], 1)).to(device)
    lp_lo, lp_hi = params["precision_px"]
    lpx = lp_lo + (lp_hi - lp_lo) * torch.rand(n, generator=gen, **f64)
    lpy = lp_lo + (lp_hi - lp_lo) * torch.rand(n, generator=gen, **f64)
    noise = torch.randn((n, 2), generator=gen, **f64)
    x = sites[site, 1] + drift[frame, 0] + lpx * noise[:, 0]
    y = sites[site, 0] + drift[frame, 1] + lpy * noise[:, 1]
    photons = float(params["photons"]) * (
        0.5 + torch.rand(n, generator=gen, **f64))
    s = float(config["spot"]["sigma"])
    sx = s * (1 + 0.05 * torch.randn(n, generator=gen, **f64))
    sy = s * (1 + 0.05 * torch.randn(n, generator=gen, **f64))
    bg = float(config["spot"]["background"]) * (
        1 + 0.1 * torch.randn(n, generator=gen, **f64))
    cols = {
        "frame": frame, "x": x, "y": y, "photons": photons, "sx": sx,
        "sy": sy, "bg": bg, "lpx": lpx, "lpy": lpy,
        "ellipticity": (sx - sy).abs() / torch.maximum(sx, sy),
        "net_gradient": 6.0 * photons,
        "log_likelihood": -2.0 * float(config["fit"]["box"]) ** 2
        * torch.ones_like(x),
        "iterations": torch.full_like(frame, 5),
        "photons_unc": photons.sqrt(), "bg_unc": bg.sqrt() / 7,
        "sx_unc": 0.01 * sx, "sy_unc": 0.01 * sy,
    }
    locs = np.empty(n, LOCS_DTYPE)
    for name in LOCS_DTYPE.names:
        locs[name] = cols[name].cpu().numpy().astype(LOCS_DTYPE[name])
    info = [{"Frames": n_frames, "Height": height, "Width": width,
             "Data Type": "uint16", "Byte Order": "<"},
            {"Box Size": config["fit"]["box"],
             "Min. Net Gradient": config["fit"]["min_net_gradient"],
             "Pixelsize": config["camera"]["Pixelsize"],
             "Fit method": config["fit"]["fitting_method"]}]
    return locs, info, np.stack([dx, dy], 1)


def generate(config: dict, params: dict, seed: int, device,
             sizes: dict | None = None) -> dict:
    """``params["sets"]`` acquisitions: set m's sites and drift from
    ``params["layout_seed"] + m``, the same for every seed, its blinking
    and noise from one generator seeded with ``seed``. ``sizes`` overrides the configuration's ``movie`` sizes and
    the traffic's ``n_sites``. Returns {"sets": [(locs, info), ...],
    "truth": [drift, ...]}."""
    movie = dict(config["movie"], **(sizes or {}))
    n_sites = int((sizes or {}).get("n_sites", params["n_sites"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sets, truth = [], []
    for m in range(int(params["sets"])):
        layout = torch.Generator(device=device)
        layout.manual_seed(int(params["layout_seed"]) + m)
        locs, info, drift = one_set(gen, layout, config, params, movie,
                                    n_sites, device)
        sets.append((locs, info))
        truth.append(drift)
    return {"sets": sets, "truth": truth}
