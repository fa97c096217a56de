"""DNA-PAINT movies made on the device from a seed: a Poisson camera
background, binding sites that blink on with a fixed probability each
frame, and each bright site's spot a Poisson-sampled Gaussian on its
footprint, summed as u16 counts (mod 2^16). The configuration gives the
camera field and the spot (``movie``, ``spot``); the traffic gives the
sites and their blinking (``params``).

It generalises the two recipes of the JAX package's bench and of the
port's test data (``make_bench_movie``: integer sites 8 px inside the
field, a 7 x 7 spot of sigma 1.1 px and 900 photons at its peak;
``make_wide_movie``: sub-pixel sites at least 17 px apart and 10 px
inside, a 17 x 17 footprint of sigma 2.5 px and peak 300), drawn with
torch on the card in a few large calls. The movies come back as host u16
arrays, as a loaded movie reaches ``localize``.
"""

from __future__ import annotations

import numpy as np
import torch

#: frames generated per block on the device
BLOCK_FRAMES = 1024


def draw_sites(gen: torch.Generator, n: int, height: int, width: int,
               params: dict, device) -> np.ndarray:
    """(n, 2) site centres (row, column) in px, drawn uniformly from
    ``[margin, size - margin_high)``: truncated to whole pixels unless
    ``subpixel``, and, with ``min_distance``, accepted in draw order only
    at that distance from every earlier site (the candidates drawn in one
    call on the device)."""
    lo = float(params["margin"])
    hi = np.array([height, width], float) - float(params["margin_high"])
    min_d = float(params.get("min_distance", 0.0))
    count = n if min_d <= 0 else 1000 * n
    u = torch.rand((count, 2), generator=gen, device=device,
                   dtype=torch.float64).cpu().numpy()
    cand = lo + u * (hi - lo)
    if not params.get("subpixel", False):
        cand = np.floor(cand)
    if min_d <= 0:
        return cand
    sites: list[np.ndarray] = []
    for c in cand:
        if all(np.hypot(*(c - o)) >= min_d for o in sites):
            sites.append(c)
            if len(sites) == n:
                return np.array(sites)
    raise ValueError(f"only {len(sites)} of {n} sites fit at distance {min_d}")


def spot_rates(sites: np.ndarray, spot: dict):
    """(base (n, 2) int, rates (n, F, F)): each site's footprint centre
    pixel and the expected photons of its spot there, peak *
    exp(-d^2 / (2 sigma^2)) at each pixel's offset from the site."""
    half = int(spot["footprint"]) // 2
    base = np.floor(sites).astype(np.int64)
    off = np.arange(-half, half + 1)
    dy = off[None, :] + base[:, :1] - sites[:, :1]
    dx = off[None, :] + base[:, 1:] - sites[:, 1:]
    s2 = 2.0 * float(spot["sigma"]) ** 2
    rates = float(spot["peak"]) * np.exp(
        -(dy[:, :, None] ** 2 + dx[:, None, :] ** 2) / s2)
    return base, rates


def movie_on_device(gen, n_frames: int, height: int, width: int,
                    background: float, base: np.ndarray, rates: np.ndarray,
                    p_on: float, device) -> np.ndarray:
    """One (n_frames, height, width) host u16 movie, made block by block
    on ``device``."""
    out = np.empty((n_frames, height, width), np.uint16)
    half = rates.shape[1] // 2
    off = torch.arange(-half, half + 1, device=device)
    base_t = torch.from_numpy(base).to(device)
    rates_t = torch.from_numpy(rates).to(device, torch.float32)
    n_sites = len(base)
    for lo in range(0, n_frames, BLOCK_FRAMES):
        nb = min(BLOCK_FRAMES, n_frames - lo)
        img = torch.poisson(torch.full((nb, height, width), float(background),
                                       device=device), generator=gen)
        on = torch.rand((nb, n_sites), generator=gen, device=device) < p_on
        fi, si = torch.nonzero(on, as_tuple=True)
        counts = torch.poisson(rates_t[si], generator=gen)
        rows = base_t[si, :1] + off[None, :]  # (k, F)
        cols = base_t[si, 1:] + off[None, :]
        flat = (fi[:, None, None] * height + rows[:, :, None]) * width \
            + cols[:, None, :]
        img.view(-1).index_add_(0, flat.reshape(-1), counts.reshape(-1))
        u16 = (img.to(torch.int32) & 0xFFFF).to(torch.int16)
        out[lo:lo + nb] = u16.cpu().numpy().view(np.uint16)
    return out


def generate(config: dict, params: dict, seed: int, device,
             sizes: dict | None = None) -> dict:
    """The cell's inputs: ``params["movies"]`` movies. Movie m's sites
    are drawn from ``params["layout_seed"] + m``, the same for every
    seed, so that each seed brings the same work; its blinking and
    photons from one generator seeded with ``seed``. ``sizes`` overrides
    the configuration's ``movie`` sizes and the traffic's ``n_sites``
    (the tests' small runs). Returns {"movies": [...], "sites": [...]}."""
    movie = dict(config["movie"], **(sizes or {}))
    n_sites = int((sizes or {}).get("n_sites", params["n_sites"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    movies, all_sites = [], []
    for m in range(int(params["movies"])):
        layout = torch.Generator(device=device)
        layout.manual_seed(int(params["layout_seed"]) + m)
        sites = draw_sites(layout, n_sites, movie["height"], movie["width"],
                           params, device)
        base, rates = spot_rates(sites, config["spot"])
        movies.append(movie_on_device(
            gen, movie["frames"], movie["height"], movie["width"],
            config["spot"]["background"], base, rates, params["p_on"],
            device))
        all_sites.append(sites)
    return {"movies": movies, "sites": all_sites}


def expected_photons(spot: dict) -> float:
    """The expected photons of one spot whose site sits on a pixel
    centre: the rates summed over the footprint."""
    half = int(spot["footprint"]) // 2
    g = np.exp(-np.arange(-half, half + 1) ** 2
               / (2.0 * float(spot["sigma"]) ** 2))
    return float(spot["peak"]) * float(g.sum()) ** 2
