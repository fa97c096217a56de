"""Synthetic inputs of the port's tests and of chip_smoke.py, made from a
seed with numpy only: DNA-PAINT-like spots and movies (2D and
astigmatic 3D), spots laid out as a frame chunk for the fused cut+fit,
fiducial markers for drift correction, and a TIFF writer.

Copies of bench.make_spots and bench.make_bench_movie (the JAX package's
benchmark, whose other functions reach JAX), so that the port's smoke
run imports nothing of the JAX side. tests/test_torch_package.py holds
them equal to bench's for the same seeds. Importable without jax, h5py
or yaml: the machine with the card has none of them.
"""

from __future__ import annotations

import struct

import numpy as np

#: a measured astigmatic 3D calibration (the suite's conftest CALIB_3D,
#: from the reference's test data): sx, sy in px as polynomials of z in
#: nm of the calibration stage; the z fit reports z times the
#: magnification factor
CALIB_3D = {
    "X Coefficients": [
        -1.6680708772714857e-18, 2.4038209829154137e-15,
        2.1771067332017187e-12, -3.0324788231238476e-09,
        3.5433326085494675e-06, 0.0023039289366630425, 1.2026032603707493,
    ],
    "Y Coefficients": [
        -1.7708672355491796e-18, 9.808249540501714e-16,
        2.10653248543535e-12, 2.228026137415219e-11, 3.628007433361433e-06,
        -0.001646865504353452, 1.2257249554338714,
    ],
    "Step size in nm": 5.0,
    "Number of frames": 201,
    "Magnification factor": 0.79,
}


def make_spots(n: int, box: int = 7, seed: int = 0) -> np.ndarray:
    """(n, box, box) f32 Poisson samples of elliptic Gaussian spots:
    centre within +-0.5 px of the box centre, widths 0.9-1.4 px, 2000-8000
    photons over a background of 5-30 photons/pixel. The box centre is
    pixel box // 2, as the fits take it, so an even box is box pixels
    wide too (its centre sits half a pixel past the middle); an odd
    box's draws are those of bench.make_spots."""
    rng = np.random.default_rng(seed)
    half = box // 2
    grid = np.arange(box, dtype=np.float64) - half
    x0 = rng.uniform(-0.5, 0.5, n)
    y0 = rng.uniform(-0.5, 0.5, n)
    sx = rng.uniform(0.9, 1.4, n)
    sy = rng.uniform(0.9, 1.4, n)
    photons = rng.uniform(2000.0, 8000.0, n)
    bg = rng.uniform(5.0, 30.0, n)
    gx = np.exp(
        -0.5 * ((grid[None, :] - x0[:, None]) / sx[:, None]) ** 2
    ) / (sx[:, None] * np.sqrt(2 * np.pi))
    gy = np.exp(
        -0.5 * ((grid[None, :] - y0[:, None]) / sy[:, None]) ** 2
    ) / (sy[:, None] * np.sqrt(2 * np.pi))
    clean = (
        photons[:, None, None] * gy[:, :, None] * gx[:, None, :]
        + bg[:, None, None]
    )
    return rng.poisson(clean).astype(np.float32)


def make_bench_movie(n_frames, size, n_sites, p_on, rng, return_sites=False):
    """(n_frames, size, size) u16 DNA-PAINT movie: Poisson(30) camera
    background, ``n_sites`` binding sites each on with probability
    ``p_on`` per frame, ~900-photon 7x7 spots of width 1.1 px. With
    ``return_sites`` also the sites (n_sites, 2) int (row, column) of the
    spot centres, from the same draws."""
    movie = rng.poisson(
        30, (n_frames, size, size)
    ).astype(np.uint16)
    yy, xx = np.mgrid[-3:4, -3:4]
    psf = np.exp(-(yy**2 + xx**2) / (2 * 1.1**2))
    sites = rng.uniform(8, size - 8, (n_sites, 2)).astype(int)
    # a frame's spots in one draw: the generator fills the (k, 7, 7)
    # array in the order of k draws of 7x7, so the numbers are bench's;
    # np.add.at adds overlapping spots as bench's += does (mod 2^16)
    for fidx in range(n_frames):
        on = sites[rng.random(n_sites) < p_on]
        spots = rng.poisson(psf * 900, (len(on), 7, 7)).astype(np.uint16)
        np.add.at(movie[fidx], (on[:, :1, None] + yy, on[:, 1:, None] + xx),
                  spots)
    return (movie, sites) if return_sites else movie


def make_wide_movie(n_frames, size, n_sites, p_on, rng, width: float = 2.5,
                    peak: float = 300.0, min_dist: float = 17.0,
                    return_sites=False):
    """(n_frames, size, size) u16 movie of wide spots, the input of the
    large-box localize runs: Poisson(30) camera background, ``n_sites``
    binding sites at sub-pixel positions drawn uniformly at least
    ``min_dist`` px apart and 10 px inside the field (drawn one by one,
    a draw too close to an earlier site drawn again), each on with
    probability ``p_on`` per frame, its spot a Gaussian of ``width`` px
    and ``peak`` photons (~11,800 in all) over a 17 x 17 footprint,
    Poisson-sampled. With ``return_sites`` also the sites (n_sites, 2)
    float (row, column) of the spot centres."""
    sites = []
    for _ in range(1000 * n_sites):
        c = rng.uniform(10.0, size - 11.0, 2)
        if all(np.hypot(*(c - o)) >= min_dist for o in sites):
            sites.append(c)
            if len(sites) == n_sites:
                break
    if len(sites) < n_sites:
        raise ValueError(f"only {len(sites)} of {n_sites} sites fit")
    sites = np.array(sites)
    movie = rng.poisson(30, (n_frames, size, size)).astype(np.uint16)
    base = np.floor(sites).astype(int)  # the footprint's centre pixel
    off = np.arange(-8, 9)
    dy = off[None, :] + base[:, :1] - sites[:, :1]  # (n, 17)
    dx = off[None, :] + base[:, 1:] - sites[:, 1:]
    psf = peak * np.exp(-(dy[:, :, None] ** 2 + dx[:, None, :] ** 2)
                        / (2 * width**2))
    for fidx in range(n_frames):
        on = rng.random(n_sites) < p_on
        spots = rng.poisson(psf[on]).astype(np.uint16)
        b = base[on]
        np.add.at(movie[fidx], (b[:, :1, None] + off[:, None],
                                b[:, 1:, None] + off), spots)
    return (movie, sites) if return_sites else movie


#: the fields of :func:`make_event_locs`' locs, as localize writes them
EVENT_DTYPE = np.dtype([
    ("frame", np.uint32), ("x", np.float32), ("y", np.float32),
    ("photons", np.float32), ("sx", np.float32), ("sy", np.float32),
    ("bg", np.float32), ("lpx", np.float32), ("lpy", np.float32),
    ("net_gradient", np.float32), ("likelihood", np.float32),
    ("iterations", np.int32), ("group", np.int32),
])


def make_event_locs(seed: int = 0, n_sites: int = 24, frames: int = 300,
                    size: int = 32):
    """Linked-to-be DNA-PAINT locs and their info: ``n_sites`` sites, each
    bound in events of 1-8 frames, with one-frame gaps inside an event
    and dark times of 1-30 frames between events (within and beyond a
    tolerance of 1), a second loc in some frames, precisions 0.03-0.1
    px; sites 0 and 1 lie 0.36 px apart in one group, sites 2 and 3 0.41
    px apart in two groups; site 0 binds at frame 0 and the last site
    until frame ``frames`` (one past the movie, as an event that ends at
    Frames). Sorted by frame, rows within a frame in site order."""
    rng = np.random.default_rng(seed)
    sites = rng.uniform(2, size - 2, (n_sites, 2))
    sites[1] = sites[0] + (0.3, 0.2)
    sites[3] = sites[2] + (-0.4, 0.1)
    group = np.arange(n_sites) // 2
    group[3] = n_sites
    rows = []
    for s in range(n_sites):
        f = 0 if s == 0 else int(rng.integers(0, 6))
        while f < frames:
            length = int(rng.integers(1, 9))
            for k in range(length):
                if f + k >= frames or (0 < k < length - 1
                                       and rng.random() < 0.2):
                    continue
                rows += [(f + k, s)] * (2 if rng.random() < 0.05 else 1)
            f += length + int(rng.choice([1, 1, 2, 3, 5, 12, 30]))
    last = n_sites - 1
    rows += [(frames - 2, last), (frames - 1, last), (frames, last)]
    rows = np.array(sorted(rows, key=lambda r: r[0]))
    n = len(rows)
    locs = np.zeros(n, EVENT_DTYPE)
    site = rows[:, 1]
    lp = rng.uniform(0.03, 0.1, (n, 2))
    locs["frame"] = rows[:, 0]
    locs["x"] = sites[site, 0] + rng.normal(0, 1, n) * lp[:, 0]
    locs["y"] = sites[site, 1] + rng.normal(0, 1, n) * lp[:, 1]
    locs["lpx"], locs["lpy"] = lp[:, 0], lp[:, 1]
    locs["photons"] = rng.uniform(500, 5000, n)
    locs["bg"] = rng.uniform(10, 50, n)
    locs["sx"] = rng.uniform(0.9, 1.3, n)
    locs["sy"] = rng.uniform(0.9, 1.3, n)
    locs["net_gradient"] = rng.uniform(4000, 20000, n)
    locs["likelihood"] = rng.uniform(-300, -100, n)
    locs["iterations"] = rng.integers(3, 40, n)
    locs["group"] = group[site]
    info = [{"Frames": frames, "Width": size, "Height": size,
             "Pixelsize": 130}]
    return locs, info


#: DNA-PAINT origami (make_origami_locs): sites on a 3 x 4 grid at 20 nm
#: (in px at 130 nm/px), one corner left out, so that the 11 sites have no
#: rotational symmetry; binding events a site, their lengths (frames) and
#: the acquisition
ORIGAMI_PITCH = 20.0 / 130.0
ORIGAMI_EVENTS = (6, 10)
ORIGAMI_EVENT_FRAMES = (3, 8)
ORIGAMI_FRAMES = 20000
ORIGAMI_SPACING = 4.0  # px between the origami's lattice points
ORIGAMI_LP = (0.02, 0.04)  # px, the locs' precisions


def origami_template() -> np.ndarray:
    """The 11 sites (x, y) px of one origami about their centroid: rows
    of 4 at y = 0, 1, 2 pitches, the corner (3, 2) left out."""
    xy = np.array([(c, r) for r in range(3) for c in range(4)
                   if (c, r) != (3, 2)], np.float64) * ORIGAMI_PITCH
    return xy - xy.mean(0)


def origami_rows_template(rows: int = 2) -> np.ndarray:
    """The first ``rows`` rows of origami_template()'s lattice, all 4
    sites a row (8 sites for 2 rows), about their centroid: a second
    origami design for nanotron's classes."""
    xy = np.array([(c, r) for r in range(rows) for c in range(4)],
                  np.float64) * ORIGAMI_PITCH
    return xy - xy.mean(0)


def make_origami_locs(n_origami: int, seed: int = 0,
                      template: np.ndarray | None = None):
    """DNA-PAINT origami locs, their info and the truth.

    Each origami is ``template`` (by default origami_template(); the
    default leaves every draw as it was) at a random rotation, centred on a
    square lattice of ORIGAMI_SPACING px jittered by up to 0.5 px, so
    neighbours lie at least 3 px apart. Each site binds in 6-10 events of
    3-8 frames at uniform times over ORIGAMI_FRAMES frames, one loc a
    frame; a loc's lpx, lpy are uniform in ORIGAMI_LP and it scatters by
    N(0, lpx), N(0, lpy); photons, widths, background and the other fields
    as localize writes them (EVENT_DTYPE without ``group``). Sorted by
    frame. Returns (locs, info, truth): truth holds ``sites`` (n, sites,
    2) px, ``angles`` (n,) rad, ``centers`` (n, 2) px and ``site`` (each
    loc's index into the sites of all origami)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_origami)))
    lattice = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                       -1).reshape(-1, 2)[:n_origami]
    centers = ((lattice + 1) * ORIGAMI_SPACING
               + rng.uniform(-0.5, 0.5, (n_origami, 2)))
    angles = rng.uniform(0, 2 * np.pi, n_origami)
    c, s = np.cos(angles), np.sin(angles)
    t = origami_template() if template is None else np.asarray(template)
    sites = np.stack([c[:, None] * t[:, 0] - s[:, None] * t[:, 1],
                      s[:, None] * t[:, 0] + c[:, None] * t[:, 1]], -1)
    sites += centers[:, None, :]
    n_sites = n_origami * len(t)
    n_ev = rng.integers(ORIGAMI_EVENTS[0], ORIGAMI_EVENTS[1] + 1, n_sites)
    ev_site = np.repeat(np.arange(n_sites), n_ev)
    length = rng.integers(ORIGAMI_EVENT_FRAMES[0],
                          ORIGAMI_EVENT_FRAMES[1] + 1, len(ev_site))
    start = rng.integers(0, ORIGAMI_FRAMES - length + 1)
    site = np.repeat(ev_site, length)
    first = np.repeat(np.cumsum(length) - length, length)
    frame = np.repeat(start, length) + np.arange(len(site)) - first
    order = np.argsort(frame, kind="stable")
    site, frame = site[order], frame[order]
    n = len(site)
    names = [nm for nm in EVENT_DTYPE.names if nm != "group"]
    locs = np.zeros(n, [(nm, EVENT_DTYPE[nm]) for nm in names])
    lp = rng.uniform(*ORIGAMI_LP, (n, 2))
    xy = sites.reshape(-1, 2)[site]
    locs["frame"] = frame
    locs["x"] = xy[:, 0] + rng.normal(0, 1, n) * lp[:, 0]
    locs["y"] = xy[:, 1] + rng.normal(0, 1, n) * lp[:, 1]
    locs["lpx"], locs["lpy"] = lp[:, 0], lp[:, 1]
    locs["photons"] = rng.uniform(2000, 8000, n)
    locs["bg"] = rng.uniform(10, 50, n)
    locs["sx"] = rng.uniform(0.9, 1.3, n)
    locs["sy"] = rng.uniform(0.9, 1.3, n)
    locs["net_gradient"] = rng.uniform(4000, 20000, n)
    locs["likelihood"] = rng.uniform(-300, -100, n)
    locs["iterations"] = rng.integers(3, 40, n)
    size = int((side + 1) * ORIGAMI_SPACING)
    info = [{"Frames": ORIGAMI_FRAMES, "Width": size, "Height": size,
             "Pixelsize": 130}]
    return locs, info, {"sites": sites, "angles": angles,
                        "centers": centers, "site": site}


#: 3D origami (make_origami3d_locs): the z (nm) of origami_template()'s
#: rows, each origami's z offset and each loc's z scatter in its lateral
#: precisions (the astigmatic z precision is ~3 times the lateral one)
ORIGAMI_Z_ROWS = (0.0, 40.0, 80.0)
ORIGAMI_Z_OFFSET = 20.0
ORIGAMI_Z_LP = 3.0


def make_origami3d_locs(n_origami: int, seed: int = 0):
    """make_origami_locs(n_origami, seed) grouped by origami_groups, with
    a ``z`` field (nm, f32): the lattice's rows at ORIGAMI_Z_ROWS, an
    offset of N(0, ORIGAMI_Z_OFFSET) for each origami and a scatter of
    N(0, ORIGAMI_Z_LP lpx x 130) for each loc, drawn from a stream of
    their own (seed + 1). Returns (locs, info, truth), truth with
    ``z_offsets`` (n,) nm."""
    locs, info, truth = make_origami_locs(n_origami, seed)
    grouped = origami_groups(locs, truth)
    rng = np.random.default_rng(seed + 1)
    offsets = rng.normal(0, ORIGAMI_Z_OFFSET, n_origami)
    row = np.rint(origami_template()[:, 1] / ORIGAMI_PITCH + 1).astype(int)
    per = len(row)
    z = (np.asarray(ORIGAMI_Z_ROWS)[row[truth["site"] % per]]
         + offsets[truth["site"] // per]
         + rng.normal(0, 1, len(locs)) * ORIGAMI_Z_LP * locs["lpx"] * 130)
    out = np.empty(len(locs), grouped.dtype.descr + [("z", "<f4")])
    for n in grouped.dtype.names:
        out[n] = grouped[n]
    out["z"] = z
    return out, info, dict(truth, z_offsets=offsets)


def origami_groups(locs: np.ndarray, truth: dict) -> np.ndarray:
    """make_origami_locs' locs with a ``group`` field (int32): the index of
    the origami whose centre is nearest each loc."""
    from scipy.spatial import cKDTree

    near = cKDTree(truth["centers"]).query(np.column_stack(
        [locs["x"], locs["y"]]))[1]
    out = np.empty(len(locs), locs.dtype.descr + [("group", "<i4")])
    for n in locs.dtype.names:
        out[n] = locs[n]
    out["group"] = near
    return out


def rigid_rotations(before: np.ndarray, after: np.ndarray,
                    rows: list) -> np.ndarray:
    """Each group's rotation (rad) from the (x, y) of ``before`` to those
    of ``after`` (the same rows), by a least-squares rigid fit of its
    rows ``rows[g]`` about their means."""
    out = np.empty(len(rows))
    for g, r in enumerate(rows):
        p = np.column_stack([before["x"][r], before["y"][r]]).astype(
            np.float64)
        q = np.column_stack([after["x"][r], after["y"][r]]).astype(
            np.float64)
        p -= p.mean(0)
        q -= q.mean(0)
        out[g] = np.arctan2(np.sum(p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0]),
                            np.sum(p[:, 0] * q[:, 0] + p[:, 1] * q[:, 1]))
    return out


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def rotation_share(recovered: np.ndarray, true: np.ndarray,
                   tol: float) -> tuple[float, float, float]:
    """(the share of groups whose recovered rotation, relative to the
    consensus, lies within ``tol`` rad of the true relative rotation; the
    share within ``tol`` of it or of it turned by pi; the consensus).
    Averaging turns origami g, made at ``true[g]``, by -true[g] + c for
    one c, so c is the circular median of recovered + true (the angle
    with the least summed circular distance to them). An origami turned
    by pi matches 10 of its 11 sites, so alignment may take that pose."""
    d = _wrap(recovered + true)
    cost = np.abs(_wrap(d[:, None] - d[None, :])).sum(0)
    c = d[int(np.argmin(cost))]
    off = np.abs(_wrap(d - c))
    return (float(np.mean(off <= tol)),
            float(np.mean(np.minimum(off, np.pi - off) <= tol)), float(c))


def spots_chunk(spots: np.ndarray, dtype, cells: int = 36):
    """The (n, S, S) spots laid out as S x S cells, ``cells`` x ``cells``
    a frame: a (B, cells * S, cells * S) chunk of ``dtype`` (zeros where
    no spot is) and the hit list (f, y, x) int64 of the cell centres, so
    that each hit's window is its spot."""
    n, s, _ = spots.shape
    per = cells * cells
    grid = np.zeros((-(-n // per) * per, s, s), np.float32)
    grid[:n] = spots
    frames = (grid.reshape(-1, cells, cells, s, s).transpose(0, 1, 3, 2, 4)
              .reshape(-1, cells * s, cells * s))
    i = np.arange(n)
    hits = (i // per, (i % per) // cells * s + s // 2, i % cells * s + s // 2)
    return np.ascontiguousarray(frames.astype(dtype)), hits


# frame shapes (B, Y, X) that hold K4 (csrc/identify.cu) to its plain
# version at its edges: Y and X off multiples of the tile, of the strip
# rows and of the block width; odd X; frames smaller than the halo, down
# to one row; B = 1 and 300
K4_SHAPES = [(1, 97, 131), (300, 20, 23), (2, 1, 40), (2, 6, 40), (2, 9, 9),
             (2, 40, 7), (3, 8, 300), (2, 10, 13), (1, 257, 255),
             (4, 130, 67)]


def small_frames(shape, rng, spots: int = 2, nan: float = 0.0) -> np.ndarray:
    """(B, Y, X) f32 frames of any size, down to one row: Poisson(30)
    background, ``spots`` ~900-photon spots of width 1.1 px a frame at
    uniform centres (cut at the frame's edges), and a share ``nan`` of
    the pixels set to NaN. Integer-valued apart from the NaNs."""
    B, Y, X = shape
    frames = rng.poisson(30, shape).astype(np.float32)
    yy, xx = np.mgrid[-3:4, -3:4]
    psf = np.exp(-(yy**2 + xx**2) / (2 * 1.1**2))
    for f in range(B):
        for cy, cx in zip(rng.integers(0, Y, spots), rng.integers(0, X, spots)):
            spot = rng.poisson(psf * 900).astype(np.float32)
            y0, x0 = max(cy - 3, 0), max(cx - 3, 0)
            y1, x1 = min(cy + 4, Y), min(cx + 4, X)
            frames[f, y0:y1, x0:x1] += spot[y0 - cy + 3:y1 - cy + 3,
                                            x0 - cx + 3:x1 - cx + 3]
    if nan:
        frames[rng.random(shape) < nan] = np.nan
    return frames


def tiled_chunk(chunk, frames: int = 32, k: int = 8):
    """A (frames, k*Y, k*X) torch chunk whose (i, j) tile of frame f is
    frame (f*k*k + i*k + j) mod B of the (B, Y, X) torch ``chunk``, on
    its device and in its dtype."""
    import torch

    B, Y, X = chunk.shape
    idx = torch.arange(frames * k * k, device=chunk.device) % B
    # torch.uint16 has few kernels: gather through a 16-bit integer view
    src = chunk.view(torch.int16) if chunk.dtype == torch.uint16 else chunk
    out = (src[idx].view(frames, k, k, Y, X).permute(0, 1, 3, 2, 4)
           .reshape(frames, k * Y, k * X).contiguous())
    return out.view(chunk.dtype)


def make_astig_movie(n_frames, size, n_sites, p_on, rng, z_max=400.0,
                     calibration=CALIB_3D):
    """The recipe of :func:`make_bench_movie` with astigmatic spots:
    each site draws z uniform in +-``z_max`` nm, and its spot has the
    widths sx, sy = the calibration's polynomials at z (11x11 px, peak
    900 photons). Returns (movie (n_frames, size, size) u16, sites (n, 2)
    [y, x] px, z (n,) as the z fit reports it, z times the magnification
    factor)."""
    movie = rng.poisson(30, (n_frames, size, size)).astype(np.uint16)
    yy, xx = np.mgrid[-5:6, -5:6]
    sites = rng.uniform(8, size - 8, (n_sites, 2)).astype(int)
    z = rng.uniform(-z_max, z_max, n_sites)
    sx = np.polyval(calibration["X Coefficients"], z)
    sy = np.polyval(calibration["Y Coefficients"], z)
    psf = 900 * np.exp(-(xx[None] ** 2 / (2 * sx[:, None, None] ** 2)
                         + yy[None] ** 2 / (2 * sy[:, None, None] ** 2)))
    for fidx in range(n_frames):
        on = rng.random(n_sites) < p_on
        spots = rng.poisson(psf[on]).astype(np.uint16)
        s = sites[on]
        np.add.at(movie[fidx], (s[:, :1, None] + yy, s[:, 1:, None] + xx),
                  spots)
    return movie, sites, z * calibration["Magnification factor"]


def free_positions(x, y, size: int, n: int, min_dist: float,
                   margin: float = 8.0) -> np.ndarray:
    """``n`` positions (x, y) of a grid over the field, each at least
    ``min_dist`` px from every point (x, y) and from the others, at
    least ``margin`` px inside the field; the ones farthest from the
    points first. Raises ValueError if fewer are free."""
    from scipy.spatial import cKDTree

    g = np.arange(margin + 0.3, size - margin, 2.0)
    cand = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    dist, _ = cKDTree(np.stack([x, y], 1)).query(cand)
    cand, dist = cand[dist >= min_dist], dist[dist >= min_dist]
    chosen = []
    for c in cand[np.argsort(-dist, kind="stable")]:
        if all(np.hypot(*(c - o)) >= min_dist for o in chosen):
            chosen.append(c)
            if len(chosen) == n:
                return np.array(chosen)
    raise ValueError(f"only {len(chosen)} of {n} free positions")


FIDUCIAL_DTYPE = np.dtype([(n, np.uint32 if n == "frame" else np.float32)
                           for n in ("frame", "x", "y", "photons", "sx",
                                     "sy", "bg", "lpx", "lpy")])


def fiducial_tracks(centres, n_frames: int, rng, lp: float = 0.01,
                    dtype=FIDUCIAL_DTYPE) -> np.ndarray:
    """Fiducial markers: one loc a frame at each (x, y) centre with
    Gaussian noise of ``lp`` px, lpx = lpy = ``lp``, 20,000 photons,
    sx = sy = 1, bg 30 and 0 in any other field of ``dtype``, sorted by
    frame."""
    centres = np.asarray(centres, np.float64)
    frame = np.tile(np.arange(n_frames), len(centres))
    k = np.repeat(np.arange(len(centres)), n_frames)
    order = np.argsort(frame, kind="stable")
    frame, k = frame[order], k[order]
    locs = np.zeros(len(frame), dtype)
    values = {"frame": frame, "photons": 20000.0, "sx": 1.0, "sy": 1.0,
              "bg": 30.0, "lpx": lp, "lpy": lp,
              "x": centres[k, 0] + rng.normal(0, lp, len(k)),
              "y": centres[k, 1] + rng.normal(0, lp, len(k))}
    for n, v in values.items():
        if n in locs.dtype.names:
            locs[n] = v
    return locs


_TIFF_FORMAT = {"u": 1, "i": 2, "f": 3}


def write_tiff(path, frames: np.ndarray, *, bigtiff: bool = False,
               byteorder: str = "<", rows_per_strip: int | None = None,
               description: str | None = None) -> None:
    """Write (n, Y, X) ``frames`` as an uncompressed grayscale TIFF with
    ``struct``: classic or BigTIFF, little (``"<"``) or big-endian
    (``">"``), one IFD a frame, each frame in strips of
    ``rows_per_strip`` rows (default: one strip). All pixel data comes
    first, back to back, then the IFDs."""
    frames = np.ascontiguousarray(frames)
    n, h, w = frames.shape
    dt = frames.dtype.newbyteorder(byteorder)
    rows = rows_per_strip or h
    strip_rows = [min(rows, h - r) for r in range(0, h, rows)]
    row_bytes = w * dt.itemsize
    frame_bytes = h * row_bytes
    bo = byteorder
    off_fmt, off_type = ("Q", 16) if bigtiff else ("I", 4)
    osize = 8 if bigtiff else 4
    header = 16 if bigtiff else 8
    with open(path, "wb") as f:
        f.write(b"II" if bo == "<" else b"MM")
        if bigtiff:
            f.write(struct.pack(bo + "HHHQ", 43, 8, 0, 0))
        else:
            f.write(struct.pack(bo + "HI", 42, 0))
        frames.astype(dt, copy=False).tofile(f)
        ifd_pos = header + n * frame_bytes
        f.seek(4 if not bigtiff else 8)
        f.write(struct.pack(bo + off_fmt, ifd_pos))
        f.seek(ifd_pos)
        for i in range(n):
            base = header + i * frame_bytes
            offsets = [base + sum(strip_rows[:k]) * row_bytes
                       for k in range(len(strip_rows))]
            counts = [r * row_bytes for r in strip_rows]
            entries = [
                (256, 4, [w]), (257, 4, [h]), (258, 3, [dt.itemsize * 8]),
                (259, 3, [1]), (262, 3, [1]), (273, off_type, offsets),
                (277, 3, [1]), (278, 4, [rows]), (279, off_type, counts),
                (339, 3, [_TIFF_FORMAT[dt.kind]]),
            ]
            if description is not None and i == 0:
                entries.insert(4, (270, 2, description.encode() + b"\0"))
            n_fmt = "Q" if bigtiff else "H"
            entry_size = 4 + 2 * osize
            ifd_size = struct.calcsize(bo + n_fmt) + len(entries) * entry_size \
                + osize
            extra_pos = f.tell() + ifd_size
            body, extra = b"", b""
            for tag, typ, vals in entries:
                if typ == 2:
                    data = bytes(vals)
                else:
                    fmt = {3: "H", 4: "I", 16: "Q"}[typ]
                    data = struct.pack(bo + fmt * len(vals), *vals)
                count = len(vals)
                body += struct.pack(bo + "HH" + off_fmt, tag, typ, count)
                if len(data) <= osize:
                    body += data + b"\0" * (osize - len(data))
                else:
                    body += struct.pack(bo + off_fmt,
                                        extra_pos + len(extra))
                    extra += data + b"\0" * (len(data) % 2)
            next_ifd = 0 if i == n - 1 else extra_pos + len(extra)
            f.write(struct.pack(bo + n_fmt, len(entries)) + body
                    + struct.pack(bo + off_fmt, next_ifd) + extra)


# SPINNA: target "A" in a monomer, a dimer at 20 nm and an equilateral
# trimer with 20 nm sides; the cell-scale field holds 1500 / 1000 / 500 of
# them (5000 A: 30 / 40 / 30 % by target, 50 A per um^2) in a 10 x 10 um
# CSR ROI, labelled at LE 0.8 with 5 nm label uncertainty
SPINNA_CELL = {"counts": (1500, 1000, 500), "side": 10000.0, "le": 0.8,
               "unc": 5.0, "seed": 19}


def spinna_structures(spinna, d: float = 20.0) -> list:
    """The monomer, dimer and trimer of target "A" (``spinna`` is the
    port's module or JAX's)."""
    h = d * np.sqrt(3) / 2
    shapes = {"monomer": ([0.0], [0.0]),
              "dimer": ([-d / 2, d / 2], [0.0, 0.0]),
              "trimer": ([-d / 2, d / 2, 0.0], [-h / 3, -h / 3, 2 * h / 3])}
    out = []
    for name, (x, y) in shapes.items():
        s = spinna.Structure(name)
        s.define_coordinates("A", x, y, [0.0] * len(x))
        out.append(s)
    return out


def spinna_cell(spinna, scale: float = 1.0, **kw):
    """(mixer, ground truth) of the cell-scale field, its area (and so the
    counts) scaled by ``scale``, drawn under np.random.seed; ``kw``
    (depth, random_rot_mode) go to the mixer."""
    c = SPINNA_CELL
    side = c["side"] * np.sqrt(scale)
    mixer = spinna.StructureMixer(spinna_structures(spinna),
                                  label_unc={"A": c["unc"]},
                                  le={"A": c["le"]}, width=side, height=side,
                                  **kw)
    np.random.seed(c["seed"])
    counts = [int(round(n * scale)) for n in c["counts"]]
    return mixer, mixer.run_simulation(counts)


#: tests/test_average3.py's L-shaped 3D template (px, px, nm), which
#: breaks every rotational symmetry
AVERAGE3_TEMPLATE = np.array([[0.0, 0.0, 0.0], [0.8, 0.0, 0.0],
                              [1.6, 0.0, 0.0], [0.0, 0.7, 0.0],
                              [0.0, 0.0, 120.0]])
AVERAGE3_DTYPE = np.dtype([
    ("frame", np.uint32), ("x", np.float32), ("y", np.float32),
    ("z", np.float32), ("photons", np.float32), ("sx", np.float32),
    ("sy", np.float32), ("bg", np.float32), ("lpx", np.float32),
    ("lpy", np.float32), ("group", np.int32)])


def make_average3_locs(n_groups: int = 14, locs_per_site: int = 12,
                       noise: float = 0.03, seed: int = 2) -> np.ndarray:
    """tests/test_average3.py's dataset without pandas, the same draws in
    the same order: each group the template turned about z by a uniform
    angle and moved by N(0, 0.15) px and N(0, 20) nm, each site's locs
    scattered by ``noise`` px (z: ``noise`` x 130 nm)."""
    rng = np.random.default_rng(seed)
    rows = []
    true_angles = rng.uniform(0, 2 * np.pi, n_groups)
    for g in range(n_groups):
        c, s = np.cos(true_angles[g]), np.sin(true_angles[g])
        t = AVERAGE3_TEMPLATE
        x, y, z = c * t[:, 0] - s * t[:, 1], s * t[:, 0] + c * t[:, 1], t[:, 2]
        dx, dy = rng.normal(0, 0.15, 2)
        dz = rng.normal(0, 20.0)
        for px, py, pz in zip(x, y, z):
            for _ in range(locs_per_site):
                rows.append((g, px + dx + rng.normal(0, noise),
                             py + dy + rng.normal(0, noise),
                             pz + dz + rng.normal(0, noise * 130)))
    arr = np.array(rows)
    locs = np.zeros(len(arr), AVERAGE3_DTYPE)
    locs["frame"] = np.arange(len(arr))
    locs["x"], locs["y"], locs["z"] = arr[:, 1], arr[:, 2], arr[:, 3]
    locs["photons"], locs["sx"], locs["sy"], locs["bg"] = 1000, 1, 1, 5
    locs["lpx"] = locs["lpy"] = 0.03
    locs["group"] = arr[:, 0]
    return locs


def xy_spread(locs: np.ndarray) -> float:
    """tests/test_average3.py's group spread without pandas: the entropy
    of the locs' xy histogram in 60 x 60 bins over [-3, 3] px, which
    falls as the groups align into common sharp peaks."""
    H, *_ = np.histogram2d(locs["x"], locs["y"], bins=60,
                           range=[[-3, 3], [-3, 3]])
    p = H / H.sum()
    return float(-np.sum(p[p > 0] * np.log(p[p > 0])))
