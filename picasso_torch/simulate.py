"""DNA-PAINT movie simulator on the host: exponential on/off kinetics,
photon distribution into (astigmatic) PSFs, Poisson camera noise,
origami structure generation.

Counterpart of picasso_tpu/simulate.py (MAGFAC :19, calculate_zpsf :23,
saveInfo :32, noisy :36, noisy_p :44, check_type :49, paintgen :55,
distphotons :145, distphotonsxy :173, convertMovie :212, saveMovie :242,
defineStructure :250, generatePositions :273, rotateStructure :291,
incorporateStructure :307, randomExchange :314, prepareStructures :322,
simulate_movie :360, test_calculate_zpsf :423, fitFuncBg :437,
fitFuncStd :443, calibrate_noise_model :449, sigmafilter :478), itself
after picasso/simulate.py. All of it is host numpy, as in JAX: the draws
are the global ``np.random`` stream's, made in JAX's order, so under one
``np.random.seed`` the port's movies equal JAX's bit for bit; there is
no device argument. Closed loop: simulate_movie, then localize the movie
on the card (localize.localize).
"""

from __future__ import annotations

import numpy as np

from picasso_torch import io

MAGFAC = 0.79  # astigmatism magnification factor (simulate.py:16)
magfac = MAGFAC  # reference public name (simulate.py:15)


def calculate_zpsf(z, cx, cy):
    """Astigmatic PSF widths at z via the calibration polynomials
    (picasso/simulate.py:19)."""
    z = np.asarray(z) / MAGFAC
    wx = np.polyval(np.asarray(cx), z)
    wy = np.polyval(np.asarray(cy), z)
    return wx, wy


def saveInfo(filename: str, info: dict) -> None:
    io.save_info(filename, [info], default_flow_style=True)


def noisy(image: np.ndarray, mu: float, sigma: float) -> np.ndarray:
    """Add clipped Gaussian noise (picasso/simulate.py:91)."""
    gauss = sigma * np.random.normal(0, 1, image.shape) + mu
    out = image + gauss
    out[out < 0] = 0
    return out


def noisy_p(image: np.ndarray, mu: float) -> np.ndarray:
    """Add Poisson background noise (picasso/simulate.py:118)."""
    return image + np.random.poisson(mu, image.shape)


def check_type(movie: np.ndarray) -> np.ndarray:
    """Clip to uint16 range and convert (picasso/simulate.py:141)."""
    movie[movie >= 2**16] = 2**16 - 1
    return movie.astype("<u2")


def paintgen(
    meandark: float,
    meanbright: float,
    frames: int,
    time: float,
    photonrate: float,
    photonratestd: float,
    photonbudget: float,
):
    """Generate the on/off photon trace for one binding site
    (picasso/simulate.py:194): exponential dark/bright event trains,
    per-frame photon counts with partial first/last frames, photon
    budget cap.

    Returns (photonsinframe, timetrace, spotkinetics)."""
    meanlocs = 4 * int(np.ceil(frames * time / (meandark + meanbright)))
    if meanlocs < 10:
        meanlocs *= 10
    dark_times = np.random.exponential(meandark, meanlocs)
    bright_times = np.random.exponential(meanbright, meanlocs)
    events = np.vstack((dark_times, bright_times)).reshape(
        (-1,), order="F"
    )
    eventsum = np.cumsum(events)
    maxloc = int(np.argmax(eventsum > (frames * time)))
    simulatedmeandark = np.mean(events[:maxloc:2]) if maxloc else 0
    simulatedmeanbright = (
        np.mean(events[1:maxloc:2]) if maxloc > 1 else 0
    )
    onevents = int(maxloc // 2) if maxloc % 2 == 0 else int(
        np.floor(maxloc / 2)
    )
    photonsinframe = np.zeros(
        int(frames + np.ceil(meanbright / time * 20))
    )
    for i in range(1, maxloc, 2):
        if photonratestd == 0:
            photons = max(0.0, np.round(photonrate * time))
        else:
            photons = max(
                0.0,
                np.round(
                    np.random.normal(photonrate, photonratestd) * time
                ),
            )
        tempFrame = int(np.floor(eventsum[i - 1] / time))
        onFrames = int(np.ceil((eventsum[i] - tempFrame * time) / time))
        if photons > 0 and photons * onFrames > photonbudget:
            onFrames = int(np.ceil(photonbudget / photons))
        for j in range(onFrames):
            idx = 1 + tempFrame + j
            if idx >= len(photonsinframe):
                break
            if j == 0:
                frac = (
                    (tempFrame + 1) * time - eventsum[i - 1]
                ) / time
            elif j == onFrames - 1:
                frac = (
                    eventsum[i] - (tempFrame + onFrames - 1) * time
                ) / time
            else:
                frac = 1.0
            photonsinframe[idx] = int(
                np.random.poisson(max(frac, 0) * photons)
            )
        total = np.sum(
            photonsinframe[1 + tempFrame:tempFrame + 1 + onFrames]
        )
        if total > photonbudget:
            # clamp to the last WRITTEN frame: the write loop breaks
            # at the array end, so onFrames+tempFrame can be past it
            last = min(onFrames + tempFrame, len(photonsinframe) - 1)
            photonsinframe[last] = int(
                photonsinframe[last] - (total - photonbudget)
            )
    photonsinframe = photonsinframe[:frames]
    timetrace = events[:maxloc]
    if onevents > 0:
        spotkinetics = [
            onevents,
            int(np.sum(photonsinframe > 0)),
            simulatedmeandark,
            simulatedmeanbright,
        ]
    else:
        spotkinetics = [0, int(np.sum(photonsinframe > 0)), 0, 0]
    return photonsinframe, timetrace, spotkinetics


def distphotons(
    structures,
    itime: float,
    frames: int,
    taud: float,
    taub: float,
    photonrate: float,
    photonratestd: float,
    photonbudget: float,
):
    """Photon traces for every binding site (picasso/simulate.py:297).
    Returns (photondist (n_sites, frames), spotkinetics list,
    timetraces list)."""
    n_sites = structures.shape[1]
    photondist = np.zeros((n_sites, frames))
    spotkinetics = []
    timetraces = []
    for i in range(n_sites):
        p, t, sk = paintgen(
            taud, taub, frames, itime, photonrate, photonratestd,
            photonbudget,
        )
        photondist[i] = p
        spotkinetics.append(sk)
        timetraces.append(t)
    return photondist, spotkinetics, timetraces


def distphotonsxy(
    runner: int,
    photondist,
    structures,
    psf: float,
    mode3Dstate: bool,
    cx=None,
    cy=None,
):
    """Sample photon positions for one frame from per-site Gaussian
    PSFs (picasso/simulate.py:357). photondist is (n_sites, frames);
    runner is the frame index."""
    xs = structures[0, :]
    ys = structures[1, :]
    zs = structures[4, :] if structures.shape[0] > 4 else np.zeros_like(
        xs
    )
    counts = np.asarray(photondist[:, runner]).astype(int)
    n_photons = int(np.sum(counts))
    out = np.zeros((n_photons, 2))
    step = np.insert(np.cumsum(counts), 0, 0)
    for i in range(len(xs)):
        c = counts[i]
        if c <= 0:
            continue
        if mode3Dstate:
            wx, wy = calculate_zpsf(zs[i], cx, cy)
            sx, sy = float(wx), float(wy)
        else:
            sx = sy = psf
        out[step[i]:step[i + 1], 0] = xs[i] + np.random.normal(
            0, sx, c
        )
        out[step[i]:step[i + 1], 1] = ys[i] + np.random.normal(
            0, sy, c
        )
    return out


def convertMovie(
    runner: int,
    photondist,
    structures,
    imagesize: int,
    frames: int,
    psf: float,
    photonrate: float,
    background: float,
    noise: float,
    mode3Dstate: bool = False,
    cx=None,
    cy=None,
):
    """Bin photon positions of one frame into an image
    (picasso/simulate.py:424)."""
    edges = range(imagesize + 1)
    photonposframe = distphotonsxy(
        runner, photondist, structures, psf, mode3Dstate, cx, cy
    )
    if len(photonposframe) == 0:
        simframe = np.zeros((imagesize, imagesize))
    else:
        x = photonposframe[:, 0]
        y = photonposframe[:, 1]
        simframe, _, _ = np.histogram2d(y, x, bins=(edges, edges))
        simframe = np.flipud(simframe)  # consistent with render
    return simframe


def saveMovie(filename: str, movie: np.ndarray, info: dict) -> None:
    """Write the simulated movie as raw + yaml
    (picasso/simulate.py:493)."""
    movie.tofile(filename)
    base = filename.rsplit(".", 1)[0]
    io.save_info(base + ".yaml", [info])


def defineStructure(
    structurexxpx,
    structureyypx,
    structureex,
    structure3d,
    pixelsize: float,
    mean: bool = True,
):
    """Structure definition: converts nm layout to px, optional
    centering; rows are [x, y, exchange, 3d]
    (picasso/simulate.py:500)."""
    structurexxpx = np.asarray(structurexxpx, float)
    structureyypx = np.asarray(structureyypx, float)
    if mean:
        structurexxpx = structurexxpx - np.mean(structurexxpx)
        structureyypx = structureyypx - np.mean(structureyypx)
    structurexx = structurexxpx / pixelsize
    structureyy = structureyypx / pixelsize
    return np.array(
        [structurexx, structureyy, structureex, structure3d]
    )


def generatePositions(
    number: int, imagesize: int, frame: int, arrangement: int
):
    """Random or grid positions for structures
    (picasso/simulate.py:551)."""
    if arrangement == 0:
        spacing = int(np.ceil(number**0.5))
        linpos = np.linspace(frame, imagesize - frame, spacing)
        xxg, yyg = np.meshgrid(linpos, linpos)
        gridpos = np.vstack((np.ravel(xxg), np.ravel(yyg))).T
        gridpos = gridpos[:number]
    else:
        gridpos = (
            (imagesize - 2 * frame) * np.random.rand(number, 2) + frame
        )
    return gridpos


def rotateStructure(structure):
    """Random in-plane rotation of a structure
    (picasso/simulate.py:594)."""
    angle = np.random.rand(1) * 2 * np.pi
    return np.array(
        [
            structure[0, :] * np.cos(angle)
            - structure[1, :] * np.sin(angle),
            structure[0, :] * np.sin(angle)
            + structure[1, :] * np.cos(angle),
            structure[2, :],
            structure[3, :],
        ]
    )


def incorporateStructure(structure, incorporation: float):
    """Labeling-efficiency thinning (picasso/simulate.py:623)."""
    return structure[
        :, np.random.rand(structure.shape[1]) < incorporation
    ]


def randomExchange(pos):
    """Shuffle the exchange channel assignment
    (picasso/simulate.py:649)."""
    arraytoShuffle = pos[2, :].copy()
    np.random.shuffle(arraytoShuffle)
    return np.array([pos[0, :], pos[1, :], arraytoShuffle, pos[3, :]])


def prepareStructures(
    structure,
    gridpos,
    orientation: int,
    number: int,
    incorporation: float,
    exchange: int,
):
    """Place, rotate and thin structures at grid positions; output rows
    are [x, y, exchange, structure_id, 3d]
    (picasso/simulate.py:670)."""
    newpos = None
    for i in range(len(gridpos)):
        struct = structure.copy()
        if orientation != 0:
            struct = rotateStructure(struct)
        if incorporation != 1:
            struct = incorporateStructure(struct, incorporation)
        newx = struct[0, :] + gridpos[i, 0]
        newy = struct[1, :] + gridpos[i, 1]
        newstruct = np.array(
            [
                newx,
                newy,
                struct[2, :],
                struct[2, :] * 0 + i,
                struct[3, :],
            ]
        )
        if newpos is None:
            newpos = newstruct
        else:
            newpos = np.concatenate((newpos, newstruct), axis=1)
    if exchange == 1 and newpos is not None:
        newpos = randomExchange(newpos)
    return newpos if newpos is not None else np.zeros((5, 0))


def simulate_movie(
    n_sites: int = 20,
    imagesize: int = 32,
    frames: int = 500,
    psf: float = 0.82,
    photonrate: float = 50.0,
    photonratestd: float = 10.0,
    photonbudget: float = 1.5e6,
    taud: float = 5000.0,
    taub: float = 500.0,
    itime: float = 300.0,
    background: float = 1.0,
    seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Convenience end-to-end simulation (not in the reference API):
    random sites -> kinetics -> photon binning -> Poisson background.
    Returns (movie uint16 (frames, Y, X), site positions (n, 2) in
    MOVIE coordinates — convertMovie flips frames vertically, so the
    returned y is already mirrored to match what localizing the movie
    recovers — and the info dict). Used for closed-loop
    simulate->localize tests."""
    if seed is not None:
        np.random.seed(seed)
    sites = generatePositions(n_sites, imagesize, 5, 0)
    structures = np.array(
        [
            sites[:, 0],
            sites[:, 1],
            np.ones(len(sites)),
            np.arange(len(sites)),
            np.zeros(len(sites)),
        ]
    )
    photondist, spotkinetics, _ = distphotons(
        structures, itime, frames, taud, taub, photonrate,
        photonratestd, photonbudget,
    )
    movie = np.zeros((frames, imagesize, imagesize))
    for f in range(frames):
        movie[f] = convertMovie(
            f, photondist, structures, imagesize, frames, psf,
            photonrate, background, 0,
        )
    movie = noisy_p(movie, background)
    movie = check_type(movie)
    # ground truth in movie coordinates: frames are flipud'ed, and
    # the localizer's pixel-center convention sits 0.5 px below the
    # simulator's photon-binning origin in both axes
    sites = np.column_stack(
        [sites[:, 0] - 0.5, imagesize - sites[:, 1] - 0.5]
    )
    info = {
        "Frames": frames,
        "Height": imagesize,
        "Width": imagesize,
        "Byte Order": "<",
        "Data Type": "uint16",
        "Pixelsize": 130,
        "Generated by": "Picasso simulate",
    }
    return movie, sites, info


def test_calculate_zpsf():
    """Self-test with the reference's checked coefficients
    (picasso/simulate.py:66)."""
    cx = np.array([1, 2, 3, 4, 5, 6, 7])
    z = np.array([1, 2, 3, 4, 5, 6, 7])
    wx, _ = calculate_zpsf(z, cx, cx)
    expected = [
        4.90350522e01, 7.13644987e02, 5.52316597e03, 2.61621620e04,
        9.06621337e04, 2.54548124e05, 6.14947219e05,
    ]
    assert np.sum((wx - expected) ** 2) < 0.001
    return wx


def fitFuncBg(x, a: float, b: float):
    """Noise-calibration background model: (a + b*conc) * laser * time
    (picasso/gui/simulate.py:34)."""
    return (a + b * x[0]) * x[1] * x[2]


def fitFuncStd(x, a: float, b: float, c: float):
    """Noise-calibration std model: a*laser*time + b*bg + c
    (picasso/gui/simulate.py:39)."""
    return a * x[0] * x[1] + b * x[2] + c


def calibrate_noise_model(bg, bgstd, laser, itime, conc):
    """Fit the background/std noise-model coefficients from measured
    per-file statistics (reference advanced-mode noise calibration,
    picasso/gui/simulate.py:2123 calibrateNoise).

    Returns ``{"lasercEdit": a, "imagercEdit": b, "EquationA": .,
    "EquationB": ., "EquationC": .}`` plus the model evaluations for
    diagnostic plotting."""
    from scipy.optimize import curve_fit

    x_bg = np.array([conc, laser, itime], float)
    params_bg, _ = curve_fit(
        fitFuncBg, x_bg, np.asarray(bg, float), [1, 1]
    )
    x_std = np.array([laser, itime, bg], float)
    params_std, _ = curve_fit(
        fitFuncStd, x_std, np.asarray(bgstd, float), [1, 1, 1]
    )
    return {
        "laserc": float(params_bg[0]),
        "imagerc": float(params_bg[1]),
        "equation_a": float(params_std[0]),
        "equation_b": float(params_std[1]),
        "equation_c": float(params_std[2]),
        "bg_model": fitFuncBg(x_bg, *params_bg),
        "std_model": fitFuncStd(x_std, *params_std),
    }


def sigmafilter(data, sigmas: float):
    """Keep data within +- sigmas standard deviations
    (picasso/gui/simulate.py:2181)."""
    data = np.asarray(data)
    sigma = np.std(data)
    mean = np.mean(data)
    out = data[data < (mean + sigmas * sigma)]
    return out[out > (mean - sigmas * sigma)]
