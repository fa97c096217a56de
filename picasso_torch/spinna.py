"""SPINNA: simulate labelled structure mixtures, compare their nearest
neighbour distances (NNDs) with an experiment's, and fit the
stoichiometry of the structures.

Counterpart of picasso_tpu/spinna.py (rref :47, generate_N_structures
:134, random_rotation_matrices :211, coords_to_locs :233, get_NN_dist*
:255-308, NND_score :311, Structure :330, load_structures :426,
MaskGenerator :449, StructureSimulator :561, StructureMixer :752,
SPINNA :1021, compare_models :1414, get_le_from_props :1498, fit_le
:1513, check_structures_valid_for_fitting :1602, plot_NN :1619,
compare_models_given_label_unc :1666, batch_analysis :1821). Locs are
numpy structured arrays; CSV files are read and written with ``csv``.

Two scoring routes, where JAX takes them by default:
- from BATCH_MIN_CANDIDATES candidates the batched scorer
  (ops/spinna_batch.py) on ``device``: simulation, kNN and KS of a chunk
  of candidates in torch. Its draws are not numpy's, so its scores agree
  with the host route's in distribution;
- below, the host scorer (``_evaluate_single``): numpy simulation with
  the same ``np.random`` calls in the same order as JAX, cKDTree and
  scipy's ks_2samp, so it equals JAX's bit for bit under one
  ``np.random.seed``.
A failure of the batched scorer raises; nothing falls back to the host.

``fit_bayesian``'s surrogate is sklearn's GaussianProcessRegressor(
kernel=Matern(nu=2.5), normalize_y=True, alpha=1e-4) written in numpy
and scipy (:class:`MaternGP`).
"""

from __future__ import annotations

import csv
import os
from copy import deepcopy
from itertools import product as it_prod
from typing import Literal

import numpy as np
from scipy.linalg import cho_solve, cholesky, solve_triangular
from scipy.optimize import minimize
from scipy.spatial import cKDTree as KDTree
from scipy.spatial.distance import cdist, pdist, squareform
from scipy.spatial.transform import Rotation
from scipy.stats import ks_2samp, norm

from picasso_torch import __version__, io, lib

N_TASKS = 100
N_BOOTSTRAPS = 20
BOOTSTRAP_DISTANCE = 30.0
# Minkowski power of the bootstrap-subset distance (p = 1, Manhattan)
BOOTSTRAP_DISTANCE_METRIC = 1.0
# candidates from which NN_scorer takes the batched scorer (JAX :1138)
BATCH_MIN_CANDIDATES = 4

FittingMode = Literal["coarse-to-fine", "bayesian", "brute-force"]


# ---------------------------------------------------------------------------
# The search space
# ---------------------------------------------------------------------------


def rref(M: np.ndarray) -> np.ndarray:
    """Reduced row echelon form by Gauss-Jordan elimination with partial
    pivoting: in each column the row of largest magnitude below the
    pivots leads; entries within a rounding of zero count as zero. Pivots
    are exactly 1 and their columns exactly 0 elsewhere."""
    M = np.array(M, dtype=np.float64, copy=True)
    n_rows, n_cols = M.shape
    tol = max(n_rows, n_cols) * np.finfo(float).eps * max(
        np.abs(M).max(initial=0.0), 1.0)
    r = 0
    for c in range(n_cols):
        if r == n_rows:
            break
        p = r + int(np.argmax(np.abs(M[r:, c])))
        if abs(M[p, c]) <= tol:
            M[r:, c] = 0.0
            continue
        M[[r, p]] = M[[p, r]]
        M[r] = M[r] / M[r, c]
        for i in range(n_rows):
            if i != r and M[i, c] != 0:
                M[i] -= M[i, c] * M[r]
                M[i, c] = 0.0
        r += 1
    return M


def _targets_from_structures(structures) -> list[str]:
    targets = []
    for s in structures:
        for t in s.targets:
            if t not in targets:
                targets.append(t)
    return targets


def _find_target_counts(targets, structures) -> np.ndarray:
    t_counts = np.zeros((len(targets), len(structures)), np.float32)
    for i, s in enumerate(structures):
        t_counts[:, i] = s.get_ind_target_count(targets)
    return t_counts


def _get_structures_permutation(t_counts: np.ndarray) -> np.ndarray:
    """Order the structures so that the free parameters of the linear
    system sit on the right (picasso/spinna.py:143)."""
    n_t, n_s = t_counts.shape
    perm = np.arange(n_s)
    red = rref(t_counts)
    lpc = n_t
    for i in range(min(n_t, n_s)):
        if lpc >= n_s:
            break
        if red[i, i] != 1:
            perm[i], perm[lpc] = lpc, i
            lpc += 1
    return perm


# The reference's public names (JAX binds them to the private functions,
# spinna.py:1592-1594).
targets_from_structures = _targets_from_structures
find_target_counts = _find_target_counts
get_structures_permutation = _get_structures_permutation


def generate_N_structures(structures, N_total: dict, granularity: int,
                          save: str = "") -> dict:
    """The stoichiometry search space: every non-negative integer count
    of the structures that accounts for the total target counts, gridded
    at ``granularity`` over the free structures (picasso/spinna.py:203).
    ``save`` writes it as a CSV, one column a structure."""
    targets = _targets_from_structures(structures)
    n_t = len(targets)
    n_s = len(structures)
    if n_s < n_t:
        raise ValueError(
            "Search-space generation needs at least as many candidate"
            f" structures as unique molecular targets; got {n_s}"
            f" structure(s) for {n_t} target(s).")
    t_counts = _find_target_counts(targets, structures)
    if n_s == n_t:
        N_arr = np.asarray([N_total[t] for t in targets], np.float64)
        try:
            counts = np.linalg.solve(t_counts.astype(np.float64), N_arr)
        except np.linalg.LinAlgError as err:
            raise ValueError(
                "Cannot generate a search space: t_counts is singular."
            ) from err
        counts = np.maximum(np.round(counts), 0).astype(np.int32)
        out = {s.title: np.array([counts[i]])
               for i, s in enumerate(structures)}
    else:
        p = _get_structures_permutation(t_counts.copy())
        t_counts = t_counts[:, p]
        structures = [structures[i] for i in p]
        N_arr = np.asarray([N_total[t] for t in targets])
        eqs = np.float32(rref(np.hstack((t_counts, N_arr.reshape(-1, 1)))))
        t_free = t_counts[:, n_t:]
        max_vals = N_arr.max() * np.ones_like(t_free)
        np.divide(N_arr.reshape(-1, 1), t_free, out=max_vals,
                  where=t_free != 0)
        max_vals = max_vals.min(axis=0).astype(np.int32)
        bases = [np.linspace(0, m, granularity) for m in max_vals]
        free = np.array(list(it_prod(*bases)))
        N_structures = np.hstack((np.zeros((free.shape[0], n_t)), free))
        for i in range(n_t):
            formula = eqs[n_t - i - 1][(n_t - i):]
            N_structures[:, n_t - i - 1] = formula[-1] - (
                N_structures[:, (n_t - i):] @ formula[:-1])
        N_structures = N_structures[~np.any(N_structures < 0, axis=1)]
        N_structures = N_structures.astype(np.int32)
        out = {s.title: N_structures[:, i] for i, s in enumerate(structures)}
    if save:
        lib.write_csv(save, list(out), zip(*out.values()))
    return out


# ---------------------------------------------------------------------------
# Rotations and conversions
# ---------------------------------------------------------------------------


def random_rotation_matrices(
        N: int, mode: Literal["2D", "3D"] | None = "2D") -> np.ndarray:
    """N random rotation matrices from numpy's global stream: in-plane
    for 2D, uniform SO(3) for 3D, the identity for None
    (picasso/spinna.py:397)."""
    if mode is None:
        return np.tile(np.eye(3), (N, 1, 1))
    if mode == "2D":
        ang = np.random.uniform(0, 2 * np.pi, N)
        c, s = np.cos(ang), np.sin(ang)
        R = np.zeros((N, 3, 3))
        R[:, 0, 0] = c
        R[:, 0, 1] = -s
        R[:, 1, 0] = s
        R[:, 1, 1] = c
        R[:, 2, 2] = 1.0
        return R
    if mode == "3D":
        return Rotation.random(N).as_matrix()
    raise ValueError("mode must be '2D', '3D' or None.")


def coords_to_locs(coords: np.ndarray, lp: float = 1.0,
                   pixelsize: float = 130) -> np.ndarray:
    """nm coordinates -> a locs structured array (x, y in camera pixels,
    z in nm), with JAX's DataFrame's fields (picasso/spinna.py:441)."""
    fields = [("frame", np.uint32), ("x", np.float32), ("y", np.float32)]
    if coords.shape[1] == 3:
        fields.append(("z", np.float32))
    fields += [("lpx", np.float32), ("lpy", np.float32)]
    locs = np.zeros(len(coords), fields)
    locs["frame"] = 1
    locs["x"] = (coords[:, 0] / pixelsize).astype(np.float32)
    locs["y"] = (coords[:, 1] / pixelsize).astype(np.float32)
    if coords.shape[1] == 3:
        locs["z"] = coords[:, 2].astype(np.float32)
    locs["lpx"] = locs["lpy"] = (lp * np.ones(len(coords))
                                 / pixelsize).astype(np.float32)
    return locs


# ---------------------------------------------------------------------------
# The NND machinery (the host scorer)
# ---------------------------------------------------------------------------


def get_NN_dist(data1, data2, n_neighbors: int) -> np.ndarray:
    """The n_neighbors nearest distances (len(data1), n_neighbors),
    ascending, by cKDTree; a cloud queried against itself leaves out the
    zero distance to each point (picasso/spinna.py:696-749)."""
    n_from = len(data1)
    if not (n_from and len(data2)):
        return np.array([])
    if data1.shape[1] != data2.shape[1]:
        raise ValueError(
            f"dimensionality mismatch: data1 has {data1.shape[1]} "
            f"columns, data2 has {data2.shape[1]}")
    self_query = data1.shape == data2.shape and bool(
        np.array_equal(data1, data2))
    k = n_neighbors + 1 if self_query else n_neighbors
    dist = KDTree(data2).query(data1, k=k)[0].reshape(n_from, k)
    return dist[:, 1:] if self_query else dist


def get_NN_dist_experimental(coords: dict, mixer: "StructureMixer",
                             duplicate: bool = False) -> list[np.ndarray]:
    """The experiment's NNDs for every relevant target pair
    (picasso/spinna.py:750)."""
    return [get_NN_dist(coords[t1], coords[t2], n)
            for t1, t2, n in mixer.get_neighbor_idx(duplicate=duplicate)
            if n]


def get_NN_dist_simulated(N_str, N_sim: int, mixer: "StructureMixer",
                          duplicate: bool = False) -> list[np.ndarray]:
    """Simulated NNDs pooled over N_sim repeats (picasso/spinna.py:792)."""
    neighbor_idx = [p for p in mixer.get_neighbor_idx(duplicate=duplicate)
                    if p[2]]
    acc = [[] for _ in neighbor_idx]
    for _ in range(N_sim):
        coords = mixer.run_simulation(N_str)
        for a, (t1, t2, n) in zip(acc, neighbor_idx):
            a.append(get_NN_dist(coords[t1], coords[t2], n))
    return [np.concatenate(a) if a else np.array([]) for a in acc]


def NND_score(dists1, dists2) -> float:
    """The mean two-sample KS statistic over target pairs and neighbour
    orders; 1.0 when nothing scores (picasso/spinna.py:846)."""
    scores = []
    for d1, d2 in zip(dists1, dists2):
        if len(d1) == 0 or len(d2) == 0:
            continue
        for n in range(d1.shape[1]):
            scores.append(ks_2samp(d1[:, n], d2[:, n]).statistic)
    if not scores:
        return 1.0
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# Structures
# ---------------------------------------------------------------------------


class Structure:
    """A hetero- or homo-multimer: named molecular targets with nm
    coordinates."""

    def __init__(self, title: str) -> None:
        self.title = title
        self.targets: list[str] = []
        self.x: dict = {}
        self.y: dict = {}
        self.z: dict = {}

    def __repr__(self) -> str:
        lines = [f"Type: Structure, Title: {self.title}\n"
                 "Coordinates below: x, y, z (nm)\n"]
        for target in self.x:
            lines.append(f"{target}:")
            for x, y, z in zip(self.x[target], self.y[target],
                               self.z[target]):
                lines.append(f"{x}, {y}, {z}")
        return "\n".join(lines) + "\n"

    def define_coordinates(self, target, x, y, z=None) -> "Structure":
        if z is not None:
            if not (len(x) == len(y) == len(z)):
                raise ValueError(
                    "x, y and z coordinates must have equal length.")
        else:
            if len(x) != len(y):
                raise ValueError(
                    "x and y coordinates must have equal length.")
            z = [0] * len(x)
        if target not in self.targets:
            self.targets.append(target)
            self.x[target] = list(x)
            self.y[target] = list(y)
            self.z[target] = list(z)
        else:
            self.x[target].extend(x)
            self.y[target].extend(y)
            self.z[target].extend(z)
        return self

    def delete_target(self, target: str) -> None:
        if target in self.targets:
            self.targets.remove(target)
            del self.x[target]
            del self.y[target]
            del self.z[target]

    def get_all_targets_count(self) -> int:
        return sum(len(c) for c in self.x.values())

    def get_ind_target_count(self, targets) -> list[int]:
        return [len(self.x[t]) if t in self.targets else 0 for t in targets]

    def get_max_nn(self, target1: str, target2: str) -> int:
        if target1 not in self.targets or target2 not in self.targets:
            return 0
        if target1 == target2:
            return max(len(self.x[target1]) - 1, 0)
        return min(len(self.x[target1]), len(self.x[target2]))

    def get_info(self) -> dict:
        info = {"Structure title": self.title,
                "Molecular targets": self.targets}
        for t in self.targets:
            info[f"{t}_x"] = list(self.x[t])
            info[f"{t}_y"] = list(self.y[t])
            info[f"{t}_z"] = list(self.z[t])
        return info

    def restart(self) -> "Structure":
        self.targets = []
        self.x = {}
        self.y = {}
        self.z = {}
        return self

    def save(self, path: str) -> None:
        if not path.endswith(".yaml"):
            raise ValueError("Path for saving structure must end with .yaml")
        io.save_info(path, [self.get_info()])


def load_structures(path: str) -> tuple[list[Structure], list[str]]:
    """Structures from a YAML multi-document file
    (picasso/spinna.py:876)."""
    structures = []
    for block in io.load_info(path):
        s = Structure(block["Structure title"])
        for t in block["Molecular targets"]:
            s.define_coordinates(t, block[f"{t}_x"], block[f"{t}_y"],
                                 block.get(f"{t}_z"))
        structures.append(s)
    return structures, _targets_from_structures(structures)


# ---------------------------------------------------------------------------
# Density masks
# ---------------------------------------------------------------------------


class MaskGenerator:
    """Blurred 2D/3D density masks of locs, to place simulated structures
    with the experiment's spatial density (picasso/spinna.py:920)."""

    def __init__(self, locs: np.ndarray, info: list[dict],
                 binsize: float = 100.0, sigma: float = 200.0,
                 mode: Literal["2D", "3D"] = "2D"):
        self.locs = locs
        self.info = info
        self.mode = mode
        self.pixelsize = lib.get_from_metadata(info, "Pixelsize", default=130)
        self.mask = None
        self.set_binsize(binsize)
        self.set_sigma(sigma)

    def set_binsize(self, binsize) -> None:
        self.binsize = binsize  # nm

    def set_sigma(self, sigma) -> None:
        self.sigma = sigma  # nm

    def render_locs(self) -> np.ndarray:
        width = lib.get_from_metadata(self.info, "Width")
        height = lib.get_from_metadata(self.info, "Height")
        bin_px = self.binsize / self.pixelsize
        nx = int(np.ceil(width / bin_px))
        ny = int(np.ceil(height / bin_px))
        x = np.asarray(self.locs["x"]) / bin_px
        y = np.asarray(self.locs["y"]) / bin_px
        if self.mode == "3D" and "z" in self.locs.dtype.names:
            z = np.asarray(self.locs["z"]) / self.binsize
            z = z - z.min()
            nz = max(1, int(np.ceil(z.max())) + 1)
            img, _ = np.histogramdd(np.column_stack([y, x, z]),
                                    bins=(ny, nx, nz),
                                    range=((0, ny), (0, nx), (0, nz)))
        else:
            img, _, _ = np.histogram2d(y, x, bins=(ny, nx),
                                       range=((0, ny), (0, nx)))
        return img

    def generate_mask(self, thresholded: bool = False) -> np.ndarray:
        from scipy.ndimage import gaussian_filter

        from picasso_torch import masking

        mask = gaussian_filter(self.render_locs().astype(np.float64),
                               self.sigma / self.binsize)
        if thresholded:
            mask = (mask > masking.threshold_otsu(mask)).astype(np.float64)
        if mask.sum() > 0:
            mask = mask / mask.sum()
        self.mask = mask
        return mask

    def save_mask(self, path: str, save_png: bool = False) -> None:
        if self.mask is None:
            raise ValueError("Generate the mask first.")
        np.save(path, self.mask)
        base = path[:-4] if path.endswith(".npy") else path
        self.save_mask_info(base + ".yaml")

    def save_mask_info(self, path: str) -> None:
        io.save_info(path, [self.mask_info()])

    def mask_info(self) -> dict:
        return {
            "Generated by": f"Picasso v{__version__} SPINNA Mask",
            "Binsize (nm)": self.binsize,
            "Sigma (nm)": self.sigma,
            "Mode": self.mode,
            "Shape": (list(self.mask.shape) if self.mask is not None
                      else None),
        }

    @property
    def area(self) -> float | None:
        """The mask's area (um^2) of nonzero bins (2D)."""
        if self.mask is None or self.mask.ndim != 2:
            return None
        return float((self.mask > 0).sum() * (self.binsize / 1000) ** 2)

    @property
    def volume(self) -> float | None:
        """The mask's volume (um^3) of nonzero bins (3D)."""
        if self.mask is None or self.mask.ndim != 3:
            return None
        return float((self.mask > 0).sum() * (self.binsize / 1000) ** 3)


# ---------------------------------------------------------------------------
# Simulation on the host
# ---------------------------------------------------------------------------


class StructureSimulator:
    """One structure population from numpy's global stream, in JAX's
    order of draws: the centers (CSR in the ROI or a multinomial over a
    density mask), a rotation a structure, the label-uncertainty jitter,
    the labelling-efficiency thinning (picasso/spinna.py:1518)."""

    def __init__(self, structure: Structure, N_structures: int, le,
                 label_unc, mask=None, mask_info: dict | None = None,
                 width: float | None = None, height: float | None = None,
                 depth: float | None = None,
                 random_rot_mode: Literal["2D", "3D"] | None = "2D"):
        self.structure = structure
        self.N = int(N_structures)
        self.le = (le if isinstance(le, (list, np.ndarray))
                   else [le] * len(structure.targets))
        self.label_unc = (label_unc
                          if isinstance(label_unc, (list, np.ndarray))
                          else [label_unc] * len(structure.targets))
        self.mask = mask
        self.mask_info = mask_info or {}
        self.width = width
        self.height = height
        self.depth = depth
        self.random_rot_mode = random_rot_mode
        self.c_pos = None
        self.pos: dict = {}
        self.pos_obs: dict = {}

    @property
    def _is_3d(self) -> bool:
        return self.depth is not None or (self.mask is not None
                                          and np.ndim(self.mask) == 3)

    def simulate_centers(self) -> None:
        if self.mask is not None:
            self.simulate_centers_mask()
        else:
            self.simulate_centers_CSR()

    def simulate_centers_CSR(self) -> None:
        if self.width is None or self.height is None:
            raise ValueError(
                "width and height (nm) must be given for CSR simulation.")
        x = np.random.uniform(0, self.width, self.N)
        y = np.random.uniform(0, self.height, self.N)
        if self.depth is not None:
            z = np.random.uniform(-self.depth / 2, self.depth / 2, self.N)
        else:
            z = np.zeros(self.N)
        self.c_pos = np.column_stack([x, y, z])

    def simulate_centers_mask(self) -> None:
        """A multinomial draw over the mask's bins, then CSR within each
        bin (picasso/spinna.py:1742)."""
        mask = np.asarray(self.mask, np.float64)
        counts = np.random.multinomial(self.N, mask.ravel() / mask.sum())
        binsize = self.mask_info.get("Binsize (nm)", 100.0)
        idx = np.repeat(np.arange(mask.size), counts)
        b = np.unravel_index(idx, mask.shape)  # (y, x[, z])
        x = (b[1] + np.random.random(self.N)) * binsize
        y = (b[0] + np.random.random(self.N)) * binsize
        z = ((b[2] + np.random.random(self.N)) * binsize if mask.ndim == 3
             else np.zeros(self.N))
        self.c_pos = np.column_stack([x, y, z])

    def simulate_all_targets(self) -> None:
        """Every target of every copy: the template rotated a copy,
        offset by its center, plus Gaussian label-uncertainty jitter
        (picasso/spinna.py:1828)."""
        self.pos = {}
        if self.N == 0:
            for t in self.structure.targets:
                self.pos[t] = np.zeros((0, 3 if self._is_3d else 2))
            return
        rotations = random_rotation_matrices(self.N, self.random_rot_mode)
        for i, t in enumerate(self.structure.targets):
            template = np.stack((self.structure.x[t], self.structure.y[t],
                                 self.structure.z[t])).astype(np.float64).T
            coords = np.einsum("nij,mj->nmi", rotations, template)
            coords = coords + self.c_pos[:, None, :]
            coords = coords + np.random.normal(
                0, max(self.label_unc[i], 1e-12), coords.shape)
            flat = coords.reshape(-1, 3)
            self.pos[t] = flat if self._is_3d else flat[:, :2]

    def simulate_le(self) -> None:
        """Thin each target by its labelling efficiency
        (picasso/spinna.py:1946)."""
        self.pos_obs = {}
        for i, t in enumerate(self.pos):
            N = len(self.pos[t])
            keep = np.random.choice(N, size=int(N * self.le[i]),
                                    replace=False)
            self.pos_obs[t] = self.pos[t][keep, :]

    def run(self, save_centers: bool = False, save_all_mol: bool = False,
            save_obs_mol: bool = False,
            path_base: str | None = None) -> "StructureSimulator":
        self.simulate_centers()
        self.simulate_all_targets()
        self.simulate_le()
        if any([save_centers, save_all_mol, save_obs_mol]):
            if path_base is None:
                raise ValueError("Please specify path_base for saving.")
            self.save(path_base, save_centers, save_all_mol, save_obs_mol)
        return self

    def save(self, path_base, centers=False, all_mol=False, obs_mol=False):
        info = [{
            "Generated by": f"Picasso v{__version__} SPINNA simulate",
            "Structure": self.structure.title,
            "N structures": self.N,
        }]
        if centers and self.c_pos is not None:
            io.save_locs(path_base + "_centers.hdf5",
                         coords_to_locs(self.c_pos[:, :2]), info)
        for t in self.structure.targets:
            if all_mol and t in self.pos:
                io.save_locs(path_base + f"_all_{t}.hdf5",
                             coords_to_locs(self.pos[t]), info)
            if obs_mol and t in self.pos_obs:
                io.save_locs(path_base + f"_obs_{t}.hdf5",
                             coords_to_locs(self.pos_obs[t]), info)


class StructureMixer:
    """A mixture of structures over one ROI or density mask, with the
    NND bookkeeping of its target pairs (picasso/spinna.py:2161)."""

    def __init__(self, structures, label_unc: dict, le: dict,
                 mask_dict: dict | None = None, width: float | None = None,
                 height: float | None = None, depth: float | None = None,
                 random_rot_mode: Literal["2D", "3D"] | None = "2D",
                 nn_counts: Literal["auto"] | dict = "auto"):
        if isinstance(structures, Structure):
            structures = [structures]
        if not isinstance(structures, list):
            raise ValueError(
                "structures must be a Structure or a list of Structures.")
        if not isinstance(label_unc, dict):
            raise ValueError(
                "label_unc must be a dict keyed by target name (or 'ALL').")
        if any(v < 0 for v in label_unc.values()):
            raise ValueError("Label uncertainties must be non-negative.")
        if not isinstance(le, dict):
            raise ValueError(
                "le must be a dict keyed by target name (or 'ALL').")
        if any(not 0 <= v <= 1 for v in le.values()):
            raise ValueError("Labeling efficiencies must lie in [0, 1].")
        if not (nn_counts == "auto" or isinstance(nn_counts, dict)):
            raise ValueError(
                "nn_counts must be 'auto' or a dict of target pairs.")
        self.structures = structures
        self.label_unc = label_unc
        self.le = le
        self.mask_dict = mask_dict
        self.roi = [width, height, depth]
        self.random_rot_mode = random_rot_mode
        self.nn_counts = nn_counts
        self.simulators: list[StructureSimulator] = []
        self.targets = self.get_target_names()
        for t in self.targets:
            for name, d in (("label_unc", label_unc), ("le", le)):
                if "ALL" not in d and t not in d:
                    raise ValueError(f"Target {t!r} missing from {name}.")
        if isinstance(nn_counts, dict):
            for i, t1 in enumerate(self.targets):
                for t2 in self.targets[i:]:
                    if f"{t1}-{t2}" not in nn_counts:
                        raise ValueError(
                            f"nn_counts missing pair '{t1}-{t2}'.")
        if mask_dict is None and (width is None or height is None):
            raise ValueError(
                "Provide either a mask_dict or ROI width/height (nm).")

    def get_target_names(self) -> list[str]:
        return _targets_from_structures(self.structures)

    def get_structure_names(self) -> list[str]:
        return [s.title for s in self.structures]

    def _per_target(self, d: dict, targets) -> list:
        if "ALL" in d:
            return [d["ALL"] for _ in targets]
        return [d[t] for t in targets]

    def extract_mask(self, structure):
        """A structure's mask: its target's, or the count-weighted mean of
        its targets' for a heteromultimer (picasso/spinna.py:2532)."""
        if self.mask_dict is None:
            return None, None
        masks = self.mask_dict.get("masks", {})
        info = self.mask_dict.get("infos", {})
        targets = structure.targets
        if len(targets) == 1:
            return masks[targets[0]], info[targets[0]]
        counts = structure.get_ind_target_count(targets)
        total = sum(counts)
        avg = sum(c / total * np.asarray(masks[t])
                  for c, t in zip(counts, targets))
        return avg, info[targets[0]]

    def run_simulation(self, N_structures, path: str = "") -> dict:
        """Simulate the mixture: per-target coordinate arrays (nm)
        (picasso/spinna.py:2453)."""
        if any(N < 0 for N in N_structures):
            raise ValueError("Numbers of structures must be positive numbers.")
        sim_results = []
        self.simulators = []
        width, height, depth = self.roi
        for i, structure in enumerate(self.structures):
            targets = structure.targets
            mask, mask_info = self.extract_mask(structure)
            sim = StructureSimulator(
                structure=structure, N_structures=N_structures[i],
                le=self._per_target(self.le, targets),
                label_unc=self._per_target(self.label_unc, targets),
                mask=mask, mask_info=mask_info, width=width, height=height,
                depth=depth, random_rot_mode=self.random_rot_mode).run()
            self.simulators.append(sim)
            sim_results.append(sim.pos_obs)
        all_locs = self.convert_sim_results(sim_results)
        if path:
            self.save(path, all_locs)
        return all_locs

    def convert_sim_results(self, sim_results) -> dict:
        out = {}
        for t in self.targets:
            parts = [r[t] for r in sim_results if t in r and len(r[t])]
            if parts:
                out[t] = np.concatenate(parts)
            else:
                out[t] = np.zeros((0, 3 if self.roi[2] is not None else 2))
        return out

    def save(self, path: str, all_locs: dict) -> None:
        base = path[:-5] if path.endswith(".hdf5") else path
        for t, coords in all_locs.items():
            io.save_locs(base + f"_sim_{t}.hdf5", coords_to_locs(coords),
                         [self.get_metadata()])

    def get_metadata(self, pixelsize: float = 130.0) -> dict:
        width_nm, height_nm = self.roi[0], self.roi[1]
        if width_nm is None and self.mask_dict is not None:
            # the field of view of the first mask
            first = next(iter(self.mask_dict.get("infos", {}).values()), {})
            shape = first.get("Shape", [1, 1])
            binsize = first.get("Binsize (nm)", 100.0)
            height_nm = shape[0] * binsize
            width_nm = shape[1] * binsize
        return {
            "Generated by": f"Picasso v{__version__} SPINNA",
            "Structures": self.get_structure_names(),
            "Targets": self.targets,
            "ROI (nm)": self.roi,
            "Frames": 1,
            "Width": int(np.ceil((width_nm or 1) / pixelsize)) + 1,
            "Height": int(np.ceil((height_nm or 1) / pixelsize)) + 1,
            "Pixelsize": pixelsize,
        }

    def get_neighbor_counts(self, target1, target2) -> int:
        if self.nn_counts == "auto":
            return max((s.get_max_nn(target1, target2)
                        for s in self.structures), default=0)
        return self.nn_counts[f"{target1}-{target2}"]

    def get_neighbor_idx(self, duplicate: bool = False):
        neighbor_idx = []
        for i, t1 in enumerate(self.targets):
            for t2 in self.targets[i:]:
                n = self.get_neighbor_counts(t1, t2)
                neighbor_idx.append((t1, t2, n))
                if duplicate and t1 != t2:
                    neighbor_idx.append((t2, t1, n))
        return neighbor_idx

    def convert_N_structures_to_array(self, N_structures):
        if isinstance(N_structures, dict):
            return np.column_stack(
                [np.asarray(N_structures[n])
                 for n in self.get_structure_names()]).astype(np.int32)
        arr = np.asarray(N_structures)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        return arr.astype(np.int32)

    def convert_counts_to_props(self, N_structures) -> np.ndarray:
        """Counts -> % of all targets (picasso/spinna.py:2836)."""
        N_structures = self.convert_N_structures_to_array(
            deepcopy(N_structures))
        per_struct = np.array([sum(s.get_ind_target_count(self.targets))
                               for s in self.structures])
        totals = np.maximum(N_structures @ per_struct, 1)
        props = np.round(100 * N_structures * per_struct[None, :]
                         / totals[:, None], 2).astype(np.float32)
        for r in np.where(np.sum(props, axis=1) != 100)[0]:
            nz = np.nonzero(props[r] > 0)[0]
            if len(nz):
                props[r, nz[0]] -= np.sum(props[r]) - 100
        if props.shape[0] == 1:
            return props.reshape(-1)
        return props

    def convert_props_to_counts(self, proportions, N_total):
        proportions = np.float32(deepcopy(proportions))
        if proportions.ndim == 1:
            proportions = proportions.reshape(1, -1)
        N_total = np.int32(N_total)
        out = np.zeros(proportions.shape, np.int32)
        for i, s in enumerate(self.structures):
            out[:, i] = np.int32(N_total * proportions[:, i] / 100
                                 / s.get_all_targets_count())
        if out.shape[0] == 1:
            return out.reshape(-1)
        return out

    @property
    def roi_size(self) -> float:
        w, h, d = self.roi
        if w is None:
            return 0.0
        if d is None:
            return w * h
        return w * h * d


# ---------------------------------------------------------------------------
# The Gaussian process of fit_bayesian
# ---------------------------------------------------------------------------


class MaternGP:
    """sklearn's GaussianProcessRegressor(kernel=Matern(nu=2.5),
    normalize_y=True, alpha=1e-4) in numpy and scipy, with sklearn's
    defaults and its order of operations (sklearn/gaussian_process
    _gpr.py fit, predict, log_marginal_likelihood; kernels.py Matern):
    one length scale, 1.0 at the start, bounded to (1e-5, 1e5) and fitted
    in its log by one L-BFGS-B run of the log-marginal likelihood and its
    gradient (no restarts); y normalized by its mean and std (std 0 -> 1);
    a Cholesky with ``alpha`` on the diagonal; the predictive variance
    clipped at 0."""

    def __init__(self, alpha: float = 1e-4, length_scale: float = 1.0,
                 length_scale_bounds=(1e-5, 1e5)):
        self.alpha = alpha
        self.length_scale = length_scale
        self.bounds = np.log(np.vstack([length_scale_bounds]))

    @staticmethod
    def _kernel(X, Y=None, length_scale=1.0, eval_gradient=False):
        length_scale = np.squeeze(length_scale).astype(float)
        if Y is None:
            dists = pdist(X / length_scale, metric="euclidean")
        else:
            dists = cdist(X / length_scale, Y / length_scale,
                          metric="euclidean")
        K = dists * np.sqrt(5)
        K = (1.0 + K + K**2 / 3.0) * np.exp(-K)
        if Y is None:
            K = squareform(K)
            np.fill_diagonal(K, 1)
        if not eval_gradient:
            return K
        D = squareform(dists**2)[:, :, np.newaxis]
        tmp = np.sqrt(5 * D.sum(-1))[..., np.newaxis]
        K_gradient = 5.0 / 3.0 * D * (tmp + 1) * np.exp(-tmp)
        return K, K_gradient.sum(-1)[:, :, np.newaxis]

    def log_marginal_likelihood(self, theta):
        """The log-marginal likelihood at log length scale ``theta`` (1,)
        and its gradient."""
        K, K_gradient = self._kernel(self.X_train_,
                                     length_scale=np.exp(theta[0]),
                                     eval_gradient=True)
        K[np.diag_indices_from(K)] += self.alpha
        try:
            L = cholesky(K, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return -np.inf, np.zeros_like(theta)
        y_train = self.y_train_[:, np.newaxis]
        alpha = cho_solve((L, True), y_train, check_finite=False)
        lml = -0.5 * np.einsum("ik,ik->k", y_train, alpha)
        lml -= np.log(np.diag(L)).sum()
        lml -= K.shape[0] / 2 * np.log(2 * np.pi)
        inner_term = np.einsum("ik,jk->ijk", alpha, alpha)
        K_inv = cho_solve((L, True), np.eye(K.shape[0]), check_finite=False)
        inner_term -= K_inv[..., np.newaxis]
        grad = 0.5 * np.einsum("ijl,jik->kl", inner_term, K_gradient)
        return lml.sum(axis=-1), grad.sum(axis=-1)

    def fit(self, X, y) -> "MaternGP":
        X = np.asarray(X)
        y = np.asarray(y, np.float64)
        self._y_train_mean = np.mean(y, axis=0)
        std = np.std(y, axis=0)
        self._y_train_std = 1.0 if std == 0.0 else std
        self.X_train_ = np.copy(X)
        self.y_train_ = (y - self._y_train_mean) / self._y_train_std

        def obj_func(theta):
            lml, grad = self.log_marginal_likelihood(theta)
            return -lml, -grad

        res = minimize(obj_func, np.log(np.hstack([self.length_scale])),
                       method="L-BFGS-B", jac=True, bounds=self.bounds)
        self.length_scale_ = np.exp(res.x[0])
        K = self._kernel(self.X_train_, length_scale=self.length_scale_)
        K[np.diag_indices_from(K)] += self.alpha
        self.L_ = cholesky(K, lower=True, check_finite=False)
        self.alpha_ = cho_solve((self.L_, True), self.y_train_,
                                check_finite=False)
        return self

    def predict(self, X):
        """(mean, std) of the predictive distribution at ``X``."""
        X = np.asarray(X)
        K_trans = self._kernel(X, self.X_train_,
                               length_scale=self.length_scale_)
        y_mean = K_trans @ self.alpha_
        y_mean = self._y_train_std * y_mean + self._y_train_mean
        V = solve_triangular(self.L_, K_trans.T, lower=True,
                             check_finite=False)
        y_var = np.ones(X.shape[0])
        y_var -= np.einsum("ij,ji->i", V.T, V)
        y_var[y_var < 0] = 0.0
        y_var = np.outer(y_var, self._y_train_std**2).reshape(-1)
        return y_mean, np.sqrt(y_var)


def expected_improvement(mu, std, best_y) -> np.ndarray:
    """EI of a minimization at the GP's predictions (JAX :1360-1363)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (best_y - mu) / np.maximum(std, 1e-12)
        return (best_y - mu) * norm.cdf(z) + std * norm.pdf(z)


# ---------------------------------------------------------------------------
# Stoichiometry fitting
# ---------------------------------------------------------------------------


class SPINNA:
    """Fit structure stoichiometries by comparing simulated and
    experimental NND distributions (KS statistic). ``device`` (resolved
    here by parallel/mesh.route: "cuda" without a card raises, and is one
    card however many are visible) runs the batched scorer; a mesh given
    splits its candidates over the shards."""

    def __init__(self, mixer: StructureMixer, gt_coords: dict,
                 N_sim: int = 1, progress_title: str = "Spinning structures",
                 device="cuda"):
        from picasso_torch.parallel.mesh import route

        self.device, self.mesh = route(device, spread=False)
        if not isinstance(mixer, StructureMixer):
            raise TypeError("Initialize the class with StructureMixer.")
        self.mixer = mixer
        self.N_sim = N_sim
        self.progress_title = progress_title
        if mixer.roi[0] is not None and mixer.roi[2] is None:
            gt_coords = {k: v[:, :2] for k, v in gt_coords.items()}
        self.gt_coords = gt_coords
        self.dists_gt = get_NN_dist_experimental(gt_coords, mixer)
        self._batched_cache = None

    def fit(self, N_structures, **kwargs):
        return self.fit_stoichiometry(N_structures, **kwargs)

    def fit_stoichiometry(self, N_structures, *,
                          fitting_mode: FittingMode = "coarse-to-fine",
                          save: str = "", asynch: bool = True,
                          bootstrap: bool = False,
                          return_scores: bool = False, callback=None):
        """Fit by ``fitting_mode``; ``asynch`` is accepted for the
        reference's API and ignored, as JAX does."""
        assert fitting_mode in ("coarse-to-fine", "bayesian", "brute-force")
        fit = {"coarse-to-fine": self.fit_coarse_to_fine,
               "bayesian": self.fit_bayesian,
               "brute-force": self._fit_brute}[fitting_mode]
        return fit(N_structures, save=save, bootstrap=bootstrap,
                   return_scores=return_scores, callback=callback)

    # -- scoring --
    def _evaluate_single(self, N_row) -> float:
        """The host scorer of one candidate."""
        dists_sim = get_NN_dist_simulated(N_row, self.N_sim, self.mixer,
                                          duplicate=False)
        return NND_score(dists_sim, self.dists_gt)

    def _get_batched_scorer(self, N_structures):
        """The batched scorer for these candidates, cached by its pads and
        the identity of the experimental distances (a bootstrap's swapped
        distances build a new one)."""
        from picasso_torch.ops.spinna_batch import BatchedScorer, _bucket

        N_structures = np.asarray(N_structures)
        max_counts = np.maximum(np.max(N_structures, axis=0), 1)
        t_counts = _find_target_counts(self.mixer.targets,
                                       self.mixer.structures)
        max_points = np.max(N_structures @ t_counts.T, axis=0).astype(
            np.int64)
        buckets = (tuple(_bucket(int(c)) for c in max_counts)
                   + tuple(_bucket(int(max(p, 1))) for p in max_points))
        cached = self._batched_cache
        if (cached is not None and cached[0] == buckets
                and cached[1] is self.dists_gt):
            return cached[2]
        scorer = BatchedScorer(self.mixer, self.dists_gt, self.N_sim,
                               max_counts, max_points=max_points,
                               device=(self.device if self.mesh is None
                                       else self.mesh))
        self._batched_cache = (buckets, self.dists_gt, scorer)
        return scorer

    def NN_scorer(self, N_structures, callback=None):
        """Score every candidate row: from BATCH_MIN_CANDIDATES rows with
        the batched scorer on the device, below with the host scorer."""
        N_structures = np.asarray(N_structures)
        with lib.progress_reporter(callback, len(N_structures),
                                   self.progress_title) as rep:
            if len(N_structures) >= BATCH_MIN_CANDIDATES:
                scorer = self._get_batched_scorer(N_structures)
                return N_structures, scorer.score(N_structures,
                                                  progress=rep.set_value)
            scores = np.empty(len(N_structures))
            for i, row in enumerate(N_structures):
                scores[i] = self._evaluate_single(row)
                rep.set_value(i + 1)
        return N_structures, scores

    @staticmethod
    def _farthest_point_sampling(points, n_samples):
        """Maximin sampling from the point nearest the centroid
        (picasso/spinna.py:3870)."""
        n_samples = min(n_samples, points.shape[0])
        centroid = points.mean(axis=0)
        first = int(np.argmin(np.linalg.norm(points - centroid, axis=1)))
        selected = [first]
        min_d = np.linalg.norm(points - points[first], axis=1)
        for _ in range(n_samples - 1):
            nxt = int(np.argmax(min_d))
            selected.append(nxt)
            min_d = np.minimum(min_d,
                               np.linalg.norm(points - points[nxt], axis=1))
        return np.array(selected)

    def get_subset_N_structures(self, N_structures, center,
                                radius: float = BOOTSTRAP_DISTANCE,
                                p: float = None):
        """The candidates within ``radius`` of ``center`` in proportion
        space, by the Minkowski-p distance (Manhattan by default;
        picasso/spinna.py:3970-4012)."""
        if p is None:
            p = BOOTSTRAP_DISTANCE_METRIC
        props = self.mixer.convert_counts_to_props(N_structures)
        if props.ndim == 1:
            props = props.reshape(1, -1)
        center_props = self.mixer.convert_counts_to_props(
            np.asarray(center).reshape(1, -1))
        diff = np.abs(props - center_props)
        if np.isinf(p):
            d = diff.max(axis=1)
        else:
            d = (diff**p).sum(axis=1) ** (1 / p)
        subset = N_structures[d <= radius]
        if len(subset) == 0:
            subset = np.asarray(center).reshape(1, -1)
        return subset

    def _finalize(self, N_structures, scores, save, bootstrap,
                  return_scores, callback):
        best = int(np.argmin(scores))
        opt_N = N_structures[best]
        opt_props = self.mixer.convert_counts_to_props(opt_N)
        score = float(scores[best])
        if save:
            props = self.mixer.convert_counts_to_props(N_structures)
            if props.ndim == 1:
                props = props.reshape(1, -1)
            names = self.mixer.get_structure_names()
            table = np.hstack((N_structures, props, scores.reshape(-1, 1)))
            lib.write_csv(save, [f"N_{n}" for n in names]
                          + [f"Prop_{n}" for n in names]
                          + ["Kolmogorov-Smirnov statistic"],
                          ([repr(float(v)) for v in row] for row in table))
        if bootstrap:
            result = self._run_bootstrap(N_structures, opt_N, opt_props,
                                         score, callback)
            return (*result, scores) if return_scores else result
        if return_scores:
            return opt_props, score, scores
        return opt_props, score

    def _fit_brute(self, N_structures, save="", bootstrap=False,
                   return_scores=False, callback=None):
        if isinstance(N_structures, dict):
            N_structures = self.mixer.convert_N_structures_to_array(
                N_structures)
        N_structures, scores = self.NN_scorer(N_structures,
                                              callback=callback)
        return self._finalize(N_structures, scores, save, bootstrap,
                              return_scores, callback)

    def fit_coarse_to_fine(self, N_structures, coarse_fraction: float = 0.1,
                           radius: float = BOOTSTRAP_DISTANCE,
                           save: str = "", bootstrap: bool = False,
                           return_scores: bool = False, callback=None):
        """A coarse pass over a farthest-point subsample, then a fine pass
        around its winner (picasso/spinna.py:3322)."""
        if isinstance(N_structures, dict):
            N_structures = self.mixer.convert_N_structures_to_array(
                N_structures)
        n_coarse = max(2, int(N_structures.shape[0] * coarse_fraction))
        props = self.mixer.convert_counts_to_props(N_structures)
        if props.ndim == 1:
            props = props.reshape(1, -1)
        N_coarse = N_structures[self._farthest_point_sampling(props,
                                                              n_coarse)]
        N_coarse, scores_coarse = self.NN_scorer(N_coarse, callback=callback)
        coarse_best = N_coarse[int(np.argmin(scores_coarse))]
        N_fine = self.get_subset_N_structures(N_structures, coarse_best,
                                              radius=radius)
        N_fine, scores_fine = self.NN_scorer(N_fine, callback=callback)
        return self._finalize(N_fine, scores_fine, save, bootstrap,
                              return_scores, callback)

    def fit_bayesian(self, N_structures, n_initial: int = 20,
                     n_iterations: int = 80, save: str = "",
                     bootstrap: bool = False, return_scores: bool = False,
                     callback=None):
        """Bayesian optimization with a Matern GP surrogate
        (:class:`MaternGP`) and expected improvement: the initial design
        scored as one batch, then one candidate an iteration on the host
        (picasso/spinna.py:3441)."""
        if isinstance(N_structures, dict):
            N_structures = self.mixer.convert_N_structures_to_array(
                N_structures)
        n_total = N_structures.shape[0]
        props = self.mixer.convert_counts_to_props(N_structures)
        if props.ndim == 1:
            props = props.reshape(1, -1)
        n_initial = min(n_initial, n_total)
        evaluated = list(self._farthest_point_sampling(props, n_initial))
        _, init_scores = self.NN_scorer(
            N_structures[np.asarray(evaluated, int)])
        scores = {int(i): float(s) for i, s in zip(evaluated, init_scores)}
        with lib.progress_reporter(callback, n_initial + n_iterations,
                                   self.progress_title) as rep:
            rep.set_value(len(evaluated))
            for it in range(n_iterations):
                remaining = np.setdiff1d(np.arange(n_total),
                                         list(scores.keys()))
                if len(remaining) == 0:
                    break
                y = np.array(list(scores.values()))
                gp = MaternGP().fit(props[list(scores.keys())], y)
                mu, std = gp.predict(props[remaining])
                ei = expected_improvement(mu, std, y.min())
                nxt = int(remaining[int(np.argmax(ei))])
                scores[nxt] = self._evaluate_single(N_structures[nxt])
                rep.set_value(n_initial + it + 1)
        idx = np.array(list(scores.keys()))
        vals = np.array(list(scores.values()))
        return self._finalize(N_structures[idx], vals, save, bootstrap,
                              return_scores, callback)

    def _run_bootstrap(self, N_structures, opt_N, opt_props, score,
                       callback):
        """The best fit's spread over N_BOOTSTRAPS simulated experiments
        at it (picasso/spinna.py:3786)."""
        exp_dists = deepcopy(self.dists_gt)
        subset = self.get_subset_N_structures(N_structures, opt_N)
        boot_scores, boot_props = [], []
        for _ in range(N_BOOTSTRAPS):
            gt_boot = self.mixer.run_simulation(opt_N)
            self.dists_gt = get_NN_dist_experimental(gt_boot, self.mixer)
            _, scores_b = self.NN_scorer(subset, callback=None)
            b = int(np.argmin(scores_b))
            boot_scores.append(scores_b[b])
            boot_props.append(self.mixer.convert_counts_to_props(subset[b]))
        self.dists_gt = exp_dists
        return ((opt_props, np.std(boot_props, axis=0)),
                (score, float(np.std(boot_scores))))

    def fit_stoichiometry_parallel(self, N_structures):
        """The reference's process-pool entry (picasso/spinna.py:3280):
        the candidates are scored by NN_scorer."""
        return [self.NN_scorer(N_structures)]


# ---------------------------------------------------------------------------
# Model comparison and labelling-efficiency fitting
# ---------------------------------------------------------------------------


def compare_models(models: list[list[Structure]], exp_data: dict,
                   granularity: int, label_unc: dict, N_sim: int = 1,
                   mask_dict: dict | None = None, width: float | None = None,
                   height: float | None = None, depth: float | None = None,
                   random_rot_mode: Literal["2D", "3D"] | None = "2D",
                   le: dict | None = None, asynch: bool = True,
                   savedir: str = "", callback=None,
                   fitting_mode: FittingMode = "coarse-to-fine",
                   device="cuda"):
    """Fit every model (structure set x label-uncertainty combination)
    and rank them by KS score (picasso/spinna.py:4181). Returns
    (best_model_idx, best_label_unc, best_score, best_props, best_mixer,
    all_scores)."""
    device = lib.resolve_device(device)
    targets_all = sorted({t for m in models for s in m for t in s.targets})
    if le is None:
        le = {"ALL": 1.0}
    unc_lists = [label_unc[t] if isinstance(label_unc[t], (list, np.ndarray))
                 else [label_unc[t]] for t in targets_all]
    best = None
    all_scores = []
    for mi, structures in enumerate(models):
        for unc_combo in it_prod(*unc_lists):
            unc = dict(zip(targets_all, unc_combo))
            mixer = StructureMixer(
                structures=structures, label_unc=unc, le=le,
                mask_dict=mask_dict, width=width, height=height, depth=depth,
                random_rot_mode=random_rot_mode)
            N_total = {t: int(len(exp_data[t])
                              / (le.get(t, le.get("ALL", 1.0))))
                       for t in mixer.targets}
            try:
                N_structures = generate_N_structures(structures, N_total,
                                                     granularity)
            except ValueError:
                continue
            spinna = SPINNA(mixer, exp_data, N_sim=N_sim, device=device)
            props, score = spinna.fit_stoichiometry(
                N_structures, fitting_mode=fitting_mode,
                callback=callback)[:2]
            all_scores.append({"model": mi, "label_unc": unc,
                               "score": score, "props": props})
            if best is None or score < best[2]:
                best = (mi, unc, score, props, mixer)
    if best is None:
        raise ValueError("No model could be fitted.")
    return (*best, all_scores)


def get_le_from_props(props, structures, targets) -> dict:
    """The labelling efficiencies (%) that fitted proportions of the
    monomer/monomer/heterodimer model give: each target's share in the
    heterodimer (JAX :1498)."""
    le = {}
    t_counts = _find_target_counts(targets, structures)
    props = np.asarray(props, np.float64)
    for i, t in enumerate(targets):
        in_het = props[-1]
        total = props @ (t_counts[i] > 0)
        le[t] = float(100 * in_het / total) if total > 0 else 0.0
    return le


def fit_le(target_a: str, target_b: str, exp_data: dict, granularity: int,
           label_unc: dict, distances: list[float], N_sim: int = 1,
           mask_dict: dict | None = None, width: float | None = None,
           height: float | None = None, depth: float | None = None,
           random_rot_mode: Literal["2D", "3D"] | None = "2D",
           asynch: bool = True, savedir: str = "", callback=None,
           fitting_mode: FittingMode = "coarse-to-fine", device="cuda"):
    """The labelling efficiency of two targets through the monomer-A /
    monomer-B / heterodimer-AB models, one heterodimer a distance
    (picasso/spinna.py:4534). Returns (le, best_label_unc,
    best_distance, best_score, best_props, best_mixer)."""
    device = lib.resolve_device(device)
    if target_a not in exp_data or target_b not in exp_data:
        raise ValueError(
            "Both target_a and target_b must be present in exp_data.")
    if target_a == target_b:
        raise ValueError("target_a and target_b must be distinct.")
    if len(distances) == 0:
        raise ValueError("distances must contain at least one value.")
    monomer_a = Structure(f"Monomer_{target_a}")
    monomer_a.define_coordinates(target_a, [0.0], [0.0], [0.0])
    monomer_b = Structure(f"Monomer_{target_b}")
    monomer_b.define_coordinates(target_b, [0.0], [0.0], [0.0])
    models = []
    for d in distances:
        het = Structure(f"Het_{target_a}_{target_b}_{float(d):.2f}nm")
        het.define_coordinates(target_a, [-float(d) / 2], [0.0], [0.0])
        het.define_coordinates(target_b, [float(d) / 2], [0.0], [0.0])
        models.append([monomer_a, monomer_b, het])
    best_mi, best_unc, best_score, best_props, best_mixer, _ = compare_models(
        models, exp_data, granularity, label_unc, N_sim=N_sim,
        mask_dict=mask_dict, width=width, height=height, depth=depth,
        random_rot_mode=random_rot_mode, le={"ALL": 1.0}, asynch=asynch,
        savedir=savedir, callback=callback, fitting_mode=fitting_mode,
        device=device)
    le_values = get_le_from_props(best_props, models[best_mi],
                                  [target_a, target_b])
    return (le_values, best_unc, distances[best_mi], best_score, best_props,
            best_mixer)


NN_COLORS = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]


def check_structures_valid_for_fitting(structures, N_total: dict) -> bool:
    """True if a search space can be generated for the structures at the
    total target counts."""
    targets = _targets_from_structures(structures)
    if len(structures) < len(targets):
        return False
    if any(t not in N_total for t in targets):
        return False
    try:
        generate_N_structures(structures, N_total, granularity=2)
        return True
    except (ValueError, np.linalg.LinAlgError):
        return False


def plot_NN(dists_exp, dists_sim, mixer, bin_size: float = 4.0, fig=None):
    """The experimental and simulated NND histograms of each target pair
    (picasso/spinna.py:499)."""
    import matplotlib.pyplot as plt

    neighbor_idx = [t for t in mixer.get_neighbor_idx() if t[2]]
    n = max(1, len(neighbor_idx))
    if fig is None:
        fig = plt.figure(figsize=(5 * n, 4))
    for i, ((t1, t2, nn), de, ds) in enumerate(
            zip(neighbor_idx, dists_exp, dists_sim)):
        ax = fig.add_subplot(1, n, i + 1)
        upper = np.percentile(de, 99) if len(de) else 100.0
        bins = np.arange(0, upper + bin_size, bin_size)
        for k in range(de.shape[1] if len(de) else 0):
            color = NN_COLORS[k % len(NN_COLORS)]
            ax.hist(de[:, k], bins=bins, density=True, alpha=0.4,
                    color=color, label=f"exp NN{k + 1}")
            if len(ds):
                hist, edges = np.histogram(ds[:, k], bins=bins, density=True)
                ax.plot((edges[:-1] + edges[1:]) / 2, hist, color=color,
                        label=f"sim NN{k + 1}")
        ax.set_xlabel("distance (nm)")
        ax.set_ylabel("density")
        ax.set_title(f"{t1} -> {t2}")
        ax.legend(fontsize=7)
    return fig


def compare_models_given_label_unc(models, exp_data, granularity,
                                   label_unc: dict, **kwargs):
    """compare_models at one label uncertainty a target (the first of a
    list; picasso/spinna.py:4367)."""
    fixed = {k: (v if not isinstance(v, (list, np.ndarray)) else v[0])
             for k, v in label_unc.items()}
    return compare_models(models, exp_data, granularity, fixed, **kwargs)


# ---------------------------------------------------------------------------
# Batch analysis from a CSV of parameters
# ---------------------------------------------------------------------------

# the strings pandas' read_csv reads as a missing value
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def _isna(value) -> bool:
    return isinstance(value, float) and np.isnan(value)


def _read_parameters(path: str) -> list[dict]:
    """The rows of a parameters CSV as dicts of strings, a missing cell
    as NaN (as pandas reads it)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [{k: (np.nan if v is None or v.strip() in _NA_STRINGS else v)
             for k, v in row.items()} for row in rows]


def _batch_targets_from_row(row: dict) -> list[str]:
    """The targets of a row's exp_data_* columns (LE-fitting rows carry
    no structures file)."""
    targets = [c[len("exp_data_"):] for c in row
               if c.startswith("exp_data_") and not _isna(row[c])]
    if len(targets) != 2:
        raise ValueError(
            f"LE fitting requires exactly two exp_data_* columns; got "
            f"{targets}.")
    return targets


def _batch_load_target_data(row: dict, targets, le_fitting):
    """Per-target experimental coordinates (nm), label uncertainties,
    LEs and simulated molecule counts of one row."""
    label_unc, le, exp_data, n_simulated, infos = {}, {}, {}, {}, {}
    dim = 2
    for t in targets:
        for col in (f"label_unc_{t}", f"exp_data_{t}"):
            if col not in row:
                raise ValueError(
                    f"Column {col} not found in the parameters file.")
        if not le_fitting and f"le_{t}" not in row:
            raise ValueError(
                f"Column le_{t} not found in the parameters file.")
        if le_fitting:
            label_unc[t] = [float(v)
                            for v in str(row[f"label_unc_{t}"]).split(",")
                            if v]
            le[t] = 1.0
        else:
            label_unc[t] = float(row[f"label_unc_{t}"])
            le[t] = float(row[f"le_{t}"]) / 100
        locs, info = io.load_locs(str(row[f"exp_data_{t}"]))
        infos[t] = info
        pixelsize = lib.get_from_metadata(info, "Pixelsize", 130)
        cols = [locs["x"] * pixelsize, locs["y"] * pixelsize]
        if "z" in locs.dtype.names:
            cols.append(locs["z"])
            dim = 3
        exp_data[t] = np.column_stack(cols)
        n_simulated[t] = (len(locs) if le_fitting
                          else int(len(locs) / le[t]))
    return label_unc, le, exp_data, n_simulated, dim, infos


def _batch_resolve_roi(row: dict, dim, targets, infos):
    """A row's ROI: a homogeneous area or volume, the metadata's area, or
    per-target density masks."""
    apply_mask = True
    area = volume = z_range = None
    mask_paths: dict = {}
    if dim == 3:
        if not _isna(row.get("volume", np.nan)):
            volume = float(row["volume"])
            apply_mask = False
            if "z_range" not in row:
                raise ValueError(
                    "3D homogeneous simulation needs a z_range column.")
            z_range = float(row["z_range"])
    else:
        if not _isna(row.get("area", np.nan)):
            area = float(row["area"])
            apply_mask = False
        elif infos:
            meta_area = lib.get_from_metadata(infos[targets[0]],
                                              "Area (um^2)")
            if meta_area is not None:
                area = float(meta_area)
                apply_mask = False
    if apply_mask:
        for t in targets:
            col = f"mask_filename_{t}"
            if _isna(row.get(col, np.nan)):
                raise ValueError(
                    f"Column {col} required (no area/volume given).")
            mask_paths[t] = str(row[col])
    return apply_mask, mask_paths, area, volume, z_range


def _batch_roi_to_mixer_kwargs(targets, apply_mask, mask_paths, dim, area,
                               volume, z_range):
    if apply_mask:
        masks, mask_infos = {}, {}
        for t in targets:
            masks[t] = np.load(mask_paths[t])
            mask_infos[t] = io.load_info(mask_paths[t])[0]
        return dict(mask_dict={"masks": masks, "infos": mask_infos},
                    width=None, height=None, depth=None)
    if dim == 2:
        side = float(np.sqrt(area * 1e6))  # um^2 -> nm side
        return dict(mask_dict=None, width=side, height=side, depth=None)
    side = float(np.sqrt(volume * 1e9 / z_range))
    return dict(mask_dict=None, width=side, height=side, depth=z_range)


def _int(value) -> int:
    return int(float(value))


def _csv_cell(value, as_float: bool) -> str:
    """A summary value as pandas' to_csv writes it."""
    if value is None:
        return ""
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (int, np.integer)) and not as_float:
        return str(int(value))
    if isinstance(value, (int, float, np.integer, np.floating)):
        return repr(float(value))
    return str(value)


def _write_summary(path: str, summary: list[dict]) -> None:
    """The summary rows as pandas' DataFrame(summary).to_csv writes them:
    the columns in order of first appearance, a missing value empty, an
    integer column with a missing value as floats."""
    columns = list(dict.fromkeys(k for row in summary for k in row))
    as_float = {c: any(c not in row for row in summary) or any(
        isinstance(row.get(c), (float, np.floating)) for row in summary)
        for c in columns}
    lib.write_csv(path, columns, ([_csv_cell(row.get(c), as_float[c])
                                   for c in columns] for row in summary))


def batch_analysis(parameters_filename: str, asynch: bool = True,
                   bootstrap: bool = False, verbose: bool = False,
                   fitting_mode: FittingMode = "bayesian",
                   device="cuda") -> list[dict]:
    """SPINNA from a CSV of parameters, one fit (or LE fit, where
    ``le_fitting`` is 1) a row, the results in a new
    ``<parameters>__fitting_results`` folder (picasso/__main__.py:2210):
    per-target ``exp_data_*``, ``label_unc_*`` and ``le_*`` columns,
    ``granularity``, ``sim_repeats``, ``save_filename``, ``NND_bin``,
    ``NND_maxdist``, the ROI by ``area``, ``volume`` + ``z_range`` or
    ``mask_filename_*`` (or the metadata's 'Area (um^2)'), and optional
    ``rotation_mode``, ``le_fitting`` and ``distances``. Returns the
    summary, one dict a row, also written as ``summary_results.csv``
    (JAX returns a DataFrame)."""
    device = lib.resolve_device(device)
    if not isinstance(parameters_filename, str):
        raise TypeError(
            "parameters_filename must be a string ending with .csv")
    if not parameters_filename.endswith(".csv"):
        raise TypeError("parameters_filename must end with .csv")
    with open(parameters_filename, newline="") as f:
        columns = next(csv.reader(f), [])
    for column in ("granularity", "save_filename", "NND_bin",
                   "NND_maxdist", "sim_repeats"):
        if column not in columns:
            raise ValueError(
                f"Column {column} not found in the parameters file.")
    parameters = _read_parameters(parameters_filename)
    base, _ = os.path.splitext(parameters_filename)
    result_dir = base + "__fitting_results"
    i = 1
    while os.path.isdir(result_dir):
        result_dir = base + f"__fitting_results_{i}"
        i += 1
    os.makedirs(result_dir)
    summary = [_batch_process_row(index, row, result_dir, asynch=asynch,
                                  bootstrap=bootstrap, verbose=verbose,
                                  fitting_mode=fitting_mode, device=device)
               for index, row in enumerate(parameters)]
    _write_summary(os.path.join(result_dir, "summary_results.csv"), summary)
    return summary


def _batch_process_row(index, row: dict, result_dir, *, asynch, bootstrap,
                       verbose, fitting_mode, device):
    granularity = _int(row["granularity"])
    sim_repeats = _int(row["sim_repeats"])
    save_base, _ = os.path.splitext(str(row["save_filename"]))
    save_filename = os.path.join(result_dir, os.path.basename(save_base))
    le_fitting = (not _isna(row.get("le_fitting", np.nan))
                  and _int(row["le_fitting"]) == 1)
    random_rot_mode = "2D"
    if isinstance(row.get("rotation_mode"), str):
        random_rot_mode = row["rotation_mode"]
        if random_rot_mode == "None":
            random_rot_mode = None

    if le_fitting:
        targets = _batch_targets_from_row(row)
        structures = None
    else:
        if _isna(row.get("structures_filename", np.nan)):
            raise ValueError(
                f"Row {index}: structures_filename is required when"
                " le_fitting != 1.")
        structures, targets = load_structures(str(row["structures_filename"]))
    label_unc, le, exp_data, n_simulated, dim, infos = (
        _batch_load_target_data(row, targets, le_fitting))
    apply_mask, mask_paths, area, volume, z_range = _batch_resolve_roi(
        row, dim, targets, infos)
    roi_kwargs = _batch_roi_to_mixer_kwargs(
        targets, apply_mask, mask_paths, dim, area, volume, z_range)

    if le_fitting:
        if _isna(row.get("distances", np.nan)):
            raise ValueError(
                f"Row {index}: distances is required when le_fitting=1.")
        distances = [float(v) for v in str(row["distances"]).split(",") if v]
        le_out, best_unc, best_d, best_score, best_props, mixer = fit_le(
            targets[0], targets[1], exp_data, granularity, label_unc,
            distances, N_sim=sim_repeats, random_rot_mode=random_rot_mode,
            asynch=asynch, fitting_mode=fitting_mode, device=device,
            **roi_kwargs)
        results = {
            "row": index,
            "le_fitting": 1,
            "targets": ",".join(targets),
            "best_distance_nm": best_d,
            "score": float(best_score),
            **{f"le_{t}": le_out[t] for t in targets},
            **{f"label_unc_{t}": (best_unc[t] if isinstance(best_unc, dict)
                                  else best_unc) for t in targets},
        }
        opt_props = best_props
    else:
        N_structures = generate_N_structures(structures, n_simulated,
                                             granularity)
        mixer = StructureMixer(structures=structures, label_unc=label_unc,
                               le=le, random_rot_mode=random_rot_mode,
                               **roi_kwargs)
        fit_out = SPINNA(mixer=mixer, gt_coords=exp_data, N_sim=sim_repeats,
                         device=device).fit_stoichiometry(
            N_structures, fitting_mode=fitting_mode,
            save=f"{save_filename}_fit_scores.csv", bootstrap=bootstrap,
            callback="console" if verbose else None)
        if bootstrap:
            (opt_props, prop_sems), (score, score_sem) = fit_out
        else:
            opt_props, score = fit_out
            prop_sems = None
        names = mixer.get_structure_names()
        results = {
            "row": index,
            "le_fitting": 0,
            "targets": ",".join(targets),
            "score": float(np.asarray(score).reshape(-1)[0]),
            **{f"prop_{n}": float(p)
               for n, p in zip(names, np.atleast_1d(opt_props))},
        }
        if prop_sems is not None:
            results.update({f"prop_sem_{n}": float(p)
                            for n, p in zip(names, np.atleast_1d(prop_sems))})

    with open(f"{save_filename}_fit_summary.txt", "w") as f:
        for key, value in results.items():
            f.write(f"{key}: {value}\n")

    # the NND overlay at the fitted proportions; as in JAX, a failed plot
    # is reported and the batch goes on
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        N_best = mixer.convert_props_to_counts(
            np.atleast_1d(opt_props), sum(n_simulated[t] for t in targets))
        dists_exp = get_NN_dist_experimental(exp_data, mixer)
        dists_sim = get_NN_dist_simulated(np.atleast_1d(N_best), sim_repeats,
                                          mixer)
        fig = plot_NN(dists_exp, dists_sim, mixer,
                      bin_size=float(row["NND_bin"]))
        fig.savefig(f"{save_filename}_NND.png", dpi=120)
        plt.close(fig)
    except Exception as exc:
        print(f"Row {index}: NND plot failed ({exc})")
    return results
