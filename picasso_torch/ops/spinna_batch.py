"""Batched SPINNA candidate scoring on a torch device.

Counterpart of picasso_tpu/ops/spinna_batch.py (_tile_budget :33,
_bucket :48, _rotations :55, BatchedScorer :96), whose scorer is one
``jax.jit`` program vmapped over candidates. Here it is two halves, each
testable alone:

- :meth:`BatchedScorer.simulate` (random): for every (candidate, repeat)
  row it places the structure centers (CSR in the ROI, or a categorical
  draw over the mask's bins and a uniform offset within the bin), rotates
  the templates, adds the label-uncertainty jitter, thins each target to
  exactly floor(n_valid * le) points (the smallest random keys, as JAX
  keeps them, :303-316) and compacts the kept points of each target to
  its pad ``P`` (:346-356), or in :meth:`BatchedScorer.score` to the
  chunk's largest kept count, known on the host from the counts (the
  padding is masked, so the width changes no score; at the cell-scale
  field it quarters the kNN's pairs);
- :meth:`BatchedScorer.score_coords` (deterministic): the masked kNN
  distances of every relevant target pair (ops/neighbors.knn_masked) and
  the KS statistic of every (pair, neighbour order) against the sorted
  experimental distances (ops/neighbors.ks_2samp_masked), averaged over
  the valid ones with JAX's conventions (:372-414): a row whose second
  target is empty adds nothing, and a candidate with nothing scored
  scores 1.0.

Pads are JAX's: each structure's count to a power of two (``_bucket``),
each target's kept points to the power of two above the search space's
largest total (``P``).

Randomness: a counter-based hash in integer torch ops, keyed by (seed,
candidate index, repeat, structure, stream) and counted by element, so
the card and the CPU draw the same 32-bit words for the same candidate
whatever the chunk. Uniforms are exact in f32; the transforms that need
transcendentals (Box-Muller normals, rotation angles, quaternions) run
in f64 and round to f32, so the two devices differ at most where a
libm's last f64 ulp crosses an f32 rounding. The stream is not
jax.random's: the batched scores agree with JAX's in distribution
(tests/test_torch_spinna.py), as JAX's agree with its serial scorer.
"""

from __future__ import annotations

import copy
import math
import threading

import numpy as np
import torch

from picasso_torch.ops.neighbors import knn_masked, ks_2samp_masked

#: b-block of the kNN distance tiles (JAX :45 takes 512; on the H100 the
#: min-extraction merge of ops/neighbors.knn_masked runs 1.6x faster at
#: 2048 than at 512 with torch.topk, 1.04x faster than at 512 without)
NN_BLOCK = 2048
#: live f32 elements of the distance tiles on the CPU (JAX's CPU budget)
CPU_TILE_BUDGET = 24_000_000
#: share of the card's free memory the distance tiles may take
CARD_MEMORY_SHARE = 0.25
MAX_CHUNK = 512

_M32 = 0xFFFFFFFF
# stream ids of the draws of one (candidate, repeat, structure): the
# centers, the mask bins, the rotations (8 streams), and per target
# number tno the jitter (2 streams) and the thinning keys
_CENTERS, _BIN, _ROTATION = 0, 1, 8


def _target_stream(tno: int, i: int) -> int:
    return 16 + 4 * tno + i


def _bucket(n: int) -> int:
    """Next power of two (>= 8), as JAX pads (:48)."""
    b = 8
    while b < n:
        b *= 2
    return b


def _tile_budget(device: torch.device) -> int:
    """Live f32 elements the distance tiles may hold: a share of the
    card's free memory (torch.cuda.mem_get_info), or JAX's CPU budget."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free * CARD_MEMORY_SHARE) // 4
    return CPU_TILE_BUDGET


# ---------------------------------------------------------------------------
# counter-based draws
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) in int64 without overflow: the
    constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of [0, 2^32) with full avalanche (C. Wellons'
    lowbias32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def row_keys(seed: int, cand: torch.Tensor, rep: torch.Tensor, si: int,
             stream: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Two 32-bit key words a row, from (seed, candidate index, repeat,
    structure, stream); ``cand`` and ``rep`` are (R,) int64."""
    k = _mix32(torch.full_like(cand, int(seed) & _M32))
    for v in (cand, rep, si, stream):
        k = _mix32(k ^ (v & _M32 if torch.is_tensor(v) else int(v) & _M32))
    return k, _mix32(k ^ 0x9E3779B9)


def words(keys, n: int) -> torch.Tensor:
    """(R, n) 32-bit words of the rows' streams: element e of a row is
    mix32(mix32(e ^ k1) + k2), distinct within the row."""
    k1, k2 = keys
    e = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    return _mix32((_mix32(e ^ k1[:, None]) + k2[:, None]) & _M32)


def uniform(keys, n: int) -> torch.Tensor:
    """(R, n) f32 uniforms in (0, 1), exact on every device: the top 24
    bits of each word and a half."""
    return ((words(keys, n) >> 8).to(torch.float32) + 0.5) * 2.0**-24


def uniform64(keys, n: int) -> torch.Tensor:
    """(R, n) f64 uniforms in (0, 1) from the whole word."""
    return (words(keys, n).to(torch.float64) + 0.5) * 2.0**-32


def normal64(keys_a, keys_b, n: int) -> torch.Tensor:
    """(R, n) f64 standard normals by Box-Muller from two streams."""
    r = torch.sqrt(-2.0 * torch.log(uniform64(keys_a, n)))
    return r * torch.cos((2 * math.pi) * uniform64(keys_b, n))


def _rotations(mode, key_fn, shape) -> torch.Tensor:
    """(R, n, 3, 3) f32 rotation matrices of the rows: in-plane for
    '2D' (one uniform angle), uniform SO(3) for '3D' (a normalized 4D
    Gaussian quaternion, as JAX :55-93), the identity for None.
    ``key_fn(stream)`` gives a stream's keys; the entries are formed in
    f64 and rounded."""
    R, n = shape
    if mode is None:
        eye = torch.eye(3, dtype=torch.float32, device=key_fn(0)[0].device)
        return eye.expand(R, n, 3, 3)
    if mode == "2D":
        ang = (2 * math.pi) * uniform64(key_fn(0), n)
        c, s = torch.cos(ang), torch.sin(ang)
        z, o = torch.zeros_like(c), torch.ones_like(c)
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    elif mode == "3D":
        q = torch.stack([normal64(key_fn(2 * i), key_fn(2 * i + 1), n)
                         for i in range(4)], -1)
        w, x, y, z = q.unbind(-1)
        norm = torch.sqrt(((w * w + x * x) + y * y) + z * z)
        w, x, y, z = w / norm, x / norm, y / norm, z / norm
        rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)]]
    else:
        raise ValueError("mode must be '2D', '3D' or None.")
    return torch.stack([torch.stack(r, -1) for r in rows], -2).to(
        torch.float32)


# ---------------------------------------------------------------------------
# the scorer
# ---------------------------------------------------------------------------


class BatchedScorer:
    """Scores SPINNA candidate stoichiometries in chunks on ``device``.

    Built once per (mixer, search-space scale, experimental distances);
    ``score(N_rows)`` evaluates any number of candidates. Mirrors
    SPINNA._evaluate_single: per-pair KS statistics averaged over target
    pairs and neighbour orders, empty pairs skipped, 1.0 when nothing
    scores.
    """

    def __init__(self, mixer, dists_gt, N_sim: int, max_counts,
                 max_points=None, device="cuda"):
        """``max_counts``: per-structure largest count over the search
        space (each structure's pad); ``max_points``: per-target largest
        total of placed points over it, which sets the pad ``P`` the kept
        points are compacted to (JAX :108-116). ``device`` is resolved by
        parallel/mesh.route: without a card, "cuda" raises, and it is
        one card however many are visible; a mesh splits :meth:`score`'s
        candidates over its shards (mesh.spinna_score_sharded), the
        scorer's tensors on its first device."""
        from picasso_torch.parallel.mesh import route

        self.device, self.mesh = route(device, spread=False)
        self._copies, self._copies_lock = {}, threading.Lock()
        self.mixer = mixer
        self.N_sim = max(1, int(N_sim))
        self.n_structures = len(mixer.structures)
        self.is_3d = mixer.roi[2] is not None or (
            mixer.mask_dict is not None
            and any(np.ndim(m) == 3
                    for m in mixer.mask_dict.get("masks", {}).values()))
        self.dim = 3 if self.is_3d else 2
        self.targets = targets = mixer.targets
        self.N_pad = [_bucket(int(c)) for c in np.maximum(max_counts, 1)]
        self.spec = []
        for structure in mixer.structures:
            le = mixer._per_target(mixer.le, structure.targets)
            unc = mixer._per_target(mixer.label_unc, structure.targets)
            mask, mask_info = mixer.extract_mask(structure)
            tmpl = {}
            for ti, t in enumerate(structure.targets):
                xyz = np.stack([np.asarray(structure.x[t], np.float64),
                                np.asarray(structure.y[t], np.float64),
                                np.asarray(structure.z[t], np.float64)],
                               axis=1).astype(np.float32)
                tmpl[t] = (torch.from_numpy(xyz).to(self.device),
                           float(le[ti]), float(unc[ti]))
            spec = {"templates": tmpl, "mask": None}
            if mask is not None:
                mask = np.asarray(mask, np.float32)
                cdf = np.cumsum(mask.ravel().astype(np.float64))
                spec.update(
                    mask=mask, cdf=torch.from_numpy(cdf / cdf[-1]).to(
                        self.device),
                    binsize=float((mask_info or {}).get("Binsize (nm)",
                                                        100.0)))
            self.spec.append(spec)

        # relevant target pairs and their sorted experimental distances
        self.pairs = []  # (pair index, order j, sorted gt (G,) f32)
        self.pair_keys = []  # (t1 index, t2 index, n) per simulated kNN
        gi = 0
        for t1, t2, n in mixer.get_neighbor_idx(duplicate=False):
            if not n:
                continue
            gt = np.asarray(dists_gt[gi], np.float32)
            gi += 1
            self.pair_keys.append((targets.index(t1), targets.index(t2), n))
            for j in range(n):
                if gt.shape[0] and j < gt.shape[1]:
                    self.pairs.append((len(self.pair_keys) - 1, j,
                                       torch.from_numpy(np.sort(gt[:, j])).to(
                                           self.device)))

        # per-target pads: the concatenation of the structures' pads and
        # the compacted width the distance tiles see
        self.P_cat = []
        for t in targets:
            p = sum(self.N_pad[si] * len(spec["templates"][t][0])
                    for si, spec in enumerate(self.spec)
                    if t in spec["templates"])
            self.P_cat.append(max(p, 1))
        if max_points is not None:
            self.P = [min(pc, _bucket(int(max(mp, 1))))
                      for pc, mp in zip(self.P_cat, max_points)]
        else:
            self.P = list(self.P_cat)
        p_max = max(self.P)
        self.block = min(NN_BLOCK, p_max)
        # ~3 live (P1, block) tiles a row through the top-k merge
        per_cand = 3 * p_max * self.block * self.N_sim
        self.chunk = int(np.clip(_tile_budget(self.device) // per_cand, 1,
                                 MAX_CHUNK))

    def on(self, device) -> "BatchedScorer":
        """This scorer's copy on ``device`` with no mesh, as a mesh's
        shard scores (made once a device, with this scorer's chunk)."""
        device = torch.device(device)
        with self._copies_lock:
            out = self._copies.get(device)
            if out is None:
                out = copy.copy(self)
                out.device, out.mesh = device, None
                out._copies, out._copies_lock = {}, threading.Lock()
                out.spec = []
                for spec in self.spec:
                    spec = dict(spec, templates={
                        t: (x.to(device), le, unc)
                        for t, (x, le, unc) in spec["templates"].items()})
                    if spec["mask"] is not None:
                        spec["cdf"] = spec["cdf"].to(device)
                    out.spec.append(spec)
                out.pairs = [(pk, j, gt.to(device))
                             for pk, j, gt in self.pairs]
                self._copies[device] = out
        return out

    # -- the random half ----------------------------------------------------
    def _simulate_structure(self, si: int, counts: torch.Tensor,
                            cand: torch.Tensor, rep: torch.Tensor,
                            seed: int) -> dict:
        """One structure's population for the rows (R,) of ``counts``
        (candidate index ``cand``, repeat ``rep``): {target: (coords (R,
        N_pad * M, 3) f32, keep (R, N_pad * M) bool)}."""
        spec = self.spec[si]
        n_pad = self.N_pad[si]
        R = counts.shape[0]
        dev = self.device

        def keys(stream):
            return row_keys(seed, cand, rep, si, stream)

        valid = torch.arange(n_pad, device=dev)[None, :] < counts[:, None]
        if spec["mask"] is not None:
            mask = spec["mask"]
            u = uniform64(keys(_BIN), n_pad)
            bins = torch.searchsorted(spec["cdf"], u, right=True).clamp_(
                max=mask.size - 1)
            sub = uniform(keys(_CENTERS), n_pad * mask.ndim).view(
                R, n_pad, mask.ndim)
            idx = []
            for size in reversed(mask.shape):  # unravel, mask (y, x[, z])
                idx.append(bins % size)
                bins = bins // size
            idx = torch.stack(idx[::-1], -1).to(torch.float32)
            pos = (idx + sub) * spec["binsize"]
            cz = (pos[..., 2] if mask.ndim == 3
                  else torch.zeros_like(pos[..., 0]))
            centers = torch.stack([pos[..., 1], pos[..., 0], cz], -1)
        else:
            width, height, depth = self.mixer.roi
            u = uniform(keys(_CENTERS), n_pad * 3).view(R, n_pad, 3)
            cx = u[..., 0] * float(width)
            cy = u[..., 1] * float(height)
            cz = ((u[..., 2] - 0.5) * float(depth) if depth is not None
                  else torch.zeros_like(cx))
            centers = torch.stack([cx, cy, cz], -1)
        rot = _rotations(self.mixer.random_rot_mode,
                         lambda s: keys(_ROTATION + s), (R, n_pad))

        out = {}
        for tno, (t, (tmpl, le, unc)) in enumerate(
                spec["templates"].items()):
            M = tmpl.shape[0]
            # rotated copies, the axes summed in a fixed order
            r = rot[:, :, None, :, :]  # (R, n, 1, 3, 3)
            pts = (r[..., 0] * tmpl[:, 0, None] + r[..., 1] * tmpl[:, 1, None]
                   + r[..., 2] * tmpl[:, 2, None])  # (R, n, M, 3)
            pts = pts + centers[:, :, None, :]
            jit = normal64(keys(_target_stream(tno, 0)),
                           keys(_target_stream(tno, 1)), n_pad * M * 3)
            pts = pts + jit.to(torch.float32).view(R, n_pad, M, 3) * float(
                max(unc, 1e-12))
            flat = pts.reshape(R, n_pad * M, 3)
            vmask = valid.repeat_interleave(M, dim=1)
            # exact-count LE thinning: keep the floor(n_valid * le)
            # smallest keys among the valid points (keys distinct a row)
            key = torch.where(vmask, words(keys(_target_stream(tno, 2)),
                                           n_pad * M), 1 << 40)
            n_valid = vmask.sum(1)
            k_keep = torch.floor(n_valid.to(torch.float32) * torch.tensor(
                le, dtype=torch.float32, device=dev))
            rank = torch.empty_like(key)
            order = torch.argsort(key, dim=1, stable=True)
            rank.scatter_(1, order, torch.arange(
                key.shape[1], device=dev).expand_as(order))
            keep = vmask & (rank < k_keep.to(torch.int64)[:, None])
            out[t] = (flat, keep)
        return out

    def kept_counts(self, counts) -> np.ndarray:
        """(B, n_targets) points each candidate keeps of each target, on
        the host: the sum over its structures of floor(n_valid * le) in
        f32, as :meth:`_simulate_structure` thins them."""
        counts = np.asarray(counts, np.int64).reshape(-1, self.n_structures)
        out = np.zeros((len(counts), len(self.targets)), np.int64)
        for si, spec in enumerate(self.spec):
            for t, (tmpl, le, _) in spec["templates"].items():
                n_valid = (counts[:, si] * len(tmpl)).astype(np.float32)
                out[:, self.targets.index(t)] += np.floor(
                    n_valid * np.float32(le)).astype(np.int64)
        return out

    def simulate(self, counts, seed: int, first: int = 0, width=None):
        """Populations of candidates ``first``.. of (B, n_structures)
        ``counts``, each repeated N_sim times: ({target: coords (B *
        N_sim, W, dim) f32}, {target: keep (B * N_sim, W) bool}); row b *
        N_sim + r is candidate first + b's repeat r. The kept points are
        compacted to W, the target's pad P, or ``width[ti]`` if that is
        less (at least the candidates' largest kept count)."""
        counts = torch.as_tensor(np.asarray(counts, np.int64),
                                 device=self.device)
        B = counts.shape[0]
        n_sim = self.N_sim
        rows = torch.arange(B * n_sim, device=self.device)
        cand, rep = first + rows // n_sim, rows % n_sim
        counts2 = counts.repeat_interleave(n_sim, dim=0)
        per_target = {t: [] for t in self.targets}
        for si in range(self.n_structures):
            sim = self._simulate_structure(si, counts2[:, si], cand, rep,
                                           seed)
            for t, cm in sim.items():
                per_target[t].append(cm)
        coords, masks = {}, {}
        for ti, t in enumerate(self.targets):
            parts = per_target[t]
            if not parts:
                coords[t] = torch.zeros((B * n_sim, 1, self.dim),
                                        device=self.device)
                masks[t] = torch.zeros((B * n_sim, 1), dtype=torch.bool,
                                       device=self.device)
                continue
            c = torch.cat([c for c, _ in parts], 1)[..., :self.dim]
            m = torch.cat([m for _, m in parts], 1)
            p_out = self.P[ti] if width is None else min(self.P[ti],
                                                         int(width[ti]))
            if c.shape[1] > p_out:
                # the kept points to the front, in order, cropped to P
                # (the slot p_out takes every other point and goes)
                slot = torch.where(m, torch.cumsum(m, 1) - 1, p_out)
                c_out = torch.zeros((c.shape[0], p_out + 1, self.dim),
                                    device=self.device)
                c_out.scatter_(1, slot[..., None].expand(-1, -1, self.dim),
                               c)
                c = c_out[:, :p_out]
                m = (torch.arange(p_out, device=self.device)[None, :]
                     < m.sum(1, keepdim=True))
            coords[t], masks[t] = c, m
        return coords, masks

    # -- the deterministic half ---------------------------------------------
    def knn_pairs(self, coords: dict, masks: dict):
        """The kNN distances (B, N_sim * P1, n) of every relevant pair and
        their rows' validity (B, N_sim * P1)."""
        knn, eff = [], []
        for i1, i2, n in self.pair_keys:
            t1, t2 = self.targets[i1], self.targets[i2]
            c1, m1, c2, m2 = coords[t1], masks[t1], coords[t2], masks[t2]
            d = knn_masked(c1, c2, m1, m2, n, exclude_self=(t1 == t2),
                           b_block=min(self.block, c2.shape[1]))
            # a repeat whose t2 population is empty adds nothing
            e = m1 & (m2.sum(1) > 0)[:, None]
            B = c1.shape[0] // self.N_sim
            knn.append(d.reshape(B, -1, n))
            eff.append(e.reshape(B, -1))
        return knn, eff

    def ks_scores(self, knn, eff, B: int) -> torch.Tensor:
        """(B,) f64: the KS statistics of every (pair, order) averaged over
        the valid ones, 1.0 where none is."""
        total = torch.zeros(B, dtype=torch.float64, device=self.device)
        n_scored = torch.zeros(B, dtype=torch.float64, device=self.device)
        for pk, j, gt_sorted in self.pairs:
            stat = ks_2samp_masked(knn[pk][:, :, j], eff[pk], gt_sorted)
            ok = eff[pk].any(1)
            total = total + torch.where(ok, stat, 0.0)
            n_scored = n_scored + ok
        return torch.where(n_scored > 0, total / n_scored.clamp(min=1), 1.0)

    def score_coords(self, coords: dict, masks: dict) -> torch.Tensor:
        """(B,) f64 scores of simulated populations (:meth:`simulate`)."""
        B = next(iter(masks.values())).shape[0] // self.N_sim
        return self.ks_scores(*self.knn_pairs(coords, masks), B)

    def score(self, N_rows, seed: int | None = None, progress=None,
              first: int = 0) -> np.ndarray:
        """Score candidates (N, n_structures) -> (N,) f64, row i drawn as
        candidate ``first`` + i. Every chunk is queued before any is read
        back; ``progress(done)`` is called as each is read. With a mesh
        the candidates split over its shards, and ``progress`` is called
        once at the end."""
        N_rows = np.asarray(N_rows, np.int64)
        if N_rows.ndim == 1:
            N_rows = N_rows.reshape(1, -1)
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        if self.mesh is not None:
            from picasso_torch.parallel.mesh import spinna_score_sharded

            out = spinna_score_sharded(self, N_rows, seed, self.mesh, first)
            if progress is not None:
                progress(len(N_rows))
            return out
        pending = []
        kept = self.kept_counts(N_rows)
        for start in range(0, len(N_rows), self.chunk):
            stop = min(start + self.chunk, len(N_rows))
            # the distance tiles as wide as the chunk's largest kept count
            width = np.maximum(kept[start:stop].max(0), 1)
            coords, masks = self.simulate(N_rows[start:stop], seed,
                                          first + start, width)
            pending.append((stop, self.score_coords(coords, masks)))
            del coords, masks
        out = np.empty(len(N_rows), np.float64)
        start = 0
        for stop, scores in pending:
            out[start:stop] = scores.cpu().numpy()
            start = stop
            if progress is not None:
                progress(stop)
        return out
