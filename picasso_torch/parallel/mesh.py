"""Several devices of one process: the localization pipeline's batches
split over a mesh of shards.

Counterpart of picasso_tpu/parallel/mesh.py (default_mesh :23,
fit_mle_sharded :40, render_hist_sharded :80, sharded_pipeline_step
:123, fit_lq_sharded :194, pair_xcorrs_sharded :226,
spinna_score_sharded :275, fit_g5m_clusters_sharded :318,
fused_chain_program :386, localize_fused_sharded :467,
identify_sharded :553). JAX runs one program over a device mesh from one
controller; here a :class:`Mesh` is a tuple of torch devices, one shard
each, and :meth:`Mesh.run` calls a function once a shard, each on a host
thread of its own under the shard's device (on its current stream).
Threads, not a loop: the hit compaction (ops/identify.compact) waits on
the host for ``torch.nonzero``'s count, so a loop would run the cards
one after another. The shards of one device take turns (a lock a
device). There is no process group and no NCCL.

A device may appear more than once in a mesh, each entry a shard:
``Mesh(["cpu"] * 8)`` drives the code as JAX's 8 virtual CPU devices
do, ``Mesh(["cuda:0"] * 4)`` drives it on one card.

Batches split as JAX's shards do, ``ceil(n / size)`` rows a shard in
shard order, the last shards shorter or empty (no compile cache needs
equal shapes, so nothing is padded but where JAX's fit padding is kept).
Each shard runs the route its batch takes on its device alone: the
kernels on a card, their plain versions on the CPU. Nothing reduces
across shards but the render histograms (JAX's psum), which are summed
on the first device in shard order, so the sum is deterministic (the
counts are exact in f32 below 2^24). A failure in a shard is raised in
the caller; no shard is retried on another device or on the CPU.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from picasso_torch import _build, lib

AXIS_NAME = "spots"
#: the shards of one device take turns (one lock a device): on the CPU
#: torch's kernels already use every core, and its thread pools called
#: from several threads at once run many times slower; on a card the
#: shards' host threads would contend for the GIL, op by op, for no
#: device time gained (SPINNA's scorer on 4 logical shards of one card:
#: 8.84 s at once, 1.44 s in turns, tests/torch_mesh_sweep.py, PERF.md)
_DEVICE_LOCKS: dict = {}
_DEVICE_LOCKS_LOCK = threading.Lock()


def _device_lock(device: torch.device) -> threading.Lock:
    with _DEVICE_LOCKS_LOCK:
        return _DEVICE_LOCKS.setdefault(device, threading.Lock())


class Mesh:
    """A 1D mesh of shards, one torch device each (repeats allowed),
    with the axis name ``"spots"`` of JAX's mesh. ``launches[i]`` counts
    the kernel launches of shard ``i`` by wrapper
    ({"module.wrapper": n}, _build.tally) over every :meth:`run`."""

    axis_names = (AXIS_NAME,)

    def __init__(self, devices):
        devices = [lib.resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devices)
        self.launches = [{} for _ in self.devices]
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]!r})"

    def reset_launches(self) -> None:
        self.launches = [{} for _ in self.devices]

    def _call(self, i: int, fn, args):
        dev = self.devices[i]
        with _build.tally() as counts, _device_lock(dev):
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    out = fn(i, *args)
                    torch.cuda.current_stream(dev).synchronize()
            else:
                out = fn(i, *args)
        with self._lock:
            for key, n in counts.items():
                self.launches[i][key] = self.launches[i].get(key, 0) + n
        return out

    def run(self, fn, *per_shard):
        """``fn(i, *args_i)`` for every shard ``i``, ``args_i`` the i-th
        entries of ``per_shard``; returns the results in shard order.
        Each call runs on a worker thread under its shard's device, on
        that device's current stream, after the work the caller queued
        on the default streams (the shards of one device in turns, those
        of different devices at once), and is synchronized before the
        call returns, so tensors it returns are ready. The first shard's
        exception, if any, is raised after every shard has ended."""
        args = list(zip(*per_shard)) if per_shard else [()] * self.size
        if len(args) != self.size:
            raise ValueError(f"{len(args)} shard arguments for {self.size} "
                             "shards")
        with ThreadPoolExecutor(self.size,
                                thread_name_prefix="picasso-mesh") as pool:
            futures = [pool.submit(self._call, i, fn, a)
                       for i, a in enumerate(args)]
        for fut in futures:
            if fut.exception() is not None:
                raise fut.exception()
        return [fut.result() for fut in futures]


def default_mesh(devices=None) -> Mesh:
    """1D mesh over ``devices``, by default every visible card
    (``cuda:0`` ... ``cuda:{device_count() - 1}``); without a card the
    default raises, as lib.resolve_device does."""
    if devices is None:
        lib.resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def route(device, spread: bool = True) -> tuple[torch.device, Mesh | None]:
    """The device and mesh a caller's ``device`` argument names: a
    :class:`Mesh` as given (its first device for the work that is not
    split); ``"cuda"`` without an index, with more than one card visible
    and ``spread``, :func:`default_mesh`; anything else that one device
    and no mesh (``"cuda:N"`` pins card N). The callers whose time is on
    the device (the fused localize, RCC's pair correlations) spread;
    the launch-bound SPINNA scorer and G5M EM do not (``spread=False``:
    their shards' host threads contend for the GIL, and no run has shown
    them faster across cards), so they split only over a mesh given."""
    if isinstance(device, Mesh):
        return device.devices[0], device
    dev = lib.resolve_device(device)
    if (spread and dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() > 1):
        return dev, default_mesh()
    return dev, None


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _split(n: int, size: int) -> list[tuple[int, int]]:
    """[lo, hi) rows of each shard: ceil(n / size) rows a shard in order,
    as JAX's shards of the padded batch, the last ones shorter or
    empty."""
    per = -(-max(n, 1) // size)
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(size)]


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: to a card from pinned memory without
    blocking (on the current stream), on the CPU as it is."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _mesh(mesh: Mesh | None) -> Mesh:
    return default_mesh() if mesh is None else mesh


# ---------------------------------------------------------------------------
# spot-sharded fits
# ---------------------------------------------------------------------------


def _spot_shards(spots: np.ndarray, mesh: Mesh):
    """JAX's padding of a spot batch: up to a multiple of 8 x size with
    spots of ones, then equal shards; returns (padded, bounds)."""
    n = len(spots)
    spots = np.asarray(spots, np.float32)
    padded_n = _pad_to(max(n, 1), 8 * mesh.size)
    if padded_n != n:
        spots = np.concatenate(
            [spots, np.ones((padded_n - n, *spots.shape[1:]), np.float32)])
    return spots, _split(padded_n, mesh.size)


def _lanes_last(spots: np.ndarray, device) -> torch.Tensor:
    return upload(spots, device).permute(1, 2, 0).contiguous()


def fit_mle_sharded(spots: np.ndarray, eps: float = 0.001, max_it: int = 100,
                    method: str = "sigmaxy", mesh: Mesh | None = None):
    """MLE fit of (N, S, S) spots with the batch split over the mesh
    (padded with spots of ones to a multiple of 8 x size, as JAX). Each
    shard takes the route of a ROI batch on its device
    (ops/mle_cuda.ROI_FITS[method]: K2's phases for sigmaxy, K1 for
    sigma on a card, the plain fit on the CPU). Returns numpy (thetas (N,
    6), CRLBs (N, 6), log-likelihoods (N,), iterations (N,))."""
    from picasso_torch.ops import mle_cuda
    from picasso_torch.ops.mle import _check_method

    _check_method(method)
    mesh = _mesh(mesh)
    n = len(spots)
    spots, bounds = _spot_shards(spots, mesh)

    def shard(i, lo, hi):
        t = _lanes_last(spots[lo:hi], mesh.devices[i])
        fit = mle_cuda.ROI_FITS[method](t, eps, max_it, method)
        return [a.cpu().numpy() for a in fit]

    parts = mesh.run(shard, *zip(*bounds))
    theta, crlb, ll, iters = (np.concatenate(a, axis=-1) for a in zip(*parts))
    return theta.T[:n].copy(), crlb.T[:n].copy(), ll[:n], iters[:n]


def fit_lq_sharded(spots: np.ndarray, max_it: int = 30, ftol: float = 1e-6,
                   mesh: Mesh | None = None) -> np.ndarray:
    """LM fit of (N, S, S) spots with the batch split over the mesh
    (JAX's padding); each shard on the route of a ROI batch on its device
    (ops/lq_cuda.ROI_FIT: K3's work queue on a card, the plain fit on the
    CPU). Returns theta (N, 6), x/y relative to the box centre."""
    from picasso_torch.ops import lq_cuda

    mesh = _mesh(mesh)
    n = len(spots)
    spots, bounds = _spot_shards(spots, mesh)

    def shard(i, lo, hi):
        t = _lanes_last(spots[lo:hi], mesh.devices[i])
        return lq_cuda.ROI_FIT(t, max_it, ftol).cpu().numpy()

    return np.concatenate(mesh.run(shard, *zip(*bounds)), axis=-1).T[:n].copy()


# ---------------------------------------------------------------------------
# histograms: the one reduction across shards
# ---------------------------------------------------------------------------


def _hist(xs: torch.Tensor, ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(H * W,) f32 counts of floor(x), floor(y) in the (H, W) grid."""
    xi = torch.floor(xs).to(torch.int64)
    yi = torch.floor(ys).to(torch.int64)
    ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    flat = torch.where(ok, yi * W + xi, H * W)  # the overflow bin
    return torch.bincount(flat, minlength=H * W + 1)[:H * W].to(torch.float32)


def _reduce(mesh: Mesh, parts) -> np.ndarray:
    """JAX's psum: the shards' partial images summed on the first device
    in shard order, read back once."""
    dev = mesh.devices[0]
    total = parts[0].to(dev).clone()
    for p in parts[1:]:
        total += p.to(dev)
    return total.cpu().numpy()


def render_hist_sharded(x: np.ndarray, y: np.ndarray, shape: tuple[int, int],
                        mesh: Mesh | None = None) -> np.ndarray:
    """2D histogram (floor bins of an (H, W) grid, locs outside dropped)
    of f32 coordinates with the locs split over the mesh and the
    shards' images summed in shard order. Returns (H, W) f32."""
    mesh = _mesh(mesh)
    H, W = shape
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)

    def shard(i, lo, hi):
        dev = mesh.devices[i]
        return _hist(upload(x[lo:hi], dev), upload(y[lo:hi], dev), H, W)

    parts = mesh.run(shard, *zip(*_split(len(x), mesh.size)))
    return _reduce(mesh, parts).reshape(H, W)


SPOTS_PER_FRAME = 4


def _top_maxima(frames: torch.Tensor, box: int, k: int):
    """(y, x) (B, k) of each frame's k largest ``where(maxima, ng, -inf)``
    pixels in JAX's top_k order: descending, ties (the -inf pixels a frame
    with fewer than k maxima fills up with) by pixel index. The maxima
    and their ng come from the identify kernel (K4) at threshold -inf."""
    from picasso_torch.ops.identify import compact
    from picasso_torch.ops.identify_cuda import identify_tiles

    B, Y, X = frames.shape
    f, yy, xx, ng = compact(*identify_tiles(frames, float("-inf"), box), box)
    score = torch.full((B, Y * X), float("-inf"), device=frames.device)
    score[f, yy * X + xx] = ng
    idx = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    return idx // X, idx % X


def sharded_pipeline_step(frames: np.ndarray, box: int, eps: float = 0.001,
                          max_it: int = 20, mesh: Mesh | None = None):
    """One sharded pipeline step: frames split over the mesh; each shard
    finds the top 4 maxima of each frame by net gradient (K4), cuts their
    (box, box) ROIs (centres clipped into the frame) and fits them
    (ops/mle_cuda.ROI_FITS["sigmaxy"]: K2 on a card), and the fitted
    positions' (box, box) histograms are summed over the shards. Returns
    (theta (B * 4, 6), histogram (box, box)), numpy f32."""
    from picasso_torch.ops import mle_cuda
    from picasso_torch.ops.winfit_cuda import cut_rois_t

    mesh = _mesh(mesh)
    frames = np.asarray(frames, np.float32)
    k, half = SPOTS_PER_FRAME, box // 2

    def shard(i, lo, hi):
        dev = mesh.devices[i]
        if hi <= lo:
            return (np.zeros((0, 6), np.float32),
                    torch.zeros(box * box, device=dev))
        t = upload(frames[lo:hi], dev)
        nb, ny, nx = t.shape
        yy, xx = _top_maxima(t, box, k)
        yy = yy.clamp(half, ny - half - 1).reshape(-1)
        xx = xx.clamp(half, nx - half - 1).reshape(-1)
        ff = torch.arange(nb, device=dev).repeat_interleave(k)
        rois = cut_rois_t(t, ff, yy, xx, box).contiguous()
        theta = mle_cuda.ROI_FITS["sigmaxy"](rois, eps, max_it, "sigmaxy")[0]
        # NaN positions bin at 0, as XLA converts NaN to the int 0
        pos = torch.nan_to_num(torch.floor(theta[:2]), nan=0.0).clamp(
            0, box - 1).to(torch.int64)
        img = torch.bincount(pos[1] * box + pos[0],
                             minlength=box * box).to(torch.float32)
        return theta.T.cpu().numpy(), img

    parts = mesh.run(shard, *zip(*_split(len(frames), mesh.size)))
    theta = np.concatenate([p[0] for p in parts])
    return theta, _reduce(mesh, [p[1] for p in parts]).reshape(box, box)


# ---------------------------------------------------------------------------
# RCC pair correlations, SPINNA candidates, G5M clusters
# ---------------------------------------------------------------------------


def pair_xcorrs_crops(segments, pairs_i, pairs_j, mesh: Mesh,
                      offsets=(0, 0)) -> np.ndarray:
    """imageprocess.xcorr_pairs with the pairs split over the mesh: each
    shard FFTs the (n, Y, X) segments (a tensor on any device, or an
    array) once on its device and correlates its pairs there; returns the
    crops (n_pairs, Y - 2 Y_, X - 2 X_) f64 of ``offsets`` (Y_, X_) in
    pair order."""
    from picasso_torch.imageprocess import xcorr_pairs

    seg = segments if isinstance(segments, torch.Tensor) else (
        torch.from_numpy(np.ascontiguousarray(segments, np.float32)))
    ii, jj = np.asarray(pairs_i, np.int64), np.asarray(pairs_j, np.int64)
    _, Y, X = seg.shape
    Y_, X_ = offsets

    def shard(i, lo, hi):
        if hi <= lo:
            return np.zeros((0, Y - 2 * Y_, X - 2 * X_))
        dev = mesh.devices[i]
        src = upload(seg.numpy(), dev) if seg.device.type == "cpu" else seg
        F = torch.fft.fft2(src.to(dev, torch.float64))
        return xcorr_pairs(F, ii[lo:hi], jj[lo:hi], offsets)

    return np.concatenate(mesh.run(shard, *zip(*_split(len(ii), mesh.size))))


def pair_xcorrs_sharded(segments, pairs_i, pairs_j,
                        mesh: Mesh | None = None) -> np.ndarray:
    """Cross-correlation maps fftshift(Re(ifft2(F_i conj(F_j)))) /
    sqrt(Y X) of segment pairs for RCC, the pairs split over the mesh
    (the segments' FFTs made once on each shard, in f64 as
    imageprocess.pair_xcorrs). Returns (n_pairs, Y, X) f64."""
    return pair_xcorrs_crops(segments, pairs_i, pairs_j, _mesh(mesh))


def spinna_score_sharded(scorer, N_rows: np.ndarray, seed: int | None = None,
                         mesh: Mesh | None = None,
                         first: int = 0) -> np.ndarray:
    """Scores of SPINNA candidates (N, n_structures) with the candidate
    axis split over the mesh: each shard scores its rows with the
    scorer's copy on its device (ops/spinna_batch.BatchedScorer.on; the
    shards of a device take turns, so each has the device's tile
    budget), drawing by the global candidate index (``first`` + row), so
    the scores equal the unsharded ones bit for bit. Returns (N,) f64."""
    mesh = _mesh(mesh)
    N_rows = np.asarray(N_rows, np.int64)
    if N_rows.ndim == 1:
        N_rows = N_rows.reshape(1, -1)
    if seed is None:
        seed = int(np.random.randint(0, 2**31 - 1))

    def shard(i, lo, hi):
        if hi <= lo:
            return np.zeros(0, np.float64)
        return scorer.on(mesh.devices[i]).score(N_rows[lo:hi], seed,
                                                first=first + lo)

    return np.concatenate(mesh.run(shard, *zip(*_split(len(N_rows),
                                                       mesh.size))))


def g5m_shards(X, mask, lp, u, *, K: int, sigma_bounds, isotropic: bool,
               loc_local: bool, min_locs: int, mesh: Mesh, bic: bool = False,
               stats: dict | None = None):
    """ops/gmm.fit_g5m_batched (and, with ``bic``, gmm.bic_batched of the
    fit) with the cluster axis split over the mesh; X, mask, lp host
    arrays, u (n_init, G, K) uniforms by global cluster index. Returns
    the fit's eight numpy arrays (+ the BICs). ``stats`` gains the
    shards' step counts summed and gets their per-cluster records
    (numpy) in cluster order."""
    from picasso_torch.ops import gmm

    u = np.asarray(u, np.float64)

    def shard(i, lo, hi):
        if hi <= lo:
            return None
        dev = mesh.devices[i]
        Xd, md, ld = (upload(a[lo:hi], dev) for a in (X, mask, lp))
        st = {} if stats is not None else None
        out = gmm.fit_g5m_batched(
            Xd, md, ld, upload(u[:, lo:hi], dev), K=K,
            sigma_bounds=tuple(sigma_bounds), isotropic=isotropic,
            loc_local=loc_local, min_locs=min_locs, stats=st)
        if bic:
            w, m, _, pc, _, _, valid, _ = out
            out = (*out, gmm.bic_batched(Xd, md, w, m, pc, valid, isotropic))
        return [a.cpu().numpy() for a in out], (
            None if st is None else {k: v.cpu().numpy() if torch.is_tensor(v)
                                     else v for k, v in st.items()})

    parts = [p for p in mesh.run(shard, *zip(*_split(len(X), mesh.size)))
             if p is not None]
    if stats is not None:
        rows: dict = {}
        for _, st in parts:
            for key, v in st.items():
                if key in ("steps", "row_steps"):
                    stats[key] = stats.get(key, 0) + v
                else:
                    rows.setdefault(key, []).append(v)
        stats.update({k: np.concatenate(v) for k, v in rows.items()})
    return tuple(np.concatenate(a) for a in zip(*(p[0] for p in parts)))


def fit_g5m_clusters_sharded(X: np.ndarray, mask: np.ndarray, lp: np.ndarray,
                             u: np.ndarray | None = None, *, K: int,
                             sigma_bounds, isotropic: bool = True,
                             loc_local: bool = False, n_init: int = 1,
                             min_locs: int = 4, mesh: Mesh | None = None):
    """Batched G5M EM (ops/gmm.fit_g5m_batched) with the cluster axis
    split over the mesh. Inputs as fit_g5m_batched's: X (G, P, D), mask
    (G, P), lp (G, P) or (G, P, D); ``u`` (n_init, G, K) kmeans++
    uniforms in [0, 1) in place of JAX's key, by default
    ops/gmm.kmeans_uniforms (seed 0). Each shard takes the uniforms of its
    clusters' global indices, so the fits equal the unsharded ones bit
    for bit. Returns numpy (weights, means, cov, prec, lower_bound,
    converged, valid, ok), leading axis G."""
    from picasso_torch.ops import gmm

    X = np.asarray(X, np.float32)
    if u is None:
        u = gmm.kmeans_uniforms(len(X), K, n_init, 0)
    return g5m_shards(X, np.asarray(mask, bool), np.asarray(lp, np.float32),
                      u, K=K, sigma_bounds=sigma_bounds, isotropic=isotropic,
                      loc_local=loc_local, min_locs=min_locs,
                      mesh=_mesh(mesh))


# ---------------------------------------------------------------------------
# frame-sharded identify and the fused chain
# ---------------------------------------------------------------------------


def fused_chain_program(mesh: Mesh, per_dev: int, box: int, size: int,
                        eps: float, max_it: int, method: str,
                        use_pallas: bool = False,
                        pallas_interpret: bool = False):
    """The per-shard fused chain that :func:`localize_fused_sharded` and
    ops/fused.localize_fused over a mesh share: ``prog(frames, ng_thresh,
    baseline, factor)`` splits the (B, Y, X) host frames into shards of
    ``per_dev`` frames (the last shorter or empty), and each shard
    uploads its frames and runs K4 -> compact -> K5
    (ops/fused.identify_cut_fit_packed) on its device. Returns, a shard,
    the packed (rows, n) f32 hit rows [f, y, x, ng, theta, (crlb, ll,
    iters)] with f the frame in ``frames``. The hit lists have exactly as
    many rows as hits, so ``size`` (JAX's bucket), ``use_pallas`` and
    ``pallas_interpret`` are accepted and change nothing."""
    from picasso_torch.ops.fused import identify_cut_fit_packed
    from picasso_torch.ops.identify import host_frames

    rows = 10 if method == "lq" else 18

    def prog(frames, ng_thresh, baseline, factor):
        n = len(frames)
        bounds = [(min(i * per_dev, n), min((i + 1) * per_dev, n))
                  for i in range(mesh.size)]

        def shard(i, lo, hi):
            if hi <= lo:
                return np.zeros((rows, 0), np.float32)
            chunk = upload(host_frames(frames[lo:hi]), mesh.devices[i])
            out = identify_cut_fit_packed(
                chunk, ng_thresh, baseline, factor, box=box, eps=eps,
                max_it=max_it, method=method).cpu().numpy()
            out[0] += lo
            return out

        return mesh.run(shard, *zip(*bounds))

    return prog


def localize_fused_sharded(frames: np.ndarray, minimum_ng: float, box: int,
                           camera_info: dict, mesh: Mesh | None = None,
                           bucket: int = 4096, method: str = "lq",
                           eps: float = 1e-3, max_it: int = 100,
                           use_pallas: bool = False,
                           pallas_interpret: bool = False):
    """The fused identify + cut + fit chain with the frames split over
    the mesh (:func:`fused_chain_program`). ``method`` is ``"lq"`` or an
    MLE method. Returns flat frame-sorted numpy arrays (frame, y, x,
    net_gradient, theta (N, 6), crlb (N, 6), ll, iterations); LQ's crlb,
    ll and iterations are zeros (as ops/fused.localize_fused). Equal bit
    for bit to the unsharded chain on each device."""
    mesh = _mesh(mesh)
    frames = np.asarray(frames)
    per_dev = -(-max(len(frames), 1) // mesh.size)
    prog = fused_chain_program(mesh, per_dev, box, bucket, eps, max_it,
                               method, use_pallas, pallas_interpret)
    from picasso_torch.ops.fused import photon_factors

    baseline, factor = photon_factors(camera_info)
    block = np.concatenate(prog(frames, minimum_ng, baseline, factor), axis=1)
    n = block.shape[1]
    f, y, x = (block[k].astype(np.int64) for k in range(3))
    theta = block[4:10].T.copy()
    if method == "lq":
        return (f, y, x, block[3].copy(), theta, np.zeros((n, 6), np.float32),
                np.zeros(n, np.float32), np.zeros(n, np.int32))
    return (f, y, x, block[3].copy(), theta, block[10:16].T.copy(),
            block[16].copy(), block[17].astype(np.int32))


def identify_sharded(frames: np.ndarray, minimum_ng: float, box: int,
                     mesh: Mesh | None = None, bucket: int = 4096):
    """Spot identification (K4 -> compact) with the frames split over the
    mesh. Returns flat frame-sorted numpy (frame, y, x, net_gradient),
    equal to ops/identify.identify_frames; ``bucket`` is accepted and
    changes nothing."""
    from picasso_torch.ops.identify import compact, host_frames
    from picasso_torch.ops.identify_cuda import identify_tiles

    mesh = _mesh(mesh)
    frames = np.asarray(frames)

    def shard(i, lo, hi):
        if hi <= lo:
            return np.zeros((4, 0), np.float32)
        chunk = upload(host_frames(frames[lo:hi]), mesh.devices[i])
        hits = compact(*identify_tiles(chunk, minimum_ng, box), box)
        out = torch.stack([h.to(torch.float32) for h in hits]).cpu().numpy()
        out[0] += lo
        return out

    block = np.concatenate(
        mesh.run(shard, *zip(*_split(len(frames), mesh.size))), axis=1)
    f, y, x = (block[k].astype(np.int64) for k in range(3))
    return f, y, x, block[3].copy()
