"""Device-resident localize per frame chunk: identify -> hit list ->
fused ROI cut + photon conversion + MLE or LQ fit, with only the hit
list and the fit results read back.

Counterpart of picasso_tpu/ops/fused.py (identify_cut_fit :654,
identify_cut_fit_packed :750, localize_fused :1103).
Frames upload once in their native dtype. The hit list has exactly as
many rows as hits (torch.nonzero knows the count), so there are no
padded buckets and no overflow retry, and a short last chunk is just a
shorter chunk. The fit kernel reads each spot's window from the chunk
itself, so no ROI batch is written between the stages.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Literal

import numpy as np
import torch

from picasso_torch.ops import winfit_cuda
from picasso_torch.ops.mle import _check_method
from picasso_torch.ops.identify import compact
from picasso_torch.ops.identify_cuda import identify_tiles
from picasso_torch.profiling import span

#: the loop's parts of ``perf`` that sum with ``other_s`` to ``total_s``
_LOOP_PARTS = ("decode_wait_s", "upload_dispatch_s", "chain_dispatch_s",
               "drain_s")

#: the LM fit's convergence tolerance in the fused chain (the JAX
#: package's, picasso_tpu/ops/fused.py:707)
LQ_FTOL = 1e-6

#: K5's MLE route for each method, by chip_smoke.py's alternating turns
#: on the smoke movie's dense first chunk (PERF.md): the work queue (one
#: persistent launch with lane refill, then the CRLB/LL pass) for both.
#: For sigma the queue's stragglers run cooperatively
#: (csrc/mle_queue.cuh); its turns against K2's phase schedule flip
#: between runs by a few per cent, ahead on the whole, so it keeps the
#: queue.
MLE_FITS = {"sigmaxy": winfit_cuda.fit_mle_queue_t,
            "sigma": winfit_cuda.fit_mle_queue_t}


def identify_cut_fit(frames, minimum_ng, baseline: float, factor: float,
                     *, box: int, eps: float, max_it: int,
                     method: str = "sigmaxy"):
    """One frame chunk on its device. ``method`` is ``"lq"`` (the LM fit,
    ftol :data:`LQ_FTOL`) or an MLE method (``"sigmaxy"``, ``"sigma"``).
    Returns (f, y, x, ng, theta (6, n), crlb (6, n), ll (n,), iters (n,))
    with n the hit count; for ``"lq"`` it stops after theta (the LM fit
    has no crlb, ll or iters: its precision comes from Mortensen's
    formula on the host). A chunk without hits launches no fit.

    The fit is K5, the fused cut + photon conversion + fit
    (ops/winfit_cuda.py), which reads each window straight from the
    chunk; on the CPU its plain version cuts the ROI batch first. The MLE
    fit takes the route of :data:`MLE_FITS`, the LM fit K5's work queue
    (winfit_cuda.fit_lq_queue_t); chip_smoke.py times these routes
    against each other and the gather route on the same chunk
    (PERF.md). At a box without a templated kernel (even, or above 15)
    the same calls run K4, the cut and the fit as the any-box kernels
    (identify_cuda.identify_tiles_anybox, or at boxes of 96 and above its
    direct kernel, winfit_cuda.cut_anybox_t)."""
    with span("picasso.fused.identify"):
        f, y, x, ng = compact(*identify_tiles(frames, minimum_ng, box), box)
    with span("picasso.fused.fit"):
        if method != "lq":
            return (f, y, x, ng, *MLE_FITS[method](
                frames, f, y, x, baseline, factor, box=box, eps=eps,
                max_it=max_it, method=method))
        return f, y, x, ng, winfit_cuda.fit_lq_queue_t(
            frames, f, y, x, baseline, factor, box=box, max_it=max_it,
            ftol=LQ_FTOL)


def identify_cut_fit_packed(frames, minimum_ng, baseline: float,
                            factor: float, *, box: int, eps: float,
                            max_it: int, method: str = "sigmaxy"):
    """:func:`identify_cut_fit` as one f32 payload, one readback per
    chunk: (18, n) rows [f, y, x, ng, theta(6), crlb(6), ll, iters] for
    MLE, (10, n) rows [f, y, x, ng, theta(6)] for LQ (f/y/x/iters are
    integers far below 2^24, exact in f32)."""
    out = identify_cut_fit(frames, minimum_ng, baseline, factor, box=box,
                           eps=eps, max_it=max_it, method=method)
    with span("picasso.fused.pack"):
        return torch.cat([torch.atleast_2d(r).to(torch.float32)
                          for r in out], dim=0)


def photon_factors(camera_info: dict) -> tuple[float, float]:
    """(baseline, sensitivity / gain) of a scalar camera, each rounded to
    f32 as the chain takes them."""
    return (float(np.float32(float(camera_info["Baseline"]))),
            float(np.float32(float(camera_info["Sensitivity"])
                             / float(camera_info["Gain"]))))


_IDS_DTYPE = [
    ("frame", np.int64), ("x", np.int64), ("y", np.int64),
    ("net_gradient", np.float32),
]


def make_ids(hits, roi=None) -> np.ndarray:
    """The identifications (structured, :data:`_IDS_DTYPE`) of per-chunk
    hit rows ``[(first_frame, f, y, x, ng), ...]`` (numpy, f relative to
    the chunk), in chunk order; y/x shifted back by the ``roi``'s
    corner."""
    n = sum(len(h[1]) for h in hits)
    ids = np.empty(n, dtype=_IDS_DTYPE)
    if not n:
        return ids
    ids["frame"] = np.concatenate(
        [np.asarray(h[1]).astype(np.int64) + h[0] for h in hits])
    for name, k in (("y", 2), ("x", 3), ("net_gradient", 4)):
        ids[name] = np.concatenate([h[k] for h in hits])
    if roi is not None:
        ids["y"] += roi[0][0]
        ids["x"] += roi[0][1]
    return ids


def localize_fused(
    movie,
    minimum_ng: float,
    box: int,
    camera_info: dict,
    *,
    fitting_method: Literal["gausslq", "gausslq-gpu", "gaussmle"] = "gaussmle",
    eps: float = 0.001,
    max_it: int = 100,
    mle_method: Literal["sigma", "sigmaxy"] = "sigmaxy",
    roi: tuple[tuple[int, int], tuple[int, int]] | None = None,
    frame_bounds: tuple[int, int] | None = None,
    frame_chunk: int | None = None,
    prefetch_depth: int = 2,
    progress_callback: Callable[[int], None] | Literal["console"] | None = None,
    abort_callback: Callable[[], bool] | None = None,
    perf: dict | None = None,
    device="cuda",
):
    """Localize a (possibly lazy) movie chunk by chunk on ``device``.

    A background thread decodes up to ``prefetch_depth`` chunks of
    ``frame_chunk`` frames (stream.frame_chunk_for's by default) ahead
    while the device works on the current one (stream.device_chunks).
    Returns ``(identifications, (theta, crlb, ll, iters))``:
    identifications a structured array (frame, x, y, net_gradient),
    theta/crlb (n, 6), rows aligned; ``(None, None)`` if
    ``abort_callback()``, polled before each chunk, turns true. ``perf``,
    where given, gets the JAX package's wall split of the loop
    (picasso_tpu/ops/fused.py:1308-1321): ``n_chunks``, ``frame_chunk``,
    the seconds waiting for decoded chunks (``decode_wait_s``), uploading
    them (``upload_dispatch_s``), issuing the chain (``chain_dispatch_s``),
    reading its results back (``drain_s``, the blocking readback on a
    card), the rest (``other_s``) and ``total_s``, and the bytes of
    frames uploaded (``upload_bytes``). Each part is its span's host
    time (profiling.span): ``picasso.stream.decode_wait``, ``picasso.
    stream.upload``, ``picasso.fused.chain`` (or ``.mesh_chain``) and
    ``picasso.fused.drain``; after the loop, ``picasso.localize.gather``
    holds the concatenation of the payloads into the returned arrays.

    ``device`` may be a mesh (picasso_torch.parallel.mesh.Mesh), and
    ``"cuda"`` with several cards visible is :func:`~picasso_torch.
    parallel.mesh.default_mesh` (``"cuda:N"`` pins one card): each
    chunk's frames then split over the shards, which upload their part
    and run the chain on their device (mesh.fused_chain_program); the
    shards' uploads, chains and readbacks count as ``chain_dispatch_s``
    and the gathering of their hits as ``drain_s``."""
    from picasso_torch.parallel.mesh import fused_chain_program, route
    from picasso_torch.stream import device_chunks

    if fitting_method in ("gausslq", "gausslq-gpu"):
        method = "lq"
    elif fitting_method == "gaussmle":
        _check_method(mle_method)
        method = mle_method
    else:
        raise ValueError(f"no fused chain for {fitting_method!r}")
    device, mesh = route(device)
    baseline, factor = photon_factors(camera_info)
    blocks = []
    loop = None if perf is None else {}
    t_run0 = time.perf_counter()
    with contextlib.closing(device_chunks(
            movie, device if mesh is None else None, roi=roi,
            frame_bounds=frame_bounds, frame_chunk=frame_chunk,
            prefetch_depth=prefetch_depth,
            progress_callback=progress_callback, description="Localizing",
            perf=loop)) as chunks:
        for offset, chunk in chunks:
            if abort_callback is not None and abort_callback():
                return None, None
            if mesh is None:
                with span("picasso.fused.chain", loop, "chain_dispatch_s"):
                    packed = identify_cut_fit_packed(
                        chunk, minimum_ng, baseline, factor, box=box,
                        eps=eps, max_it=max_it, method=method)
                with span("picasso.fused.drain", loop, "drain_s"):
                    packed = packed.cpu().numpy()
            else:
                per_dev = -(-len(chunk) // mesh.size)
                with span("picasso.fused.mesh_chain", loop,
                          "chain_dispatch_s"):
                    packed = fused_chain_program(
                        mesh, per_dev, box, 0, eps, max_it, method)(
                            chunk, minimum_ng, baseline, factor)
                with span("picasso.fused.drain", loop, "drain_s"):
                    packed = np.concatenate(packed, axis=1)
            blocks.append((offset, packed))
    if loop:
        total = time.perf_counter() - t_run0
        parts = {k: loop.get(k, 0.0) for k in _LOOP_PARTS}
        perf.update(n_chunks=loop["n_chunks"],
                    frame_chunk=loop["frame_chunk"],
                    **{k: round(v, 3) for k, v in parts.items()},
                    other_s=round(total - sum(parts.values()), 3),
                    total_s=round(total, 3),
                    upload_bytes=loop["upload_bytes"])
    with span("picasso.localize.gather"):
        rows = 10 if method == "lq" else 18
        block = np.concatenate([np.zeros((rows, 0), np.float32)]
                               + [p for _, p in blocks], axis=1)
        ids = make_ids([(off, p[0], p[1], p[2], p[3]) for off, p in blocks],
                       roi)
        n = block.shape[1]
        if method == "lq":
            # the JAX package's LQ tuple: crlb, ll and iters are zeros
            return ids, (block[4:10].T.copy(), np.zeros((n, 6), np.float32),
                         np.zeros(n, np.float32), np.zeros(n, np.int32))
        return ids, (
            block[4:10].T.copy(), block[10:16].T.copy(), block[16].copy(),
            block[17].astype(np.int32),
        )
