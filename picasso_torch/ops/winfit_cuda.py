"""K5, the fused ROI cut + photon conversion + fit, for the MLE fit
(methods ``sigmaxy`` and ``sigma``: the work-queue kernel
csrc/winfit_mle_queue.cu + winfit_mle_queue_f32.cu, and the single-pass
and phase modes of csrc/winfit_mle.cu + winfit_mle_f32.cu) and the LM
fit (the work-queue kernel csrc/winfit_lq_queue.cu +
winfit_lq_queue_f32.cu), and its plain version, the gather route: cut the (S, S, N) ROI batch out of
the chunk, convert it to photons, fit it.

Counterpart of picasso_tpu/ops/winfit_pallas.py (fit_mle_t :186,
fit_lq_t :140) together with the window gather that feeds it
(picasso_tpu/ops/fused.gather_wincols :609). The kernels take the
uploaded (B, Y, X) chunk in its own dtype (u16 or f32,
ops/identify.upload_frames) and the hit list (f, y, x), not a ROI batch:
each thread loads its window from the chunk itself. A CUDA chunk
launches the kernel or raises; a CPU chunk takes the gather route.
Nothing here falls back from one to the other.

The chain (ops/fused.identify_cut_fit, MLE_FITS) fits both methods
through :func:`fit_mle_queue_t` (one persistent launch in which a lane
whose spot has converged takes the next hit, and, for sigma, a drained
warp's lanes run its last spots in groups; then one CRLB/LL pass), the
faster on the card (PERF.md). :func:`fit_mle_boundary_t` (K2's phase
schedule run on K5) and :func:`fit_mle_t` (one pass, one thread per
spot) are off the main path; chip_smoke.py holds all three against each
other. The LM fit is
:func:`fit_lq_queue_t` (one persistent launch with lane refill and a
cooperative straggler tail), equal to K3 (ops/lq_cuda.fit_t) on the
gather route's ROIs bit for bit.

A hit's window starts box // 2 pixels before its centre, so at an even
box it ends box // 2 - 1 after it (:func:`cut_rois_t`). The kernels
above take the boxes of ``_fit_common.BOXES``; on the card every other
box >= 1 is cut by :func:`cut_anybox_t` (csrc/cut_anybox.cu: the same
clamp and photon conversion, the box a launch argument, a block a tile
of hits written lanes-last through shared memory; its first form, one
thread a pixel, is :func:`cut_anybox_direct_t`, on no path) and fitted
by the any-box kernels (ops/mle_cuda.fit_anybox_t,
ops/lq_cuda.fit_anybox_t), whichever of the fits is called.

Launch counts (plain integers): ``fit_mle_queue_t.launches`` counts the
queue kernel's launches and its CRLB/LL pass (2 a fit),
``fit_mle_t.launches`` the MLE kernel's single-pass (FULL) launches,
``fit_mle_boundary_t.launches`` its phase launches,
``fit_lq_queue_t.launches`` the LM queue kernel's (1 a fit),
``cut_anybox_t.launches`` the any-box cut's (1 a fit at such a box,
whichever fit routed to it; its fit counts on the any-box fit's own
counter), ``cut_anybox_direct_t.launches`` its first form's.
"""

from __future__ import annotations

import ctypes

import torch

from picasso_torch import _build
from picasso_torch.ops import lq as _lq
from picasso_torch.ops import lq_cuda, mle_cuda
from picasso_torch.ops import mle as _mle
from picasso_torch.ops._fit_common import (
    BOXES, FINISH, FULL, SHARED_LIMIT, START, check_box, default_boundaries,
    on_cuda, phase_ends, run_phases,
)

_DTYPE_ID = {torch.uint16: 0, torch.float32: 1}
_METHOD_ID = {"sigmaxy": 0, "sigma": 1}
_ROWS = {"sigmaxy": 6, "sigma": 5}  # carry rows (parameters)


def cut_rois_t(frames: torch.Tensor, f, y, x, box: int) -> torch.Tensor:
    """Raw (box, box, N) ROIs [y, x, n] around hit centres (f, y, x)
    from a (B, Y, X) chunk, in the chunk's dtype (u16 comes back as
    int32), each starting box // 2 = r pixels before its centre (at an
    even box it ends r - 1 after it, as picasso_tpu's gather_wincols
    takes it). The centre is clamped as gather_wincols clamps it (f to
    [0, B-1], y to [r, Y-r-1], x to [r, X-r-1]), so a window never leaves
    the chunk and a negative index never wraps."""
    r = box // 2
    B, Y, X = frames.shape
    f = f.long().clamp(0, B - 1)
    y = y.long().clamp(r, Y - r - 1)
    x = x.long().clamp(r, X - r - 1)
    offs = torch.arange(box, device=frames.device) - r
    src = frames.view(torch.int16) if frames.dtype == torch.uint16 else frames
    rows = y[None, :] + offs[:, None]  # (S, N)
    cols = x[None, :] + offs[:, None]
    roi = src[f[None, None, :], rows[:, None, :], cols[None, :, :]]
    if frames.dtype == torch.uint16:
        roi = roi.to(torch.int32) & 0xFFFF
    return roi


def photons_t(frames, f, y, x, box: int, baseline: float,
              factor: float) -> torch.Tensor:
    """The gather route's ROI batch: :func:`cut_rois_t`, then (raw -
    baseline) * factor in f32, contiguous (S, S, N)."""
    return ((cut_rois_t(frames, f, y, x, box).to(torch.float32) - baseline)
            * factor).contiguous()


def _check_launch(frames, rows, box: int) -> None:
    """The checks of a launch of a cut or fused kernel over the hit rows
    ``rows`` (f, y, x) of ``frames``."""
    if frames.ndim != 3 or frames.dtype not in _DTYPE_ID:
        raise ValueError("the fused cut+fit kernels take a (B, Y, X) u16 or "
                         f"f32 chunk, got {frames.dtype} {tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("the frame chunk must be contiguous")
    check_box(box)
    if min(frames.shape[1:]) < 2 * (box // 2) + 1:  # the clamp's range
        raise ValueError(f"frames {tuple(frames.shape)} smaller than the box")
    if any(r.device != frames.device for r in rows):
        raise ValueError("hits and frames must be on one device")


def _hit_list(frames, f, y, x, box: int, cuda: bool) -> torch.Tensor:
    """The (3, N) hit list rows f, y, x; on the card int32 and
    contiguous (the templated kernels' layout), after the checks of a
    launch."""
    hits = torch.stack([f, y, x])
    if cuda:
        _check_launch(frames, (hits,), box)
        hits = hits.to(torch.int32).contiguous()
    return hits


def _hit_rows(frames, f, y, x, box: int) -> tuple:
    """The hit rows f, y, x of a CUDA chunk for the any-box cut, after
    the checks of a launch: int64 as compaction gives them (other
    integers converted), which the cut reads in place, each at its
    stride (:func:`_launch_cut`), with no stack or cast before it."""
    rows = (f, y, x)
    if not (f.ndim == 1 and f.shape == y.shape == x.shape):
        raise ValueError("the hit rows f, y, x must be 1-D of one length")
    _check_launch(frames, rows, box)
    return tuple(r.to(torch.int64) for r in rows)


#: hits a block of the any-box cut may take, the most first (a pixel's
#: hits one store: 128 B at 32, a 32-B sector at 8)
CUT_TILES = (32, 16, 8)
#: the shared bytes a block of the any-box cut may take: a third of what
#: a block may hold, so that three blocks share an SM
CUT_SHARED = SHARED_LIMIT // 3


def anybox_cut_smem(box: int, hits: int, rows: int) -> int:
    """Dynamic shared bytes a block of the any-box cut takes: a band of
    ``rows`` window rows as [pixel][hit], a pixel's hits at the stride
    hits + 1 (csrc/cut_anybox.cu's cut_smem; the hits' window origins sit
    in 256 B of static shared memory beside it)."""
    return 4 * rows * box * (hits + 1)


def anybox_cut_config(box: int) -> dict:
    """The any-box cut's launch arguments at ``box``, worked out from the
    box against :data:`CUT_SHARED`: ``hits`` a block, the most of
    :data:`CUT_TILES` for which a band of one window row fits, and
    ``rows`` a band, the window in ``bands`` bands of equal rows (one
    band up to box 24 at 32 hits); with ``shared_bytes``. Raises where
    no tile fits (boxes above 2152)."""
    if box < 1:
        raise ValueError(f"the any-box cut takes boxes >= 1, got {box}")
    for hits in CUT_TILES:
        most = min(box, CUT_SHARED // (4 * box * (hits + 1)))
        if most >= 1:
            bands = -(-box // most)
            rows = -(-box // bands)
            return {"hits": hits, "rows": rows, "bands": bands,
                    "shared_bytes": anybox_cut_smem(box, hits, rows)}
    raise ValueError(f"box {box}: no tile of the any-box cut fits")


def _launch_cut(lib, frames, rows, box: int, baseline, factor,
                cfg: dict) -> torch.Tensor:
    """One launch of cut_anybox.cu's tiled cut (of ``lib``: the
    package's, or a -D build of tests/torch_anybox_sweep.py) over the
    int64 hit rows ``rows`` (f, y, x; N > 0, each read at its stride)
    with the launch arguments ``cfg`` (:func:`anybox_cut_config`'s
    ``hits`` and ``rows``): the (box, box, N) f32 photon ROIs."""
    f, y, x = rows
    n = f.shape[0]
    out = torch.empty((box, box, n), dtype=torch.float32,
                      device=frames.device)
    B, Y, X = frames.shape
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        status = lib.picasso_cut_anybox(
            frames.data_ptr(), _DTYPE_ID[frames.dtype], B, Y, X,
            f.data_ptr(), f.stride(0), y.data_ptr(), y.stride(0),
            x.data_ptr(), x.stride(0), n, box, float(baseline),
            float(factor), cfg["hits"], cfg["rows"], out.data_ptr(), stream,
        )
    _build.check(status, "cut_anybox")
    return out


def _cut(frames, rows, box: int, baseline, factor) -> torch.Tensor:
    """The any-box cut of :func:`_hit_rows`' int64 rows (N > 0) with
    :func:`anybox_cut_config`'s launch arguments, counted on
    :func:`cut_anybox_t`."""
    out = _launch_cut(_build.library(), frames, rows, box, baseline, factor,
                      anybox_cut_config(box))
    _build.count_launch(cut_anybox_t)
    return out


def cut_anybox_t(frames, f, y, x, box: int, baseline: float,
                 factor: float) -> torch.Tensor:
    """K5's window load and photon conversion at any box >= 1 on the card
    (csrc/cut_anybox.cu: a block a tile of hits, the windows read by rows
    and written lanes-last through shared memory, its launch arguments
    :func:`anybox_cut_config`'s): the lanes-last (box, box, N) f32 photon
    ROIs of the hits (f, y, x) of the (B, Y, X) u16 or f32 chunk, rounded
    as the templated K5 stages them and equal to :func:`photons_t`, its
    plain version (which a CPU chunk takes, uncounted), bit for bit."""
    if not on_cuda(frames):
        return photons_t(frames, f, y, x, box, baseline, factor)
    rows = _hit_rows(frames, f, y, x, box)
    if rows[0].shape[0] == 0:
        return torch.empty((box, box, 0), dtype=torch.float32,
                           device=frames.device)
    return _cut(frames, rows, box, baseline, factor)


cut_anybox_t.launches = 0


def cut_anybox_direct_t(frames, f, y, x, box: int, baseline: float,
                        factor: float) -> torch.Tensor:
    """The first form of :func:`cut_anybox_t` (csrc/cut_anybox.cu's
    picasso_cut_anybox_direct: one thread a pixel, the spot index
    fastest), the same ROIs bit for bit; on no path (chip_smoke.py times
    the two in turns). On the CPU it is :func:`photons_t`, uncounted."""
    cuda = on_cuda(frames)
    hits = _hit_list(frames, f, y, x, box, cuda)
    if not cuda:
        return photons_t(frames, *hits, box, baseline, factor)
    n = hits.shape[1]
    out = torch.empty((box, box, n), dtype=torch.float32,
                      device=frames.device)
    if n == 0:
        return out
    B, Y, X = frames.shape
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        status = _build.library().picasso_cut_anybox_direct(
            frames.data_ptr(), _DTYPE_ID[frames.dtype], B, Y, X,
            hits.data_ptr(), n, box, float(baseline), float(factor),
            out.data_ptr(), stream,
        )
    _build.check(status, "cut_anybox_direct")
    _build.count_launch(cut_anybox_direct_t)
    return out


cut_anybox_direct_t.launches = 0


def _anybox_mle(frames, f, y, x, baseline, factor, box, eps, max_it,
                method):
    """A CUDA chunk's MLE fit at a box without a templated kernel: the
    any-box cut, then the any-box fit (2 launches; none without hits)."""
    rows = _hit_rows(frames, f, y, x, box)
    if rows[0].shape[0] == 0:
        return _empty_fit(frames.device)
    spots = _cut(frames, rows, box, baseline, factor)
    return mle_cuda.fit_anybox_t(spots, eps, max_it, method)


def _launch_mle(mode: int, frames, hits, baseline, factor, box, eps, k,
                method, carry=None, lib=None):
    """One launch of the K5 MLE kernel (of ``lib``, by default the
    package's). START/RESUME return the carry (RESUME updates it in
    place); FULL/FINISH return (theta, crlb, ll, iters)."""
    lib = lib or _build.library()
    n = hits.shape[1]
    dev = frames.device
    f32 = dict(dtype=torch.float32, device=dev)
    r = _ROWS[method]
    if mode == START:
        carry = (torch.empty((r, n), **f32), torch.empty((r, n), **f32),
                 torch.empty((1, n), **f32), torch.empty((1, n), **f32),
                 torch.empty((r, n), **f32))
    outs = None
    if mode in (FULL, FINISH):
        outs = (torch.empty((6, n), **f32), torch.empty((6, n), **f32),
                torch.empty((n,), **f32),
                torch.empty((n,), dtype=torch.int32, device=dev))
    ptrs = [c.data_ptr() for c in carry] if carry is not None else [None] * 5
    optrs = [o.data_ptr() for o in outs] if outs is not None else [None] * 4
    B, Y, X = frames.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.picasso_winfit_mle(
            frames.data_ptr(), _DTYPE_ID[frames.dtype], B, Y, X,
            hits.data_ptr(), n, box, float(baseline), float(factor),
            float(eps), int(k), mode, _METHOD_ID[method], *ptrs, *optrs,
            stream,
        )
    _build.check(status, "winfit_mle")
    return carry if outs is None else outs


def _empty_fit(device):
    return (torch.zeros((6, 0), dtype=torch.float32, device=device),
            torch.zeros((6, 0), dtype=torch.float32, device=device),
            torch.zeros((0,), dtype=torch.float32, device=device),
            torch.zeros((0,), dtype=torch.int32, device=device))


def fit_mle_t(frames, f, y, x, baseline: float, factor: float, *, box: int,
              eps: float, max_it: int, method: str = "sigmaxy"):
    """K5 MLE in one pass: fit the box x box windows around the hits (f,
    y, x) of the (B, Y, X) chunk ``frames``, converted to photons (raw -
    baseline) * factor. Returns (theta (6, N), crlb (6, N), ll (N,),
    iters (N,) i32), as :func:`ops.mle_cuda.fit_t` on
    :func:`photons_t`, bit for bit."""
    _mle._check_method(method)
    cuda = on_cuda(frames)
    if cuda and box not in BOXES:
        return _anybox_mle(frames, f, y, x, baseline, factor, box, eps,
                           max_it, method)
    hits = _hit_list(frames, f, y, x, box, cuda)
    if not cuda:
        return _mle._fit_core(photons_t(frames, *hits, box, baseline, factor),
                              eps, max_it, method)
    if hits.shape[1] == 0:
        return _empty_fit(frames.device)
    out = _launch_mle(FULL, frames, hits, baseline, factor, box, eps,
                      max_it, method)
    _build.count_launch(fit_mle_t)
    return out


fit_mle_t.launches = 0


def fit_mle_boundary_t(frames, f, y, x, baseline: float, factor: float, *,
                       box: int, eps: float, max_it: int,
                       method: str = "sigmaxy"):
    """K5 MLE in the phase schedule of K2 (phases ending at
    ``default_boundaries(max_it)``): between phases the carry and the
    (3, N) hit list, not a ROI batch, are reordered stragglers first, and
    each phase loads its windows anew. Equals :func:`fit_mle_t` bit for
    bit. On the CPU each phase takes the gather route (cut, photons, the
    plain phase). Off the chain's routes (ops/fused.MLE_FITS)."""
    _mle._check_method(method)
    cuda = on_cuda(frames)
    ends = phase_ends(default_boundaries(max_it), max_it)
    if not ends:
        return fit_mle_t(frames, f, y, x, baseline, factor, box=box, eps=eps,
                         max_it=max_it, method=method)
    if cuda and box not in BOXES:
        # one launch: the phases equal it by construction
        return _anybox_mle(frames, f, y, x, baseline, factor, box, eps,
                           max_it, method)
    hits = _hit_list(frames, f, y, x, box, cuda)
    if hits.shape[1] == 0:
        return _empty_fit(frames.device)

    def phase(mode, hits, k, carry):
        if cuda:
            out = _launch_mle(mode, frames, hits, baseline, factor,
                              box, eps, k, method, carry)
            _build.count_launch(fit_mle_boundary_t)
            return out
        spots = photons_t(frames, *hits, box, baseline, factor)
        return _mle._fit_phase(mode, spots, eps, k, method, None, carry)

    (theta, crlb, ll, iters), inv = run_phases(phase, hits, max_it, ends, 2,
                                               FINISH)
    return theta[:, inv], crlb[:, inv], ll[inv], iters[inv]


fit_mle_boundary_t.launches = 0


QUEUE_INFO = ("threads", "blocks_per_sm", "registers", "local_bytes",
              "refill", "min_blocks", "sms", "group")


def queue_info(dtype: torch.dtype, box: int, method: str = "sigmaxy",
               lib=None) -> dict:
    """What the queue kernel's instance for a ``dtype`` chunk, ``box``
    and ``method`` is on the current card: the :data:`QUEUE_INFO` fields
    (threads a block, resident blocks per SM, registers and local spill
    bytes a thread, the refill threshold, the launch bounds' minimum
    blocks, the card's SMs, the lanes of a cooperative group or 0
    without the tail)."""
    lib = lib or _build.library()
    info = (ctypes.c_int * len(QUEUE_INFO))()
    _build.check(lib.picasso_winfit_mle_queue_info(
        _DTYPE_ID[dtype], box, _METHOD_ID[method], info),
        "winfit_mle_queue_info")
    return dict(zip(QUEUE_INFO, info))


def _launch_queue(lib, frames, hits, baseline, factor, box, eps, max_it,
                  method):
    """One launch of the queue kernel of ``lib`` over the (3, N) hit
    list, with its counter zeroed here; returns the carry (theta, old,
    done, iters, max_step) in input order."""
    n = hits.shape[1]
    dev = frames.device
    f32 = dict(dtype=torch.float32, device=dev)
    r = _ROWS[method]
    carry = (torch.empty((r, n), **f32), torch.empty((r, n), **f32),
             torch.empty((1, n), **f32), torch.empty((1, n), **f32),
             torch.empty((r, n), **f32))
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    B, Y, X = frames.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.picasso_winfit_mle_queue(
            frames.data_ptr(), _DTYPE_ID[frames.dtype], B, Y, X,
            hits.data_ptr(), n, box, float(baseline), float(factor),
            float(eps), int(max_it), _METHOD_ID[method], counter.data_ptr(),
            *[c.data_ptr() for c in carry], stream,
        )
    _build.check(status, "winfit_mle_queue")
    return carry


def fit_mle_queue_t(frames, f, y, x, baseline: float, factor: float, *,
                    box: int, eps: float, max_it: int,
                    method: str = "sigmaxy"):
    """K5 MLE as a work queue, the chain's route: one persistent
    launch in which each lane of a warp takes the next hit from a device
    counter once its spot has converged or reached max_it, a drained
    warp's lanes run its last spots in groups (the cooperative tail), and
    each spot's carry is written at its index; then K5's FINISH mode at k = 0
    computes the CRLB and log-likelihood of all N spots (2 launches).
    Arguments and returns as :func:`fit_mle_t`, and equal to it (and to
    :func:`fit_mle_boundary_t`) bit for bit: each spot runs the same
    steps, only the lane that runs them differs. On the CPU it is the
    gather route (cut, photons, the plain fit)."""
    _mle._check_method(method)
    cuda = on_cuda(frames)
    if cuda and box not in BOXES:
        return _anybox_mle(frames, f, y, x, baseline, factor, box, eps,
                           max_it, method)
    hits = _hit_list(frames, f, y, x, box, cuda)
    if not cuda:
        return _mle._fit_core(photons_t(frames, *hits, box, baseline, factor),
                              eps, max_it, method)
    if hits.shape[1] == 0:
        return _empty_fit(frames.device)
    carry = _launch_queue(_build.library(), frames, hits, baseline, factor,
                          box, eps, max_it, method)
    _build.count_launch(fit_mle_queue_t)
    out = _launch_mle(FINISH, frames, hits, baseline, factor, box, eps, 0,
                      method, carry)
    _build.count_launch(fit_mle_queue_t)
    return out


fit_mle_queue_t.launches = 0


LQ_QUEUE_INFO = ("threads", "blocks_per_sm", "registers", "local_bytes",
                 "refill", "group", "sms")


def lq_queue_info(dtype: torch.dtype, box: int, lib=None) -> dict:
    """What the LM queue kernel's instance for a ``dtype`` chunk and
    ``box`` is on the current card: the :data:`LQ_QUEUE_INFO` fields
    (threads a block, resident blocks per SM, registers and local spill
    bytes a thread, the refill threshold R, the lanes G of a cooperative
    group, the card's SMs)."""
    lib = lib or _build.library()
    info = (ctypes.c_int * len(LQ_QUEUE_INFO))()
    _build.check(lib.picasso_winfit_lq_queue_info(_DTYPE_ID[dtype], box,
                                                  info),
                 "winfit_lq_queue_info")
    return dict(zip(LQ_QUEUE_INFO, info))


def _launch_lq_queue(lib, frames, hits, baseline, factor, box, max_it, ftol,
                     coop_steps=None):
    """One launch of the LM queue kernel of ``lib`` over the (3, N) hit
    list, with its counter zeroed here; returns theta (6, N) in input
    order. ``coop_steps``, one int32 on the card, gains the spot-steps
    taken in the cooperative tail."""
    n = hits.shape[1]
    theta = torch.empty((6, n), dtype=torch.float32, device=frames.device)
    counter = torch.zeros(1, dtype=torch.int32, device=frames.device)
    B, Y, X = frames.shape
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        status = lib.picasso_winfit_lq_queue(
            frames.data_ptr(), _DTYPE_ID[frames.dtype], B, Y, X,
            hits.data_ptr(), n, box, float(baseline), float(factor),
            float(ftol), int(max_it), counter.data_ptr(), theta.data_ptr(),
            None if coop_steps is None else coop_steps.data_ptr(), stream,
        )
    _build.check(status, "winfit_lq_queue")
    return theta


def fit_lq_queue_t(frames, f, y, x, baseline: float, factor: float, *,
                   box: int, max_it: int, ftol: float = 1e-6,
                   coop_steps=None) -> torch.Tensor:
    """K5 LM fit of the windows around the hits (f, y, x) of the (B, Y,
    X) chunk ``frames``, converted to photons (raw - baseline) * factor,
    as a work queue: one persistent launch in which each lane of a warp
    takes the next hit from a device counter once its spot is done, and
    a drained warp's lanes run its last spots in groups (the cooperative
    tail). Returns theta (6, N), x/y relative to the box centre, as
    :func:`ops.lq_cuda.fit_t` on :func:`photons_t`, bit for bit: each
    spot runs the same steps with the same arithmetic, only the lanes
    that run them differ. ``coop_steps`` (one int32 on the card, or None) gains the spot-steps
    taken in the cooperative tail. On the CPU it is the gather route."""
    cuda = on_cuda(frames)
    if not cuda:
        return _lq._lm_core(photons_t(frames, f, y, x, box, baseline,
                                      factor), max_it, ftol)
    if coop_steps is not None and (coop_steps.device != frames.device
                                   or coop_steps.dtype != torch.int32):
        raise ValueError("coop_steps must be an int32 tensor on the card")
    empty = torch.empty((6, 0), dtype=torch.float32, device=frames.device)
    if box not in BOXES:
        rows = _hit_rows(frames, f, y, x, box)
        if rows[0].shape[0] == 0:
            return empty
        return lq_cuda.fit_anybox_t(
            _cut(frames, rows, box, baseline, factor), max_it, ftol)
    hits = _hit_list(frames, f, y, x, box, cuda)
    if hits.shape[1] == 0:
        return empty
    theta = _launch_lq_queue(_build.library(), frames, hits, baseline, factor,
                             box, max_it, ftol, coop_steps)
    _build.count_launch(fit_lq_queue_t)
    return theta


fit_lq_queue_t.launches = 0
