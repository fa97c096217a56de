"""Wrappers of the CUDA MLE fit kernels on a cut ROI batch, for the
methods ``sigmaxy`` and ``sigma``: K1 and K7 as one work-queue launch
with the CRLB and log-likelihood in it (csrc/roi_mle_fit.cu: lane
refill, a warp-cooperative straggler tail, then the handoff: each
finished spot's theta and a ready flag, and warps whose fits are done
run the CRLB/LL of 32 spots at a time); K2, the fit split into
resumable phases with stragglers-first lane order between them
(csrc/mle_fit.cu's START/RESUME/FINISH modes); and the one-thread pass
(mle_fit.cu's FULL mode, :func:`fit_one_pass_t`), on no path: the fixed
point the queue equals bit for bit. :data:`ROI_FITS` is fit2D's route
per method (gaussmle.gaussmle). These take the boxes of
``_fit_common.BOXES``; a CUDA batch of any other box >= 1 goes to
:func:`fit_anybox_t` (csrc/mle_anybox_queue.cu: the same work queue
with the box a launch argument, its launch arguments from
:func:`anybox_queue_config`), whichever of them is called. The any-box
one-thread pass (csrc/mle_anybox.cu, :func:`fit_anybox_one_pass_t`) is
on no path: the fixed point the any-box queue equals bit for bit.

Counterpart of picasso_tpu/ops/mle_pallas.py (fit_pallas_t,
fit_pallas_boundary_t, fit_pallas_multiround). A CUDA tensor launches
the kernel or raises; a CPU tensor runs the plain PyTorch version of the
same fit or phases (ops/mle.py). Nothing here falls back from one to
the other.

Launch counts (plain integers): ``fit_t.launches`` and
``fit_multiround_t.launches`` count roi_mle_fit.cu's launches (1 a
fit), ``fit_one_pass_t.launches`` the one-thread pass (FULL),
``fit_boundary_t.launches`` the phase (START/RESUME/FINISH) launches of
the K2 schedule, ``fit_anybox_t.launches`` the any-box queue's (1 a
fit, whichever wrapper routed to it), ``fit_anybox_one_pass_t.launches``
the any-box one-thread pass's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from picasso_torch import _build
from picasso_torch.ops import mle as _mle
from picasso_torch.ops._fit_common import (
    FINISH, FULL, SHARED_LIMIT, START, any_box, check_box, check_spots,
    default_boundaries, on_cuda, phase_ends, run_phases,
)

_METHOD_ID = {"sigmaxy": 0, "sigma": 1}
_ROWS = {"sigmaxy": 6, "sigma": 5}  # carry rows (parameters)


def _empty_fit(n: int, device):
    return (
        torch.zeros((6, n), dtype=torch.float32, device=device),
        torch.zeros((6, n), dtype=torch.float32, device=device),
        torch.zeros((n,), dtype=torch.float32, device=device),
        torch.zeros((n,), dtype=torch.int32, device=device),
    )


def _fit_outputs(n: int, dev):
    """Empty (theta (6, n), crlb (6, n), ll (n,), iters (n,) i32) on
    ``dev``."""
    return (torch.empty((6, n), dtype=torch.float32, device=dev),
            torch.empty((6, n), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev))


def _launch(mode: int, spots_t, eps: float, k: int, n_valid, method: str,
            carry=None, lib=None):
    """One launch of the fit kernel (of ``lib``, by default the
    package's) on ``spots_t``'s card. START/RESUME return the carry
    (RESUME updates it in place); FULL/FINISH return (theta, crlb, ll,
    iters)."""
    lib = lib or _build.library()
    s, _, n = spots_t.shape
    dev = spots_t.device
    f32 = dict(dtype=torch.float32, device=dev)
    r = _ROWS[method]
    if mode == START:
        carry = (
            torch.empty((r, n), **f32), torch.empty((r, n), **f32),
            torch.empty((1, n), **f32), torch.empty((1, n), **f32),
            torch.empty((r, n), **f32),
        )
    outs = None
    if mode in (FULL, FINISH):
        outs = (
            torch.empty((6, n), **f32), torch.empty((6, n), **f32),
            torch.empty((n,), **f32),
            torch.empty((n,), dtype=torch.int32, device=dev),
        )
    if carry is not None:
        for c in carry:
            if (c.device != dev or c.dtype != torch.float32
                    or not c.is_contiguous()):
                raise ValueError(
                    "fit carry must be contiguous float32 on the spots' device"
                )
    ptrs = [c.data_ptr() for c in carry] if carry is not None else [None] * 5
    optrs = [o.data_ptr() for o in outs] if outs is not None else [None] * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.picasso_mle_fit(
            spots_t.data_ptr(), n, s, float(eps), int(k), mode,
            n if n_valid is None else int(n_valid), _METHOD_ID[method],
            *ptrs, *optrs, stream,
        )
    _build.check(status, "mle_fit")
    return carry if outs is None else outs


def fit_anybox_one_pass_t(spots_t: torch.Tensor, eps: float, max_it: int,
                          method: str = "sigmaxy", n_valid=None):
    """The any-box one-thread pass (csrc/mle_anybox.cu): fit a lanes-last
    (S, S, N) f32 batch at any box >= 1, one thread a spot, the box a
    launch argument, fit, CRLB and LL in one launch, with a (5, S, N) f32
    workspace for the x axis's factors. Returns (theta (6, N), crlb (6,
    N), ll (N,), iters (N,) i32), at boxes 5-15 equal to
    :func:`fit_one_pass_t` bit for bit. Lanes at index >= ``n_valid``
    start converged. On no path: the fixed point :func:`fit_anybox_t`
    equals bit for bit. On the CPU it is the plain fit, uncounted."""
    _mle._check_method(method)
    if not on_cuda(spots_t):
        return _mle._fit_core(spots_t, eps, max_it, method, n_valid)
    check_spots(spots_t)
    s, _, n = spots_t.shape
    if n == 0:
        return _empty_fit(0, spots_t.device)
    dev = spots_t.device
    work = torch.empty((5, s, n), dtype=torch.float32, device=dev)
    theta, crlb, ll, iters = _fit_outputs(n, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _build.library().picasso_mle_anybox(
            spots_t.data_ptr(), n, s, float(eps), int(max_it),
            n if n_valid is None else int(n_valid), _METHOD_ID[method],
            work.data_ptr(), theta.data_ptr(), crlb.data_ptr(),
            ll.data_ptr(), iters.data_ptr(), stream,
        )
    _build.check(status, "mle_anybox")
    _build.count_launch(fit_anybox_one_pass_t)
    return theta, crlb, ll, iters


fit_anybox_one_pass_t.launches = 0

#: where the any-box queue's slots read a spot's pixels (its C entry's
#: stage argument): the lanes-last batch, or a stage in shared memory
STAGES = ("batch", "shared")
#: threads a block of the any-box queue (csrc/mle_anybox_queue.cu
#: kAnyThreads, a compile-time constant, as are its refill threshold and
#: where its tail starts; :func:`anybox_queue_info` reads the build's)
ANYBOX_THREADS = 32
#: the column factors the any-box bodies keep a column
#: (csrc/fit_mle_any.cuh kAnyCols)
ANYBOX_COLS = 5
#: fields of :func:`anybox_queue_info`, in picasso_mle_anybox_queue_info's
#: order
ANYBOX_QUEUE_INFO = ("threads", "blocks_per_sm", "registers",
                     "local_bytes", "shared_bytes", "sms")


def anybox_queue_smem(box: int, stage: str, cols_shared: bool,
                      threads: int = ANYBOX_THREADS) -> int:
    """Shared bytes a block of ``threads`` of the any-box queue takes: a
    shared stage of box * box pixels a slot with a pixel stride of
    threads + 1 words, and the five column factors a column a slot
    (csrc/mle_anybox_queue.cu's any_queue_smem)."""
    return 4 * ((box * box * (threads + 1) if stage == "shared" else 0)
                + (ANYBOX_COLS * box * threads if cols_shared else 0))


def anybox_queue_config(box: int) -> dict:
    """The any-box queue's launch arguments at ``box``, worked out from
    the box against :data:`SHARED_LIMIT`:

    - ``stage``: where the slots read a spot's pixels, one of
      :data:`STAGES`: a stage in shared memory while a block's fits
      (boxes up to 41), else the batch;
    - ``cols_shared``: the x axis's column factors in shared memory where
      they fit beside the stage (all boxes but 40, 41 and those above
      363), else in a per-slot global scratch;
    - ``group``: the lanes of a cooperative group, the least of 8, 16 and
      32 that is >= box + 1, else 32, whose lanes then loop over the
      points and rows (``rounds`` of 32);

    with ``shared_bytes`` (:func:`anybox_queue_smem`)."""
    check_box(box)
    stage = "shared" if anybox_queue_smem(
        box, "shared", False) <= SHARED_LIMIT else "batch"
    cols_shared = anybox_queue_smem(box, stage, True) <= SHARED_LIMIT
    group = next((g for g in (8, 16, 32) if g >= box + 1), 32)
    return {"stage": stage, "cols_shared": cols_shared, "group": group,
            "rounds": -(-box // group),
            "shared_bytes": anybox_queue_smem(box, stage, cols_shared)}


@functools.cache
def _resident_slots(lib, box: int, method: str, stage: str,
                    device_index: int) -> int:
    """Slots the any-box queue of ``lib``, with its column factors in
    global memory, keeps resident on the card (its launch's blocks at
    most): SMs x resident blocks a SM x threads."""
    with torch.cuda.device(device_index):
        info = anybox_queue_info(box, method, {
            "stage": stage, "cols_shared": False}, lib)
    return info["sms"] * max(info["blocks_per_sm"], 1) * info["threads"]


def _launch_anybox(lib, spots_t, eps: float, max_it: int, method: str,
                   n_valid, cfg: dict, coop_steps=None):
    """One launch of mle_anybox_queue.cu's queue (of ``lib``) with the
    launch arguments ``cfg`` (:func:`anybox_queue_config`'s keys), its
    counters zeroed and its per-slot scratch (the column factors outside
    shared memory) made here; returns (theta, crlb, ll, iters)."""
    s, _, n = spots_t.shape
    dev = spots_t.device
    theta, crlb, ll, iters = _fit_outputs(n, dev)
    counter = torch.zeros(n + 2, dtype=torch.int32, device=dev)
    work, slots = None, 0
    if not cfg["cols_shared"]:  # a slot's column factors in global memory
        slots = min(-(-n // 32) * 32, _resident_slots(
            lib, s, method, cfg["stage"],
            dev.index if dev.index is not None else
            torch.cuda.current_device()))
        work = torch.empty((ANYBOX_COLS, s, slots), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.picasso_mle_anybox_queue(
            spots_t.data_ptr(), n, s, float(eps), int(max_it),
            n if n_valid is None else int(n_valid), _METHOD_ID[method],
            cfg["group"], STAGES.index(cfg["stage"]),
            int(cfg["cols_shared"]), counter.data_ptr(),
            None if work is None else work.data_ptr(), slots,
            theta.data_ptr(), crlb.data_ptr(), ll.data_ptr(),
            iters.data_ptr(),
            None if coop_steps is None else coop_steps.data_ptr(), stream,
        )
    _build.check(status, "mle_anybox_queue")
    return theta, crlb, ll, iters


def fit_anybox_t(spots_t: torch.Tensor, eps: float, max_it: int,
                 method: str = "sigmaxy", n_valid=None, coop_steps=None):
    """The MLE fit at any box >= 1 (csrc/mle_anybox_queue.cu): fit a
    lanes-last (S, S, N) f32 batch with its CRLB and log-likelihood in one
    launch of the any-box work queue (lane refill, each spot staged in
    shared memory, the cooperative tail, the CRLB/LL handoff), the box a
    launch argument, its launch arguments :func:`anybox_queue_config`'s.
    Returns (theta (6, N), crlb (6, N), ll (N,), iters (N,) i32), equal
    to :func:`fit_anybox_one_pass_t` bit for bit (and at boxes 5-15 to
    :func:`fit_one_pass_t`). Lanes at index >= ``n_valid`` start
    converged. ``coop_steps`` (one int32 on the card, or None) gains the
    spot-steps taken in the cooperative tail. The other wrappers route a
    CUDA batch of a box outside ``BOXES`` here. On the CPU it is the
    plain fit, uncounted."""
    _mle._check_method(method)
    if not on_cuda(spots_t):
        return _mle._fit_core(spots_t, eps, max_it, method, n_valid)
    check_spots(spots_t)
    _check_coop(coop_steps, spots_t)
    if spots_t.shape[-1] == 0:
        return _empty_fit(0, spots_t.device)
    out = _launch_anybox(_build.library(), spots_t, eps, max_it, method,
                         n_valid, anybox_queue_config(spots_t.shape[0]),
                         coop_steps)
    _build.count_launch(fit_anybox_t)
    return out


fit_anybox_t.launches = 0


def anybox_queue_info(box: int, method: str = "sigmaxy", cfg=None,
                      lib=None) -> dict:
    """What the any-box queue's kernel (of ``lib``) is for ``box``,
    ``method`` and the launch arguments ``cfg`` (its ``stage`` and
    ``cols_shared``; by default :func:`anybox_queue_config`'s) on the
    current card: the :data:`ANYBOX_QUEUE_INFO` fields."""
    lib = lib or _build.library()
    cfg = cfg or anybox_queue_config(box)
    info = (ctypes.c_int * len(ANYBOX_QUEUE_INFO))()
    _build.check(lib.picasso_mle_anybox_queue_info(
        box, _METHOD_ID[method], STAGES.index(cfg["stage"]),
        int(cfg["cols_shared"]), info), "mle_anybox_queue_info")
    return dict(zip(ANYBOX_QUEUE_INFO, info))


def fit_one_pass_t(spots_t: torch.Tensor, eps: float, max_it: int,
                   method: str = "sigmaxy", n_valid=None):
    """The one-thread pass (mle_fit.cu FULL, the first port of K1): fit
    a lanes-last (S, S, N) f32 batch, one thread a spot, fit, CRLB and
    LL in one launch. Returns (theta (6, N), crlb (6, N), ll (N,), iters
    (N,) i32). Lanes at index >= ``n_valid`` start converged. On no
    path: the work queues (:func:`fit_t`, K5's) and K2's phases equal it
    bit for bit."""
    _mle._check_method(method)
    if not on_cuda(spots_t):
        return _mle._fit_core(spots_t, eps, max_it, method, n_valid)
    if any_box(spots_t):
        return fit_anybox_t(spots_t, eps, max_it, method, n_valid)
    if spots_t.shape[-1] == 0:
        return _empty_fit(0, spots_t.device)
    out = _launch(FULL, spots_t, eps, max_it, n_valid, method)
    _build.count_launch(fit_one_pass_t)
    return out


fit_one_pass_t.launches = 0


def _launch_fit(lib, spots_t, eps: float, max_it: int, method: str,
                n_valid, coop_steps=None):
    """One launch of roi_mle_fit.cu's queue (of ``lib``) with its counter
    zeroed here; returns (theta, crlb, ll, iters) in input order."""
    s, _, n = spots_t.shape
    dev = spots_t.device
    theta, crlb, ll, iters = _fit_outputs(n, dev)
    # the queue's two counters and a ready flag a spot, zeroed
    counter = torch.zeros(n + 2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.picasso_roi_mle_fit(
            spots_t.data_ptr(), n, s, float(eps), int(max_it),
            n if n_valid is None else int(n_valid), _METHOD_ID[method],
            counter.data_ptr(), theta.data_ptr(), crlb.data_ptr(),
            ll.data_ptr(), iters.data_ptr(),
            None if coop_steps is None else coop_steps.data_ptr(), stream,
        )
    _build.check(status, "roi_mle_fit")
    return theta, crlb, ll, iters


def _check_coop(coop_steps, spots_t) -> None:
    if coop_steps is not None and (coop_steps.device != spots_t.device
                                   or coop_steps.dtype != torch.int32):
        raise ValueError("coop_steps must be an int32 tensor on the card")


def fit_t(spots_t: torch.Tensor, eps: float, max_it: int,
          method: str = "sigmaxy", n_valid=None, coop_steps=None):
    """K1: fit a lanes-last (S, S, N) f32 batch with its CRLB and
    log-likelihood in one launch of roi_mle_fit.cu's work queue: a lane
    whose spot has converged or reached max_it takes the next spot from a
    device counter, a drained warp's lanes run its last spots in groups
    (the cooperative tail), and each finished spot writes its theta and
    a ready flag; a warp whose fits are done then computes the CRLB and
    LL of 32 consecutive spots at a time, one a lane, reading each ROI
    again from the batch (the handoff). Returns (theta (6, N), crlb (6, N), ll (N,), iters (N,)
    i32), equal to :func:`fit_one_pass_t` bit for bit. Lanes at index >=
    ``n_valid`` start converged. ``coop_steps`` (one int32 on the card,
    or None) gains the spot-steps taken in the cooperative tail. On the
    CPU it is the plain fit, uncounted."""
    _mle._check_method(method)
    if not on_cuda(spots_t):
        return _mle._fit_core(spots_t, eps, max_it, method, n_valid)
    if any_box(spots_t):
        return fit_anybox_t(spots_t, eps, max_it, method, n_valid)
    _check_coop(coop_steps, spots_t)
    if spots_t.shape[-1] == 0:
        return _empty_fit(0, spots_t.device)
    out = _launch_fit(_build.library(), spots_t, eps, max_it, method,
                      n_valid, coop_steps)
    _build.count_launch(fit_t)
    return out


fit_t.launches = 0


def fit_boundary_t(spots_t: torch.Tensor, eps: float, max_it: int,
                   method: str = "sigmaxy", n_valid=None):
    """K2: the fit of :func:`fit_one_pass_t` run as phases that end at
    :func:`default_boundaries`. Before each later phase the lanes are
    stably reordered stragglers first, so the warps of converged spots
    retire together; the order is undone at the end. Every lane's
    trajectory is independent of its position, so the result equals
    :func:`fit_one_pass_t` bit for bit."""
    return _fit_phases(spots_t, eps, max_it, method, n_valid,
                       default_boundaries(max_it))


fit_boundary_t.launches = 0


def fit_multiround_t(spots_t: torch.Tensor, eps: float, max_it: int,
                     round_it: int = 8):
    """K7: picasso_tpu's fit_pallas_multiround, the sigmaxy fit in rounds
    of ``round_it`` iterations with the lanes stably reordered
    stragglers first between rounds (the argsort of ``done``), then the
    CRLB and log-likelihood. A TPU lane cannot take new work when its
    spot converges, so the rounds gather the spots still running into
    whole vregs. A lane of the card can: on a CUDA tensor K7 is one
    launch of :func:`fit_t`'s work queue, in which a slot whose spot is
    done takes the next one, so no round boundary, argsort or permute is
    left to do and the result does not depend on ``round_it`` (kept for
    JAX's signature); counted on ``fit_multiround_t.launches`` (1 a
    fit). On the CPU it is the rounds schedule over the plain phases
    (ops/mle.py), uncounted. Equals :func:`fit_one_pass_t` bit for bit
    either way. Nothing in the port routes to it, as nothing in the JAX
    package does."""
    if not on_cuda(spots_t):
        return _fit_phases(spots_t, eps, max_it, "sigmaxy", None,
                           range(round_it, max_it, round_it))
    if any_box(spots_t):
        return fit_anybox_t(spots_t, eps, max_it)
    if spots_t.shape[-1] == 0:
        return _empty_fit(0, spots_t.device)
    out = _launch_fit(_build.library(), spots_t, eps, max_it, "sigmaxy",
                      None)
    _build.count_launch(fit_multiround_t)
    return out


fit_multiround_t.launches = 0


def _fit_phases(spots_t, eps, max_it, method, n_valid, boundaries,
                counter=fit_boundary_t):
    """The phase schedule with phases ending at ``boundaries``; its
    launches count on ``counter.launches``."""
    _mle._check_method(method)
    cuda = on_cuda(spots_t)
    if any_box(spots_t):
        # one launch: the phases equal it by construction
        return fit_anybox_t(spots_t, eps, max_it, method, n_valid)
    ends = phase_ends(boundaries, max_it)
    if not ends:
        return fit_one_pass_t(spots_t, eps, max_it, method, n_valid)
    if spots_t.shape[-1] == 0:
        return _empty_fit(0, spots_t.device)

    def phase(mode, spots, k, carry):
        if cuda:
            out = _launch(mode, spots, eps, k, n_valid, method, carry)
            _build.count_launch(counter)
            return out
        return _mle._fit_phase(mode, spots, eps, k, method, n_valid, carry)

    (theta, crlb, ll, iters), inv = run_phases(phase, spots_t, max_it, ends,
                                               2, FINISH)
    return theta[:, inv], crlb[:, inv], ll[inv], iters[inv]


QUEUE_INFO = ("threads", "blocks_per_sm", "registers", "local_bytes",
              "refill", "min_blocks", "sms", "group")


def queue_info(box: int, method: str = "sigmaxy", lib=None) -> dict:
    """What :func:`fit_t`'s queue kernel (roi_mle_fit.cu, of ``lib``) is
    for ``box`` and ``method`` on the current card: the
    :data:`QUEUE_INFO` fields (threads a block, resident blocks per SM,
    registers and local spill bytes a thread, the refill threshold, the
    launch bounds' minimum blocks, the card's SMs, the lanes of a
    cooperative group)."""
    lib = lib or _build.library()
    info = (ctypes.c_int * len(QUEUE_INFO))()
    _build.check(lib.picasso_roi_mle_fit_info(box, _METHOD_ID[method], info),
                 "roi_mle_fit_info")
    return dict(zip(QUEUE_INFO, info))


#: fit2D's MLE route per method (gaussmle.gaussmle): K2's phases
#: (:func:`fit_boundary_t`) or K1's work queue (:func:`fit_t`), the one
#: with the lower median in chip_smoke.py's turns on the first
#: 262,144-ROI block of its movie (PERF.md; gaps under 1% that flip
#: between runs keep the route). Both equal the one-thread pass bit for
#: bit.
ROI_FITS = {"sigmaxy": fit_boundary_t, "sigma": fit_t}
