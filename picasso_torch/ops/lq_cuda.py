"""Wrappers of the CUDA LM fit kernels on a cut ROI batch:
csrc/lq_fit.cu's K3, the single-pass fit, and K6, the same fit split
into resumable phases with stragglers-first lane order between them;
and K3 as a work queue (csrc/roi_lq_queue.cu, one persistent launch with
lane refill and a cooperative straggler tail). :data:`ROI_FIT` is
fit2D's route (ops/lq.fit_spots_batched).

Counterpart of picasso_tpu/ops/lq_pallas.py (fit_pallas_t,
fit_pallas_boundary_t). A CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain PyTorch version of the same phases
(ops/lq.py). Nothing here falls back from one to the other.

Launch counts (plain integers): ``fit_t.launches`` counts the kernel's
single-pass (FULL) launches, ``fit_boundary_t.launches`` the phase
(START/RESUME) launches of the K6 schedule, ``fit_queue_t.launches``
the work queue's (1 a fit).
"""

from __future__ import annotations

import ctypes

import torch

from picasso_torch import _build
from picasso_torch.ops import lq as _lq
from picasso_torch.ops._fit_common import (
    FULL, RESUME, START, check_spots, default_boundaries, on_cuda, phase_ends,
    run_phases,
)


def _launch(mode: int, spots_t, ftol: float, k: int, n_valid, carry=None):
    """One launch of the LM kernel on ``spots_t``'s card. FULL returns
    theta (6, N); START returns the carry (theta, lam, cost, done), and
    RESUME updates the given carry in place and returns it."""
    lib = _build.library()
    s, _, n = spots_t.shape
    dev = spots_t.device
    f32 = dict(dtype=torch.float32, device=dev)
    if mode == RESUME:
        for c in carry:
            if (c.device != dev or c.dtype != torch.float32
                    or not c.is_contiguous()):
                raise ValueError(
                    "LM carry must be contiguous float32 on the spots' device"
                )
    elif mode == START:
        carry = (torch.empty((6, n), **f32), torch.empty((1, n), **f32),
                 torch.empty((1, n), **f32), torch.empty((1, n), **f32))
    else:
        carry = (torch.empty((6, n), **f32),)
    ptrs = [c.data_ptr() for c in carry] + [None] * (4 - len(carry))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.picasso_lq_fit(
            spots_t.data_ptr(), n, s, float(ftol), int(k), mode,
            n if n_valid is None else int(n_valid), *ptrs, stream,
        )
    _build.check(status, "lq_fit")
    return carry[0] if mode == FULL else carry


def fit_t(spots_t: torch.Tensor, max_it: int, ftol: float = 1e-6,
          n_valid=None) -> torch.Tensor:
    """K3: LM-fit a lanes-last (S, S, N) f32 batch in one pass. Returns
    theta (6, N), x/y relative to the box centre. Lanes at index >=
    ``n_valid`` start done."""
    if not on_cuda(spots_t):
        return _lq._lm_core(spots_t, max_it, ftol, n_valid)
    check_spots(spots_t)
    if spots_t.shape[-1] == 0:
        return torch.zeros((6, 0), dtype=torch.float32, device=spots_t.device)
    out = _launch(FULL, spots_t, ftol, max_it, n_valid)
    fit_t.launches += 1
    return out


fit_t.launches = 0


def fit_boundary_t(spots_t: torch.Tensor, max_it: int, ftol: float = 1e-6,
                   n_valid=None) -> torch.Tensor:
    """K6: the fit of :func:`fit_t` run as phases that end at
    ``default_boundaries(max_it)``, as K2's. Before each later phase the
    lanes are stably reordered stragglers first; the order is undone at
    the end. Every lane's trajectory is independent of its position, so
    the result equals :func:`fit_t` bit for bit."""
    return _fit_phases(spots_t, max_it, ftol, n_valid,
                       default_boundaries(max_it))


def _fit_phases(spots_t, max_it, ftol, n_valid, boundaries):
    """The K6 schedule with phases ending at ``boundaries``."""
    cuda = on_cuda(spots_t)
    if cuda:
        check_spots(spots_t)
    ends = phase_ends(boundaries, max_it)
    if not ends:
        return fit_t(spots_t, max_it, ftol, n_valid)
    if spots_t.shape[-1] == 0:
        return torch.zeros((6, 0), dtype=torch.float32, device=spots_t.device)

    def phase(mode, spots, k, carry):
        if cuda:
            out = _launch(mode, spots, ftol, k, n_valid, carry)
            fit_boundary_t.launches += 1
            return out
        if mode == START:
            carry = _lq._lm_init(spots, n_valid)
        return _lq._lm_rounds(spots, *carry, k, ftol)

    carry, inv = run_phases(phase, spots_t, max_it, ends, 3, RESUME)
    return carry[0][:, inv]


fit_boundary_t.launches = 0


QUEUE_INFO = ("threads", "blocks_per_sm", "registers", "local_bytes",
              "refill", "group", "sms")


def queue_info(box: int, lib=None) -> dict:
    """What the ROI LM queue kernel's instance for ``box`` is on the
    current card: the :data:`QUEUE_INFO` fields (threads a block,
    resident blocks per SM, registers and local spill bytes a thread, the
    refill threshold, the lanes of a cooperative group, the card's
    SMs)."""
    lib = lib or _build.library()
    info = (ctypes.c_int * len(QUEUE_INFO))()
    _build.check(lib.picasso_roi_lq_queue_info(box, info),
                 "roi_lq_queue_info")
    return dict(zip(QUEUE_INFO, info))


def fit_queue_t(spots_t: torch.Tensor, max_it: int, ftol: float = 1e-6,
                n_valid=None, coop_steps=None) -> torch.Tensor:
    """K3 as a work queue: LM-fit a lanes-last (S, S, N) f32 batch in one
    persistent launch in which each lane of a warp takes the next spot
    from a device counter once its spot is done, and a drained warp's
    lanes run its last spots in groups (the cooperative tail). Arguments
    and returns as :func:`fit_t`, and equal to it and to
    :func:`fit_boundary_t` bit for bit. ``coop_steps`` (one int32 on the
    card, or None) gains the spot-steps taken in the cooperative tail. On
    the CPU it is the plain fit, uncounted."""
    if not on_cuda(spots_t):
        return _lq._lm_core(spots_t, max_it, ftol, n_valid)
    check_spots(spots_t)
    if coop_steps is not None and (coop_steps.device != spots_t.device
                                   or coop_steps.dtype != torch.int32):
        raise ValueError("coop_steps must be an int32 tensor on the card")
    s, _, n = spots_t.shape
    theta = torch.empty((6, n), dtype=torch.float32, device=spots_t.device)
    if n == 0:
        return theta
    counter = torch.zeros(1, dtype=torch.int32, device=spots_t.device)
    with torch.cuda.device(spots_t.device):
        stream = torch.cuda.current_stream(spots_t.device).cuda_stream
        status = _build.library().picasso_roi_lq_queue(
            spots_t.data_ptr(), n, s, float(ftol), int(max_it),
            n if n_valid is None else int(n_valid), counter.data_ptr(),
            theta.data_ptr(),
            None if coop_steps is None else coop_steps.data_ptr(), stream,
        )
    _build.check(status, "roi_lq_queue")
    fit_queue_t.launches += 1
    return theta


fit_queue_t.launches = 0

#: fit2D's LM route (ops/lq.fit_spots_batched): the work queue
#: (:func:`fit_queue_t`) or the one pass (:func:`fit_t`), the one with
#: the lower median in chip_smoke.py's turns at max_it 30 on the first
#: 262,144-ROI block of its movie (PERF.md). Both equal K6 bit for bit.
ROI_FIT = fit_queue_t
