"""Wrappers of the CUDA MLE fit kernels on a cut ROI batch, for the
methods ``sigmaxy`` and ``sigma``: csrc/mle_fit.cu's K1, the
single-pass fit, and K2, the same fit split into resumable phases with
stragglers-first lane order between them; K2 as a work queue
(csrc/roi_mle_queue.cu, one persistent launch with lane refill and a
warp-cooperative straggler tail, then mle_fit.cu's CRLB/LL pass); and
K7, the sigmaxy fit in fixed rounds, as a schedule of K2's phase modes.
:data:`ROI_FITS` is fit2D's route per method (gaussmle.gaussmle).

Counterpart of picasso_tpu/ops/mle_pallas.py (fit_pallas_t,
fit_pallas_boundary_t, fit_pallas_multiround). A CUDA tensor launches
the kernel or raises; a CPU tensor runs the plain PyTorch version of the
same phases (ops/mle.py). Nothing here falls back from one to the other.

Launch counts (plain integers): ``fit_t.launches`` counts the kernel's
single-pass (FULL) launches, ``fit_boundary_t.launches`` the phase
(START/RESUME/FINISH) launches of the K2 schedule,
``fit_queue_t.launches`` the work queue's launches and its CRLB/LL pass
(2 a fit), ``fit_multiround_t.launches`` those of the K7 schedule.
"""

from __future__ import annotations

import ctypes

import torch

from picasso_torch import _build
from picasso_torch.ops import mle as _mle
from picasso_torch.ops._fit_common import (
    FINISH, FULL, START, check_spots, default_boundaries, on_cuda, phase_ends,
    run_phases,
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


def fit_t(spots_t: torch.Tensor, eps: float, max_it: int,
          method: str = "sigmaxy", n_valid=None):
    """K1: fit a lanes-last (S, S, N) f32 batch in one pass. Returns
    (theta (6, N), crlb (6, N), ll (N,), iters (N,) i32). Lanes at index
    >= ``n_valid`` start converged."""
    _mle._check_method(method)
    if not on_cuda(spots_t):
        return _mle._fit_core(spots_t, eps, max_it, method, n_valid)
    check_spots(spots_t)
    if spots_t.shape[-1] == 0:
        return _empty_fit(0, spots_t.device)
    out = _launch(FULL, spots_t, eps, max_it, n_valid, method)
    fit_t.launches += 1
    return out


fit_t.launches = 0


def fit_boundary_t(spots_t: torch.Tensor, eps: float, max_it: int,
                   method: str = "sigmaxy", n_valid=None):
    """K2: the fit of :func:`fit_t` run as phases that end at
    :func:`default_boundaries`. Before each later phase the lanes are
    stably reordered stragglers first, so the warps of converged spots
    retire together; the order is undone at the end. Every lane's
    trajectory is independent of its position, so the result equals
    :func:`fit_t` bit for bit."""
    return _fit_phases(spots_t, eps, max_it, method, n_valid,
                       default_boundaries(max_it))


fit_boundary_t.launches = 0


def fit_multiround_t(spots_t: torch.Tensor, eps: float, max_it: int,
                     round_it: int = 8):
    """K7: the sigmaxy fit of :func:`fit_t` in rounds of ``round_it``
    iterations with the lanes stably reordered stragglers first between
    rounds (the argsort of ``done`` of picasso_tpu's
    fit_pallas_multiround), then the CRLB and log-likelihood: a schedule
    of the phase modes of K2, 1 START, RESUMEs and 1 FINISH (13 launches
    at max_it 100), which does the last round and the CRLB pass in one
    launch. Equals :func:`fit_t` bit for bit. A fit of max_it <=
    round_it is one pass of :func:`fit_t`. Nothing in the port routes to
    it, as nothing in the JAX package does."""
    return _fit_phases(spots_t, eps, max_it, "sigmaxy", None,
                       range(round_it, max_it, round_it), fit_multiround_t)


fit_multiround_t.launches = 0


def _fit_phases(spots_t, eps, max_it, method, n_valid, boundaries,
                counter=fit_boundary_t):
    """The phase schedule with phases ending at ``boundaries``; its
    launches count on ``counter.launches``."""
    _mle._check_method(method)
    cuda = on_cuda(spots_t)
    if cuda:
        check_spots(spots_t)
    ends = phase_ends(boundaries, max_it)
    if not ends:
        return fit_t(spots_t, eps, max_it, method, n_valid)
    if spots_t.shape[-1] == 0:
        return _empty_fit(0, spots_t.device)

    def phase(mode, spots, k, carry):
        if cuda:
            out = _launch(mode, spots, eps, k, n_valid, method, carry)
            counter.launches += 1
            return out
        return _mle._fit_phase(mode, spots, eps, k, method, n_valid, carry)

    (theta, crlb, ll, iters), inv = run_phases(phase, spots_t, max_it, ends,
                                               2, FINISH)
    return theta[:, inv], crlb[:, inv], ll[inv], iters[inv]


QUEUE_INFO = ("threads", "blocks_per_sm", "registers", "local_bytes",
              "refill", "min_blocks", "sms", "group")


def queue_info(box: int, method: str = "sigmaxy", lib=None) -> dict:
    """What the ROI queue kernel's instance for ``box`` and ``method`` is
    on the current card: the :data:`QUEUE_INFO` fields (threads a block,
    resident blocks per SM, registers and local spill bytes a thread, the
    refill threshold, the launch bounds' minimum blocks, the card's SMs,
    the lanes of a cooperative group)."""
    lib = lib or _build.library()
    info = (ctypes.c_int * len(QUEUE_INFO))()
    _build.check(lib.picasso_roi_mle_queue_info(box, _METHOD_ID[method], info),
                 "roi_mle_queue_info")
    return dict(zip(QUEUE_INFO, info))


def _launch_queue(lib, spots_t, eps: float, max_it: int, method: str,
                  n_valid, coop_steps=None):
    """One launch of the ROI queue kernel of ``lib``, with its counter
    zeroed here; returns the carry (theta, old, done, iters, max_step) in
    input order."""
    s, _, n = spots_t.shape
    dev = spots_t.device
    f32 = dict(dtype=torch.float32, device=dev)
    r = _ROWS[method]
    carry = (torch.empty((r, n), **f32), torch.empty((r, n), **f32),
             torch.empty((1, n), **f32), torch.empty((1, n), **f32),
             torch.empty((r, n), **f32))
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.picasso_roi_mle_queue(
            spots_t.data_ptr(), n, s, float(eps), int(max_it),
            n if n_valid is None else int(n_valid), _METHOD_ID[method],
            counter.data_ptr(), *[c.data_ptr() for c in carry],
            None if coop_steps is None else coop_steps.data_ptr(), stream,
        )
    _build.check(status, "roi_mle_queue")
    return carry


def fit_queue_t(spots_t: torch.Tensor, eps: float, max_it: int,
                method: str = "sigmaxy", n_valid=None, coop_steps=None):
    """K2 as a work queue: fit a lanes-last (S, S, N) f32 batch in one
    persistent launch in which each lane of a warp takes the next spot
    from a device counter once its spot has converged or reached max_it,
    and a drained warp's lanes run its last spots in groups (the
    cooperative tail); each spot's carry is written at its index, then
    mle_fit.cu's FINISH mode at k = 0 computes the CRLB and
    log-likelihood of all N spots (2 launches). Arguments and returns as
    :func:`fit_t`, and equal to it and to :func:`fit_boundary_t` bit for
    bit: each spot runs the same steps with the same arithmetic, only the
    lanes that run them differ. ``coop_steps`` (one int32 on the card, or
    None) gains the spot-steps taken in the cooperative tail. On the CPU
    it is the plain fit, uncounted."""
    _mle._check_method(method)
    if not on_cuda(spots_t):
        return _mle._fit_core(spots_t, eps, max_it, method, n_valid)
    check_spots(spots_t)
    if coop_steps is not None and (coop_steps.device != spots_t.device
                                   or coop_steps.dtype != torch.int32):
        raise ValueError("coop_steps must be an int32 tensor on the card")
    if spots_t.shape[-1] == 0:
        return _empty_fit(0, spots_t.device)
    carry = _launch_queue(_build.library(), spots_t, eps, max_it, method,
                          n_valid, coop_steps)
    fit_queue_t.launches += 1
    out = _launch(FINISH, spots_t, eps, 0, n_valid, method, carry)
    fit_queue_t.launches += 1
    return out


fit_queue_t.launches = 0

#: fit2D's MLE route per method (gaussmle.gaussmle): the work queue
#: (:func:`fit_queue_t`) or K2's phases (:func:`fit_boundary_t`), the
#: one with the lower median in chip_smoke.py's turns on the first
#: 262,144-ROI block of its movie (PERF.md). Both equal K1 bit for bit.
ROI_FITS = {"sigmaxy": fit_queue_t, "sigma": fit_queue_t}
