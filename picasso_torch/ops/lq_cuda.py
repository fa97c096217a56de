"""Wrappers of the CUDA LM fit kernels on a cut ROI batch: K3 as a
work queue (csrc/roi_lq_queue.cu, one persistent launch with lane refill
and a cooperative straggler tail, :func:`fit_queue_t`); K6, JAX's fit in
phases, which on the card is one launch of the same queue
(:func:`fit_boundary_t`); and the one-thread pass (csrc/lq_fit.cu,
:func:`fit_t`), the fixed point both equal bit for bit. :data:`ROI_FIT`
is fit2D's route (ops/lq.fit_spots_batched). These take the boxes of
``_fit_common.BOXES``; a CUDA batch of any other box >= 1 goes to
:func:`fit_anybox_t` (csrc/lq_anybox_queue.cu: the box a launch
argument, a work queue in which a group of lanes steps each spot, its
launch arguments from :func:`anybox_queue_config`), whichever of them is
called. The any-box one-thread pass (csrc/lq_anybox.cu,
:func:`fit_anybox_one_pass_t`) is on no path: the fixed point the queue
equals bit for bit.

Counterpart of picasso_tpu/ops/lq_pallas.py (fit_pallas_t,
fit_pallas_boundary_t). A CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain PyTorch version of the same fit or phases
(ops/lq.py). Nothing here falls back from one to the other.

Launch counts (plain integers): ``fit_t.launches`` counts the one-thread
pass's launches, ``fit_boundary_t.launches`` and ``fit_queue_t.launches``
the work queue's launched for each (1 a fit), ``fit_anybox_t.launches``
the any-box queue's (1 a fit, whichever wrapper routed to it),
``fit_anybox_one_pass_t.launches`` the any-box one-thread pass's.
"""

from __future__ import annotations

import ctypes

import torch

from picasso_torch import _build
from picasso_torch.ops import lq as _lq
from picasso_torch.ops._fit_common import (
    RESUME, SHARED_LIMIT, START, any_box, check_box, check_spots,
    default_boundaries, on_cuda, phase_ends, run_phases,
)


def fit_anybox_one_pass_t(spots_t: torch.Tensor, max_it: int,
                          ftol: float = 1e-6, n_valid=None) -> torch.Tensor:
    """The any-box one-thread pass (csrc/lq_anybox.cu): LM-fit a
    lanes-last (S, S, N) f32 batch, one thread a spot, the box a launch
    argument, with a (7, S, N) f32 workspace for the axis factors.
    Returns theta (6, N), x/y relative to the box centre, at boxes 5-15
    equal to :func:`fit_t` bit for bit. Lanes at index >= ``n_valid``
    start done. On no path: the fixed point :func:`fit_anybox_t` equals
    bit for bit. On the CPU it is the plain fit, uncounted."""
    if not on_cuda(spots_t):
        return _lq._lm_core(spots_t, max_it, ftol, n_valid)
    check_spots(spots_t)
    s, _, n = spots_t.shape
    theta = torch.empty((6, n), dtype=torch.float32, device=spots_t.device)
    if n == 0:
        return theta
    work = torch.empty((7, s, n), dtype=torch.float32, device=spots_t.device)
    with torch.cuda.device(spots_t.device):
        stream = torch.cuda.current_stream(spots_t.device).cuda_stream
        status = _build.library().picasso_lq_anybox(
            spots_t.data_ptr(), n, s, float(ftol), int(max_it),
            n if n_valid is None else int(n_valid), work.data_ptr(),
            theta.data_ptr(), stream,
        )
    _build.check(status, "lq_anybox")
    _build.count_launch(fit_anybox_one_pass_t)
    return theta


fit_anybox_one_pass_t.launches = 0

#: where a group of the any-box queue reads its spot's pixels (its C
#: entry's stage argument): the lanes-last batch, or a stage in shared
#: memory
STAGES = ("batch", "shared")
#: threads a block the any-box queue may launch, the most first
ANYBOX_THREADS = (128, 64, 32)
#: the axis-factor rows a group keeps in shared memory (csrc/
#: lq_anybox_queue.cu: gx, dgx, dsx, gy, dgy, dsy, the trial's gx)
ANYBOX_FACTOR_ROWS = 7
#: fields of :func:`anybox_queue_info`, in picasso_lq_anybox_queue_info's
#: order
ANYBOX_QUEUE_INFO = ("threads", "blocks_per_sm", "registers",
                     "local_bytes", "shared_bytes", "sms", "group")
#: lanes of the any-box queue's group, a compile-time constant of
#: csrc/lq_anybox_queue.cu (PICASSO_LQANY_GROUP; tests/
#: torch_anybox_sweep.py builds 4, 16 and 32 and measured them at boxes
#: 16, 17 and 21, PERF.md)
ANYBOX_GROUP = 8


def anybox_area(box: int, stage: str) -> int:
    """Floats of shared memory a group takes (csrc/lq_anybox_queue.cu's
    lq_any_area): its factor rows and, with a shared stage, ``box`` rows
    of the odd stride box | 1."""
    return ANYBOX_FACTOR_ROWS * box + (box * (box | 1)
                                       if stage == "shared" else 0)


def anybox_queue_smem(box: int, stage: str, threads: int) -> int:
    """Shared bytes a block of ``threads`` of the any-box queue takes: an
    area a group of :data:`ANYBOX_GROUP` lanes."""
    return 4 * (threads // ANYBOX_GROUP) * anybox_area(box, stage)


def anybox_queue_config(box: int) -> dict:
    """The any-box queue's launch arguments at ``box``, worked out from
    the box against :data:`SHARED_LIMIT`:

    - ``stage``: where a group reads its spot's pixels, one of
      :data:`STAGES`: a stage in shared memory while a warp's groups'
      areas fit (boxes up to 117), else the batch;
    - ``threads``: the most of :data:`ANYBOX_THREADS` whose areas fit;

    with ``shared_bytes`` (:func:`anybox_queue_smem`), the compiled
    ``group`` (:data:`ANYBOX_GROUP`) and its ``rounds`` = ceil(box /
    group) points and rows a lane. Raises where even a warp's factor rows
    do not fit."""
    check_box(box)

    def fits(stage, threads):
        return anybox_queue_smem(box, stage, threads) <= SHARED_LIMIT

    stage = "shared" if fits("shared", 32) else "batch"
    if not fits(stage, 32):
        raise ValueError(f"box {box}: the LM queue's factor rows of a warp "
                         "pass the shared bytes a block may hold")
    threads = next(t for t in ANYBOX_THREADS if fits(stage, t))
    return {"stage": stage, "threads": threads,
            "shared_bytes": anybox_queue_smem(box, stage, threads),
            "group": ANYBOX_GROUP, "rounds": -(-box // ANYBOX_GROUP)}


def anybox_queue_info(box: int, cfg=None, lib=None) -> dict:
    """What the any-box queue's kernel (of ``lib``) is for ``box`` and the
    launch arguments ``cfg`` (by default :func:`anybox_queue_config`'s) on
    the current card: the :data:`ANYBOX_QUEUE_INFO` fields."""
    lib = lib or _build.library()
    cfg = cfg or anybox_queue_config(box)
    info = (ctypes.c_int * len(ANYBOX_QUEUE_INFO))()
    _build.check(lib.picasso_lq_anybox_queue_info(
        box, STAGES.index(cfg["stage"]), cfg["threads"], info),
        "lq_anybox_queue_info")
    return dict(zip(ANYBOX_QUEUE_INFO, info))


def _launch_anybox(lib, spots_t, max_it: int, ftol: float, n_valid,
                   cfg: dict) -> torch.Tensor:
    """One launch of lq_anybox_queue.cu's queue (of ``lib``: the
    package's, or a -D build of tests/torch_anybox_sweep.py) with the
    launch arguments ``cfg`` (:func:`anybox_queue_config`'s ``stage`` and
    ``threads``), its counter zeroed here; returns theta (6, N)."""
    s, _, n = spots_t.shape
    theta = torch.empty((6, n), dtype=torch.float32, device=spots_t.device)
    counter = torch.zeros(1, dtype=torch.int32, device=spots_t.device)
    with torch.cuda.device(spots_t.device):
        stream = torch.cuda.current_stream(spots_t.device).cuda_stream
        status = lib.picasso_lq_anybox_queue(
            spots_t.data_ptr(), n, s, float(ftol), int(max_it),
            n if n_valid is None else int(n_valid),
            STAGES.index(cfg["stage"]), cfg["threads"], counter.data_ptr(),
            theta.data_ptr(), stream,
        )
    _build.check(status, "lq_anybox_queue")
    return theta


def fit_anybox_t(spots_t: torch.Tensor, max_it: int, ftol: float = 1e-6,
                 n_valid=None) -> torch.Tensor:
    """The LM fit at any box >= 1 (csrc/lq_anybox_queue.cu): LM-fit a
    lanes-last (S, S, N) f32 batch in one launch of the any-box work
    queue, in which a group of lanes steps each spot from its stage in
    shared memory and takes the next claimed spot when its own ends, the
    box a launch argument, its launch arguments
    :func:`anybox_queue_config`'s. Returns theta (6, N), x/y relative to
    the box centre, equal to :func:`fit_anybox_one_pass_t` bit for bit
    (and at boxes 5-15 to :func:`fit_t`). Lanes at index >= ``n_valid``
    start done. The other wrappers route a CUDA batch of a box outside
    ``BOXES`` here. On the CPU it is the plain fit, uncounted."""
    if not on_cuda(spots_t):
        return _lq._lm_core(spots_t, max_it, ftol, n_valid)
    check_spots(spots_t)
    if spots_t.shape[-1] == 0:
        return torch.empty((6, 0), dtype=torch.float32,
                           device=spots_t.device)
    theta = _launch_anybox(_build.library(), spots_t, max_it, ftol, n_valid,
                           anybox_queue_config(spots_t.shape[0]))
    _build.count_launch(fit_anybox_t)
    return theta


fit_anybox_t.launches = 0


def fit_t(spots_t: torch.Tensor, max_it: int, ftol: float = 1e-6,
          n_valid=None) -> torch.Tensor:
    """K3 in one pass, one thread a spot (lq_fit.cu): LM-fit a
    lanes-last (S, S, N) f32 batch. Returns theta (6, N), x/y relative
    to the box centre. Lanes at index >= ``n_valid`` start done."""
    if not on_cuda(spots_t):
        return _lq._lm_core(spots_t, max_it, ftol, n_valid)
    if any_box(spots_t):
        return fit_anybox_t(spots_t, max_it, ftol, n_valid)
    s, _, n = spots_t.shape
    theta = torch.empty((6, n), dtype=torch.float32, device=spots_t.device)
    if n == 0:
        return theta
    with torch.cuda.device(spots_t.device):
        stream = torch.cuda.current_stream(spots_t.device).cuda_stream
        status = _build.library().picasso_lq_fit(
            spots_t.data_ptr(), n, s, float(ftol), int(max_it),
            n if n_valid is None else int(n_valid), theta.data_ptr(), stream,
        )
    _build.check(status, "lq_fit")
    _build.count_launch(fit_t)
    return theta


fit_t.launches = 0


def fit_boundary_t(spots_t: torch.Tensor, max_it: int, ftol: float = 1e-6,
                   n_valid=None) -> torch.Tensor:
    """K6: picasso_tpu's fit_pallas_boundary_t, the fit of :func:`fit_t`
    in phases that end at ``default_boundaries(max_it)`` with the lanes
    stably reordered stragglers first between phases (the argsort of
    ``done``, and a permute of the spots and the carry). A TPU lane
    cannot take new work when its spot converges, so the phases gather
    the spots still running into whole vregs. A lane of the card can: on
    a CUDA tensor K6 is one launch of :func:`fit_queue_t`'s work queue,
    in which a slot whose spot is done takes the next one, so no phase
    boundary, argsort or permute is left to do and the result does not
    depend on the boundaries; counted on ``fit_boundary_t.launches`` (1
    a fit). On the CPU it is the phase schedule over the plain
    ops/lq._lm_init/_lm_rounds, uncounted. Equals :func:`fit_t` bit for
    bit either way."""
    return _fit_phases(spots_t, max_it, ftol, n_valid,
                       default_boundaries(max_it))


fit_boundary_t.launches = 0


def _fit_phases(spots_t, max_it, ftol, n_valid, boundaries):
    """K6 with phases ending at ``boundaries``: on the card one launch of
    the work queue (the boundaries do not exist there), on the CPU the
    phase schedule."""
    if any_box(spots_t):
        return fit_anybox_t(spots_t, max_it, ftol, n_valid)
    if on_cuda(spots_t):
        theta = _launch_queue(spots_t, max_it, ftol, n_valid)
        if spots_t.shape[-1]:
            _build.count_launch(fit_boundary_t)
        return theta
    ends = phase_ends(boundaries, max_it)
    if not ends:
        return _lq._lm_core(spots_t, max_it, ftol, n_valid)
    if spots_t.shape[-1] == 0:
        return torch.zeros((6, 0), dtype=torch.float32)

    def phase(mode, spots, k, carry):
        if mode == START:
            carry = _lq._lm_init(spots, n_valid)
        return _lq._lm_rounds(spots, *carry, k, ftol)

    carry, inv = run_phases(phase, spots_t, max_it, ends, 3, RESUME)
    return carry[0][:, inv]


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


def _launch_queue(spots_t, max_it, ftol, n_valid, coop_steps=None):
    """One launch of roi_lq_queue.cu's work queue on ``spots_t``'s card
    (none for an empty batch); returns theta (6, N) in input order."""
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
    return theta


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
    if any_box(spots_t):
        return fit_anybox_t(spots_t, max_it, ftol, n_valid)
    if coop_steps is not None and (coop_steps.device != spots_t.device
                                   or coop_steps.dtype != torch.int32):
        raise ValueError("coop_steps must be an int32 tensor on the card")
    theta = _launch_queue(spots_t, max_it, ftol, n_valid, coop_steps)
    if spots_t.shape[-1]:
        _build.count_launch(fit_queue_t)
    return theta


fit_queue_t.launches = 0

#: fit2D's LM route (ops/lq.fit_spots_batched): the work queue
#: (:func:`fit_queue_t`) or the one pass (:func:`fit_t`), the one with
#: the lower median in chip_smoke.py's turns at max_it 30 on the first
#: 262,144-ROI block of its movie (PERF.md). Both equal K6 bit for bit.
ROI_FIT = fit_queue_t
