"""Wrappers of the CUDA LM fit kernel (csrc/lq_fit.cu): K3, the
single-pass fit, and K6, the same fit split into resumable phases with
stragglers-first lane order between them.

Counterpart of picasso_tpu/ops/lq_pallas.py (fit_pallas_t,
fit_pallas_boundary_t). A CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain PyTorch version of the same phases
(ops/lq.py). Nothing here falls back from one to the other.

Launch counts (plain integers): ``fit_t.launches`` counts the kernel's
single-pass (FULL) launches, ``fit_boundary_t.launches`` the phase
(START/RESUME) launches of the K6 schedule.
"""

from __future__ import annotations

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
