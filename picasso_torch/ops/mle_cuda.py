"""Wrappers of the CUDA MLE fit kernel (csrc/mle_fit.cu): K1, the
single-pass fit, and K2, the same fit split into resumable phases with
stragglers-first lane order between them; both for the methods
``sigmaxy`` and ``sigma``.

Counterpart of picasso_tpu/ops/mle_pallas.py (fit_pallas_t,
fit_pallas_boundary_t). A CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain PyTorch version of the same phases
(ops/mle.py). Nothing here falls back from one to the other.

Launch counts (plain integers): ``fit_t.launches`` counts the kernel's
single-pass (FULL) launches, ``fit_boundary_t.launches`` the phase
(START/RESUME/FINISH) launches of the K2 schedule.
"""

from __future__ import annotations

import torch

from picasso_torch import _build
from picasso_torch.ops import mle as _mle
from picasso_torch.ops._fit_common import (
    check_spots, default_boundaries, on_cuda, stragglers_first,
)

_FULL, _START, _RESUME, _FINISH = 0, 1, 2, 3
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
            carry=None):
    """One launch of the fit kernel on ``spots_t``'s card. START/RESUME
    return the carry (RESUME updates it in place); FULL/FINISH return
    (theta, crlb, ll, iters)."""
    lib = _build.library()
    s, _, n = spots_t.shape
    dev = spots_t.device
    f32 = dict(dtype=torch.float32, device=dev)
    r = _ROWS[method]
    if mode == _START:
        carry = (
            torch.empty((r, n), **f32), torch.empty((r, n), **f32),
            torch.empty((1, n), **f32), torch.empty((1, n), **f32),
            torch.empty((r, n), **f32),
        )
    outs = None
    if mode in (_FULL, _FINISH):
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
    out = _launch(_FULL, spots_t, eps, max_it, n_valid, method)
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


def _fit_phases(spots_t, eps, max_it, method, n_valid, boundaries):
    """The K2 schedule with phases ending at ``boundaries``."""
    _mle._check_method(method)
    cuda = on_cuda(spots_t)
    if cuda:
        check_spots(spots_t)
    n = spots_t.shape[-1]
    bs = sorted({int(b) for b in boundaries if 0 < int(b) < max_it})
    if not bs:
        return fit_t(spots_t, eps, max_it, method, n_valid)
    if n == 0:
        return _empty_fit(0, spots_t.device)

    def phase(mode, spots, k, carry=None):
        if cuda:
            out = _launch(mode, spots, eps, k, n_valid, method, carry)
            fit_boundary_t.launches += 1
            return out
        if mode == _START:
            return _mle._fit_start(spots, eps, k, method, n_valid)
        if mode == _RESUME:
            return _mle._fit_resume(spots, *carry, eps, k, method)
        return _mle._fit_finish(spots, *carry, eps, k, method)

    carry = phase(_START, spots_t, bs[0])
    orig = torch.arange(n, device=spots_t.device)
    ks = [b - a for a, b in zip(bs, bs[1:])] + [max_it - bs[-1]]
    for i, k in enumerate(ks):
        perm = stragglers_first(carry[2])
        spots_t = spots_t[:, :, perm].contiguous()
        carry = tuple(c[:, perm].contiguous() for c in carry)
        orig = orig[perm]
        mode = _FINISH if i == len(ks) - 1 else _RESUME
        carry = phase(mode, spots_t, k, carry)
    theta, crlb, ll, iters = carry
    inv = torch.empty_like(orig)
    inv[orig] = torch.arange(n, device=orig.device)
    return theta[:, inv], crlb[:, inv], ll[inv], iters[inv]


fit_boundary_t.launches = 0
