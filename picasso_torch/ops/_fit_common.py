"""What the fit wrappers share (ops/mle_cuda.py, ops/lq_cuda.py,
ops/winfit_cuda.py): the boxes their templated kernels are built for,
the check of a spot batch, and the phase schedule of K2, K5, K6 and K7
(the phase boundaries and the stragglers-first lane order between
phases). The fits take any box >= 1, as the JAX package's do; identify
has its own minimum (ops/identify.MIN_BOX, 3)."""

from __future__ import annotations

import torch

#: the boxes of the templated fit kernels; a CUDA batch of any other box
#: >= MIN_BOX (1 and 2 among them) goes to the any-box kernels
#: (csrc/mle_anybox_queue.cu, lq_anybox_queue.cu, cut_anybox.cu)
BOXES = (3, 5, 7, 9, 11, 13, 15)
MIN_BOX = 1
#: the shared bytes a block may opt in to on an H100 (227 KB), against
#: which the any-box kernels choose their launch configurations
#: (ops/mle_cuda.anybox_queue_config, ops/lq_cuda.anybox_queue_config,
#: ops/winfit_cuda.anybox_cut_config, ops/identify_cuda.anybox_tile_shape;
#: their entries check the card's own limit)
SHARED_LIMIT = 232_448
# the kernels' modes (csrc/fit_common.cuh)
FULL, START, RESUME, FINISH = 0, 1, 2, 3


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no fit kernel for tensors on {t.device}")


def check_box(box: int) -> None:
    """Raise for a box the CUDA fit kernels do not take (below
    :data:`MIN_BOX`: 0 and negative boxes)."""
    if box < MIN_BOX:
        raise ValueError(
            f"the CUDA fit kernels take boxes >= {MIN_BOX}, got {box}")


def check_spots(spots_t: torch.Tensor) -> None:
    """Raise unless ``spots_t`` is a contiguous f32 (S, S, N) batch of a
    box the fit kernels take."""
    if spots_t.ndim != 3 or spots_t.shape[0] != spots_t.shape[1]:
        raise ValueError(f"spots must be (S, S, N), got {tuple(spots_t.shape)}")
    check_box(spots_t.shape[0])
    if spots_t.dtype != torch.float32 or not spots_t.is_contiguous():
        raise ValueError("spots must be contiguous float32")


def any_box(spots_t: torch.Tensor) -> bool:
    """True for a CUDA batch (checked) of a box without a templated
    kernel, which the wrappers route to the any-box kernels; False for a
    CPU batch or a templated box."""
    if not on_cuda(spots_t):
        return False
    check_spots(spots_t)
    return spots_t.shape[0] not in BOXES


def default_boundaries(max_it: int) -> tuple[int, ...]:
    """The JAX package's two phase boundaries (~max_it/6 and /2):
    (16, 50) at max_it 100."""
    return tuple(sorted({
        b for b in (max(max_it // 6, 4), max_it // 2) if b < max_it
    }))


def stragglers_first(done: torch.Tensor) -> torch.Tensor:
    """Stable permutation (new position -> old lane) putting the lanes
    that have not converged first."""
    return torch.argsort(done[0], stable=True)


def phase_ends(boundaries, max_it: int) -> list[int]:
    """The distinct boundaries strictly inside (0, max_it), ascending."""
    return sorted({int(b) for b in boundaries if 0 < int(b) < max_it})


def run_phases(phase, src: torch.Tensor, max_it: int, ends: list[int],
               done_row: int, last_mode: int):
    """A fit run as phases that end at ``ends`` (non-empty, from
    :func:`phase_ends`) and at max_it. ``phase(mode, src, k, carry)`` runs
    up to k iterations of every lane in mode START (``carry`` None),
    RESUME or ``last_mode`` and returns the carry (or, from FINISH, the
    outputs). ``src`` is what the lanes read, lane axis last: the (S, S,
    N) ROI batch, or the (3, N) hit list of the fused cut+fit. Before each
    later phase, ``src`` and the carry are stably reordered stragglers
    first by carry row ``done_row``, so the warps of converged spots
    retire together. Every lane's trajectory is independent of its
    position, so the schedule equals one pass bit for bit. Returns (the
    last phase's output, inv) with ``out[..., inv]`` in the input order."""
    n = src.shape[-1]
    carry = phase(START, src, ends[0], None)
    orig = torch.arange(n, device=src.device)
    ks = [b - a for a, b in zip(ends, ends[1:])] + [max_it - ends[-1]]
    for i, k in enumerate(ks):
        perm = stragglers_first(carry[done_row])
        src = src[..., perm].contiguous()
        carry = tuple(c[:, perm].contiguous() for c in carry)
        orig = orig[perm]
        carry = phase(last_mode if i == len(ks) - 1 else RESUME, src, k,
                      carry)
    inv = torch.empty_like(orig)
    inv[orig] = torch.arange(n, device=orig.device)
    return carry, inv
