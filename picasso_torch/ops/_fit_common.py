"""What the two fit wrappers share (ops/mle_cuda.py, ops/lq_cuda.py):
the boxes their kernels are built for, the check of a spot batch, and
the phase schedule of K2 and K6 (the phase boundaries and the
stragglers-first lane order between phases)."""

from __future__ import annotations

import torch

BOXES = (5, 7, 9, 11, 13, 15)  # box 3: see csrc/mle_fit.cu


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no fit kernel for tensors on {t.device}")


def check_spots(spots_t: torch.Tensor) -> None:
    """Raise unless ``spots_t`` is a contiguous f32 (S, S, N) batch of a
    box the fit kernels are built for."""
    if spots_t.ndim != 3 or spots_t.shape[0] != spots_t.shape[1]:
        raise ValueError(f"spots must be (S, S, N), got {tuple(spots_t.shape)}")
    if spots_t.shape[0] not in BOXES:
        raise ValueError(
            f"the CUDA fit kernels take boxes {BOXES}, got {spots_t.shape[0]}"
        )
    if spots_t.dtype != torch.float32 or not spots_t.is_contiguous():
        raise ValueError("spots must be contiguous float32")


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
