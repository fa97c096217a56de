"""Batched tiny SPD matrices, unrolled over the matrix dimension.

Counterpart of picasso_tpu/ops/linalg.py. The batch index N sits on the
last axis and ``A[p][q]`` is a list-of-lists of (N,) tensors, so every
step is an elementwise op over the batch. Used by the MLE CRLB (the
float32 inverse of the equilibrated Fisher matrix); the CUDA fit kernel
runs the same recurrences per spot.
"""

from __future__ import annotations

import torch


def _to_rows(A: torch.Tensor) -> list[list[torch.Tensor]]:
    P = A.shape[0]
    return [[A[i, j] for j in range(P)] for i in range(P)]


def chol_factor(A: torch.Tensor) -> list[list[torch.Tensor]]:
    """Cholesky A = L L^T of SPD (P, P, N) batches; L as a
    lower-triangular list-of-lists of (N,) tensors. Non-SPD inputs give
    NaNs, which propagate like the reference's failed fits."""
    a = _to_rows(A)
    P = len(a)
    L: list[list[torch.Tensor | None]] = [[None] * P for _ in range(P)]
    for j in range(P):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, P):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L  # type: ignore[return-value]


def chol_inv_diag(L: list[list[torch.Tensor]]) -> torch.Tensor:
    """diag(A^-1) from L = chol(A): with Z = L^-1,
    diag(A^-1)_k = sum_{j>=k} Z[j,k]^2. Returns (P, N)."""
    P = len(L)
    out = []
    for k in range(P):
        z: list[torch.Tensor | None] = [None] * P
        z[k] = 1.0 / L[k][k]
        acc = z[k] * z[k]
        for j in range(k + 1, P):
            s = -(L[j][k] * z[k])
            for m in range(k + 1, j):
                s = s - L[j][m] * z[m]
            z[j] = s / L[j][j]
            acc = acc + z[j] * z[j]
        out.append(acc)
    return torch.stack(out)


def spd_inv_diag(A: torch.Tensor) -> torch.Tensor:
    """diag(A^-1) for SPD (P, P, N) batches; (P, N)."""
    return chol_inv_diag(chol_factor(A))
