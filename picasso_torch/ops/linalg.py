"""Batched tiny SPD matrices, unrolled over the matrix dimension.

Counterpart of picasso_tpu/ops/linalg.py. The batch index N sits on the
last axis and ``A[p][q]`` is a list-of-lists of (N,) tensors, so every
step is an elementwise op over the batch. Used by the MLE CRLB (the
float32 inverse of the equilibrated Fisher matrix) and the LM step of
the LQ fit (the damped 6x6 normal equations); the CUDA fit kernels run
the same recurrences per spot.
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


def chol_solve(L: list[list[torch.Tensor]], b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given L = chol(A); b is (P, N), returns (P, N).
    Forward then backward substitution, dividing by the diagonal."""
    P = len(L)
    y: list[torch.Tensor | None] = [None] * P
    for i in range(P):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x: list[torch.Tensor | None] = [None] * P
    for i in reversed(range(P)):
        s = y[i]
        for k in range(i + 1, P):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD A x = b for (P, P, N) / (P, N) batches; a non-SPD A
    gives NaNs."""
    return chol_solve(chol_factor(A), b)


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
