"""Small-matrix linear algebra, written out entry by entry.

The port's `rmp_tpu/ops/linalg.py`. These are the plain PyTorch solvers: the
pivoted LU is the arithmetic the CUDA resolve kernel (ops/cuda_resolve.py)
repeats inside one thread per environment.
"""
from __future__ import annotations

import torch


def safe_denom(d: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Sign-preserving magnitude clamp: |result| >= eps, sign kept (0 -> +eps).

    Guards divisions by (near-)singular pivots and diagonals, so an exactly
    singular combined metric gives a large but finite solution instead of
    Inf/NaN."""
    return torch.where(d >= 0, torch.clamp(d, min=eps), torch.clamp(d, max=-eps))


def cholesky_solve_unrolled(A: torch.Tensor, b: torch.Tensor,
                            ridge: float = 1e-6) -> torch.Tensor:
    """Solve (sym(A) + ridge*I) x = b for PSD A. A: (..., n, n), b: (..., n)."""
    n = A.shape[-1]
    A = 0.5 * (A + A.transpose(-1, -2))

    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[..., j, j] + ridge
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        Ljj = torch.sqrt(torch.clamp(d, min=1e-12))
        inv_Ljj = 1.0 / Ljj
        L[j][j] = Ljj
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_Ljj

    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]

    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def lu_solve_unrolled(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b by unrolled Gaussian elimination with partial pivoting.
    A: (..., n, n), b: (..., n); valid for indefinite systems.

    Tie rule: a row becomes the pivot only if its magnitude is strictly
    greater than the running pivot's; the displaced row takes the candidate's
    place (swap-free pairwise selection, as in the JAX package). Pivots and
    back-substitution diagonals go through safe_denom."""
    n = A.shape[-1]
    rows = [torch.cat([A[..., i, :], b[..., i:i + 1]], dim=-1)
            for i in range(n)]

    for k in range(n):
        piv = rows[k]
        piv_mag = torch.abs(piv[..., k])
        for i in range(k + 1, n):
            mag_i = torch.abs(rows[i][..., k])
            take = (mag_i > piv_mag)[..., None]
            new_i = torch.where(take, piv, rows[i])
            piv = torch.where(take, rows[i], piv)
            piv_mag = torch.maximum(piv_mag, mag_i)
            rows[i] = new_i
        rows[k] = piv
        inv_pivot = 1.0 / safe_denom(piv[..., k])
        for i in range(k + 1, n):
            factor = rows[i][..., k] * inv_pivot
            rows[i] = rows[i] - factor[..., None] * piv

    x = [None] * n
    for i in reversed(range(n)):
        s = rows[i][..., n]
        for j in range(i + 1, n):
            s = s - rows[i][..., j] * x[j]
        x[i] = s / safe_denom(rows[i][..., i])
    return torch.stack(x, dim=-1)
