"""Plain PyTorch versions of the batched Cholesky / SPD-solve kernels.

Counterparts of the bodies of ``mpc_limx_control_tpu.ops.chol_pallas``
(``_chol_body`` :34, ``_fwd_sub`` :68, ``_bwd_sub`` :93) written out as the
CUDA kernels of ``csrc/chol.cu`` run them: a column loop with the
``max(d, 1e-30)`` pivot clamp and the ``1 / sqrt(d)``-scaled column,
explicit forward and backward column sweeps against the reciprocal of the
clamped diagonal, and an explicit inverse of the factor. No library
factorization or triangular solve is called here: the tests and
``chip_smoke.py`` hold the kernels against these functions, and
``ops/chol_cuda.py`` runs them for CPU tensors.

Batch-first: M, L [B, n, n]; rhs [B, n, k]. Any floating dtype.
"""

from __future__ import annotations

import torch

PIVOT_FLOOR = 1e-30


def cholesky_plain(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of M [B,n,n] (only its lower triangle is
    read): pivot d = max(M_jj, 1e-30), column scaled by 1 / sqrt(d), the
    trailing rank-1 update, strict upper triangle zero on return."""
    A = M.clone()
    n = A.shape[-1]
    for j in range(n):
        d = torch.clamp(A[:, j, j], min=PIVOT_FLOOR)
        inv = 1.0 / torch.sqrt(d)
        A[:, j, j] = torch.sqrt(d)
        if j + 1 < n:
            col = A[:, j + 1:, j] * inv[:, None]
            A[:, j + 1:, j] = col
            A[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    return torch.tril(A)


def _diag_inv(L: torch.Tensor) -> torch.Tensor:
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return 1.0 / torch.clamp(d, min=PIVOT_FLOOR)


def chol_solve_plain(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L')^-1 rhs by a forward then a backward column sweep; L [B,n,n]
    lower, rhs [B,n,k]. The diagonal is clamped at 1e-30 in both."""
    n = L.shape[-1]
    dinv = _diag_inv(L)
    Y = rhs.clone()
    for j in range(n):
        yj = Y[:, j] * dinv[:, j, None]
        Y[:, j] = yj
        if j + 1 < n:
            Y[:, j + 1:] -= L[:, j + 1:, j, None] * yj[:, None, :]
    for j in range(n - 1, -1, -1):
        xj = Y[:, j] * dinv[:, j, None]
        Y[:, j] = xj
        if j > 0:
            Y[:, :j] -= L[:, j, :j, None] * xj[:, None, :]
    return Y


def posdef_solve_plain(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """M^-1 rhs for SPD M [B,n,n], rhs [B,n,k]: factor, then both sweeps
    (the function of posdef_solve and posdef_solve_fast)."""
    return chol_solve_plain(cholesky_plain(M), rhs)


def factor_inverse_plain(L: torch.Tensor) -> torch.Tensor:
    """T = L^-1 (lower) row by row: T_ii = 1 / max(L_ii, 1e-30),
    T[i, :i] = -T_ii L[i, :i] T[:i, :i] -- the explicit factor inverse of
    the fused MPC kernels' ``solve_form="inv"``
    (mpc_fused_pallas.py:249-263)."""
    n = L.shape[-1]
    dinv = _diag_inv(L)
    T = torch.zeros_like(L)
    T[:, 0, 0] = dinv[:, 0]
    for i in range(1, n):
        row = (L[:, i, None, :i] @ T[:, :i, :i])[:, 0]
        T[:, i, :i] = -row * dinv[:, i, None]
        T[:, i, i] = dinv[:, i]
    return T
