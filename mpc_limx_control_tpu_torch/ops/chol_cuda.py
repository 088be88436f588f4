"""Batched Cholesky factorization and SPD solves: CUDA kernel wrappers.

Counterpart of ``mpc_limx_control_tpu.ops.chol_pallas``, same four public
names and argument order, batch-first:

* :func:`cholesky` (chol_pallas.py:144): M [B,n,n] SPD -> lower L [B,n,n];
* :func:`chol_solve` (:172): L [B,n,n], rhs [B,n,k] -> (L L')^-1 rhs;
* :func:`posdef_solve` (:293): M, rhs -> M^-1 rhs in one launch;
* :func:`posdef_solve_fast` (:263): the same function, the forward
  substitution riding on the factorization.

The kernels are ``csrc/chol.cu`` (one block per matrix, any B >= 1, any
k >= 1, n <= 256 as far as shared memory reaches, float32; each reads only
the lower triangle of its matrix argument). A wrapper launches its
kernel for CUDA tensors and runs the kernel's plain version (``ops/chol.py``)
for CPU tensors; nothing here calls a library factorization.
"""

from __future__ import annotations

import ctypes

import torch

from mpc_limx_control_tpu_torch.ops import _build
from mpc_limx_control_tpu_torch.ops import chol as plain

SMEM_LIMIT_BYTES = 232448     # what a block can opt in to on sm_90
MAX_N = 256                   # eight rows per lane in a substitution sweep

_SIZER = "chol_params_bytes"
CHOLESKY = _build.Kernel("cholesky", n_ptr=2, params_sizer=_SIZER)
CHOL_SOLVE = _build.Kernel("chol_solve", n_ptr=3, params_sizer=_SIZER)
POSDEF_SOLVE = _build.Kernel("posdef_solve", n_ptr=3, params_sizer=_SIZER)
POSDEF_SOLVE_FAST = _build.Kernel("posdef_solve_fast", n_ptr=3,
                                  params_sizer=_SIZER)
KERNELS = {k.name: k for k in (CHOLESKY, CHOL_SOLVE, POSDEF_SOLVE,
                               POSDEF_SOLVE_FAST)}


class CholParams(ctypes.Structure):
    """Mirror of ``CholParams`` in csrc/chol.cu."""

    _fields_ = [("n", ctypes.c_int), ("k", ctypes.c_int)]


def smem_bytes(name: str, n: int, k: int = 1) -> int:
    """Dynamic shared memory per block of kernel `name` (the arithmetic of
    csrc/chol.cu: the packed lower triangle, plus the diagonal and its
    reciprocal where the kernel factors; ``posdef_solve_fast`` also the k
    right-hand sides appended as k rows of n floats)."""
    tri = n * (n + 1) // 2
    if name == "chol_solve":
        return 4 * tri
    if name == "posdef_solve_fast":
        return 4 * (tri + k * n + 2 * n)
    return 4 * (tri + 2 * n)


def size_reason(name: str, n: int, k: int = 1) -> str | None:
    """Why kernel `name` cannot take order n with k right-hand sides
    (None: it can)."""
    need = smem_bytes(name, n, k)
    if n < 1 or k < 1 or n > MAX_N or need > SMEM_LIMIT_BYTES:
        return (f"{name}: n = {n}, k = {k} needs {need} bytes of shared "
                f"memory; the kernel takes 1 <= n <= {MAX_N}, k >= 1 within "
                f"{SMEM_LIMIT_BYTES} bytes per block")
    return None


def _check_size(name: str, n: int, k: int) -> None:
    reason = size_reason(name, n, k)
    if reason is not None:
        raise ValueError(reason)


def _launch(kernel, tensors_in, out, n, k):
    dev = out.device
    prm = CholParams(n=n, k=k)
    kernel.launch(prm, [t.data_ptr() for t in tensors_in] + [out.data_ptr()],
                  out.shape[0], dev)
    return out


def _matrix(name, M):
    if M.ndim != 3 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"{name}: expected [B, n, n], got {tuple(M.shape)}")
    return M.shape[0], M.shape[-1]


def _rhs(name, rhs, B, n):
    if rhs.ndim != 3 or rhs.shape[:2] != (B, n):
        raise ValueError(f"{name}: rhs {tuple(rhs.shape)} does not fit "
                         f"[{B}, {n}, k]")
    return rhs.shape[-1]


def _on_cuda(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {t.device}")


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky: M [B,n,n] SPD -> L [B,n,n], strict upper
    triangle zero, pivots clamped at 1e-30. CUDA tensors launch the
    ``cholesky`` kernel (float32 only); CPU tensors run
    ``chol.cholesky_plain``."""
    B, n = _matrix("cholesky", M)
    if M.device.type == "cpu":
        return plain.cholesky_plain(M)
    _on_cuda("cholesky", M)
    _build.check_tensor("M", M, (B, n, n), M.device)
    _check_size("cholesky", n, 1)
    return _launch(CHOLESKY, (M,), torch.empty_like(M), n, 1)


def _solve(kernel, plain_fn, A, rhs):
    name = kernel.name
    B, n = _matrix(name, A)
    k = _rhs(name, rhs, B, n)
    if A.device.type == "cpu":
        return plain_fn(A, rhs)
    _on_cuda(name, A)
    _build.check_tensor("matrix", A, (B, n, n), A.device)
    _build.check_tensor("rhs", rhs, (B, n, k), A.device)
    _check_size(name, n, k)
    return _launch(kernel, (A, rhs), torch.empty_like(rhs), n, k)


def chol_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L')^-1 rhs with a precomputed lower factor L [B,n,n], rhs
    [B,n,k]; kernel ``chol_solve`` on CUDA tensors, ``chol_solve_plain``
    on CPU tensors."""
    return _solve(CHOL_SOLVE, plain.chol_solve_plain, L, rhs)


def posdef_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """M^-1 rhs for SPD M [B,n,n], rhs [B,n,k], factor and both sweeps in
    one launch of ``posdef_solve``; ``posdef_solve_plain`` on CPU
    tensors."""
    return _solve(POSDEF_SOLVE, plain.posdef_solve_plain, M, rhs)


def posdef_solve_fast(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The function of :func:`posdef_solve` (M symmetric) by the
    ``posdef_solve_fast`` kernel: the right-hand sides ride on the
    factorization as extra rows (the forward substitution inside it), then
    the backward sweep."""
    return _solve(POSDEF_SOLVE_FAST, plain.posdef_solve_plain, M, rhs)
