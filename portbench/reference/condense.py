"""Condensation: prediction matrices and the dense condensed QP.

A frozen copy of the port's ``ops/condense.py`` (reference
src/QPSolver.cpp:31-81), trimmed to :func:`prediction_matrices` and
:func:`condense`, batch-first with time-varying (Ad_t, Bd_t) over the
horizon.

Shapes: Ad [B,nx,nx] or [B,N,nx,nx]; Bd [B,nx,nu] or [B,N,nx,nu];
A_blocks [B,N+1,nx,nx] (A_blocks[i] = Ad_{i-1}...Ad_0);
B_blocks [B,N+1,N,nx,nu] (B_blocks[i,j] = Ad_{i-1}..Ad_{j+1} Bd_j, j < i).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class CondensedQP(NamedTuple):
    """min 1/2 z'Hz + f'z s.t. Gz <= h; H [B,nz,nz], f [B,nz], G [B,m,nz],
    h [B,m], plus the prediction blocks for state reconstruction."""

    H: torch.Tensor
    f: torch.Tensor
    G: torch.Tensor
    h: torch.Tensor
    A_blocks: torch.Tensor
    B_blocks: torch.Tensor


def prediction_matrices(Ad: torch.Tensor, Bd: torch.Tensor, N: int):
    """(A_blocks [B,N+1,nx,nx], B_blocks [B,N+1,N,nx,nu]) by the row
    recursion G_i = Ad_{i-1} G_{i-1} + e_{i-1} (x) Bd_{i-1}."""
    B, nx = Ad.shape[0], Ad.shape[-1]
    nu = Bd.shape[-1]
    dtype, device = Ad.dtype, Ad.device
    if Ad.ndim == 3:
        Ad = Ad[:, None].expand(B, N, nx, nx)
    if Bd.ndim == 3:
        Bd = Bd[:, None].expand(B, N, nx, nu)
    eye = torch.eye(nx, dtype=dtype, device=device).expand(B, nx, nx)
    phis = [eye]
    for t in range(N):
        phis.append(Ad[:, t] @ phis[-1])
    A_blocks = torch.stack(phis, 1)

    g = torch.zeros((B, N, nx, nu), dtype=dtype, device=device)
    rows = [g]
    for t in range(N):
        g = Ad[:, t, None] @ g
        g = g.clone()
        g[:, t] = g[:, t] + Bd[:, t]
        rows.append(g)
    B_blocks = torch.stack(rows, 1)
    return A_blocks, B_blocks


def _flatten_b(B_blocks: torch.Tensor) -> torch.Tensor:
    """[B,N+1,N,nx,nu] -> [B,(N+1)*nx,N*nu] dense prediction matrix."""
    b, n1, N, nx, nu = B_blocks.shape
    return B_blocks.permute(0, 1, 3, 2, 4).reshape(b, n1 * nx, N * nu)


def condense(Ad: torch.Tensor, Bd: torch.Tensor, Q: torch.Tensor,
             R: torch.Tensor, P: torch.Tensor, N: int, x0: torch.Tensor,
             x_ref: torch.Tensor,
             u_min: Optional[float] = None, u_max: Optional[float] = None,
             x_min=None, x_max=None,
             extra_G: Optional[torch.Tensor] = None,
             extra_h: Optional[torch.Tensor] = None) -> CondensedQP:
    """Condensed QP (src/QPSolver.cpp:50-68): H = 2(B'Q̄B + R̄),
    f = 2 B'Q̄(A_aug x0 - x_ref). x0 [B,nx]; x_ref [B,N+1,nx]; Q/R/P
    shared [nx,nx]/[nu,nu]/[nx,nx]. Constraint rows, in this order: the
    optional input box, the optional state box x_min <= x_i <= x_max
    through prediction rows 1..N (src/QPSolver.cpp:71-80; x_min / x_max
    length nx) and extra rows extra_G [m,N*nu] / extra_h [B,m] (the
    friction cone)."""
    B, nx = x0.shape
    nu = Bd.shape[-1]
    dtype, device = x0.dtype, x0.device
    A_blocks, B_blocks = prediction_matrices(Ad, Bd, N)
    B_mat = _flatten_b(B_blocks)                        # [B,(N+1)nx,nz]
    nz = N * nu

    Qs = torch.cat([Q.expand(N, nx, nx), P[None]], 0)   # [N+1,nx,nx]
    B_rows = B_mat.reshape(B, N + 1, nx, nz)
    QB = (Qs[None] @ B_rows).reshape(B, (N + 1) * nx, nz)
    R_bar = torch.kron(torch.eye(N, dtype=dtype, device=device), R)
    H = 2.0 * (B_mat.transpose(-1, -2) @ QB + R_bar)
    H = 0.5 * (H + H.transpose(-1, -2))

    x_pred_free = (A_blocks @ x0[:, None, :, None])[..., 0].reshape(B, -1)
    err = x_pred_free - x_ref.reshape(B, -1)
    f = 2.0 * (QB.transpose(-1, -2) @ err[..., None])[..., 0]

    G_parts, h_parts = [], []
    if u_min is not None:
        eye_z = torch.eye(nz, dtype=dtype, device=device)
        G_parts += [eye_z, -eye_z]
        h_parts += [torch.full((B, nz), u_max, dtype=dtype, device=device),
                    torch.full((B, nz), -u_min, dtype=dtype, device=device)]
    if x_min is not None:
        B_pred = B_mat[:, nx:]                          # states 1..N
        xf = x_pred_free[:, nx:]
        x_max_t = torch.as_tensor(x_max, dtype=dtype, device=device).repeat(N)
        x_min_t = torch.as_tensor(x_min, dtype=dtype, device=device).repeat(N)
        G_parts += [B_pred, -B_pred]
        h_parts += [x_max_t - xf, -(x_min_t - xf)]
    if extra_G is not None:
        G_parts.append(extra_G)
        h_parts.append(extra_h.expand(B, -1))
    G = torch.cat([g.expand(B, -1, -1) for g in G_parts], 1)
    h = torch.cat(h_parts, -1)
    return CondensedQP(H=H, f=f, G=G, h=h, A_blocks=A_blocks,
                       B_blocks=B_blocks)


