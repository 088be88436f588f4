"""Condensation: prediction matrices and the dense condensed QP.

Counterpart of ``mpc_limx_control_tpu.ops.condense`` (reference
src/QPSolver.cpp:31-81), batch-first: :func:`prediction_matrices`,
:func:`condense` and :func:`predict_states` take a leading batch dimension
B and time-varying (Ad_t, Bd_t) inputs over the horizon. The cached form
for LTI MPC (:func:`condense_cache`, :func:`linear_terms`) keeps ONE
system's x0-independent matrices, shared by every scenario of a batch.
:func:`condense_lti_diag` is the band form of :func:`condense` for a
step-invariant Ad and diagonal weights, with any leading batch dims.

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


def condense_lti_diag(Ad: torch.Tensor, Bd_t: torch.Tensor,
                      q_diag, r_diag, p_diag, N: int,
                      x0: torch.Tensor, x_ref: torch.Tensor):
    """Band-form condensation for LTI Ad + LTV Bd + DIAGONAL weights.

    The (H, f) of :func:`condense` (reference cost layout,
    src/QPSolver.cpp:50-60) without the prediction matrix B_mat
    [(N+1)nx, N nu] or QB, from the block-Toeplitz structure of B'Q̄B when
    Ad is step-invariant (the shared-yaw SRBD linearization):

        H[j,k]/2 = Bd_j' (Ad')^{k-j} W_k Bd_k + delta_jk R      (j <= k)
        W_k      = Q + Ad' W_{k+1} Ad,   W_{N-1} = P            (backward)
        f[j]/2   = Bd_j' s_j,   s_j = Q_{j+1} err_{j+1} + Ad' s_{j+1}

    Ad [..., nx, nx]; Bd_t [..., N, nx, nu]; q_diag / r_diag / p_diag of
    length nx / nu / nx; x0 [..., nx]; x_ref [..., N+1, nx], with any
    leading batch dims (broadcast). Returns (H [..., nz, nz], f [..., nz]),
    nz = N nu.
    """
    nx = Ad.shape[-1]
    nu = Bd_t.shape[-1]
    dtype, device = x0.dtype, x0.device
    nz = N * nu
    q = torch.as_tensor(q_diag, dtype=dtype, device=device)
    r = torch.as_tensor(r_diag, dtype=dtype, device=device)
    p = torch.as_tensor(p_diag, dtype=dtype, device=device)
    lead = torch.broadcast_shapes(Ad.shape[:-2], Bd_t.shape[:-3],
                                  x0.shape[:-1], x_ref.shape[:-2])
    AdT = Ad.transpose(-1, -2)

    # ---- W_k backward recursion (cost-to-go Gramians) ------------------
    Ws = [torch.diag(p).expand(*Ad.shape[:-2], nx, nx)]
    for _ in range(N - 1):
        Ws.append(torch.diag(q) + AdT @ Ws[-1] @ Ad)
    Ws = torch.stack(Ws[::-1], -3)                      # [..., N, nx, nx]
    V = Ws @ Bd_t                                       # W_k Bd_k

    # ---- band assembly: S[j, j+d] = Bd_j' (Ad')^d V_{j+d} --------------
    S = torch.zeros((*lead, N, N, nu, nu), dtype=dtype, device=device)
    BdT = Bd_t.transpose(-1, -2)
    T = V
    for d in range(N):
        if d > 0:
            T = AdT[..., None, :, :] @ T                # Ad' T_{d-1}[k]
        j = torch.arange(N - d, device=device)
        S[..., j, j + d, :, :] = BdT[..., :N - d, :, :] @ T[..., d:, :, :]

    U = S.transpose(-3, -2).reshape(*lead, nz, nz)      # upper incl. diag
    j = torch.arange(N, device=device)
    D = torch.zeros_like(S)
    D[..., j, j, :, :] = S[..., j, j, :, :]
    Dmat = D.transpose(-3, -2).reshape(*lead, nz, nz)
    R_bar = torch.diag(r.repeat(N))
    H = 2.0 * (U + U.transpose(-1, -2) - Dmat + R_bar)

    # ---- f: adjoint (backward) sweep instead of QB' err ----------------
    xs = [x0]
    for _ in range(N):
        xs.append((Ad @ xs[-1][..., None])[..., 0])
    err = torch.stack(xs, -2) - x_ref                   # [..., N+1, nx]
    qw = torch.cat([q.expand(N - 1, nx), p[None]], 0)   # Q_1..Q_N
    qerr = qw * err[..., 1:, :]                         # [..., N, nx]
    s = torch.zeros_like(qerr[..., 0, :])
    ss = []
    for k in range(N - 1, -1, -1):
        s = qerr[..., k, :] + (AdT @ s[..., None])[..., 0]
        ss.append(s)
    s = torch.stack(ss[::-1], -2)                       # s_j [..., N, nx]
    f = 2.0 * (BdT @ s[..., None])[..., 0].reshape(*lead, nz)
    return H, f


class CondensationCache(NamedTuple):
    """Per-(Ad, Bd) precomputation for LTI MPC: everything that does not
    depend on (x0, x_ref), for ONE system (no batch dimension). The
    reference rebuilds all of this every control step
    (src/QPSolver.cpp:31-60); caching it leaves two small products per
    tick.

    A_blocks [N+1,nx,nx]; B_mat [(N+1)nx, nz]; QB [(N+1)nx, nz];
    H [nz,nz]; G [m,nz] (constant for the box and state rows).
    """

    A_blocks: torch.Tensor
    B_mat: torch.Tensor
    QB: torch.Tensor
    H: torch.Tensor
    G: torch.Tensor
    N: int
    nx: int
    nu: int


def condense_cache(Ad, Bd, Q, R, P, N: int, with_state_rows: bool = True,
                   extra_G: Optional[torch.Tensor] = None
                   ) -> CondensationCache:
    """Precompute the x0-independent parts of the condensed QP from one
    system's Ad [nx,nx] (or [N,nx,nx]) and Bd [nx,nu] (or [N,nx,nu])."""
    nx, nu = Ad.shape[-1], Bd.shape[-1]
    dtype, device = Ad.dtype, Ad.device
    A_blocks, B_blocks = prediction_matrices(Ad[None], Bd[None], N)
    A_blocks = A_blocks[0]
    B_mat = _flatten_b(B_blocks)[0]
    nz = N * nu
    Qs = torch.cat([Q.expand(N, nx, nx), P[None]], 0)
    QB = (Qs @ B_mat.reshape(N + 1, nx, nz)).reshape((N + 1) * nx, nz)
    R_bar = torch.kron(torch.eye(N, dtype=dtype, device=device), R)
    H = 2.0 * (B_mat.T @ QB + R_bar)
    H = 0.5 * (H + H.T)
    eye_z = torch.eye(nz, dtype=dtype, device=device)
    G_parts = [eye_z, -eye_z]
    if with_state_rows:
        G_parts += [B_mat[nx:], -B_mat[nx:]]
    if extra_G is not None:
        G_parts.append(extra_G)
    return CondensationCache(A_blocks=A_blocks, B_mat=B_mat, QB=QB, H=H,
                             G=torch.cat(G_parts, 0), N=N, nx=nx, nu=nu)


def linear_terms(cache: CondensationCache, x0, x_ref, u_min, u_max,
                 x_min=None, x_max=None, extra_h=None):
    """Per-tick linear pieces (f, h) for the cached condensation.

    x0 [nx] with x_ref [N+1,nx], or x0 [B,nx] with x_ref [N+1,nx] or
    [B,N+1,nx]; the result has x0's batch dimension. Pass x_min / x_max
    exactly when the cache was built with state rows, and extra_h exactly
    when it was built with extra_G.
    """
    N, nx, nu = cache.N, cache.nx, cache.nu
    dtype, device = x0.dtype, x0.device
    nz = N * nu
    lead = x0.shape[:-1]
    # A_aug x0, [..., (N+1) nx]
    x_pred_free = (x0 @ cache.A_blocks.reshape(-1, nx).T)
    err = x_pred_free - x_ref.reshape(*x_ref.shape[:-2], -1)
    f = 2.0 * (err @ cache.QB)
    h_parts = [torch.full((*lead, nz), u_max, dtype=dtype, device=device),
               torch.full((*lead, nz), -u_min, dtype=dtype, device=device)]
    if x_min is not None:
        xf = x_pred_free[..., nx:]
        x_max_t = torch.as_tensor(x_max, dtype=dtype, device=device).repeat(N)
        x_min_t = torch.as_tensor(x_min, dtype=dtype, device=device).repeat(N)
        h_parts += [x_max_t - xf, -(x_min_t - xf)]
    if extra_h is not None:
        h_parts.append(extra_h.expand(*lead, -1))
    return f, torch.cat(h_parts, -1)


def predict_states(qp: CondensedQP, x0: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """The predicted state trajectory [B,N+1,nx] from the controls z
    [B,N*nu] of a batched condensed QP."""
    B, _, N, nx, nu = qp.B_blocks.shape
    free = (qp.A_blocks @ x0[:, None, :, None])[..., 0]
    forced = torch.einsum("bijxu,bju->bix", qp.B_blocks,
                          z.reshape(B, N, nu))
    return free + forced
