"""Riccati-form ADMM for the walking stance GRF MPC.

Counterpart of ``mpc_limx_control_tpu.ops.riccati``: the sparse (state and
control) form of the warm ADMM of ``make_admm_fused``. Each ADMM x-update

    min 1/2 z' (H + rho G'G) z + (f - rho G'(v - y))' z

is the LQR with stage weights (2Q, 2R + rho Gu'Gu), tracking terms
-2Q x_ref and per-step input terms -rho Gu'(v_t - y_t), solved by a
backward Riccati recursion and a forward rollout. The gains depend only on
the QP's matrices, so the factorization runs once per solve and every
iteration is one backward linear sweep and one forward rollout of [B, nx]
vectors: the same iterates as the condensed warm ADMM up to rounding.

Batch-first. The JAX module's ``lax.scan`` steps are Python loops over the
horizon here (N small-matrix products each, plain torch on any device);
``make_admm_riccati_single`` (riccati.py:229), a custom-vmap adapter for
the per-scenario JAX tick, has no counterpart: the port's controller is
batch-first and calls :func:`make_admm_riccati` directly. The reduced
matrices are 3 x 3 and inverted in closed form (:func:`_inv3`), as in JAX.
"""

from __future__ import annotations

import torch

from mpc_limx_control_tpu_torch.core.types import QPSolution


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of [..., 3, 3] (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _diag(v, dtype, device):
    return torch.diag(torch.tensor(v, dtype=dtype, device=device))


def riccati_factor(Ad, Bd_t, q_diag, r_diag, p_diag, Gu, rho):
    """Backward Riccati factorization, batched.

    Ad [B,nx,nx]; Bd_t [B,N,nx,nu]. Weights in the condensed QP's scaling
    (H = 2(B'Qbar B + Rbar) + rho G'G): Q~ = 2 diag(q), terminal 2 diag(p),
    R~ = 2 diag(r) + rho Gu'Gu.

    Returns per-step tensors with the step first: K_t [N,B,nu,nx], Hinv_t
    [N,B,nu,nu], BtP_t = Bd_t' P_{t+1} [N,B,nu,nx] and Acl_t = Ad - Bd_t K_t
    [N,B,nx,nx].
    """
    dtype, device = Ad.dtype, Ad.device
    Q2 = 2.0 * _diag(q_diag, dtype, device)
    P2 = 2.0 * _diag(p_diag, dtype, device)
    Gu_ = torch.tensor(Gu, dtype=dtype, device=device)
    R2 = 2.0 * _diag(r_diag, dtype, device) + rho * (Gu_.T @ Gu_)
    N = Bd_t.shape[1]
    P = P2.expand_as(Ad)
    K, Hinv, BtP, Acl = [None] * N, [None] * N, [None] * N, [None] * N
    for t in range(N - 1, -1, -1):
        Bd = Bd_t[:, t]
        BtP[t] = Bd.transpose(-1, -2) @ P                  # B' P [B,nu,nx]
        Hs = R2 + BtP[t] @ Bd                              # [B,nu,nu]
        Hinv[t] = _inv3(Hs) if Hs.shape[-1] == 3 else torch.linalg.inv(Hs)
        K[t] = Hinv[t] @ (BtP[t] @ Ad)                     # gain
        Acl[t] = Ad - Bd @ K[t]
        P = Q2 + Ad.transpose(-1, -2) @ P @ Acl[t]
        P = 0.5 * (P + P.transpose(-1, -2))
    return (torch.stack(K), torch.stack(Hinv), torch.stack(BtP),
            torch.stack(Acl))


def riccati_solve(Ad, Bd_t, factors, x0, x_ref, q_diag, p_diag, r_lin):
    """One LQR solve with the precomputed factorization.

    r_lin [B,N,nu]: per-step input linear terms (the ADMM -rho Gu'(v_t -
    y_t)). Returns u [B,N,nu]. Affine recursions (the cross terms cancel
    through K' = A'P B Hinv):

        k_t = Hinv_t (B_t' s_{t+1} + r_t)
        s_t = q_t + Acl_t' s_{t+1} - K_t' r_t
        u_t = -K_t x_t - k_t,   x_{t+1} = A x_t + B_t u_t

    with q_t = -2Q x_ref_t (t >= 1; q_0 = 0, x_0 is fixed) and
    s_N = -2P x_ref_N.
    """
    K, Hinv, _, Acl = factors
    dtype, device = Ad.dtype, Ad.device
    Q2 = 2.0 * _diag(q_diag, dtype, device)
    P2 = 2.0 * _diag(p_diag, dtype, device)
    N = Bd_t.shape[1]

    def mv(A, x):
        return (A @ x[..., None])[..., 0]

    def mtv(A, x):
        return (A.transpose(-1, -2) @ x[..., None])[..., 0]

    s = -mv(P2, x_ref[:, N])                               # s_N
    ks = [None] * N
    for t in range(N - 1, -1, -1):
        Bd, r_t = Bd_t[:, t], r_lin[:, t]
        ks[t] = mv(Hinv[t], mtv(Bd, s) + r_t)
        q_t = (-mv(Q2, x_ref[:, t]) if t >= 1
               else torch.zeros_like(s))
        s = q_t + mtv(Acl[t], s) - mtv(K[t], r_t)
    x = x0
    us = []
    for t in range(N):
        u = -mv(K[t], x) - ks[t]
        x = mv(Ad, x) + mv(Bd_t[:, t], u)
        us.append(u)
    return torch.stack(us, 1)


def make_admm_riccati(cfg_srbd):
    """Warm-started ADMM with Riccati-factorized x-updates: the interface
    and (up to rounding) the iterates of ``mpc_fused_cuda.make_admm_fused``
    with one foot per step -- fn(Ad, Bd_t, x_ref, x0, z_warm, y_warm) ->
    (QPSolution, (z, y)), batch-first: Ad [B,13,13], Bd_t [B,N,13,3], x_ref
    [B,N+1,13], x0 [B,13], z_warm [B,3N], y_warm [B,6N]."""
    c = cfg_srbd
    N = c.horizon
    mu = float(c.friction_mu)
    Gu = ((1.0, 0.0, -mu), (-1.0, 0.0, -mu),
          (0.0, 1.0, -mu), (0.0, -1.0, -mu),
          (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
    hu = (0.0, 0.0, 0.0, 0.0, float(c.fz_max), -float(c.fz_min))
    q_diag = tuple(float(v) for v in c.q_diag)
    r_diag = tuple(float(v) for v in c.r_diag)
    p_diag = tuple(float(c.p_scale) * float(v) for v in c.q_diag)
    iters = int(c.solver.admm_warm_iters)
    rho = float(c.solver.admm_rho)
    alpha = float(c.solver.admm_alpha)

    def solve(Ad, Bd_t, x_ref, x0, z_warm, y_warm):
        dtype, device = x0.dtype, x0.device
        B = x0.shape[0]
        nu = Bd_t.shape[-1]
        rows = len(Gu)
        Gu_ = torch.tensor(Gu, dtype=dtype, device=device)
        h_full = torch.tensor(hu, dtype=dtype, device=device).repeat(N)[None]
        factors = riccati_factor(Ad, Bd_t, q_diag, r_diag, p_diag, Gu, rho)

        def lqr(v, y):
            # r_t = -rho Gu'(v_t - y_t), per step
            w = (v - y).reshape(B, N, rows)
            r_lin = -rho * (w @ Gu_)
            u = riccati_solve(Ad, Bd_t, factors, x0, x_ref, q_diag, p_diag,
                              r_lin)
            return u.reshape(B, N * nu)

        def g_mv(z):
            return (z.reshape(B, N, nu) @ Gu_.T).reshape(B, -1)

        v = torch.minimum(g_mv(z_warm), h_full)
        y = y_warm
        for _ in range(iters):
            z = lqr(v, y)
            gzr = alpha * g_mv(z) + (1.0 - alpha) * v
            v_new = torch.minimum(gzr + y, h_full)
            y = y + gzr - v_new
            v = v_new
        z = lqr(v, y)
        r_prim = torch.amax(torch.abs(g_mv(z) - v), -1)
        return QPSolution(u=z, iterations=iters, residual=r_prim), (z, y)

    return solve
