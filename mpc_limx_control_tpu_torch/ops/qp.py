"""Batched warm-started ADMM for the condensed GRF QP.

Counterpart of ``mpc_limx_control_tpu.ops.qp._batched_admm``
(qp.py:383-457): over-relaxed ADMM for  min 1/2 z'Hz + f'z  s.t. Gz <= h
with ONE factorization of K = H + rho G'G + reg I per solve.

``solve_form`` picks how each iteration applies K^-1:

* ``"kinv"`` — the JAX composition's explicit K^-1 = L^-T L^-1 formed once
  per solve, then matvecs only. Use it for parity with the JAX CPU path.
* ``"subst"`` — exact forward/backward triangular solves against the
  Cholesky factor every iteration: the algorithm of the fused kernels, and
  so the plain twin they are compared with.

The two differ by the f32 rounding of the explicit inverse (~1e-2 relative
residual of K Kinv - I at the walking sizes), which ADMM absorbs as an
inexact-iteration perturbation.
"""

from __future__ import annotations

import torch

from mpc_limx_control_tpu_torch.core.types import QPSolution

SOLVE_FORMS = ("kinv", "subst")


def _batched_admm(H, f, G, h, z_warm, y_warm, iters: int, rho: float,
                  alpha: float, solve_form: str = "kinv"):
    """H [B,n,n], f [B,n], G [B,m,n], h [B,m], z_warm [B,n], y_warm [B,m].

    Returns (QPSolution, (z, y)) with y the scaled dual, threaded tick to
    tick as the warm state. The residual is the splitting-consistency
    measure |Gz - v|_inf / (1 + |f|_inf), strictly positive for any finite
    iteration count.
    """
    if solve_form not in SOLVE_FORMS:
        raise ValueError(f"solve_form must be one of {SOLVE_FORMS}, "
                         f"got {solve_form!r}")
    dtype = H.dtype
    n = f.shape[-1]
    reg = 1e-12 if dtype == torch.float64 else 1e-6
    eye = torch.eye(n, dtype=dtype, device=H.device)
    Gt = G.transpose(-1, -2)
    K = H + rho * (Gt @ G) + reg * eye
    L = torch.linalg.cholesky(K)

    def mv(A, x):
        return (A @ x[..., None])[..., 0]

    if solve_form == "kinv":
        Linv = torch.linalg.solve_triangular(
            L, eye.expand_as(L), upper=False)
        Kinv = Linv.transpose(-1, -2) @ Linv
        M1 = rho * (Kinv @ Gt)                          # [B, n, m]
        z_base = -mv(Kinv, f)

        def z_of(w):                                    # K^-1 (-f + rho G'w)
            return z_base + mv(M1, w)
    else:
        Lt = L.transpose(-1, -2)

        def z_of(w):
            rhs = (-f + rho * mv(Gt, w))[..., None]
            y1 = torch.linalg.solve_triangular(L, rhs, upper=False)
            return torch.linalg.solve_triangular(Lt, y1, upper=True)[..., 0]

    v = torch.minimum(mv(G, z_warm), h)
    y = y_warm
    for _ in range(iters):
        z = z_of(v - y)
        gz = mv(G, z)
        gz_relaxed = alpha * gz + (1.0 - alpha) * v
        v_new = torch.minimum(gz_relaxed + y, h)
        y = y + gz_relaxed - v_new
        v = v_new
    z = z_of(v - y)

    r_prim = torch.amax(torch.abs(mv(G, z) - v), -1)
    residual = r_prim / (1.0 + torch.amax(torch.abs(f), -1))
    return QPSolution(u=z, iterations=iters, residual=residual), (z, y)
