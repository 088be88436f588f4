"""Batched, fixed-iteration QP solvers.

Counterpart of ``mpc_limx_control_tpu.ops.qp`` for

    min_z 1/2 z'Hz + f'z   s.t.   G z <= h

* :func:`pdip_qp` / :func:`_batched_pdip` / :func:`make_pdip` /
  :func:`make_pdip_warm`: primal-dual interior point with Mehrotra
  predictor-corrector, a fixed number of Newton steps, one factorization
  of M = H + G'DG per step shared by the affine and the corrector solve;
  cold start z0 = -H^-1 f or the primal-only warm start.
* :func:`_batched_admm` / :func:`make_admm_warm`: over-relaxed ADMM with
  one factorization of K = H + rho G'G + reg I per solve, warm-started
  with (z, scaled dual y).
* :func:`_batched_admm_kron` / :func:`make_admm_warm_kron`: the same ADMM
  ("kinv" form) for a block-diagonal G = kron(I_N, Gu), which is never
  formed.
* :func:`admm_qp`: the two-sided form l <= Gz <= u.
* :func:`ruiz_equilibrate`: OSQP-style scaling of an ill-conditioned QP.

Batch-first: H [B,n,n], f [B,n], G [B,m,n], h [B,m]. The public solvers
also take one unbatched problem, or a mix (a shared H and G with batched f
and h): what lacks the batch dimension is expanded.

Dispatch by device, as everywhere in the port. CUDA tensors: every SPD
factorization and solve is a hand-written kernel of ``ops/chol_cuda.py``
(``cholesky`` once per Newton step, ``chol_solve`` for the affine and the
corrector direction, ``posdef_solve`` for the cold start; float32 only).
CPU tensors: ``torch.linalg``, as the JAX package off the TPU.
``plain_twins=True`` runs the kernels' plain versions (``ops/chol.py``)
instead, on any device: the tests and ``chip_smoke.py`` compare with it.

``solve_form`` of :func:`_batched_admm` picks how each iteration applies
K^-1:

* ``"kinv"``: the explicit K^-1 = L^-T L^-1 formed once per solve, then
  mat-vecs only; the dense ADMM of ``SolverConfig(method="admm")`` and the
  JAX composition's form. Its factorization dispatches as above; forming
  L^-1 and the products stay ``torch`` calls, as they are XLA calls in JAX.
* ``"subst"``: exact forward / backward triangular solves against the
  factor every iteration -- the plain twin of the fused MPC kernels.
* ``"linv"``: the explicit factor inverse T = L^-1 formed once by a row
  recursion, then x = T'(T b) per iteration -- the plain twin of the fused
  kernels' ``solve_form="inv"``.

The two twins are references only (library factorization on any device).
``"kinv"`` differs from them by the f32 rounding of the explicit inverse
(~1e-2 relative residual of K Kinv - I at the walking sizes), which ADMM
absorbs as an inexact-iteration perturbation.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpc_limx_control_tpu_torch.core.types import QPSolution
from mpc_limx_control_tpu_torch.ops import chol as cholp
from mpc_limx_control_tpu_torch.ops import chol_cuda

SOLVE_FORMS = ("kinv", "subst", "linv")


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _mtv(A, x):
    """A' x without forming the transpose."""
    return (x[..., None, :] @ A)[..., 0, :]


def _consts(dtype):
    """(eps, cap on lam / s, diagonal regularization) of the working type."""
    f64 = dtype == torch.float64
    return ((1e-12 if f64 else 1e-8), (1e14 if f64 else 1e7),
            (1e-12 if f64 else 1e-6))


def _posdef_chol(M: torch.Tensor, reg: float,
                 plain_twins: bool = False) -> torch.Tensor:
    """Lower Cholesky factor of M + reg I, M [B,n,n]."""
    n = M.shape[-1]
    A = M + reg * torch.eye(n, dtype=M.dtype, device=M.device)
    if plain_twins:
        return cholp.cholesky_plain(A)
    if A.device.type == "cpu":
        # a late f32 interior-point iterate can lose positive definiteness:
        # its factor is NaN (as jnp.linalg.cholesky returns it) and the
        # solver's best-iterate pick never takes what follows from it
        L, info = torch.linalg.cholesky_ex(A)
        return torch.where(info[..., None, None] > 0,
                           torch.full_like(L, float("nan")), L)
    return chol_cuda.cholesky(A.contiguous())


def _chol_solve(L: torch.Tensor, rhs: torch.Tensor,
                plain_twins: bool = False) -> torch.Tensor:
    """(L L')^-1 rhs for rhs [B,n]."""
    r = rhs[..., None]
    if plain_twins:
        return cholp.chol_solve_plain(L, r)[..., 0]
    if L.device.type == "cpu":
        y = torch.linalg.solve_triangular(L, r, upper=False)
        return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                             upper=True)[..., 0]
    return chol_cuda.chol_solve(L, r.contiguous())[..., 0]


def _posdef_solve(M: torch.Tensor, rhs: torch.Tensor,
                  plain_twins: bool = False) -> torch.Tensor:
    """M^-1 rhs for SPD M [B,n,n], rhs [B,n]; one kernel launch on the
    card."""
    if plain_twins or M.device.type == "cpu":
        return _chol_solve(_posdef_chol(M, 0.0, plain_twins), rhs,
                           plain_twins)
    return chol_cuda.posdef_solve(M.contiguous(),
                                  rhs[..., None].contiguous())[..., 0]


def _max_step(v: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """Largest alpha in (0, 1] with v + alpha dv >= 0, per problem."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return torch.clamp(ratio.amin(-1), max=1.0)


def _batch(args, ndims):
    """Expand what lacks the batch dimension; returns (args, batched)."""
    B = None
    for a, nd in zip(args, ndims):
        if a is not None and a.ndim == nd + 1:
            B = a.shape[0]
    batched = B is not None
    out = []
    for a, nd in zip(args, ndims):
        if a is None or a.ndim == nd + 1:
            out.append(a)
        elif a.ndim == nd:
            out.append(a.expand(B if batched else 1, *a.shape))
        else:
            raise ValueError(f"expected {nd} or {nd + 1} dimensions, got "
                             f"{tuple(a.shape)}")
    return out, batched


def _unbatch_sol(sol: QPSolution) -> QPSolution:
    return QPSolution(u=sol.u[0], iterations=sol.iterations,
                      residual=sol.residual[0])


def ruiz_equilibrate(H, f, G, h, iters: int = 6):
    """OSQP-style Ruiz equilibration, batched or not.

    Returns (H', f', G', h', D): the scaled problem in z' = D^-1 z has
    H' = D H D, f' = D f, G' = E G D, h' = E h; after solving, u = D z'.
    """
    (H, f, G, h), batched = _batch((H, f, G, h), (2, 1, 2, 1))
    D = torch.ones_like(f)
    E = torch.ones_like(h)
    Ha, Ga = H.abs(), G.abs()
    for _ in range(iters):
        Hs = Ha * D[:, :, None] * D[:, None, :]
        Gs = Ga * E[:, :, None] * D[:, None, :]
        col = torch.maximum(Hs.amax(-2), Gs.amax(-2))
        D = D / torch.sqrt(torch.clamp(col, min=1e-8))
        Gs = Ga * E[:, :, None] * D[:, None, :]
        E = E / torch.sqrt(torch.clamp(Gs.amax(-1), min=1e-8))
    out = (H * D[:, :, None] * D[:, None, :], f * D,
           G * E[:, :, None] * D[:, None, :], h * E, D)
    return out if batched else tuple(o[0] for o in out)


def _batched_pdip(H, f, G, h, iters: int, z_warm=None, lam_warm=None,
                  plain_twins: bool = False):
    """Batch-first PDIP: H [B,n,n], f [B,n], G [B,m,n], h [B,m].

    One factorization of M + reg I per Newton step, shared by the affine
    and the corrector solve. (z_warm, lam_warm): primal-only warm start --
    the previous solution as z0 with the slacks re-derived and pushed
    interior and the multipliers restarted at 1 (lam_warm is threaded but
    not used: warm multipliers of a changed problem poison the first
    Newton step). Returns (QPSolution, (z_best, lam_final)).
    """
    del lam_warm
    m = h.shape[-1]
    eps, d_cap, reg = _consts(H.dtype)
    Gt = G.transpose(-1, -2)

    if z_warm is not None:
        z0, margin = z_warm, 0.1
    else:
        n = f.shape[-1]
        eye = torch.eye(n, dtype=H.dtype, device=H.device)
        z0, margin = -_posdef_solve(H + reg * eye, f, plain_twins), 1.0
    s0_raw = h - _mv(G, z0)
    s0 = (s0_raw + torch.clamp(-s0_raw.amin(-1, keepdim=True), min=0.0)
          + margin)
    lam0 = torch.ones_like(h)
    f_scale = 1.0 + f.abs().amax(-1)
    mu0 = (s0 * lam0).sum(-1) / m

    def merit_of(z, s, lam):
        r_dual = _mv(H, z) + f + _mtv(G, lam)
        r_prim = torch.clamp(_mv(G, z) - h, min=0.0)
        mu = (s * lam).sum(-1) / m
        return r_dual.abs().amax(-1) / f_scale + r_prim.amax(-1) + mu / mu0

    z, s, lam = z0, s0, lam0
    z_best, merit_best = z0, merit_of(z0, s0, lam0)
    for _ in range(iters):
        r_dual = _mv(H, z) + f + _mtv(G, lam)
        r_prim = _mv(G, z) + s - h
        mu = (s * lam).sum(-1) / m
        s_safe = torch.clamp(s, min=eps)
        d = torch.clamp(lam / s_safe, max=d_cap)
        L = _posdef_chol(H + Gt @ (G * d[..., None]), reg, plain_twins)

        def direction(r_comp):
            dz = _chol_solve(
                L, -r_dual + _mtv(G, (r_comp - lam * r_prim) / s_safe),
                plain_twins)
            ds = -r_prim - _mv(G, dz)
            return dz, ds, -(r_comp + lam * ds) / s_safe

        rc_aff = s * lam
        _, ds_a, dlam_a = direction(rc_aff)
        a_aff = torch.minimum(_max_step(s, ds_a),
                              _max_step(lam, dlam_a))[..., None]
        mu_aff = ((s + a_aff * ds_a) * (lam + a_aff * dlam_a)).sum(-1) / m
        sigma = (mu_aff / torch.clamp(mu, min=eps)) ** 3

        dz, ds, dlam = direction(rc_aff - (sigma * mu)[..., None]
                                 + ds_a * dlam_a)
        alpha = (0.99 * torch.minimum(_max_step(s, ds),
                                      _max_step(lam, dlam)))[..., None]
        z = z + alpha * dz
        s = torch.clamp(s + alpha * ds, min=eps)
        lam = torch.clamp(lam + alpha * dlam, min=eps)
        merit = merit_of(z, s, lam)
        better = merit < merit_best
        z_best = torch.where(better[..., None], z, z_best)
        merit_best = torch.where(better, merit, merit_best)
    sol = QPSolution(u=z_best, iterations=iters, residual=merit_best)
    return sol, (z_best, lam)


def pdip_qp(H, f, G, h, iters: int = 20, scale: bool = False,
            plain_twins: bool = False) -> QPSolution:
    """Cold fixed-iteration Mehrotra predictor-corrector IPM for one
    problem or a batch. With ``scale=True`` the problem is
    Ruiz-equilibrated first (recommended in f32)."""
    (H, f, G, h), batched = _batch((H, f, G, h), (2, 1, 2, 1))
    if scale:
        H, f, G, h, D = ruiz_equilibrate(H, f, G, h)
    sol, _ = _batched_pdip(H, f, G, h, iters, plain_twins=plain_twins)
    if scale:
        sol = QPSolution(u=sol.u * D, iterations=iters,
                         residual=sol.residual)
    return sol if batched else _unbatch_sol(sol)


def make_pdip(iters: int = 20, plain_twins: bool = False):
    """Cold PDIP solver fn(H, f, G, h) -> QPSolution for one problem or a
    batch (the kernels of ops/chol_cuda.py on CUDA tensors)."""
    def solve(H, f, G, h):
        return pdip_qp(H, f, G, h, iters=iters, plain_twins=plain_twins)

    return solve


def make_pdip_warm(iters: int = 6, plain_twins: bool = False):
    """Warm-started PDIP: fn(H, f, G, h, z_warm, lam_warm) ->
    (QPSolution, (z_final, lam_final)), threaded through receding-horizon
    resolves; one problem or a batch."""
    def solve(H, f, G, h, z_warm, lam_warm):
        args, batched = _batch((H, f, G, h, z_warm, lam_warm),
                               (2, 1, 2, 1, 1, 1))
        sol, (z, lam) = _batched_pdip(*args[:4], iters, z_warm=args[4],
                                      lam_warm=args[5],
                                      plain_twins=plain_twins)
        if batched:
            return sol, (z, lam)
        return _unbatch_sol(sol), (z[0], lam[0])

    return solve


def _batched_admm(H, f, G, h, z_warm, y_warm, iters: int, rho: float,
                  alpha: float, solve_form: str = "kinv",
                  plain_twins: bool = False):
    """H [B,n,n], f [B,n], G [B,m,n], h [B,m], z_warm [B,n], y_warm [B,m].

    Returns (QPSolution, (z, y)) with y the scaled dual, threaded tick to
    tick as the warm state. The residual is the splitting-consistency
    measure |Gz - v|_inf / (1 + |f|_inf), strictly positive for any finite
    iteration count. See the module docstring for ``solve_form``;
    ``plain_twins`` applies to the ``"kinv"`` form.
    """
    if solve_form not in SOLVE_FORMS:
        raise ValueError(f"solve_form must be one of {SOLVE_FORMS}, "
                         f"got {solve_form!r}")
    dtype = H.dtype
    n = f.shape[-1]
    reg = _consts(dtype)[2]
    eye = torch.eye(n, dtype=dtype, device=H.device)
    Gt = G.transpose(-1, -2)
    K = H + rho * (Gt @ G) + reg * eye

    if solve_form == "kinv":
        L = _posdef_chol(K, 0.0, plain_twins)
        Linv = torch.linalg.solve_triangular(L, eye.expand_as(L),
                                             upper=False)
        Kinv = Linv.transpose(-1, -2) @ Linv
        M1 = rho * (Kinv @ Gt)                          # [B, n, m]
        z_base = -_mv(Kinv, f)

        def z_of(w):                                    # K^-1 (-f + rho G'w)
            return z_base + _mv(M1, w)
    elif solve_form == "linv":
        T = cholp.factor_inverse_plain(torch.linalg.cholesky(K))

        def z_of(w):
            return _mtv(T, _mv(T, -f + rho * _mv(Gt, w)))
    else:
        L = torch.linalg.cholesky(K)
        Lt = L.transpose(-1, -2)

        def z_of(w):
            rhs = (-f + rho * _mv(Gt, w))[..., None]
            y1 = torch.linalg.solve_triangular(L, rhs, upper=False)
            return torch.linalg.solve_triangular(Lt, y1, upper=True)[..., 0]

    v = torch.minimum(_mv(G, z_warm), h)
    y = y_warm
    for _ in range(iters):
        z = z_of(v - y)
        gz = _mv(G, z)
        gz_relaxed = alpha * gz + (1.0 - alpha) * v
        v_new = torch.minimum(gz_relaxed + y, h)
        y = y + gz_relaxed - v_new
        v = v_new
    z = z_of(v - y)

    r_prim = torch.amax(torch.abs(_mv(G, z) - v), -1)
    residual = r_prim / (1.0 + torch.amax(torch.abs(f), -1))
    return QPSolution(u=z, iterations=iters, residual=residual), (z, y)


def make_admm_warm(iters: int = 10, rho: float = 1.0, alpha: float = 1.6,
                   plain_twins: bool = False):
    """Warm-started dense ADMM: fn(H, f, G, h, z_warm, y_warm) ->
    (QPSolution, (z, y)); one problem or a batch. The factorization of K
    is the ``cholesky`` kernel on CUDA tensors."""
    def solve(H, f, G, h, z_warm, y_warm):
        args, batched = _batch((H, f, G, h, z_warm, y_warm),
                               (2, 1, 2, 1, 1, 1))
        sol, (z, y) = _batched_admm(*args, iters, rho, alpha,
                                    plain_twins=plain_twins)
        if batched:
            return sol, (z, y)
        return _unbatch_sol(sol), (z[0], y[0])

    return solve


def _batched_admm_kron(H, f, Gu, h, z_warm, y_warm, iters: int, rho: float,
                       alpha: float, plain_twins: bool = False):
    """:func:`_batched_admm` ("kinv" form) for G = kron(I_N, Gu).

    The per-step friction cone gives every horizon step the same [mu,nu]
    block (models/srbd.py:friction_cone_rows), so G is never formed:
    G'G = kron(I_N, Gu'Gu), M1 = rho K^-1 G' is a per-block [n,N,nu] x
    [mu,nu] contraction and the iterations' G mat-vecs contract over nu.
    The same iterates as :func:`_batched_admm` on the expanded G.

    H [B,n,n]; f [B,n]; Gu [mu,nu] (shared by the batch and the horizon);
    h [B,m], z_warm [B,n], y_warm [B,m] with n = N nu, m = N mu. The
    factorization of K is the ``cholesky`` kernel on CUDA tensors.
    """
    dtype, device = H.dtype, H.device
    B, n = f.shape
    Gu = torch.as_tensor(Gu, dtype=dtype, device=device)
    mu_, nu_ = Gu.shape
    N = n // nu_
    m = N * mu_
    reg = _consts(dtype)[2]
    eye = torch.eye(n, dtype=dtype, device=device)
    GtG = torch.kron(torch.eye(N, dtype=dtype, device=device), Gu.T @ Gu)
    K = H + (rho * GtG + reg * eye)
    L = _posdef_chol(K, 0.0, plain_twins)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    Kinv = Linv.transpose(-1, -2) @ Linv
    M1 = rho * (Kinv.reshape(B, n, N, nu_) @ Gu.T).reshape(B, n, m)
    z_base = -_mv(Kinv, f)

    def g_mv(z):                                        # G z, [B,m]
        return (z.reshape(B, N, nu_) @ Gu.T).reshape(B, m)

    v = torch.minimum(g_mv(z_warm), h)
    y = y_warm
    for _ in range(iters):
        z = z_base + _mv(M1, v - y)
        gz_relaxed = alpha * g_mv(z) + (1.0 - alpha) * v
        v_new = torch.minimum(gz_relaxed + y, h)
        y = y + gz_relaxed - v_new
        v = v_new
    z = z_base + _mv(M1, v - y)

    r_prim = torch.amax(torch.abs(g_mv(z) - v), -1)
    residual = r_prim / (1.0 + torch.amax(torch.abs(f), -1))
    return QPSolution(u=z, iterations=iters, residual=residual), (z, y)


def make_admm_warm_kron(Gu: torch.Tensor, iters: int = 10, rho: float = 1.0,
                        alpha: float = 1.6, plain_twins: bool = False):
    """Warm-started ADMM for G = kron(I_N, Gu): fn(H, f, h, z_warm,
    y_warm) -> (QPSolution, (z, y)); one problem or a batch. Gu [mu,nu]
    (the friction-cone block) is closed over; the expanded G is never
    formed. The factorization of K is the ``cholesky`` kernel on CUDA
    tensors."""
    def solve(H, f, h, z_warm, y_warm):
        args, batched = _batch((H, f, h, z_warm, y_warm), (2, 1, 1, 1, 1))
        sol, (z, y) = _batched_admm_kron(args[0], args[1], Gu, *args[2:],
                                         iters, rho, alpha,
                                         plain_twins=plain_twins)
        if batched:
            return sol, (z, y)
        return _unbatch_sol(sol), (z[0], y[0])

    return solve


def admm_qp(H, f, G, l, u, iters: int = 50, rho: float = 1.0,
            alpha: float = 1.6, z_warm: Optional[torch.Tensor] = None,
            y_warm: Optional[torch.Tensor] = None,
            plain_twins: bool = False) -> QPSolution:
    """Over-relaxed ADMM for  min 1/2 z'Hz + f'z  s.t.  l <= Gz <= u,
    one problem or a batch: one factorization of H + rho G'G + reg I per
    solve, a triangular solve pair and a clip per iteration."""
    (H, f, G, l, u, z_warm, y_warm), batched = _batch(
        (H, f, G, l, u, z_warm, y_warm), (2, 1, 2, 1, 1, 1, 1))
    reg = _consts(H.dtype)[2]
    Gt = G.transpose(-1, -2)
    L = _posdef_chol(H + rho * (Gt @ G), reg, plain_twins)
    z = torch.zeros_like(f) if z_warm is None else z_warm
    y = torch.zeros_like(l) if y_warm is None else y_warm
    v = _mv(G, z)
    for _ in range(iters):
        z = _chol_solve(L, -f + rho * _mv(Gt, v - y), plain_twins)
        gz_relaxed = alpha * _mv(G, z) + (1.0 - alpha) * v
        v_new = torch.minimum(torch.maximum(gz_relaxed + y, l), u)
        y = y + gz_relaxed - v_new
        v = v_new
    r_prim = (_mv(G, z) - v).abs().amax(-1)
    sol = QPSolution(u=z, iterations=iters,
                     residual=r_prim / (1.0 + f.abs().amax(-1)))
    return sol if batched else _unbatch_sol(sol)
