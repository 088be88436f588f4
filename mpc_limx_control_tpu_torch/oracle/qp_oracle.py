"""Float64 CPU oracle QP solver.

The reference validates its MPC numerics with qpOASES (dense active-set,
src/QPSolver.cpp:83-106).  qpOASES is unavailable here, and the reference's
constraint plumbing is broken anyway (its "equality constraints"
A_eq = B_aug.bottomRows, b_eq = A_aug.bottomRows * x0 at src/QPSolver.cpp:63-64
are over-determined — NX*N rows on NU*N < NX*N unknowns — and generally
infeasible; additionally Eigen column-major buffers are handed to row-major
qpOASES readers).  So the authoritative ground truth for this repo is the
*correct* condensed-QP formulation solved to machine precision:

    min_z  1/2 z' H z + f' z   s.t.  G z <= h

via a Mehrotra predictor-corrector primal-dual interior point method in
float64 NumPy, iterated adaptively until the KKT residuals drop below 1e-10.
Every TPU-path solver is tested against this oracle (tolerance on the control
sequence u, per SURVEY.md §7).
"""

from __future__ import annotations

import numpy as np


def kkt_residuals(H, f, G, h, z, lam):
    """Return (stationarity, primal feasibility, complementarity) residuals."""
    r_stat = H @ z + f + G.T @ lam
    s = h - G @ z
    r_feas = np.minimum(s, 0.0)
    r_comp = lam * s
    return (
        float(np.linalg.norm(r_stat, ord=np.inf)),
        float(np.linalg.norm(r_feas, ord=np.inf)),
        float(np.linalg.norm(r_comp, ord=np.inf)),
    )


def solve_qp_oracle(H, f, G=None, h=None, tol=1e-10, max_iters=100):
    """Solve min 1/2 z'Hz + f'z s.t. Gz <= h to ~machine precision (float64).

    Returns (z, lam, info_dict).  H must be symmetric positive definite.
    With no constraints the exact solution -H^{-1} f is returned.
    """
    H = np.asarray(H, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64).reshape(-1)
    n = f.shape[0]

    if G is None or G.shape[0] == 0:
        z = np.linalg.solve(H, -f)
        return z, np.zeros(0), {"iters": 0, "residuals": (0.0, 0.0, 0.0)}

    G = np.asarray(G, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64).reshape(-1)
    m = G.shape[0]

    # Initial point: unconstrained minimizer, slacks/multipliers pushed interior.
    z = np.linalg.solve(H, -f)
    s = h - G @ z
    shift = max(0.0, -float(s.min())) + 1.0
    s = s + shift
    lam = np.ones(m)

    def max_step(v, dv):
        neg = dv < 0
        if not neg.any():
            return 1.0
        return min(1.0, float(np.min(-v[neg] / dv[neg])))

    info = {"iters": 0}
    mu = float(s @ lam) / m
    for it in range(max_iters):
        r_dual = H @ z + f + G.T @ lam          # stationarity
        r_prim = G @ z + s - h                   # primal (with slack)
        mu = float(s @ lam) / m

        if mu < 1e-8 or (np.linalg.norm(r_dual, np.inf) < tol
                         and np.linalg.norm(r_prim, np.inf) < tol
                         and mu < tol):
            break

        d = lam / np.maximum(s, 1e-12)           # m
        M = H + G.T @ (d[:, None] * G)           # n x n, SPD
        L = np.linalg.cholesky(M)

        def solve_M(rhs):
            return np.linalg.solve(L.T, np.linalg.solve(L, rhs))

        def direction(r_comp):
            """Newton direction for residuals (r_dual, r_prim, r_comp)
            of the system H dz + G'dlam = -r_dual; G dz + ds = -r_prim;
            lam*ds + s*dlam = -r_comp (elementwise)."""
            rhs = -r_dual + G.T @ ((r_comp - lam * r_prim) / s)
            dz = solve_M(rhs)
            ds = -r_prim - G @ dz
            dlam = -(r_comp + lam * ds) / s
            return dz, ds, dlam

        # ---- affine (predictor) step: r_comp = s*lam
        dz_a, ds_a, dlam_a = direction(s * lam)
        alpha_aff = min(max_step(s, ds_a), max_step(lam, dlam_a))
        mu_aff = float(
            (s + alpha_aff * ds_a) @ (lam + alpha_aff * dlam_a)) / m
        sigma = (mu_aff / mu) ** 3 if mu > 0 else 0.0

        # ---- corrector step with Mehrotra second-order term
        dz, ds, dlam = direction(s * lam - sigma * mu + ds_a * dlam_a)

        alpha = 0.995 * min(max_step(s, ds), max_step(lam, dlam))
        z = z + alpha * dz
        s = s + alpha * ds
        lam = lam + alpha * dlam
        info["iters"] = it + 1

    # ---- active-set polish (OSQP-style): the IPM above resolves the active
    # set long before mu reaches machine precision; re-solving the
    # equality-constrained KKT system on that set gives an exact solution.
    z_p, lam_p = _polish(H, f, G, h, z, lam, s, mu)
    if z_p is not None:
        res_ipm = kkt_residuals(H, f, G, h, z, lam)
        res_pol = kkt_residuals(H, f, G, h, z_p, lam_p)
        if max(res_pol) <= max(res_ipm):
            z, lam = z_p, lam_p

    info["residuals"] = kkt_residuals(H, f, G, h, z, lam)
    return z, lam, info


def _polish(H, f, G, h, z, lam, s, mu):
    """Solve the KKT system restricted to the detected active set.

    Active set detection: lam_i > s_i (multiplier dominates slack).  The
    restricted system  [H  G_A'; G_A  0] [z; nu] = [-f; h_A]  is solved by
    least squares (G_A may contain dependent rows).  Returns (None, None)
    if the detected set is empty-safe or the solve fails validation.
    """
    act = lam > np.maximum(s, np.sqrt(mu))
    n = z.shape[0]
    if not act.any():
        return np.linalg.solve(H, -f), np.zeros_like(lam)
    G_a = G[act]
    k = G_a.shape[0]
    KKT = np.zeros((n + k, n + k))
    KKT[:n, :n] = H
    KKT[:n, n:] = G_a.T
    KKT[n:, :n] = G_a
    rhs = np.concatenate([-f, h[act]])
    sol, *_ = np.linalg.lstsq(KKT, rhs, rcond=None)
    z_p = sol[:n]
    lam_p = np.zeros_like(lam)
    lam_p[act] = sol[n:]
    return z_p, lam_p
