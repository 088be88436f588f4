"""Float64 NumPy re-derivation of the reference condensed-MPC pipeline.

Reproduces, in NumPy, the math of the *working* reference core:

* ZOH discretization via the augmented matrix exponential
  (src/QPSolver.cpp:21-29)
* prediction-matrix condensation A_aug/B_aug and cost H/f
  (src/QPSolver.cpp:36-60)
* input box bounds and state-prediction inequality rows
  (src/QPSolver.cpp:67-80)
* closed-loop plant rollout x <- Ad x + Bd u (src/QPSolver.cpp:108-111)
* the 500-step circle-tracking scenario of src/qpSolver_test.cpp:29-75 and
  src/linear_mpc_example.cpp:108-196.

Deviations from the reference, by design (documented in qp_oracle.py):
the over-determined "equality constraints" (src/QPSolver.cpp:63-64) are
dropped; constraints kept are the input box and the state box, and the QP is
solved to ~1e-10 KKT residual with the float64 interior-point oracle.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import expm

from mpc_limx_control_tpu_torch.oracle.qp_oracle import solve_qp_oracle


def zoh_discretize(Ac, Bc, ts):
    """Exact ZOH via exp([[Ac,Bc],[0,0]] * ts) (src/QPSolver.cpp:21-29)."""
    Ac = np.asarray(Ac, np.float64)
    Bc = np.asarray(Bc, np.float64)
    nx, nu = Bc.shape
    M = np.zeros((nx + nu, nx + nu))
    M[:nx, :nx] = Ac
    M[:nx, nx:] = Bc
    E = expm(M * ts)
    return E[:nx, :nx], E[:nx, nx:]


def condense(Ad, Bd, Q, R, P, N):
    """Build A_aug, B_aug and the block-diagonal cost pieces.

    A_aug: [(N+1)nx, nx] with block i = Ad^i        (src/QPSolver.cpp:36-40)
    B_aug: [(N+1)nx, N*nu], block (i,j) = Ad^(i-j-1) Bd for j < i  (:42-47)
    Returns (A_aug, B_aug, Q_bar, R_bar) with Q_bar [(N+1)nx, (N+1)nx]
    block-diag(Q,...,Q,P) and R_bar [N nu, N nu] block-diag(R) (:50-57).
    """
    nx = Ad.shape[0]
    nu = Bd.shape[1]
    A_aug = np.zeros(((N + 1) * nx, nx))
    A_aug[:nx] = np.eye(nx)
    for i in range(1, N + 1):
        A_aug[i * nx:(i + 1) * nx] = Ad @ A_aug[(i - 1) * nx:i * nx]

    powers = [np.eye(nx)]
    for _ in range(N):
        powers.append(Ad @ powers[-1])

    B_aug = np.zeros(((N + 1) * nx, N * nu))
    for i in range(1, N + 1):
        for j in range(i):
            B_aug[i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = (
                powers[i - j - 1] @ Bd)

    Q_bar = np.zeros(((N + 1) * nx, (N + 1) * nx))
    for i in range(N):
        Q_bar[i * nx:(i + 1) * nx, i * nx:(i + 1) * nx] = Q
    Q_bar[N * nx:, N * nx:] = P
    R_bar = np.kron(np.eye(N), R)
    return A_aug, B_aug, Q_bar, R_bar


def build_qp(Ad, Bd, Q, R, P, N, x0, x_ref, u_min, u_max,
             x_min=None, x_max=None):
    """Form the condensed QP (H, f) and inequality set G z <= h.

    x_ref is [nx, N+1] (column i = reference state at step i), flattened
    column-major to match Eigen's Map (src/QPSolver.cpp:59).
    Constraints: input box (:67-68) and, if x_min/x_max given, the state box
    through the prediction rows (:71-80), as Gz <= h with
    G = [I; -I; B_pred; -B_pred].
    """
    nx = Ad.shape[0]
    nu = Bd.shape[1]
    A_aug, B_aug, Q_bar, R_bar = condense(Ad, Bd, Q, R, P, N)

    H = 2.0 * (B_aug.T @ Q_bar @ B_aug + R_bar)
    H = 0.5 * (H + H.T)
    x_ref_vec = np.asarray(x_ref, np.float64).reshape(-1, order="F")
    f = 2.0 * B_aug.T @ Q_bar @ (A_aug @ x0 - x_ref_vec)

    nz = N * nu
    G_list = [np.eye(nz), -np.eye(nz)]
    h_list = [np.full(nz, u_max), np.full(nz, -u_min)]

    if x_min is not None:
        B_pred = B_aug[nx:]                     # blocks 1..N
        A_pred = A_aug[nx:]
        x_max_t = np.tile(np.asarray(x_max, np.float64), N)
        x_min_t = np.tile(np.asarray(x_min, np.float64), N)
        G_list += [B_pred, -B_pred]
        h_list += [x_max_t - A_pred @ x0, -(x_min_t - A_pred @ x0)]

    G = np.concatenate(G_list, axis=0)
    h = np.concatenate(h_list, axis=0)
    return H, f, G, h


def circle_reference(k, ts, N, radius=2.0, angular_vel=0.5):
    """The circle reference of src/qpSolver_test.cpp:40-50: [4, N+1]."""
    i = np.arange(N + 1)
    t = (k + i) * ts
    theta = angular_vel * t
    x_ref = np.zeros((4, N + 1))
    x_ref[0] = radius * np.cos(theta)
    x_ref[1] = -radius * angular_vel * np.sin(theta)
    x_ref[2] = radius * np.sin(theta)
    x_ref[3] = radius * angular_vel * np.cos(theta)
    return x_ref


def double_integrator_matrices(variant="qpsolver_test"):
    """(Ac, Bc) of the two closed-loop examples.

    "qpsolver_test": damping 0.1, input gain 5 (src/qpSolver_test.cpp:10-17)
    "linear_mpc_example": damping 0.02/mass 0.2 = 0.1, gain 1/mass = 5
      (src/linear_mpc_example.cpp:17-18,110-117) — identical numerically.
    """
    del variant
    Ac = np.array([
        [0.0, 1.0, 0.0, 0.0],
        [0.0, -0.1, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
        [0.0, 0.0, 0.0, -0.1],
    ])
    Bc = np.array([
        [0.0, 0.0],
        [5.0, 0.0],
        [0.0, 0.0],
        [0.0, 5.0],
    ])
    return Ac, Bc


def run_closed_loop(steps=500, ts=0.01, N=15, x0=(2.0, 0.0, 0.0, 0.0),
                    use_state_constraints=True, tol=1e-10, solver=None):
    """The full 500-step circle-tracking loop (src/qpSolver_test.cpp:38-75).

    Returns dict with arrays: states [steps+1, 4], controls [steps, 2],
    errors [steps] (position tracking error, printed by the reference at
    src/qpSolver_test.cpp:84-89).

    `solver(H, f, G, h) -> (z, lam, info)` defaults to the float64 IPM
    oracle; pass oracle.qp_active_set.solve_qp_active_set to drive the
    loop with the independent dense active-set method (the reference's
    qpOASES algorithm family) instead.
    """
    Ac, Bc = double_integrator_matrices()
    Ad, Bd = zoh_discretize(Ac, Bc, ts)
    Q = np.diag([50.0, 5.0, 50.0, 5.0])
    R = 0.1 * np.eye(2)
    P = 20.0 * Q
    x_min = np.array([-5.0, -3.0, -5.0, -3.0])
    x_max = -x_min

    x = np.asarray(x0, np.float64)
    states = [x.copy()]
    controls = []
    errors = []
    for k in range(steps):
        x_ref = circle_reference(k, ts, N)
        H, f, G, h = build_qp(
            Ad, Bd, Q, R, P, N, x, x_ref, -8.0, 8.0,
            x_min if use_state_constraints else None,
            x_max if use_state_constraints else None)
        if solver is None:
            z, _, _ = solve_qp_oracle(H, f, G, h, tol=tol)
        else:
            z, _, _ = solver(H, f, G, h)
        u = z[:2]
        x = Ad @ x + Bd @ u
        states.append(x.copy())
        controls.append(u.copy())
        errors.append(np.linalg.norm(
            [x[0] - x_ref[0, 0], x[2] - x_ref[2, 0]]))
    return {
        "states": np.array(states),
        "controls": np.array(controls),
        "errors": np.array(errors),
        "Ad": Ad, "Bd": Bd,
    }
