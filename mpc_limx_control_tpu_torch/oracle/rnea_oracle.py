"""Independent float64 inverse-dynamics oracle (Lagrangian form).

Counterpart of ``mpc_limx_control_tpu.oracle.rnea_oracle``.
`models/dynamics.py:rnea` (the Newton-Euler recursion mirroring
`PinocchioKinematics::inverseDynamics`, include/pinocchio_kinematics.h:
46-48) is held against the same joint torques computed by a completely
different route -- the Euler-Lagrange equations evaluated by automatic
differentiation of the chain's energy:

    T(q, qd) = sum_i 1/2 m_i |d/dt com_i|^2 + 1/2 w_i' I_i w_i
    V(q)     = sum_i m_i g z_com_i
    tau      = d/dt (dT/dqd) - dT/dq + dV/dq
             = (d2T/dqd dq) qd + (d2T/dqd2) qdd - dT/dq + dV/dq

COM world positions and link rotations are built by a direct forward
chain (no shared code with the RNEA recursion beyond the joint offsets);
velocities come from ``torch.func.jvp``, angular velocities from
unskew(R' dR), and every derivative from ``torch.func.grad`` / ``jacfwd``
in float64. Every tensor is float64 on the caller's device.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacfwd, jvp

from mpc_limx_control_tpu_torch.core.config import LegOffsets
from mpc_limx_control_tpu_torch.models.dynamics import LegInertialParams
from mpc_limx_control_tpu_torch.models.kinematics import leg_geometry

F64 = torch.float64


def _rx(a):
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack([one, zero, zero]),
                        torch.stack([zero, c, -s]),
                        torch.stack([zero, s, c])])


def _ry(a):
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack([c, zero, s]),
                        torch.stack([zero, one, zero]),
                        torch.stack([-s, zero, c])])


def _chain(q, geom, coms):
    """World (base-frame) link rotations and COM positions.

    Returns (Rs [3][3,3], coms_w [3][3]) for the abad/hip/knee links of
    the Rx(q0) Ry(q1) Ry(q2) chain."""
    R1 = _rx(q[0])
    R2 = R1 @ _ry(q[1])
    R3 = R2 @ _ry(q[2])
    p1 = geom.abad
    p2 = p1 + R1 @ geom.hip
    p3 = p2 + R2 @ geom.knee
    return [R1, R2, R3], [p1 + R1 @ coms[0], p2 + R2 @ coms[1],
                          p3 + R3 @ coms[2]]


def _unskew(W):
    return torch.stack([W[2, 1], W[0, 2], W[1, 0]])


def solve_rnea_oracle(q, dq, ddq,
                      offsets: LegOffsets = LegOffsets(),
                      params: LegInertialParams = LegInertialParams(),
                      side: str = "left",
                      gravity: float = 9.81) -> torch.Tensor:
    """tau [3] for one configuration, float64, Euler-Lagrange by autodiff.

    Semantics match models/dynamics.py:rnea (fixed base, gravity -z,
    per-link diagonal COM inertia in the link frame, right side mirrors
    the COM y offsets). q / dq / ddq [3] (tensors or array-likes); the
    result lies on q's device (the CPU for an array-like).
    """
    device = q.device if isinstance(q, torch.Tensor) else None

    def t(v):
        return torch.as_tensor(v, dtype=F64, device=device)

    q, dq, ddq = t(q), t(dq), t(ddq)
    geom = leg_geometry(offsets, side, F64, q.device)
    mir = t([1.0, 1.0 if side == "left" else -1.0, 1.0])
    coms = [t(c) * mir
            for c in (params.com_abad, params.com_hip, params.com_knee)]
    masses = [t(m) for m in params.masses]
    inertias = [t(i) for i in (params.inertia_abad, params.inertia_hip,
                               params.inertia_knee)]
    g = t(gravity)

    def kinetic(qv, qdv):
        def pos_rot(qq):
            Rs, cs = _chain(qq, geom, coms)
            return torch.stack(cs), torch.stack(Rs)

        (cs, Rs), (dcs, dRs) = jvp(pos_rot, (qv,), (qdv,))
        T = torch.zeros((), dtype=F64, device=qv.device)
        for i in range(3):
            v = dcs[i]
            w = _unskew(Rs[i].T @ dRs[i])        # link-frame angular vel
            T = T + 0.5 * masses[i] * (v @ v) \
                + 0.5 * (w @ (inertias[i] * w))
        return T

    def potential(qv):
        _, cs = _chain(qv, geom, coms)
        return sum(masses[i] * g * cs[i][2] for i in range(3))

    p_fn = grad(kinetic, argnums=1)              # dT/dqd (momentum)
    dp_dq = jacfwd(p_fn, argnums=0)(q, dq)       # [3, 3]
    M = jacfwd(p_fn, argnums=1)(q, dq)           # mass matrix
    dT_dq = grad(kinetic, argnums=0)(q, dq)
    dV_dq = grad(potential)(q)
    return M @ ddq + dp_dq @ dq - dT_dq + dV_dq
