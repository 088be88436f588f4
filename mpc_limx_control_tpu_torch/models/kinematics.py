"""TRON1 point-foot leg kinematics: FK, the contact Jacobian and three IKs.

Counterpart of ``mpc_limx_control_tpu.models.kinematics``: the closed-form
position IK of the production configs (``ik_method="analytic"``) and the
two iterative parity paths of the reference's pinocchio loop
(include/pinocchio_kinematics.h:61-149), the position-only damped
least squares (``"damped_ls"``) and the SE(3) log6 6-DoF loop
(``"log6"``), whose Jacobian JAX takes by forward-mode autodiff through
:func:`log6` and the port by that derivative written out. The 3-DoF chain
per leg is

    base --abad--> Rx(q0) --hip--> Ry(q1) --knee--> Ry(q2) --foot+contact

with the right leg mirroring every offset's y component. Geometry fields
may carry a batch shape ``[..., 3]`` (a per-scenario choice of leg), and
broadcast against the joint angles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mpc_limx_control_tpu_torch.core.config import LegOffsets


class LegGeometry(NamedTuple):
    """Per-leg chain constants (side sign already applied), each [..., 3]."""

    abad: torch.Tensor
    hip: torch.Tensor
    knee: torch.Tensor
    foot: torch.Tensor    # knee -> contact point (foot + contact merged)


@functools.lru_cache(maxsize=64)
def leg_geometry(offsets: LegOffsets = LegOffsets(), side: str = "left",
                 dtype=torch.float32, device=None) -> LegGeometry:
    """The chain constants of one leg, made once per (offsets, side,
    dtype, device) (see types.constant); callers must not modify them."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    mirror = torch.tensor([1.0, 1.0 if side == "left" else -1.0, 1.0],
                          dtype=dtype, device=device)

    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return LegGeometry(
        abad=t(offsets.abad_offset) * mirror,
        hip=t(offsets.hip_offset) * mirror,
        knee=t(offsets.knee_offset) * mirror,
        foot=(t(offsets.foot_offset) + t(offsets.contact_offset)) * mirror)


def select_geometry(cond: torch.Tensor, a: LegGeometry,
                    b: LegGeometry) -> LegGeometry:
    """Per-scenario leg choice: ``a`` where cond [B] is True, else ``b``."""
    c = cond[..., None]
    return LegGeometry(*(torch.where(c, x, y) for x, y in zip(a, b)))


def _rx(q):
    c, s = torch.cos(q), torch.sin(q)
    z, o = torch.zeros_like(q), torch.ones_like(q)
    return torch.stack([
        torch.stack([o, z, z], -1),
        torch.stack([z, c, -s], -1),
        torch.stack([z, s, c], -1),
    ], -2)


def _ry(q):
    c, s = torch.cos(q), torch.sin(q)
    z, o = torch.zeros_like(q), torch.ones_like(q)
    return torch.stack([
        torch.stack([c, z, s], -1),
        torch.stack([z, o, z], -1),
        torch.stack([-s, z, c], -1),
    ], -2)


def _mv(R, v):
    """R [..., 3, 3] @ v [..., 3] (broadcasting) -> [..., 3]."""
    return (R * v[..., None, :]).sum(-1)


def forward_kinematics(geom: LegGeometry, q: torch.Tensor) -> torch.Tensor:
    """Contact-point position in the base frame; q [..., 3] = [abad, hip,
    knee]."""
    r0 = _rx(q[..., 0])
    r01 = r0 @ _ry(q[..., 1])
    r012 = r01 @ _ry(q[..., 2])
    return (geom.abad + _mv(r0, geom.hip) + _mv(r01, geom.knee)
            + _mv(r012, geom.foot))


def contact_jacobian(geom: LegGeometry, q: torch.Tensor) -> torch.Tensor:
    """d(contact position)/d(q) [..., 3, 3] in the base frame.

    Closed form of the Rx(q0) Ry(q1) Ry(q2) chain (the JAX package takes
    the same matrix by forward-mode autodiff): with the abad-frame point
    u = hip + Ry(q1) knee + Ry(q1+q2) foot,
    dp/dq0 = Rx'(q0) u and dp/dq{1,2} = Rx(q0) du/dq{1,2}.
    """
    c0, s0 = torch.cos(q[..., 0]), torch.sin(q[..., 0])
    c1, s1 = torch.cos(q[..., 1]), torch.sin(q[..., 1])
    q12 = q[..., 1] + q[..., 2]
    c12, s12 = torch.cos(q12), torch.sin(q12)
    hy, hz = geom.hip[..., 1], geom.hip[..., 2]
    kx, ky, kz = geom.knee[..., 0], geom.knee[..., 1], geom.knee[..., 2]
    fx, fy, fz = geom.foot[..., 0], geom.foot[..., 1], geom.foot[..., 2]
    a1 = c1 * kx + s1 * kz
    b1 = -s1 * kx + c1 * kz
    a2 = c12 * fx + s12 * fz
    b2 = -s12 * fx + c12 * fz
    uy = hy + ky + fy
    uz = hz + b1 + b2
    zero = torch.zeros_like(c0 + uy)
    col0 = torch.stack([zero, -s0 * uy - c0 * uz, c0 * uy - s0 * uz], -1)
    col1 = torch.stack([b1 + b2, s0 * (a1 + a2), -c0 * (a1 + a2)], -1)
    col2 = torch.stack([b2 + zero, s0 * a2, -c0 * a2], -1)
    return torch.stack([col0, col1, col2], -1)


def _wrap_angle(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def inverse_kinematics_analytic(geom: LegGeometry, target: torch.Tensor,
                                q_ref: torch.Tensor) -> torch.Tensor:
    """Closed-form position IK; target [..., 3] in the base frame, q_ref the
    branch hint (nearest branch wins, ties to the first candidate as
    ``argmin`` does). Unreachable targets clamp to the workspace boundary.
    """
    v = target - geom.abad
    vy, vz = v[..., 1], v[..., 2]
    y_chain = geom.hip[..., 1] + geom.knee[..., 1] + geom.foot[..., 1]
    r = torch.sqrt(vy * vy + vz * vz)
    phi = torch.atan2(vz, vy)
    c = torch.clamp(y_chain / torch.clamp(r, min=1e-9), -1.0, 1.0)
    delta0 = torch.acos(c)
    c0a = _wrap_angle(phi - delta0)
    c0b = _wrap_angle(phi + delta0)
    pick0 = (torch.abs(_wrap_angle(c0a - q_ref[..., 0]))
             <= torch.abs(_wrap_angle(c0b - q_ref[..., 0])))
    q0 = torch.where(pick0, c0a, c0b)

    # rotate into the abad frame, subtract the hip offset, go planar (x, z)
    u3 = _mv(_rx(q0).transpose(-1, -2), v) - geom.hip
    ux, uz = u3[..., 0], u3[..., 2]

    ax, az = geom.knee[..., 0], geom.knee[..., 2]
    bx, bz = geom.foot[..., 0], geom.foot[..., 2]
    la2 = ax * ax + az * az
    lb2 = bx * bx + bz * bz
    rho = torch.sqrt(la2 * lb2)
    psi = torch.atan2(ax * bz - az * bx, ax * bx + az * bz)
    k = (ux * ux + uz * uz - la2 - lb2) / 2.0
    c2 = torch.clamp(k / rho, -1.0, 1.0)
    delta2 = torch.acos(c2)
    c2a = _wrap_angle(psi - delta2)
    c2b = _wrap_angle(psi + delta2)
    pick2 = (torch.abs(_wrap_angle(c2a - q_ref[..., 2]))
             <= torch.abs(_wrap_angle(c2b - q_ref[..., 2])))
    q2 = torch.where(pick2, c2a, c2b)

    # q1 from the residual rotation: e^{-i q1} (A + e^{-i q2} B) = U
    wx = ax + torch.cos(q2) * bx + torch.sin(q2) * bz
    wz = az - torch.sin(q2) * bx + torch.cos(q2) * bz
    q1 = _wrap_angle(torch.atan2(wz, wx) - torch.atan2(uz, ux))
    return torch.stack([q0, q1, q2], -1)


def inverse_kinematics_damped_ls(geom: LegGeometry, target: torch.Tensor,
                                 q_init: torch.Tensor, iters: int = 10,
                                 damp: float = 1e-6,
                                 step: float = 1.0) -> torch.Tensor:
    """Fixed-iteration damped least-squares IK (Gauss-Newton), position
    error only (point foot): q <- q - step J' (J J' + damp I)^-1 (FK(q) -
    target), ``iters`` times with no early exit (the budget of
    include/pinocchio_kinematics.h:61-149: 10 iterations, damp 1e-6)."""
    eye = torch.eye(3, dtype=q_init.dtype, device=q_init.device)
    q = q_init
    for _ in range(iters):
        err = forward_kinematics(geom, q) - target
        J = contact_jacobian(geom, q)
        JJt = J @ J.transpose(-1, -2) + damp * eye
        y = torch.linalg.solve(JJt, err[..., None])[..., 0]
        q = q + step * -_mv(J.transpose(-1, -2), y)
    return q


def _skew(w):
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def log3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) log: rotation [..., 3, 3] -> axis-angle [..., 3]
    (pinocchio::log3), for theta in [0, pi).

    atan2(sin, cos) with double-where guards instead of arccos, so that
    the forward-mode derivative stays finite at the identity (the log6
    IK's Jacobian passes through here): theta -> 0 takes the smooth
    theta / sin(theta) = 1 + (1 - c) / 3 branch."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w_raw = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                               R[..., 0, 2] - R[..., 2, 0],
                               R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = (w_raw * w_raw).sum(-1)                 # sin^2(theta)
    small = s2 < 1e-12
    s_safe = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(s_safe, c)
    scale = torch.where(small, 1.0 + (1.0 - c) * (1.0 / 3.0),
                        theta / s_safe)
    return w_raw * scale[..., None]


def log6(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """SE(3) log: (R [..., 3, 3], p [..., 3]) -> twist [..., 6], linear
    part first (pinocchio Motion::toVector()). Linear part V(theta)^-1 p
    with V^-1 = I - [w]x / 2 + coef [w]x^2; below theta^2 = 1e-4 coef is
    the series 1/12 + theta^2 / 720 (the closed form cancels in f32), with
    the double-where guard keeping the derivative finite at theta = 0."""
    w = log3(R)
    th2 = (w * w).sum(-1)
    small = th2 < 1e-4
    th_safe = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    s, c = torch.sin(th_safe), torch.cos(th_safe)
    denom = torch.where(small, torch.ones_like(th2), 2.0 * (1.0 - c) * th2)
    coef_big = (2.0 * (1.0 - c) - th_safe * s) / denom
    coef = torch.where(small, 1.0 / 12.0 + th2 * (1.0 / 720.0), coef_big)
    wx = _skew(w)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    v_inv = eye - 0.5 * wx + coef[..., None, None] * (wx @ wx)
    return torch.cat([_mv(v_inv, p), w], -1)


def leg_pose(geom: LegGeometry, q: torch.Tensor):
    """Contact-frame pose in the base frame: (R [..., 3, 3], p [..., 3]).
    The fixed foot / contact joints carry identity rotations, so the frame
    rotation is the joint chain Rx(q0) Ry(q1) Ry(q2)."""
    r0 = _rx(q[..., 0])
    r01 = r0 @ _ry(q[..., 1])
    r012 = r01 @ _ry(q[..., 2])
    p = (geom.abad + _mv(r0, geom.hip) + _mv(r01, geom.knee)
         + _mv(r012, geom.foot))
    return r012, p


def _log6_error_jacobian(geom: LegGeometry, q: torch.Tensor,
                         target: torch.Tensor):
    """The log6 IK's 6-DoF error e = log6(oMf^-1 oMdes) with the identity
    desired orientation, log6(R', R' (target - p)) [..., 6], and its
    Jacobian J = de/dq [..., 6, 3]: the forward-mode derivative of the same
    formulas, guards included, written out with the three joint directions
    on one axis (JAX takes it with ``jax.jacfwd``).

    With A = R' and b = A (target - p): dR/dq_j = R [w_j]x for the
    body-frame axes w_0 = Ry(q1 + q2)' e_x, w_1 = w_2 = e_y, so
    dA_j = -[w_j]x A and db_j = -[w_j]x b - A dp/dq_j (dp/dq: the contact
    Jacobian); then log3 and log6 are differentiated step by step, each
    ``where`` selecting the derivative of its branch."""
    R, p = leg_pose(geom, q)
    A = R.transpose(-1, -2)
    b = _mv(A, target - p)
    q12 = q[..., 1] + q[..., 2]
    zero, one = torch.zeros_like(q12), torch.ones_like(q12)
    ey = torch.stack([zero, one, zero], -1)
    axes = torch.stack([torch.stack([torch.cos(q12), zero, torch.sin(q12)],
                                    -1), ey, ey], -2)      # [..., 3 dir, 3]
    wx = _skew(axes)                                      # [..., 3, 3, 3]
    dA = -(wx @ A[..., None, :, :])
    db = (-_mv(wx, b[..., None, :])
          - _mv(A[..., None, :, :],
                contact_jacobian(geom, q).transpose(-1, -2)))
    A, b = A[..., None, :, :], b[..., None, :]           # against the dirs

    # log3(A) and its derivative
    tr = A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]
    dtr = dA[..., 0, 0] + dA[..., 1, 1] + dA[..., 2, 2]
    c_raw = (tr - 1.0) * 0.5
    c = torch.clamp(c_raw, -1.0, 1.0)
    dc = torch.where((c_raw > -1.0) & (c_raw < 1.0), 0.5 * dtr,
                     torch.zeros_like(dtr))

    def vee_asym(M):
        return 0.5 * torch.stack([M[..., 2, 1] - M[..., 1, 2],
                                  M[..., 0, 2] - M[..., 2, 0],
                                  M[..., 1, 0] - M[..., 0, 1]], -1)

    w_raw, dw_raw = vee_asym(A), vee_asym(dA)
    s2 = (w_raw * w_raw).sum(-1)
    ds2 = 2.0 * (w_raw * dw_raw).sum(-1)
    small = s2 < 1e-12
    s_safe = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    ds_safe = torch.where(small, torch.zeros_like(ds2), ds2 / (2.0 * s_safe))
    theta = torch.atan2(s_safe, c)
    dtheta = (c * ds_safe - s_safe * dc) / (s_safe * s_safe + c * c)
    scale = torch.where(small, 1.0 + (1.0 - c) * (1.0 / 3.0),
                        theta / s_safe)
    dscale = torch.where(small, -dc * (1.0 / 3.0),
                         (dtheta * s_safe - theta * ds_safe)
                         / (s_safe * s_safe))
    w = w_raw * scale[..., None]
    dw = dw_raw * scale[..., None] + w_raw * dscale[..., None]

    # log6(A, b) and its derivative
    th2 = (w * w).sum(-1)
    dth2 = 2.0 * (w * dw).sum(-1)
    small6 = th2 < 1e-4
    th_safe = torch.sqrt(torch.where(small6, torch.ones_like(th2), th2))
    dth = torch.where(small6, torch.zeros_like(dth2), dth2 / (2.0 * th_safe))
    sn, cs = torch.sin(th_safe), torch.cos(th_safe)
    dsn, dcs = cs * dth, -sn * dth
    denom = torch.where(small6, torch.ones_like(th2),
                        2.0 * (1.0 - cs) * th2)
    ddenom = torch.where(small6, torch.zeros_like(th2),
                         -2.0 * dcs * th2 + 2.0 * (1.0 - cs) * dth2)
    num = 2.0 * (1.0 - cs) - th_safe * sn
    dnum = -2.0 * dcs - dth * sn - th_safe * dsn
    coef = torch.where(small6, 1.0 / 12.0 + th2 * (1.0 / 720.0), num / denom)
    dcoef = torch.where(small6, dth2 * (1.0 / 720.0),
                        (dnum * denom - num * ddenom) / (denom * denom))
    wx, dwx = _skew(w), _skew(dw)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    v_inv = eye - 0.5 * wx + coef[..., None, None] * (wx @ wx)
    dv_inv = (-0.5 * dwx + dcoef[..., None, None] * (wx @ wx)
              + coef[..., None, None] * (dwx @ wx + wx @ dwx))
    v = _mv(v_inv, b)
    dv = _mv(dv_inv, b) + _mv(v_inv, db)
    e = torch.cat([v, w], -1)[..., 0, :]
    J = torch.cat([dv, dw], -1).transpose(-1, -2)        # [..., 6, 3]
    return e, J


def inverse_kinematics_log6(geom: LegGeometry, target: torch.Tensor,
                            q_init: torch.Tensor, iters: int = 10,
                            damp: float = 1e-6,
                            dt: float = 0.1) -> torch.Tensor:
    """SE(3) log6 damped-least-squares IK, the reference's pinocchio loop
    (include/pinocchio_kinematics.h:61-149): desired pose (identity,
    target); per iteration e = log6(oMf^-1 oMdes), J = de/dq (the forward
    derivative of the error, :func:`_log6_error_jacobian`: the chain rule of
    the reference's -Jlog6 @ frameJacobian), v = -J' (J J' + damp I)^-1 e
    and q <- q + v dt, ``iters`` times with no early exit. A 3-joint point
    foot cannot realize the identity orientation, so the error trades
    position against rotation, as the reference's does
    (ik_method="log6")."""
    eye6 = torch.eye(6, dtype=q_init.dtype, device=q_init.device)
    q = q_init
    for _ in range(iters):
        e, J = _log6_error_jacobian(geom, q, target)
        JJt = J @ J.transpose(-1, -2) + damp * eye6
        q = q + dt * -_mv(J.transpose(-1, -2),
                          torch.linalg.solve(JJt, e[..., None])[..., 0])
    return q


def full_fk(offsets: LegOffsets, q6: torch.Tensor):
    """Both contact points in the base frame: (p_left, p_right) [..., 3]."""
    gl = leg_geometry(offsets, "left", q6.dtype, q6.device)
    gr = leg_geometry(offsets, "right", q6.dtype, q6.device)
    return (forward_kinematics(gl, q6[..., :3]),
            forward_kinematics(gr, q6[..., 3:]))

