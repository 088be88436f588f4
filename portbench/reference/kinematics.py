"""TRON1 point-foot leg kinematics: FK, the contact Jacobian and the
closed-form position IK.

A frozen copy of the port's ``models/kinematics.py``, trimmed to what the
analytic-IK tick uses. The 3-DoF chain per leg is

    base --abad--> Rx(q0) --hip--> Ry(q1) --knee--> Ry(q2) --foot+contact

with the right leg mirroring every offset's y component. Geometry fields
may carry a batch shape ``[..., 3]`` (a per-scenario choice of leg), and
broadcast against the joint angles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from portbench.reference.config import LegOffsets


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


