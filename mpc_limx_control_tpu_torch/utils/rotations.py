"""Rotation utilities (quaternion / Euler / rotation matrix), batched.

Counterpart of ``mpc_limx_control_tpu.utils.rotations``. Quaternions are
(x, y, z, w) (include/state_estimator_fake.h:69-72); rpy = (roll, pitch,
yaw) with R = Rz(yaw) Ry(pitch) Rx(roll).
"""

from __future__ import annotations

import torch


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x,y,z,w) -> [..., 3, 3] world-from-body rotation."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / torch.clamp(n, min=1e-12)
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return torch.stack([
        torch.stack([1 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1 - (xx + yy)], -1),
    ], -2)


def rpy_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] (roll, pitch, yaw) -> [..., 4] (x,y,z,w)."""
    r, p, y = rpy[..., 0] / 2, rpy[..., 1] / 2, rpy[..., 2] / 2
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], -1)


def rpy_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] (roll, pitch, yaw) -> [..., 3, 3] = Rz(yaw)Ry(pitch)Rx(roll)."""
    return quat_to_rot(rpy_to_quat(rpy))
