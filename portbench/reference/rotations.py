"""Rotation utilities (quaternion / Euler / rotation matrix), batched.

A frozen copy of the port's ``utils/rotations.py``. Quaternions are
(x, y, z, w) (include/state_estimator_fake.h:69-72); rpy = (roll, pitch,
yaw) with R = Rz(yaw) Ry(pitch) Rx(roll); zyx = (yaw, pitch, roll) is the
reference's quatToZyx (include/stateEstimator.h:76-84).
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


def quat_to_zyx(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [..., 3] ZYX Euler (yaw, pitch, roll), the reference's
    quatToZyx including its 0.99999 asin clamp."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    as_ = torch.clamp(-2.0 * (x * z - w * y), max=0.99999)
    yaw = torch.atan2(2 * (x * y + w * z), w * w + x * x - y * y - z * z)
    pitch = torch.asin(as_)
    roll = torch.atan2(2 * (y * z + w * x), w * w - x * x - y * y + z * z)
    return torch.stack([yaw, pitch, roll], -1)


def quat_to_rpy(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [..., 3] (roll, pitch, yaw), the layout of
    OdomState.ori (include/state_estimator_fake.h:62-67)."""
    return quat_to_zyx(q).flip(-1)


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


