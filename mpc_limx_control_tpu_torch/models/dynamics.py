"""Leg inverse dynamics: recursive Newton-Euler (RNEA) for the 3-DoF
point-foot leg chain.

Counterpart of ``mpc_limx_control_tpu.models.dynamics``, the capability of
``PinocchioKinematics::inverseDynamics`` (include/pinocchio_kinematics.h:
46-48, pinocchio::rnea on the URDF). The URDF is not shipped with the
reference, so the link inertial parameters are configurable engineering
estimates; the chain offsets are the exact ``kinematicValues`` of
include/MPCParam.h:13-38 (``models/kinematics.py``).

Fixed-base chain, joint axes (roll, pitch, pitch), batched over leading
axes and unrolled over the three links; the device and dtype follow q.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mpc_limx_control_tpu_torch.core.config import LegOffsets
from mpc_limx_control_tpu_torch.models.kinematics import (_rx, _ry,
                                                          leg_geometry)


@dataclasses.dataclass(frozen=True)
class LegInertialParams:
    """Per-link mass (kg), COM offset in the link frame (m) and diagonal
    rotational inertia about the COM (kg m^2). Defaults are engineering
    estimates for a ~1.8 kg TRON1 leg (the trunk carries the rest of the
    9.585 kg total, include/mpcQP.h:18)."""

    masses: Tuple[float, float, float] = (0.7, 0.8, 0.3)
    # COM at roughly half the next-link offset
    com_abad: Tuple[float, float, float] = (-0.04, 0.01, 0.0)
    com_hip: Tuple[float, float, float] = (-0.075, -0.01, -0.13)
    com_knee: Tuple[float, float, float] = (0.07, 0.0, -0.145)
    inertia_abad: Tuple[float, float, float] = (1e-3, 1e-3, 1e-3)
    inertia_hip: Tuple[float, float, float] = (8e-3, 8e-3, 1e-3)
    inertia_knee: Tuple[float, float, float] = (3e-3, 3e-3, 5e-4)


def _mv(R, v):
    """R [..., 3, 3] @ v [..., 3] -> [..., 3]."""
    return (R @ v[..., None])[..., 0]


def rnea(q: torch.Tensor, dq: torch.Tensor, ddq: torch.Tensor,
         offsets: LegOffsets = LegOffsets(),
         params: LegInertialParams = LegInertialParams(),
         side: str = "left", gravity: float = 9.81) -> torch.Tensor:
    """Joint torques for the prescribed motion; q / dq / ddq [..., 3].

    The outward recursion carries angular velocity / acceleration and the
    linear acceleration link to link (in each link's own frame), the inward
    one accumulates forces and moments and projects them on the joint
    axes. Gravity enters as an upward acceleration of the base.
    """
    dtype, device = q.dtype, q.device
    geom = leg_geometry(offsets, side, dtype, device)
    mirror = 1.0 if side == "left" else -1.0

    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    rots = [_rx(q[..., 0]), _ry(q[..., 1]), _ry(q[..., 2])]  # parent <- link
    ex, ey = t([1.0, 0.0, 0.0]), t([0.0, 1.0, 0.0])
    axes = [ex, ey, ey]
    joints_pos = [geom.abad, geom.hip, geom.knee]           # in the parent
    masses = [float(m) for m in params.masses]
    coms = [t(c) * t([1.0, mirror, 1.0])
            for c in (params.com_abad, params.com_hip, params.com_knee)]
    inertias = [torch.diag(t(i)) for i in (params.inertia_abad,
                                           params.inertia_hip,
                                           params.inertia_knee)]
    batch = q.shape[:-1]
    zero3 = torch.zeros((*batch, 3), dtype=dtype, device=device)

    def cross(a, b):
        a, b = torch.broadcast_tensors(a, b)
        return torch.linalg.cross(a, b, dim=-1)

    # ---- outward recursion
    w, dw = zero3, zero3
    a = t([0.0, 0.0, gravity]).expand(*batch, 3)            # +g upward
    w_l, dw_l, ac_l = [], [], []
    for i in range(3):
        Rt = rots[i].transpose(-1, -2)                      # link <- parent
        qd = dq[..., i:i + 1]
        qdd = ddq[..., i:i + 1]
        w_par = _mv(Rt, w)
        w_new = w_par + axes[i] * qd
        dw_new = _mv(Rt, dw) + cross(w_par, axes[i] * qd) + axes[i] * qdd
        r = joints_pos[i]
        a_new = _mv(Rt, a + cross(dw, r) + cross(w, cross(w, r)))
        c = coms[i]
        ac = a_new + cross(dw_new, c) + cross(w_new, cross(w_new, c))
        w, dw, a = w_new, dw_new, a_new
        w_l.append(w_new)
        dw_l.append(dw_new)
        ac_l.append(ac)

    # ---- inward recursion
    f_child, n_child = zero3, zero3
    taus = [None, None, None]
    for i in (2, 1, 0):
        F = masses[i] * ac_l[i]
        Nm = (_mv(inertias[i], dw_l[i])
              + cross(w_l[i], _mv(inertias[i], w_l[i])))
        if i < 2:
            # the child's wrench in this frame, its moment shifted
            Rc = rots[i + 1]
            f_c = _mv(Rc, f_child)
            n_c = _mv(Rc, n_child) + cross(joints_pos[i + 1], f_c)
        else:
            f_c, n_c = zero3, zero3
        f = F + f_c
        n = Nm + cross(coms[i], F) + n_c
        taus[i] = (n * axes[i]).sum(-1)
        f_child, n_child = f, n
    return torch.stack(taus, -1)


def gravity_torques(q: torch.Tensor, **kw) -> torch.Tensor:
    """tau = RNEA(q, 0, 0): the static gravity compensation torques."""
    z = torch.zeros_like(q)
    return rnea(q, z, z, **kw)
