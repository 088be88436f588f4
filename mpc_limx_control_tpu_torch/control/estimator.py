"""State-estimation front ends: the scripted source and the KF wrapper.

Counterpart of ``mpc_limx_control_tpu.control.estimator``:

* :func:`scripted_odometry` is the deterministic ground-truth source that
  stands in for StateEstimatorFake (include/state_estimator_fake.h:27-116);
* :func:`estimator_tick` packs joint and IMU readings into the filter's
  measurements the way src/mpc_control.cpp:158-192 does and runs one
  Kalman-filter step (ops/kf.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import (ImuData, JointState,
                                                   KFState, OdomState,
                                                   constant)
from mpc_limx_control_tpu_torch.models import kinematics as kin
from mpc_limx_control_tpu_torch.ops import kf as kfops
from mpc_limx_control_tpu_torch.utils import rotations as rot


def scripted_odometry(cfg: ControllerConfig, iteration: torch.Tensor,
                      v_des: torch.Tensor, base_height: float = 0.8,
                      yaw_rate: torch.Tensor | None = None) -> OdomState:
    """Exact odometry of a straight or arc walk at the desired velocity
    (constant-heading position integral). iteration [B], v_des [B, 3]."""
    t = iteration.to(v_des.dtype) * cfg.gait.dt
    if yaw_rate is None:
        yaw_rate = torch.zeros_like(t)
    yaw = yaw_rate * t
    zero = torch.zeros_like(yaw)
    pos = torch.stack([v_des[..., 0] * t, v_des[..., 1] * t,
                       torch.full_like(t, base_height)], -1)
    rpy = torch.stack([zero, zero, yaw], -1)
    return OdomState(pos=pos, ori=rpy, quat=rot.rpy_to_quat(rpy),
                     v_pos=v_des * torch.ones_like(t)[..., None],
                     v_ori=torch.stack([zero, zero, yaw_rate], -1))


class EstimatorOutput(NamedTuple):
    kf: KFState
    odom: OdomState


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def estimator_tick(cfg: ControllerConfig, kf_state: KFState,
                   joints: JointState, imu: ImuData, contact: torch.Tensor,
                   dt: float) -> EstimatorOutput:
    """One KF estimation tick; contact [B, 2] bool (left, right).

    FK with the base orientation only gives base -> foot vectors in world
    axes; foot velocities come from the contact Jacobian plus the
    omega x r term (include/stateEstimator.h:239-248); the world
    acceleration is R a_imu + g.
    """
    dtype, device = joints.q.dtype, joints.q.device
    R_wb = rot.quat_to_rot(imu.quat)
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype, device)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype, device)
    ql, qr = joints.q[..., :3], joints.q[..., 3:]
    vl_b = _mv(kin.contact_jacobian(gl, ql), joints.dq[..., :3])
    vr_b = _mv(kin.contact_jacobian(gr, qr), joints.dq[..., 3:])

    omega_w = _mv(R_wb, imu.gyro)
    pl_w = _mv(R_wb, kin.forward_kinematics(gl, ql))
    pr_w = _mv(R_wb, kin.forward_kinematics(gr, qr))
    vl_w = _mv(R_wb, vl_b) + torch.linalg.cross(omega_w, pl_w, dim=-1)
    vr_w = _mv(R_wb, vr_b) + torch.linalg.cross(omega_w, pr_w, dim=-1)
    g_vec = constant((0.0, 0.0, -9.81), dtype, device)
    meas = kfops.KFMeasurement(
        foot_pos_rel=torch.stack([pl_w, pr_w], -2),
        foot_vel_rel=torch.stack([vl_w, vr_w], -2),
        accel_world=_mv(R_wb, imu.acc) + g_vec,
        contact=contact,
        foot_heights=torch.zeros((*contact.shape[:-1], 2), dtype=dtype,
                                 device=device))
    kf_new = kfops.kf_update(cfg.estimator, kf_state, meas, dt)
    # world position and velocity from the filter, orientation from the
    # IMU (include/stateEstimator.h:318-332)
    odom = OdomState(pos=kf_new.x_hat[..., 0:3],
                     ori=rot.quat_to_rpy(imu.quat), quat=imu.quat,
                     v_pos=kf_new.x_hat[..., 3:6], v_ori=omega_w)
    return EstimatorOutput(kf=kf_new, odom=odom)
