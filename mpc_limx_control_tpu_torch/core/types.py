"""State containers as small dataclasses of tensors.

Counterparts of the chex dataclasses of ``mpc_limx_control_tpu.core.types``
(reference structs RobotOdomState, limxsdk RobotState / RobotCmd). Every
field carries an explicit leading batch dimension ``[B, ...]``; the port
writes the batch out instead of relying on ``vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


def default_device(device=None) -> torch.device:
    """The device of newly created state: the card unless the caller asks
    for another one (``device="cpu"`` in the CPU tests). With no card,
    creating the tensors raises torch's own error."""
    return torch.device("cuda" if device is None else device)


@dataclasses.dataclass(frozen=True)
class OdomState:
    """Base-link odometry: pos/ori(rpy)/quat(x,y,z,w)/v_pos/v_ori."""

    pos: torch.Tensor    # [B, 3]
    ori: torch.Tensor    # [B, 3]
    quat: torch.Tensor   # [B, 4]
    v_pos: torch.Tensor  # [B, 3]
    v_ori: torch.Tensor  # [B, 3]


@dataclasses.dataclass(frozen=True)
class JointState:
    """Measured joint state (limxsdk RobotState: q, dq, tau)."""

    q: torch.Tensor    # [B, J]
    dq: torch.Tensor   # [B, J]
    tau: torch.Tensor  # [B, J]


@dataclasses.dataclass(frozen=True)
class ImuData:
    """IMU sample (limxsdk ImuData: quat, acc, gyro); quat is (x, y, z, w)."""

    quat: torch.Tensor  # [B, 4]
    acc: torch.Tensor   # [B, 3] specific force, body frame
    gyro: torch.Tensor  # [B, 3] angular velocity, body frame


@dataclasses.dataclass(frozen=True)
class RobotCmd:
    """Joint command (limxsdk RobotCmd: mode, q, dq, tau, Kp, Kd)."""

    mode: torch.Tensor  # [B, J] int32; 0 = torque mode
    q: torch.Tensor
    dq: torch.Tensor
    tau: torch.Tensor
    kp: torch.Tensor
    kd: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GaitState:
    """Gait clock output (MPCController.h:61-75): left_swing [B] bool,
    phase / remain_swing_time / swing_progress [B]."""

    left_swing: torch.Tensor
    phase: torch.Tensor
    remain_swing_time: torch.Tensor
    swing_progress: torch.Tensor


@dataclasses.dataclass(frozen=True)
class QPSolution:
    """Batched QP result: u [B, nz], iterations (int), residual [B]."""

    u: torch.Tensor
    iterations: int
    residual: torch.Tensor


class TickDiagnostics(NamedTuple):
    """Per-tick controller diagnostics (controller.tick)."""

    gait: GaitState
    grf: torch.Tensor           # [B, 6] stance forces (world), L then R
    qp_residual: torch.Tensor   # [B]
    foot_target: torch.Tensor   # [B, 3]
    swing_q: torch.Tensor       # [B, 3]
    predicted_xi: torch.Tensor  # [B, 13] one-step-ahead SRBD state
    qp_state: tuple | None      # (z, y) warm state for the next tick
    ref_anchor: torch.Tensor | None = None  # [B, 3] next-tick anchor


@dataclasses.dataclass(frozen=True)
class KFState:
    """Kalman-filter state (include/stateEstimator.h:142-147): x_hat
    [B, 12] = base position, base velocity, left and right foot positions;
    p_cov [B, 12, 12] its covariance."""

    x_hat: torch.Tensor
    p_cov: torch.Tensor

    def replace(self, **kw) -> "KFState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def initial(cls, batch=(), initial_covariance: float = 100.0,
                dtype=torch.float32, device=None) -> "KFState":
        """Zero estimate with covariance ``initial_covariance * I``, on
        the card unless ``device`` says otherwise."""
        batch = tuple(batch)
        device = default_device(device)
        eye = torch.eye(12, dtype=dtype, device=device) * initial_covariance
        return cls(x_hat=torch.zeros((*batch, 12), dtype=dtype,
                                     device=device),
                   p_cov=eye.expand(*batch, 12, 12).clone())
