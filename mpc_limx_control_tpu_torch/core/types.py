"""State containers as small dataclasses of tensors.

Counterparts of the chex dataclasses of ``mpc_limx_control_tpu.core.types``
(reference structs RobotOdomState, limxsdk RobotState / RobotCmd). Every
field carries an explicit leading batch dimension ``[B, ...]``; the port
writes the batch out instead of relying on ``vmap``. ``KFState`` and
``ImuData`` come with the Kalman-filter slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


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
