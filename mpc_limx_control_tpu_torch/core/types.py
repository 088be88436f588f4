"""State containers as small dataclasses of tensors.

Counterparts of the chex dataclasses of ``mpc_limx_control_tpu.core.types``
(reference structs RobotOdomState, limxsdk RobotState / RobotCmd). Every
field carries an explicit leading batch dimension ``[B, ...]``; the port
writes the batch out instead of relying on ``vmap``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch


def default_device(device=None) -> torch.device:
    """The device of newly created state: the card unless the caller asks
    for another one (``device="cpu"`` in the CPU tests). With no card,
    creating the tensors raises torch's own error."""
    return torch.device("cuda" if device is None else device)


def require_device(name: str = "cuda") -> torch.device:
    """The device an example or tool runs on (its ``--device``): the card
    unless asked for the CPU; a card this process does not have raises
    here, before any work."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to run on the CPU")
    return device


def constant(values, dtype, device) -> torch.Tensor:
    """A tensor of configuration values (a float or nested tuples of
    floats) on `device`, made once per (values, dtype, device). A tensor
    made from Python values on every call is a copy from pageable host
    memory: it blocks the host behind the kernels queued before it, and
    a CUDA graph cannot capture it. Callers must not modify the result."""
    # keyed by the repr too: -0.0 == 0.0 would otherwise share an entry
    return _constant(repr(values), values, dtype, device)


@functools.lru_cache(maxsize=256)
def _constant(key: str, values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


class _Replace:
    """``.replace(**fields)``, as the JAX package's chex dataclasses have
    it."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _zeros(batch, width, dtype, device, w_one=False):
    """A [*batch, width] zero tensor on `device` (the card unless told
    otherwise); ``w_one`` sets the last entry to 1 (a unit quaternion)."""
    t = torch.zeros((*tuple(batch), width), dtype=dtype,
                    device=default_device(device))
    if w_one:
        t[..., -1] = 1.0
    return t


@dataclasses.dataclass(frozen=True)
class OdomState(_Replace):
    """Base-link odometry: pos/ori(rpy)/quat(x,y,z,w)/v_pos/v_ori."""

    pos: torch.Tensor    # [B, 3]
    ori: torch.Tensor    # [B, 3]
    quat: torch.Tensor   # [B, 4]
    v_pos: torch.Tensor  # [B, 3]
    v_ori: torch.Tensor  # [B, 3]

    @classmethod
    def zeros(cls, batch=(), dtype=torch.float32, device=None):
        """At the origin, level (quat w = 1), at rest."""
        return cls(pos=_zeros(batch, 3, dtype, device),
                   ori=_zeros(batch, 3, dtype, device),
                   quat=_zeros(batch, 4, dtype, device, w_one=True),
                   v_pos=_zeros(batch, 3, dtype, device),
                   v_ori=_zeros(batch, 3, dtype, device))


@dataclasses.dataclass(frozen=True)
class JointState(_Replace):
    """Measured joint state (limxsdk RobotState: q, dq, tau)."""

    q: torch.Tensor    # [B, J]
    dq: torch.Tensor   # [B, J]
    tau: torch.Tensor  # [B, J]

    @classmethod
    def zeros(cls, batch=(), num_joints: int = 6, dtype=torch.float32,
              device=None):
        z = _zeros(batch, num_joints, dtype, device)
        return cls(q=z, dq=z, tau=z)


@dataclasses.dataclass(frozen=True)
class ImuData(_Replace):
    """IMU sample (limxsdk ImuData: quat, acc, gyro); quat is (x, y, z, w)."""

    quat: torch.Tensor  # [B, 4]
    acc: torch.Tensor   # [B, 3] specific force, body frame
    gyro: torch.Tensor  # [B, 3] angular velocity, body frame

    @classmethod
    def zeros(cls, batch=(), dtype=torch.float32, device=None):
        return cls(quat=_zeros(batch, 4, dtype, device, w_one=True),
                   acc=_zeros(batch, 3, dtype, device),
                   gyro=_zeros(batch, 3, dtype, device))


@dataclasses.dataclass(frozen=True)
class RobotCmd(_Replace):
    """Joint command (limxsdk RobotCmd: mode, q, dq, tau, Kp, Kd)."""

    mode: torch.Tensor  # [B, J] int32; 0 = torque mode
    q: torch.Tensor
    dq: torch.Tensor
    tau: torch.Tensor
    kp: torch.Tensor
    kd: torch.Tensor

    @classmethod
    def zeros(cls, batch=(), num_joints: int = 6, dtype=torch.float32,
              device=None):
        z = _zeros(batch, num_joints, dtype, device)
        return cls(mode=_zeros(batch, num_joints, torch.int32, device),
                   q=z, dq=z, tau=z, kp=z, kd=z)


@dataclasses.dataclass(frozen=True)
class GaitState(_Replace):
    """Gait clock output (MPCController.h:61-75): left_swing [B] bool,
    phase / remain_swing_time / swing_progress [B]."""

    left_swing: torch.Tensor
    phase: torch.Tensor
    remain_swing_time: torch.Tensor
    swing_progress: torch.Tensor


@dataclasses.dataclass(frozen=True)
class QPSolution(_Replace):
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
class KFState(_Replace):
    """Kalman-filter state (include/stateEstimator.h:142-147): x_hat
    [B, 12] = base position, base velocity, left and right foot positions;
    p_cov [B, 12, 12] its covariance."""

    x_hat: torch.Tensor
    p_cov: torch.Tensor

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
