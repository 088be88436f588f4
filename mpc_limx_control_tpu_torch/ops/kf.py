"""Batched 12-state Kalman filter for base-state estimation, plain torch.

Counterpart of ``mpc_limx_control_tpu.ops.kf`` (the reference
``stateEstimator``, include/stateEstimator.h:86-337): state x_hat = [base
p(3), base v(3), left foot p(3), right foot p(3)], observation y(14) =
[relative foot positions(6), relative foot velocities(6), foot heights(2)].

* constant A with the dt position <- velocity coupling and B integrating
  the world-frame acceleration (0.5 dt^2, dt) (:221-223);
* the reference's dt-scaled process and measurement noise (:224-226,
  :250-258), inflated x high_suspect_number for a foot not in contact
  (:260-279);
* the update through a Cholesky factor of the innovation covariance S
  (SPD), then symmetrization and the xy-block conditioning (:299-306).

Full float32 throughout: the package pins TF32 off (``__init__.py``), the
class of error that once made S indefinite on the TPU (NOTES.md). The
factor is ``torch.linalg.cholesky_ex``, which does not check ``info`` on
the host and so does not synchronize a CUDA stream. On the card the
walking loop runs this filter inside the tick kernel
(``ops/csrc/walking_tick.cu``); this module is its plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mpc_limx_control_tpu_torch.core.config import EstimatorConfig
from mpc_limx_control_tpu_torch.core.types import KFState


class KFMeasurement(NamedTuple):
    """Per-tick inputs to the filter (world-frame quantities from FK + IMU,
    as src/mpc_control.cpp:158-192 computes them)."""

    foot_pos_rel: torch.Tensor   # [B, 2, 3] base -> foot in world axes
    foot_vel_rel: torch.Tensor   # [B, 2, 3]
    accel_world: torch.Tensor    # [B, 3] R a_imu + g
    contact: torch.Tensor        # [B, 2] bool
    foot_heights: torch.Tensor   # [B, 2] measured foot heights (usually 0)


def _observation_matrix(dtype, device) -> torch.Tensor:
    """The constant C [14, 12] (include/stateEstimator.h:195-206)."""
    C = torch.zeros((14, 12), dtype=dtype, device=device)
    e3 = torch.eye(3, dtype=dtype, device=device)
    C[0:3, 0:3] = e3          # base position relative to each foot
    C[3:6, 0:3] = e3
    C[0:6, 6:12] = -torch.eye(6, dtype=dtype, device=device)
    C[6:9, 3:6] = e3          # base velocity seen from each stance foot
    C[9:12, 3:6] = e3
    C[12, 8] = 1.0            # foot heights
    C[13, 11] = 1.0
    return C


@functools.lru_cache(maxsize=16)
def _constants(cfg: EstimatorConfig, dt: float, dtype, device):
    """The filter's constant matrices A [12, 12], B [12, 3], C [14, 12] and
    noise diagonals q [12], r [14], made once per (config, dt, dtype,
    device): an element write of a Python number is a copy from host
    memory, which synchronizes with the card and which a CUDA graph
    cannot capture. Callers must not modify them."""
    e3 = torch.eye(3, dtype=dtype, device=device)
    A = torch.eye(12, dtype=dtype, device=device)
    A[0:3, 3:6] = dt * e3
    Bm = torch.zeros((12, 3), dtype=dtype, device=device)
    Bm[0:3] = 0.5 * dt * dt * e3
    Bm[3:6] = dt * e3
    C = _observation_matrix(dtype, device)

    def full(n, v):
        return torch.full((n,), v, dtype=dtype, device=device)

    q_diag = torch.cat([full(3, (dt / 20.0) * cfg.imu_process_noise_position),
                        full(3, (dt * 9.81 / 20.0)
                             * cfg.imu_process_noise_velocity),
                        full(6, dt * cfg.foot_process_noise_position)])
    r_diag = torch.cat([full(6, cfg.foot_sensor_noise_position),
                        full(6, cfg.foot_sensor_noise_velocity),
                        full(2, cfg.foot_height_sensor_noise)])
    return A, Bm, C, q_diag, r_diag


def kf_update(cfg: EstimatorConfig, state: KFState, meas: KFMeasurement,
              dt: float) -> KFState:
    """One predict + update step over a batch [B, ...]."""
    dtype, device = state.x_hat.dtype, state.x_hat.device
    A, Bm, C, q_diag, r_diag = _constants(cfg, float(dt), dtype, device)

    # contact gating: x high_suspect_number on the foot not in contact
    gate = torch.where(meas.contact, 1.0, cfg.high_suspect_number).to(dtype)
    gate3 = gate.repeat_interleave(3, -1)                   # [B, 6]
    q_gate = torch.cat([torch.ones_like(gate3), gate3], -1)
    r_gate = torch.cat([gate3, gate3, gate], -1)
    Qm = q_diag * q_gate                                     # [B, 12]
    Rm = r_diag * r_gate                                     # [B, 14]

    # observation: ps = -(p_foot - p_base) + radius z, vs = -v_foot_rel
    ps = -meas.foot_pos_rel
    ps = torch.cat([ps[..., :2], ps[..., 2:] + cfg.foot_radius], -1)
    y = torch.cat([ps.reshape(-1, 6), (-meas.foot_vel_rel).reshape(-1, 6),
                   meas.foot_heights], -1)                   # [B, 14]

    # predict
    x_pred = state.x_hat @ A.T + meas.accel_world @ Bm.T
    P_pred = A @ state.p_cov @ A.T + torch.diag_embed(Qm)

    # update (S SPD: Cholesky)
    ey = y - x_pred @ C.T
    PCt = P_pred @ C.T                                       # [B, 12, 14]
    S = C @ PCt + torch.diag_embed(Rm)
    L, _ = torch.linalg.cholesky_ex(S)
    s_ey = torch.cholesky_solve(ey[..., None], L)[..., 0]
    x_new = x_pred + (PCt @ s_ey[..., None])[..., 0]
    SC = torch.cholesky_solve(C.expand(*L.shape[:-2], 14, 12), L)
    P_new = P_pred - PCt @ SC @ P_pred

    # symmetrize + xy conditioning
    P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
    det_xy = (P_new[..., 0, 0] * P_new[..., 1, 1]
              - P_new[..., 0, 1] * P_new[..., 1, 0])
    xy = torch.arange(12, device=device) < 2
    mask_off = (xy[:, None] == xy[None, :]).to(dtype)
    scale_xy = torch.where(xy[:, None] & xy[None, :], 0.1, 1.0).to(dtype)
    P_new = torch.where((det_xy > 1e-6)[..., None, None],
                        P_new * mask_off * scale_xy, P_new)
    return KFState(x_hat=x_new, p_cov=P_new)
