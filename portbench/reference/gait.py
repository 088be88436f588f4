"""Gait schedule, foot placement and swing-foot trajectory.

A frozen copy of the port's ``control/gait.py`` (reference
include/MPCController.h:61-158). The clock runs in the dtype of the
iteration it is given; the reference's tick gives it float32, as the
program computes it.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.config import ControllerConfig, GaitParams
from portbench.reference.types import GaitState, constant


def gait_clock(gait: GaitParams, iteration: torch.Tensor) -> GaitState:
    """Leg states at control tick `iteration` [B] (float tensor)."""
    t = iteration * gait.dt
    cycle = gait.cycle_time
    phase = torch.remainder(t, cycle)
    left_swing = phase < gait.swing_time
    remain = torch.where(left_swing, gait.swing_time - phase, cycle - phase)
    progress = (gait.swing_time - remain) / gait.swing_time
    return GaitState(left_swing=left_swing, phase=phase,
                     remain_swing_time=remain, swing_progress=progress)


def foot_placement(cfg: ControllerConfig, state: GaitState,
                   base_pos: torch.Tensor, v_des: torch.Tensor,
                   v_actual: torch.Tensor | None = None) -> torch.Tensor:
    """Swing-foot touchdown target [B, 3] (world frame).

    "reference" mode mirrors include/MPCController.h:106-132 (desired
    velocity only, the reference's swapped-y static offsets, z = ground);
    "capture" predicts from the measured velocity and adds the capture-point
    correction k sqrt(h/g) (v - v_des).
    """
    if cfg.placement_mode not in ("capture", "reference"):
        raise ValueError(f"placement_mode must be 'capture' or "
                         f"'reference', got {cfg.placement_mode!r}")
    gait = cfg.gait
    dtype, device = base_pos.dtype, base_pos.device
    if cfg.placement_mode == "capture" and v_actual is not None:
        v_pred = v_actual
        k_cap = cfg.capture_gain_scale * math.sqrt(cfg.base_height / 9.81)
        correction = k_cap * (v_actual[..., :2] - v_des[..., :2])
    else:
        v_pred = v_des
        correction = 0.0
    predicted = base_pos + v_pred * state.remain_swing_time[..., None]
    p_rel = torch.clamp(v_pred[..., :2] * (0.5 * gait.stance_time)
                        + correction, -gait.p_rel_max, gait.p_rel_max)
    xy = predicted[..., :2] + p_rel
    if cfg.placement_mode == "reference":
        off_l = cfg.robot.static_foot_offset_left[:2]
        off_r = cfg.robot.static_foot_offset_right[:2]
    else:
        off_l = cfg.robot.nominal_foot_offset_left[:2]
        off_r = cfg.robot.nominal_foot_offset_right[:2]
    offset = torch.where(state.left_swing[..., None],
                         constant(tuple(off_l), dtype, device),
                         constant(tuple(off_r), dtype, device))
    xy = xy + offset
    z = torch.full((*xy.shape[:-1], 1), cfg.ground_height, dtype=dtype,
                   device=device)
    return torch.cat([xy, z], -1)


def swing_trajectory(gait: GaitParams, state: GaitState,
                     foot_now: torch.Tensor, target: torch.Tensor,
                     ground_height: float = 0.0) -> torch.Tensor:
    """Next swing-foot position [B, 3]: linear x/y interpolation by the
    swing fraction, z = ground + gait_height sin(pi s)."""
    s = state.swing_progress[..., None]
    nxt = foot_now + (target - foot_now) * s
    z = ground_height + gait.gait_height * torch.sin(
        math.pi * state.swing_progress)
    return torch.cat([nxt[..., :2], z[..., None]], -1)


def contact_schedule(gait: GaitParams, iteration: torch.Tensor, N: int,
                     dt_mpc: float) -> torch.Tensor:
    """left_stance [B, N] bool: True when the LEFT foot supports at horizon
    step k (the clock advanced k*dt_mpc from `iteration`)."""
    t0 = iteration * gait.dt
    k = torch.arange(N, dtype=t0.dtype, device=t0.device)
    t = t0[..., None] + k * dt_mpc
    phase = torch.remainder(t, gait.cycle_time)
    return ~(phase < gait.swing_time)
