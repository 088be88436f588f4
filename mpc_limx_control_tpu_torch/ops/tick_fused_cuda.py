"""The whole walking tick as one CUDA kernel: wrapper and plain version.

Counterpart of ``mpc_limx_control_tpu.ops.tick_fused_pallas``. The TPU
kernel ``_tick_kernel`` (tick_fused_pallas.py:130, pallas_call at :868
via ``_fused_tick_core`` :737, ``fused_walking_tick`` :626 and
``make_tick_fused`` :911) becomes ``csrc/walking_tick.cu`` in walk mode
with truth odometry: gait clock, FK, anchor clip, capture placement, swing
+ analytic IK, contact schedule and moment arms, the shared MPC core of
``csrc/mpc_core.cuh``, GRF split, exact-ZOH plant step, rigid-ground
clamp and next-tick FK / IK, one launch per tick for the whole batch.

Its hold (K4), in-kernel KF (K5) and standing (K6) variants are later
slices: :func:`supports_fused_tick` accepts only what this kernel runs.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mpc_limx_control_tpu_torch.ops import _build
from mpc_limx_control_tpu_torch.ops.mpc_fused_cuda import (
    NX, MpcParams, mpc_params, supports_fused_walking_qp)

# The kernel and its launch counter (see ops/_build.py).
WALKING_TICK = _build.Kernel("walking_tick", n_ptr=20,
                             params_sizer="walking_tick_params_bytes")


class TickParams(ctypes.Structure):
    """Mirror of ``mpc::TickParams`` in csrc/walking_tick.cu."""

    _fields_ = [("mpc", MpcParams),
                ("dt", ctypes.c_float), ("cycle", ctypes.c_float),
                ("swing_t", ctypes.c_float), ("stance_t", ctypes.c_float),
                ("gait_height", ctypes.c_float),
                ("p_rel_max", ctypes.c_float), ("ground_h", ctypes.c_float),
                ("k_cap", ctypes.c_float), ("use_capture", ctypes.c_int),
                ("anchor_band", ctypes.c_float),
                ("anchor_gain", ctypes.c_float),
                ("yaw_band", ctypes.c_float),
                ("off_l", ctypes.c_float * 2), ("off_r", ctypes.c_float * 2),
                ("geom", ctypes.c_float * 12)]


def _tick_statics(cfg) -> dict:
    """Compile-time constants of the whole-tick kernel from the config
    (the tick-level statics of the JAX _tick_statics; the MPC's come from
    mpc_fused_cuda.walking_constants)."""
    g = cfg.gait
    legs = cfg.robot.legs
    use_capture = cfg.placement_mode == "capture"
    if use_capture:
        off_l = cfg.robot.nominal_foot_offset_left[:2]
        off_r = cfg.robot.nominal_foot_offset_right[:2]
    else:
        off_l = cfg.robot.static_foot_offset_left[:2]
        off_r = cfg.robot.static_foot_offset_right[:2]
    return dict(
        dt=float(g.dt), cycle=float(g.cycle_time),
        swing_t=float(g.swing_time), stance_t=float(g.stance_time),
        gait_height=float(g.gait_height), p_rel_max=float(g.p_rel_max),
        ground_h=float(cfg.ground_height),
        k_cap=float(cfg.capture_gain_scale)
        * math.sqrt(cfg.base_height / 9.81),
        use_capture=int(use_capture),
        anchor_band=float(cfg.ref_anchor_band),
        anchor_gain=float(cfg.anchor_placement_gain),
        yaw_band=float(cfg.yaw_anchor_band),
        off_l=tuple(float(v) for v in off_l),
        off_r=tuple(float(v) for v in off_r),
        geom=tuple(float(v) for v in (
            *legs.abad_offset, *legs.hip_offset, *legs.knee_offset,
            *(a + b for a, b in zip(legs.foot_offset,
                                    legs.contact_offset)))))


@functools.lru_cache(maxsize=16)
def tick_params(cfg) -> TickParams:
    """Kernel constants for a (frozen, hashable) config; cached so the
    per-tick launch builds no structure. Callers must not mutate it."""
    s = _tick_statics(cfg)
    p = TickParams()
    p.mpc = mpc_params(cfg)
    for k, v in s.items():
        if isinstance(v, tuple):
            getattr(p, k)[:] = list(v)
        else:
            setattr(p, k, v)
    return p


def supports_fused_tick(cfg) -> bool:
    """True when ``walking_tick`` implements the config's tick: walk mode,
    truth odometry, analytic IK, the warm ``admm_fused`` solver, capture or
    reference placement, and a walking QP the MPC core implements (level
    attitude, horizon <= 21)."""
    return _config_reason(cfg) is None


def _config_reason(cfg) -> str | None:
    if cfg.mode != "walk":
        return ("standing is the two-foot variant of the tick kernel, "
                "ROADMAP queue 2, K6")
    if cfg.estimator_mode != "truth":
        return ("the in-kernel Kalman filter is ROADMAP queue 2, K5 "
                "(queue 1, item 10)")
    if cfg.ik_method != "analytic":
        return "iterative IK is ROADMAP queue 1, item 15"
    if not cfg.qp_warm_start or cfg.srbd.solver.method != "admm_fused":
        return ("only the warm admm_fused solver runs in the tick kernel; "
                "other solvers are ROADMAP queue 1, item 13 / queue 2, K8")
    if cfg.placement_mode not in ("capture", "reference"):
        return f"placement_mode={cfg.placement_mode!r} is unknown"
    if not supports_fused_walking_qp(cfg):
        return ("the tick kernel's MPC is level-attitude only with horizon "
                "<= 21 (the receding reference is ROADMAP queue 2, K7)")
    return None


def unsupported_reason(cfg, state) -> str | None:
    """Why plant_step cannot run `state` on the tick kernel (None: it can)."""
    reason = _config_reason(cfg)
    if reason is None and (state.qp_z is None or state.qp_lam is None):
        reason = "the tick kernel needs the warm QP state (qp_warm_start)"
    return reason


def fused_walking_tick(xi, q, foot_l, foot_r, z_warm, y_warm, anchor, it,
                       v_des, yaw_rate, *, cfg):
    """Batched whole-tick dispatch (kernel wrapper).

    xi [B,13]; q [B,6]; foot_l / foot_r [B,3]; z_warm [B,3N];
    y_warm [B,6N]; anchor [B,3] (x, y, yaw); it [B]; v_des [B,3];
    yaw_rate [B]. Returns (xi', q', foot_l', foot_r', z, y, anchor',
    residual [B], grf [B,6], target [B,3]).

    CUDA tensors launch ``walking_tick``; CPU tensors run its plain
    version, ``rollout._plant_step_ref`` with the exact-solve ADMM
    (``solve_form="subst"``).
    """
    reason = _config_reason(cfg)
    if reason is not None:
        raise ValueError(f"walking_tick does not implement this config: "
                         f"{reason}")
    if xi.device.type == "cpu":
        from mpc_limx_control_tpu_torch.control import rollout as ro

        st = ro.PlantState(xi=xi, q=q, foot_l=foot_l, foot_r=foot_r,
                           qp_z=z_warm, qp_lam=y_warm, ref_anchor=anchor)
        st2, m = ro._plant_step_ref(cfg, st, it, v_des=v_des,
                                    yaw_rate_des=yaw_rate,
                                    solve_form="subst")
        return (st2.xi, st2.q, st2.foot_l, st2.foot_r, st2.qp_z,
                st2.qp_lam, st2.ref_anchor, m["qp_residual"], m["grf"],
                m["foot_target"])
    if xi.device.type != "cuda":
        raise ValueError(f"walking_tick runs on CUDA tensors, got "
                         f"{xi.device}")
    N = int(cfg.srbd.horizon)
    B = xi.shape[0]
    dev = xi.device
    ins = (("xi", xi, (B, NX)), ("q", q, (B, 6)), ("foot_l", foot_l, (B, 3)),
           ("foot_r", foot_r, (B, 3)), ("z_warm", z_warm, (B, 3 * N)),
           ("y_warm", y_warm, (B, 6 * N)), ("anchor", anchor, (B, 3)),
           ("it", it, (B,)), ("v_des", v_des, (B, 3)),
           ("yaw_rate", yaw_rate, (B,)))
    for name, t, shape in ins:
        _build.check_tensor(name, t, shape, dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (empty(B, NX), empty(B, 6), empty(B, 3), empty(B, 3),
            empty(B, 3 * N), empty(B, 6 * N), empty(B, 3), empty(B),
            empty(B, 6), empty(B, 3))
    WALKING_TICK.launch(
        tick_params(cfg),
        [t.data_ptr() for _, t, _ in ins] + [t.data_ptr() for t in outs],
        B, torch.cuda.current_stream(dev).cuda_stream)
    return outs
