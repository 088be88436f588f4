"""The whole tick as one CUDA kernel: wrapper and plain version.

Counterpart of ``mpc_limx_control_tpu.ops.tick_fused_pallas``. The TPU
kernel ``_tick_kernel`` (tick_fused_pallas.py:130, pallas_call at :868
via ``_fused_tick_core`` :737, ``fused_walking_tick`` :626 and
``make_tick_fused`` :911) becomes ``csrc/walking_tick.cu`` in walk mode:
gait clock, FK, anchor clip, capture placement, swing + analytic IK,
contact schedule and moment arms, the shared MPC core of
``csrc/mpc_core.cuh``, GRF split, exact-ZOH plant step, rigid-ground
clamp and next-tick FK / IK, one launch per tick for the whole batch; and
``csrc/standing_tick.cu`` in stand mode (K6): no swing and no schedule,
the two-foot nu = 6 MPC with both feet's step-invariant moment arms and
the reference anchored at their midpoint, both forces applied, both feet
pinned and both legs re-solved by IK.

Eight entry points, one per mode and variant of the TPU kernel's
``est_kf`` / ``hold`` flags, each with its own launch counter
(``standing_*`` likewise):

* ``walking_tick``: truth odometry, MPC solve;
* ``walking_tick_hold`` (K4): the dtMPC held-force tick, no MPC;
* ``walking_tick_kf`` (K5): the 12-state Kalman filter in the kernel, its
  estimate driving the controller while the plant steps from the truth;
* ``walking_tick_kf_hold``: both.

:func:`supports_fused_tick` accepts only what these kernels run.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from mpc_limx_control_tpu_torch.ops import _build
from mpc_limx_control_tpu_torch.ops.mpc_fused_cuda import (
    MAX_HORIZON, NX, MpcParams, mpc_params)

# The kernels and their launch counters (see ops/_build.py). The hold
# variants take neither the warm QP state nor return it (it passes
# through); the KF variants take the filter state, prev_v and prev_q and
# return the filter state.
_SIZER = "walking_tick_params_bytes"
WALKING_TICK = _build.Kernel("walking_tick", n_ptr=20, params_sizer=_SIZER)
WALKING_TICK_HOLD = _build.Kernel("walking_tick_hold", n_ptr=17,
                                  params_sizer=_SIZER)
WALKING_TICK_KF = _build.Kernel("walking_tick_kf", n_ptr=26,
                                params_sizer=_SIZER)
WALKING_TICK_KF_HOLD = _build.Kernel("walking_tick_kf_hold", n_ptr=23,
                                     params_sizer=_SIZER)
TICK_KERNELS = {(False, False): WALKING_TICK, (False, True): WALKING_TICK_HOLD,
                (True, False): WALKING_TICK_KF,
                (True, True): WALKING_TICK_KF_HOLD}
# the standing forms, same pointer lists; keys (est_kf, hold) as above
STAND_KERNELS = {
    key: _build.Kernel(k.name.replace("walking", "standing"), n_ptr=k.n_ptr,
                       params_sizer=_SIZER)
    for key, k in TICK_KERNELS.items()}


def tick_kernels(cfg) -> dict:
    """(est_kf, hold) -> kernel for the config's mode."""
    return STAND_KERNELS if cfg.mode == "stand" else TICK_KERNELS


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
                ("geom", ctypes.c_float * 12), ("kf", ctypes.c_float * 8)]


def _tick_statics(cfg) -> dict:
    """Compile-time constants of the whole-tick kernel from the config
    (the tick-level statics and ``est_c`` of the JAX _tick_statics; the
    MPC's come from mpc_fused_cuda.walking_constants)."""
    g = cfg.gait
    e = cfg.estimator
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
                                    legs.contact_offset)))),
        # process noise as ops/kf.py scales it, then the sensor noise,
        # the contact-gate factor and the foot radius
        kf=tuple(float(v) for v in (
            (g.dt / 20.0) * e.imu_process_noise_position,
            (g.dt * 9.81 / 20.0) * e.imu_process_noise_velocity,
            g.dt * e.foot_process_noise_position,
            e.foot_sensor_noise_position, e.foot_sensor_noise_velocity,
            e.foot_height_sensor_noise, e.high_suspect_number,
            e.foot_radius)))


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
    """True when the ``walking_tick`` / ``standing_tick`` kernels implement
    the config's tick: walk or stand mode, truth or KF odometry, analytic
    IK, the warm ``admm_fused`` solver with exact triangular solves,
    capture or reference placement, and a QP the MPC core implements
    (level attitude, horizon <= 21)."""
    return _config_reason(cfg) is None


def _config_reason(cfg) -> str | None:
    if cfg.mode not in ("walk", "stand"):
        return f"mode={cfg.mode!r} is unknown"
    if cfg.estimator_mode not in ("truth", "kf"):
        return f"estimator_mode={cfg.estimator_mode!r} is unknown"
    if cfg.ik_method != "analytic":
        return "iterative IK is ROADMAP queue 1, item 15"
    if not cfg.qp_warm_start or cfg.srbd.solver.method != "admm_fused":
        return ("only the warm admm_fused solver runs in the tick kernel; "
                "other solvers are ROADMAP queue 1, item 13 / queue 2, K8")
    if cfg.placement_mode not in ("capture", "reference"):
        return f"placement_mode={cfg.placement_mode!r} is unknown"
    if cfg.srbd.solver.solve_form != "subst":
        return ("the tick kernel's MPC runs exact triangular solves; "
                "solve_form='inv' is ROADMAP queue 2, K1")
    if (cfg.srbd.attitude_ref != "level"
            or not 1 <= cfg.srbd.horizon <= MAX_HORIZON):
        return ("the tick kernel's MPC is level-attitude only with horizon "
                f"<= {MAX_HORIZON} (the receding reference is ROADMAP queue "
                "1, item 13)")
    return None


def unsupported_reason(cfg, state) -> str | None:
    """Why plant_step cannot run `state` on the tick kernel (None: it can)."""
    reason = _config_reason(cfg)
    if reason is None and (state.qp_z is None or state.qp_lam is None):
        reason = "the tick kernel needs the warm QP state (qp_warm_start)"
    kf_state = (state.kf is not None and state.prev_v is not None
                and state.prev_q is not None)
    if reason is None and kf_state != (cfg.estimator_mode == "kf"):
        reason = (f"estimator_mode={cfg.estimator_mode!r} needs a state "
                  f"{'with' if not kf_state else 'without'} the filter "
                  "fields (kf, prev_v, prev_q)")
    return reason


def fused_walking_tick(xi, q, foot_l, foot_r, z_warm, y_warm, anchor, it,
                       v_des, yaw_rate, kf_x=None, kf_p=None, prev_v=None,
                       prev_q=None, grf_held=None, *, cfg):
    """Batched whole-tick dispatch (kernel wrapper).

    xi [B,13]; q [B,6]; foot_l / foot_r [B,3]; z_warm [B,nu N];
    y_warm [B,2 nu N] (nu = 3 walking, 6 standing); anchor [B,3] (x, y,
    yaw; standing reads only its clip and advance, which its caller
    drops); it [B]; v_des [B,3];
    yaw_rate [B]. Returns (xi', q', foot_l', foot_r', z, y, anchor',
    residual [B], grf [B,6], target [B,3]).

    With kf_x [B,12] / kf_p [B,12,12] / prev_v [B,3] / prev_q [B,6] (the
    config's estimator_mode must be "kf") the filter runs in the kernel
    and the outputs gain (kf_x', kf_p'). With grf_held [B,6] the tick holds
    that force (walking: on the foot now in stance; standing: on both feet
    as given) and runs no MPC: z and y are returned as given (the same
    tensors) and the residual is 0.

    CUDA tensors launch the matching ``walking_tick*`` /
    ``standing_tick*`` kernel; CPU
    tensors run its plain version, ``rollout._plant_step_ref`` with the
    exact-solve ADMM (``solve_form="subst"``).
    """
    reason = _config_reason(cfg)
    if reason is not None:
        raise ValueError(f"the tick kernels do not implement this config: "
                         f"{reason}")
    est_kf = cfg.estimator_mode == "kf"
    kf_in = (kf_x, kf_p, prev_v, prev_q)
    if any((t is None) == est_kf for t in kf_in):
        raise ValueError(f"estimator_mode={cfg.estimator_mode!r}: pass "
                         "kf_x, kf_p, prev_v and prev_q exactly when it is "
                         "'kf'")
    if xi.device.type == "cpu":
        from mpc_limx_control_tpu_torch.control import rollout as ro
        from mpc_limx_control_tpu_torch.core.types import KFState

        st = ro.PlantState(xi=xi, q=q, foot_l=foot_l, foot_r=foot_r,
                           qp_z=z_warm, qp_lam=y_warm, ref_anchor=anchor,
                           kf=KFState(x_hat=kf_x, p_cov=kf_p) if est_kf
                           else None, prev_v=prev_v, prev_q=prev_q)
        st2, m = ro._plant_step_ref(cfg, st, it, grf_override=grf_held,
                                    v_des=v_des, yaw_rate_des=yaw_rate,
                                    solve_form="subst")
        outs = (st2.xi, st2.q, st2.foot_l, st2.foot_r, st2.qp_z,
                st2.qp_lam, st2.ref_anchor, m["qp_residual"], m["grf"],
                m["foot_target"])
        return outs + ((st2.kf.x_hat, st2.kf.p_cov) if est_kf else ())
    plan = prepare_tick_launch(xi, q, foot_l, foot_r, z_warm, y_warm, anchor,
                               it, v_des, yaw_rate, kf_x, kf_p, prev_v,
                               prev_q, grf_held, cfg=cfg)
    plan.kernel.launch(plan.params, plan.ptrs, plan.batch,
                       torch.cuda.current_stream(xi.device).cuda_stream)
    return plan.results


class TickLaunch(NamedTuple):
    """One launch of a tick kernel, ready to go: the kernel,
    its constants, its device pointers (inputs then outputs), the batch,
    and what :func:`fused_walking_tick` returns once it has run."""

    kernel: _build.Kernel
    params: TickParams
    ptrs: list
    batch: int
    results: tuple


def prepare_tick_launch(xi, q, foot_l, foot_r, z_warm, y_warm, anchor, it,
                        v_des, yaw_rate, kf_x=None, kf_p=None, prev_v=None,
                        prev_q=None, grf_held=None, *, cfg) -> TickLaunch:
    """Check the CUDA tensors of :func:`fused_walking_tick` (same
    arguments) and allocate its outputs, without launching: the kernel
    variant is chosen by the config's mode and estimator and by
    ``grf_held``."""
    if xi.device.type != "cuda":
        raise ValueError(f"the tick kernels run on CUDA tensors, got "
                         f"{xi.device}")
    est_kf = cfg.estimator_mode == "kf"
    hold = grf_held is not None
    N = int(cfg.srbd.horizon)
    n = (6 if cfg.mode == "stand" else 3) * N
    B = xi.shape[0]
    dev = xi.device
    state_in = (("xi", xi, (B, NX)), ("q", q, (B, 6)),
                ("foot_l", foot_l, (B, 3)), ("foot_r", foot_r, (B, 3)))
    warm_in = (("z_warm", z_warm, (B, n)), ("y_warm", y_warm, (B, 2 * n)))
    cmd_in = (("anchor", anchor, (B, 3)), ("it", it, (B,)),
              ("v_des", v_des, (B, 3)), ("yaw_rate", yaw_rate, (B,)))
    ins = state_in + (() if hold else warm_in) + cmd_in
    if hold:
        ins += (("grf_held", grf_held, (B, 6)),)
    if est_kf:
        ins += (("kf_x", kf_x, (B, 12)), ("kf_p", kf_p, (B, 12, 12)),
                ("prev_v", prev_v, (B, 3)), ("prev_q", prev_q, (B, 6)))
    for name, t, shape in ins:
        _build.check_tensor(name, t, shape, dev)
    if hold:
        # the warm QP state passes through untouched
        for name, t, shape in warm_in:
            _build.check_tensor(name, t, shape, dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    state_out = (empty(B, NX), empty(B, 6), empty(B, 3), empty(B, 3))
    warm_out = () if hold else (empty(B, n), empty(B, 2 * n))
    cmd_out = (empty(B, 3), empty(B), empty(B, 6), empty(B, 3))
    kf_out = (empty(B, 12), empty(B, 12, 12)) if est_kf else ()
    outs = state_out + warm_out + cmd_out + kf_out
    results = (state_out + (z_warm, y_warm) + cmd_out + kf_out if hold
               else outs)
    return TickLaunch(tick_kernels(cfg)[(est_kf, hold)], tick_params(cfg),
                      [t.data_ptr() for _, t, _ in ins]
                      + [t.data_ptr() for t in outs], B, results)
