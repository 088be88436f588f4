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

The two solving forms of each mode have a second entry point each for
``SolverConfig.solve_form="inv"`` (``walking_tick_inv``,
``walking_tick_kf_inv``, ``standing_tick_inv``, ``standing_tick_kf_inv``:
the MPC core with the explicit factor inverse, csrc/mpc_core.cuh, where
n = nu N <= 64; the substitution sweeps beyond, as the TPU kernel does,
mpc_fused_pallas.py:249); hold ticks run no solve.

:func:`kernel_refusal` says why these kernels do not implement a config
(None: they do); ``control.rollout.tick_route`` combines it with the
controller's own answer into the path a config takes on the card.

The live session's walking ticks at batch 1 have two entry points of their
own (``csrc/session_tick.cu``): ``walking_session_tick`` (the warm solve
tick) and ``walking_session_tick_hold`` (the held-force tick), which read
the session's packet and write its command, with no plant step.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from mpc_limx_control_tpu_torch.ops import _build
from mpc_limx_control_tpu_torch.ops.mpc_fused_cuda import (
    KERNEL_SOLVE_FORMS, NX, MpcParams, mpc_params, plain_solve_form,
    size_reason)

# The kernels and their launch counters (see ops/_build.py), by (mode,
# estimator_mode, hold, solve_form). The hold variants take neither the
# warm QP state nor return it (it passes through) and run no solve, so
# both solve forms share them; the KF variants take the filter state,
# prev_v and prev_q and return the filter state.
_SIZER = "walking_tick_params_bytes"


def _tick_table() -> dict:
    table = {}
    for mode, stem in (("walk", "walking_tick"), ("stand", "standing_tick")):
        for est, kf, n_ptr in (("truth", "", 20), ("kf", "_kf", 26)):
            hold = _build.Kernel(f"{stem}{kf}_hold", n_ptr=n_ptr - 3,
                                 params_sizer=_SIZER)
            for form, suffix in (("subst", ""), ("inv", "_inv")):
                table[mode, est, False, form] = _build.Kernel(
                    f"{stem}{kf}{suffix}", n_ptr=n_ptr, params_sizer=_SIZER)
                table[mode, est, True, form] = hold
    return table


TICK_TABLE = _tick_table()


def tick_kernel(cfg, hold: bool) -> _build.Kernel:
    """The kernel of the config's solving tick (hold False) or held-force
    tick (hold True)."""
    return TICK_TABLE[cfg.mode, cfg.estimator_mode, hold,
                      cfg.srbd.solver.solve_form]


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


class SessionParams(ctypes.Structure):
    """Mirror of ``mpc::SessionParams`` in csrc/session_tick.cu."""

    _fields_ = [("tick", TickParams), ("vdes", ctypes.c_float * 3),
                ("wdes", ctypes.c_float), ("kp", ctypes.c_float),
                ("kd", ctypes.c_float), ("anchor", ctypes.c_int),
                ("inv", ctypes.c_int)]


# The live session's walking tick at batch 1 (csrc/session_tick.cu): the
# warm solve tick (the packet's first 50 floats, z and y in place, out
# [command, next anchor, force]) and the held-force tick (the packet, the
# next anchor written into it, out the command)
_SESSION_SIZER = "walking_session_params_bytes"
WALKING_SESSION_TICK = _build.Kernel("walking_session_tick", n_ptr=4,
                                     params_sizer=_SESSION_SIZER)
WALKING_SESSION_TICK_HOLD = _build.Kernel("walking_session_tick_hold",
                                          n_ptr=2,
                                          params_sizer=_SESSION_SIZER)
SESSION_KERNELS = (WALKING_SESSION_TICK, WALKING_SESSION_TICK_HOLD)
# the packet's row and the outputs' (control/session.py's layout, which
# csrc/session_tick.cu reads)
SESSION_PACKET, SESSION_SOLVE_IN = 56, 50
SESSION_CMD, SESSION_WARM_OUT = 30, 39


@functools.lru_cache(maxsize=16)
def session_params(cfg) -> SessionParams:
    """Constants of the session kernels for a (frozen, hashable) walking
    config: the tick's, the commanded velocity and yaw rate, the gains,
    whether the held tick writes the next anchor back (an anchor band) and
    the solve form. Cached; callers must not mutate it."""
    p = SessionParams()
    p.tick = tick_params(cfg)
    p.vdes[:] = [float(v) for v in cfg.desired_velocity]
    p.wdes = float(cfg.desired_yaw_rate)
    p.kp, p.kd = float(cfg.kp), float(cfg.kd)
    p.anchor = int(cfg.ref_anchor_band > 0.0)
    p.inv = int(cfg.srbd.solver.solve_form == "inv")
    return p


def _session_checks(cfg, tensors, device) -> int:
    if (device.type != "cuda" or cfg.mode != "walk"
            or kernel_refusal(cfg) is not None):
        raise ValueError("the session kernels run walking configs that the "
                         "tick kernels implement, on CUDA tensors")
    B = tensors[0][1].shape[0]
    for name, t, width in tensors:
        _build.check_tensor(name, t, (B, width), device)
    return B


def walking_session_tick(cfg, solve_in, z, y, out) -> None:
    """The session's warm solve tick: solve_in [B, 50] (the packet's
    sensors and anchor), z [B, 3N] and y [B, 6N] updated in place, out
    [B, 39] = [command (30), next anchor (3), force (L, R)]; one launch."""
    n = 3 * int(cfg.srbd.horizon)
    B = _session_checks(cfg, (("solve_in", solve_in, SESSION_SOLVE_IN),
                              ("z", z, n), ("y", y, 2 * n),
                              ("out", out, SESSION_WARM_OUT)),
                        solve_in.device)
    WALKING_SESSION_TICK.launch(session_params(cfg),
                                [t.data_ptr() for t in (solve_in, z, y, out)],
                                B, solve_in.device)


def walking_session_tick_hold(cfg, packet, out) -> None:
    """The session's held-force tick: packet [B, 56] (its anchor slice
    advanced in place when the config tracks an anchor), out [B, 30] the
    command; one launch."""
    B = _session_checks(cfg, (("packet", packet, SESSION_PACKET),
                              ("out", out, SESSION_CMD)), packet.device)
    WALKING_SESSION_TICK_HOLD.launch(session_params(cfg),
                                     [packet.data_ptr(), out.data_ptr()], B,
                                     packet.device)


def kernel_refusal(cfg) -> str | None:
    """Why the ``walking_tick`` / ``standing_tick`` kernels do not implement
    the config's tick (None: they do). They run walk or stand mode, truth
    or KF odometry, capture or reference placement, solve_form "subst" or
    "inv", at a horizon their MPC core takes (``mpc_fused_cuda.size_reason``
    of the solving kernel: 1 to 85 steps walking, 1 to 42 standing, within
    a block's shared memory), with the analytic IK, the level attitude
    reference and the warm ``admm_fused`` solver."""
    for field, value, runs in (
            ("mode", cfg.mode, ("walk", "stand")),
            ("estimator_mode", cfg.estimator_mode, ("truth", "kf")),
            ("placement_mode", cfg.placement_mode, ("capture", "reference")),
            ("solve_form", cfg.srbd.solver.solve_form, KERNEL_SOLVE_FORMS)):
        if value not in runs:
            return f"the tick kernels run {field} in {runs} (got {value!r})"
    reason = size_reason(tick_kernel(cfg, False).name, cfg.srbd.horizon)
    if reason is not None:
        return reason
    if cfg.ik_method != "analytic":
        return ("the tick kernels run the analytic IK (got ik_method="
                f"{cfg.ik_method!r})")
    if cfg.srbd.attitude_ref != "level":
        return ("the tick kernels' MPC is level-attitude only (got "
                f"attitude_ref={cfg.srbd.attitude_ref!r})")
    if not cfg.qp_warm_start or cfg.srbd.solver.method != "admm_fused":
        return ("only the warm admm_fused solver runs in the tick kernel "
                f"(got method={cfg.srbd.solver.method!r}, qp_warm_start="
                f"{cfg.qp_warm_start})")
    return None


def supports_fused_tick(cfg) -> bool:
    """True when the tick kernels implement the config's tick (the JAX
    ``tick_fused_pallas.supports_fused_tick``): :func:`kernel_refusal` is
    None."""
    return kernel_refusal(cfg) is None


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
    exact-solve ADMM (``solve_form="subst"``; ``"linv"`` for the ``inv``
    forms where n = nu N <= 64).
    """
    reason = kernel_refusal(cfg)
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
                                    solve_form=plain_solve_form(
                                        cfg.srbd.solver.solve_form,
                                        6 if cfg.mode == "stand" else 3,
                                        int(cfg.srbd.horizon)))
        outs = (st2.xi, st2.q, st2.foot_l, st2.foot_r, st2.qp_z,
                st2.qp_lam, st2.ref_anchor, m["qp_residual"], m["grf"],
                m["foot_target"])
        return outs + ((st2.kf.x_hat, st2.kf.p_cov) if est_kf else ())
    plan = prepare_tick_launch(xi, q, foot_l, foot_r, z_warm, y_warm, anchor,
                               it, v_des, yaw_rate, kf_x, kf_p, prev_v,
                               prev_q, grf_held, cfg=cfg)
    plan.launch()
    return plan.results


class TickLaunch(NamedTuple):
    """One launch of a tick kernel, ready to go: the kernel,
    its constants, its device pointers (inputs then outputs), the batch,
    what :func:`fused_walking_tick` returns once it has run, and the input
    tensors behind the pointers (held so that a plan launched later, or
    replayed from a CUDA graph, never reads freed memory)."""

    kernel: _build.Kernel
    params: TickParams
    ptrs: list
    batch: int
    results: tuple
    inputs: tuple

    def launch(self) -> None:
        """Launch the kernel on its tensors' device, in that device's
        current stream (a plan launched later, from a CUDA graph or the
        resident rollout, launches where its tensors live)."""
        self.kernel.launch(self.params, self.ptrs, self.batch,
                           self.inputs[0].device)


def prepare_tick_launch(xi, q, foot_l, foot_r, z_warm, y_warm, anchor, it,
                        v_des, yaw_rate, kf_x=None, kf_p=None, prev_v=None,
                        prev_q=None, grf_held=None, *, cfg,
                        out=None) -> TickLaunch:
    """Check the CUDA tensors of :func:`fused_walking_tick` (same
    arguments) and allocate its outputs, without launching: the kernel
    variant is chosen by the config's mode and estimator and by
    ``grf_held``. ``out``: the kernel's output tensors to write instead
    (xi', q', foot_l', foot_r', then z, y unless the tick holds, anchor',
    residual, grf, target, then kf_x', kf_p' with the filter), none of
    them an input (``control.rollout.batched_rollout_resident``'s double
    buffer)."""
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

    shapes = ((B, NX), (B, 6), (B, 3), (B, 3)) \
        + (() if hold else ((B, n), (B, 2 * n))) \
        + ((B, 3), (B,), (B, 6), (B, 3)) \
        + (((B, 12), (B, 12, 12)) if est_kf else ())
    if out is None:
        outs = tuple(torch.empty(sh, dtype=torch.float32, device=dev)
                     for sh in shapes)
    else:
        if len(out) != len(shapes):
            raise ValueError(f"out: {len(out)} tensors, the kernel writes "
                             f"{len(shapes)}")
        for i, (t, sh) in enumerate(zip(out, shapes)):
            _build.check_tensor(f"out[{i}]", t, sh, dev)
        outs = tuple(out)
    n_kf = len(outs) - (2 if est_kf else 0)
    state_out, cmd_out, kf_out = outs[:4], outs[n_kf - 4:n_kf], outs[n_kf:]
    results = (state_out + (z_warm, y_warm) + cmd_out + kf_out if hold
               else outs)
    return TickLaunch(tick_kernel(cfg, hold), tick_params(cfg),
                      [t.data_ptr() for _, t, _ in ins]
                      + [t.data_ptr() for t in outs], B, results,
                      tuple(t for _, t, _ in ins))
