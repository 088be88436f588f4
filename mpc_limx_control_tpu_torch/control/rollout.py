"""Batched closed-loop walking simulation harness.

Counterpart of the main path of ``mpc_limx_control_tpu.control.rollout``: a
batched SRBD plant driven by the controller tick (truth odometry), with
the swing leg tracking its command ideally and the stance foot pinned
where it touched down (its joints from IK). Batch-first throughout.

Dispatch of :func:`plant_step`:

* CUDA tensors and a config :func:`ops.tick_fused_cuda.supports_fused_tick`
  accepts: the whole tick is ONE launch of the ``walking_tick`` kernel;
* CUDA tensors with any other config (standing, the KF estimator, held
  dtMPC ticks, the receding attitude reference, ...): NotImplementedError
  naming the ROADMAP item that ports it;
* CPU tensors: :func:`_plant_step_ref`, the plain composition, as the JAX
  package runs off the TPU.

:func:`rollout` / :func:`batched_rollout` write the per-tick metrics into
tensors preallocated on the state's device and never synchronize with the
host inside the loop.
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import JointState, OdomState
from mpc_limx_control_tpu_torch.control import controller as ctrl
from mpc_limx_control_tpu_torch.control import gait as gaitmod
from mpc_limx_control_tpu_torch.models import kinematics as kin
from mpc_limx_control_tpu_torch.models import srbd
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc
from mpc_limx_control_tpu_torch.utils import rotations as rot

METRIC_KEYS = ("est_error", "height", "velocity", "grf", "qp_residual",
               "foot_target")
_METRIC_WIDTH = {"est_error": (), "height": (), "velocity": (3,),
                 "grf": (6,), "qp_residual": (), "foot_target": (3,)}


@dataclasses.dataclass(frozen=True)
class PlantState:
    """Batched plant + controller carry, each field [B, ...].

    xi [B,13] SRBD state; q [B,6] joints; foot_l / foot_r [B,3] world;
    qp_z [B,nz] / qp_lam [B,m] warm state of the GRF QP (None when
    qp_warm_start is off); ref_anchor [B,3] = (x, y, yaw) tracking anchor
    (None = receding reference). The KF fields of the JAX PlantState come
    with the Kalman-filter slice.
    """

    xi: torch.Tensor
    q: torch.Tensor
    foot_l: torch.Tensor
    foot_r: torch.Tensor
    qp_z: torch.Tensor | None = None
    qp_lam: torch.Tensor | None = None
    ref_anchor: torch.Tensor | None = None

    def replace(self, **kw) -> "PlantState":
        return dataclasses.replace(self, **kw)


def initial_plant_state(cfg: ControllerConfig, batch=(), device=None,
                        dtype=torch.float32) -> PlantState:
    """Standing at the configured base height, feet at their nominal
    offsets on the ground, joints from IK. ``batch`` is () for one
    scenario or (B,)."""
    if cfg.estimator_mode != "truth":
        raise NotImplementedError(
            f"estimator_mode={cfg.estimator_mode!r}: the Kalman-filter "
            "state is ROADMAP queue 1, item 10")
    batch = tuple(batch)
    B = batch[0] if batch else 1

    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    pos = torch.zeros((B, 3), dtype=dtype, device=device)
    pos[:, 2] = cfg.ground_height + cfg.base_height
    xi = torch.zeros((B, 13), dtype=dtype, device=device)
    xi[:, 3:6] = pos
    xi[:, 12] = -9.81
    foot_l = pos + t(cfg.robot.nominal_foot_offset_left)
    foot_r = pos + t(cfg.robot.nominal_foot_offset_right)
    foot_l[:, 2] = cfg.ground_height
    foot_r[:, 2] = cfg.ground_height
    if cfg.mode == "stand":
        # a point-foot biped has no COP authority: feet under the COM in x
        foot_l[:, 0] = pos[:, 0]
        foot_r[:, 0] = pos[:, 0]
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype, device)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype, device)
    zero3 = torch.zeros((B, 3), dtype=dtype, device=device)
    q = torch.cat([kin.inverse_kinematics_analytic(gl, foot_l - pos, zero3),
                   kin.inverse_kinematics_analytic(gr, foot_r - pos, zero3)],
                  -1)
    qp_z = qp_lam = None
    if cfg.qp_warm_start:
        N = cfg.srbd.horizon
        nu = 3 if cfg.mode == "walk" else 6
        qp_z = torch.zeros((B, nu * N), dtype=dtype, device=device)
        # ADMM threads the scaled dual (starts at zero); PDIP multipliers
        # start strictly positive
        fill = 0.0 if cfg.srbd.solver.method in ("admm", "admm_fused") \
            else 1.0
        qp_lam = torch.full((B, 2 * nu * N), fill, dtype=dtype,
                            device=device)
    ref_anchor = None
    if cfg.ref_anchor_band > 0.0 and cfg.mode == "walk":
        ref_anchor = torch.cat([pos[:, :2], zero3[:, :1]], -1)
    state = PlantState(xi=xi, q=q, foot_l=foot_l, foot_r=foot_r, qp_z=qp_z,
                       qp_lam=qp_lam, ref_anchor=ref_anchor)
    return state if batch else _unbatch(state)


def _map_state(state: PlantState, fn) -> PlantState:
    return PlantState(**{f.name: (None if getattr(state, f.name) is None
                                  else fn(getattr(state, f.name)))
                         for f in dataclasses.fields(state)})


def _unbatch(state: PlantState) -> PlantState:
    return _map_state(state, lambda x: x[0])


def _odom_from_xi(xi: torch.Tensor) -> OdomState:
    ori = xi[:, 0:3]
    return OdomState(pos=xi[:, 3:6], ori=ori, quat=rot.rpy_to_quat(ori),
                     v_pos=xi[:, 9:12], v_ori=xi[:, 6:9])


def plant_step(cfg: ControllerConfig, state: PlantState,
               iteration: torch.Tensor, grf_override=None, v_des=None):
    """One 1 kHz simulation tick for a batch of scenarios; returns
    (new_state, metrics) with metrics[k] [B, ...]. See the module
    docstring for the dispatch."""
    if state.xi.device.type == "cpu":
        return _plant_step_ref(cfg, state, iteration,
                               grf_override=grf_override, v_des=v_des)
    reason = tfc.unsupported_reason(cfg, state)
    if grf_override is not None:
        reason = ("held dtMPC ticks (grf_override, mpc_every > 1) are the "
                  "hold variant of the tick kernel, ROADMAP queue 2, K4")
    if reason is not None:
        raise NotImplementedError(f"plant_step on {state.xi.device}: "
                                  f"{reason}")
    B = state.xi.shape[0]
    dtype, device = state.xi.dtype, state.xi.device
    vd = torch.as_tensor(cfg.desired_velocity if v_des is None else v_des,
                         dtype=dtype, device=device).expand(B, 3)
    wd = torch.full((B,), float(cfg.desired_yaw_rate), dtype=dtype,
                    device=device)
    it = torch.as_tensor(iteration, dtype=dtype, device=device).expand(B)
    anc = (state.ref_anchor if state.ref_anchor is not None
           else torch.cat([state.xi[:, 3:5], state.xi[:, 2:3]], -1))
    (xi, q, fl, fr, z, y, anc_n, res, grf, tgt) = tfc.fused_walking_tick(
        state.xi, state.q, state.foot_l, state.foot_r, state.qp_z,
        state.qp_lam, anc.contiguous(), it.contiguous(), vd.contiguous(),
        wd, cfg=cfg)
    new_state = PlantState(
        xi=xi, q=q, foot_l=fl, foot_r=fr, qp_z=z, qp_lam=y,
        ref_anchor=anc_n if state.ref_anchor is not None else None)
    metrics = {"est_error": torch.zeros_like(res), "height": xi[:, 5],
               "velocity": xi[:, 9:12], "grf": grf, "qp_residual": res,
               "foot_target": tgt}
    return new_state, metrics


def _plant_step_ref(cfg: ControllerConfig, state: PlantState,
                    iteration: torch.Tensor, grf_override=None, v_des=None,
                    yaw_rate_des=None, solve_form: str | None = None):
    """The plain composition of one tick (truth odometry).

    ``solve_form`` ("kinv" / "subst") runs the walking QP as the plain
    composition with that solve form on any device; None lets the
    controller dispatch it (the kernel on CUDA, "kinv" on the CPU).
    ``yaw_rate_des`` overrides cfg.desired_yaw_rate.
    """
    if cfg.estimator_mode != "truth":
        raise NotImplementedError(
            f"estimator_mode={cfg.estimator_mode!r}: the Kalman-filter "
            "tick is ROADMAP queue 1, item 10")
    dtype, device = state.xi.dtype, state.xi.device
    B = state.xi.shape[0]
    iteration = torch.as_tensor(iteration, dtype=dtype,
                                device=device).expand(B)
    odom = _odom_from_xi(state.xi)
    joints = JointState(q=state.q, dq=torch.zeros_like(state.q),
                        tau=torch.zeros_like(state.q))
    qp_warm = (state.qp_z, state.qp_lam) if cfg.qp_warm_start else None
    cmd, diag = ctrl.tick(cfg, odom, joints, iteration,
                          grf_override=grf_override, qp_warm=qp_warm,
                          v_des=v_des, yaw_rate_des=yaw_rate_des,
                          ref_anchor=state.ref_anchor, solve_form=solve_form)

    # ---- SRBD dynamics with the commanded GRF (exact ZOH, vector form) --
    ls = gaitmod.gait_clock(cfg.gait, iteration).left_swing
    on_l = 1.0 - ls.to(dtype)
    on_r = ls.to(dtype)
    feet = torch.stack([state.foot_l, state.foot_r], -2)
    forces = torch.stack([diag.grf[:, 0:3] * on_l[:, None],
                          diag.grf[:, 3:6] * on_r[:, None]], -2)
    xi_new = srbd.srbd_step_vector(cfg.robot, state.xi, feet, forces,
                                   cfg.gait.dt)

    # ---- foot / joint kinematics -------------------------------------
    base_new = xi_new[:, 3:6]
    R_new = rot.quat_to_rot(rot.rpy_to_quat(xi_new[:, 0:3]))
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype, device)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype, device)
    # swing leg executes its command; stance leg keeps its foot pinned
    q_sw = torch.where(ls[:, None], cmd.q[:, :3], cmd.q[:, 3:])
    p_sw_b = kin.forward_kinematics(kin.select_geometry(ls, gl, gr), q_sw)
    p_sw_w = base_new + (R_new @ p_sw_b[..., None])[..., 0]
    # rigid ground: the swing foot cannot penetrate the support surface
    p_sw_w = torch.cat([p_sw_w[:, :2],
                        torch.clamp(p_sw_w[:, 2:3], min=cfg.ground_height)],
                       -1)
    foot_l = torch.where(ls[:, None], p_sw_w, state.foot_l)
    foot_r = torch.where(ls[:, None], state.foot_r, p_sw_w)
    foot_st = torch.where(ls[:, None], foot_r, foot_l)
    q_prev_st = torch.where(ls[:, None], state.q[:, 3:], state.q[:, :3])
    q_st = kin.inverse_kinematics_analytic(
        kin.select_geometry(ls, gr, gl),
        (R_new.transpose(-1, -2) @ (foot_st - base_new)[..., None])[..., 0],
        q_prev_st)
    q_new = torch.where(ls[:, None], torch.cat([q_sw, q_st], -1),
                        torch.cat([q_st, q_sw], -1))
    if cfg.qp_warm_start and diag.qp_state is not None:
        qp_z, qp_lam = diag.qp_state
    else:
        qp_z, qp_lam = state.qp_z, state.qp_lam
    new_state = PlantState(
        xi=xi_new, q=q_new, foot_l=foot_l, foot_r=foot_r, qp_z=qp_z,
        qp_lam=qp_lam,
        ref_anchor=diag.ref_anchor if state.ref_anchor is not None else None)
    metrics = {
        "est_error": torch.zeros_like(xi_new[:, 0]),   # truth odometry
        "height": xi_new[:, 5],
        "velocity": xi_new[:, 9:12],
        "grf": diag.grf,
        "qp_residual": diag.qp_residual,
        "foot_target": diag.foot_target,
    }
    return new_state, metrics


def _rollout_batched(cfg, state0: PlantState, steps: int, start_iteration,
                     mpc_every: int):
    B = state0.xi.shape[0]
    dtype, device = state0.xi.dtype, state0.xi.device
    if mpc_every < 1 or steps % mpc_every != 0:
        raise ValueError(f"steps={steps} must be a multiple of "
                         f"mpc_every={mpc_every} >= 1")
    start = torch.as_tensor(start_iteration, dtype=dtype,
                            device=device).expand(B)
    # its[t] = t + start (float, as the JAX scan's arange + start)
    its = (torch.arange(steps, dtype=dtype, device=device)[:, None]
           + start[None, :]).contiguous()
    metrics = {k: torch.empty((B, steps, *_METRIC_WIDTH[k]), dtype=dtype,
                              device=device) for k in METRIC_KEYS}
    # the command lives on the device before the loop: a per-tick copy
    # from pageable host memory would block the host behind the queued
    # kernels every tick
    vd_cfg = torch.tensor(cfg.desired_velocity, dtype=dtype,
                          device=device).expand(B, 3).contiguous()
    s, grf = state0, None
    for t in range(steps):
        hold = grf if (mpc_every > 1 and t % mpc_every != 0) else None
        s, m = plant_step(cfg, s, its[t], grf_override=hold, v_des=vd_cfg)
        if mpc_every > 1 and t % mpc_every == 0:
            grf = m["grf"]
        for k in METRIC_KEYS:
            metrics[k][:, t] = m[k]
    return s, metrics


def rollout(cfg: ControllerConfig, state0: PlantState, steps: int,
            start_iteration=0, mpc_every: int = 1):
    """Closed-loop simulation of ONE scenario (unbatched state, e.g. from
    ``initial_plant_state(cfg)``); returns (final, metrics) with metrics
    stacked over time on axis 0. ``mpc_every`` > 1 re-solves the MPC
    every `mpc_every` ticks and holds the force in between (CPU only in
    this slice)."""
    s0 = _map_state(state0, lambda x: x[None])
    final, metrics = _rollout_batched(cfg, s0, steps, start_iteration,
                                      mpc_every)
    return _unbatch(final), {k: v[0] for k, v in metrics.items()}


def batched_rollout(cfg: ControllerConfig, state0: PlantState, steps: int,
                    start_iteration=0, mpc_every: int = 1):
    """Closed loop over a batch (state0 fields [B, ...]); start_iteration
    a scalar or a [B] tensor (staggered gait phases). Returns (final,
    metrics) with metrics[k] [B, steps, ...]."""
    return _rollout_batched(cfg, state0, steps, start_iteration, mpc_every)
