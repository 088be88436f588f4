"""Batched closed-loop simulation harness, walking and standing.

Counterpart of ``mpc_limx_control_tpu.control.rollout``: a batched SRBD
plant driven by the controller tick, with the swing leg tracking its
command ideally and the stance foot pinned where it touched down (its
joints from IK); standing, both feet stay pinned. The controller sees the
plant truth
(``estimator_mode="truth"``) or the 12-state Kalman filter's estimate fed
by sensors synthesized from the truth (``"kf"``). Batch-first throughout.

Dispatch of :func:`plant_step`:

* CUDA tensors and a config :func:`ops.tick_fused_cuda.supports_fused_tick`
  accepts (walk or stand mode; truth or KF odometry): the whole tick is
  ONE launch of a ``walking_tick`` / ``standing_tick`` kernel variant,
  chosen by the mode, the estimator and by whether the tick holds a force
  (``grf_override``, the dtMPC schedule);
* CUDA tensors and any other config the port has
  (``tick_fused_cuda.runs_as_composition``: a cold start, PDIP, the dense
  ADMM -- ``ControllerConfig()`` itself --, the Riccati solver, the
  iterative IKs, the receding attitude reference):
  :func:`_plant_step_ref` on the card, as the JAX package runs the
  composition for such configs on the TPU; its dense QP solves launch the
  batched Cholesky / SPD-solve kernels of ``ops/chol_cuda.py``, its warm
  fused solves the MPC kernels where they apply;
* CUDA tensors with an unknown value, a horizon past what the MPC kernel
  the tick would launch takes (85 steps walking, 42 standing), or a dense
  QP past the Cholesky kernels' order: NotImplementedError naming it,
  before the tick;
* CPU tensors: :func:`_plant_step_ref`, the plain composition, as the JAX
  package runs off the TPU.

:func:`rollout` / :func:`batched_rollout` write the per-tick metrics into
tensors preallocated on the state's device and never synchronize with the
host inside the loop; :func:`soak_rollout` reduces them per window on the
device and fetches the reductions once.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import (ImuData, JointState,
                                                   KFState, OdomState,
                                                   default_device)
from mpc_limx_control_tpu_torch.control import controller as ctrl
from mpc_limx_control_tpu_torch.control import estimator as est
from mpc_limx_control_tpu_torch.control import gait as gaitmod
from mpc_limx_control_tpu_torch.models import kinematics as kin
from mpc_limx_control_tpu_torch.models import srbd
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc
from mpc_limx_control_tpu_torch.utils import rotations as rot

METRIC_KEYS = ("est_error", "height", "velocity", "grf", "qp_residual",
               "foot_target")
KF_METRIC_KEYS = ("kf_cov_pos", "kf_cov_vel")
_METRIC_WIDTH = {"est_error": (), "height": (), "velocity": (3,),
                 "grf": (6,), "qp_residual": (), "foot_target": (3,),
                 "kf_cov_pos": (3,), "kf_cov_vel": (3,)}


@dataclasses.dataclass(frozen=True)
class PlantState:
    """Batched plant + controller carry, each field [B, ...].

    xi [B,13] SRBD state; q [B,6] joints; foot_l / foot_r [B,3] world;
    qp_z [B,nz] / qp_lam [B,m] warm state of the GRF QP (None when
    qp_warm_start is off); ref_anchor [B,3] = (x, y, yaw) tracking anchor
    (None = receding reference). With estimator_mode "kf": the filter
    state kf, and the previous tick's truth velocity prev_v [B,3] and
    joints prev_q [B,6], from which the IMU acceleration and the joint
    velocities are synthesized (None otherwise).
    """

    xi: torch.Tensor
    q: torch.Tensor
    foot_l: torch.Tensor
    foot_r: torch.Tensor
    qp_z: torch.Tensor | None = None
    qp_lam: torch.Tensor | None = None
    ref_anchor: torch.Tensor | None = None
    kf: KFState | None = None
    prev_v: torch.Tensor | None = None
    prev_q: torch.Tensor | None = None

    def replace(self, **kw) -> "PlantState":
        return dataclasses.replace(self, **kw)


def initial_plant_state(cfg: ControllerConfig, batch=(), device=None,
                        dtype=torch.float32) -> PlantState:
    """Standing at the configured base height, feet at their nominal
    offsets on the ground, joints from IK; in KF mode the filter starts at
    the true pose and feet. ``batch`` is () for one scenario or (B,). The
    state is created on the card unless ``device`` says otherwise."""
    batch = tuple(batch)
    device = default_device(device)
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
    kf = prev_v = prev_q = None
    if cfg.estimator_mode == "kf":
        # seeded at the truth, so the transient is the filter's own and
        # not a cold start from the origin
        kf = KFState.initial((B,), cfg.estimator.initial_covariance, dtype,
                             device)
        kf = kf.replace(x_hat=torch.cat([pos, kf.x_hat[:, 3:6], foot_l,
                                         foot_r], -1))
        prev_v = torch.zeros((B, 3), dtype=dtype, device=device)
        prev_q = q
    state = PlantState(xi=xi, q=q, foot_l=foot_l, foot_r=foot_r, qp_z=qp_z,
                       qp_lam=qp_lam, ref_anchor=ref_anchor, kf=kf,
                       prev_v=prev_v, prev_q=prev_q)
    return state if batch else _unbatch(state)


def _map_state(state: PlantState, fn) -> PlantState:
    def one(v):
        if v is None:
            return None
        if isinstance(v, KFState):
            return KFState(x_hat=fn(v.x_hat), p_cov=fn(v.p_cov))
        return fn(v)

    return PlantState(**{f.name: one(getattr(state, f.name))
                         for f in dataclasses.fields(state)})


def _unbatch(state: PlantState) -> PlantState:
    return _map_state(state, lambda x: x[0])


def _odom_from_xi(xi: torch.Tensor) -> OdomState:
    ori = xi[:, 0:3]
    return OdomState(pos=xi[:, 3:6], ori=ori, quat=rot.rpy_to_quat(ori),
                     v_pos=xi[:, 9:12], v_ori=xi[:, 6:9])


def _kf_estimate(cfg: ControllerConfig, state: PlantState,
                 iteration: torch.Tensor):
    """Synthesize IMU and joint readings from the plant truth and run one
    KF tick (the intended path of src/mpc_control.cpp:158-192); returns
    (kf_new, odom, truth)."""
    truth = _odom_from_xi(state.xi)
    dt = cfg.gait.dt
    joints = JointState(q=state.q, dq=(state.q - state.prev_q) / dt,
                        tau=torch.zeros_like(state.q))
    R_wb = rot.quat_to_rot(truth.quat)
    a_world = (truth.v_pos - state.prev_v) / dt
    g_vec = torch.tensor([0.0, 0.0, -9.81], dtype=state.xi.dtype,
                         device=state.xi.device)
    # the accelerometer reads the specific force in the body frame
    imu = ImuData(quat=truth.quat,
                  acc=(R_wb.transpose(-1, -2)
                       @ (a_world - g_vec)[..., None])[..., 0],
                  gyro=(R_wb.transpose(-1, -2)
                        @ truth.v_ori[..., None])[..., 0])
    ls = gaitmod.gait_clock(cfg.gait, iteration).left_swing
    if cfg.mode == "stand":
        contact = torch.ones((*ls.shape, 2), dtype=torch.bool,
                             device=ls.device)
    else:
        contact = torch.stack([~ls, ls], -1)
    out = est.estimator_tick(cfg, state.kf, joints, imu, contact, dt)
    return out.kf, out.odom, truth


def _kf_metrics(kf: KFState) -> dict:
    """Covariance health per tick (the role of the reference's 200 Hz
    pose-with-covariance stream, include/stateEstimator.h:404-419)."""
    d = torch.diagonal(kf.p_cov, dim1=-2, dim2=-1)
    return {"kf_cov_pos": d[:, 0:3], "kf_cov_vel": d[:, 3:6]}


@functools.lru_cache(maxsize=16)
def _command(desired_velocity: tuple, dtype, device) -> torch.Tensor:
    """The configured velocity command on `device`, made once: a tensor
    made from the tuple every tick is a copy from pageable host memory,
    which blocks the host behind the kernels queued before it. Callers
    must not modify it."""
    return torch.tensor(desired_velocity, dtype=dtype, device=device)


def plant_step(cfg: ControllerConfig, state: PlantState,
               iteration: torch.Tensor, grf_override=None, v_des=None):
    """One 1 kHz simulation tick for a batch of scenarios; returns
    (new_state, metrics) with metrics[k] [B, ...].

    With ``grf_override`` [B,6] the MPC solve is skipped and the given
    force held: walking, on the foot now in stance; standing, on both feet
    as given (the intermediate ticks of the reference's mpcStep = 5
    re-solve schedule, include/MPCParam.h:46-47).
    ``v_des`` overrides the configured velocity command. See the module
    docstring for the dispatch."""
    if state.xi.device.type == "cpu":
        return _plant_step_ref(cfg, state, iteration,
                               grf_override=grf_override, v_des=v_des)
    if tfc.runs_as_composition(cfg):
        return _plant_step_ref(cfg, state, iteration,
                               grf_override=grf_override, v_des=v_des)
    reason = tfc.unsupported_reason(cfg, state)
    if reason is not None:
        raise NotImplementedError(f"plant_step on {state.xi.device}: "
                                  f"{reason}")
    B = state.xi.shape[0]
    dtype, device = state.xi.dtype, state.xi.device
    vd = (_command(tuple(cfg.desired_velocity), dtype, device)
          if v_des is None
          else torch.as_tensor(v_des, dtype=dtype, device=device)
          ).expand(B, 3)
    wd = torch.full((B,), float(cfg.desired_yaw_rate), dtype=dtype,
                    device=device)
    it = torch.as_tensor(iteration, dtype=dtype, device=device).expand(B)
    anc = (state.ref_anchor if state.ref_anchor is not None
           else torch.cat([state.xi[:, 3:5], state.xi[:, 2:3]], -1))
    kf = state.kf
    # (a state from _plant_step_ref holds prev_v as a view of xi)
    kf_args = {} if kf is None else dict(
        kf_x=kf.x_hat, kf_p=kf.p_cov, prev_v=state.prev_v.contiguous(),
        prev_q=state.prev_q)
    (xi, q, fl, fr, z, y, anc_n, res, grf, tgt, *kf_out) = \
        tfc.fused_walking_tick(
            state.xi, state.q, state.foot_l, state.foot_r, state.qp_z,
            state.qp_lam, anc.contiguous(), it.contiguous(),
            vd.contiguous(), wd, cfg=cfg, **kf_args,
            grf_held=(None if grf_override is None
                      else grf_override.contiguous()))
    new_state = PlantState(
        xi=xi, q=q, foot_l=fl, foot_r=fr, qp_z=z, qp_lam=y,
        ref_anchor=anc_n if state.ref_anchor is not None else None)
    metrics = {"height": xi[:, 5], "velocity": xi[:, 9:12], "grf": grf,
               "qp_residual": res, "foot_target": tgt}
    if kf is None:
        metrics["est_error"] = torch.zeros_like(res)
    else:
        kf_new = KFState(x_hat=kf_out[0], p_cov=kf_out[1])
        # the filter's input was the pre-step truth: prev_v / prev_q and
        # the error are taken against it
        new_state = new_state.replace(
            kf=kf_new, prev_v=state.xi[:, 9:12].contiguous(), prev_q=state.q)
        metrics["est_error"] = torch.linalg.vector_norm(
            kf_new.x_hat[:, 0:3] - state.xi[:, 3:6], dim=-1)
        metrics.update(_kf_metrics(kf_new))
    return new_state, metrics


def _plant_step_ref(cfg: ControllerConfig, state: PlantState,
                    iteration: torch.Tensor, grf_override=None, v_des=None,
                    yaw_rate_des=None, solve_form: str | None = None):
    """The plain composition of one tick.

    ``solve_form`` ("kinv" / "subst" / "linv") runs the warm admm_fused
    QP as the plain composition with that solve form on any device; None
    lets the controller dispatch it (the kernel on CUDA, "kinv" on the
    CPU).
    ``yaw_rate_des`` overrides cfg.desired_yaw_rate.
    """
    dtype, device = state.xi.dtype, state.xi.device
    B = state.xi.shape[0]
    iteration = torch.as_tensor(iteration, dtype=dtype,
                                device=device).expand(B)
    if cfg.estimator_mode == "kf":
        # the controller sees the filter's estimate, the plant the truth
        kf_new, odom, truth = _kf_estimate(cfg, state, iteration)
    else:
        kf_new = None
        odom = truth = _odom_from_xi(state.xi)
    joints = JointState(q=state.q, dq=torch.zeros_like(state.q),
                        tau=torch.zeros_like(state.q))
    qp_warm = (state.qp_z, state.qp_lam) if cfg.qp_warm_start else None
    cmd, diag = ctrl.tick(cfg, odom, joints, iteration,
                          grf_override=grf_override, qp_warm=qp_warm,
                          v_des=v_des, yaw_rate_des=yaw_rate_des,
                          ref_anchor=state.ref_anchor, solve_form=solve_form)

    # ---- SRBD dynamics with the commanded GRF (exact ZOH, vector form) --
    stand = cfg.mode == "stand"
    ls = gaitmod.gait_clock(cfg.gait, iteration).left_swing
    if stand:
        on_l = on_r = torch.ones((B,), dtype=dtype, device=device)
    else:
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

    def to_base(p_w):
        return (R_new.transpose(-1, -2) @ (p_w - base_new)[..., None])[..., 0]

    if stand:
        # both feet stay pinned; both legs re-solved from the new base pose
        foot_l, foot_r = state.foot_l, state.foot_r
        q_new = torch.cat([
            kin.inverse_kinematics_analytic(gl, to_base(foot_l),
                                            state.q[:, :3]),
            kin.inverse_kinematics_analytic(gr, to_base(foot_r),
                                            state.q[:, 3:])], -1)
    else:
        # swing leg executes its command; stance leg keeps its foot pinned
        q_sw = torch.where(ls[:, None], cmd.q[:, :3], cmd.q[:, 3:])
        p_sw_b = kin.forward_kinematics(kin.select_geometry(ls, gl, gr),
                                        q_sw)
        p_sw_w = base_new + (R_new @ p_sw_b[..., None])[..., 0]
        # rigid ground: the swing foot cannot penetrate the support surface
        p_sw_w = torch.cat(
            [p_sw_w[:, :2],
             torch.clamp(p_sw_w[:, 2:3], min=cfg.ground_height)], -1)
        foot_l = torch.where(ls[:, None], p_sw_w, state.foot_l)
        foot_r = torch.where(ls[:, None], state.foot_r, p_sw_w)
        foot_st = torch.where(ls[:, None], foot_r, foot_l)
        q_prev_st = torch.where(ls[:, None], state.q[:, 3:], state.q[:, :3])
        q_st = kin.inverse_kinematics_analytic(
            kin.select_geometry(ls, gr, gl), to_base(foot_st), q_prev_st)
        q_new = torch.where(ls[:, None], torch.cat([q_sw, q_st], -1),
                            torch.cat([q_st, q_sw], -1))
    if cfg.qp_warm_start and diag.qp_state is not None:
        qp_z, qp_lam = diag.qp_state
    else:
        qp_z, qp_lam = state.qp_z, state.qp_lam
    new_state = PlantState(
        xi=xi_new, q=q_new, foot_l=foot_l, foot_r=foot_r, qp_z=qp_z,
        qp_lam=qp_lam,
        ref_anchor=diag.ref_anchor if state.ref_anchor is not None else None,
        kf=kf_new,
        prev_v=truth.v_pos if state.prev_v is not None else None,
        prev_q=state.q if state.prev_q is not None else None)
    metrics = {
        "est_error": torch.linalg.vector_norm(odom.pos - truth.pos, dim=-1),
        "height": xi_new[:, 5],
        "velocity": xi_new[:, 9:12],
        "grf": diag.grf,
        "qp_residual": diag.qp_residual,
        "foot_target": diag.foot_target,
    }
    if kf_new is not None:
        metrics.update(_kf_metrics(kf_new))
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
    keys = METRIC_KEYS + (KF_METRIC_KEYS if cfg.estimator_mode == "kf"
                          else ())
    metrics = {k: torch.empty((B, steps, *_METRIC_WIDTH[k]), dtype=dtype,
                              device=device) for k in keys}
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
        for k in keys:
            metrics[k][:, t] = m[k]
    return s, metrics


def rollout(cfg: ControllerConfig, state0: PlantState, steps: int,
            start_iteration=0, mpc_every: int = 1):
    """Closed-loop simulation of ONE scenario (unbatched state, e.g. from
    ``initial_plant_state(cfg)``); returns (final, metrics) with metrics
    stacked over time on axis 0. ``mpc_every`` > 1 reproduces the
    reference's dtMPC schedule: the MPC is re-solved every `mpc_every`
    ticks (mpcStep = 5, include/MPCParam.h:46-47) and the force held in
    between, while gait, swing tracking and the plant run every tick."""
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


SOAK_KEYS = ("height_mean", "height_min", "height_max", "vx_mean", "vy_mean",
             "qp_res_max", "est_err_max", "nonfinite_ticks")
SOAK_KF_KEYS = ("kf_cov_pos_max", "kf_cov_pos_mean", "kf_cov_vel_max")


def soak_rollout(cfg: ControllerConfig, state0: PlantState, n_windows: int,
                 window: int, start_iteration=0, mpc_every: int = 1):
    """Endurance soak: `n_windows` blocks of `window` ticks, the metrics of
    each block reduced to summary statistics on the device.

    The per-tick metrics of a minute-long batched soak (60k ticks x B x
    ~20 floats) never leave the device: each window's reductions are
    written into one [n_keys, n_windows] tensor that is fetched once, at
    the end. `start_iteration` may be a [B] tensor (staggered gait
    phases); `mpc_every` > 1 soaks the dtMPC hold schedule. An unbatched
    state runs as one scenario. Returns (final_state, stats) with every
    stats entry a CPU tensor [n_windows].
    """
    batched = state0.xi.ndim == 2
    s = state0 if batched else _map_state(state0, lambda x: x[None])
    device = s.xi.device
    B = s.xi.shape[0]
    keys = SOAK_KEYS + (SOAK_KF_KEYS if cfg.estimator_mode == "kf" else ())
    stats = torch.empty((len(keys), n_windows), dtype=torch.float64,
                        device=device)
    it = torch.as_tensor(start_iteration, dtype=s.xi.dtype,
                         device=device).expand(B)
    for w in range(n_windows):
        s, m = _rollout_batched(cfg, s, window, it, mpc_every)
        h, v = m["height"], m["velocity"]
        red = [h.mean(), h.min(), h.max(), v[..., 0].mean(),
               v[..., 1].mean(), m["qp_residual"].max(),
               m["est_error"].max(), (~torch.isfinite(h)).sum()]
        if cfg.estimator_mode == "kf":
            red += [m["kf_cov_pos"].max(), m["kf_cov_pos"].mean(),
                    m["kf_cov_vel"].max()]
        stats[:, w] = torch.stack([r.to(torch.float64) for r in red])
        it = it + window
    host = stats.cpu()
    out = {k: host[i] for i, k in enumerate(keys)}
    out["nonfinite_ticks"] = out["nonfinite_ticks"].to(torch.int32)
    return (s if batched else _unbatch(s)), out


def soak_stationary(stats: dict, tail_frac: float = 0.8) -> dict:
    """Host-side stationarity summary of :func:`soak_rollout` stats.

    Over the last `tail_frac` of windows: the tail mean, its spread and a
    least-squares drift slope per window of height, vx and (KF) the mean
    position covariance. A limit cycle has ~zero drift; anchor windup, the
    KF touchdown sink or f32 accumulation show as a slope long before they
    cross a hard floor."""
    import numpy as np

    out = {}
    n = len(np.asarray(stats["height_mean"]))
    i0 = int(round((1.0 - tail_frac) * n))
    w = np.arange(n - i0, dtype=np.float64)
    for key in ("height_mean", "vx_mean", "kf_cov_pos_mean"):
        if key not in stats:
            continue
        y = np.asarray(stats[key], np.float64)[i0:]
        slope = float(np.polyfit(w, y, 1)[0]) if len(y) > 1 else 0.0
        out[f"{key}_tail_mean"] = float(y.mean())
        out[f"{key}_tail_ptp"] = float(y.max() - y.min())
        out[f"{key}_drift_per_window"] = slope
    out["height_min"] = float(np.asarray(stats["height_min"]).min())
    out["nonfinite_ticks"] = int(np.asarray(stats["nonfinite_ticks"]).sum())
    if "kf_cov_pos_max" in stats:
        # the all-time max is the initial-covariance transient; steady-
        # state boundedness is the tail max
        cov_max = np.asarray(stats["kf_cov_pos_max"])
        out["kf_cov_pos_max"] = float(cov_max.max())
        out["kf_cov_pos_max_tail"] = float(cov_max[i0:].max())
        out["kf_cov_vel_max"] = float(np.asarray(
            stats["kf_cov_vel_max"]).max())
    return out
