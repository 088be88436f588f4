"""Batched closed-loop simulation harness, walking and standing.

Counterpart of ``mpc_limx_control_tpu.control.rollout``: a batched SRBD
plant driven by the controller tick, with the swing leg tracking its
command ideally and the stance foot pinned where it touched down (its
joints from IK); standing, both feet stay pinned. The controller sees the
plant truth
(``estimator_mode="truth"``) or the 12-state Kalman filter's estimate fed
by sensors synthesized from the truth (``"kf"``). Batch-first throughout.

Dispatch of :func:`plant_step`: CPU tensors run :func:`_plant_step_ref`,
the plain composition, as the JAX package runs off the TPU. CUDA tensors
take :func:`tick_route`'s path: where the tick kernels implement the
config, ONE launch a tick of a ``walking_tick`` / ``standing_tick``
variant (chosen by the mode, the estimator, the solve form and whether the
tick holds a force, ``grf_override``); else :func:`_plant_step_ref` on the
card, as the JAX package runs its composition on the TPU (a cold start,
PDIP, the dense ADMM -- ``ControllerConfig()`` itself --, Riccati, the
iterative IKs, the receding reference: its dense QP solves launch the
``ops/chol_cuda.py`` kernels, its warm fused solves the MPC kernels where
they apply); NotImplementedError, before the tick, where the controller
cannot run it on the card either.

:func:`rollout` / :func:`batched_rollout` write the per-tick metrics into
tensors preallocated on the state's device and never synchronize with the
host inside the loop; :func:`soak_rollout` reduces them per window on the
device and fetches the reductions once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import (ImuData, JointState,
                                                   KFState, OdomState,
                                                   constant, default_device)
from mpc_limx_control_tpu_torch.control import controller as ctrl
from mpc_limx_control_tpu_torch.control import estimator as est
from mpc_limx_control_tpu_torch.control import gait as gaitmod
from mpc_limx_control_tpu_torch.models import kinematics as kin
from mpc_limx_control_tpu_torch.models import srbd
from mpc_limx_control_tpu_torch.ops import _build
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
    g_vec = constant((0.0, 0.0, -9.81), state.xi.dtype, state.xi.device)
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


class TickRoute(NamedTuple):
    """The path of a config's tick on the card: ``path`` "kernel", with the
    kernels of its solving and held-force ticks, or "composition" (the
    plain tick on the card, no kernels named)."""

    path: str
    solve: _build.Kernel | None = None
    hold: _build.Kernel | None = None


def tick_route(cfg: ControllerConfig) -> TickRoute:
    """How :func:`plant_step` runs the config on CUDA tensors: the tick
    kernels where they implement it, else the composition where the
    controller runs it on the card; NotImplementedError where neither
    does, with the controller's reason (an unknown value, or the horizon
    of the kernels its branch launches)."""
    if tfc.kernel_refusal(cfg) is None:
        return TickRoute("kernel", tfc.tick_kernel(cfg, False),
                         tfc.tick_kernel(cfg, True))
    reason = ctrl.card_refusal(cfg)
    if reason is not None:
        raise NotImplementedError(f"the card runs neither the tick kernels "
                                  f"nor the composition: {reason}")
    return TickRoute("composition")


def _kernel_state_reason(cfg: ControllerConfig, state: PlantState):
    """Why the tick kernel cannot run `state` (None: it can): it needs the
    warm QP state, and the filter fields exactly with the KF."""
    if state.qp_z is None or state.qp_lam is None:
        return "the tick kernel needs the warm QP state (qp_warm_start)"
    kf_state = (state.kf is not None and state.prev_v is not None
                and state.prev_q is not None)
    if kf_state != (cfg.estimator_mode == "kf"):
        return (f"estimator_mode={cfg.estimator_mode!r} needs a state "
                f"{'with' if not kf_state else 'without'} the filter "
                "fields (kf, prev_v, prev_q)")
    return None


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
    if (state.xi.device.type == "cpu"
            or tick_route(cfg).path == "composition"):
        return _plant_step_ref(cfg, state, iteration,
                               grf_override=grf_override, v_des=v_des)
    reason = _kernel_state_reason(cfg, state)
    if reason is not None:
        raise NotImplementedError(f"plant_step on {state.xi.device}: "
                                  f"{reason}")
    B = state.xi.shape[0]
    dtype, device = state.xi.dtype, state.xi.device
    vd = (constant(tuple(cfg.desired_velocity), dtype, device)
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
    plan = tfc.prepare_tick_launch(
        state.xi, state.q, state.foot_l, state.foot_r, state.qp_z,
        state.qp_lam, anc.contiguous(), it.contiguous(), vd.contiguous(), wd,
        cfg=cfg, **kf_args,
        grf_held=None if grf_override is None else grf_override.contiguous())
    plan.launch()
    (xi, q, fl, fr, z, y, anc_n, res, grf, tgt, *kf_out) = plan.results
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
                     mpc_every: int, v_des_schedule=None):
    B = state0.xi.shape[0]
    dtype, device = state0.xi.dtype, state0.xi.device
    if mpc_every < 1 or steps % mpc_every != 0:
        raise ValueError(f"steps={steps} must be a multiple of "
                         f"mpc_every={mpc_every} >= 1")
    if v_des_schedule is not None:
        # the JAX rollout reads a schedule only when every tick solves and
        # drops it silently otherwise: the port refuses instead
        if mpc_every != 1:
            raise ValueError("v_des_schedule needs mpc_every=1 (got "
                             f"mpc_every={mpc_every})")
        v_des_schedule = torch.as_tensor(v_des_schedule, dtype=dtype,
                                         device=device)
        if tuple(v_des_schedule.shape) != (steps, 3):
            raise ValueError(f"v_des_schedule: shape "
                             f"{tuple(v_des_schedule.shape)}, expected "
                             f"({steps}, 3)")
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
        vd = (vd_cfg if v_des_schedule is None
              else v_des_schedule[t].expand(B, 3).contiguous())
        s, m = plant_step(cfg, s, its[t], grf_override=hold, v_des=vd)
        if mpc_every > 1 and t % mpc_every == 0:
            grf = m["grf"]
        for k in keys:
            metrics[k][:, t] = m[k]
    return s, metrics


def rollout(cfg: ControllerConfig, state0: PlantState, steps: int,
            start_iteration=0, mpc_every: int = 1, v_des_schedule=None):
    """Closed-loop simulation of ONE scenario (unbatched state, e.g. from
    ``initial_plant_state(cfg)``); returns (final, metrics) with metrics
    stacked over time on axis 0. ``mpc_every`` > 1 reproduces the
    reference's dtMPC schedule: the MPC is re-solved every `mpc_every`
    ticks (mpcStep = 5, include/MPCParam.h:46-47) and the force held in
    between, while gait, swing tracking and the plant run every tick.
    ``v_des_schedule`` [steps, 3]: the velocity command of each tick in
    place of the configured one (ramp, cruise, stop); it needs
    ``mpc_every=1`` (ValueError otherwise)."""
    s0 = _map_state(state0, lambda x: x[None])
    final, metrics = _rollout_batched(cfg, s0, steps, start_iteration,
                                      mpc_every, v_des_schedule)
    return _unbatch(final), {k: v[0] for k, v in metrics.items()}


def batched_rollout(cfg: ControllerConfig, state0: PlantState, steps: int,
                    start_iteration=0, mpc_every: int = 1):
    """Closed loop over a batch (state0 fields [B, ...]); start_iteration
    a scalar or a [B] tensor (staggered gait phases). Returns (final,
    metrics) with metrics[k] [B, steps, ...]."""
    return _rollout_batched(cfg, state0, steps, start_iteration, mpc_every)


def batched_rollout_resident(cfg: ControllerConfig, state0: PlantState,
                             steps: int, start_iteration=0):
    """The closed loop over the whole-tick kernel with the state resident
    in two preallocated buffers (JAX ``batched_rollout_resident``,
    rollout.py:566-685, which carries the kernel's batch-last layout
    through one ``lax.scan``).

    Takes what the tick kernels implement (``tick_route``'s "kernel"
    path: walk or stand, truth or KF odometry, solve_form "subst" or
    "inv"; ValueError otherwise), every tick solving. State buffers A and B alternate as the
    kernel's input and output; the iteration, the tick index and the
    metrics (``[B, steps, ...]``, JAX's keys, ``est_error`` zero with
    truth odometry) are written on the device. On the card the first tick
    is one launch, each following pair of ticks (B -> A -> B) one replay
    of a CUDA graph that holds the two launches and their metric writes,
    and an even ``steps`` ends with one more launch: equal bit for bit to
    ``batched_rollout(mpc_every=1)``, which launches the same kernel on
    the same inputs. CPU tensors run the same loop over the tick's plain
    version (the CPU branch of ``tick_fused_cuda.fused_walking_tick``),
    with no graph. Returns (final, metrics) as batched_rollout.
    """
    from mpc_limx_control_tpu_torch.ops import graphs

    reason = tfc.kernel_refusal(cfg)
    if reason is not None:
        raise ValueError("batched_rollout_resident runs the tick kernels, "
                         f"which do not implement this config: {reason}")
    est_kf = cfg.estimator_mode == "kf"
    if (state0.kf is not None) != est_kf:
        raise ValueError(f"estimator_mode={cfg.estimator_mode!r} needs a "
                         f"state {'with' if est_kf else 'without'} kf")
    B = state0.xi.shape[0]
    dtype, device = state0.xi.dtype, state0.xi.device
    anc0 = (state0.ref_anchor if state0.ref_anchor is not None
            else torch.cat([state0.xi[:, 3:5], state0.xi[:, 2:3]], -1))
    fields = [state0.xi, state0.q, state0.foot_l, state0.foot_r,
              state0.qp_z, state0.qp_lam, anc0]
    if est_kf:
        fields += [state0.kf.x_hat, state0.kf.p_cov, state0.prev_v,
                   state0.prev_q]
    # each side: the carried state, then the kernel's residual, force and
    # target outputs
    cmd = [(B,), (B, 6), (B, 3)]
    bufs = tuple(
        [t.contiguous().clone() if i == 0 else torch.empty_like(t)
         for t in fields]
        + [torch.empty(sh, dtype=dtype, device=device) for sh in cmd]
        for i in (0, 1))
    n_state = len(fields)
    start = torch.as_tensor(start_iteration, dtype=dtype,
                            device=device).expand(B).clone()
    it = torch.empty_like(start)
    t_idx = torch.zeros((1,), dtype=torch.long, device=device)
    vd = constant(tuple(cfg.desired_velocity), dtype,
                  device).expand(B, 3).contiguous()
    wd = torch.full((B,), float(cfg.desired_yaw_rate), dtype=dtype,
                    device=device)
    keys = METRIC_KEYS + (KF_METRIC_KEYS if est_kf else ())
    widths = [_METRIC_WIDTH[k][0] if _METRIC_WIDTH[k] else 1 for k in keys]
    packed = torch.empty((B, steps, sum(widths)), dtype=dtype,
                         device=device)
    # a tick's metric row and its parts, written in place: the captured
    # ticks allocate nothing, so a graph's private pool stays empty
    row_buf = torch.empty((B, sum(widths)), dtype=dtype, device=device)
    est_err = torch.zeros((B,), dtype=dtype, device=device)
    est_diff = torch.empty((B, 3), dtype=dtype, device=device)
    cuda = device.type == "cuda"

    def inputs(src):
        kf = dict(zip(("kf_x", "kf_p", "prev_v", "prev_q"), src[7:n_state]))
        return src[:7] + [it, vd, wd], kf

    def outputs(dst):
        """The kernel's outputs in its order (state, then residual, force,
        target, then the filter)."""
        return dst[:7] + dst[n_state:] + (dst[7:9] if est_kf else [])

    # on the card, the launches A -> B and B -> A, written in place
    plans = {}
    if cuda:
        for i in (0, 1):
            args, kw = inputs(bufs[i])
            plans[i] = tfc.prepare_tick_launch(*args, **kw, cfg=cfg,
                                               out=outputs(bufs[1 - i]))

    def tick(i):
        """One tick from side i into side 1 - i, its metrics written at
        the tick index, then the index advanced."""
        src, dst = bufs[i], bufs[1 - i]
        torch.add(start, t_idx, out=it)
        if cuda:
            plans[i].launch()
        else:
            args, kw = inputs(src)
            for d, o in zip(outputs(dst),
                            tfc.fused_walking_tick(*args, **kw, cfg=cfg)):
                d.copy_(o)
        xi, (res, grf, tgt) = dst[0], dst[n_state:]
        if est_kf:
            torch.sub(dst[7][:, 0:3], src[0][:, 3:6], out=est_diff)
            torch.linalg.vector_norm(est_diff, dim=-1, out=est_err)
            cov = torch.diagonal(dst[8], dim1=-2, dim2=-1)
        row = [est_err[:, None], xi[:, 5:6], xi[:, 9:12], grf, res[:, None],
               tgt] + ([cov[:, 0:3], cov[:, 3:6]] if est_kf else [])
        torch.cat(row, -1, out=row_buf)
        packed.index_copy_(1, t_idx, row_buf[:, None])
        if est_kf:
            # the filter's input was the pre-step truth (plant_step)
            dst[9].copy_(src[0][:, 9:12])
            dst[10].copy_(src[1])
        t_idx.add_(1)

    if steps > 0:
        tick(0)
    pairs = (steps - 1) // 2
    if pairs > 0 and cuda:
        graph = graphs.Graph(lambda: (tick(1), tick(0)),
                             name="batched_rollout_resident", device=device)
        for _ in range(pairs):
            graph.replay()
    else:
        for _ in range(pairs):
            tick(1)
            tick(0)
    if steps > 1 and steps % 2 == 0:
        tick(1)
    fin = bufs[steps % 2]
    final = PlantState(
        xi=fin[0], q=fin[1], foot_l=fin[2], foot_r=fin[3], qp_z=fin[4],
        qp_lam=fin[5],
        ref_anchor=fin[6] if state0.ref_anchor is not None else None,
        kf=KFState(x_hat=fin[7], p_cov=fin[8]) if est_kf else None,
        prev_v=fin[9] if est_kf else None, prev_q=fin[10] if est_kf else None)
    cols = torch.split(packed, widths, -1)
    metrics = {k: (c[..., 0] if not _METRIC_WIDTH[k] else c).contiguous()
               for k, c in zip(keys, cols)}
    return final, metrics


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
