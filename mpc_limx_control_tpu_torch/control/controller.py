"""The TRON1 controller tick: gait -> placement -> swing IK ->
stance-force MPC -> joint command, walking or standing.

Counterpart of ``mpc_limx_control_tpu.control.controller`` (reference
MPC::run, include/MPCController.h:183-196, with the empty
computeSupportFootForce filled by the SRBD GRF MPC). Batch-first: every
tensor carries a leading scenario dimension B.

The walking GRF QP is single-support (one 3-vector GRF per horizon step,
nz = 3N) with the friction cone per step; its warm ``admm_fused`` solve runs
the ``walking_mpc_prep`` CUDA kernel for CUDA tensors. The standing QP has
both feet's GRF per step (nu = 6, nz = 6N, :func:`stance_mpc`); its warm
solve runs the generic ``fused_qp`` kernel (ops/mpc_fused_cuda.py). Every
other solver choice (cold or warm PDIP, cold or warm dense ADMM --
``ControllerConfig()`` itself is a cold 20-step PDIP) condenses the QP with
``ops.condense`` and solves it with ``ops.qp``, whose factorizations and
solves are the ``ops/chol_cuda.py`` kernels on CUDA tensors; the warm
``"riccati"`` walking solve is the sparse-form ADMM of ``ops.riccati``
(plain torch). The swing IK is ``cfg.ik_method``: the closed form, or the
reference's iterative damped-LS or log6 loops (``models.kinematics``).
"""

from __future__ import annotations

import torch

from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import (JointState, OdomState,
                                                   RobotCmd, TickDiagnostics,
                                                   constant)
from mpc_limx_control_tpu_torch.control import gait as gaitmod
from mpc_limx_control_tpu_torch.models import kinematics as kin
from mpc_limx_control_tpu_torch.models import srbd
from mpc_limx_control_tpu_torch.ops import chol_cuda
from mpc_limx_control_tpu_torch.ops import condense as cnd
from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as fqp
from mpc_limx_control_tpu_torch.ops import qp as qps
from mpc_limx_control_tpu_torch.ops import riccati as ricmod
from mpc_limx_control_tpu_torch.utils import rotations as rot


IK_METHODS = ("analytic", "damped_ls", "log6")
SOLVER_METHODS = ("pdip", "admm", "admm_fused", "riccati")


def _check_config(cfg: ControllerConfig) -> None:
    """Refuse an unknown mode, IK or solver method instead of running
    something else."""
    if cfg.mode not in ("walk", "stand"):
        raise ValueError(f"mode must be 'walk' or 'stand', got {cfg.mode!r}")
    if cfg.ik_method not in IK_METHODS:
        raise ValueError(f"ik_method must be one of {IK_METHODS}, got "
                         f"{cfg.ik_method!r}")
    if cfg.srbd.solver.method not in SOLVER_METHODS:
        raise ValueError(f"solver method must be one of {SOLVER_METHODS}, "
                         f"got {cfg.srbd.solver.method!r}")


def card_refusal(cfg: ControllerConfig) -> str | None:
    """Why :func:`tick` cannot run the config on CUDA tensors (None: it
    can): an unknown value; a horizon past the fused MPC kernel its warm
    ADMM branch launches (``walking_mpc_prep`` for the level-attitude
    admm_fused walking QP, :func:`stance_mpc_single_support`;
    ``fused_qp_nu6`` for the admm / admm_fused standing QP,
    :func:`stance_mpc`); or, on every other branch but the warm Riccati
    walking ADMM (which launches none), a dense QP past the Cholesky
    kernels: each launches ``cholesky``, the largest in shared memory of
    the three K8 kernels a PDIP launches."""
    s, c = cfg.srbd.solver, cfg.srbd
    for field, value, known in (
            ("mode", cfg.mode, ("walk", "stand")),
            ("estimator_mode", cfg.estimator_mode, ("truth", "kf")),
            ("ik_method", cfg.ik_method, IK_METHODS),
            ("solver method", s.method, SOLVER_METHODS),
            ("placement_mode", cfg.placement_mode, ("capture", "reference"))):
        if value not in known:
            return f"{field}={value!r} is unknown"
    if s.solve_form not in fqp.KERNEL_SOLVE_FORMS:
        return (f"solve_form={s.solve_form!r} is unknown "
                f"(the kernels run {fqp.KERNEL_SOLVE_FORMS})")
    if c.attitude_ref not in ("level", "receding"):
        return f"attitude_ref={c.attitude_ref!r} is unknown"
    if c.horizon < 1:
        return f"horizon={c.horizon} is not a horizon"
    stand = cfg.mode == "stand"
    if cfg.qp_warm_start:
        if stand and s.method in ("admm", "admm_fused"):
            return fqp.size_reason("fused_qp_nu6", c.horizon)
        if not stand and s.method == "admm_fused" \
                and c.attitude_ref == "level":
            return fqp.size_reason("walking_mpc_prep", c.horizon)
        if not stand and s.method == "riccati":
            return None
    n = c.horizon * (6 if stand else 3)
    reason = chol_cuda.size_reason("cholesky", n, 1)
    if reason is None:
        return None
    return (f"horizon={c.horizon}: the dense QP (n = {n}) is past "
            f"the Cholesky kernels' reach ({reason})")


def _cone_rows(cfg: ControllerConfig, dtype, device):
    """Static friction-cone matrix for two feet over the horizon:
    G [12N, 6N]. The bound vector is schedule-dependent
    (:func:`_cone_bounds`)."""
    c = cfg.srbd
    Gu1 = constant(tuple(map(tuple, fqp.cone_constants(c)["Gu"])), dtype,
                   device)
    return torch.kron(torch.eye(c.horizon, dtype=dtype, device=device),
                      torch.block_diag(Gu1, Gu1))


def _cone_bounds(cfg: ControllerConfig, on_l: torch.Tensor,
                 on_r: torch.Tensor):
    """h [B,12N]: fz in [fz_min, fz_max] for stance feet, fz = 0 for swing
    feet (which with the cone rows forces the whole GRF to zero).
    on_l / on_r [B,N] in {0,1}."""
    c = cfg.srbd

    def foot_h(on):
        zeros4 = torch.zeros((*on.shape, 4), dtype=on.dtype,
                             device=on.device)
        return torch.cat([zeros4, on[..., None] * c.fz_max,
                          -on[..., None] * c.fz_min], -1)     # [B,N,6]

    h = torch.cat([foot_h(on_l), foot_h(on_r)], -1)           # [B,N,12]
    return h.reshape(h.shape[0], -1)


def _weights(c, feet: int, dtype, device):
    q = constant(tuple(c.q_diag), dtype, device)
    r = constant(tuple(c.r_diag) * feet, dtype, device)
    return torch.diag(q), torch.diag(r), torch.diag(c.p_scale * q)


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def _mtv(R, v):
    return (R.transpose(-1, -2) @ v[..., None])[..., 0]


def stance_mpc(cfg: ControllerConfig, odom: OdomState,
               arm_l: torch.Tensor, arm_r: torch.Tensor,
               on_l: torch.Tensor, on_r: torch.Tensor, v_des: torch.Tensor,
               yaw_rate_des: torch.Tensor,
               pos_anchor: torch.Tensor | None = None, qp_warm=None,
               solve_form: str | None = None):
    """Two-foot SRBD GRF MPC (standing / double support: nu = 6 with
    schedule gating).

    arm_l/arm_r [B,3]: the world position each foot pushes from; on_l/on_r
    [B,N] in {0,1}: stance schedule per foot over the horizon; v_des [B,3];
    yaw_rate_des [B]; pos_anchor [B,3]: origin of the position reference
    (None = the measured position); qp_warm = (z [B,6N], y [B,12N]).
    Returns (grf [B,6] world forces (L,R), residual [B], xi_pred [B,13],
    qp_state).

    Solver: with warm state and method "admm" / "admm_fused", the warm
    two-foot QP of make_admm_fused (``solve_form`` None: the ``fused_qp``
    kernel on CUDA tensors); its cone bounds are the full-stance
    constants, right for the standing schedule (on_l = on_r = 1), the only
    one this path is used with. Otherwise the cold fixed-iteration PDIP on
    the condensed QP with schedule-gated bounds (qp_state None).
    """
    c = cfg.srbd
    N = c.horizon
    xi0 = srbd.initial_state(odom.ori, odom.pos, odom.v_ori, odom.v_pos)
    # per-foot linearization at the operating point (the moment arms are
    # constant over the horizon; the schedule gates which columns act)
    arms2 = torch.stack([arm_l, arm_r], -2)                   # [B,2,3]
    Ac, Bc2 = srbd.linearize_shared(cfg.robot, arms2, odom.pos,
                                    odom.ori[:, 2])
    Bc = torch.cat([Bc2[:, 0], Bc2[:, 1]], -1)                # [B,13,6]
    Ad, Bd = srbd.discretize_srbd(Ac, Bc, c.ts)
    gate = torch.cat([on_l[..., None].expand(-1, -1, 3),
                      on_r[..., None].expand(-1, -1, 3)], -1)  # [B,N,6]
    Bd_t = Bd[:, None] * gate[:, :, None, :].to(Bd.dtype)     # [B,N,13,6]
    x_ref = srbd.walking_reference(
        xi0, c, N, v_des, yaw_rate_des,
        height_des=cfg.ground_height + cfg.base_height,
        pos_anchor=pos_anchor)
    if c.solver.method in ("admm", "admm_fused") and qp_warm is not None:
        solver = fqp.make_admm_fused(c, two_feet=True, solve_form=solve_form)
        sol, qp_state = solver(Ad, Bd_t, x_ref, xi0, qp_warm[0], qp_warm[1])
        grf = sol.u[:, :6]
        xi_pred = _mv(Ad, xi0) + _mv(Bd_t[:, 0], grf)
        return grf, sol.residual, xi_pred, qp_state

    dtype, device = xi0.dtype, xi0.device
    Q, R, P = _weights(c, 2, dtype, device)
    on_l, on_r = on_l.to(dtype), on_r.to(dtype)
    qp = cnd.condense(Ad, Bd_t, Q, R, P, N, xi0, x_ref,
                      extra_G=_cone_rows(cfg, dtype, device),
                      extra_h=_cone_bounds(cfg, on_l, on_r))
    sol = qps.make_pdip(iters=c.solver.iters)(qp.H, qp.f, qp.G, qp.h)
    grf = sol.u[:, :6]
    xi_pred = _mv(qp.A_blocks[:, 1], xi0) + _mv(qp.B_blocks[:, 1, 0], grf)
    return grf, sol.residual, xi_pred, None


def stance_mpc_single_support(cfg: ControllerConfig, odom: OdomState,
                              arm_l: torch.Tensor, arm_r: torch.Tensor,
                              left_stance: torch.Tensor,
                              v_des: torch.Tensor,
                              yaw_rate_des: torch.Tensor, qp_warm=None,
                              pos_anchor: torch.Tensor | None = None,
                              solve_form: str | None = None):
    """Walking-gait GRF MPC: one stance foot per horizon step.

    arm_l/arm_r [B,3] world positions each foot pushes from; left_stance
    [B,N] bool; v_des [B,3]; yaw_rate_des [B]; qp_warm = (z [B,3N],
    y [B,6N]); pos_anchor [B,3] = the clipped (x, y, yaw) tracking anchor
    or None (receding reference). Returns (grf [B,6] (L,R) with the swing
    foot's force zero, residual [B], xi_pred [B,13], qp_state).

    Solver, by ``cfg.srbd.solver.method`` and the warm state: warm
    "admm_fused" is the prep-fused walking QP of make_walking_fused
    (``solve_form`` None: the kernel on CUDA tensors); warm "riccati" the
    sparse-form ADMM of ops.riccati on the same linearization. Every other
    choice condenses the QP and solves it with ops.qp: "admm" (and a cold
    "admm_fused") the dense ADMM -- cold from zeros with max(50, iters)
    iterations, warm with admm_warm_iters --, "pdip" (and a cold
    "riccati") the cold (solver.iters) or the warm (solver.warm_iters)
    interior point.
    """
    c = cfg.srbd
    xi0 = srbd.initial_state(odom.ori, odom.pos, odom.v_ori, odom.v_pos)
    on_l = left_stance.to(odom.pos.dtype)
    arms = torch.where(on_l[..., None] > 0.5, arm_l[:, None, :],
                       arm_r[:, None, :])                     # [B,N,3]
    if pos_anchor is None:
        anchor_xy, yaw_anchor = odom.pos[:, :2], None
    else:
        anchor_xy, yaw_anchor = pos_anchor[:, :2], pos_anchor[:, 2]

    if c.solver.method == "admm_fused" and qp_warm is not None:
        # prep-fused path: linearization, exact ZOH, reference,
        # condensation, Cholesky and the warm ADMM in one kernel on CUDA
        # tensors
        solver = fqp.make_walking_fused(cfg, solve_form=solve_form)
        anchor3 = torch.cat(
            [anchor_xy, odom.ori[:, 2:3] if yaw_anchor is None
             else yaw_anchor[:, None]], -1)
        sol, xi_pred, qp_state = solver(arms, xi0, v_des, yaw_rate_des,
                                        qp_warm[0], qp_warm[1], anchor3)
    else:
        _check_config(cfg)
        # shared-yaw linearization + exact ZOH: Ad is step-invariant, only
        # Bd varies over the horizon
        N = c.horizon
        dtype, device = xi0.dtype, xi0.device
        Ac, Bc_t = srbd.linearize_shared(cfg.robot, arms, odom.pos,
                                         odom.ori[:, 2])
        Ad, Bd_t = srbd.discretize_srbd(Ac, Bc_t, c.ts)
        anchor3 = torch.cat([anchor_xy, torch.zeros_like(anchor_xy[:, :1])],
                            -1)
        x_ref = srbd.walking_reference(
            xi0, c, N, v_des, yaw_rate_des,
            height_des=cfg.ground_height + cfg.base_height,
            pos_anchor=anchor3, yaw_anchor=yaw_anchor)
        s = c.solver
        if s.method == "riccati" and qp_warm is not None:
            # the warm ADMM with Riccati-factorized x-updates on the sparse
            # form; a cold start falls through to the cold PDIP below, as
            # the JAX code does (controller.py:251-303)
            sol, qp_state = ricmod.make_admm_riccati(c)(
                Ad, Bd_t, x_ref, xi0, qp_warm[0], qp_warm[1])
            xi_pred = _mv(Ad, xi0) + _mv(Bd_t[:, 0], sol.u[:, :3])
        else:
            Q, R, P = _weights(c, 1, dtype, device)
            G, h = srbd.friction_cone_rows(c, N, dtype, device)
            qp = cnd.condense(Ad, Bd_t, Q, R, P, N, xi0, x_ref, extra_G=G,
                              extra_h=h)
            if s.method in ("admm", "admm_fused"):
                if qp_warm is None:
                    z0, y0 = torch.zeros_like(qp.f), torch.zeros_like(qp.h)
                    iters = max(50, s.iters)
                else:
                    (z0, y0), iters = qp_warm, s.admm_warm_iters
                sol, qp_state = qps.make_admm_warm(
                    iters=iters, rho=s.admm_rho, alpha=s.admm_alpha)(
                        qp.H, qp.f, qp.G, qp.h, z0, y0)
            elif qp_warm is None:
                sol = qps.make_pdip(iters=s.iters)(qp.H, qp.f, qp.G, qp.h)
                qp_state = (sol.u, torch.ones_like(qp.h))
            else:
                sol, qp_state = qps.make_pdip_warm(iters=s.warm_iters)(
                    qp.H, qp.f, qp.G, qp.h, qp_warm[0], qp_warm[1])
            xi_pred = (_mv(qp.A_blocks[:, 1], xi0)
                       + _mv(qp.B_blocks[:, 1, 0], sol.u[:, :3]))
    u0 = sol.u[:, :3]
    zeros3 = torch.zeros_like(u0)
    left_now = on_l[:, 0:1] > 0.5
    grf = torch.where(left_now, torch.cat([u0, zeros3], -1),
                      torch.cat([zeros3, u0], -1))
    return grf, sol.residual, xi_pred, qp_state


def tick(cfg: ControllerConfig, odom: OdomState, joints: JointState,
         iteration: torch.Tensor, grf_override: torch.Tensor | None = None,
         qp_warm=None, v_des: torch.Tensor | None = None,
         yaw_rate_des: torch.Tensor | None = None,
         ref_anchor: torch.Tensor | None = None,
         solve_form: str | None = None):
    """One 1 kHz control tick for a batch of scenarios.

    odom/joints batch-first [B, ...]; iteration [B] (any float dtype is
    cast to the state dtype). ``grf_override`` [B,6] skips the MPC solve
    and holds the given force (the dtMPC hold tick,
    include/MPCParam.h:46-47): walking, on the foot now in stance;
    standing, the force pair as given. Returns (RobotCmd,
    TickDiagnostics).
    """
    _check_config(cfg)
    stand = cfg.mode == "stand"
    dtype, device = odom.pos.dtype, odom.pos.device
    B = odom.pos.shape[0]
    iteration = torch.as_tensor(iteration, dtype=dtype,
                                device=device).expand(B)
    # the configured commands are made once per device (types.constant)
    if v_des is None:
        v_des = constant(tuple(cfg.desired_velocity), dtype, device)
    v_des = torch.as_tensor(v_des, dtype=dtype, device=device).expand(B, 3)
    if yaw_rate_des is None:
        yaw_rate_des = constant(float(cfg.desired_yaw_rate), dtype, device)
    yaw_rate_des = torch.as_tensor(yaw_rate_des, dtype=dtype,
                                   device=device).expand(B)

    gait = gaitmod.gait_clock(cfg.gait, iteration)
    target_w = gaitmod.foot_placement(cfg, gait, odom.pos, v_des,
                                      v_actual=odom.v_pos)

    # ---- reference anchor (pose tracking with anti-windup) ------------
    band, yband = cfg.ref_anchor_band, cfg.yaw_anchor_band
    dt = cfg.gait.dt
    if ref_anchor is not None and band > 0.0:
        yaw_now = odom.ori[:, 2:3]
        anchor_used = torch.cat([
            torch.clamp(ref_anchor[:, :2], odom.pos[:, :2] - band,
                        odom.pos[:, :2] + band),
            torch.clamp(ref_anchor[:, 2:3], yaw_now - yband,
                        yaw_now + yband)], -1)
        anchor_next = anchor_used + torch.cat(
            [v_des[:, :2], yaw_rate_des[:, None]], -1) * dt
        if cfg.anchor_placement_gain > 0.0:
            # integral action on the velocity error through the placement
            target_w = torch.cat([
                target_w[:, :2] + cfg.anchor_placement_gain
                * (odom.pos[:, :2] - anchor_used[:, :2]),
                target_w[:, 2:]], -1)
    else:
        anchor_used = None
        anchor_next = (torch.cat(
            [odom.pos[:, :2] + v_des[:, :2] * dt,
             odom.ori[:, 2:3] + yaw_rate_des[:, None] * dt], -1)
            if ref_anchor is not None else None)

    # world-frame foot positions from FK + base pose
    R_wb = rot.quat_to_rot(odom.quat)
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype, device)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype, device)
    p_l_w = odom.pos + _mv(R_wb, kin.forward_kinematics(gl, joints.q[:, :3]))
    p_r_w = odom.pos + _mv(R_wb, kin.forward_kinematics(gr, joints.q[:, 3:]))

    # ---- swing leg: trajectory + IK (cfg.ik_method) -------------------
    ls = gait.left_swing
    foot_now_w = torch.where(ls[:, None], p_l_w, p_r_w)
    next_w = gaitmod.swing_trajectory(cfg.gait, gait, foot_now_w, target_w,
                                      ground_height=cfg.ground_height)
    next_b = _mtv(R_wb, next_w - odom.pos)
    g_sw = kin.select_geometry(ls, gl, gr)
    q_guess = torch.where(ls[:, None], joints.q[:, :3], joints.q[:, 3:])
    if cfg.ik_method == "analytic":
        swing_q = kin.inverse_kinematics_analytic(g_sw, next_b, q_guess)
    elif cfg.ik_method == "log6":
        # the reference's literal pinocchio loop: 6-DoF log6 error with an
        # identity target orientation (pinocchio_kinematics.h:61-149)
        swing_q = kin.inverse_kinematics_log6(
            g_sw, next_b, q_guess, iters=cfg.ik_iters, damp=cfg.ik_damp,
            dt=cfg.ik_dt)
    else:
        swing_q = kin.inverse_kinematics_damped_ls(
            g_sw, next_b, q_guess, iters=cfg.ik_iters, damp=cfg.ik_damp)

    # ---- stance leg(s): SRBD GRF MPC ----------------------------------
    if stand:
        if grf_override is None:
            # both feet push from where they are, for the whole horizon;
            # the MPC holds the COM over the support midpoint
            ones = torch.ones((B, cfg.srbd.horizon), dtype=dtype,
                              device=device)
            mid = 0.5 * (p_l_w + p_r_w)
            pos_anchor = torch.cat([mid[:, :2], torch.full_like(
                mid[:, 2:], cfg.ground_height + cfg.base_height)], -1)
            grf, residual, xi_pred, qp_state = stance_mpc(
                cfg, odom, p_l_w, p_r_w, ones, ones, v_des, yaw_rate_des,
                pos_anchor=pos_anchor, qp_warm=qp_warm,
                solve_form=solve_form)
            if qp_state is None:       # the cold solve threads no state
                qp_state = qp_warm
        else:
            grf = grf_override
    else:
        on_l = gaitmod.contact_schedule(cfg.gait, iteration,
                                        cfg.srbd.horizon, cfg.srbd.ts)
        if grf_override is None:
            # a standing foot pushes from where it is; the swinging foot
            # re-enters stance (within the horizon) at its placement target
            arm_l = torch.where(ls[:, None], target_w, p_l_w)
            arm_r = torch.where(ls[:, None], p_r_w, target_w)
            grf, residual, xi_pred, qp_state = stance_mpc_single_support(
                cfg, odom, arm_l, arm_r, on_l, v_des, yaw_rate_des,
                qp_warm=qp_warm, pos_anchor=anchor_used,
                solve_form=solve_form)
        else:
            # held-force tick: the held force belongs to the foot now in
            # stance
            f_any = grf_override[:, :3] + grf_override[:, 3:]
            zeros3 = torch.zeros_like(f_any)
            grf = torch.where(on_l[:, 0:1], torch.cat([f_any, zeros3], -1),
                              torch.cat([zeros3, f_any], -1))
    if grf_override is not None:
        residual = torch.zeros_like(odom.pos[:, 0])
        xi_pred = srbd.initial_state(odom.ori, odom.pos, odom.v_ori,
                                     odom.v_pos)
        qp_state = qp_warm

    # ---- pack the command: stance torque tau = J^T (-R^T f) -----------
    if stand:
        tau_l = -_mtv(kin.contact_jacobian(gl, joints.q[:, :3]),
                      _mtv(R_wb, grf[:, :3]))
        tau_r = -_mtv(kin.contact_jacobian(gr, joints.q[:, 3:]),
                      _mtv(R_wb, grf[:, 3:]))
        q_cmd = joints.q
        tau_cmd = torch.cat([tau_l, tau_r], -1)
        kp = torch.zeros((B, 6), dtype=dtype, device=device)
    else:
        g_st = kin.select_geometry(ls, gr, gl)
        q_st = torch.where(ls[:, None], joints.q[:, 3:], joints.q[:, :3])
        f_st_w = torch.where(ls[:, None], grf[:, 3:], grf[:, :3])
        f_st_b = _mtv(R_wb, f_st_w)
        J_st = kin.contact_jacobian(g_st, q_st)
        tau_st = -_mtv(J_st, f_st_b)
        zeros3t = torch.zeros_like(tau_st)
        q_cmd = torch.where(ls[:, None],
                            torch.cat([swing_q, joints.q[:, 3:]], -1),
                            torch.cat([joints.q[:, :3], swing_q], -1))
        tau_cmd = torch.where(ls[:, None], torch.cat([zeros3t, tau_st], -1),
                              torch.cat([tau_st, zeros3t], -1))
        left_gain = constant((1.0, 1.0, 1.0, 0.0, 0.0, 0.0), dtype, device)
        kp = cfg.kp * torch.where(ls[:, None], left_gain, 1.0 - left_gain)
    cmd = RobotCmd(mode=torch.zeros((B, 6), dtype=torch.int32,
                                    device=device),
                   q=q_cmd, dq=torch.zeros_like(q_cmd), tau=tau_cmd, kp=kp,
                   kd=torch.full_like(kp, cfg.kd))
    diag = TickDiagnostics(gait=gait, grf=grf, qp_residual=residual,
                           foot_target=target_w, swing_q=swing_q,
                           predicted_xi=xi_pred, qp_state=qp_state,
                           ref_anchor=anchor_next)
    return cmd, diag

