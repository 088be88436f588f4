"""The plain tick of the walking and standing controller and its plant.

A trimmed copy of the port's plain composition (``controller.tick``,
``rollout._plant_step_ref``, ``mpc_fused_cuda.walking_qp_prep_plain`` /
``fused_qp_plain`` and ``qp._batched_admm``) for what the benchmark runs:
truth odometry, the warm fused ADMM (``admm_fused``, ``solve_form``
"subst": exact forward and backward triangular solves against one
Cholesky factor, as the tick kernels run it), the analytic IK, the
reference anchor walking. It runs in any dtype on any device; the
benchmark runs it in float64.

The gait clock and the contact schedule are computed in float32 from a
float32 iteration, as the program computes them: their comparisons with
the swing time decide which foot is in stance, and a tick whose time lies
on a phase boundary would otherwise be decided by the precision. Their
continuous outputs are cast to the working dtype.

The kernels add ``REG`` = 1e-6 to the diagonal of K = H + rho G'G; the
reference adds the same, in every dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import condense as cnd
from portbench.reference import gait as gaitmod
from portbench.reference import kinematics as kin
from portbench.reference import rotations as rot
from portbench.reference import srbd
from portbench.reference.config import ControllerConfig
from portbench.reference.types import GaitState, OdomState

REG = 1e-6
METRIC_KEYS = ("height", "velocity", "grf", "qp_residual", "foot_target")
STATE_FIELDS = ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam",
                "ref_anchor")


@dataclasses.dataclass(frozen=True)
class State:
    """Batched plant and controller carry, each field [B, ...]: the SRBD
    state xi [B,13], joints q [B,6], feet [B,3] (world), the QP warm state
    qp_z [B,n] / qp_lam [B,2n], and walking the anchor (x, y, yaw) [B,3]
    (None standing)."""

    xi: torch.Tensor
    q: torch.Tensor
    foot_l: torch.Tensor
    foot_r: torch.Tensor
    qp_z: torch.Tensor
    qp_lam: torch.Tensor
    ref_anchor: torch.Tensor | None = None

    def map(self, fn) -> "State":
        return State(**{k: (None if getattr(self, k) is None
                            else fn(getattr(self, k)))
                        for k in STATE_FIELDS})


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def _mtv(R, v):
    return (R.transpose(-1, -2) @ v[..., None])[..., 0]


def initial_state(cfg: ControllerConfig, B: int, dtype=torch.float64,
                  device="cpu") -> State:
    """Standing at the configured base height, feet at their nominal
    offsets on the ground, joints from IK, the warm state zero."""
    pos = torch.zeros((B, 3), dtype=dtype, device=device)
    pos[:, 2] = cfg.ground_height + cfg.base_height
    xi = torch.zeros((B, 13), dtype=dtype, device=device)
    xi[:, 3:6] = pos
    xi[:, 12] = -9.81
    off_l = torch.tensor(cfg.robot.nominal_foot_offset_left, dtype=dtype,
                         device=device)
    off_r = torch.tensor(cfg.robot.nominal_foot_offset_right, dtype=dtype,
                         device=device)
    foot_l, foot_r = pos + off_l, pos + off_r
    foot_l[:, 2] = cfg.ground_height
    foot_r[:, 2] = cfg.ground_height
    if cfg.mode == "stand":
        foot_l[:, 0] = pos[:, 0]
        foot_r[:, 0] = pos[:, 0]
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype, device)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype, device)
    zero3 = torch.zeros((B, 3), dtype=dtype, device=device)
    q = torch.cat([kin.inverse_kinematics_analytic(gl, foot_l - pos, zero3),
                   kin.inverse_kinematics_analytic(gr, foot_r - pos, zero3)],
                  -1)
    nu = 3 if cfg.mode == "walk" else 6
    n = nu * cfg.srbd.horizon
    anchor = (torch.cat([pos[:, :2], zero3[:, :1]], -1)
              if cfg.ref_anchor_band > 0.0 and cfg.mode == "walk" else None)
    return State(xi=xi, q=q, foot_l=foot_l, foot_r=foot_r,
                 qp_z=torch.zeros((B, n), dtype=dtype, device=device),
                 qp_lam=torch.zeros((B, 2 * n), dtype=dtype, device=device),
                 ref_anchor=anchor)


# ---- the gait clock, in float32 as the program decides it -----------------

def gait_clock(cfg: ControllerConfig, iteration: torch.Tensor,
               dtype) -> GaitState:
    g = gaitmod.gait_clock(cfg.gait, iteration.to(torch.float32))
    return GaitState(left_swing=g.left_swing, phase=g.phase.to(dtype),
                     remain_swing_time=g.remain_swing_time.to(dtype),
                     swing_progress=g.swing_progress.to(dtype))


def contact_schedule(cfg: ControllerConfig, iteration: torch.Tensor):
    return gaitmod.contact_schedule(cfg.gait, iteration.to(torch.float32),
                                    cfg.srbd.horizon, cfg.srbd.ts)


# ---- the warm ADMM, "subst" form --------------------------------------------

def admm_subst(H, f, G, h, z_warm, y_warm, iters: int, rho: float,
               alpha: float):
    """Over-relaxed warm ADMM on min 1/2 z'Hz + f'z s.t. Gz <= h with one
    Cholesky factor of K = H + rho G'G + REG I and exact triangular solves
    each iteration. Returns (z, y, residual) with the residual
    |Gz - v|_inf / (1 + |f|_inf)."""
    n = f.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    Gt = G.transpose(-1, -2)
    K = H + rho * (Gt @ G) + REG * eye
    L = torch.linalg.cholesky(K)
    Lt = L.transpose(-1, -2)

    def z_of(w):
        rhs = (-f + rho * _mv(Gt, w))[..., None]
        y1 = torch.linalg.solve_triangular(L, rhs, upper=False)
        return torch.linalg.solve_triangular(Lt, y1, upper=True)[..., 0]

    v = torch.minimum(_mv(G, z_warm), h)
    y = y_warm
    for _ in range(iters):
        z = z_of(v - y)
        gz = _mv(G, z)
        gz_relaxed = alpha * gz + (1.0 - alpha) * v
        v_new = torch.minimum(gz_relaxed + y, h)
        y = y + gz_relaxed - v_new
        v = v_new
    z = z_of(v - y)
    r_prim = torch.amax(torch.abs(_mv(G, z) - v), -1)
    residual = r_prim / (1.0 + torch.amax(torch.abs(f), -1))
    return z, y, residual


def _cone(cfg: ControllerConfig, feet: int, N: int, dtype, device):
    mu = float(cfg.srbd.friction_mu)
    Gu = torch.tensor(((1.0, 0.0, -mu), (-1.0, 0.0, -mu), (0.0, 1.0, -mu),
                       (0.0, -1.0, -mu), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0)),
                      dtype=dtype, device=device)
    hu = torch.tensor((0.0, 0.0, 0.0, 0.0, float(cfg.srbd.fz_max),
                       -float(cfg.srbd.fz_min)), dtype=dtype, device=device)
    G = torch.kron(torch.eye(feet * N, dtype=dtype, device=device), Gu)
    return G, hu.repeat(feet * N)


def _qp(cfg: ControllerConfig, Ad, Bd_t, x_ref, x0, z_warm, y_warm,
        feet: int):
    """Condense the stance-force QP and run the warm ADMM."""
    c = cfg.srbd
    N = c.horizon
    dtype, device = x0.dtype, x0.device

    def diag(v):
        return torch.diag(torch.tensor(v, dtype=dtype, device=device))

    q = tuple(float(v) for v in c.q_diag)
    p = tuple(float(c.p_scale) * float(v) for v in c.q_diag)
    r = tuple(float(v) for v in c.r_diag) * feet
    G, h = _cone(cfg, feet, N, dtype, device)
    qp = cnd.condense(Ad, Bd_t, diag(q), diag(r), diag(p), N, x0, x_ref,
                      extra_G=G, extra_h=h)
    s = c.solver
    return admm_subst(qp.H, qp.f, qp.G, qp.h, z_warm, y_warm,
                      int(s.admm_warm_iters), float(s.admm_rho),
                      float(s.admm_alpha))


def walking_qp(cfg, arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor):
    """The walking QP (one stance foot a horizon step, nu = 3): returns
    (z, y, residual)."""
    c = cfg.srbd
    Ac, Bc_t = srbd.linearize_shared(cfg.robot, arms, x0[:, 3:6], x0[:, 2])
    Ad, Bd_t = srbd.discretize_srbd(Ac, Bc_t, float(c.ts))
    anc3 = torch.cat([anchor[:, :2], torch.zeros_like(anchor[:, :1])], -1)
    x_ref = srbd.walking_reference(
        x0, c, c.horizon, v_des, yaw_rate,
        height_des=float(cfg.ground_height) + float(cfg.base_height),
        pos_anchor=anc3, yaw_anchor=anchor[:, 2])
    return _qp(cfg, Ad, Bd_t, x_ref, x0, z_warm, y_warm, 1)


def standing_qp(cfg, odom: OdomState, arm_l, arm_r, v_des, yaw_rate,
                pos_anchor, z_warm, y_warm):
    """The standing QP (both feet every horizon step, nu = 6): returns
    (z, y, residual)."""
    c = cfg.srbd
    N = c.horizon
    xi0 = srbd.initial_state(odom.ori, odom.pos, odom.v_ori, odom.v_pos)
    arms2 = torch.stack([arm_l, arm_r], -2)
    Ac, Bc2 = srbd.linearize_shared(cfg.robot, arms2, odom.pos,
                                    odom.ori[:, 2])
    Bc = torch.cat([Bc2[:, 0], Bc2[:, 1]], -1)
    Ad, Bd = srbd.discretize_srbd(Ac, Bc, float(c.ts))
    Bd_t = Bd[:, None].expand(-1, N, -1, -1)
    x_ref = srbd.walking_reference(
        xi0, c, N, v_des, yaw_rate,
        height_des=float(cfg.ground_height) + float(cfg.base_height),
        pos_anchor=pos_anchor)
    return _qp(cfg, Ad, Bd_t, x_ref, xi0, z_warm, y_warm, 2)


# ---- the controller tick ---------------------------------------------------

def controller_tick(cfg: ControllerConfig, odom: OdomState, q: torch.Tensor,
                    iteration: torch.Tensor, v_des: torch.Tensor,
                    yaw_rate_des: torch.Tensor, grf_override=None,
                    qp_warm=None, ref_anchor=None) -> dict:
    """One control tick: gait, placement, anchor, swing IK, the stance
    force (solved warm, or held), the joint command. Returns a dict with
    the command (q, dq, tau, kp, kd), grf, residual, foot_target,
    qp_state and the next anchor."""
    stand = cfg.mode == "stand"
    dtype, device = odom.pos.dtype, odom.pos.device
    B = odom.pos.shape[0]
    gait = gait_clock(cfg, iteration, dtype)
    target_w = gaitmod.foot_placement(cfg, gait, odom.pos, v_des,
                                      v_actual=odom.v_pos)
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
            target_w = torch.cat([
                target_w[:, :2] + cfg.anchor_placement_gain
                * (odom.pos[:, :2] - anchor_used[:, :2]),
                target_w[:, 2:]], -1)
    else:
        anchor_used = anchor_next = None

    R_wb = rot.quat_to_rot(odom.quat)
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype, device)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype, device)
    p_l_w = odom.pos + _mv(R_wb, kin.forward_kinematics(gl, q[:, :3]))
    p_r_w = odom.pos + _mv(R_wb, kin.forward_kinematics(gr, q[:, 3:]))

    ls = gait.left_swing
    foot_now_w = torch.where(ls[:, None], p_l_w, p_r_w)
    next_w = gaitmod.swing_trajectory(cfg.gait, gait, foot_now_w, target_w,
                                      ground_height=cfg.ground_height)
    next_b = _mtv(R_wb, next_w - odom.pos)
    g_sw = kin.select_geometry(ls, gl, gr)
    q_guess = torch.where(ls[:, None], q[:, :3], q[:, 3:])
    swing_q = kin.inverse_kinematics_analytic(g_sw, next_b, q_guess)

    qp_state = qp_warm
    residual = torch.zeros_like(odom.pos[:, 0])
    if stand:
        if grf_override is None:
            mid = 0.5 * (p_l_w + p_r_w)
            pos_anchor = torch.cat([mid[:, :2], torch.full_like(
                mid[:, 2:], cfg.ground_height + cfg.base_height)], -1)
            z, y, residual = standing_qp(cfg, odom, p_l_w, p_r_w, v_des,
                                         yaw_rate_des, pos_anchor,
                                         qp_warm[0], qp_warm[1])
            grf, qp_state = z[:, :6], (z, y)
        else:
            grf = grf_override
    else:
        on_l = contact_schedule(cfg, iteration)
        if grf_override is None:
            arm_l = torch.where(ls[:, None], target_w, p_l_w)
            arm_r = torch.where(ls[:, None], p_r_w, target_w)
            arms = torch.where(on_l[..., None], arm_l[:, None, :],
                               arm_r[:, None, :])
            xi0 = srbd.initial_state(odom.ori, odom.pos, odom.v_ori,
                                     odom.v_pos)
            anchor3 = (torch.cat([odom.pos[:, :2], odom.ori[:, 2:3]], -1)
                       if anchor_used is None else anchor_used)
            z, y, residual = walking_qp(cfg, arms, xi0, v_des, yaw_rate_des,
                                        qp_warm[0], qp_warm[1], anchor3)
            u0 = z[:, :3]
            zeros3 = torch.zeros_like(u0)
            grf = torch.where(on_l[:, 0:1], torch.cat([u0, zeros3], -1),
                              torch.cat([zeros3, u0], -1))
            qp_state = (z, y)
        else:
            f_any = grf_override[:, :3] + grf_override[:, 3:]
            zeros3 = torch.zeros_like(f_any)
            grf = torch.where(on_l[:, 0:1], torch.cat([f_any, zeros3], -1),
                              torch.cat([zeros3, f_any], -1))

    if stand:
        tau_l = -_mtv(kin.contact_jacobian(gl, q[:, :3]),
                      _mtv(R_wb, grf[:, :3]))
        tau_r = -_mtv(kin.contact_jacobian(gr, q[:, 3:]),
                      _mtv(R_wb, grf[:, 3:]))
        q_cmd = q
        tau_cmd = torch.cat([tau_l, tau_r], -1)
        kp = torch.zeros((B, 6), dtype=dtype, device=device)
    else:
        g_st = kin.select_geometry(ls, gr, gl)
        q_st = torch.where(ls[:, None], q[:, 3:], q[:, :3])
        f_st_w = torch.where(ls[:, None], grf[:, 3:], grf[:, :3])
        tau_st = -_mtv(kin.contact_jacobian(g_st, q_st), _mtv(R_wb, f_st_w))
        zeros3t = torch.zeros_like(tau_st)
        q_cmd = torch.where(ls[:, None], torch.cat([swing_q, q[:, 3:]], -1),
                            torch.cat([q[:, :3], swing_q], -1))
        tau_cmd = torch.where(ls[:, None], torch.cat([zeros3t, tau_st], -1),
                              torch.cat([tau_st, zeros3t], -1))
        left_gain = torch.tensor((1.0, 1.0, 1.0, 0.0, 0.0, 0.0), dtype=dtype,
                                 device=device)
        kp = cfg.kp * torch.where(ls[:, None], left_gain, 1.0 - left_gain)
    return dict(q=q_cmd, dq=torch.zeros_like(q_cmd), tau=tau_cmd, kp=kp,
                kd=torch.full_like(kp, cfg.kd), grf=grf, residual=residual,
                foot_target=target_w, swing_q=swing_q, qp_state=qp_state,
                anchor_next=anchor_next, left_swing=ls)


# ---- the plant -------------------------------------------------------------

def odom_from_xi(xi: torch.Tensor) -> OdomState:
    ori = xi[:, 0:3]
    return OdomState(pos=xi[:, 3:6], ori=ori, quat=rot.rpy_to_quat(ori),
                     v_pos=xi[:, 9:12], v_ori=xi[:, 6:9])


def plant_step(cfg: ControllerConfig, state: State, iteration: torch.Tensor,
               v_des: torch.Tensor, grf_override=None):
    """One 1 kHz tick of the batched closed loop: the controller on the
    plant truth, the SRBD stepped with the commanded force, the swing leg
    executing its command and the stance foot pinned (walking) or both
    feet pinned (standing). Returns (new state, metrics)."""
    dtype, device = state.xi.dtype, state.xi.device
    B = state.xi.shape[0]
    odom = odom_from_xi(state.xi)
    yaw_rate = torch.full((B,), float(cfg.desired_yaw_rate), dtype=dtype,
                          device=device)
    d = controller_tick(cfg, odom, state.q, iteration, v_des, yaw_rate,
                        grf_override=grf_override,
                        qp_warm=(state.qp_z, state.qp_lam),
                        ref_anchor=state.ref_anchor)
    stand = cfg.mode == "stand"
    ls = d["left_swing"]
    if stand:
        on_l = on_r = torch.ones((B,), dtype=dtype, device=device)
    else:
        on_l, on_r = 1.0 - ls.to(dtype), ls.to(dtype)
    feet = torch.stack([state.foot_l, state.foot_r], -2)
    forces = torch.stack([d["grf"][:, 0:3] * on_l[:, None],
                          d["grf"][:, 3:6] * on_r[:, None]], -2)
    xi_new = srbd.srbd_step_vector(cfg.robot, state.xi, feet, forces,
                                   cfg.gait.dt)
    base_new = xi_new[:, 3:6]
    R_new = rot.quat_to_rot(rot.rpy_to_quat(xi_new[:, 0:3]))
    gl = kin.leg_geometry(cfg.robot.legs, "left", dtype, device)
    gr = kin.leg_geometry(cfg.robot.legs, "right", dtype, device)

    def to_base(p_w):
        return _mtv(R_new, p_w - base_new)

    if stand:
        foot_l, foot_r = state.foot_l, state.foot_r
        q_new = torch.cat([
            kin.inverse_kinematics_analytic(gl, to_base(foot_l),
                                            state.q[:, :3]),
            kin.inverse_kinematics_analytic(gr, to_base(foot_r),
                                            state.q[:, 3:])], -1)
    else:
        q_sw = torch.where(ls[:, None], d["q"][:, :3], d["q"][:, 3:])
        p_sw_w = base_new + _mv(R_new, kin.forward_kinematics(
            kin.select_geometry(ls, gl, gr), q_sw))
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
    z, y = d["qp_state"]
    new = State(xi=xi_new, q=q_new, foot_l=foot_l, foot_r=foot_r, qp_z=z,
                qp_lam=y,
                ref_anchor=(d["anchor_next"] if state.ref_anchor is not None
                            else None))
    metrics = {"height": xi_new[:, 5], "velocity": xi_new[:, 9:12],
               "grf": d["grf"], "qp_residual": d["residual"],
               "foot_target": d["foot_target"]}
    return new, metrics


def rollout(cfg: ControllerConfig, state: State, steps: int,
            start_iteration: torch.Tensor, mpc_every: int = 1):
    """`steps` ticks of the closed loop from `state`; start_iteration [B].
    With mpc_every > 1 the force solved on a tick t % mpc_every == 0 is
    held on the ticks between. Returns (final state, metrics [B, steps,
    ...])."""
    B = state.xi.shape[0]
    dtype, device = state.xi.dtype, state.xi.device
    v_des = torch.tensor(cfg.desired_velocity, dtype=dtype,
                         device=device).expand(B, 3)
    # the iteration as the program holds it: float32
    start = start_iteration.to(torch.float32)
    out = {k: [] for k in METRIC_KEYS}
    s, grf = state, None
    for t in range(steps):
        hold = grf if (mpc_every > 1 and t % mpc_every != 0) else None
        s, m = plant_step(cfg, s, start + float(t), v_des, grf_override=hold)
        if mpc_every > 1 and t % mpc_every == 0:
            grf = m["grf"]
        for k in METRIC_KEYS:
            out[k].append(m[k])
    return s, {k: torch.stack(v, 1) for k, v in out.items()}


def session_rpy(quat: torch.Tensor) -> torch.Tensor:
    """Roll, pitch, yaw of a wire quaternion (x, y, z, w), as the session
    derives the odometry's orientation."""
    return rot.quat_to_rpy(quat)

