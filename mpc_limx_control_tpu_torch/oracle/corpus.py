"""Capture real walking/standing SRBD QPs from closed-loop rollouts.

Counterpart of ``mpc_limx_control_tpu.oracle.corpus``. The solvers are
held against the float64 oracles on *the problems the controller actually
solves*, not only on synthetic QPs. This module (a) steps the port's
closed-loop plant (``rollout.plant_step``: the fused tick kernels on the
card) and records the state at sampled ticks, and (b) rebuilds, in
float64 on the CPU, the exact condensed GRF QP (H, f, G, h) that
``controller.tick`` poses at that state -- same gait clock, placement,
anchor logic, moment arms, SRBD linearization, exact-ZOH discretization,
reference synthesis and friction-cone rows.

Capture fidelity: the f64 oracle solution of the rebuilt QP must match the
u the in-loop solver produced at that tick (to that solver's accuracy),
for cold and warm-started problems (tests/test_torch_oracle.py,
chip_smoke.py's ``[corpus]`` phase).

Reference lineage: the QP corresponds to the intended stance-force MPC of
include/mpcQP.h (corrected physics, models/srbd.py) condensed as in
src/QPSolver.cpp:31-81 and constrained by friction cones instead of the
placeholder +/-8 N box (include/mpcQP.h:59).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpc_limx_control_tpu_torch.control import gait as gaitmod
from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import require_device
from mpc_limx_control_tpu_torch.models import kinematics as kin
from mpc_limx_control_tpu_torch.models import srbd
from mpc_limx_control_tpu_torch.utils import rotations as rot

F64 = torch.float64


class CapturedQP(NamedTuple):
    """One condensed GRF QP (float64 NumPy) + the in-loop solve's answer."""

    H: np.ndarray          # [nz, nz]
    f: np.ndarray          # [nz]
    G: np.ndarray          # [m, nz]
    h: np.ndarray          # [m]
    u_loop: np.ndarray     # [nu] first-step GRF the controller applied
    iteration: int
    warm: bool             # True once the warm state is threaded (tick > 0)
    nu: int                # 3 (walking single-support) or 6 (standing)


def condense_ltv_f64(Ad, Bd_t, Q, R, P, N, x0, x_ref):
    """Float64 LTV condensation: H, f for min 1/2 z'Hz + f'z.

    Ad [nx,nx] (step-invariant — the SRBD Ac does not depend on the arm),
    Bd_t [N,nx,nu] per-step input matrices, x_ref [N+1,nx] (row i =
    reference state at step i).  Same math as ops/condense.py:condense
    generalizing src/QPSolver.cpp:31-60 to time-varying B.
    """
    Ad = np.asarray(Ad, np.float64)
    Bd_t = np.asarray(Bd_t, np.float64)
    nx = Ad.shape[0]
    nu = Bd_t.shape[-1]

    powers = [np.eye(nx)]
    for _ in range(N):
        powers.append(Ad @ powers[-1])
    A_aug = np.concatenate(powers, axis=0)               # [(N+1)nx, nx]

    B_aug = np.zeros(((N + 1) * nx, N * nu))
    for i in range(1, N + 1):
        for j in range(i):
            B_aug[i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = (
                powers[i - j - 1] @ Bd_t[j])

    Q_bar = np.zeros(((N + 1) * nx, (N + 1) * nx))
    for i in range(N):
        Q_bar[i * nx:(i + 1) * nx, i * nx:(i + 1) * nx] = Q
    Q_bar[N * nx:, N * nx:] = P

    R_bar = np.kron(np.eye(N), R)
    H = 2.0 * (B_aug.T @ Q_bar @ B_aug + R_bar)
    H = 0.5 * (H + H.T)
    x_ref_vec = np.asarray(x_ref, np.float64).reshape(-1)
    f = 2.0 * B_aug.T @ Q_bar @ (A_aug @ np.asarray(x0, np.float64)
                                 - x_ref_vec)
    return H, f


def _to64(x) -> torch.Tensor:
    """One scenario's field as a float64 CPU vector (the state may lie on
    the card, in float32, unbatched or as a batch of one)."""
    return torch.as_tensor(x).detach().to("cpu", F64).reshape(-1)


def _weights(c, feet: int):
    Q = np.diag(np.asarray(c.q_diag, np.float64))
    R = np.diag(np.asarray(tuple(c.r_diag) * feet, np.float64))
    return Q, R, c.p_scale * Q


def build_walking_qp_f64(cfg: ControllerConfig, state: ro.PlantState,
                         iteration: float) -> tuple:
    """Rebuild, in float64, the single-support walking GRF QP that
    controller.tick poses at `state` (truth odometry; one scenario).

    Returns (H [60,60], f [60], G [120,60], h [120]) as NumPy arrays for
    the default N = 20 horizon. Mirrors control/controller.py:tick ->
    stance_mpc_single_support step by step.
    """
    assert cfg.mode == "walk"
    c = cfg.srbd
    N = c.horizon

    xi = _to64(state.xi)
    q = _to64(state.q)
    it = torch.tensor([float(iteration)], dtype=F64)
    pos, ori, v_pos = xi[3:6], xi[0:3], xi[9:12]
    v_des = torch.tensor(cfg.desired_velocity, dtype=F64)
    yaw_rate_des = torch.tensor([cfg.desired_yaw_rate], dtype=F64)

    gait = gaitmod.gait_clock(cfg.gait, it)
    target_w = gaitmod.foot_placement(cfg, gait, pos[None], v_des[None],
                                      v_actual=v_pos[None])[0]

    # anchor logic (tick()): clip the persistent (x, y, yaw) anchor into
    # its bands, shift placement by the integral term, use it as the MPC
    # reference origin
    band = cfg.ref_anchor_band
    yband = cfg.yaw_anchor_band
    anchor_used = None
    yaw_anchor_used = None
    if state.ref_anchor is not None and band > 0.0:
        ra = _to64(state.ref_anchor)
        anchor_used = torch.clamp(ra[:2], pos[:2] - band, pos[:2] + band)
        yaw_anchor_used = torch.clamp(ra[2:3], ori[2:3] - yband,
                                      ori[2:3] + yband)
        if cfg.anchor_placement_gain > 0.0:
            target_w = target_w + torch.cat([
                cfg.anchor_placement_gain * (pos[:2] - anchor_used),
                torch.zeros(1, dtype=F64)])

    # world foot positions from FK + base pose
    R_wb = rot.quat_to_rot(rot.rpy_to_quat(ori))
    gl = kin.leg_geometry(cfg.robot.legs, "left", F64)
    gr = kin.leg_geometry(cfg.robot.legs, "right", F64)
    p_l_w = pos + R_wb @ kin.forward_kinematics(gl, q[:3])
    p_r_w = pos + R_wb @ kin.forward_kinematics(gr, q[3:])

    on_l = gaitmod.contact_schedule(cfg.gait, it, N, c.ts)[0]   # [N]
    left_swing = gait.left_swing[0]
    arm_l = torch.where(left_swing, target_w, p_l_w)
    arm_r = torch.where(left_swing, p_r_w, target_w)
    arms = torch.where(on_l[:, None], arm_l[None], arm_r[None])  # [N, 3]

    xi0 = srbd.initial_state(ori, pos, xi[6:9], v_pos)
    Ac, Bc_t = srbd.linearize_shared(cfg.robot, arms[None], pos[None],
                                     ori[2:3])
    Ad, Bd_t = srbd.discretize_srbd(Ac, Bc_t, c.ts)

    anchor_xy = pos[:2] if anchor_used is None else anchor_used
    anchor3 = torch.cat([anchor_xy, torch.zeros(1, dtype=F64)])
    x_ref = srbd.walking_reference(
        xi0[None], c, N, v_des[None], yaw_rate_des,
        height_des=cfg.ground_height + cfg.base_height,
        pos_anchor=anchor3[None], yaw_anchor=yaw_anchor_used)

    H, f = condense_ltv_f64(Ad[0].numpy(), Bd_t[0].numpy(), *_weights(c, 1),
                            N, xi0.numpy(), x_ref[0].numpy())
    G, h = srbd.friction_cone_rows(c, N, F64)
    return H, f, G.numpy(), h.numpy()


def build_standing_qp_f64(cfg: ControllerConfig, state: ro.PlantState,
                          iteration: float) -> tuple:
    """Rebuild, in float64, the two-foot standing GRF QP of stance_mpc
    (nu = 6, both feet on over the whole horizon, position anchored over
    the support midpoint; one scenario)."""
    assert cfg.mode == "stand"
    c = cfg.srbd
    N = c.horizon

    xi = _to64(state.xi)
    pos, ori = xi[3:6], xi[0:3]
    v_des = torch.tensor(cfg.desired_velocity, dtype=F64)
    yaw_rate_des = torch.tensor([cfg.desired_yaw_rate], dtype=F64)

    p_l_w = _to64(state.foot_l)
    p_r_w = _to64(state.foot_r)
    pos_anchor = torch.cat([0.5 * (p_l_w + p_r_w)[:2], torch.tensor(
        [cfg.ground_height + cfg.base_height], dtype=F64)])

    xi0 = srbd.initial_state(ori, pos, xi[6:9], xi[9:12])
    arms2 = torch.stack([p_l_w, p_r_w], -2)
    Ac, Bc2 = srbd.linearize_shared(cfg.robot, arms2[None], pos[None],
                                    ori[2:3])
    Bc = torch.cat([Bc2[:, 0], Bc2[:, 1]], -1)           # [1, 13, 6]
    Ad, Bd = srbd.discretize_srbd(Ac, Bc, c.ts)
    Bd_t = np.broadcast_to(Bd[0].numpy(), (N, 13, 6))

    x_ref = srbd.walking_reference(
        xi0[None], c, N, v_des[None], yaw_rate_des,
        height_des=cfg.ground_height + cfg.base_height,
        pos_anchor=pos_anchor[None])

    H, f = condense_ltv_f64(Ad[0].numpy(), Bd_t, *_weights(c, 2), N,
                            xi0.numpy(), x_ref[0].numpy())

    # two-foot cone rows with both feet on (controller._cone_rows/_bounds)
    mu = c.friction_mu
    Gu1 = np.asarray([[1.0, 0.0, -mu], [-1.0, 0.0, -mu],
                      [0.0, 1.0, -mu], [0.0, -1.0, -mu],
                      [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float64)
    Gu = np.block([[Gu1, np.zeros((6, 3))], [np.zeros((6, 3)), Gu1]])
    G = np.kron(np.eye(N), Gu)
    hu = np.asarray([0.0, 0.0, 0.0, 0.0, c.fz_max, -c.fz_min] * 2)
    h = np.tile(hu, N)
    return H, f, G, h


def capture_corpus(cfg: ControllerConfig, ticks: int, sample_every: int,
                   skip_first: int = 0, kick: tuple | None = None,
                   device=None) -> list[CapturedQP]:
    """Run the closed loop for `ticks` 1 kHz steps and capture the GRF QP
    at every `sample_every`-th tick (from `skip_first` on).

    The controller path is the production one, ``rollout.plant_step`` on
    one scenario: on the card (the default) the fused tick kernels
    (``walking_tick`` / ``standing_tick``, warm ADMM in the kernel); with
    ``device="cpu"`` the plain composition. Without a card the default
    raises. u_loop records the force the loop actually applied, so the
    captured problems include warm-started intermediate solves, not just
    cold starts.

    kick=(tick, (dvx, dvy, dvz)): velocity impulse applied to the plant at
    `tick` -- disturbance-recovery QPs drive the friction cone / fz bounds
    active, exercising the constrained solve paths the steady gait never
    touches.
    """
    device = require_device("cuda" if device is None else str(device))
    state = ro.initial_plant_state(cfg, batch=(1,), device=device)
    dtype = state.xi.dtype
    build = (build_walking_qp_f64 if cfg.mode == "walk"
             else build_standing_qp_f64)
    nu = 3 if cfg.mode == "walk" else 6

    out = []
    for t in range(ticks):
        if kick is not None and t == kick[0]:
            dv = torch.tensor(kick[1], dtype=dtype, device=device)
            state = state.replace(xi=torch.cat(
                [state.xi[:, :9], state.xi[:, 9:12] + dv, state.xi[:, 12:]],
                -1))
        pending = None
        if t >= skip_first and (t - skip_first) % sample_every == 0:
            pending = build(cfg, state, float(t))
        it = torch.full((1,), float(t), dtype=dtype, device=device)
        new_state, metrics = ro.plant_step(cfg, state, it)
        if pending is not None:
            H, f, G, h = pending
            grf = metrics["grf"][0].to("cpu", F64).numpy()
            if cfg.mode == "walk":
                # u0 is the STANCE foot's force (controller.tick zeroes
                # the swing foot's slot)
                g_clk = gaitmod.gait_clock(cfg.gait,
                                           torch.tensor(float(t), dtype=F64))
                u_loop = grf[3:] if bool(g_clk.left_swing) else grf[:3]
            else:
                u_loop = grf
            out.append(CapturedQP(H=H, f=f, G=G, h=h, u_loop=u_loop,
                                  iteration=t, warm=t > 0, nu=nu))
        state = new_state
    return out
