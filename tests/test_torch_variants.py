"""The controller variants of the PyTorch port against the JAX package, on
the CPU: the Riccati-form ADMM, the iterative swing IKs (damped least
squares, SE(3) log6), the receding attitude reference, the SRBD
linearizations and the leg inverse dynamics.

Inputs are drawn with numpy from a seed and handed to both packages.
float64 agrees to 1e-9 on the modules (same formulas, another summation
order in a few contractions) and to 1e-8 on a full-width tick; states are
kicked in vx / vy only (a yaw kick puts some swing targets at an IK branch
tie, ROADMAP §3). Riccati against the condensed warm ADMM in float32 holds
the JAX suite's own band (tests/test_riccati.py:54-75).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_limx_control_tpu.control import rollout as jro
from mpc_limx_control_tpu.core.config import ControllerConfig as JCfg
from mpc_limx_control_tpu.core.config import LegOffsets as JLegs
from mpc_limx_control_tpu.core.config import RobotParams as JRobot
from mpc_limx_control_tpu.models import dynamics as jdyn
from mpc_limx_control_tpu.models import kinematics as jkin
from mpc_limx_control_tpu.models import srbd as jsrbd
from mpc_limx_control_tpu.ops import riccati as jric
from mpc_limx_control_tpu.oracle.rnea_oracle import solve_rnea_oracle
from mpc_limx_control_tpu_torch.control import rollout as tro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig as TCfg
from mpc_limx_control_tpu_torch.core.config import RobotParams as TRobot
from mpc_limx_control_tpu_torch.models import dynamics as tdyn
from mpc_limx_control_tpu_torch.models import kinematics as tkin
from mpc_limx_control_tpu_torch.models import srbd as tsrbd
from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as tmfc
from mpc_limx_control_tpu_torch.ops import riccati as tric
from mpc_limx_control_tpu_torch.utils import convert

F64 = 1e-9
FIELDS = ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam", "ref_anchor")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ticks and IK loops are host loops over many small
    torch calls: with several test workers on one machine a multi-threaded
    BLAS oversubscribes the cores and each call spins. One thread per
    worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.tensor(np.asarray(a))


def close(t, j, atol, msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0,
                               err_msg=msg)


def _walking_qp_inputs(B, seed, dtype=np.float64):
    """SRBD matrices of perturbed poses, arms under the hips, a walking
    reference and a warm state (tests/test_mpc_fused.py recipe, drawn with
    numpy): (Ad, Bd_t, x_ref, x0, z_w, y_w) as numpy arrays."""
    cfg = TCfg.walking()
    N = cfg.srbd.horizon
    rng = np.random.default_rng(seed)
    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    ori = np.concatenate([0.01 * rng.standard_normal((B, 2)),
                          0.1 * rng.standard_normal((B, 1))], -1)
    arms = (pos[:, None, :] + np.array([0.02, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, N, 3)))
    x0 = tsrbd.initial_state(T(ori), T(pos), T(np.zeros((B, 3))),
                             T(np.tile([0.4, 0.0, 0.0], (B, 1))))
    Ac, Bc = tsrbd.linearize_shared(cfg.robot, T(arms), x0[:, 3:6], x0[:, 2])
    Ad, Bd_t = tsrbd.discretize_srbd(Ac, Bc, cfg.srbd.ts)
    x_ref = tsrbd.walking_reference(
        x0, cfg.srbd, N, T(np.tile([0.5, 0.0, 0.0], (B, 1))),
        T(0.05 * rng.standard_normal(B)), height_des=0.65)
    z_w = 5.0 * rng.standard_normal((B, 3 * N))
    y_w = np.abs(rng.standard_normal((B, 6 * N)))
    return [np.asarray(a, dtype) for a in
            (Ad.numpy(), Bd_t.numpy(), x_ref.numpy(), x0.numpy(), z_w, y_w)]


def _weights(c):
    mu = float(c.friction_mu)
    Gu = ((1.0, 0.0, -mu), (-1.0, 0.0, -mu), (0.0, 1.0, -mu),
          (0.0, -1.0, -mu), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
    q = tuple(float(v) for v in c.q_diag)
    r = tuple(float(v) for v in c.r_diag)
    p = tuple(float(c.p_scale) * float(v) for v in c.q_diag)
    return q, r, p, Gu, float(c.solver.admm_rho)


# ---- ops/riccati.py -----------------------------------------------------

def test_inv3_matches_jax_f64():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((7, 3, 3)) + 3.0 * np.eye(3)
    close(tric._inv3(T(M)), jric._inv3(jnp.asarray(M)), F64)
    close(tric._inv3(T(M)) @ T(M), np.broadcast_to(np.eye(3), M.shape), F64)


def test_riccati_factor_and_solve_match_jax_f64():
    c = TCfg.walking().srbd
    q, r, p, Gu, rho = _weights(c)
    Ad, Bd_t, x_ref, x0, _, _ = _walking_qp_inputs(4, 1)
    tf = tric.riccati_factor(T(Ad), T(Bd_t), q, r, p, Gu, rho)
    jf = jric.riccati_factor(jnp.asarray(Ad), jnp.asarray(Bd_t), q, r, p,
                             Gu, rho)
    for name, a, b in zip(("K", "Hinv", "BtP", "Acl"), tf, jf):
        scale = float(np.abs(np.asarray(b)).max()) + 1.0
        close(a, b, F64 * scale, name)
    r_lin = np.random.default_rng(2).standard_normal((4, c.horizon, 3))
    u_t = tric.riccati_solve(T(Ad), T(Bd_t), tf, T(x0), T(x_ref), q, p,
                             T(r_lin))
    u_j = jric.riccati_solve(jnp.asarray(Ad), jnp.asarray(Bd_t), jf,
                             jnp.asarray(x0), jnp.asarray(x_ref), q, p,
                             jnp.asarray(r_lin))
    close(u_t, u_j, F64 * (float(np.abs(np.asarray(u_j)).max()) + 1.0))


def test_make_admm_riccati_matches_jax_f64():
    c = TCfg.walking().srbd
    args = _walking_qp_inputs(5, 3)
    sol_t, (z_t, y_t) = tric.make_admm_riccati(c)(*map(T, args))
    sol_j, (z_j, y_j) = jric.make_admm_riccati(JCfg.walking().srbd)(
        *map(jnp.asarray, args))
    scale = float(np.abs(np.asarray(z_j)).max()) + 1.0
    close(z_t, z_j, F64 * scale, "z")
    close(y_t, y_j, F64 * scale, "y")
    close(sol_t.residual, sol_j.residual, F64 * scale, "residual")
    assert sol_t.iterations == sol_j.iterations


def test_riccati_admm_matches_condensed_admm_f32():
    """Riccati-factorized x-updates against the condensed warm ADMM of
    make_admm_fused on the same QPs, float32: z and y within 3e-3 of the
    force scale (the band of tests/test_riccati.py:54-75)."""
    c = TCfg.walking().srbd
    args = [T(a) for a in _walking_qp_inputs(16, 4, np.float32)]
    _, (z_r, y_r) = tric.make_admm_riccati(c)(*args)
    _, (z_c, y_c) = tmfc.make_admm_fused(c)(*args)
    scale = float(z_c.abs().max()) + 1.0
    close(z_r, z_c.numpy(), 3e-3 * scale, "z")
    close(y_r, y_c.numpy(), 3e-3 * scale, "y")


# ---- models/kinematics.py ------------------------------------------------

def _geoms(side):
    return (tkin.leg_geometry(side=side, dtype=torch.float64),
            jkin.leg_geometry(JLegs(), side, jnp.float64))


def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-1.0, 1.0, (n, 3))
    cr, sr = np.cos(rpy[:, 0]), np.sin(rpy[:, 0])
    cp, sp = np.cos(rpy[:, 1]), np.sin(rpy[:, 1])
    cy, sy = np.cos(rpy[:, 2]), np.sin(rpy[:, 2])
    R = np.zeros((n, 3, 3))
    R[:, 0] = np.stack([cy * cp, cy * sp * sr - sy * cr,
                        cy * sp * cr + sy * sr], -1)
    R[:, 1] = np.stack([sy * cp, sy * sp * sr + cy * cr,
                        sy * sp * cr - cy * sr], -1)
    R[:, 2] = np.stack([-sp, cp * sr, cp * cr], -1)
    return R


def test_log3_log6_match_jax_f64_including_the_identity():
    R = _rotations(8, 5)
    # the identity and a rotation of 1e-7 rad: the guarded branches
    tiny = np.eye(3) + 1e-7 * np.array([[0, -1, 0], [1, 0, 0], [0, 0, 0]])
    R = np.concatenate([R, np.eye(3)[None], tiny[None]])
    p = np.random.default_rng(6).standard_normal((10, 3))
    close(tkin.log3(T(R)), jkin.log3(jnp.asarray(R)), F64, "log3")
    close(tkin.log6(T(R), T(p)), jkin.log6(jnp.asarray(R), jnp.asarray(p)),
          F64, "log6")
    assert float(tkin.log3(T(np.eye(3))).abs().max()) == 0.0


@pytest.mark.parametrize("side", ["left", "right"])
def test_leg_pose_and_damped_ls_ik_match_jax_f64(side):
    gt, gj = _geoms(side)
    rng = np.random.default_rng(7)
    q = rng.uniform(-0.6, 0.6, (6, 3))
    Rt, pt = tkin.leg_pose(gt, T(q))
    Rj, pj = jkin.leg_pose(gj, jnp.asarray(q))
    close(Rt, Rj, F64, "R")
    close(pt, pj, F64, "p")
    close(pt, tkin.forward_kinematics(gt, T(q)).numpy(), F64, "p vs FK")
    target = np.asarray(pj) + 0.01 * rng.standard_normal((6, 3))
    q0 = q + 0.05 * rng.standard_normal((6, 3))
    qt = tkin.inverse_kinematics_damped_ls(gt, T(target), T(q0))
    qj = jkin.inverse_kinematics_damped_ls(gj, jnp.asarray(target),
                                           jnp.asarray(q0))
    close(qt, qj, F64, "damped_ls")
    # converged: the foot reaches the target
    close(tkin.forward_kinematics(gt, qt), target, 1e-8, "reach")


@pytest.mark.parametrize("side", ["left", "right"])
def test_log6_ik_matches_jax_f64(side):
    gt, gj = _geoms(side)
    rng = np.random.default_rng(8)
    q0 = rng.uniform(-0.5, 0.5, (5, 3))
    target = (np.asarray(jkin.forward_kinematics(gj, jnp.asarray(q0)))
              + 0.05 * rng.standard_normal((5, 3)))
    qt = tkin.inverse_kinematics_log6(gt, T(target), T(q0))
    qj = jkin.inverse_kinematics_log6(gj, jnp.asarray(target),
                                      jnp.asarray(q0))
    close(qt, qj, F64)
    # float32 stays float32 through the forward-mode Jacobian; J J' is a
    # 6 x 6 of rank 3 damped by 1e-6, so float32 keeps ~3 digits (JAX's own
    # float32 loop lands 2.6e-3 from its float64 one): 1e-2
    g32 = tkin.leg_geometry(side=side)
    q32 = tkin.inverse_kinematics_log6(g32, T(target).float(), T(q0).float())
    assert q32.dtype == torch.float32
    close(q32, np.asarray(qj), 1e-2)


def _jax_log6_jacobian(gj, q, target):
    def err(qq):
        R, p = jkin.leg_pose(gj, qq)
        return jkin.log6(R.T, R.T @ (jnp.asarray(target) - p))

    return np.stack([np.asarray(jax.jacfwd(err)(jnp.asarray(qi)))
                     for qi in q])


def test_log6_jacobian_matches_jax_forward_mode_f64():
    """The derivative written out (chain rule through leg_pose, log3, log6
    with their guards) against JAX's jacfwd of the same error."""
    gt, gj = _geoms("right")
    rng = np.random.default_rng(12)
    q = rng.uniform(-0.6, 0.6, (4, 3))
    for target in (rng.standard_normal(3) * 0.1 + [0.0, -0.1, -0.5],
                   np.asarray(jkin.forward_kinematics(gj, jnp.zeros(3)))):
        e, J = tkin._log6_error_jacobian(gt, T(q), T(target))
        close(e, np.stack([np.asarray(jkin.log6(*(lambda R, p: (
            R.T, R.T @ (jnp.asarray(target) - p)))(*jkin.leg_pose(
                gj, jnp.asarray(qi))))) for qi in q]), F64, "e")
        close(J, _jax_log6_jacobian(gj, q, target), F64, "J")


def test_log6_ik_at_the_home_pose_stays_finite():
    """A target at the home pose reached from q = 0: the error rotation is
    the identity, where the Jacobian passes through the guarded branches
    of log3 / log6; it must be finite and match JAX's forward-mode one."""
    gt, gj = _geoms("left")
    home = np.asarray(jkin.forward_kinematics(gj, jnp.zeros(3)))
    _, J_t = tkin._log6_error_jacobian(
        gt, torch.zeros(1, 3, dtype=torch.float64), T(home[None]))
    assert bool(torch.isfinite(J_t).all())
    close(J_t, _jax_log6_jacobian(gj, np.zeros((1, 3)), home), F64)
    q_t = tkin.inverse_kinematics_log6(gt, T(home[None]),
                                       torch.zeros(1, 3, dtype=torch.float64))
    q_j = jkin.inverse_kinematics_log6(gj, jnp.asarray(home[None]),
                                       jnp.zeros((1, 3)))
    close(q_t, q_j, F64)
    assert float(q_t.abs().max()) < 1e-12      # already at the target


# ---- models/srbd.py ------------------------------------------------------

def test_linearize_matches_jax_f64():
    rng = np.random.default_rng(9)
    foot = rng.standard_normal((4, 2, 3))
    base = rng.standard_normal((4, 1, 3))
    yaw = rng.uniform(-1.0, 1.0, (4, 2))
    At, Bt = tsrbd.linearize(TRobot(), T(foot), T(base), T(yaw))
    Aj, Bj = jsrbd.linearize(JRobot(), jnp.asarray(foot), jnp.asarray(base),
                             jnp.asarray(yaw), jnp.float64)
    assert At.shape == (4, 2, 13, 13) and Bt.shape == (4, 2, 13, 3)
    close(At, Aj, F64, "Ac")
    close(Bt, Bj, F64, "Bc")
    # one arm of linearize_shared
    As, Bs = tsrbd.linearize_shared(TRobot(), T(foot[:, :1]),
                                    T(base[:, 0]), T(yaw[:, 0]))
    close(As, At[:, 0].numpy(), F64, "shared Ac")
    close(Bs[:, 0], Bt[:, 0].numpy(), F64, "shared Bc")


def test_linearize_reference_literal_is_the_reference_bit_for_bit():
    """The literal include/mpcQP.h matrices, bugs included
    (tests/test_srbd.py:12-35): equal to JAX's bit for bit."""
    rng = np.random.default_rng(10)
    foot, base = rng.standard_normal((3, 3)), rng.standard_normal((3, 3))
    At, Bt = tsrbd.linearize_reference_literal(TRobot(), T(foot), T(base))
    Aj, Bj = jsrbd.linearize_reference_literal(
        JRobot(), jnp.asarray(foot), jnp.asarray(base), jnp.float64)
    np.testing.assert_array_equal(At.numpy(), np.asarray(Aj))
    np.testing.assert_array_equal(Bt.numpy(), np.asarray(Bj))
    d = foot - base
    assert float(At[0, 0, 7]) == d[0, 2] and float(At[0, 2, 7]) == d[0, 0]
    assert float(At[0, 11, 12]) == -1.0
    assert float(Bt[0, 9, 0]) == -TRobot().mass


# ---- models/dynamics.py --------------------------------------------------

@pytest.mark.parametrize("side", ["left", "right"])
def test_rnea_matches_jax_and_the_oracle_f64(side):
    rng = np.random.default_rng(11)
    q = rng.uniform(-1.2, 1.2, (10, 3))
    dq = 3.0 * rng.standard_normal((10, 3))
    ddq = 10.0 * rng.standard_normal((10, 3))
    tau_t = tdyn.rnea(T(q), T(dq), T(ddq), side=side)
    tau_j = jdyn.rnea(jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ddq),
                      side=side)
    close(tau_t, tau_j, F64, "rnea")
    close(tdyn.gravity_torques(T(q), side=side),
          jdyn.gravity_torques(jnp.asarray(q), side=side), F64, "gravity")
    # the independent Euler-Lagrange oracle (tests/test_dynamics.py:104)
    for i in range(3):
        t_o = np.asarray(solve_rnea_oracle(q[i], dq[i], ddq[i], side=side))
        assert (np.abs(t_o - tau_t[i].numpy()).max()
                / (1.0 + np.abs(t_o).max())) < 1e-12


def test_rnea_follows_the_input_device_and_dtype():
    tau = tdyn.rnea(torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(2, 3))
    assert tau.dtype == torch.float32 and tau.shape == (2, 3)
    assert tau.device == torch.zeros(1).device


# ---- one full-width tick per variant against JAX -------------------------

def _kicked(jcfg, B, seed):
    s0 = jro.initial_plant_state(jcfg, batch=(B,), dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    xi = np.asarray(s0.xi).copy()
    xi[:, 9] += 0.08 * rng.standard_normal(B)
    xi[:, 10] += 0.05 * rng.standard_normal(B)
    return s0.replace(xi=jnp.asarray(xi))


def _variant(base, name):
    srbd = base.srbd
    solver = srbd.solver
    if name.startswith("riccati"):
        cfg = dataclasses.replace(base, srbd=dataclasses.replace(
            srbd, solver=dataclasses.replace(solver, method="riccati")))
        return dataclasses.replace(cfg, qp_warm_start=name == "riccati_warm")
    if name == "receding":
        return dataclasses.replace(base, srbd=dataclasses.replace(
            srbd, attitude_ref="receding"))
    if name == "pdip_n22":
        # a horizon past the MPC kernels' 21 steps: the composition runs it
        return dataclasses.replace(base, srbd=dataclasses.replace(
            srbd, horizon=22, solver=dataclasses.replace(solver,
                                                         method="pdip")))
    return dataclasses.replace(base, ik_method=name)


VARIANTS = [("walk", "riccati_warm"), ("walk", "riccati_cold"),
            ("walk", "damped_ls"), ("walk", "log6"), ("walk", "receding"),
            ("stand", "riccati_warm"), ("stand", "damped_ls"),
            ("stand", "log6"), ("stand", "receding"), ("walk", "pdip_n22")]


@pytest.mark.parametrize("mode,name", VARIANTS)
def test_variant_tick_matches_jax_f64(mode, name):
    """One full-width tick (N = 20; "pdip_n22": the warm PDIP walking at
    N = 22) of each variant through plant_step on
    CPU tensors against JAX _plant_step_ref, f64: 1e-8 on the state, the
    warm QP state and every metric. Standing runs the stance MPC whatever
    the method ("riccati" there is the cold PDIP, as in JAX)."""
    jbase = JCfg.walking() if mode == "walk" else JCfg.standing()
    jcfg = _variant(jbase, name)
    tcfg = convert.config_from_dict(jcfg)
    assert tro.tick_route(tcfg) == tro.TickRoute("composition")
    B = 4
    sj = _kicked(jcfg, B, 20 + VARIANTS.index((mode, name)))
    its = np.asarray([40.0, 299.0, 300.0, 455.0])
    sj2, mj = jax.vmap(lambda s, it: jro._plant_step_ref(jcfg, s, it))(
        sj, jnp.asarray(its))
    st = convert.plant_state_from_numpy(
        {k: np.asarray(getattr(sj, k)) for k in FIELDS
         if getattr(sj, k) is not None}, dtype=torch.float64, device="cpu")
    st2, mt = tro.plant_step(tcfg, st, torch.tensor(its))
    for k in FIELDS:
        if getattr(sj2, k) is None:
            assert getattr(st2, k) is None, k
            continue
        j = np.asarray(getattr(sj2, k))
        close(getattr(st2, k), j, 1e-8, k)
    for k, v in mt.items():
        j = np.asarray(mj[k])
        close(v, j, 1e-8, k)
