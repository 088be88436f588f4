"""The standing-balance slice of the PyTorch port against the JAX package,
on the CPU.

* ``controller.stance_mpc`` (the two-foot nu = 6 QP) and the stand branch
  of ``controller.tick`` against JAX in float64 at full width (N = 20,
  n = 120, m = 240): 1e-9 on the forces, the prediction and the command;
* ``make_admm_fused``'s plain version against JAX's ``_xla_batched`` for
  nu = 3 and nu = 6 in float64 (1e-9), and the "subst" twin of the
  ``fused_qp`` kernels against JAX ``fused_walking_qp`` in interpret mode
  at horizon 8 (2e-3 of the solution scale, tests/test_mpc_fused.py:212-235);
* full-width standing ticks, truth and KF odometry, against JAX
  ``_plant_step_ref`` in float64 (1e-8 after one tick, 1e-6 after five);
* the plain twins of the ``standing_tick`` kernels against the JAX fused
  tick in interpret mode at horizon 8 over a solve + hold sequence
  (xi 5e-4, q 1e-3, grf 2e-1, tests/test_tick_fused.py:394-441);
* the closed loop on the CPU (bench.py's stand gate, shortened), the
  held-force tick, the state conversion of a standing state, the device
  default of the state-creating entry points, and the refusals left.

Comparison states are kicked in vx / vy only: a yaw kick puts the filter's
measured feet off its state and makes some IK branches rounding-decided
ties (ROADMAP section 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpc_limx_control_tpu.control import controller as jctrl
from mpc_limx_control_tpu.control import rollout as jro
from mpc_limx_control_tpu.core.config import ControllerConfig as JCfg
from mpc_limx_control_tpu.core.types import JointState as JJoints
from mpc_limx_control_tpu.models import srbd as jsrbd
from mpc_limx_control_tpu.ops import mpc_fused_pallas as jfused
from mpc_limx_control_tpu.ops import tick_fused_pallas as jtick
from mpc_limx_control_tpu_torch.control import controller as tctrl
from mpc_limx_control_tpu_torch.control import rollout as tro
from mpc_limx_control_tpu_torch.core import types as ttypes
from mpc_limx_control_tpu_torch.core.config import ControllerConfig as TCfg
from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as tmfc
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as ttfc
from mpc_limx_control_tpu_torch.utils import convert

FIELDS = ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam", "prev_v",
          "prev_q")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ticks are host loops over hundreds of small torch
    calls: with several test workers on one machine a multi-threaded BLAS
    oversubscribes the cores and each call spins (a 600-tick walking loop
    takes 11 s on one thread and a minute on the default). One thread per
    worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kf(cfg):
    return dataclasses.replace(cfg, estimator_mode="kf")


def _small(cfg):
    return dataclasses.replace(
        cfg, srbd=dataclasses.replace(cfg.srbd, horizon=8))


def _jax_state_np(s):
    d = {k: np.asarray(getattr(s, k)) for k in FIELDS
         if getattr(s, k) is not None}
    if s.kf is not None:
        d["kf"] = {"x_hat": np.asarray(s.kf.x_hat),
                   "p_cov": np.asarray(s.kf.p_cov)}
    return d


def _port_state(s_jax, dtype):
    return convert.plant_state_from_numpy(_jax_state_np(s_jax), dtype=dtype,
                                          device="cpu")


def _kicked(jcfg, B, seed, np_dtype):
    """JAX initial standing state with numpy-seeded vx / vy kicks."""
    s0 = jro.initial_plant_state(jcfg, batch=(B,), dtype=jnp.dtype(np_dtype))
    rng = np.random.default_rng(seed)
    xi = np.asarray(s0.xi).copy()
    xi[:, 9] += 0.05 * rng.standard_normal(B)
    xi[:, 10] += 0.05 * rng.standard_normal(B)
    return s0.replace(xi=jnp.asarray(xi.astype(np_dtype)))


def _close(t, j, atol, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0,
                               err_msg=what)


def _assert_state(st, sj, tols):
    for k, a in tols.items():
        if k in ("x_hat", "p_cov"):
            _close(getattr(st.kf, k), getattr(sj.kf, k), a, k)
        else:
            _close(getattr(st, k), getattr(sj, k), a, k)


# ---- the two-foot MPC and the controller tick in float64 -------------------

def test_initial_standing_state_matches_jax():
    for jcfg, tcfg in ((JCfg.standing(), TCfg.standing()),
                       (_kf(JCfg.standing()), _kf(TCfg.standing()))):
        sj = jro.initial_plant_state(jcfg, batch=(3,), dtype=jnp.float64)
        st = tro.initial_plant_state(tcfg, batch=(3,), dtype=torch.float64,
                                     device="cpu")
        keys = [k for k in FIELDS if getattr(sj, k) is not None]
        _assert_state(st, sj, {k: 1e-12 for k in keys})
        assert st.qp_z.shape == (3, 120) and st.qp_lam.shape == (3, 240)
        assert st.ref_anchor is None and sj.ref_anchor is None
        if sj.kf is not None:
            _assert_state(st, sj, {"x_hat": 1e-12, "p_cov": 1e-12})


def _stance_inputs(B, seed):
    """Perturbed pose, velocity, feet and warm state for stance_mpc."""
    rng = np.random.default_rng(seed)
    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    ori = np.concatenate([0.02 * rng.standard_normal((B, 2)),
                          0.1 * rng.standard_normal((B, 1))], -1)
    v_ori = 0.1 * rng.standard_normal((B, 3))
    v_pos = 0.1 * rng.standard_normal((B, 3))
    arm_l = pos + [0.0, 0.1, -0.65] + 0.02 * rng.standard_normal((B, 3))
    arm_r = pos + [0.0, -0.1, -0.65] + 0.02 * rng.standard_normal((B, 3))
    z_w = 5.0 * rng.standard_normal((B, 120))
    y_w = np.abs(rng.standard_normal((B, 240)))
    anchor = 0.5 * (arm_l + arm_r)
    anchor[:, 2] = 0.65
    v_des = 0.05 * rng.standard_normal((B, 3))
    w_des = 0.05 * rng.standard_normal(B)
    return pos, ori, v_ori, v_pos, arm_l, arm_r, z_w, y_w, anchor, v_des, w_des


def test_stance_mpc_matches_jax_f64():
    """stance_mpc at full width, B = 4 perturbed states, both sides the
    condense + explicit-K^-1 ADMM composition: 1e-9 on the forces (scale
    ~100 N), the residual, the prediction and the warm state."""
    from mpc_limx_control_tpu.core.types import OdomState as JOdom
    from mpc_limx_control_tpu.utils import rotations as jrot
    from mpc_limx_control_tpu_torch.utils import rotations as trot

    B = 4
    (pos, ori, v_ori, v_pos, arm_l, arm_r, z_w, y_w, anchor, v_des,
     w_des) = _stance_inputs(B, 5)
    jcfg, tcfg = JCfg.standing(), TCfg.standing()
    ones = jnp.ones((20,))

    def jfn(pos, ori, v_ori, v_pos, al, ar, zw, yw, anc, vd, wd):
        odom = JOdom(pos=pos, ori=ori, quat=jrot.rpy_to_quat(ori),
                     v_pos=v_pos, v_ori=v_ori)
        return jctrl.stance_mpc(jcfg, odom, al, ar, ones, ones, vd, wd,
                                pos_anchor=anc, qp_warm=(zw, yw))

    grf_j, res_j, xp_j, (z_j, y_j) = jax.vmap(jfn)(*[jnp.asarray(a) for a in (
        pos, ori, v_ori, v_pos, arm_l, arm_r, z_w, y_w, anchor, v_des,
        w_des)])
    T = torch.tensor
    odom = ttypes.OdomState(pos=T(pos), ori=T(ori),
                            quat=trot.rpy_to_quat(T(ori)), v_pos=T(v_pos),
                            v_ori=T(v_ori))
    tones = torch.ones((B, 20), dtype=torch.float64)
    grf_t, res_t, xp_t, (z_t, y_t) = tctrl.stance_mpc(
        tcfg, odom, T(arm_l), T(arm_r), tones, tones, T(v_des), T(w_des),
        pos_anchor=T(anchor), qp_warm=(T(z_w), T(y_w)))
    assert grf_t.shape == (B, 6) and z_t.shape == (B, 120)
    for name, t, j in (("grf", grf_t, grf_j), ("residual", res_t, res_j),
                       ("xi_pred", xp_t, xp_j), ("z", z_t, z_j),
                       ("y", y_t, y_j)):
        _close(t, j, 1e-9, name)
    # without a warm state the same call is the cold PDIP on the condensed
    # QP (parity with JAX: tests/test_torch_linear_mpc.py): no state to
    # thread, both feet pushing up inside their cones
    grf_c, res_c, _, state_c = tctrl.stance_mpc(
        tcfg, odom, T(arm_l), T(arm_r), tones, tones, T(v_des), T(w_des),
        pos_anchor=T(anchor), qp_warm=None)
    assert state_c is None and bool((res_c > 0).all())
    assert bool(torch.isfinite(grf_c).all())
    assert bool((grf_c[:, [2, 5]] > 0).all())
    assert bool((grf_c[:, [0, 1, 3, 4]].abs()
                 <= 0.5 * grf_c[:, [2, 2, 5, 5]] + 1e-6).all())


def test_controller_tick_stand_matches_jax_f64():
    """controller.tick in stand mode: both legs' stance torques, q_cmd =
    the measured joints, kp = 0, and the diagnostics."""
    jcfg, tcfg = JCfg.standing(), TCfg.standing()
    sj = _kicked(jcfg, 4, 3, np.float64)
    its = np.asarray([0.0, 40.0, 299.0, 455.0])

    def jtick_(s, it):
        z = jnp.zeros_like(s.q)
        return jctrl.tick(jcfg, jro._odom_from_xi(s.xi),
                          JJoints(q=s.q, dq=z, tau=z), it,
                          qp_warm=(s.qp_z, s.qp_lam))

    cmd_j, dg_j = jax.vmap(jtick_)(sj, jnp.asarray(its))
    st = _port_state(sj, torch.float64)
    z = torch.zeros_like(st.q)
    cmd_t, dg_t = tctrl.tick(tcfg, tro._odom_from_xi(st.xi),
                             ttypes.JointState(q=st.q, dq=z, tau=z),
                             torch.tensor(its), qp_warm=(st.qp_z, st.qp_lam))
    for f in ("mode", "q", "dq", "tau", "kp", "kd"):
        _close(getattr(cmd_t, f), getattr(cmd_j, f), 1e-9, f)
    assert float(cmd_t.kp.abs().max()) == 0.0
    for f in ("grf", "qp_residual", "foot_target", "swing_q",
              "predicted_xi"):
        _close(getattr(dg_t, f), getattr(dg_j, f), 1e-9, f)
    assert dg_t.ref_anchor is None and dg_j.ref_anchor is None
    assert float(dg_t.grf[:, 2].min()) > 10.0    # both feet carry weight
    assert float(dg_t.grf[:, 5].min()) > 10.0


# ---- make_admm_fused / the fused QP ----------------------------------------

def _qp_inputs(N, nu, B, seed, np_dtype):
    """Ad (the SRBD's plus a dense perturbation: the solver takes any Ad),
    Bd_t, x_ref, x0, warm state, drawn with numpy."""
    rng = np.random.default_rng(seed)
    feet = nu // 3
    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    yaw = 0.1 * rng.standard_normal(B)
    arms = (pos[:, None, None, :] + np.array([0.0, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, N, feet, 3)))
    if feet == 2:
        arms[:, :, 1, 1] -= 0.2
    x0 = np.concatenate([0.01 * rng.standard_normal((B, 2)), yaw[:, None],
                         pos, np.zeros((B, 3)),
                         0.1 * rng.standard_normal((B, 3)),
                         np.full((B, 1), -9.81)], -1)
    jc = JCfg.walking()
    Ac, Bc = jax.vmap(lambda a, p, y: jsrbd.linearize_shared(
        jc.robot, a, p, y, jnp.float64))(
            jnp.asarray(arms.reshape(B, N * feet, 3)), jnp.asarray(pos),
            jnp.asarray(yaw))
    Ad, Bd = jax.vmap(lambda a, b: jsrbd.discretize_srbd(a, b, jc.srbd.ts))(
        Ac, Bc)
    Bd_t = np.asarray(Bd).reshape(B, N, feet, 13, 3).transpose(
        0, 1, 3, 2, 4).reshape(B, N, 13, nu)
    Ad = np.asarray(Ad) + 2e-3 * rng.standard_normal((B, 13, 13))
    x_ref = np.tile(x0[:, None, :], (1, N + 1, 1))
    x_ref[:, :, 0:2] = 0.0
    x_ref[:, :, 3] += 0.3 * jc.srbd.ts * np.arange(N + 1)
    x_ref[:, :, 5] = 0.65
    z_w = 5.0 * rng.standard_normal((B, N * nu))
    y_w = np.abs(rng.standard_normal((B, 2 * N * nu)))
    return [a.astype(np_dtype) for a in (Ad, Bd_t, x_ref, x0, z_w, y_w)]


@pytest.mark.parametrize("nu", [3, 6])
def test_make_admm_fused_plain_matches_jax_f64(nu):
    """The plain version of make_admm_fused (condense + _batched_admm,
    explicit K^-1) against JAX's _xla_batched at full width, both forms."""
    ins = _qp_inputs(20, nu, 3, 30 + nu, np.float64)
    two = nu == 6
    sol_j, (z_j, y_j) = jax.vmap(jfused.make_admm_fused(
        JCfg.walking().srbd, use_pallas=False, two_feet=two))(
            *[jnp.asarray(a) for a in ins])
    sol_t, (z_t, y_t) = tmfc.make_admm_fused(
        TCfg.walking().srbd, two_feet=two)(*[torch.tensor(a) for a in ins])
    _close(z_t, z_j, 1e-9, "z")
    _close(y_t, y_j, 1e-9, "y")
    _close(sol_t.residual, sol_j.residual, 1e-9, "residual")
    assert sol_t.iterations == int(np.asarray(sol_j.iterations).max())
    with pytest.raises(ValueError, match="solve_form"):
        tmfc.make_admm_fused(TCfg.walking().srbd, solve_form="inv")


@pytest.mark.parametrize("nu", [3, 6])
def test_fused_qp_twin_matches_jax_kernel_interpret(nu):
    """The fused_qp kernels' plain twin ("subst": the wrapper's CPU
    branch) against JAX fused_walking_qp in interpret mode at horizon 8,
    B = 3, with a dense Ad: z and y within 2e-3 of the solution scale
    (tests/test_mpc_fused.py:212-235)."""
    N = 8
    ins = _qp_inputs(N, nu, 3, 50 + nu, np.float32)
    two = nu == 6
    jc, tc = _small(JCfg.walking()).srbd, _small(TCfg.walking()).srbd
    solver = jfused.make_admm_fused(jc, use_pallas="interpret", two_feet=two)
    with pltpu.force_tpu_interpret_mode():
        sol_j, (z_j, y_j) = jax.vmap(solver)(*[jnp.asarray(a) for a in ins])
    k = tmfc.cone_constants(tc)
    feet = nu // 3
    consts = dict(
        N=N, iters=k["iters"], rho=k["rho"], alpha=k["alpha"], reg=k["reg"],
        q_diag=k["q_diag"], r_diag=k["r_diag"] * feet, p_diag=k["p_diag"],
        Gu=tuple(map(tuple, np.kron(np.eye(feet), np.asarray(k["Gu"])))),
        h=k["hu"] * feet * N)
    before = tmfc.FUSED_QP[nu].launches
    z_t, y_t, res_t = tmfc.fused_walking_qp(
        *[torch.from_numpy(a) for a in ins], **consts)
    assert tmfc.FUSED_QP[nu].launches == before    # CPU: no launch
    scale = float(np.abs(np.asarray(z_j)).max()) + 1.0
    _close(z_t, z_j, 2e-3 * scale, "z")
    _close(y_t, y_j, 2e-3 * scale, "y")
    _close(res_t, sol_j.residual, 1e-2, "residual")
    # make_admm_fused with "subst" is the same twin
    sol_s, (z_s, _) = tmfc.make_admm_fused(
        tc, two_feet=two, solve_form="subst")(
            *[torch.from_numpy(a) for a in ins])
    assert torch.equal(z_s, z_t) and torch.equal(sol_s.residual, res_t)
    # what the kernel does not apply is refused, not approximated
    bad = dict(consts, h=tuple(np.arange(len(consts["h"]), dtype=float)))
    with pytest.raises(ValueError, match="step"):
        tmfc.fused_walking_qp(*[torch.from_numpy(a) for a in ins], **bad)
    with pytest.raises(ValueError, match="nu = 3 or 6"):
        tmfc.fused_walking_qp(
            torch.zeros(1, 13, 13), torch.zeros(1, N, 13, 4),
            torch.zeros(1, N + 1, 13), torch.zeros(1, 13),
            torch.zeros(1, 4 * N), torch.zeros(1, 8 * N), **consts)


def _inv_form(cfg):
    return dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, solver=dataclasses.replace(cfg.srbd.solver,
                                             solve_form="inv")))


def test_stand_linv_twin_matches_jax_inv_kernel_interpret():
    """fused_qp_nu6_inv's plain twin ("linv", the wrapper's CPU branch of
    a solve_form="inv" two-foot QP where n = 6 N <= 64) against JAX
    make_admm_fused(two_feet=True, use_pallas="interpret") with
    solve_form="inv" at horizon 8 (n = 48), B = 3, with a dense Ad: z and
    y within 2e-3 of the solution scale (the band of the walking "linv"
    case, tests/test_torch_linear_mpc.py:323); within 1e-4 of it from the
    "subst" twin (tests/test_mpc_fused.py:288) and not that twin bit for
    bit."""
    N = 8
    ins = _qp_inputs(N, 6, 3, 57, np.float32)
    jc = _inv_form(_small(JCfg.walking())).srbd
    tc = _inv_form(_small(TCfg.walking())).srbd
    solver = jfused.make_admm_fused(jc, use_pallas="interpret", two_feet=True)
    with pltpu.force_tpu_interpret_mode():
        sol_j, (z_j, y_j) = jax.vmap(solver)(*[jnp.asarray(a) for a in ins])
    tins = [torch.from_numpy(a) for a in ins]
    assert tmfc.plain_solve_form("inv", 6, N) == "linv"
    sol_t, (z_t, y_t) = tmfc.make_admm_fused(tc, two_feet=True,
                                             solve_form="linv")(*tins)
    scale = float(np.abs(np.asarray(z_j)).max()) + 1.0
    _close(z_t, z_j, 2e-3 * scale, "z")
    _close(y_t, y_j, 2e-3 * scale, "y")
    _close(sol_t.residual, sol_j.residual, 1e-2, "residual")
    k = tmfc.cone_constants(tc)
    before = tmfc.FUSED_QP_NU6_INV.launches
    z_w, y_w, res_w = tmfc.fused_walking_qp(
        *tins, N=N, iters=k["iters"], rho=k["rho"], alpha=k["alpha"],
        reg=k["reg"], q_diag=k["q_diag"], r_diag=k["r_diag"] * 2,
        p_diag=k["p_diag"],
        Gu=tuple(map(tuple, np.kron(np.eye(2), np.asarray(k["Gu"])))),
        h=k["hu"] * 2 * N, solve_form="inv")
    assert tmfc.FUSED_QP_NU6_INV.launches == before    # CPU: no launch
    assert torch.equal(z_w, z_t) and torch.equal(y_w, y_t)
    assert torch.equal(res_w, sol_t.residual)
    z_s = tmfc.make_admm_fused(tc, two_feet=True, solve_form="subst")(
        *tins)[1][0]
    _close(z_t, z_s.numpy(), 1e-4 * scale, "z vs subst")
    assert not torch.equal(z_t, z_s)


# ---- the standing tick at full width ----------------------------------------

@pytest.mark.parametrize("est", ["truth", "kf"])
def test_stand_plant_step_ref_matches_jax_f64(est):
    """Five threaded standing ticks at full width (N = 20, n = 120),
    B = 4: 1e-8 after one tick (state, warm QP state, filter, every
    metric; the covariance relative to its scale 100 I as in
    tests/test_torch_kf.py), 1e-6 after five."""
    jcfg, tcfg = JCfg.standing(), TCfg.standing()
    if est == "kf":
        jcfg, tcfg = _kf(jcfg), _kf(tcfg)
    P0 = jcfg.estimator.initial_covariance
    sj = _kicked(jcfg, 4, 0, np.float64)
    st = _port_state(sj, torch.float64)
    its = np.asarray([0.0, 40.0, 299.0, 455.0])
    keys = [k for k in FIELDS if getattr(sj, k) is not None]
    for j in range(5):
        sj, mj = jax.vmap(lambda s, it: jro._plant_step_ref(jcfg, s, it))(
            sj, jnp.asarray(its + j))
        st, mt = tro._plant_step_ref(tcfg, st, torch.tensor(its + j))
        if j == 0:
            _assert_state(st, sj, {k: 1e-8 for k in keys})
            assert set(mt) == set(mj)
            for k, v in mt.items():
                _close(v, mj[k], 1e-8 * (P0 if "cov" in k else 1), k)
            if est == "kf":
                _assert_state(st, sj, {"x_hat": 1e-8, "p_cov": 1e-8 * P0})
    _assert_state(st, sj, {k: 1e-6 for k in keys})
    if est == "kf":
        _assert_state(st, sj, {"x_hat": 1e-6, "p_cov": 1e-6})
        assert float(mt["est_error"].max()) > 0.0
    assert st.ref_anchor is None
    # the feet never move while standing
    assert torch.equal(st.foot_l, _port_state(sj, torch.float64).foot_l)


def test_stand_plant_step_ref_n30_matches_jax_f64():
    """The standing tick past the 21 steps the core once took: N = 30
    (n = 180, what the standing kernels run with eight solve rows a lane),
    B = 3, two threaded full-width ticks against JAX _plant_step_ref in
    float64, 1e-8 on the state, the warm QP state and every metric."""
    def n30(c):
        return dataclasses.replace(c, srbd=dataclasses.replace(c.srbd,
                                                               horizon=30))

    jcfg, tcfg = n30(JCfg.standing()), n30(TCfg.standing())
    assert ttfc.supports_fused_tick(tcfg)
    sj = _kicked(jcfg, 3, 5, np.float64)
    st = _port_state(sj, torch.float64)
    its = np.asarray([0.0, 150.0, 299.0])
    keys = [k for k in FIELDS if getattr(sj, k) is not None]
    for j in range(2):
        sj, mj = jax.vmap(lambda s, it: jro._plant_step_ref(jcfg, s, it))(
            sj, jnp.asarray(its + j))
        st, mt = tro._plant_step_ref(tcfg, st, torch.tensor(its + j))
        _assert_state(st, sj, {k: 1e-8 for k in keys})
        for k, v in mt.items():
            _close(v, mj[k], 1e-8, k)
    assert st.qp_z.shape == (3, 180) and st.qp_lam.shape == (3, 360)


def test_core_layout_fits_the_blocks_an_sm(monkeypatch):
    """The Python mirror of the MPC core's shared-memory layout
    (mpc_fused_cuda.smem_bytes): at N = 20 the standing solving forms fit
    at least five blocks in an SM's 233,472 bytes with 1 KB reserved a
    block, fused_qp_nu6 at least four, and the walking solving forms and
    the prep kernel (the nu = 3 core, packed K and S_k instead of the N
    Gramians) at least ten; an ``_inv`` entry adds the packed factor
    inverse where n <= 64 (nine blocks of the ``inv`` ticks) and nothing
    beyond; every horizon the kernels take fits a block (walking
    1 to 85, standing 1 to 42); the refusals name the horizon and the
    shared-memory limits."""
    def per_sm(entry):
        return 233472 // (tmfc.smem_bytes(entry, 20) + 1024)

    assert min(per_sm("standing_tick"), per_sm("standing_tick_kf")) >= 5
    assert per_sm("fused_qp_nu6") >= 4
    assert min(per_sm(e) for e in ("walking_tick", "walking_tick_kf",
                                   "walking_mpc_prep")) >= 10
    assert min(per_sm("walking_tick_inv"), per_sm("walking_tick_kf_inv")) >= 9
    assert tmfc.smem_bytes("standing_tick", 20) == 37456
    assert tmfc.smem_bytes("standing_tick_kf", 20) == 37456
    assert tmfc.smem_bytes("fused_qp_nu6", 20) == 45156
    for entry, now in (("walking_mpc_prep", 15400), ("walking_tick", 15464),
                       ("walking_tick_kf", 15464), ("fused_qp_nu3", 16956)):
        assert tmfc.smem_bytes(entry, 20) == now, entry
        # the factor inverse, 60 x 61 / 2 floats, up to n = 64 only
        assert tmfc.smem_bytes(entry + "_inv", 20) == now + 4 * 1830
        assert (tmfc.smem_bytes(entry + "_inv", 22)
                == tmfc.smem_bytes(entry, 22))
    for entry in tmfc.MPC_ENTRIES:
        top = tmfc.max_horizon(tmfc.entry_nu(entry))
        assert top == (42 if tmfc.entry_nu(entry) == 6 else 85)
        for N in range(1, top + 1):
            assert tmfc.size_reason(entry, N) is None, (entry, N)
        assert f"1 to {top} steps" in tmfc.size_reason(entry, top + 1)
        assert "steps" in tmfc.size_reason(entry, 0)
    # the wrapper refuses what the kernel does not take, on any device
    ins = [torch.zeros(1, 13, 13), torch.zeros(1, 43, 13, 6),
           torch.zeros(1, 44, 13), torch.zeros(1, 13),
           torch.zeros(1, 258), torch.zeros(1, 516)]
    k = tmfc.cone_constants(TCfg.standing().srbd)
    consts = dict(
        N=43, iters=k["iters"], rho=k["rho"], alpha=k["alpha"], reg=k["reg"],
        q_diag=k["q_diag"], r_diag=k["r_diag"] * 2, p_diag=k["p_diag"],
        Gu=tuple(map(tuple, np.kron(np.eye(2), np.asarray(k["Gu"])))),
        h=k["hu"] * 2 * 43)
    with pytest.raises(ValueError, match="1 to 42 steps"):
        tmfc.fused_walking_qp(*ins, **consts)
    # a layout past a block's shared memory is refused, naming the limit
    monkeypatch.setattr(tmfc, "SMEM_LIMIT_BYTES", 40000)
    assert tmfc.size_reason("standing_tick", 20) is None
    assert "40000" in tmfc.size_reason("fused_qp_nu6", 20)
    n22 = dataclasses.replace(TCfg.standing(), srbd=dataclasses.replace(
        TCfg.standing().srbd, horizon=22))
    assert "40000" in ttfc.kernel_refusal(n22)
    with pytest.raises(NotImplementedError, match="40000"):
        tro.tick_route(n22)


@pytest.mark.parametrize("est", ["truth", "kf"])
def test_stand_tick_twin_solve_then_hold_matches_jax_kernel_interpret(est):
    """The plain twins of standing_tick{,_kf} (solve) then
    standing_tick{_hold,_kf_hold} (held force) against the JAX fused tick
    in interpret mode at horizon 8, B = 2, over a solve and two held
    ticks: xi 5e-4, q 1e-3, grf 2e-1, x_hat 5e-4, p_cov 5e-4
    (tests/test_tick_fused.py:436-448), held residual == 0."""
    _stand_twin_vs_jax_kernel(_small(JCfg.standing()),
                              _small(TCfg.standing()), est == "kf")


def test_stand_kf_inv_twin_solve_then_hold_matches_jax_kernel_interpret():
    """The standing KF dtMPC block with solve_form="inv" at horizon 8
    (n = 48 <= 64: the factor inverse on both sides): the plain twin of
    standing_tick_kf_inv (the "linv" tick) then standing_tick_kf_hold
    against the JAX fused tick in interpret mode, with the bands of the
    "subst" case above."""
    jcfg = _inv_form(_small(JCfg.standing()))
    tcfg = _inv_form(_small(TCfg.standing()))
    assert tro.tick_route(_kf(tcfg)).solve.name == "standing_tick_kf_inv"
    _stand_twin_vs_jax_kernel(jcfg, tcfg, True)


def test_stand_twin_hold_across_a_phase_switch_matches_jax_interpret():
    """The plain twins of standing_tick (solve) then standing_tick_hold
    against the JAX fused tick in interpret mode at horizon 8, B = 3, over
    a solve and four held ticks that cross the standing gait's phase
    switch at iteration 500 (a 1 s cycle: the placement target reported
    changes feet; the force pair is held as given), with the bands of the
    solve-then-hold test above."""
    _stand_twin_vs_jax_kernel(_small(JCfg.standing()),
                              _small(TCfg.standing()), False,
                              its=(496.0, 497.0, 499.0), ticks=5)


def _stand_twin_vs_jax_kernel(jcfg, tcfg, kf, its=(5.0, 320.0), ticks=3):
    if kf:
        jcfg, tcfg = _kf(jcfg), _kf(tcfg)
    B = len(its)
    s0 = jro.initial_plant_state(jcfg, batch=(B,))
    rng = np.random.default_rng(13)
    xi = np.asarray(s0.xi).copy()
    xi[:, 10] += 0.05 * rng.standard_normal(B)
    sj = s0.replace(xi=jnp.asarray(xi))
    st = _port_state(sj, torch.float32)
    its = np.asarray(its, np.float32)
    vd = jnp.zeros((B, 3), jnp.float32)
    wd = jnp.zeros((B,), jnp.float32)
    steps = {h: jtick.make_tick_fused(jcfg, use_pallas="interpret", hold=h)
             for h in (False, True)}
    held_j = held_t = None
    for j in range(ticks):
        hold = j > 0
        anc_j = jnp.concatenate([sj.xi[:, 3:5], sj.xi[:, 2:3]], -1)
        args = [sj.xi, sj.q, sj.foot_l, sj.foot_r, sj.qp_z, sj.qp_lam,
                anc_j, jnp.asarray(its + j), vd, wd]
        args += [held_j] if hold else []
        args += [sj.kf.x_hat, sj.kf.p_cov, sj.prev_v, sj.prev_q] if kf else []
        with pltpu.force_tpu_interpret_mode():
            outs = jax.vmap(steps[hold])(*args)
        (xi_j, q_j, fl_j, fr_j, z_j, y_j, _, res_j, grf_j, tgt_j,
         *kf_j) = outs
        rep = dict(xi=xi_j, q=q_j, foot_l=fl_j, foot_r=fr_j, qp_z=z_j,
                   qp_lam=y_j)
        if kf:
            rep.update(kf=sj.kf.replace(x_hat=kf_j[0], p_cov=kf_j[1]),
                       prev_v=sj.xi[:, 9:12], prev_q=sj.q)
        sj = sj.replace(**rep)

        z_in = st.qp_z
        anc_t = torch.cat([st.xi[:, 3:5], st.xi[:, 2:3]], -1)
        kf_args = dict(kf_x=st.kf.x_hat, kf_p=st.kf.p_cov,
                       prev_v=st.prev_v, prev_q=st.prev_q) if kf else {}
        outs_t = ttfc.fused_walking_tick(
            st.xi, st.q, st.foot_l, st.foot_r, st.qp_z, st.qp_lam, anc_t,
            torch.from_numpy(its + j), torch.zeros(B, 3), torch.zeros(B),
            grf_held=held_t if hold else None, cfg=tcfg, **kf_args)
        rep_t = dict(xi=outs_t[0], q=outs_t[1], foot_l=outs_t[2],
                     foot_r=outs_t[3], qp_z=outs_t[4], qp_lam=outs_t[5])
        if kf:
            rep_t.update(kf=ttypes.KFState(x_hat=outs_t[10],
                                           p_cov=outs_t[11]),
                         prev_v=st.xi[:, 9:12], prev_q=st.q)
        st = st.replace(**rep_t)
        _close(outs_t[8], grf_j, 2e-1, f"grf tick {j}")
        _close(outs_t[9], tgt_j, 1e-4, f"foot_target tick {j}")
        if hold:
            assert float(outs_t[7].abs().max()) == 0.0
            assert float(np.abs(np.asarray(res_j)).max()) == 0.0
            assert outs_t[4] is z_in        # the warm state passes through
            assert torch.equal(outs_t[8], held_t)   # the force as given
        else:
            held_j, held_t = grf_j, outs_t[8]
    tols = {"xi": 5e-4, "q": 1e-3, "foot_l": 0.0, "foot_r": 0.0,
            "qp_z": 2e-1}
    if kf:
        tols.update(x_hat=5e-4, p_cov=5e-4)
    _assert_state(st, sj, tols)


# ---- the closed loop, the held force, dispatch ------------------------------

def test_standing_closed_loop_cpu_holds_height():
    """bench.py's stand gate (:153-161), shortened to 400 ticks on the
    CPU: a 0.05 m/s lateral kick, the height stays within 0.01 of 0.65 at
    every tick and the velocity decays; then the dtMPC schedule holds it
    too, with a residual on the solve ticks only."""
    cfg = TCfg.standing()
    s = tro.initial_plant_state(cfg, device="cpu")
    s = s.replace(xi=s.xi + torch.tensor([0.0] * 10 + [0.05, 0.0, 0.0]))
    f, m = tro.rollout(cfg, s, 400)
    h = m["height"]
    assert bool(torch.isfinite(h).all())
    assert float((h - 0.65).abs().max()) < 0.01
    assert abs(float(h[-100:].mean()) - 0.65) < 0.005
    assert float(m["velocity"][-50:, 1].abs().max()) < 0.02
    assert torch.equal(f.foot_l, s.foot_l) and f.ref_anchor is None
    f5, m5 = tro.rollout(cfg, s, 50, mpc_every=5)
    res = m5["qp_residual"].view(10, 5)
    assert bool((res[:, 0] > 0).all()) and float(res[:, 1:].abs().max()) == 0
    assert float((m5["height"] - 0.65).abs().max()) < 0.01


def test_stand_grf_override_tick():
    """The held-force standing tick: the force pair is applied as given
    (no stance-foot reassignment), the residual is exactly 0 and the warm
    QP state passes through untouched -- against JAX in float64."""
    jcfg, tcfg = JCfg.standing(), TCfg.standing()
    sj = _kicked(jcfg, 3, 8, np.float64)
    grf = np.abs(np.random.default_rng(2).standard_normal((3, 6))) * 40.0
    its = np.asarray([3.0, 299.0, 456.0])
    sj2, mj = jax.vmap(lambda s, it, g: jro._plant_step_ref(
        jcfg, s, it, grf_override=g))(sj, jnp.asarray(its), jnp.asarray(grf))
    st = _port_state(sj, torch.float64)
    st2, mt = tro.plant_step(tcfg, st, torch.tensor(its),
                             grf_override=torch.tensor(grf))
    _assert_state(st2, sj2, {k: 1e-10 for k in ("xi", "q", "foot_l",
                                                "foot_r")})
    assert torch.equal(mt["grf"], torch.tensor(grf))
    assert float(mt["qp_residual"].abs().max()) == 0.0
    assert st2.qp_z is st.qp_z and st2.qp_lam is st.qp_lam
    _close(mt["foot_target"], mj["foot_target"], 1e-10, "foot_target")


@pytest.mark.parametrize("est", ["truth", "kf"])
def test_convert_round_trips_standing_state(est):
    jcfg = _kf(JCfg.standing()) if est == "kf" else JCfg.standing()
    sj = _kicked(jcfg, 2, 7, np.float32)
    st = _port_state(sj, torch.float32)
    assert st.qp_z.shape == (2, 120) and st.qp_lam.shape == (2, 240)
    assert st.ref_anchor is None and (st.kf is not None) == (est == "kf")
    keys = [k for k in FIELDS if getattr(sj, k) is not None]
    _assert_state(st, sj, {k: 0.0 for k in keys})
    back = convert.plant_state_to_numpy(st)
    assert "ref_anchor" not in back and back["qp_lam"].shape == (2, 240)
    np.testing.assert_array_equal(back["xi"], np.asarray(sj.xi))
    if est == "kf":
        _assert_state(st, sj, {"x_hat": 0.0, "p_cov": 0.0})
        np.testing.assert_array_equal(back["kf"]["p_cov"],
                                      np.asarray(sj.kf.p_cov))
    cfg2 = convert.config_from_dict(jcfg)
    assert cfg2.mode == "stand" and ttfc.supports_fused_tick(cfg2)


def test_state_entry_points_default_to_the_card():
    """initial_plant_state, plant_state_from_numpy and KFState.initial
    create their tensors on the card unless told otherwise: without a card
    they raise torch's own error instead of carrying on on the CPU, and
    device="cpu" runs anywhere."""
    cfg = _kf(TCfg.standing())
    cpu = tro.initial_plant_state(cfg, batch=(2,), device="cpu")
    assert cpu.xi.device.type == "cpu" and cpu.kf.p_cov.device.type == "cpu"
    d = convert.plant_state_to_numpy(cpu)
    calls = (lambda **kw: tro.initial_plant_state(cfg, **kw).xi,
             lambda **kw: convert.plant_state_from_numpy(d, **kw).xi,
             lambda **kw: ttypes.KFState.initial((2,), **kw).x_hat)
    for call in calls:
        assert call(device="cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()


def test_stand_wrapper_dispatch_and_refusals():
    """CPU tensors run the plain standing tick and count no launch; the
    kernel set follows the mode; what the tick kernels refuse runs as the
    composition, and an unknown value raises."""
    cfg = TCfg.standing()
    route = tro.tick_route(cfg)
    assert (route.path, route.solve.name, route.hold.name) == (
        "kernel", "standing_tick", "standing_tick_hold")
    assert tro.tick_route(TCfg.walking()).solve.name == "walking_tick"
    stand_kernels = {k for key, k in ttfc.TICK_TABLE.items()
                     if key[0] == "stand" and key[3] == "subst"}
    assert sorted(k.name for k in stand_kernels) == [
        "standing_tick", "standing_tick_hold", "standing_tick_kf",
        "standing_tick_kf_hold"]
    kernels = (*stand_kernels, *tmfc.FUSED_QP.values())
    before = [k.launches for k in kernels]
    s = tro.initial_plant_state(cfg, batch=(2,), device="cpu")
    s2, m = tro.plant_step(cfg, s, torch.zeros(2))
    tro.plant_step(cfg, s, torch.zeros(2), grf_override=m["grf"])
    assert [k.launches for k in kernels] == before
    assert ttfc.tick_params(cfg).mpc.N == 20
    assert list(ttfc.tick_params(cfg).mpc.hu)[4::6] == [400.0, 400.0]
    ric = dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, solver=dataclasses.replace(cfg.srbd.solver,
                                             method="riccati")))
    # the iterative IK and the Riccati solver are ported: the tick kernels
    # refuse them, the composition runs them (standing "riccati" is the
    # cold PDIP of stance_mpc, as in JAX)
    for other, said in (
            (dataclasses.replace(cfg, ik_method="log6"),
             "the tick kernels run the analytic IK (got ik_method='log6')"),
            (ric, "only the warm admm_fused solver runs in the tick kernel "
                  "(got method='riccati', qp_warm_start=True)")):
        assert tro.tick_route(other) == tro.TickRoute("composition")
        assert ttfc.kernel_refusal(other) == said
        _, mo = tro.plant_step(other, tro.initial_plant_state(
            other, batch=(1,), device="cpu"), torch.zeros(1))
        assert bool(torch.isfinite(mo["grf"]).all())
    # a cold standing config is the cold PDIP, not a refusal
    cold = dataclasses.replace(cfg, qp_warm_start=False)
    assert tro.tick_route(cold) == tro.TickRoute("composition")
    assert ttfc.kernel_refusal(cold) == (
        "only the warm admm_fused solver runs in the tick kernel (got "
        "method='admm_fused', qp_warm_start=False)")
    _, mc = tro.plant_step(cold, tro.initial_plant_state(
        cold, batch=(1,), device="cpu"), torch.zeros(1))
    assert bool(torch.isfinite(mc["grf"]).all())
    # solve_form="inv" takes the inv entries, which at n = 120 > 64 run
    # the substitution sweeps (so the plain twin is "subst")
    inv = dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, solver=dataclasses.replace(cfg.srbd.solver,
                                             solve_form="inv")))
    assert tro._kernel_state_reason(inv, s) is None
    route = tro.tick_route(inv)
    assert (route.path, route.solve.name, route.hold.name) == (
        "kernel", "standing_tick_inv", "standing_tick_hold")
    assert route.hold is tro.tick_route(cfg).hold
    assert tmfc.plain_solve_form("inv", 6, 20) == "subst"
    with pytest.raises(ValueError, match="estimator_mode"):
        ttfc.fused_walking_tick(
            s.xi, s.q, s.foot_l, s.foot_r, s.qp_z, s.qp_lam,
            torch.zeros(2, 3), torch.zeros(2), torch.zeros(2, 3),
            torch.zeros(2), cfg=_kf(cfg))
