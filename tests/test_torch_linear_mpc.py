"""The general-solver paths of the PyTorch port against the JAX package,
on the CPU: the double-integrator linear MPC closed loop, the controller's
cold / warm PDIP and dense-ADMM branches at the full width of the walking
and standing configurations, and the ``solve_form="inv"`` twin against the
JAX fused kernel in interpret mode.

Inputs are drawn with numpy from a seed and handed to both packages; every
port state is created with ``device="cpu"``. Tolerances are stated per
test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpc_limx_control_tpu.control import controller as jctrl
from mpc_limx_control_tpu.control import linear_mpc as jlin
from mpc_limx_control_tpu.control import rollout as jro
from mpc_limx_control_tpu.core.config import ControllerConfig as JCfg
from mpc_limx_control_tpu.core.config import MPCConfig as JMPC
from mpc_limx_control_tpu.core.config import SolverConfig as JSolver
from mpc_limx_control_tpu.core.types import OdomState as JOdom
from mpc_limx_control_tpu.models import double_integrator as jdi
from mpc_limx_control_tpu.ops import mpc_fused_pallas as jfused
from mpc_limx_control_tpu.oracle import pipeline as oracle
from mpc_limx_control_tpu.utils import rotations as jrot
from mpc_limx_control_tpu_torch.control import controller as tctrl
from mpc_limx_control_tpu_torch.control import linear_mpc as tlin
from mpc_limx_control_tpu_torch.control import rollout as tro
from mpc_limx_control_tpu_torch.core import types as ttypes
from mpc_limx_control_tpu_torch.core.config import ControllerConfig as TCfg
from mpc_limx_control_tpu_torch.core.config import MPCConfig as TMPC
from mpc_limx_control_tpu_torch.core.config import SolverConfig as TSolver
from mpc_limx_control_tpu_torch.models import double_integrator as tdi
from mpc_limx_control_tpu_torch.ops import chol_cuda
from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as tmfc
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as ttfc
from mpc_limx_control_tpu_torch.utils import convert
from mpc_limx_control_tpu_torch.utils import rotations as trot

STEPS = 120
X0S = np.asarray([[2.0, 0.0, 0.0, 0.0], [1.5, 0.2, 0.5, -0.1],
                  [2.5, -0.3, -0.5, 0.2], [0.0, 0.0, 0.0, 0.0]])
FIELDS = ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam", "ref_anchor")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solvers here are host loops over thousands of LAPACK calls on
    small matrices: with several test workers on one machine a
    multi-threaded BLAS oversubscribes the cores and each call spins (a
    120-step closed loop went from 6 s alone to 18 minutes beside five
    other workers). One thread per worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t, j, atol, msg=""):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor)
                               else np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0, err_msg=msg)


# ---- the double-integrator linear MPC --------------------------------------

def test_double_integrator_model_matches_jax():
    for a, b in zip(tdi.continuous_matrices(torch.float64, "cpu"),
                    jdi.continuous_matrices(jnp.float64)):
        close(a, b, 0.0)
    close(tdi.circle_reference(7.0, 0.01, 15, dtype=torch.float64),
          jdi.circle_reference(7.0, 0.01, 15, dtype=jnp.float64), 1e-14)


def test_linear_mpc_setup_matches_jax_f64():
    pj = jlin.setup(JMPC(), dtype=jnp.float64)
    pt = tlin.setup(TMPC(), dtype=torch.float64, device="cpu")
    close(pt.Ad, pj.Ad, 1e-12)
    close(pt.Bd, pj.Bd, 1e-12)
    for k in ("A_blocks", "B_mat", "QB", "H", "G"):
        close(getattr(pt.cache, k), getattr(pj.cache, k), 1e-10, k)
    assert pt.cache.H.shape == (30, 30) and pt.cache.G.shape == (180, 30)
    # both packages can start from the same matrices
    pt2 = convert.linear_mpc_params_from_numpy(
        TMPC(), np.asarray(pj.Ad), np.asarray(pj.Bd), device="cpu")
    close(pt2.cache.H, pj.cache.H, 1e-12)
    assert pt2.Ad.dtype == torch.float64


@pytest.mark.parametrize("twins", [False, True], ids=["linalg", "twins"])
def test_linear_mpc_closed_loop_matches_jax_f64(twins):
    """120 closed-loop steps, 30 Newton steps per solve, from the same
    discrete matrices: controls, states, errors and residuals within 1e-8
    of JAX, batched (scenario 0 is the reference's run)."""
    jcfg = JMPC(solver=JSolver(iters=30))
    tcfg = TMPC(solver=TSolver(iters=30))
    pj = jlin.setup(jcfg, dtype=jnp.float64)
    pt = convert.linear_mpc_params_from_numpy(
        tcfg, np.asarray(pj.Ad), np.asarray(pj.Bd), device="cpu")
    rj = jax.jit(lambda xs: jlin.batched_closed_loop(jcfg, pj, xs, STEPS))(
        jnp.asarray(X0S))
    rt = tlin.batched_closed_loop(tcfg, pt, torch.tensor(X0S), STEPS,
                                  plain_twins=twins)
    for k in ("states", "controls", "errors", "residuals"):
        close(rt[k], rj[k], 1e-8, k)
    assert rt["states"].shape == (4, STEPS + 1, 4)
    assert float(rt["controls"].abs().max()) <= 8.0 + 1e-4
    one = tlin.closed_loop(tcfg, pt, torch.tensor(X0S[0]), 10,
                           plain_twins=twins)
    assert one["controls"].shape == (10, 2)
    close(one["controls"], rj["controls"][0, :10], 1e-8)


def test_linear_mpc_closed_loop_f32_within_oracle_budget():
    """tests/test_closed_loop.py:41-53 in the port: f32, 25 Newton steps,
    controls and tracking errors within 1e-3 of the f64 oracle pipeline;
    every scenario tracks and respects the input box."""
    ref = oracle.run_closed_loop(steps=STEPS)
    cfg = TMPC(solver=TSolver(iters=25))
    params = tlin.setup(cfg, dtype=torch.float32, device="cpu")
    run = tlin.batched_closed_loop(
        cfg, params, torch.tensor(X0S, dtype=torch.float32), STEPS)
    u_err = np.max(np.abs(run["controls"][0].numpy() - ref["controls"]))
    e_err = np.max(np.abs(run["errors"][0].numpy() - ref["errors"]))
    assert u_err < 1e-3, u_err
    assert e_err < 1e-3, e_err
    errors = run["errors"].numpy()
    final, early = errors[:, -20:].mean(1), errors[:, 5:25].mean(1)
    assert (final < 0.2).all() and (final <= early + 1e-3).all()
    assert float(run["controls"].abs().max()) <= 8.0 + 1e-4
    assert all(k.launches == 0 for k in chol_cuda.KERNELS.values())


def test_linear_mpc_without_state_rows_f64():
    jcfg = JMPC(use_state_constraints=False, solver=JSolver(iters=20))
    tcfg = TMPC(use_state_constraints=False, solver=TSolver(iters=20))
    pj = jlin.setup(jcfg, dtype=jnp.float64)
    pt = convert.linear_mpc_params_from_numpy(
        tcfg, np.asarray(pj.Ad), np.asarray(pj.Bd), device="cpu")
    u_j, sol_j = jlin.solve_tick(jcfg, pj, jnp.asarray(X0S[1]),
                                 jnp.asarray(3.0))
    u_t, sol_t = tlin.solve_tick(tcfg, pt, torch.tensor(X0S[1]), 3.0)
    assert pt.cache.G.shape == (60, 30) and u_t.shape == (2,)
    close(u_t, u_j, 1e-9)
    close(sol_t.residual, sol_j.residual, 1e-9)


# ---- the controller's general-solver branches -------------------------------

def _variant(cfg, method, warm):
    """The config with SolverConfig(method=...) cold or warm; the dense
    ADMM with the JAX suite's cold settings (tests/test_config_variants.py
    :43-53: rho 0.1)."""
    s = dataclasses.replace(cfg.srbd.solver, method=method)
    if method == "admm":
        s = dataclasses.replace(s, admm_rho=0.1)
    return dataclasses.replace(cfg, qp_warm_start=warm,
                               srbd=dataclasses.replace(cfg.srbd, solver=s))


def _perturbed(jcfg, B, seed):
    s0 = jro.initial_plant_state(jcfg, batch=(B,), dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    xi = np.asarray(s0.xi).copy()
    xi[:, 9] += 0.08 * rng.standard_normal(B)
    xi[:, 10] += 0.05 * rng.standard_normal(B)
    if jcfg.mode == "walk":
        xi[:, 2] += 0.1 * rng.standard_normal(B)
    return s0.replace(xi=jnp.asarray(xi))


def _port_state(sj):
    d = {k: np.asarray(getattr(sj, k)) for k in FIELDS
         if getattr(sj, k) is not None}
    return convert.plant_state_from_numpy(d, dtype=torch.float64,
                                          device="cpu")


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("method", ["pdip", "admm"])
@pytest.mark.parametrize("mode", ["walk", "stand"])
def test_general_solver_tick_matches_jax_f64(mode, method, warm):
    """One full-width tick of _plant_step_ref (N = 20; n = 60 / m = 120
    walking, n = 120 / m = 240 standing), B = 3 perturbed states at
    staggered gait phases, then a second tick threaded on the first's warm
    state: state, warm state and metrics within 1e-8 of JAX."""
    jbase = JCfg.walking() if mode == "walk" else JCfg.standing()
    jcfg = _variant(jbase, method, warm)
    tcfg = convert.config_from_dict(jcfg)
    assert tro.tick_route(tcfg) == tro.TickRoute("composition")
    sj = _perturbed(jcfg, 3, 11)
    st = _port_state(sj)
    its = np.asarray([0.0, 299.0, 455.0])
    step = jax.jit(jax.vmap(lambda s, it: jro._plant_step_ref(jcfg, s, it)))
    for j in range(2):
        sj, mj = step(sj, jnp.asarray(its + j))
        st, mt = tro.plant_step(tcfg, st, torch.tensor(its + j))
    for k in FIELDS:
        if getattr(sj, k) is None:
            assert getattr(st, k) is None, k
        else:
            close(getattr(st, k), getattr(sj, k), 1e-8, k)
    for k, v in mt.items():
        close(v, mj[k], 1e-8, k)
    assert bool((mt["qp_residual"] > 0).all())


def test_default_config_is_a_cold_pdip_and_runs():
    """ControllerConfig() -- cold 20-step PDIP, no warm state -- and its
    stand-mode twin run in the port and match JAX in f64 (1e-8)."""
    for mode in ("walk", "stand"):
        jcfg = dataclasses.replace(JCfg(), mode=mode)
        tcfg = convert.config_from_dict(jcfg)
        assert tcfg.srbd.solver.method == "pdip" and not tcfg.qp_warm_start
        assert tro.tick_route(tcfg) == tro.TickRoute("composition")
        assert not ttfc.supports_fused_tick(tcfg)
        sj = _perturbed(jcfg, 2, 5)
        st = _port_state(sj)
        assert st.qp_z is None and st.qp_lam is None
        its = np.asarray([3.0, 510.0])
        sj2, mj = jax.vmap(lambda s, it: jro._plant_step_ref(jcfg, s, it))(
            sj, jnp.asarray(its))
        st2, mt = tro.plant_step(tcfg, st, torch.tensor(its))
        close(st2.xi, sj2.xi, 1e-8, mode)
        close(mt["grf"], mj["grf"], 1e-8, mode)
        assert st2.qp_z is None


def test_stance_mpc_cold_pdip_with_gated_schedule_f64():
    """stance_mpc's cold PDIP branch with a schedule that lifts the right
    foot half-way through the horizon (the gated cone bounds force its
    force to zero there): forces, residual and prediction within 1e-8."""
    B, N = 3, 20
    rng = np.random.default_rng(21)
    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    ori = 0.02 * rng.standard_normal((B, 3))
    v_pos, v_ori = (0.05 * rng.standard_normal((B, 3)) for _ in range(2))
    arm_l = pos + np.array([0.0, 0.1, -0.65])
    arm_r = pos + np.array([0.0, -0.1, -0.65])
    on_l = np.ones((B, N))
    on_r = np.concatenate([np.ones((B, N // 2)), np.zeros((B, N // 2))], -1)
    v_des = 0.05 * rng.standard_normal((B, 3))
    w_des = 0.05 * rng.standard_normal(B)
    jcfg = _variant(JCfg.standing(), "pdip", False)
    tcfg = convert.config_from_dict(jcfg)

    def jfn(pos, ori, v_ori, v_pos, al, ar, ol, orr, vd, wd):
        odom = JOdom(pos=pos, ori=ori, quat=jrot.rpy_to_quat(ori),
                     v_pos=v_pos, v_ori=v_ori)
        return jctrl.stance_mpc(jcfg, odom, al, ar, ol, orr, vd, wd)[:3]

    grf_j, res_j, xp_j = jax.vmap(jfn)(*[jnp.asarray(a) for a in (
        pos, ori, v_ori, v_pos, arm_l, arm_r, on_l, on_r, v_des, w_des)])
    T = torch.tensor
    odom = ttypes.OdomState(pos=T(pos), ori=T(ori),
                            quat=trot.rpy_to_quat(T(ori)), v_pos=T(v_pos),
                            v_ori=T(v_ori))
    grf_t, res_t, xp_t, state = tctrl.stance_mpc(
        tcfg, odom, T(arm_l), T(arm_r), T(on_l), T(on_r), T(v_des), T(w_des))
    assert state is None
    close(grf_t, grf_j, 1e-8)
    close(res_t, res_j, 1e-8)
    close(xp_t, xp_j, 1e-8)
    close(tctrl._cone_bounds(tcfg, T(on_l), T(on_r)),
          jax.vmap(lambda a, b: jctrl._cone_bounds(jcfg, a, b, jnp.float64))(
              jnp.asarray(on_l), jnp.asarray(on_r)), 0.0)
    close(tctrl._cone_rows(tcfg, torch.float64, "cpu"),
          jctrl._cone_rows(jcfg, jnp.float64), 0.0)


def test_general_solver_walking_closed_loop_cpu_stays_upright():
    """120 CPU ticks of walking with the warm PDIP (12 Newton steps, the
    variant of tests/test_config_variants.py:66-75), f32, B = 2: finite,
    the height held, no kernel launched."""
    cfg = convert.config_from_dict(dataclasses.replace(
        _variant(JCfg.walking(), "pdip", True)))
    cfg = dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, solver=dataclasses.replace(cfg.srbd.solver,
                                             warm_iters=12)))
    s = tro.initial_plant_state(cfg, batch=(2,), device="cpu")
    assert float(s.qp_lam.min()) == 1.0
    _, m = tro.batched_rollout(cfg, s, 120)
    assert bool(torch.isfinite(m["height"]).all())
    assert float(m["height"].min()) > 0.6
    assert all(k.launches == 0 for k in chol_cuda.KERNELS.values())


# ---- solve_form="inv": the "linv" twin vs the JAX kernel --------------------

def _small_inv(cfg):
    return dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, horizon=8, solver=dataclasses.replace(
            cfg.srbd.solver, solve_form="inv")))


def _prep_ins(B, N, seed):
    """numpy-seeded f32 inputs of the walking prep QP: perturbed poses, arms
    under the hips, commands, a warm state and the anchor."""
    rng = np.random.default_rng(seed)
    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    yaw = 0.1 * rng.standard_normal(B)
    arms = (pos[:, None, :] + np.array([0.02, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, N, 3)))
    x0 = np.concatenate([0.01 * rng.standard_normal((B, 2)), yaw[:, None],
                         pos, np.zeros((B, 3)),
                         np.array([0.4, 0, 0]) + np.zeros((B, 3)),
                         np.full((B, 1), -9.81)], -1)
    v_des = np.tile([0.5, 0.0, 0.0], (B, 1))
    w = 0.05 * rng.standard_normal(B)
    z_w = 5.0 * rng.standard_normal((B, 3 * N))
    y_w = np.abs(rng.standard_normal((B, 6 * N)))
    anc = np.concatenate([x0[:, 3:5], x0[:, 2:3]], -1)
    return [a.astype(np.float32) for a in (arms, x0, v_des, w, z_w, y_w,
                                           anc)]


def test_linv_twin_matches_jax_inv_kernel_interpret():
    """walking_mpc_prep_inv's plain twin ("linv") against JAX
    make_walking_fused(use_pallas="interpret") with solve_form="inv" at
    horizon 8, B = 3: the bands of the "subst" twin (u, y within 2e-3 of
    the solution scale, xi_pred within 1e-3 of it,
    tests/test_mpc_fused.py:257-260); the wrapper's CPU branch is the
    twin."""
    jcfg = _small_inv(JCfg.walking())
    tcfg = convert.config_from_dict(jcfg)
    ins = _prep_ins(3, 8, 21)
    solver_k = jfused.make_walking_fused(jcfg, use_pallas="interpret")
    with pltpu.force_tpu_interpret_mode():
        _, xp_j, (z_j, y_j) = jax.vmap(solver_k)(
            *[jnp.asarray(a) for a in ins])
    tins = [torch.from_numpy(a) for a in ins]
    sol_t, xp_t, (z_t, y_t) = tmfc.make_walking_fused(
        tcfg, solve_form="linv")(*tins)
    scale = float(np.abs(np.asarray(z_j)).max()) + 1.0
    close(z_t, z_j, 2e-3 * scale)
    close(y_t, y_j, 2e-3 * scale)
    close(xp_t, xp_j, 1e-3 * scale)
    z_w2, _, res_w, xp_w = tmfc.fused_walking_qp_prep(*tins, cfg=tcfg)
    assert torch.equal(z_w2, z_t) and torch.equal(xp_w, xp_t)
    assert torch.equal(res_w, sol_t.residual)
    # and it is not the "subst" twin bit for bit
    z_s = tmfc.make_walking_fused(tcfg, solve_form="subst")(*tins)[2][0]
    close(z_t, z_s, 1e-4 * scale)
    assert not torch.equal(z_t, z_s)


def test_inv_dispatch_walking_and_standing():
    """Configs with solve_form="inv" take the inv entry points, walking and
    standing; the twin is "linv" where n = nu N <= 64 (walking N <= 21,
    standing N <= 10) and "subst" beyond (standing at N = 20, n = 120), as
    mpc_fused_pallas.py:249 does."""
    winv = convert.config_from_dict(dataclasses.replace(
        _small_inv(JCfg.walking()), srbd=dataclasses.replace(
            _small_inv(JCfg.walking()).srbd, horizon=20)))
    sinv = dataclasses.replace(winv, mode="stand",
                               desired_velocity=(0.0, 0.0, 0.0),
                               ref_anchor_band=0.0)
    assert ttfc.supports_fused_tick(winv) and ttfc.supports_fused_tick(sinv)
    def names(c):
        return {est: (r.path, r.solve.name, r.hold.name) for est, r in (
            (est, tro.tick_route(dataclasses.replace(c, estimator_mode=est)))
            for est in ("truth", "kf"))}

    assert names(winv) == {
        "truth": ("kernel", "walking_tick_inv", "walking_tick_hold"),
        "kf": ("kernel", "walking_tick_kf_inv", "walking_tick_kf_hold")}
    assert names(sinv) == {
        "truth": ("kernel", "standing_tick_inv", "standing_tick_hold"),
        "kf": ("kernel", "standing_tick_kf_inv", "standing_tick_kf_hold")}
    ssub = dataclasses.replace(sinv, srbd=dataclasses.replace(
        sinv.srbd, solver=dataclasses.replace(sinv.srbd.solver,
                                              solve_form="subst")))
    assert names(ssub) == {
        "truth": ("kernel", "standing_tick", "standing_tick_hold"),
        "kf": ("kernel", "standing_tick_kf", "standing_tick_kf_hold")}
    assert tmfc.plain_solve_form("inv", 3, 20) == "linv"
    for N in range(1, 11):
        assert tmfc.plain_solve_form("inv", 6, N) == "linv", N
    for N in (11, 20):
        assert tmfc.plain_solve_form("inv", 6, N) == "subst", N
    assert tmfc.plain_solve_form("subst", 3, 20) == "subst"
    with pytest.raises(ValueError, match="solve_form"):
        tmfc.plain_solve_form("kinv", 3, 20)
    # the wrappers' CPU branches: walking = the "linv" tick, standing = the
    # "subst" tick, bit for bit
    for cfg, form in ((winv, "linv"), (sinv, "subst")):
        s = tro.initial_plant_state(cfg, batch=(2,), device="cpu")
        anc = (s.ref_anchor if s.ref_anchor is not None
               else torch.zeros(2, 3))
        outs = ttfc.fused_walking_tick(
            s.xi, s.q, s.foot_l, s.foot_r, s.qp_z, s.qp_lam, anc,
            torch.tensor([5.0, 320.0]), torch.tensor([[0.3, 0.0, 0.0]] * 2),
            torch.zeros(2), cfg=cfg)
        s2, _ = tro._plant_step_ref(
            cfg, s.replace(ref_anchor=anc), torch.tensor([5.0, 320.0]),
            v_des=torch.tensor([[0.3, 0.0, 0.0]] * 2),
            yaw_rate_des=torch.zeros(2), solve_form=form)
        assert torch.equal(outs[0], s2.xi) and torch.equal(outs[4], s2.qp_z)


@pytest.mark.parametrize("N", [21, 22])
def test_inv_twin_switches_to_subst_past_n64(N):
    """solve_form="inv" forms the factor inverse only where n <= 64, as
    the TPU kernel does (mpc_fused_pallas.py:249): the plain form of the
    inv kernels is "linv" at N = 21 (n = 63) and "subst" at N = 22
    (n = 66), and the walking prep wrapper's and the tick wrapper's CPU
    branches of an inv config are that twin bit for bit (at N = 22 the
    subst twin exactly; at N = 21 not the subst twin)."""
    form = tmfc.plain_solve_form("inv", 3, N)
    assert form == ("linv" if N == 21 else "subst")
    base = TCfg.walking()
    cfg = dataclasses.replace(base, srbd=dataclasses.replace(
        base.srbd, horizon=N, solver=dataclasses.replace(
            base.srbd.solver, solve_form="inv")))
    tins = [torch.from_numpy(a) for a in _prep_ins(3, N, 40 + N)]
    z, y, res, xp = tmfc.fused_walking_qp_prep(*tins, cfg=cfg)
    sol_f, xp_f, (z_f, y_f) = tmfc.walking_qp_prep_plain(cfg, *tins,
                                                         solve_form=form)
    assert torch.equal(z, z_f) and torch.equal(y, y_f)
    assert torch.equal(xp, xp_f) and torch.equal(res, sol_f.residual)
    z_s = tmfc.walking_qp_prep_plain(cfg, *tins, solve_form="subst")[2][0]
    assert torch.equal(z, z_s) == (N == 22)
    s = tro.initial_plant_state(cfg, batch=(2,), device="cpu")
    its = torch.tensor([5.0, 320.0])
    outs = ttfc.fused_walking_tick(
        s.xi, s.q, s.foot_l, s.foot_r, s.qp_z, s.qp_lam, s.ref_anchor, its,
        torch.tensor([[0.3, 0.0, 0.0]] * 2), torch.zeros(2), cfg=cfg)
    s2, _ = tro._plant_step_ref(
        cfg, s, its, v_des=torch.tensor([[0.3, 0.0, 0.0]] * 2),
        yaw_rate_des=torch.zeros(2), solve_form=form)
    assert torch.equal(outs[0], s2.xi) and torch.equal(outs[4], s2.qp_z)
