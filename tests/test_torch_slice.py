"""The walking closed-loop slice of the PyTorch port against the JAX
package, on the CPU.

* The port's plain tick (``_plant_step_ref``, explicit f32 K^-1 "kinv" as
  the JAX composition) against JAX ``_plant_step_ref`` at the walking
  config's full width (N = 20, n = 60, m = 120), B = 6, staggered gait
  phases: float64 agrees to 1e-8; a 20-tick float32 rollout stays within
  the stated band.
* The "subst" twins of the CUDA kernels against the JAX Pallas kernels in
  interpret mode at horizon 8 (the JAX suite's own cheap kernel config),
  with tolerances no looser than tests/test_tick_fused.py:436-441 and
  tests/test_mpc_fused.py:257-260.
* The dispatch rules: CPU tensors run the plain versions; configs the
  kernels do not implement raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpc_limx_control_tpu.control import rollout as jro
from mpc_limx_control_tpu.core.config import ControllerConfig as JCfg
from mpc_limx_control_tpu.ops import mpc_fused_pallas as jfused
from mpc_limx_control_tpu.ops import tick_fused_pallas as jtick
from mpc_limx_control_tpu_torch.control import controller as tctrl
from mpc_limx_control_tpu_torch.control import rollout as tro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig as TCfg
from mpc_limx_control_tpu_torch.models import srbd as tsrbd
from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as tmfc
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as ttfc
from mpc_limx_control_tpu_torch.utils import convert

FIELDS = ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam", "ref_anchor")
ITS = [0.0, 40.0, 180.0, 299.0, 300.0, 455.0]   # both swing sides + switch


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


def _small(cfg):
    return dataclasses.replace(
        cfg, srbd=dataclasses.replace(cfg.srbd, horizon=8))


def _jax_state_np(s):
    return {k: np.asarray(getattr(s, k)) for k in FIELDS
            if getattr(s, k) is not None}


def _perturbed(jcfg, B, seed, np_dtype):
    """JAX initial state with numpy-seeded vx / vy / yaw perturbations
    (tests/test_tick_fused.py:_states recipe)."""
    s0 = jro.initial_plant_state(jcfg, batch=(B,), dtype=jnp.dtype(np_dtype))
    rng = np.random.default_rng(seed)
    xi = np.asarray(s0.xi).copy()
    xi[:, 9] += 0.08 * rng.standard_normal(B)
    xi[:, 10] += 0.05 * rng.standard_normal(B)
    xi[:, 2] += 0.1 * rng.standard_normal(B)
    return s0.replace(xi=jnp.asarray(xi.astype(np_dtype)))


def _port_state(s_jax, dtype):
    return convert.plant_state_from_numpy(_jax_state_np(s_jax), dtype=dtype,
                                          device="cpu")


def _assert_states(st, sj, tols):
    for k, a in tols.items():
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(sj, k)), atol=a,
                                   rtol=0, err_msg=k)


def test_initial_plant_state_matches_jax():
    jcfg, tcfg = JCfg.walking(), TCfg.walking()
    sj = jro.initial_plant_state(jcfg, batch=(3,), dtype=jnp.float64)
    st = tro.initial_plant_state(tcfg, batch=(3,), dtype=torch.float64,
                                 device="cpu")
    _assert_states(st, sj, {k: 1e-12 for k in FIELDS})
    one = tro.initial_plant_state(tcfg, dtype=torch.float64, device="cpu")
    assert one.xi.shape == (13,) and one.qp_z.shape == (60,)


def test_plant_step_ref_matches_jax_f64():
    """Full width N = 20, B = 6, staggered iterations: f64 <= 1e-8 on the
    state, the warm QP state and every metric."""
    jcfg, tcfg = JCfg.walking(), TCfg.walking()
    sj = _perturbed(jcfg, 6, 0, np.float64)
    its = np.asarray(ITS)
    sj2, mj = jax.vmap(lambda s, it: jro._plant_step_ref(jcfg, s, it))(
        sj, jnp.asarray(its))
    st2, mt = tro._plant_step_ref(tcfg, _port_state(sj, torch.float64),
                                  torch.tensor(its))
    _assert_states(st2, sj2, {k: 1e-8 for k in FIELDS})
    for k, v in mt.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(mj[k]), atol=1e-8,
                                   rtol=0, err_msg=k)
    # CPU dispatch of plant_step is the plain composition
    st3, _ = tro.plant_step(tcfg, _port_state(sj, torch.float64),
                            torch.tensor(its))
    for k in FIELDS:
        assert torch.equal(getattr(st3, k), getattr(st2, k))


def test_plant_step_ref_n40_matches_jax_f64():
    """The walking tick past the 21 steps the nu = 3 core once took: N = 40
    (n = 120, what the walking kernels run with four solve rows a lane),
    B = 3, two threaded full-width ticks against JAX _plant_step_ref in
    float64, 1e-8 on the state, the warm QP state and every metric."""
    def n40(c):
        return dataclasses.replace(c, srbd=dataclasses.replace(c.srbd,
                                                               horizon=40))

    jcfg, tcfg = n40(JCfg.walking()), n40(TCfg.walking())
    assert ttfc.supports_fused_tick(tcfg)
    sj = _perturbed(jcfg, 3, 5, np.float64)
    st = _port_state(sj, torch.float64)
    its = np.asarray([0.0, 180.0, 299.0])
    for j in range(2):
        sj, mj = jax.vmap(lambda s, it: jro._plant_step_ref(jcfg, s, it))(
            sj, jnp.asarray(its + j))
        st, mt = tro._plant_step_ref(tcfg, st, torch.tensor(its + j))
        _assert_states(st, sj, {k: 1e-8 for k in FIELDS})
        assert set(mt) == set(mj)
        for k, v in mt.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(mj[k]),
                                       atol=1e-8, rtol=0, err_msg=k)
    assert st.qp_z.shape == (3, 120) and st.qp_lam.shape == (3, 240)


def test_hold_tick_matches_jax_f64():
    """The dtMPC held-force tick (grf_override) of the plain composition."""
    jcfg, tcfg = JCfg.walking(), TCfg.walking()
    sj = _perturbed(jcfg, 6, 1, np.float64)
    its = np.asarray(ITS) + 3.0
    grf = np.abs(np.random.default_rng(2).standard_normal((6, 6))) * 40.0
    sj2, mj = jax.vmap(lambda s, it, g: jro._plant_step_ref(
        jcfg, s, it, grf_override=g))(sj, jnp.asarray(its), jnp.asarray(grf))
    st2, mt = tro._plant_step_ref(tcfg, _port_state(sj, torch.float64),
                                  torch.tensor(its),
                                  grf_override=torch.tensor(grf))
    _assert_states(st2, sj2, {k: 1e-10 for k in FIELDS})
    for k in ("grf", "qp_residual", "foot_target"):
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                   atol=1e-10, rtol=0, err_msg=k)


def test_controller_tick_command_matches_jax_f64():
    """controller.tick's joint command (swing q, stance torque
    tau = J^T(-R^T f), gains) and diagnostics."""
    from mpc_limx_control_tpu.control import controller as jctrl
    from mpc_limx_control_tpu.core.types import JointState as JJoints
    from mpc_limx_control_tpu_torch.core.types import JointState

    jcfg, tcfg = JCfg.walking(), TCfg.walking()
    sj = _perturbed(jcfg, 6, 3, np.float64)
    its = np.asarray(ITS) + 7.0

    def jtick(s, it):
        odom = jro._odom_from_xi(s.xi)
        z = jnp.zeros_like(s.q)
        return jctrl.tick(jcfg, odom, JJoints(q=s.q, dq=z, tau=z), it,
                          qp_warm=(s.qp_z, s.qp_lam),
                          ref_anchor=s.ref_anchor)

    cmd_j, dg_j = jax.vmap(jtick)(sj, jnp.asarray(its))
    st = _port_state(sj, torch.float64)
    z = torch.zeros_like(st.q)
    cmd_t, dg_t = tctrl.tick(tcfg, tro._odom_from_xi(st.xi),
                             JointState(q=st.q, dq=z, tau=z),
                             torch.tensor(its), qp_warm=(st.qp_z, st.qp_lam),
                             ref_anchor=st.ref_anchor)
    for f in ("mode", "q", "dq", "tau", "kp", "kd"):
        np.testing.assert_allclose(getattr(cmd_t, f).numpy(),
                                   np.asarray(getattr(cmd_j, f)), atol=1e-8,
                                   rtol=0, err_msg=f)
    for f in ("grf", "qp_residual", "foot_target", "swing_q", "predicted_xi",
              "ref_anchor"):
        np.testing.assert_allclose(getattr(dg_t, f).numpy(),
                                   np.asarray(getattr(dg_j, f)), atol=1e-8,
                                   rtol=0, err_msg=f)


def test_rollout_20_ticks_matches_jax_f32():
    """20 consecutive float32 ticks at full width. Both sides run the
    explicit f32 K^-1 ADMM; each library rounds that inverse differently
    and the closed loop carries the difference. Measured: xi 1.5e-5,
    GRF 1.1e-3 N on a ~100 N scale after 20 ticks; the bands below leave
    ~7x margin (the per-tick kernel-vs-composition band of
    tests/test_tick_fused.py is 3e-4 on xi)."""
    jcfg, tcfg = JCfg.walking(), TCfg.walking()
    B, T = 6, 20
    sj = _perturbed(jcfg, B, 4, np.float32)
    start = np.asarray(ITS, np.float32) + 280.0
    fj, mj = jax.jit(lambda s, it0: jro.batched_rollout(
        jcfg, s, T, start_iteration=it0))(sj, jnp.asarray(start))
    ft, mt = tro.batched_rollout(tcfg, _port_state(sj, torch.float32), T,
                                 start_iteration=torch.tensor(start))
    _assert_states(ft, fj, {"xi": 1e-4, "q": 1e-5, "foot_l": 1e-5,
                            "foot_r": 1e-5, "ref_anchor": 1e-6})
    for k, a in (("height", 1e-5), ("velocity", 1e-5), ("grf", 1e-2),
                 ("foot_target", 1e-5)):
        assert mt[k].shape == tuple(np.asarray(mj[k]).shape)
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                   atol=a, rtol=0, err_msg=k)


def test_rollout_single_scenario_and_hold_schedule():
    """rollout() on an unbatched state equals batched_rollout on B = 1,
    and mpc_every = 5 runs the held-force ticks on the CPU."""
    cfg = TCfg.walking()
    s = tro.initial_plant_state(cfg, dtype=torch.float64, device="cpu")
    f1, m1 = tro.rollout(cfg, s, 10, start_iteration=295)
    sb = tro.initial_plant_state(cfg, batch=(1,), dtype=torch.float64,
                                 device="cpu")
    fb, mb = tro.batched_rollout(cfg, sb, 10, start_iteration=295)
    assert m1["height"].shape == (10,) and mb["height"].shape == (1, 10)
    torch.testing.assert_close(f1.xi, fb.xi[0], rtol=0, atol=0)
    fh, mh = tro.batched_rollout(cfg, sb, 10, mpc_every=5)
    res = mh["qp_residual"][0]
    assert bool((res[[0, 5]] > 0).all()) and float(res[1:5].abs().max()) == 0
    with pytest.raises(ValueError, match="multiple"):
        tro.batched_rollout(cfg, sb, 7, mpc_every=5)


def test_walking_closed_loop_cpu_stays_upright():
    """600 ticks of the plain closed loop from a perturbed start: upright,
    finite, moving forward."""
    cfg = TCfg.walking()
    s = tro.initial_plant_state(cfg, batch=(2,), device="cpu")
    s = s.replace(xi=s.xi + torch.tensor([[0.0] * 9 + [0.05, 0, 0, 0],
                                          [0.0] * 9 + [-0.05, 0, 0, 0]]))
    _, m = tro.batched_rollout(cfg, s, 600)
    h = m["height"]
    assert bool(torch.isfinite(h).all())
    assert float(h.min()) > 0.6 and float((h - 0.65).abs().max()) < 0.03
    assert float(m["velocity"][:, -100:, 0].mean()) > 0.2


# ---- kernel twins vs the JAX Pallas kernels (interpret mode) -----------

def test_prep_twin_matches_jax_kernel_interpret():
    """walking_mpc_prep's plain twin ("subst") against JAX
    make_walking_fused(..., "interpret") at horizon 8, B = 3: u within
    2e-3 of the solution scale, xi_pred within 1e-3 of it
    (tests/test_mpc_fused.py:257-260)."""
    jcfg, tcfg = _small(JCfg.walking()), _small(TCfg.walking())
    B, N = 3, 8
    rng = np.random.default_rng(21)
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
    ins = [a.astype(np.float32) for a in
           (arms, x0, v_des, w, z_w, y_w, anc)]
    solver_k = jfused.make_walking_fused(jcfg, use_pallas="interpret")
    with pltpu.force_tpu_interpret_mode():
        sol_j, xp_j, (z_j, y_j) = jax.vmap(solver_k)(
            *[jnp.asarray(a) for a in ins])
    sol_t, xp_t, (z_t, y_t) = tmfc.make_walking_fused(
        tcfg, solve_form="subst")(*[torch.from_numpy(a) for a in ins])
    scale = float(np.abs(np.asarray(z_j)).max()) + 1.0
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j),
                               atol=2e-3 * scale, rtol=0)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               atol=2e-3 * scale, rtol=0)
    np.testing.assert_allclose(xp_t.numpy(), np.asarray(xp_j),
                               atol=1e-3 * scale, rtol=0)
    # the kernel wrapper's CPU branch is exactly this plain twin
    z_w2, y_w2, res_w, xp_w = tmfc.fused_walking_qp_prep(
        *[torch.from_numpy(a) for a in ins], cfg=tcfg)
    assert torch.equal(z_w2, z_t) and torch.equal(xp_w, xp_t)
    assert torch.equal(res_w, sol_t.residual)


def test_tick_twin_matches_jax_kernel_interpret():
    """walking_tick's plain twin (_plant_step_ref with "subst") against
    JAX make_tick_fused(..., "interpret") at horizon 8 over two threaded
    ticks: xi 5e-4, q 1e-3, grf 2e-1 (tests/test_tick_fused.py:436-441)."""
    jcfg, tcfg = _small(JCfg.walking()), _small(TCfg.walking())
    B = 2
    s0 = jro.initial_plant_state(jcfg, batch=(B,))
    rng = np.random.default_rng(13)
    xi = np.asarray(s0.xi).copy()
    xi[:, 9] += 0.05 * rng.standard_normal(B)
    sj = s0.replace(xi=jnp.asarray(xi))
    st = _port_state(sj, torch.float32)
    its = np.asarray([5.0, 320.0], np.float32)
    step = jtick.make_tick_fused(jcfg, use_pallas="interpret")
    vd = jnp.broadcast_to(jnp.asarray([0.5, 0.0, 0.0], jnp.float32), (B, 3))
    wd = jnp.zeros((B,), jnp.float32)
    for j in range(2):
        with pltpu.force_tpu_interpret_mode():
            (xi_j, q_j, fl_j, fr_j, z_j, y_j, anc_j, res_j, grf_j,
             tgt_j) = jax.vmap(step)(sj.xi, sj.q, sj.foot_l, sj.foot_r,
                                     sj.qp_z, sj.qp_lam, sj.ref_anchor,
                                     jnp.asarray(its + j), vd, wd)
        sj = sj.replace(xi=xi_j, q=q_j, foot_l=fl_j, foot_r=fr_j, qp_z=z_j,
                        qp_lam=y_j, ref_anchor=anc_j)
        outs = ttfc.fused_walking_tick(
            st.xi, st.q, st.foot_l, st.foot_r, st.qp_z, st.qp_lam,
            st.ref_anchor, torch.from_numpy(its + j),
            torch.tensor([[0.5, 0.0, 0.0]] * B), torch.zeros(B), cfg=tcfg)
        st = tro.PlantState(xi=outs[0], q=outs[1], foot_l=outs[2],
                            foot_r=outs[3], qp_z=outs[4], qp_lam=outs[5],
                            ref_anchor=outs[6])
        grf_t = outs[8]
    _assert_states(st, sj, {"xi": 5e-4, "q": 1e-3, "foot_l": 1e-3,
                            "foot_r": 1e-3, "ref_anchor": 1e-5})
    np.testing.assert_allclose(grf_t.numpy(), np.asarray(grf_j), atol=2e-1,
                               rtol=0)


# ---- dispatch and refusal ----------------------------------------------

def test_unsupported_configs_refuse():
    cfg = TCfg.walking()
    kf = dataclasses.replace(cfg, estimator_mode="kf")
    stand = TCfg.standing()
    def solver(c, **kw):
        return dataclasses.replace(c, srbd=dataclasses.replace(
            c.srbd, solver=dataclasses.replace(c.srbd.solver, **kw)))

    def refused(c):
        """The card's refusal of `c`: tick_route's NotImplementedError,
        which carries controller.card_refusal's reason."""
        with pytest.raises(NotImplementedError) as info:
            tro.tick_route(c)
        assert str(info.value).endswith(tctrl.card_refusal(c))
        return tctrl.card_refusal(c)

    inv = solver(cfg, solve_form="inv")
    for ok in (cfg, kf, stand, dataclasses.replace(kf, mode="stand"), inv,
               solver(stand, solve_form="inv")):
        assert ttfc.supports_fused_tick(ok)
        assert ttfc.kernel_refusal(ok) is None
        assert tro.tick_route(ok).path == "kernel"
    rec = dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, attitude_ref="receding"))
    composition = tro.TickRoute("composition")
    # refused by the tick kernels for the solver, the swing IK or the
    # attitude reference: the composition runs them, on the card too
    for other in (dataclasses.replace(cfg, qp_warm_start=False),
                  dataclasses.replace(stand, qp_warm_start=False),
                  solver(cfg, method="pdip"), solver(stand, method="admm"),
                  TCfg(), dataclasses.replace(cfg, ik_method="damped_ls"),
                  dataclasses.replace(stand, ik_method="log6"),
                  solver(cfg, method="riccati"), rec):
        assert not ttfc.supports_fused_tick(other)
        assert tctrl.card_refusal(other) is None
        assert tro.tick_route(other) == composition
    # refused by both: unknown values
    for bad, said in (
            (solver(cfg, solve_form="x"),
             "solve_form='x' is unknown (the kernels run ('subst', 'inv'))"),
            (solver(cfg, method="x"), "solver method='x' is unknown"),
            (dataclasses.replace(cfg, ik_method="x"),
             "ik_method='x' is unknown"),
            (dataclasses.replace(cfg, srbd=dataclasses.replace(
                cfg.srbd, attitude_ref="x")), "attitude_ref='x' is unknown")):
        assert not ttfc.supports_fused_tick(bad)
        assert refused(bad) == said
    # a horizon past the 21 steps the walking MPC kernels once took: the
    # compositions that launch no MPC kernel run it; the walking kernels
    # (walking_tick, walking_mpc_prep) take 1 to 85 steps (n = 3 N <= 256),
    # the standing ones (standing_tick, fused_qp_nu6) 1 to 42 (n = 6 N <=
    # 256); past that the fused QP is refused, naming the limit
    def n22(c, N=22):
        return dataclasses.replace(c, srbd=dataclasses.replace(
            c.srbd, horizon=N))

    for other in (solver(cfg, method="pdip"),
                  dataclasses.replace(stand, qp_warm_start=False),
                  solver(cfg, method="riccati"), rec, TCfg()):
        assert not ttfc.supports_fused_tick(n22(other))
        assert tro.tick_route(n22(other)) == composition
    dls = dataclasses.replace(cfg, ik_method="damped_ls")
    for N in (22, 85):
        s_n = tro.initial_plant_state(n22(cfg, N), batch=(1,), device="cpu")
        for ok in (cfg, kf, inv):
            assert ttfc.supports_fused_tick(n22(ok, N))
        assert tro.tick_route(n22(cfg, N)).path == "kernel"
        assert tro._kernel_state_reason(n22(cfg, N), s_n) is None
        assert tro.tick_route(n22(dls, N)) == composition
    for bad in (cfg, kf, dls):
        assert not ttfc.supports_fused_tick(n22(bad, 86))
        assert refused(n22(bad, 86)) == (
            "horizon=86: the walking MPC kernels take 1 to 85 steps (n = 3 "
            "N <= 256, eight solve rows a lane)")
    for N in (22, 42):
        s_n = tro.initial_plant_state(n22(stand, N), batch=(1,),
                                      device="cpu")
        for ok in (stand, dataclasses.replace(stand, estimator_mode="kf")):
            assert ttfc.supports_fused_tick(n22(ok, N))
        assert tro.tick_route(n22(stand, N)).path == "kernel"
        assert tro._kernel_state_reason(n22(stand, N), s_n) is None
        assert tro.tick_route(n22(solver(stand, method="admm"), N)) == \
            composition
    for bad in (stand, solver(stand, method="admm"),
                dataclasses.replace(stand, ik_method="log6")):
        assert not ttfc.supports_fused_tick(n22(bad, 43))
        assert refused(n22(bad, 43)) == (
            "horizon=43: the standing MPC kernels take 1 to 42 steps (n = 6 "
            "N <= 256, eight solve rows a lane)")
    # a dense QP past the Cholesky kernels (standing n = 6 N > 256)
    far = dataclasses.replace(stand, qp_warm_start=False,
                              srbd=dataclasses.replace(stand.srbd,
                                                       horizon=45))
    assert refused(far) == (
        "horizon=45: the dense QP (n = 270) is past the Cholesky kernels' "
        "reach (cholesky: n = 270, k = 1 needs 148500 bytes of shared "
        "memory; the kernel takes 1 <= n <= 256, k >= 1 within 232448 bytes "
        "per block)")
    # the KF state, standing and the cold two-foot solve are ported
    assert tro.initial_plant_state(kf, device="cpu").kf.x_hat.shape == (12,)
    s = tro.initial_plant_state(stand, batch=(1,), device="cpu")
    assert s.qp_z.shape == (1, 120) and s.ref_anchor is None
    s2, m = tro.plant_step(stand, s, torch.zeros(1))
    assert s2.qp_lam.shape == (1, 240) and bool(m["qp_residual"] > 0)
    cold = dataclasses.replace(stand, qp_warm_start=False)
    s3, m3 = tro.plant_step(cold, tro.initial_plant_state(
        cold, batch=(1,), device="cpu"), torch.zeros(1))
    assert s3.qp_z is None and bool(m3["qp_residual"] > 0)
    assert abs(float(m3["grf"][0, 2] + m3["grf"][0, 5]) - 9.81
               * cold.robot.mass) < 0.1 * 9.81 * cold.robot.mass
    # the Riccati solver is ported: its warm walking tick threads (z, y)
    ric = solver(cfg, method="riccati")
    sr, mr = tro.plant_step(ric, tro.initial_plant_state(
        ric, batch=(1,), device="cpu"), torch.zeros(1))
    assert sr.qp_z.shape == (1, 60) and bool(torch.isfinite(mr["grf"]).all())
    with pytest.raises(ValueError, match="ik_method"):
        bad = dataclasses.replace(cfg, ik_method="x")
        tro.plant_step(bad, tro.initial_plant_state(cfg, batch=(1,),
                                                    device="cpu"),
                       torch.zeros(1))
    # the kernel wrapper itself still takes the level reference only
    with pytest.raises(ValueError, match="level-attitude"):
        tmfc.fused_walking_qp_prep(
            torch.zeros(1, 20, 3), torch.zeros(1, 13), torch.zeros(1, 3),
            torch.zeros(1), torch.zeros(1, 60), torch.zeros(1, 120),
            torch.zeros(1, 3), cfg=rec)
    with pytest.raises(ValueError, match="solve_form"):
        tmfc.make_walking_fused(cfg, solve_form="inv")


def test_receding_config_runs_plain_on_cpu():
    """The level-attitude guard: a receding config still runs the plain
    composition on CPU tensors (as JAX runs its XLA branch), and matches
    JAX there in float64."""
    jcfg = JCfg.walking()
    jcfg = dataclasses.replace(jcfg, srbd=dataclasses.replace(
        jcfg.srbd, attitude_ref="receding"))
    tcfg = convert.config_from_dict(jcfg)
    sj = _perturbed(jcfg, 2, 5, np.float64)
    its = np.asarray([10.0, 310.0])
    sj2, _ = jax.vmap(lambda s, it: jro._plant_step_ref(jcfg, s, it))(
        sj, jnp.asarray(its))
    st2, _ = tro.plant_step(tcfg, _port_state(sj, torch.float64),
                            torch.tensor(its))
    _assert_states(st2, sj2, {"xi": 1e-8, "qp_z": 1e-6})


def test_kernel_wrappers_validate_on_cuda_only_paths():
    """CPU tensors never count a launch; a meta-device tensor is refused
    instead of being sent to the kernel or the plain version."""
    cfg = TCfg.walking()
    kernels = (tmfc.WALKING_MPC_PREP, *ttfc.TICK_TABLE.values())
    before = [k.launches for k in kernels]
    s = tro.initial_plant_state(cfg, batch=(2,), device="cpu")
    tro.plant_step(cfg, s, torch.zeros(2))
    tro.plant_step(cfg, s, torch.zeros(2), grf_override=torch.zeros(2, 6))
    assert [k.launches for k in kernels] == before
    meta = torch.zeros(1, 13, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tmfc.fused_walking_qp_prep(meta, meta, meta, meta, meta, meta, meta,
                                   cfg=cfg)
    x0 = tsrbd.initial_state(torch.zeros(1, 3), torch.zeros(1, 3),
                             torch.zeros(1, 3), torch.zeros(1, 3))
    assert x0.shape == (1, 13)
