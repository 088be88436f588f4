"""The Kalman-filter walking loop and the dtMPC held-force schedule of the
PyTorch port against the JAX package, on the CPU.

* ``kf_update``, ``estimator_tick``, ``scripted_odometry`` and
  ``quat_to_rpy`` against JAX in float64 (1e-9);
* five threaded KF ticks of the port's ``_plant_step_ref`` against JAX
  ``_plant_step_ref`` at the walking config's full width (N = 20), B = 6,
  staggered phases: float64 1e-8 after one tick, 1e-6 after five;
* the plain twins of the ``walking_tick`` variants (KF, hold, KF + hold)
  against JAX ``make_tick_fused(..., use_pallas="interpret")`` at horizon
  8 over a solve + hold sequence, with the tolerances of
  tests/test_tick_fused.py:253-262, 380-391 and 436-441;
* ``soak_rollout`` against ``batched_rollout`` window by window, and
  ``soak_stationary`` against JAX on the same stats;
* the KF state through ``utils/convert.py`` and the dispatch rules of the
  kernel wrapper on CPU tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpc_limx_control_tpu.control import estimator as jest
from mpc_limx_control_tpu.control import rollout as jro
from mpc_limx_control_tpu.core import types as jtypes
from mpc_limx_control_tpu.core.config import ControllerConfig as JCfg
from mpc_limx_control_tpu.ops import kf as jkf
from mpc_limx_control_tpu.ops import tick_fused_pallas as jtick
from mpc_limx_control_tpu.utils import rotations as jrot
from mpc_limx_control_tpu_torch.control import estimator as t_est
from mpc_limx_control_tpu_torch.control import rollout as tro
from mpc_limx_control_tpu_torch.core import types as ttypes
from mpc_limx_control_tpu_torch.core.config import ControllerConfig as TCfg
from mpc_limx_control_tpu_torch.ops import kf as tkf
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as ttfc
from mpc_limx_control_tpu_torch.utils import convert
from mpc_limx_control_tpu_torch.utils import rotations as trot

FIELDS = ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam", "ref_anchor",
          "prev_v", "prev_q")
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


def _kf(cfg):
    return dataclasses.replace(cfg, estimator_mode="kf")


def _small(cfg):
    return dataclasses.replace(
        cfg, srbd=dataclasses.replace(cfg.srbd, horizon=8))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _spd(rng, B, n, scale):
    a = rng.standard_normal((B, n, n))
    return scale * (a @ a.transpose(0, 2, 1) / n + 0.1 * np.eye(n))


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


def _perturbed(jcfg, B, seed, np_dtype):
    """JAX initial state with numpy-seeded vx / vy / yaw perturbations."""
    s0 = jro.initial_plant_state(jcfg, batch=(B,), dtype=jnp.dtype(np_dtype))
    rng = np.random.default_rng(seed)
    xi = np.asarray(s0.xi).copy()
    xi[:, 9] += 0.08 * rng.standard_normal(B)
    xi[:, 10] += 0.05 * rng.standard_normal(B)
    xi[:, 2] += 0.1 * rng.standard_normal(B)
    return s0.replace(xi=jnp.asarray(xi.astype(np_dtype)))


def _assert_close(t, j, atol, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0,
                               err_msg=what)


def _assert_kf_state(st, sj, tols):
    for k, a in tols.items():
        if k in ("x_hat", "p_cov"):
            _assert_close(getattr(st.kf, k), getattr(sj.kf, k), a, k)
        else:
            _assert_close(getattr(st, k), getattr(sj, k), a, k)


# ---- modules in float64 ------------------------------------------------

def test_quat_to_rpy_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((64, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    # near the pitch singularity, where the 0.99999 asin clamp bites
    q[:4] = [[0.0, 0.7071, 0.0, 0.7072], [0.0, 0.70711, 0.0, 0.70710],
             [0.1, 0.7, 0.0, 0.7], [0.0, -0.7071, 0.0, 0.7071]]
    for fn_t, fn_j in ((trot.quat_to_rpy, jrot.quat_to_rpy),
                       (trot.quat_to_zyx, jrot.quat_to_zyx)):
        _assert_close(fn_t(_t(q)), fn_j(jnp.asarray(q)), 1e-12,
                      fn_t.__name__)


def _kf_inputs(B, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([[0.0, 0.0, 0.65] + 0.02 * rng.standard_normal(
        (B, 3)), 0.3 * rng.standard_normal((B, 3)),
        [0.0, 0.1, 0.0] + 0.02 * rng.standard_normal((B, 3)),
        [0.0, -0.1, 0.0] + 0.02 * rng.standard_normal((B, 3))], -1)
    P = _spd(rng, B, 12, 0.05)
    pos_rel = np.stack([[0.0, 0.1, -0.65], [0.0, -0.1, -0.65]]) \
        + 0.03 * rng.standard_normal((B, 2, 3))
    vel_rel = 0.2 * rng.standard_normal((B, 2, 3))
    acc = [0.0, 0.0, 0.0] + 0.5 * rng.standard_normal((B, 3))
    contact = np.stack([np.arange(B) % 2 == 0, np.arange(B) % 3 != 0], -1)
    heights = 0.01 * rng.standard_normal((B, 2))
    return x, P, (pos_rel, vel_rel, acc, contact, heights)


def test_kf_update_matches_jax_f64():
    cfg = TCfg.walking()
    x, P, meas = _kf_inputs(8, 1)
    out_j = jax.vmap(lambda x1, p1, *m1: jkf.kf_update(
        JCfg.walking().estimator, jtypes.KFState(x_hat=x1, p_cov=p1),
        jkf.KFMeasurement(*m1), 0.001))(
        *[jnp.asarray(a) for a in (x, P, *meas)])
    out_t = tkf.kf_update(cfg.estimator,
                          ttypes.KFState(x_hat=_t(x), p_cov=_t(P)),
                          tkf.KFMeasurement(*[_t(a) for a in meas]), 0.001)
    _assert_close(out_t.x_hat, out_j.x_hat, 1e-9, "x_hat")
    _assert_close(out_t.p_cov, out_j.p_cov, 1e-9, "p_cov")
    # the xy conditioning branch ran for some scenarios and not others
    det = P[:, 0, 0] * P[:, 1, 1] - P[:, 0, 1] * P[:, 1, 0]
    assert det.min() > 0 and bool(
        (np.abs(np.asarray(out_j.p_cov)[:, 0, 2:]) == 0).any())


def test_estimator_tick_matches_jax_f64():
    cfg, jcfg = TCfg.walking(), JCfg.walking()
    B = 8
    x, P, (_, _, _, contact, _) = _kf_inputs(B, 2)
    rng = np.random.default_rng(3)
    q = np.tile([0.0, 0.6, -1.2, 0.0, 0.6, -1.2], (B, 1)) \
        + 0.1 * rng.standard_normal((B, 6))
    dq = 0.5 * rng.standard_normal((B, 6))
    quat = rng.standard_normal((B, 4)) * [0.05, 0.05, 0.3, 1.0]
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    acc = [0.0, 0.0, 9.81] + 0.3 * rng.standard_normal((B, 3))
    gyro = 0.2 * rng.standard_normal((B, 3))

    def jone(x1, p1, q1, dq1, qt1, a1, g1, c1):
        return jest.estimator_tick(
            jcfg, jtypes.KFState(x_hat=x1, p_cov=p1),
            jtypes.JointState(q=q1, dq=dq1, tau=jnp.zeros_like(q1)),
            jtypes.ImuData(quat=qt1, acc=a1, gyro=g1), c1, 0.001)

    out_j = jax.vmap(jone)(*[jnp.asarray(a) for a in
                             (x, P, q, dq, quat, acc, gyro, contact)])
    out_t = t_est.estimator_tick(
        cfg, ttypes.KFState(x_hat=_t(x), p_cov=_t(P)),
        ttypes.JointState(q=_t(q), dq=_t(dq),
                          tau=torch.zeros(B, 6, dtype=torch.float64)),
        ttypes.ImuData(quat=_t(quat), acc=_t(acc), gyro=_t(gyro)),
        _t(contact), 0.001)
    _assert_close(out_t.kf.x_hat, out_j.kf.x_hat, 1e-9, "x_hat")
    _assert_close(out_t.kf.p_cov, out_j.kf.p_cov, 1e-9, "p_cov")
    for f in ("pos", "ori", "quat", "v_pos", "v_ori"):
        _assert_close(getattr(out_t.odom, f), getattr(out_j.odom, f), 1e-9, f)


def test_scripted_odometry_matches_jax():
    cfg, jcfg = TCfg.walking(), JCfg.walking()
    its = np.asarray([0.0, 17.0, 600.0, 1234.0])
    v = np.tile([0.5, 0.1, 0.0], (4, 1))
    w = np.asarray([0.0, 0.3, -0.2, 0.1])
    oj = jest.scripted_odometry(jcfg, jnp.asarray(its), jnp.asarray(v),
                                yaw_rate=jnp.asarray(w))
    ot = t_est.scripted_odometry(cfg, _t(its), _t(v), yaw_rate=_t(w))
    for f in ("pos", "ori", "quat", "v_pos", "v_ori"):
        _assert_close(getattr(ot, f), getattr(oj, f), 1e-12, f)


# ---- the KF tick at full width --------------------------------------------

def test_initial_kf_state_matches_jax():
    sj = jro.initial_plant_state(_kf(JCfg.walking()), batch=(3,),
                                 dtype=jnp.float64)
    st = tro.initial_plant_state(_kf(TCfg.walking()), batch=(3,),
                                 dtype=torch.float64, device="cpu")
    _assert_kf_state(st, sj, {k: 1e-12 for k in FIELDS + ("x_hat",
                                                         "p_cov")})
    one = tro.initial_plant_state(_kf(TCfg.walking()), dtype=torch.float64,
                                  device="cpu")
    assert one.kf.p_cov.shape == (12, 12) and one.prev_q.shape == (6,)


def test_kf_plant_step_ref_matches_jax_f64():
    """Five threaded KF ticks, full width N = 20, B = 6, staggered
    iterations: 1e-8 after one tick (state, filter and every metric),
    1e-6 after five. The covariance is held relative to its scale, the
    initial 100 I: its first update cancels 100 -> 33 through an
    innovation covariance of condition ~1e5, where the two libraries'
    Cholesky solves differ by 5e-8 (measured; 5e-10 of the scale; 1e-10
    after five ticks)."""
    jcfg, tcfg = _kf(JCfg.walking()), _kf(TCfg.walking())
    P0 = jcfg.estimator.initial_covariance
    sj = _perturbed(jcfg, 6, 0, np.float64)
    st = _port_state(sj, torch.float64)
    its = np.asarray(ITS) + 2.0
    for j in range(5):
        sj, mj = jax.vmap(lambda s, it: jro._plant_step_ref(jcfg, s, it))(
            sj, jnp.asarray(its + j))
        st, mt = tro._plant_step_ref(tcfg, st, torch.tensor(its + j))
        if j == 0:
            _assert_kf_state(st, sj, {k: 1e-8 for k in FIELDS + ("x_hat",)})
            _assert_kf_state(st, sj, {"p_cov": 1e-8 * P0})
            assert set(mt) == set(mj)
            for k, v in mt.items():
                _assert_close(v, mj[k], 1e-8 * (P0 if "cov" in k else 1), k)
    _assert_kf_state(st, sj, {"xi": 1e-6, "x_hat": 1e-6, "p_cov": 1e-6,
                              "q": 1e-6, "qp_z": 1e-6})
    assert float(mt["est_error"].max()) > 0.0


# ---- kernel twins vs the JAX Pallas kernel (interpret mode) --------------

@pytest.mark.parametrize("est", ["truth", "kf"])
def test_tick_twin_solve_then_hold_matches_jax_kernel_interpret(est):
    """The plain twins of walking_tick{,_kf} (solve) then
    walking_tick{_hold,_kf_hold} (held force) against JAX
    make_tick_fused(..., "interpret") at horizon 8, B = 2, over one dtMPC
    block (a solve and four held ticks): xi 5e-4, q 1e-3, x_hat 5e-4,
    p_cov 1e-5 (after the five ticks: the float32 cancellation of the
    first updates from 100 I is 1e-4 and decays ~10x a tick), grf 2e-1,
    held residual == 0."""
    _walk_twin_vs_jax_kernel(est == "kf", (5.0, 320.0))


def test_tick_twin_hold_across_a_phase_switch_matches_jax_interpret():
    """The plain twins of walking_tick (solve) then walking_tick_hold
    against JAX make_tick_fused(..., "interpret") at horizon 8, B = 3,
    over a solve and four held ticks that cross the gait's phase switch at
    iteration 300 (the left leg swings on 0-299 of each 600): solved at
    296, 297 and 299, the held force moves to the other foot at 300 in
    each scenario, on the first held tick for the last. The bands of the
    solve-then-hold test above."""
    _walk_twin_vs_jax_kernel(False, (296.0, 297.0, 299.0))


def _walk_twin_vs_jax_kernel(kf, its):
    jcfg, tcfg = _small(JCfg.walking()), _small(TCfg.walking())
    if kf:
        jcfg, tcfg = _kf(jcfg), _kf(tcfg)
    B = len(its)
    s0 = jro.initial_plant_state(jcfg, batch=(B,))
    rng = np.random.default_rng(13)
    xi = np.asarray(s0.xi).copy()
    xi[:, 9] += 0.05 * rng.standard_normal(B)
    sj = s0.replace(xi=jnp.asarray(xi))
    st = _port_state(sj, torch.float32)
    its = np.asarray(its, np.float32)
    vd = jnp.broadcast_to(jnp.asarray([0.5, 0.0, 0.0], jnp.float32), (B, 3))
    wd = jnp.zeros((B,), jnp.float32)
    held_j = held_t = None
    steps = {h: jtick.make_tick_fused(jcfg, use_pallas="interpret", hold=h)
             for h in (False, True)}
    for j in range(5):
        hold = j > 0
        step = steps[hold]
        args = [sj.xi, sj.q, sj.foot_l, sj.foot_r, sj.qp_z, sj.qp_lam,
                sj.ref_anchor, jnp.asarray(its + j), vd, wd]
        args += [held_j] if hold else []
        args += [sj.kf.x_hat, sj.kf.p_cov, sj.prev_v, sj.prev_q] if kf else []
        with pltpu.force_tpu_interpret_mode():
            outs = jax.vmap(step)(*args)
        (xi_j, q_j, fl_j, fr_j, z_j, y_j, anc_j, res_j, grf_j, tgt_j,
         *kf_j) = outs
        rep = dict(xi=xi_j, q=q_j, foot_l=fl_j, foot_r=fr_j, qp_z=z_j,
                   qp_lam=y_j, ref_anchor=anc_j)
        if kf:
            rep.update(kf=sj.kf.replace(x_hat=kf_j[0], p_cov=kf_j[1]),
                       prev_v=sj.xi[:, 9:12], prev_q=sj.q)
        sj = sj.replace(**rep)

        z_in = st.qp_z
        kf_args = dict(kf_x=st.kf.x_hat, kf_p=st.kf.p_cov,
                       prev_v=st.prev_v, prev_q=st.prev_q) if kf else {}
        outs_t = ttfc.fused_walking_tick(
            st.xi, st.q, st.foot_l, st.foot_r, st.qp_z, st.qp_lam,
            st.ref_anchor, torch.from_numpy(its + j),
            torch.tensor([[0.5, 0.0, 0.0]] * B), torch.zeros(B),
            grf_held=held_t if hold else None, cfg=tcfg, **kf_args)
        rep_t = dict(xi=outs_t[0], q=outs_t[1], foot_l=outs_t[2],
                     foot_r=outs_t[3], qp_z=outs_t[4], qp_lam=outs_t[5],
                     ref_anchor=outs_t[6])
        if kf:
            rep_t.update(kf=ttypes.KFState(x_hat=outs_t[10],
                                           p_cov=outs_t[11]),
                         prev_v=st.xi[:, 9:12], prev_q=st.q)
        st = st.replace(**rep_t)
        grf_t, res_t = outs_t[8], outs_t[7]
        _assert_close(grf_t, grf_j, 2e-1, f"grf tick {j}")
        if hold:
            assert float(res_t.abs().max()) == 0.0
            assert float(np.abs(np.asarray(res_j)).max()) == 0.0
            assert outs_t[4] is z_in        # the warm state passes through
        else:
            held_j, held_t = grf_j, grf_t
    tols = {"xi": 5e-4, "q": 1e-3, "foot_l": 1e-3, "foot_r": 1e-3,
            "ref_anchor": 1e-5}
    if kf:
        tols.update(x_hat=5e-4, p_cov=1e-5)
    _assert_kf_state(st, sj, tols)


# ---- the dtMPC schedule and the soak -------------------------------------

def test_kf_dtmpc_rollout_holds_four_in_five():
    """mpc_every = 5 with the KF on the CPU: the solve ticks carry a
    residual, the held ticks exactly none; the KF metrics are there and
    the state threads through rollout() unbatched."""
    cfg = _kf(TCfg.walking())
    s = tro.initial_plant_state(cfg, dtype=torch.float64, device="cpu")
    f, m = tro.rollout(cfg, s, 10, start_iteration=295, mpc_every=5)
    res = m["qp_residual"]
    assert bool((res[[0, 5]] > 0).all())
    assert float(res[[1, 2, 3, 4, 6, 7, 8, 9]].abs().max()) == 0.0
    assert m["kf_cov_pos"].shape == (10, 3) and f.kf.x_hat.shape == (12,)
    assert bool(torch.isfinite(m["kf_cov_vel"]).all())


@pytest.mark.parametrize("est,mpc_every", [("truth", 5), ("kf", 1),
                                           ("kf", 5)])
def test_soak_matches_batched_rollout(est, mpc_every):
    """soak_rollout is batched_rollout run window by window: the same
    final state, and per-window stats equal to reductions of the per-tick
    metrics (tests/test_soak.py:31-59)."""
    cfg = TCfg.walking() if est == "truth" else _kf(TCfg.walking())
    B, W, NW = 3, 40, 2
    s0 = tro.initial_plant_state(cfg, batch=(B,), device="cpu")
    it0 = torch.tensor((np.arange(B) * 600) // B, dtype=torch.float32)
    f_s, stats = tro.soak_rollout(cfg, s0, NW, W, start_iteration=it0,
                                  mpc_every=mpc_every)
    f_r, m = tro.batched_rollout(cfg, s0, NW * W, start_iteration=it0,
                                 mpc_every=mpc_every)
    for k in ("xi", "q", "foot_l", "foot_r", "qp_z", "ref_anchor"):
        torch.testing.assert_close(getattr(f_s, k), getattr(f_r, k),
                                   atol=1e-5, rtol=0)
    h, vx = m["height"].double(), m["velocity"][..., 0].double()
    for w in range(NW):
        sl = slice(w * W, (w + 1) * W)
        for key, ref in (("height_mean", h[:, sl].mean()),
                         ("height_min", h[:, sl].min()),
                         ("vx_mean", vx[:, sl].mean()),
                         ("qp_res_max", m["qp_residual"][:, sl].max())):
            assert abs(float(stats[key][w]) - float(ref)) < 1e-5, key
        if est == "kf":
            ref = m["kf_cov_pos"][:, sl].mean()
            assert abs(float(stats["kf_cov_pos_mean"][w]) - float(ref)) \
                < 1e-5 * (1 + float(ref))
    assert int(stats["nonfinite_ticks"].sum()) == 0
    assert stats["height_mean"].device.type == "cpu"
    # the host-side summary is the JAX one
    summ_t = tro.soak_stationary(stats)
    summ_j = jro.soak_stationary({k: np.asarray(v) for k, v in
                                  stats.items()})
    assert summ_t == pytest.approx(summ_j, rel=1e-12, abs=1e-15)


# ---- state conversion and dispatch ---------------------------------------

def test_convert_round_trips_jax_kf_state():
    sj = _perturbed(_kf(JCfg.walking()), 2, 7, np.float32)
    st = convert.plant_state_from_numpy(
        {**_jax_state_np(sj), "kf": sj.kf},         # a JAX KFState object
        device="cpu")
    _assert_kf_state(st, sj, {k: 0.0 for k in FIELDS + ("x_hat", "p_cov")})
    back = convert.plant_state_to_numpy(st)
    assert set(back["kf"]) == {"x_hat", "p_cov"}
    np.testing.assert_array_equal(back["kf"]["p_cov"],
                                  np.asarray(sj.kf.p_cov))
    np.testing.assert_array_equal(back["prev_q"], np.asarray(sj.prev_q))
    with pytest.raises(ValueError, match="not in the port"):
        convert.plant_state_from_numpy({"xi": np.zeros((1, 13)),
                                        "bogus": np.zeros(1)}, device="cpu")


def test_kf_and_hold_wrappers_on_cpu_run_the_plain_tick():
    """The wrapper's CPU branch is the plain tick for every variant,
    counts no launch, and refuses a KF config without the filter state."""
    cfg = _kf(TCfg.walking())
    s = tro.initial_plant_state(cfg, batch=(2,), device="cpu")
    it = torch.tensor([3.0, 310.0])
    before = {k: v.launches for k, v in ttfc.TICK_TABLE.items()}
    grf = torch.tensor([[0.0, 0.0, 200.0, 0.0, 0.0, 0.0]] * 2)
    vd = torch.tensor([[0.5, 0.0, 0.0]] * 2)
    outs = ttfc.fused_walking_tick(
        s.xi, s.q, s.foot_l, s.foot_r, s.qp_z, s.qp_lam, s.ref_anchor, it,
        vd, torch.zeros(2), kf_x=s.kf.x_hat, kf_p=s.kf.p_cov,
        prev_v=s.prev_v, prev_q=s.prev_q, grf_held=grf, cfg=cfg)
    s_p, m_p = tro._plant_step_ref(cfg, s, it, grf_override=grf, v_des=vd,
                                   solve_form="subst")
    assert len(outs) == 12
    assert torch.equal(outs[0], s_p.xi) and torch.equal(outs[10],
                                                        s_p.kf.x_hat)
    assert outs[4] is s.qp_z and float(outs[7].abs().max()) == 0.0
    assert {k: v.launches for k, v in ttfc.TICK_TABLE.items()} == before
    with pytest.raises(ValueError, match="kf_x"):
        ttfc.fused_walking_tick(s.xi, s.q, s.foot_l, s.foot_r, s.qp_z,
                                s.qp_lam, s.ref_anchor, it, vd,
                                torch.zeros(2), cfg=cfg)
    truth = tro.initial_plant_state(TCfg.walking(), batch=(2,), device="cpu")
    assert "filter fields" in tro._kernel_state_reason(cfg, truth)
    assert "filter fields" in tro._kernel_state_reason(TCfg.walking(), s)
    assert tro._kernel_state_reason(cfg, s) is None
    assert tro.tick_route(cfg).path == "kernel"
