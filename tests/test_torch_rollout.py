"""The rest of the port's rollout against the JAX package, on the CPU:
``rollout(..., v_des_schedule=)``, ``batched_rollout_resident`` and the
state constructors the session needs (``OdomState.zeros`` etc.).

* The velocity schedule against JAX ``rollout`` in float64 (1e-8), and
  tests/test_velocity_profile.py's ramp / cruise / stop on the port.
* The resident rollout's CPU loop against a loop of the tick's plain
  version (``tick_fused_cuda.fused_walking_tick`` on CPU tensors) bit for
  bit, and against JAX ``batched_rollout_resident(use_pallas=
  "interpret")`` at horizon 8 with the bands of the kernel-twin tests
  (tests/test_torch_slice.py, tests/test_torch_kf.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpc_limx_control_tpu.control import rollout as jro
from mpc_limx_control_tpu.core import types as jtypes
from mpc_limx_control_tpu.core.config import ControllerConfig as JCfg
from mpc_limx_control_tpu_torch.control import rollout as tro
from mpc_limx_control_tpu_torch.core import types as ttypes
from mpc_limx_control_tpu_torch.core.config import ControllerConfig as TCfg
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as ttfc
from mpc_limx_control_tpu_torch.utils import convert

FIELDS = ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam", "ref_anchor")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Host loops of small torch calls: one thread per test worker (see
    tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(cfg, est="truth"):
    return dataclasses.replace(
        cfg, estimator_mode=est,
        srbd=dataclasses.replace(cfg.srbd, horizon=8))


def _port_state(sj, dtype):
    d = {k: np.asarray(getattr(sj, k)) for k in FIELDS
         if getattr(sj, k) is not None}
    if sj.kf is not None:
        d.update(kf={"x_hat": np.asarray(sj.kf.x_hat),
                     "p_cov": np.asarray(sj.kf.p_cov)},
                 prev_v=np.asarray(sj.prev_v), prev_q=np.asarray(sj.prev_q))
    return convert.plant_state_from_numpy(d, dtype=dtype, device="cpu")


def _kicked(jcfg, B, seed, dtype):
    """JAX initial state with a numpy-seeded forward-velocity kick (the
    KF comparisons kick vx only: ROADMAP, "Not faults")."""
    s0 = jro.initial_plant_state(jcfg, batch=(B,), dtype=dtype)
    xi = np.asarray(s0.xi).copy()
    xi[:, 9] += 0.05 * np.random.default_rng(seed).standard_normal(B)
    return s0.replace(xi=jnp.asarray(xi))


# ---- rollout(v_des_schedule=) -----------------------------------------------

def test_v_des_schedule_matches_jax_f64():
    """A 60-tick command that ramps vx 0.2 -> 0.8 and swings vy across the
    gait's phase switch at iteration 300 (ticks 270-329): the final state
    and every metric within 1e-8 of JAX's rollout in float64."""
    jcfg, tcfg = JCfg.walking(), TCfg.walking()
    T = 60
    k = np.arange(T)
    sched = np.stack([0.2 + 0.01 * k, 0.1 * np.sin(k / 9.0),
                      np.zeros(T)], 1)
    sj = jro.initial_plant_state(jcfg, dtype=jnp.float64)
    fj, mj = jax.jit(lambda s, v: jro.rollout(
        jcfg, s, T, start_iteration=270.0, v_des_schedule=v))(
            sj, jnp.asarray(sched))
    st = tro.initial_plant_state(tcfg, dtype=torch.float64, device="cpu")
    ft, mt = tro.rollout(tcfg, st, T, start_iteration=270,
                         v_des_schedule=torch.tensor(sched))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ft, f).numpy(),
                                   np.asarray(getattr(fj, f)), atol=1e-8,
                                   rtol=0, err_msg=f)
    assert set(mt) == set(mj)
    for key, v in mt.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(mj[key]),
                                   atol=1e-8, rtol=0, err_msg=key)
    # the schedule is what moved the command: the configured 0.5 m/s
    # differs
    f_cfg, _ = tro.rollout(tcfg, st, T, start_iteration=270)
    assert float((f_cfg.xi - ft.xi).abs().max()) > 1e-6


def test_velocity_ramp_and_stop():
    """tests/test_velocity_profile.py on the port (float32, 1800 ticks):
    ramp 0 -> 0.6 m/s, cruise, stop, with the JAX test's bands."""
    cfg = TCfg.walking()
    steps = 1800
    t = np.arange(steps) / 1000.0
    vx = np.where(t < 0.6, t / 0.6 * 0.6, np.where(t < 1.2, 0.6, 0.0))
    sched = torch.tensor(np.stack([vx, 0 * vx, 0 * vx], 1),
                         dtype=torch.float32)
    final, m = tro.rollout(cfg, tro.initial_plant_state(cfg, device="cpu"),
                           steps, v_des_schedule=sched)
    h, v = m["height"].numpy(), m["velocity"].numpy()
    assert h.min() > 0.5, h.min()
    assert abs(v[900:1150, 0].mean() - 0.6) < 0.2
    assert v[-1, 0] < 0.2, v[-1, 0]
    assert v[-1, 0] < v[1250, 0] * 0.5
    assert not torch.isnan(final.xi).any()


def test_v_des_schedule_refusals():
    """JAX reads a schedule only with mpc_every = 1 and drops it
    otherwise; the port refuses (ROADMAP, "Not faults"), and refuses a
    schedule of the wrong shape."""
    cfg = TCfg.walking()
    s = tro.initial_plant_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="mpc_every"):
        tro.rollout(cfg, s, 10, mpc_every=5, v_des_schedule=torch.zeros(10, 3))
    with pytest.raises(ValueError, match="shape"):
        tro.rollout(cfg, s, 10, v_des_schedule=torch.zeros(9, 3))


# ---- batched_rollout_resident -----------------------------------------------

def _plain_loop(cfg, s, T, start):
    """The tick's plain version in a loop (fused_walking_tick on CPU
    tensors), carrying what plant_step carries; returns the final fields
    and the stacked heights, forces and filter covariances."""
    kf = cfg.estimator_mode == "kf"
    xi, q, fl, fr, z, y = s.xi, s.q, s.foot_l, s.foot_r, s.qp_z, s.qp_lam
    anc = (s.ref_anchor if s.ref_anchor is not None
           else torch.cat([xi[:, 3:5], xi[:, 2:3]], -1))
    kw = dict(kf_x=s.kf.x_hat, kf_p=s.kf.p_cov, prev_v=s.prev_v,
              prev_q=s.prev_q) if kf else {}
    B = xi.shape[0]
    vd = torch.tensor([list(cfg.desired_velocity)] * B)
    h, grf, cov = [], [], []
    for t in range(T):
        out = ttfc.fused_walking_tick(xi, q, fl, fr, z, y, anc, start + t,
                                      vd, torch.zeros(B), cfg=cfg, **kw)
        if kf:
            kw = dict(kf_x=out[10], kf_p=out[11],
                      prev_v=xi[:, 9:12].contiguous(), prev_q=q)
            cov.append(torch.diagonal(out[11], dim1=-2, dim2=-1)[:, 0:3])
        xi, q, fl, fr, z, y, anc = out[:7]
        h.append(xi[:, 5])
        grf.append(out[8])
    return (dict(xi=xi, q=q, foot_l=fl, foot_r=fr, qp_z=z, qp_lam=y,
                 anchor=anc, **kw), torch.stack(h, 1), torch.stack(grf, 1),
            torch.stack(cov, 1) if kf else None)


@pytest.mark.parametrize("T", [4, 5])
@pytest.mark.parametrize("mode,est", [("walk", "truth"), ("walk", "kf"),
                                      ("stand", "truth"), ("stand", "kf")])
def test_resident_cpu_equals_plain_tick_loop(mode, est, T):
    """The resident rollout's CPU loop is the tick's plain version tick
    after tick, double-buffered: equal bit for bit (rtol = atol = 0),
    walking and standing, truth and KF, with staggered iterations across
    the phase switch and an even and an odd tick count."""
    base = TCfg.walking() if mode == "walk" else TCfg.standing()
    cfg = _small(base, est)
    s = tro.initial_plant_state(cfg, batch=(2,), device="cpu")
    s = s.replace(xi=s.xi + torch.tensor([[0.0] * 9 + [0.04, 0, 0, 0],
                                          [0.0] * 9 + [-0.03, 0, 0, 0]]))
    start = torch.tensor([5.0, 297.0])
    f, m = tro.batched_rollout_resident(cfg, s, T, start_iteration=start)
    ref, h, grf, cov = _plain_loop(cfg, s, T, start)
    got = dict(xi=f.xi, q=f.q, foot_l=f.foot_l, foot_r=f.foot_r,
               qp_z=f.qp_z, qp_lam=f.qp_lam)
    if est == "kf":
        got.update(kf_x=f.kf.x_hat, kf_p=f.kf.p_cov, prev_v=f.prev_v,
                   prev_q=f.prev_q)
    if f.ref_anchor is not None:
        got["anchor"] = f.ref_anchor
    for k, v in got.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(m["height"], h, rtol=0, atol=0)
    torch.testing.assert_close(m["grf"], grf, rtol=0, atol=0)
    assert m["grf"].shape == (2, T, 6) and m["velocity"].shape == (2, T, 3)
    if est == "kf":
        torch.testing.assert_close(m["kf_cov_pos"], cov, rtol=0, atol=0)
        assert float(m["est_error"].max()) > 0.0
    else:
        assert set(m) == set(tro.METRIC_KEYS)
        assert float(m["est_error"].abs().max()) == 0.0


@pytest.mark.parametrize("est", ["truth", "kf"])
def test_resident_matches_jax_resident_interpret(est):
    """Against JAX batched_rollout_resident(use_pallas="interpret") at
    horizon 8, B = 2, T = 3: xi 5e-4, q / feet 1e-3, the anchor 1e-5, grf
    2e-1 (tests/test_torch_slice.py::
    test_tick_twin_matches_jax_kernel_interpret); with the filter also
    x_hat 5e-4 and p_cov 1e-5 (tests/test_torch_kf.py)."""
    jcfg, tcfg = _small(JCfg.walking(), est), _small(TCfg.walking(), est)
    B, T = 2, 3
    sj = _kicked(jcfg, B, 13, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        fj, mj = jro.batched_rollout_resident(jcfg, sj, T,
                                              start_iteration=5.0,
                                              use_pallas="interpret")
    ft, mt = tro.batched_rollout_resident(tcfg, _port_state(sj,
                                                            torch.float32),
                                          T, start_iteration=5.0)
    for f, a in (("xi", 5e-4), ("q", 1e-3), ("foot_l", 1e-3),
                 ("foot_r", 1e-3), ("ref_anchor", 1e-5)):
        np.testing.assert_allclose(getattr(ft, f).numpy(),
                                   np.asarray(getattr(fj, f)), atol=a,
                                   rtol=0, err_msg=f)
    assert set(mt) == set(mj)
    for k in mt:
        assert mt[k].shape == np.asarray(mj[k]).shape, k
    np.testing.assert_allclose(mt["grf"].numpy(), np.asarray(mj["grf"]),
                               atol=2e-1, rtol=0)
    np.testing.assert_allclose(mt["height"].numpy(),
                               np.asarray(mj["height"]), atol=5e-4, rtol=0)
    if est == "kf":
        np.testing.assert_allclose(ft.kf.x_hat.numpy(),
                                   np.asarray(fj.kf.x_hat), atol=5e-4,
                                   rtol=0)
        np.testing.assert_allclose(ft.kf.p_cov.numpy(),
                                   np.asarray(fj.kf.p_cov), atol=1e-5,
                                   rtol=0)


def test_resident_refuses_what_the_tick_kernels_do_not_run():
    """A composition config (ControllerConfig() is a cold PDIP) raises, as
    JAX raises without the Pallas kernel; so does a state whose filter
    fields do not match the estimator."""
    cfg = TCfg()
    with pytest.raises(ValueError, match="do not implement"):
        tro.batched_rollout_resident(
            cfg, tro.initial_plant_state(cfg, batch=(1,), device="cpu"), 2)
    kcfg = dataclasses.replace(TCfg.walking(), estimator_mode="kf")
    with pytest.raises(ValueError, match="kf"):
        tro.batched_rollout_resident(kcfg, tro.initial_plant_state(
            TCfg.walking(), batch=(1,), device="cpu"), 2)


# ---- the state constructors ------------------------------------------------

@pytest.mark.parametrize("batch", [(), (3,)])
def test_zeros_constructors_match_jax(batch):
    """OdomState / JointState / ImuData / RobotCmd .zeros: the JAX
    constructors' values, shapes and dtypes (quat w = 1), on the device
    asked for; every state dataclass has .replace."""
    for name, kw in (("OdomState", {}), ("JointState", {"num_joints": 6}),
                     ("ImuData", {}), ("RobotCmd", {"num_joints": 6})):
        zj = getattr(jtypes, name).zeros(batch, **kw)
        zt = getattr(ttypes, name).zeros(batch, **kw, device="cpu")
        for f in dataclasses.fields(zt):
            a, b = getattr(zt, f.name), np.asarray(getattr(zj, f.name))
            assert a.device.type == "cpu"
            assert str(a.dtype).split(".")[-1] == str(b.dtype), (name, f)
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    o = ttypes.OdomState.zeros((1,), dtype=torch.float64, device="cpu")
    o2 = o.replace(pos=torch.ones(1, 3, dtype=torch.float64))
    assert float(o2.pos.sum()) == 3.0 and torch.equal(o2.quat, o.quat)
    for cls in (ttypes.JointState, ttypes.ImuData, ttypes.RobotCmd,
                ttypes.GaitState, ttypes.QPSolution, ttypes.KFState):
        assert callable(getattr(cls, "replace"))
