"""Kernel-vs-plain checks of the port's CUDA kernels; they need the card.

Every test takes the ``cuda_device`` fixture, which skips when
``torch.cuda.is_available()`` is false, so on a CPU-only machine they all
skip. On a CUDA machine (which need not have JAX) run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest \
        -o addopts='' -p no:cacheprovider -q

This file imports only torch, numpy and the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpc_limx_control_tpu_torch.control import controller as ctrl
from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import JointState
from mpc_limx_control_tpu_torch.models import srbd
from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as mfc
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _cfg(N):
    base = ControllerConfig.walking()
    return dataclasses.replace(
        base, srbd=dataclasses.replace(base.srbd, horizon=N))


def _prep_inputs(cfg, B, seed, device):
    N = cfg.srbd.horizon
    rng = np.random.default_rng(seed)
    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    yaw = 0.1 * rng.standard_normal(B)
    arms = (pos[:, None, :] + np.array([0.02, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, N, 3)))
    ori = np.concatenate([0.01 * rng.standard_normal((B, 2)), yaw[:, None]],
                         -1)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    x0 = srbd.initial_state(t(ori), t(pos), t(np.zeros((B, 3))),
                            t(np.array([0.4, 0.0, 0.0]) + np.zeros((B, 3))))
    anchor = torch.cat([x0[:, 3:5], x0[:, 2:3]], -1).contiguous()
    return (t(arms), x0.contiguous(), t(np.tile([0.5, 0.0, 0.0], (B, 1))),
            t(0.05 * rng.standard_normal(B)),
            t(5.0 * rng.standard_normal((B, 3 * N))),
            t(np.abs(rng.standard_normal((B, 6 * N)))), anchor)


def _states(cfg, B, seed, device, yaw=0.1):
    s0 = ro.initial_plant_state(cfg, batch=(B,), device=device)
    rng = np.random.default_rng(seed)
    xi = s0.xi.clone()
    n = torch.tensor(rng.standard_normal((3, B)), dtype=torch.float32,
                     device=device)
    xi[:, 9] += 0.08 * n[0]
    xi[:, 10] += 0.05 * n[1]
    xi[:, 2] += yaw * n[2]
    return s0.replace(xi=xi)


@pytest.mark.parametrize("N", [20, 8])
def test_prep_kernel_matches_plain(cuda_device, N):
    cfg = _cfg(N)
    args = _prep_inputs(cfg, 257, 21 + N, cuda_device)
    before = mfc.WALKING_MPC_PREP.launches
    z, y, res, xp = mfc.fused_walking_qp_prep(*args, cfg=cfg)
    assert mfc.WALKING_MPC_PREP.launches == before + 1
    sol, xp_p, (z_p, y_p) = mfc.walking_qp_prep_plain(cfg, *args,
                                                      solve_form="subst")
    scale = float(z_p.abs().max()) + 1.0
    torch.testing.assert_close(z, z_p, atol=2e-3 * scale, rtol=0)
    torch.testing.assert_close(y, y_p, atol=2e-3 * scale, rtol=0)
    torch.testing.assert_close(xp, xp_p, atol=1e-3 * scale, rtol=0)
    torch.testing.assert_close(res, sol.residual, atol=1e-2, rtol=0.5)


def test_tick_kernel_matches_plain(cuda_device):
    cfg = ControllerConfig.walking()
    B = 257
    s0 = _states(cfg, B, 0, cuda_device)
    its = _staggered(B, cuda_device)
    before = tfc.WALKING_TICK.launches
    s_k, m_k = ro.plant_step(cfg, s0, its)
    assert tfc.WALKING_TICK.launches == before + 1
    s_p, m_p = ro._plant_step_ref(cfg, s0, its, solve_form="subst")
    for k, a in (("xi", 3e-4), ("q", 5e-4), ("foot_l", 5e-4),
                 ("foot_r", 5e-4), ("ref_anchor", 1e-5)):
        torch.testing.assert_close(getattr(s_k, k), getattr(s_p, k),
                                   atol=a, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_p["grf"], atol=5e-2, rtol=0)
    torch.testing.assert_close(s_k.qp_z[:, :9], s_p.qp_z[:, :9], atol=5e-2,
                               rtol=0)
    s_k = s_p = s0
    for j in range(5):
        s_k, m_k = ro.plant_step(cfg, s_k, its + 10.0 + j)
        s_p, m_p = ro._plant_step_ref(cfg, s_p, its + 10.0 + j,
                                      solve_form="subst")
    torch.testing.assert_close(s_k.xi, s_p.xi, atol=5e-4, rtol=0)
    torch.testing.assert_close(s_k.q, s_p.q, atol=1e-3, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_p["grf"], atol=2e-1, rtol=0)


def _staggered(B, device):
    pattern = torch.tensor([0.0, 40.0, 180.0, 299.0, 300.0, 455.0],
                           device=device)
    return pattern.repeat(B // 6 + 1)[:B]


@pytest.mark.parametrize("variant", ["hold", "kf", "kf_hold"])
def test_tick_variant_matches_plain(cuda_device, variant):
    """walking_tick_hold / _kf / _kf_hold against the plain tick at
    B = 257, staggered phases, from states three plain ticks in (so the
    filter and prev_v / prev_q are past their seed): one tick, then five
    threaded ticks, each launching its kernel once."""
    est_kf, hold = variant.startswith("kf"), variant.endswith("hold")
    cfg = ControllerConfig.walking()
    if est_kf:
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    kern = tfc.TICK_KERNELS[(est_kf, hold)]
    B = 257
    # the filter's states get no yaw kick (as in the JAX KF tests): a yaw
    # off the joints' frame puts its measured feet ~10 cm from its state,
    # and within three ticks some swing targets leave the leg's reach,
    # where the IK branch is a tie that rounding decides
    s0 = _states(cfg, B, 0, cuda_device, yaw=0.0 if est_kf else 0.1)
    its = _staggered(B, cuda_device)
    for j in range(3):
        s0, m0 = ro._plant_step_ref(cfg, s0, its + j, solve_form="subst")
    its = its + 3.0
    held = m0["grf"] if hold else None
    before = kern.launches
    s_k, m_k = ro.plant_step(cfg, s0, its, grf_override=held)
    assert kern.launches == before + 1
    s_p, m_p = ro._plant_step_ref(cfg, s0, its, grf_override=held,
                                  solve_form="subst")
    for k, a in (("xi", 3e-4), ("q", 5e-4), ("foot_l", 5e-4),
                 ("foot_r", 5e-4), ("ref_anchor", 1e-5)):
        torch.testing.assert_close(getattr(s_k, k), getattr(s_p, k),
                                   atol=a, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_p["grf"], atol=5e-2, rtol=0)
    torch.testing.assert_close(m_k["foot_target"], m_p["foot_target"],
                               atol=5e-4, rtol=0)
    if hold:
        assert float(m_k["qp_residual"].abs().max()) == 0.0
        assert s_k.qp_z is s0.qp_z and s_k.qp_lam is s0.qp_lam
    if est_kf:
        torch.testing.assert_close(s_k.kf.x_hat, s_p.kf.x_hat, atol=5e-4,
                                   rtol=0)
        torch.testing.assert_close(s_k.kf.p_cov, s_p.kf.p_cov, atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(m_k["est_error"], m_p["est_error"],
                                   atol=5e-4, rtol=0)
    s_k = s_p = s0
    for j in range(5):
        s_k, m_k = ro.plant_step(cfg, s_k, its + j, grf_override=held)
        s_p, m_p = ro._plant_step_ref(cfg, s_p, its + j, grf_override=held,
                                      solve_form="subst")
    assert kern.launches == before + 6
    torch.testing.assert_close(s_k.xi, s_p.xi, atol=5e-4, rtol=0)
    torch.testing.assert_close(s_k.q, s_p.q, atol=1e-3, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_p["grf"], atol=2e-1, rtol=0)
    if est_kf:
        torch.testing.assert_close(s_k.kf.x_hat, s_p.kf.x_hat, atol=5e-4,
                                   rtol=0)
        torch.testing.assert_close(s_k.kf.p_cov, s_p.kf.p_cov, atol=1e-5,
                                   rtol=0)


def test_dtmpc_rollout_launch_counts(cuda_device):
    """batched_rollout(mpc_every=5) with the KF: one tick in five runs
    the solving kernel, four the hold kernel."""
    cfg = dataclasses.replace(ControllerConfig.walking(),
                              estimator_mode="kf")
    s = ro.initial_plant_state(cfg, batch=(8,), device=cuda_device)
    counts = [k.launches for k in tfc.TICK_KERNELS.values()]
    _, m = ro.batched_rollout(cfg, s, 50, mpc_every=5)
    after = dict(zip(tfc.TICK_KERNELS, (k.launches - c for k, c in zip(
        tfc.TICK_KERNELS.values(), counts))))
    assert after == {(False, False): 0, (False, True): 0, (True, False): 10,
                     (True, True): 40}
    assert bool(torch.isfinite(m["kf_cov_pos"]).all())
    res = m["qp_residual"]
    assert float(res[:, 1::5].abs().max()) == 0.0 and bool(
        (res[:, ::5] > 0).all())


def test_controller_tick_launches_prep_kernel(cuda_device):
    cfg = ControllerConfig.walking()
    s = _states(cfg, 16, 1, cuda_device)
    z = torch.zeros_like(s.q)
    before = mfc.WALKING_MPC_PREP.launches
    _, dg = ctrl.tick(cfg, ro._odom_from_xi(s.xi), JointState(q=s.q, dq=z,
                                                              tau=z),
                      torch.full((16,), 77.0, device=cuda_device),
                      qp_warm=(s.qp_z, s.qp_lam), ref_anchor=s.ref_anchor)
    assert mfc.WALKING_MPC_PREP.launches == before + 1
    assert bool(torch.isfinite(dg.grf).all())


def test_unsupported_configs_raise_on_cuda(cuda_device):
    cfg = ControllerConfig.walking()
    s = ro.initial_plant_state(cfg, batch=(2,), device=cuda_device)
    it = torch.zeros(2, device=cuda_device)
    # held ticks (K4) are ported: they launch the hold variant
    before = tfc.WALKING_TICK_HOLD.launches
    ro.plant_step(cfg, s, it, grf_override=torch.zeros(
        2, 6, device=cuda_device))
    assert tfc.WALKING_TICK_HOLD.launches == before + 1
    rec = dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, attitude_ref="receding"))
    with pytest.raises(NotImplementedError, match="level-attitude"):
        ro.plant_step(rec, s, it)
    # standing (K6) is ported: it launches the standing kernel
    stand = ControllerConfig.standing()
    before = tfc.STAND_KERNELS[(False, False)].launches
    ro.plant_step(stand, ro.initial_plant_state(
        stand, batch=(2,), device=cuda_device), it)
    assert tfc.STAND_KERNELS[(False, False)].launches == before + 1
    inv = dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, solver=dataclasses.replace(cfg.srbd.solver,
                                             solve_form="inv")))
    with pytest.raises(NotImplementedError, match="K1"):
        ro.plant_step(inv, s, it)


def _stand_states(cfg, B, seed, device):
    """Standing states with a velocity kick (vx, vy; no yaw: see the KF
    note above), the QP warm state zero."""
    s0 = ro.initial_plant_state(cfg, batch=(B,), device=device)
    rng = np.random.default_rng(seed)
    xi = s0.xi.clone()
    n = torch.tensor(rng.standard_normal((2, B)), dtype=torch.float32,
                     device=device)
    xi[:, 9] += 0.05 * n[0]
    xi[:, 10] += 0.05 * n[1]
    return s0.replace(xi=xi)


@pytest.mark.parametrize("variant", ["solve", "hold", "kf", "kf_hold"])
def test_stand_tick_variant_matches_plain(cuda_device, variant):
    """standing_tick / _hold / _kf / _kf_hold against the plain standing
    tick at B = 257 and full width (n = 120), from states three plain
    ticks in: one tick, then five threaded ticks, each one launch."""
    est_kf, hold = variant.startswith("kf"), variant.endswith("hold")
    cfg = ControllerConfig.standing()
    if est_kf:
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    kern = tfc.STAND_KERNELS[(est_kf, hold)]
    B = 257
    s0 = _stand_states(cfg, B, 2, cuda_device)
    its = _staggered(B, cuda_device)
    for j in range(3):
        s0, m0 = ro._plant_step_ref(cfg, s0, its + j, solve_form="subst")
    its = its + 3.0
    held = m0["grf"] if hold else None
    before = kern.launches
    s_k, m_k = ro.plant_step(cfg, s0, its, grf_override=held)
    assert kern.launches == before + 1
    s_p, m_p = ro._plant_step_ref(cfg, s0, its, grf_override=held,
                                  solve_form="subst")
    assert s_k.ref_anchor is None and s_k.qp_z.shape == (B, 120)
    for k, a in (("xi", 3e-4), ("q", 5e-4), ("foot_l", 0.0),
                 ("foot_r", 0.0)):
        torch.testing.assert_close(getattr(s_k, k), getattr(s_p, k),
                                   atol=a, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_p["grf"], atol=5e-2, rtol=0)
    torch.testing.assert_close(m_k["foot_target"], m_p["foot_target"],
                               atol=5e-4, rtol=0)
    if hold:
        assert float(m_k["qp_residual"].abs().max()) == 0.0
        assert s_k.qp_z is s0.qp_z and s_k.qp_lam is s0.qp_lam
        torch.testing.assert_close(m_k["grf"], held, atol=0, rtol=0)
    else:
        scale = float(s_p.qp_z.abs().max()) + 1.0
        torch.testing.assert_close(s_k.qp_z, s_p.qp_z, atol=2e-3 * scale,
                                   rtol=0)
        torch.testing.assert_close(s_k.qp_lam, s_p.qp_lam,
                                   atol=2e-3 * scale, rtol=0)
    if est_kf:
        torch.testing.assert_close(s_k.kf.x_hat, s_p.kf.x_hat, atol=5e-4,
                                   rtol=0)
        torch.testing.assert_close(s_k.kf.p_cov, s_p.kf.p_cov, atol=1e-5,
                                   rtol=0)
    s_k = s_p = s0
    for j in range(5):
        s_k, m_k = ro.plant_step(cfg, s_k, its + j, grf_override=held)
        s_p, m_p = ro._plant_step_ref(cfg, s_p, its + j, grf_override=held,
                                      solve_form="subst")
    assert kern.launches == before + 6
    torch.testing.assert_close(s_k.xi, s_p.xi, atol=5e-4, rtol=0)
    torch.testing.assert_close(s_k.q, s_p.q, atol=1e-3, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_p["grf"], atol=2e-1, rtol=0)


def _qp_inputs(cfg, nu, B, seed, device):
    """Inputs of the generic fused QP: the SRBD matrices of perturbed
    poses with a dense perturbation on Ad (the kernel takes any Ad), a
    walking reference, a warm state."""
    N = cfg.srbd.horizon
    rng = np.random.default_rng(seed)
    feet = nu // 3

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    ori = np.concatenate([0.01 * rng.standard_normal((B, 2)),
                          0.1 * rng.standard_normal((B, 1))], -1)
    x0 = srbd.initial_state(t(ori), t(pos), t(np.zeros((B, 3))),
                            t(0.1 * rng.standard_normal((B, 3))))
    arms = (pos[:, None, None, :] + np.array([0.0, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, N, feet, 3)))
    if feet == 2:
        arms[:, :, 1, 1] -= 0.2
    Ac, Bc = srbd.linearize_shared(cfg.robot, t(arms.reshape(B, -1, 3)),
                                   x0[:, 3:6], x0[:, 2])
    Ad, Bd = srbd.discretize_srbd(Ac, Bc, cfg.srbd.ts)
    Bd_t = Bd.reshape(B, N, feet, 13, 3).permute(0, 1, 3, 2, 4).reshape(
        B, N, 13, nu)
    Ad = Ad + t(2e-3 * rng.standard_normal((B, 13, 13)))
    x_ref = srbd.walking_reference(
        x0, cfg.srbd, N, t(np.tile([0.3, 0.0, 0.0], (B, 1))),
        t(0.05 * rng.standard_normal(B)), height_des=0.65)
    return (Ad.contiguous(), Bd_t.contiguous(), x_ref.contiguous(),
            x0.contiguous(), t(5.0 * rng.standard_normal((B, N * nu))),
            t(np.abs(rng.standard_normal((B, 2 * N * nu)))))


@pytest.mark.parametrize("nu", [3, 6])
@pytest.mark.parametrize("N", [20, 8])
def test_fused_qp_matches_plain(cuda_device, nu, N):
    """fused_qp_nu3 / _nu6 through make_admm_fused against the plain
    condense + exact-solve ADMM at B = 257, with a dense Ad."""
    cfg = _cfg(N)
    args = _qp_inputs(cfg, nu, 257, 40 + nu + N, cuda_device)
    kern = mfc.FUSED_QP[nu]
    before = kern.launches
    sol, (z, y) = mfc.make_admm_fused(cfg.srbd, two_feet=nu == 6)(*args)
    assert kern.launches == before + 1
    sol_p, (z_p, y_p) = mfc.make_admm_fused(
        cfg.srbd, two_feet=nu == 6, solve_form="subst")(*args)
    # a few times the f32 rounding between the two routes, each on its
    # own scale (forces ~100 N, duals a few N)
    scale = float(z_p.abs().max()) + 1.0
    y_scale = float(y_p.abs().max()) + 1.0
    torch.testing.assert_close(z, z_p, atol=1e-4 * scale, rtol=0)
    torch.testing.assert_close(y, y_p, atol=1e-4 * y_scale, rtol=0)
    torch.testing.assert_close(sol.residual, sol_p.residual, atol=1e-4,
                               rtol=0)


def test_stand_rollout_launch_counts(cuda_device):
    """Standing batched_rollout(mpc_every=5) with the KF: one tick in five
    runs standing_tick_kf, four standing_tick_kf_hold; controller.tick in
    stand mode launches fused_qp_nu6."""
    cfg = dataclasses.replace(ControllerConfig.standing(),
                              estimator_mode="kf")
    s = ro.initial_plant_state(cfg, batch=(8,), device=cuda_device)
    kernels = {**tfc.TICK_KERNELS,
               **{("stand", *k): v for k, v in tfc.STAND_KERNELS.items()}}
    counts = {k: v.launches for k, v in kernels.items()}
    _, m = ro.batched_rollout(cfg, s, 50, mpc_every=5)
    after = {k: v.launches - counts[k] for k, v in kernels.items()}
    want = {k: 0 for k in kernels}
    want[("stand", True, False)] = 10
    want[("stand", True, True)] = 40
    assert after == want
    assert bool(torch.isfinite(m["kf_cov_pos"]).all())
    assert abs(float(m["height"][:, -1].mean()) - 0.65) < 0.01
    truth = ControllerConfig.standing()
    st = _stand_states(truth, 16, 1, cuda_device)
    z = torch.zeros_like(st.q)
    before = mfc.FUSED_QP[6].launches
    _, dg = ctrl.tick(truth, ro._odom_from_xi(st.xi),
                      JointState(q=st.q, dq=z, tau=z),
                      torch.zeros(16, device=cuda_device),
                      qp_warm=(st.qp_z, st.qp_lam))
    assert mfc.FUSED_QP[6].launches == before + 1
    _, dg_p = ctrl.tick(truth, ro._odom_from_xi(st.xi),
                        JointState(q=st.q, dq=z, tau=z),
                        torch.zeros(16, device=cuda_device),
                        qp_warm=(st.qp_z, st.qp_lam), solve_form="subst")
    torch.testing.assert_close(dg.grf, dg_p.grf, atol=5e-2, rtol=0)


def test_wrappers_check_dtype_and_layout(cuda_device):
    cfg = ControllerConfig.walking()
    args = list(_prep_inputs(cfg, 4, 3, cuda_device))
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(TypeError, match="float32"):
        mfc.fused_walking_qp_prep(*bad, cfg=cfg)
    bad = list(args)
    bad[4] = args[4].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        mfc.fused_walking_qp_prep(*bad, cfg=cfg)
    bad = list(args)
    bad[0] = args[0][:, :5].contiguous()
    with pytest.raises(ValueError, match="shape"):
        mfc.fused_walking_qp_prep(*bad, cfg=cfg)
