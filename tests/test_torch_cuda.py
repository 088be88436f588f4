"""Kernel-vs-plain checks of the port's CUDA kernels; they need the card.

Every test takes the ``cuda_device`` fixture, which skips when
``torch.cuda.is_available()`` is false, so on a CPU-only machine they all
skip. On a CUDA machine (which need not have JAX) run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest \
        -o addopts='' -p no:cacheprovider -q

This file imports only torch, numpy, the port and chip_smoke.py (the K9
check).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_limx_control_tpu_torch.control import controller as ctrl
from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import JointState
from mpc_limx_control_tpu_torch.models import srbd
from mpc_limx_control_tpu_torch.ops import chol as cholp
from mpc_limx_control_tpu_torch.ops import chol_cuda
from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as mfc
from mpc_limx_control_tpu_torch.ops import qp as qps
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


@pytest.mark.parametrize("N", [20, 8, 22, 42, 85])
def test_prep_kernel_matches_plain(cuda_device, N):
    """walking_mpc_prep against the plain composition with exact solves at
    B = 257, at the walking tuning's N = 20, a short horizon and past the
    21 steps the nu = 3 core once took (n = 66, 126, 255: two, four and
    eight solve rows a lane)."""
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
    kern = ro.tick_route(cfg).solve
    assert kern.name == "walking_tick"
    before = kern.launches
    s_k, m_k = ro.plant_step(cfg, s0, its)
    assert kern.launches == before + 1
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


@pytest.mark.parametrize("N", [22, 42, 85])
@pytest.mark.parametrize("est_kf", [False, True])
def test_walking_tick_past_21_steps_matches_plain(cuda_device, est_kf, N):
    """walking_tick / walking_tick_kf past the 21 steps the nu = 3 core
    once took, one tick through plant_step against the plain tick at
    B = 257 from states three plain ticks in, with the N = 20 bands."""
    base = ControllerConfig.walking()
    if est_kf:
        base = dataclasses.replace(base, estimator_mode="kf")
    cfg = _horizon(base, N)
    B = 257
    s0 = _states(cfg, B, 5, cuda_device, yaw=0.0 if est_kf else 0.1)
    its = _staggered(B, cuda_device)
    for j in range(3):
        s0, _ = ro._plant_step_ref(cfg, s0, its + j, solve_form="subst")
    its = its + 3.0
    kern = ro.tick_route(cfg).solve
    before = kern.launches
    s_k, m_k = ro.plant_step(cfg, s0, its)
    assert kern.launches == before + 1
    s_p, m_p = ro._plant_step_ref(cfg, s0, its, solve_form="subst")
    for k, a in (("xi", 3e-4), ("q", 5e-4), ("foot_l", 5e-4),
                 ("foot_r", 5e-4), ("ref_anchor", 1e-5)):
        torch.testing.assert_close(getattr(s_k, k), getattr(s_p, k),
                                   atol=a, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_p["grf"], atol=5e-2, rtol=0)
    torch.testing.assert_close(s_k.qp_z[:, :9], s_p.qp_z[:, :9], atol=5e-2,
                               rtol=0)
    assert s_k.qp_z.shape == (B, 3 * N)


def _staggered(B, device):
    pattern = torch.tensor([0.0, 40.0, 180.0, 299.0, 300.0, 455.0],
                           device=device)
    return pattern.repeat(B // 6 + 1)[:B]


@pytest.mark.parametrize("B", [257, 1, 4096])
@pytest.mark.parametrize("variant", ["hold", "kf", "kf_hold"])
def test_tick_variant_matches_plain(cuda_device, variant, B):
    """walking_tick_hold / _kf / _kf_hold against the plain tick at
    B = 257 (not a multiple of a block's scenarios), 1 and 4096, staggered
    phases, from states three plain ticks in (so the filter and prev_v /
    prev_q are past their seed): one tick, then five threaded ticks, each
    launching its kernel once."""
    est_kf, hold = variant.startswith("kf"), variant.endswith("hold")
    cfg = ControllerConfig.walking()
    if est_kf:
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    route = ro.tick_route(cfg)
    kern = route.hold if hold else route.solve
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
    walking = {(est == "kf", hold): k
               for (mode, est, hold, form), k in tfc.TICK_TABLE.items()
               if mode == "walk" and form == "subst"}
    counts = [k.launches for k in walking.values()]
    _, m = ro.batched_rollout(cfg, s, 50, mpc_every=5)
    after = dict(zip(walking, (k.launches - c for k, c in zip(
        walking.values(), counts))))
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
    kern = ro.tick_route(cfg).hold
    assert kern.name == "walking_tick_hold"
    before = kern.launches
    ro.plant_step(cfg, s, it, grf_override=torch.zeros(
        2, 6, device=cuda_device))
    assert kern.launches == before + 1
    # the receding reference runs the composition: its QP's factorization
    # is the cholesky kernel, no tick kernel launches
    rec = dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, attitude_ref="receding"))
    ticks = [k.launches for k in tfc.TICK_TABLE.values()]
    before = chol_cuda.CHOLESKY.launches
    ro.plant_step(rec, s, it)
    assert chol_cuda.CHOLESKY.launches == before + 1
    assert [k.launches for k in tfc.TICK_TABLE.values()] == ticks
    # an unknown value still raises
    with pytest.raises(NotImplementedError, match="ik_method"):
        ro.plant_step(dataclasses.replace(cfg, ik_method="x"), s, it)
    # standing (K6) is ported: it launches the standing kernel
    stand = ControllerConfig.standing()
    kern = ro.tick_route(stand).solve
    assert kern.name == "standing_tick"
    before = kern.launches
    ro.plant_step(stand, ro.initial_plant_state(
        stand, batch=(2,), device=cuda_device), it)
    assert kern.launches == before + 1
    inv = dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, solver=dataclasses.replace(cfg.srbd.solver,
                                             solve_form="inv")))
    # solve_form="inv" (K1) is ported: walking launches the inv entry
    # point
    kern = ro.tick_route(inv).solve
    assert kern.name == "walking_tick_inv"
    before = kern.launches
    ro.plant_step(inv, s, it)
    assert kern.launches == before + 1
    # standing launches its inv entry point (which at n = 120 > 64 runs the
    # substitution sweeps)
    sinv = dataclasses.replace(stand, srbd=inv.srbd)
    kern = ro.tick_route(sinv).solve
    assert kern.name == "standing_tick_inv"
    before = kern.launches
    ro.plant_step(sinv, ro.initial_plant_state(
        sinv, batch=(2,), device=cuda_device), it)
    assert kern.launches == before + 1


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


@pytest.mark.parametrize("B", [257, 1, 4096])
@pytest.mark.parametrize("variant", ["solve", "hold", "kf", "kf_hold"])
def test_stand_tick_variant_matches_plain(cuda_device, variant, B):
    """standing_tick / _hold / _kf / _kf_hold against the plain standing
    tick at B = 257, 1 and 4096 and full width (n = 120), from states
    three plain ticks in: one tick, then five threaded ticks, each one
    launch."""
    _stand_variant_vs_plain(cuda_device, variant, 20, B)


@pytest.mark.parametrize("variant", ["solve", "kf"])
def test_stand_tick_n30_matches_plain(cuda_device, variant):
    """The solving standing forms past the 21 steps the core once took:
    N = 30 (n = 180, eight solve rows a lane), the bands above."""
    _stand_variant_vs_plain(cuda_device, variant, 30)


def _stand_variant_vs_plain(cuda_device, variant, N, B=257, inv=False):
    """One tick, then five threaded ticks, of a standing form against the
    plain tick (with solve_form="inv", the "linv" twin where n <= 64)."""
    est_kf, hold = variant.startswith("kf"), variant.endswith("hold")
    cfg = _horizon(ControllerConfig.standing(), N)
    if est_kf:
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    if inv:
        cfg = _inv(cfg)
    form = mfc.plain_solve_form(cfg.srbd.solver.solve_form, 6, N)
    route = ro.tick_route(cfg)
    kern = route.hold if hold else route.solve
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
                                  solve_form=form)
    assert s_k.ref_anchor is None and s_k.qp_z.shape == (B, 6 * N)
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
                                      solve_form=form)
    assert kern.launches == before + 6
    torch.testing.assert_close(s_k.xi, s_p.xi, atol=5e-4, rtol=0)
    torch.testing.assert_close(s_k.q, s_p.q, atol=1e-3, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_p["grf"], atol=2e-1, rtol=0)


@pytest.mark.parametrize("B", [1, 257, 4096])
@pytest.mark.parametrize("mode", ["walk", "stand"])
def test_kf_hold_kernels_across_a_phase_switch(cuda_device, mode, B):
    """walking_tick_kf_hold / standing_tick_kf_hold against the plain tick
    over five threaded held ticks that cross a gait phase switch
    (iterations 298 to 302 walking, 498 to 502 standing, staggered by the
    pattern of _staggered: 300 and 600 are switches walking, 500 and 1000
    standing), from states three plain ticks in, each
    tick one launch: the one-tick bands of test_tick_variant_matches_plain
    after the first tick, its five-tick bands after the fifth. Walking,
    the switch scales the swinging foot's measurement noise by the
    filter's high_suspect_number, and S's conditioning with it: there
    x_hat may part from the plain f32 tick by more than its band (the two
    f32 routes, the kernel's bit for bit the one-warp filter's before it),
    and then it passes only if the kernel is within twice the plain f32
    tick's distance of the plain tick in float64."""
    _hold_across_a_phase_switch(cuda_device, mode, B, est_kf=True)


@pytest.mark.parametrize("B", [1, 257, 4096])
@pytest.mark.parametrize("mode", ["walk", "stand"])
def test_truth_hold_kernels_across_a_phase_switch(cuda_device, mode, B):
    """walking_tick_hold / standing_tick_hold (a half warp a scenario, two
    a warp; B = 257 leaves a half warp that repeats the last scenario)
    against the plain tick over the five held ticks of the KF case above,
    across the same phase switch (walking, the held force moves to the
    other foot at 300), with its one-tick and five-tick bands; the walking
    states also get the yaw kick of test_tick_variant_matches_plain."""
    _hold_across_a_phase_switch(cuda_device, mode, B, est_kf=False)


def _hold_across_a_phase_switch(device, mode, B, est_kf):
    cfg = (ControllerConfig.walking() if mode == "walk"
           else ControllerConfig.standing())
    if est_kf:
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    kern = ro.tick_route(cfg).hold
    assert kern.name == f"{'walking' if mode == 'walk' else 'standing'}" \
        f"_tick{'_kf' if est_kf else ''}_hold"
    s0 = (_states(cfg, B, 3, device, yaw=0.0 if est_kf else 0.1)
          if mode == "walk" else _stand_states(cfg, B, 3, device))
    its = _staggered(B, device) + (295.0 if mode == "walk" else 495.0)
    for j in range(3):
        s0, m0 = ro._plant_step_ref(cfg, s0, its + j, solve_form="subst")
    its = its + 3.0
    held = m0["grf"]
    before = kern.launches
    s_k = s_p = s0
    for j in range(5):
        s_k, m_k = ro.plant_step(cfg, s_k, its + j, grf_override=held)
        s_p, m_p = ro._plant_step_ref(cfg, s_p, its + j, grf_override=held,
                                      solve_form="subst")
        if j == 0:
            for k, a in (("xi", 3e-4), ("q", 5e-4), ("foot_l", 5e-4),
                         ("foot_r", 5e-4)):
                torch.testing.assert_close(getattr(s_k, k), getattr(s_p, k),
                                           atol=a, rtol=0)
            if est_kf:
                torch.testing.assert_close(s_k.kf.x_hat, s_p.kf.x_hat,
                                           atol=5e-4, rtol=0)
                torch.testing.assert_close(s_k.kf.p_cov, s_p.kf.p_cov,
                                           atol=1e-5, rtol=0)
            torch.testing.assert_close(m_k["foot_target"],
                                       m_p["foot_target"], atol=5e-4, rtol=0)
        assert float(m_k["qp_residual"].abs().max()) == 0.0
    assert kern.launches == before + 5
    torch.testing.assert_close(s_k.xi, s_p.xi, atol=5e-4, rtol=0)
    torch.testing.assert_close(s_k.q, s_p.q, atol=1e-3, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_p["grf"], atol=2e-1, rtol=0)
    if not est_kf:
        return
    torch.testing.assert_close(s_k.kf.p_cov, s_p.kf.p_cov, atol=1e-5, rtol=0)
    err = float((s_k.kf.x_hat - s_p.kf.x_hat).abs().max())
    if err > 5e-4:
        s_d = ro._map_state(s0, lambda x: x.cpu().double())
        for j in range(5):
            s_d, _ = ro._plant_step_ref(
                cfg, s_d, (its + j).cpu().double(),
                grf_override=held.cpu().double(), solve_form="subst")
        x64 = s_d.kf.x_hat
        k64 = float((s_k.kf.x_hat.cpu().double() - x64).abs().max())
        p64 = float((s_p.kf.x_hat.cpu().double() - x64).abs().max())
        assert k64 <= 2.0 * p64, (err, k64, p64)


def test_hold_kernels_run_as_one_wave(cuda_device):
    """Each held-force form holds at least four blocks of 128 threads an
    SM (tick_common.cuh HOLD_MIN_BLOCKS: at most 128 registers a thread),
    so that B = 4096 scenarios, eight a block, run as one wave on the
    H100's 132 SMs."""
    lib = chol_cuda._build.build_library()["lib"]
    per_sm = {name: getattr(lib, name + "_blocks_per_sm")()
              for name in chol_cuda._build.HOLD_ENTRIES}
    assert min(per_sm.values()) >= 4, per_sm


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
    _fused_qp_vs_plain(cuda_device, nu, N)


def test_fused_qp_nu6_past_21_steps_matches_plain(cuda_device):
    """fused_qp_nu6 at N = 30 (n = 180, eight solve rows a lane), the bands
    above; nu = 6 refuses past 42 steps and nu = 3 past 85."""
    _fused_qp_vs_plain(cuda_device, 6, 30)
    args = _qp_inputs(_cfg(43), 6, 2, 1, cuda_device)
    with pytest.raises(ValueError, match="1 to 42 steps"):
        mfc.make_admm_fused(_cfg(43).srbd, two_feet=True)(*args)
    args = _qp_inputs(_cfg(86), 3, 2, 1, cuda_device)
    with pytest.raises(ValueError, match="1 to 85 steps"):
        mfc.make_admm_fused(_cfg(86).srbd)(*args)


@pytest.mark.parametrize("N", [22, 42])
def test_fused_qp_nu3_past_21_steps_matches_plain(cuda_device, N):
    """fused_qp_nu3 past the 21 steps the nu = 3 core once took (n = 66,
    126: two and four solve rows a lane), the bands above."""
    _fused_qp_vs_plain(cuda_device, 3, N)


def test_fused_qp_nu3_at_85_steps_against_f64(cuda_device):
    """fused_qp_nu3 at its longest horizon, N = 85 (n = 255, eight solve
    rows a lane), where over 85 steps of the perturbed dense Ad the kernel
    and the plain f32 version part by more than the shorter horizons' 1e-4
    of the solution scale: each output held against the plain version in
    float64 on the CPU, the kernel's error at most twice the plain f32
    version's (an f32 route no worse than the reference route)."""
    nu, N = 3, 85
    cfg = _cfg(N)
    args = _qp_inputs(cfg, nu, 257, 40 + nu + N, cuda_device)
    solve = mfc.make_admm_fused(cfg.srbd)
    plain = mfc.make_admm_fused(cfg.srbd, solve_form="subst")
    before = mfc.FUSED_QP[nu].launches
    sol, zy = solve(*args)
    assert mfc.FUSED_QP[nu].launches == before + 1
    sol_p, zy_p = plain(*args)
    sol_d, zy_d = plain(*[a.cpu().double() for a in args])
    for k, a, p_, d in zip(("z", "y", "res"), zy + (sol.residual,),
                           zy_p + (sol_p.residual,),
                           zy_d + (sol_d.residual,)):
        err_k = float((a.cpu().double() - d).abs().max())
        err_p = float((p_.cpu().double() - d).abs().max())
        assert err_k <= 2.0 * err_p, (k, err_k, err_p)


def test_fused_qp_nu6_at_42_steps_matches_f64(cuda_device):
    """fused_qp_nu6 at its longest horizon, N = 42 (n = 252, the last lane
    of each eight-row block short). z and the residual within the bands
    above of the plain f32 version; the duals y, where the two f32 routes
    part on a few elements by more than the shorter horizons' 1e-4 of the
    dual scale (3.06e-3 against 2.23e-3 on 2 of 129,528 duals on an H100;
    the plain f32 version alone is 2.3e-3 from float64 there),
    held against the plain version in float64 on the CPU: the kernel's
    error at most twice the plain f32 version's."""
    cfg = _cfg(42)
    args = _qp_inputs(cfg, 6, 257, 88, cuda_device)
    solve = mfc.make_admm_fused(cfg.srbd, two_feet=True)
    plain = mfc.make_admm_fused(cfg.srbd, two_feet=True, solve_form="subst")
    before = mfc.FUSED_QP[6].launches
    sol, (z, y) = solve(*args)
    assert mfc.FUSED_QP[6].launches == before + 1
    sol_p, (z_p, y_p) = plain(*args)
    _, (_, y_d) = plain(*[a.cpu().double() for a in args])
    scale = float(z_p.abs().max()) + 1.0
    torch.testing.assert_close(z, z_p, atol=1e-4 * scale, rtol=0)
    torch.testing.assert_close(sol.residual, sol_p.residual, atol=1e-4,
                               rtol=0)
    err_k = float((y.cpu().double() - y_d).abs().max())
    err_p = float((y_p.cpu().double() - y_d).abs().max())
    assert err_k <= 2.0 * err_p, (err_k, err_p)


def _fused_qp_vs_plain(cuda_device, nu, N):
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
    kernels = {(mode, est == "kf", hold): k
               for (mode, est, hold, form), k in tfc.TICK_TABLE.items()
               if form == "subst"}
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


# ---- the batched Cholesky / SPD-solve kernels (csrc/chol.cu) ------------

def _spd(B, n, k, seed, device):
    """Seeded SPD batch and right-hand sides (tests/test_qp_pallas.py:15-23
    recipe): M = A A' / n + 3 I."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    M = A @ A.transpose(0, 2, 1) / n + 3.0 * np.eye(n)
    rhs = rng.standard_normal((B, n, k))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return M, rhs, t(M), t(rhs)


# the edges of csrc/chol.cu's schedule: the 8-column panel (7, 8, 9), the
# 4 x 4 trailing tiles and 32-row blocks (31, 32, 33, 63, 64, 65, 119, 121),
# the rows per lane of a sweep (32 / 64 / 128 / 256), the block sizes (64
# and 128 threads, from n = 65) and n = 239 / 256, past what
# posdef_solve_fast's square panel took before its right-hand sides rode as
# rows after the packed triangle (n <= 239 with k <= 2); k = 33 takes the
# appended rows across a 32-row block
CHOL_EDGES = [1, 7, 8, 9, 30, 31, 32, 33, 60, 63, 64, 65, 119, 120, 121, 128,
              239, 256]


@pytest.mark.parametrize("B", [257, 1])
@pytest.mark.parametrize("k", [1, 2, 5, 33])
@pytest.mark.parametrize("n", CHOL_EDGES)
def test_chol_kernels_match_plain_and_numpy(cuda_device, n, k, B):
    """cholesky / chol_solve / posdef_solve / posdef_solve_fast at B = 257
    (not a multiple of the blocks an SM holds times 132) and B = 1 against
    their plain versions and against f64 numpy.linalg with the bands of
    tests/test_qp_pallas.py (2e-5 on L, 5e-5 on x), strict upper triangle
    of L exactly 0, each launch counted once; a kernel whose shared memory
    would pass the block's limit raises instead (chol_cuda.size_reason) and
    launches nothing."""
    M64, r64, M, rhs = _spd(B, n, k, 100 + n + k, cuda_device)
    fits = {name: chol_cuda.size_reason(name, n, k) is None
            for name in chol_cuda.KERNELS}
    counts = {name: kern.launches for name, kern in chol_cuda.KERNELS.items()}
    L_p = cholp.cholesky_plain(M)

    def run(name, *args):
        if fits[name]:
            return getattr(chol_cuda, name)(*args)
        with pytest.raises(ValueError, match="232448"):
            getattr(chol_cuda, name)(*args)
        return None

    L = run("cholesky", M)
    xs = {"chol_solve": run("chol_solve", L_p if L is None else L, rhs),
          "posdef_solve": run("posdef_solve", M, rhs),
          "posdef_solve_fast": run("posdef_solve_fast", M, rhs)}
    torch.cuda.synchronize()
    for name, kern in chol_cuda.KERNELS.items():
        assert kern.launches == counts[name] + int(fits[name]), name
    assert fits["chol_solve"] and fits["cholesky"] and fits["posdef_solve"]
    if L is not None:
        assert float(torch.triu(L, 1).abs().sum()) == 0.0
        torch.testing.assert_close(L, L_p, atol=2e-5, rtol=0)
        torch.testing.assert_close(L.double().cpu().numpy(),
                                   np.linalg.cholesky(M64), atol=2e-5,
                                   rtol=0)
    x_ref = np.linalg.solve(M64, r64)
    x_p = cholp.posdef_solve_plain(M, rhs)
    for x in xs.values():
        if x is None:
            continue
        torch.testing.assert_close(x, x_p, atol=5e-5, rtol=0)
        np.testing.assert_allclose(x.double().cpu().numpy(), x_ref,
                                   atol=5e-5, rtol=0)
    torch.testing.assert_close(
        xs["chol_solve"], cholp.chol_solve_plain(L_p if L is None else L, rhs),
        atol=5e-5, rtol=0)


def test_chol_smem_mirror_matches_library(cuda_device):
    """chol_cuda.smem_bytes (the wrapper's size rule) equals the library's
    *_smem_bytes for every kernel at every edge order and k = 1, 2, 5, 33."""
    lib = chol_cuda._build.build_library()["lib"]
    for name in chol_cuda.KERNELS:
        for n in CHOL_EDGES:
            for k in (1, 2, 5, 33):
                assert getattr(lib, name + "_smem_bytes")(n, k) == \
                    chol_cuda.smem_bytes(name, n, k), (name, n, k)


def test_mpc_smem_mirror_matches_library(cuda_device):
    """mpc_fused_cuda.smem_bytes (the wrappers' size rule) equals the
    library's *_smem_bytes for every entry point on the MPC core (the
    ``_inv`` ones too) at every horizon it takes (N = 1, 8, 20, 21, 22, 64
    and 85 among them); at N = 20 the standing solving forms hold at least
    five blocks an SM, fused_qp_nu6 at least four, and the walking solving
    forms and the prep kernel more than the six of the nu = 3 core before
    its redesign."""
    lib = chol_cuda._build.build_library()["lib"]
    for name in mfc.MPC_ENTRIES:
        for N in range(1, mfc.max_horizon(mfc.entry_nu(name)) + 1):
            assert getattr(lib, name + "_smem_bytes")(N) == \
                mfc.smem_bytes(name, N), (name, N)
    per_sm = {name: getattr(lib, name + "_blocks_per_sm")(20)
              for name in mfc.MPC_ENTRIES}
    assert min(per_sm["standing_tick"], per_sm["standing_tick_kf"]) >= 5
    assert per_sm["fused_qp_nu6"] >= 4
    assert min(per_sm[e] for e in ("walking_tick", "walking_tick_kf",
                                   "walking_mpc_prep")) > 6, per_sm


def test_chol_kernels_on_late_pdip_matrices(cuda_device):
    """The kernels against their twins on M = H + G'DG + reg I captured in
    Newton steps 15-20 of a cold PDIP on the walking QP (d = lam / s up to
    1e7: M spans ~1e7, and two f32 solves of one such system share no digit
    of x): the factor within 1e-4 of its scale and 1e-5 of |M| in
    |L L' - M|, the solves by their backward error (1e-5, within 4x of the
    twin's)."""
    cfg = ControllerConfig.walking()
    H, f, G, h = _walking_qp(cfg, 128, 9, cuda_device)
    Ms, rs = _late_pdip_matrices(H, f, G, h, 20, range(15, 20))
    assert len(Ms) == 5
    kept = 0
    for M, r in zip(Ms, rs):
        # a late f32 iterate can leave the cone of positive definite
        # matrices or be non-finite (the solver keeps its best iterate and
        # never returns what follows): the comparison takes the scenarios
        # whose twin factor has every pivot above the clamp
        L_p = cholp.cholesky_plain(M)
        d = torch.diagonal(L_p, dim1=-2, dim2=-1)
        ok = (torch.isfinite(L_p).all(-1).all(-1) & (d > 1e-6).all(-1)
              & torch.isfinite(r).all(-1).all(-1))
        if int(ok.sum()) == 0:
            continue
        kept += int(ok.sum())
        M, r, L_p = M[ok].contiguous(), r[ok].contiguous(), L_p[ok]
        L = chol_cuda.cholesky(M)
        lscale = float(L_p.abs().max())
        torch.testing.assert_close(L, L_p, atol=1e-4 * lscale, rtol=0)
        llt = (L @ L.transpose(-1, -2) - M).abs().amax((-2, -1))
        assert float((llt / M.abs().amax((-2, -1))).max()) <= 1e-5
        twin = _backward(M, cholp.chol_solve_plain(L_p, r), r)
        for x in (chol_cuda.chol_solve(L, r), chol_cuda.posdef_solve(M, r),
                  chol_cuda.posdef_solve_fast(M, r)):
            assert bool(torch.isfinite(x).all())
            assert _backward(M, x, r) <= max(1e-5, 4.0 * twin)
    assert kept >= 64, kept


def _backward(M, x, r):
    """Backward error |M x - r| / (|M| |x| + |r|) in inf norms, the worst
    of the batch."""
    num = (M @ x - r).abs().amax((-2, -1))
    den = (M.abs().sum(-1).amax(-1) * x.abs().amax((-2, -1))
           + r.abs().amax((-2, -1)))
    return float((num / den).max())


def _walking_qp(cfg, B, seed, device):
    """The condensed walking QP (n = 60, m = 120) of perturbed poses."""
    from mpc_limx_control_tpu_torch.ops import condense as cnd

    arms, x0, v_des, w_des, _, _, anc = _prep_inputs(cfg, B, seed, device)
    c = cfg.srbd
    N = c.horizon
    Ac, Bc = srbd.linearize_shared(cfg.robot, arms, x0[:, 3:6], x0[:, 2])
    Ad, Bd_t = srbd.discretize_srbd(Ac, Bc, c.ts)
    x_ref = srbd.walking_reference(x0, c, N, v_des, w_des, height_des=0.65)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    G, h = srbd.friction_cone_rows(c, N, torch.float32, device)
    qp = cnd.condense(Ad, Bd_t, torch.diag(t(c.q_diag)),
                      torch.diag(t(c.r_diag)),
                      torch.diag(c.p_scale * t(c.q_diag)), N, x0, x_ref,
                      extra_G=G, extra_h=h)
    return qp.H, qp.f, qp.G, qp.h


def _late_pdip_matrices(H, f, G, h, iters, keep):
    """(M + reg I, affine right-hand side [B,n,1]) of the Newton steps in
    `keep`, from a cold PDIP run with the plain twins."""
    seen = {"M": [], "r": []}
    chol0, solve0 = qps._posdef_chol, qps._chol_solve

    def spy_chol(M, reg, plain_twins=False):
        seen["M"].append(M + reg * torch.eye(M.shape[-1], device=M.device))
        return chol0(M, reg, plain_twins)

    def spy_solve(L, rhs, plain_twins=False):
        seen["r"].append(rhs[..., None].contiguous())
        return solve0(L, rhs, plain_twins)

    qps._posdef_chol, qps._chol_solve = spy_chol, spy_solve
    try:
        qps._batched_pdip(H, f, G, h, iters, plain_twins=True)
    finally:
        qps._posdef_chol, qps._chol_solve = chol0, solve0
    # one cold-start factorization and solve come first, then per Newton
    # step one factorization and two solves
    Ms = [seen["M"][1 + i].contiguous() for i in keep]
    rs = [seen["r"][1 + 2 * i] for i in keep]
    return Ms, rs


def test_chol_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    M = torch.eye(4, device=cuda_device).expand(3, 4, 4).contiguous()
    rhs = torch.ones(3, 4, 1, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        chol_cuda.cholesky(M.double())
    with pytest.raises(TypeError, match="float32"):
        chol_cuda.posdef_solve(M, rhs.double())
    with pytest.raises(ValueError, match="contiguous"):
        chol_cuda.chol_solve(M.transpose(1, 2), rhs)
    big = torch.zeros(1, 300, 300, device=cuda_device)
    with pytest.raises(ValueError, match="232448"):
        chol_cuda.cholesky(big)
    torch.testing.assert_close(chol_cuda.posdef_solve_fast(M, rhs), rhs)


@pytest.mark.parametrize("n,k", [(256, 96), (240, 40)])
def test_posdef_solve_fast_takes_what_the_square_panel_refused(cuda_device,
                                                               n, k):
    """Orders and right-hand-side counts the square column-major panel
    (n ((n + k) | 1) + 2 n floats) refused and the packed triangle with k
    appended rows (n (n + 1) / 2 + k n + 2 n) takes: n = 256 up to k = 96,
    the new limit (k = 97 is refused), and 240 / 40. Held against
    posdef_solve (the same function) and f64 numpy.linalg at 5e-5."""
    assert 4 * (n * ((n + k) | 1) + 2 * n) > chol_cuda.SMEM_LIMIT_BYTES
    M64, r64, M, rhs = _spd(33, n, k, 7 + k, cuda_device)
    before = chol_cuda.POSDEF_SOLVE_FAST.launches
    x = chol_cuda.posdef_solve_fast(M, rhs)
    assert chol_cuda.POSDEF_SOLVE_FAST.launches == before + 1
    torch.testing.assert_close(x, chol_cuda.posdef_solve(M, rhs), atol=5e-5,
                               rtol=0)
    np.testing.assert_allclose(x.double().cpu().numpy(),
                               np.linalg.solve(M64, r64), atol=5e-5, rtol=0)
    if n == 256:
        with pytest.raises(ValueError, match="232448"):
            chol_cuda.posdef_solve_fast(
                M, torch.zeros(33, n, k + 1, device=cuda_device))


@pytest.mark.parametrize("method", ["pdip_cold", "pdip_warm", "admm"])
def test_general_solvers_launch_the_chol_kernels(cuda_device, method):
    """_batched_pdip / _batched_admm on CUDA tensors: the launch arithmetic
    (one cholesky and two chol_solve per Newton step, one posdef_solve for
    a cold start; one cholesky per ADMM solve) and agreement with the same
    solver on the plain twins."""
    cfg = ControllerConfig.walking()
    H, f, G, h = _walking_qp(cfg, 33, 4, cuda_device)
    rng = np.random.default_rng(2)
    zw = torch.tensor(5.0 * rng.standard_normal((33, 60)),
                      dtype=torch.float32, device=cuda_device)
    counts = {n_: k.launches for n_, k in chol_cuda.KERNELS.items()}
    if method == "admm":
        yw = torch.zeros(33, 120, device=cuda_device)
        run = lambda tw: qps._batched_admm(H, f, G, h, zw, yw, 20, 0.3, 1.6,
                                           plain_twins=tw)
        want = dict(cholesky=1, chol_solve=0, posdef_solve=0)
    else:
        warm = method == "pdip_warm"
        run = lambda tw: qps._batched_pdip(
            H, f, G, h, 8, z_warm=zw if warm else None,
            lam_warm=torch.ones_like(h) if warm else None, plain_twins=tw)
        want = dict(cholesky=8, chol_solve=16, posdef_solve=0 if warm else 1)
    sol, _ = run(False)
    got = {n_: k.launches - counts[n_]
           for n_, k in chol_cuda.KERNELS.items()}
    assert got == dict(want, posdef_solve_fast=0)
    sol_p, _ = run(True)
    scale = float(sol_p.u.abs().max()) + 1.0
    # forces of ~250 N after 8 Newton steps (a cold solve is not converged
    # there, and the best-iterate pick can differ between two arithmetic
    # orders): the JAX suite's band for that is 5e-2 on z of O(10)
    # (tests/test_qp_pallas.py:66), 5e-3 of the scale
    torch.testing.assert_close(sol.u, sol_p.u, atol=5e-3 * scale, rtol=0)


# ---- solve_form="inv" (K1) ------------------------------------------------

def _inv(cfg):
    return dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, solver=dataclasses.replace(cfg.srbd.solver,
                                             solve_form="inv")))


@pytest.mark.parametrize("N", [20, 8])
def test_prep_inv_kernel_matches_twin_and_subst(cuda_device, N):
    """walking_mpc_prep_inv against its "linv" twin (bands of the subst
    kernel) and against the "subst" kernel on the same inputs (1e-4 of
    the solution scale, the band tests/test_mpc_fused.py:288 holds the two
    forms to)."""
    cfg = _inv(_cfg(N))
    args = _prep_inputs(cfg, 257, 21 + N, cuda_device)
    before = mfc.WALKING_MPC_PREP_INV.launches
    z, y, res, xp = mfc.fused_walking_qp_prep(*args, cfg=cfg)
    assert mfc.WALKING_MPC_PREP_INV.launches == before + 1
    sol, xp_p, (z_p, y_p) = mfc.walking_qp_prep_plain(cfg, *args,
                                                      solve_form="linv")
    scale = float(z_p.abs().max()) + 1.0
    torch.testing.assert_close(z, z_p, atol=2e-3 * scale, rtol=0)
    torch.testing.assert_close(y, y_p, atol=2e-3 * scale, rtol=0)
    torch.testing.assert_close(xp, xp_p, atol=1e-3 * scale, rtol=0)
    z_s = mfc.fused_walking_qp_prep(*args, cfg=_cfg(N))[0]
    torch.testing.assert_close(z, z_s, atol=1e-4 * scale, rtol=0)


def test_fused_qp_inv_kernel_matches_twin_and_subst(cuda_device):
    cfg = _inv(_cfg(20))
    args = _qp_inputs(cfg, 3, 257, 63, cuda_device)
    before = mfc.FUSED_QP_NU3_INV.launches
    sol, (z, y) = mfc.make_admm_fused(cfg.srbd)(*args)
    assert mfc.FUSED_QP_NU3_INV.launches == before + 1
    sol_p, (z_p, y_p) = mfc.make_admm_fused(cfg.srbd,
                                            solve_form="linv")(*args)
    scale = float(z_p.abs().max()) + 1.0
    torch.testing.assert_close(z, z_p, atol=1e-4 * scale, rtol=0)
    sol_s, _ = mfc.make_admm_fused(_cfg(20).srbd)(*args)
    torch.testing.assert_close(z, sol_s.u, atol=1e-4 * scale, rtol=0)
    # two feet (n = 120 > 64): the inv entry runs the substitution sweeps,
    # the subst entry's outputs bit for bit
    args6 = _qp_inputs(cfg, 6, 33, 66, cuda_device)
    before6 = mfc.FUSED_QP[6].launches
    before6i = mfc.FUSED_QP_NU6_INV.launches
    sol6, _ = mfc.make_admm_fused(cfg.srbd, two_feet=True)(*args6)
    sol6s, _ = mfc.make_admm_fused(_cfg(20).srbd, two_feet=True)(*args6)
    assert mfc.FUSED_QP[6].launches == before6 + 1
    assert mfc.FUSED_QP_NU6_INV.launches == before6i + 1
    assert mfc.FUSED_QP_NU3_INV.launches == before + 1
    assert torch.equal(sol6.u, sol6s.u)


@pytest.mark.parametrize("est_kf", [False, True])
def test_tick_inv_kernels_match_twin_and_subst(cuda_device, est_kf):
    """walking_tick_inv / walking_tick_kf_inv against the plain tick with
    the "linv" twin (bands of the subst forms) and against the subst
    kernel's tick."""
    base = ControllerConfig.walking()
    if est_kf:
        base = dataclasses.replace(base, estimator_mode="kf")
    cfg = _inv(base)
    B = 257
    s0 = _states(cfg, B, 0, cuda_device, yaw=0.0 if est_kf else 0.1)
    its = _staggered(B, cuda_device)
    for j in range(3):
        s0, _ = ro._plant_step_ref(cfg, s0, its + j, solve_form="subst")
    its = its + 3.0
    kern = ro.tick_route(cfg).solve
    assert kern.name == ("walking_tick_kf_inv" if est_kf
                         else "walking_tick_inv")
    before = kern.launches
    s_k, m_k = ro.plant_step(cfg, s0, its)
    assert kern.launches == before + 1
    s_p, m_p = ro._plant_step_ref(cfg, s0, its, solve_form="linv")
    s_s, m_s = ro.plant_step(base, s0, its)
    for k, a in (("xi", 3e-4), ("q", 5e-4), ("foot_l", 5e-4),
                 ("foot_r", 5e-4), ("ref_anchor", 1e-5)):
        torch.testing.assert_close(getattr(s_k, k), getattr(s_p, k),
                                   atol=a, rtol=0)
        torch.testing.assert_close(getattr(s_k, k), getattr(s_s, k),
                                   atol=a, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_p["grf"], atol=5e-2, rtol=0)
    torch.testing.assert_close(m_k["grf"], m_s["grf"], atol=5e-2, rtol=0)
    # a held tick of an inv config runs the shared hold kernel
    hold = ro.tick_route(base).hold
    assert hold is ro.tick_route(cfg).hold
    before = hold.launches
    ro.plant_step(cfg, s0, its, grf_override=m_k["grf"])
    assert hold.launches == before + 1


def test_inv_entries_equal_subst_past_n64(cuda_device):
    """Past n = 64 the TPU kernel runs the substitution sweeps whatever the
    form (mpc_fused_pallas.py:249): at N = 22 (n = 66) every inv entry
    launches and gives its subst entry's outputs bit for bit."""
    cfg, icfg = _cfg(22), _inv(_cfg(22))
    args = _prep_inputs(cfg, 33, 5, cuda_device)
    before = mfc.WALKING_MPC_PREP_INV.launches
    outs = mfc.fused_walking_qp_prep(*args, cfg=icfg)
    assert mfc.WALKING_MPC_PREP_INV.launches == before + 1
    for a, b in zip(outs, mfc.fused_walking_qp_prep(*args, cfg=cfg)):
        assert torch.equal(a, b)
    qargs = _qp_inputs(cfg, 3, 33, 6, cuda_device)
    before = mfc.FUSED_QP_NU3_INV.launches
    sol_i, zy_i = mfc.make_admm_fused(icfg.srbd)(*qargs)
    assert mfc.FUSED_QP_NU3_INV.launches == before + 1
    sol_s, zy_s = mfc.make_admm_fused(cfg.srbd)(*qargs)
    for a, b in zip(zy_i + (sol_i.residual,), zy_s + (sol_s.residual,)):
        assert torch.equal(a, b)
    for est_kf in (False, True):
        base = dataclasses.replace(cfg, estimator_mode="kf") if est_kf \
            else cfg
        s0 = _states(base, 33, 7, cuda_device, yaw=0.0 if est_kf else 0.1)
        its = _staggered(33, cuda_device)
        kern = ro.tick_route(_inv(base)).solve
        before = kern.launches
        s_i, m_i = ro.plant_step(_inv(base), s0, its)
        assert kern.launches == before + 1
        s_s, m_s = ro.plant_step(base, s0, its)
        for k in ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam",
                  "ref_anchor"):
            assert torch.equal(getattr(s_i, k), getattr(s_s, k)), k
        assert torch.equal(m_i["grf"], m_s["grf"])
        if est_kf:
            assert torch.equal(s_i.kf.p_cov, s_s.kf.p_cov)


@pytest.mark.parametrize("variant", ["solve", "kf"])
def test_stand_tick_inv_kernels_match_linv_twin(cuda_device, variant):
    """standing_tick_inv / standing_tick_kf_inv at N = 8 (n = 48 <= 64:
    the factor inverse) against the plain standing tick with the "linv"
    twin, with the bands of the subst forms (one tick, then five threaded
    ticks)."""
    _stand_variant_vs_plain(cuda_device, variant, 8, inv=True)


def test_fused_qp_nu6_inv_kernel_matches_twin_and_subst(cuda_device):
    """fused_qp_nu6_inv at N = 8 (n = 48) against its "linv" twin and
    against the subst kernel on the same inputs, 1e-4 of the solution
    scale (the band of fused_qp_nu3_inv), not the subst kernel bit for
    bit."""
    cfg = _inv(_cfg(8))
    args = _qp_inputs(cfg, 6, 257, 68, cuda_device)
    before = mfc.FUSED_QP_NU6_INV.launches
    sol, (z, y) = mfc.make_admm_fused(cfg.srbd, two_feet=True)(*args)
    assert mfc.FUSED_QP_NU6_INV.launches == before + 1
    sol_p, (z_p, y_p) = mfc.make_admm_fused(cfg.srbd, two_feet=True,
                                            solve_form="linv")(*args)
    scale = float(z_p.abs().max()) + 1.0
    torch.testing.assert_close(z, z_p, atol=1e-4 * scale, rtol=0)
    sol_s, _ = mfc.make_admm_fused(_cfg(8).srbd, two_feet=True)(*args)
    torch.testing.assert_close(z, sol_s.u, atol=1e-4 * scale, rtol=0)
    assert not torch.equal(z, sol_s.u)


def test_stand_inv_entries_equal_subst_past_n64(cuda_device):
    """At N = 11 (n = 66 > 64) the standing inv entries run the
    substitution sweeps, as mpc_fused_pallas.py:249 does: each launches
    and gives its subst entry's outputs bit for bit."""
    cfg, icfg = _cfg(11), _inv(_cfg(11))
    qargs = _qp_inputs(cfg, 6, 33, 16, cuda_device)
    before = mfc.FUSED_QP_NU6_INV.launches
    sol_i, zy_i = mfc.make_admm_fused(icfg.srbd, two_feet=True)(*qargs)
    assert mfc.FUSED_QP_NU6_INV.launches == before + 1
    sol_s, zy_s = mfc.make_admm_fused(cfg.srbd, two_feet=True)(*qargs)
    for a, b in zip(zy_i + (sol_i.residual,), zy_s + (sol_s.residual,)):
        assert torch.equal(a, b)
    stand = _horizon(ControllerConfig.standing(), 11)
    for est_kf in (False, True):
        base = dataclasses.replace(stand, estimator_mode="kf") if est_kf \
            else stand
        s0 = _stand_states(base, 33, 7, cuda_device)
        its = _staggered(33, cuda_device)
        kern = ro.tick_route(_inv(base)).solve
        before = kern.launches
        s_i, m_i = ro.plant_step(_inv(base), s0, its)
        assert kern.launches == before + 1
        s_s, m_s = ro.plant_step(base, s0, its)
        for k in ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam"):
            assert torch.equal(getattr(s_i, k), getattr(s_s, k)), k
        assert torch.equal(m_i["grf"], m_s["grf"])
        if est_kf:
            assert torch.equal(s_i.kf.p_cov, s_s.kf.p_cov)


# ---- the fused interior point (K9) and the controller variants -----------

def _standing_qp(B, seed, device):
    """The condensed two-foot QP of ControllerConfig() standing (n = 120,
    m = 240; controller.stance_mpc's cold branch) at kicked states."""
    from mpc_limx_control_tpu_torch.ops import condense as cnd

    cfg = dataclasses.replace(ControllerConfig(), mode="stand")
    s = _states(cfg, B, seed, device, yaw=0.0)
    od = ro._odom_from_xi(s.xi)
    xi0 = srbd.initial_state(od.ori, od.pos, od.v_ori, od.v_pos)
    Ac, Bc2 = srbd.linearize_shared(
        cfg.robot, torch.stack([s.foot_l, s.foot_r], -2), od.pos,
        od.ori[:, 2])
    Ad, Bd = srbd.discretize_srbd(Ac, torch.cat([Bc2[:, 0], Bc2[:, 1]], -1),
                                  cfg.srbd.ts)
    N = cfg.srbd.horizon
    mid = 0.5 * (s.foot_l + s.foot_r)
    x_ref = srbd.walking_reference(
        xi0, cfg.srbd, N, torch.zeros(B, 3, device=device),
        torch.zeros(B, device=device), height_des=0.65,
        pos_anchor=torch.cat([mid[:, :2], torch.full_like(mid[:, 2:], 0.65)],
                             -1))
    Q, R, P = ctrl._weights(cfg.srbd, 2, torch.float32, device)
    ones = torch.ones(B, N, device=device)
    qp = cnd.condense(Ad, Bd[:, None].expand(B, N, 13, 6), Q, R, P, N, xi0,
                      x_ref, extra_G=ctrl._cone_rows(cfg, torch.float32,
                                                     device),
                      extra_h=ctrl._cone_bounds(cfg, ones, ones))
    return qp.H, qp.f, qp.G.expand(B, -1, -1), qp.h


def _pdip_inputs(n, B, seed, device):
    """K9's QPs with their start: the recipe of tests/test_qp_pallas.py:46-58
    (n = 30, m = 64, and n = 61, m = 122, whose n is no multiple of the
    formation's 4 x 4 tiles; z0 = 0, s0 = lam0 = 1), the walking (60 / 120)
    and standing (120 / 240) QPs from the cold start of ops/qp.py's PDIP."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    if n in (30, 61):
        m = 64 if n == 30 else 122
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(B, n, n))
        H = t(np.einsum("bij,bkj->bik", A, A) / n + 3 * np.eye(n))
        f, G = t(rng.normal(size=(B, n))), t(rng.normal(size=(B, m, n)))
        h = t(np.abs(rng.normal(size=(B, m))) + 1.0)
        return [a.contiguous() for a in (H, f, G, h, torch.zeros_like(f),
                                         torch.ones_like(h),
                                         torch.ones_like(h))]
    H, f, G, h = (_walking_qp(ControllerConfig.walking(), B, seed, device)
                  if n == 60 else _standing_qp(B, seed, device))
    z0 = -cholp.posdef_solve_plain(H + 1e-6 * torch.eye(n, device=device),
                                   f[..., None])[..., 0]
    s_raw = h - (G @ z0[..., None])[..., 0]
    s0 = s_raw + torch.clamp(-s_raw.amin(-1, keepdim=True), min=0.0) + 1.0
    return [a.contiguous() for a in (H, f, G, h, z0, s0, torch.ones_like(h))]


@pytest.mark.parametrize("B", [257, 1])
@pytest.mark.parametrize("n", [30, 60, 61, 120])
def test_pdip_fused_matches_plain(cuda_device, n, B):
    """The K9 kernel against pdip_fused_plain at B = 257 and on the first of
    those QPs alone (B = 1; the merit's floor measured on the 257, as
    chip_smoke.py does) after 6 and 20 Newton steps, n = 61 with its
    formation tiles cut at the edge, every scenario held by chip_smoke.py's
    ``pdip_check``:
    the merit after 0 and 1 steps within 1e-3 of itself, the best-iterate
    pick bit for bit from the kernel's own launches, the best merit within
    1e-3 of itself plus 8x its f32 floor, all four outputs at 6 steps (a
    z_best apart from the plain one is the plain iterate of the step the
    kernel picked, a tie at the floor), the objective and the violation of
    z_best."""
    from mpc_limx_control_tpu_torch.ops import qp_cuda

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    args = _pdip_inputs(n, 257, 30 + n, cuda_device)
    held = [a[:B].contiguous() for a in args]
    before = qp_cuda.PDIP_FUSED.launches
    qp_cuda.pdip_fused(*held, iters=6)
    assert qp_cuda.PDIP_FUSED.launches == before + 1
    for iters in (6, 20):
        e = smoke.pdip_check(held, iters, smoke.pdip_floor(args, iters))
        assert e["ok"], (iters, e)


def test_pdip_fused_refuses_what_the_kernel_does_not_take(cuda_device):
    from mpc_limx_control_tpu_torch.ops import qp_cuda

    args = _pdip_inputs(30, 4, 1, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        qp_cuda.pdip_fused(*[a.double() for a in args])
    with pytest.raises(ValueError, match="contiguous"):
        qp_cuda.pdip_fused(args[0].transpose(1, 2), *args[1:])
    big = [torch.zeros(s, device=cuda_device) for s in
           ((1, 120, 120), (1, 120), (1, 3600, 120), (1, 3600), (1, 120),
            (1, 3600), (1, 3600))]
    with pytest.raises(ValueError, match="232448"):
        qp_cuda.pdip_fused(*big)


VARIANT_LAUNCHES = {
    # (mode, variant) -> the kernels one tick of the composition launches
    ("walk", "riccati"): {},
    ("walk", "riccati_cold"): {"cholesky": 12, "chol_solve": 24,
                               "posdef_solve": 1},
    ("walk", "damped_ls"): {"walking_mpc_prep": 1},
    ("walk", "log6"): {"walking_mpc_prep": 1},
    ("walk", "receding"): {"cholesky": 1},
    ("stand", "log6"): {"fused_qp_nu6": 1},
    ("stand", "receding"): {"fused_qp_nu6": 1},
}


@pytest.mark.parametrize("mode,variant", list(VARIANT_LAUNCHES))
def test_variant_ticks_run_on_the_card(cuda_device, mode, variant):
    """Each controller variant the tick kernels refuse runs through
    plant_step on CUDA tensors as the composition: it launches exactly the
    kernels its QP reaches (no tick kernel) and matches the same tick on
    CPU tensors: xi 3e-4, q and feet 5e-4 (log6: 1e-2 and 5e-3), grf
    5e-3 of its scale."""
    from mpc_limx_control_tpu_torch.ops import qp_cuda

    base = (ControllerConfig.walking() if mode == "walk"
            else ControllerConfig.standing())
    if variant.startswith("riccati"):
        cfg = dataclasses.replace(base, qp_warm_start=variant == "riccati",
                                  srbd=dataclasses.replace(
                                      base.srbd, solver=dataclasses.replace(
                                          base.srbd.solver,
                                          method="riccati")))
    elif variant == "receding":
        cfg = dataclasses.replace(base, srbd=dataclasses.replace(
            base.srbd, attitude_ref="receding"))
    else:
        cfg = dataclasses.replace(base, ik_method=variant)
    assert ro.tick_route(cfg) == ro.TickRoute("composition")
    kernels = {k.name: k for k in (
        mfc.WALKING_MPC_PREP, mfc.WALKING_MPC_PREP_INV, mfc.FUSED_QP_NU3_INV,
        *mfc.FUSED_QP.values(), *tfc.TICK_TABLE.values(),
        *chol_cuda.KERNELS.values(), qp_cuda.PDIP_FUSED)}
    B = 16
    s0 = _states(cfg, B, 3, cuda_device, yaw=0.0)
    its = _staggered(B, cuda_device)
    before = {n_: k.launches for n_, k in kernels.items()}
    s_k, m_k = ro.plant_step(cfg, s0, its)
    torch.cuda.synchronize()
    got = {n_: k.launches - before[n_] for n_, k in kernels.items()}
    assert got == {n_: VARIANT_LAUNCHES[(mode, variant)].get(n_, 0)
                   for n_ in kernels}
    s_c, m_c = ro.plant_step(cfg, ro._map_state(s0, lambda x: x.cpu()),
                             its.cpu())
    # the log6 IK solves a damped rank-3 6 x 6 system: float32 keeps ~3
    # digits of the swing joints (as in JAX, tests/test_torch_variants.py)
    log6 = variant == "log6"
    for k, a in (("xi", 3e-4), ("q", 1e-2 if log6 else 5e-4),
                 ("foot_l", 5e-3 if log6 else 5e-4),
                 ("foot_r", 5e-3 if log6 else 5e-4)):
        torch.testing.assert_close(getattr(s_k, k).cpu(), getattr(s_c, k),
                                   atol=a, rtol=0)
    # the cold PDIP's best-iterate pick can differ between the kernels and
    # torch.linalg (tests above): 5e-3 of the force scale
    torch.testing.assert_close(
        m_k["grf"].cpu(), m_c["grf"],
        atol=5e-3 * (float(m_c["grf"].abs().max()) + 1.0), rtol=0)


def _horizon(cfg, N):
    return dataclasses.replace(cfg, srbd=dataclasses.replace(cfg.srbd,
                                                             horizon=N))


def test_composition_runs_past_the_mpc_horizon(cuda_device):
    """A horizon of 22 steps (past the 21 the MPC kernels once took): the
    warm PDIP walking composition runs through plant_step on the card, one
    cholesky and two chol_solve launches per Newton step and tick
    (n = 66), its first tick within the bands of the variant ticks above
    against the same tick on CPU tensors; the fused walking and standing
    ticks and the warm standing ADMM run their MPC kernels at N = 22, and
    a horizon past what those take (86 walking, 43 standing) raises,
    naming the limit."""
    base = ControllerConfig.walking()
    cfg = _horizon(dataclasses.replace(base, srbd=dataclasses.replace(
        base.srbd, solver=dataclasses.replace(base.srbd.solver,
                                              method="pdip"))), 22)
    assert ro.tick_route(cfg) == ro.TickRoute("composition")
    B, ticks = 16, 3
    s0 = _states(cfg, B, 3, cuda_device, yaw=0.0)
    its = _staggered(B, cuda_device)
    counts = {n_: k.launches for n_, k in chol_cuda.KERNELS.items()}
    s_k, m_k = ro.plant_step(cfg, s0, its)
    s_c, m_c = ro.plant_step(cfg, ro._map_state(s0, lambda x: x.cpu()),
                             its.cpu())
    for k, a in (("xi", 3e-4), ("q", 5e-4), ("foot_l", 5e-4),
                 ("foot_r", 5e-4)):
        torch.testing.assert_close(getattr(s_k, k).cpu(), getattr(s_c, k),
                                   atol=a, rtol=0)
    torch.testing.assert_close(
        m_k["grf"].cpu(), m_c["grf"],
        atol=5e-3 * (float(m_c["grf"].abs().max()) + 1.0), rtol=0)
    st = s_k
    for t in range(1, ticks):
        st, m = ro.plant_step(cfg, st, its + t)
    torch.cuda.synchronize()
    iters = cfg.srbd.solver.warm_iters
    got = {n_: k.launches - counts[n_] for n_, k in chol_cuda.KERNELS.items()}
    assert got == dict(cholesky=iters * ticks, chol_solve=2 * iters * ticks,
                       posdef_solve=0, posdef_solve_fast=0)
    assert bool(torch.isfinite(st.xi).all()) and st.qp_z.shape == (B, 66)
    kf = dataclasses.replace(base, estimator_mode="kf")
    for bad in (_horizon(base, 86), _horizon(kf, 86)):
        sb = ro.initial_plant_state(bad, batch=(2,), device=cuda_device)
        with pytest.raises(NotImplementedError, match="1 to 85 steps"):
            ro.plant_step(bad, sb, torch.zeros(2, device=cuda_device))
    # the walking MPC kernels take 1 to 85 steps, the standing ones 1 to
    # 42: the fused walking and standing ticks and the warm standing ADMM
    # (fused_qp_nu6) run at N = 22
    stand = ControllerConfig.standing()
    admm = dataclasses.replace(stand, srbd=dataclasses.replace(
        stand.srbd, solver=dataclasses.replace(stand.srbd.solver,
                                               method="admm")))
    for c, kern, n in (
            (_horizon(base, 22), ro.tick_route(base).solve, 66),
            (_horizon(kf, 22), ro.tick_route(kf).solve, 66),
            (_horizon(stand, 22), ro.tick_route(stand).solve, 132),
            (_horizon(admm, 22), mfc.FUSED_QP[6], 132)):
        sb = ro.initial_plant_state(c, batch=(2,), device=cuda_device)
        before = kern.launches
        s2, m2 = ro.plant_step(c, sb, torch.zeros(2, device=cuda_device))
        assert kern.launches == before + 1
        assert s2.qp_z.shape == (2, n) and bool(
            torch.isfinite(m2["grf"]).all())
    s43 = ro.initial_plant_state(_horizon(stand, 43), batch=(2,),
                                 device=cuda_device)
    with pytest.raises(NotImplementedError, match="1 to 42 steps"):
        ro.plant_step(_horizon(stand, 43), s43,
                      torch.zeros(2, device=cuda_device))


# ---- the resident rollout and the live session on the card ------------------

@pytest.mark.parametrize("mode,est", [("walk", "truth"), ("walk", "kf"),
                                      ("stand", "truth"), ("stand", "kf")])
@pytest.mark.parametrize("T", [1, 6, 7])
def test_resident_rollout_equals_batched_rollout(cuda_device, mode, est, T):
    """batched_rollout_resident (double-buffered state, pairs of ticks
    replayed from a CUDA graph) launches the tick kernel on the inputs
    batched_rollout(mpc_every=1) gives it: every field and metric equal
    bit for bit, with staggered gait phases, at 1, an even and an odd
    tick count; one launch a tick."""
    base = (ControllerConfig.walking() if mode == "walk"
            else ControllerConfig.standing())
    cfg = dataclasses.replace(base, estimator_mode=est)
    B = 257
    s0 = _states(cfg, B, 5, cuda_device, yaw=0.0)
    it0 = torch.arange(B, dtype=torch.float32, device=cuda_device) * 2.0
    f_ref, m_ref = ro.batched_rollout(cfg, s0, T, start_iteration=it0)
    kern = ro.tick_route(cfg).solve
    kern.reset()
    f_res, m_res = ro.batched_rollout_resident(cfg, s0, T,
                                               start_iteration=it0)
    torch.cuda.synchronize()
    assert kern.launches == T
    for f in ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam", "ref_anchor",
              "prev_v", "prev_q"):
        if getattr(f_ref, f) is not None:
            assert torch.equal(getattr(f_res, f), getattr(f_ref, f)), f
    if est == "kf":
        assert torch.equal(f_res.kf.x_hat, f_ref.kf.x_hat)
        assert torch.equal(f_res.kf.p_cov, f_ref.kf.p_cov)
    assert set(m_res) == set(m_ref)
    for k in m_ref:
        assert torch.equal(m_res[k], m_ref[k]), k


def _scripted_session(cfg, graphs, port, ticks, use_kf):
    from mpc_limx_control_tpu_torch.control import session as ses
    from test_torch_session_walking import ScriptedLink, scripted_sensors

    s = ses.ControlSession(cfg, state_port=port, cmd_port=port + 1,
                           device="cuda", cuda_graphs=graphs)
    s.link.close()
    s.link = ScriptedLink(scripted_sensors(cfg, ticks, seed=4))
    stats = s.run(ticks, hz=1000.0, use_kf=use_kf, est_odom_every=3)
    return s, stats


@pytest.mark.parametrize("case", ["walk_kf", "walk_truth", "stand",
                                  "stand_kf", "cold"])
def test_session_graphs_equal_eager_functions(cuda_device, case):
    """The session's CUDA graphs (estimator, solve and held-force ticks;
    the cold tick of ControllerConfig()) against the same functions run
    eagerly on the card: 12 scripted ticks, every sent command and
    published odometry bit for bit, the same statistics' counters, and
    one MPC kernel launch a solve in both."""
    cfg = {"walk_kf": ControllerConfig.walking(),
           "walk_truth": ControllerConfig.walking(),
           "stand": ControllerConfig.standing(),
           "stand_kf": ControllerConfig.standing(),
           "cold": ControllerConfig()}[case]
    use_kf = case.endswith("_kf")
    runs = {}
    for g in (True, False):
        s, st = _scripted_session(cfg, g, 19930 + 2 * g, 12, use_kf)
        runs[g] = (s.link.cmds, s.link.est, st)
        s.close()
    (cg, eg, sg), (ce, ee, se) = runs[True], runs[False]
    assert len(cg) == len(ce) == 12
    assert len(eg) == len(ee) == (4 if use_kf else 0)
    for a, b in zip(cg + eg, ce + ee):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    for k in ("sent", "mpc_solves", "mpc_holds", "est_odom_published"):
        assert sg[k] == se[k], k
    assert sg["mpc_solves"] == (12 if case == "cold" else 3)


def test_session_capture_counts_replays_not_the_capture(cuda_device):
    """Making a session captures its graphs: a recorded launch runs
    nothing and is not counted; each replay counts its launches."""
    from mpc_limx_control_tpu_torch.ops import _build

    cfg = ControllerConfig.walking()
    solve, hold = tfc.WALKING_SESSION_TICK, tfc.WALKING_SESSION_TICK_HOLD
    before = (solve.launches, hold.launches, mfc.WALKING_MPC_PREP.launches)
    s, stats = _scripted_session(cfg, True, 19940, 10, False)
    s.close()
    # two eager warm-up launches of each tick kernel when the session was
    # made, then one a solve tick (0 and 5) and one a held tick; the plain
    # tick's MPC kernel is off the walking session's path
    assert solve.launches - before[0] == 2 + 2
    assert hold.launches - before[1] == 2 + 8
    assert mfc.WALKING_MPC_PREP.launches == before[2]
    assert stats["mpc_solves"] == 2 and stats["kernel_ticks"] == 10
    assert all(k.launches >= 0 for k in _build.KERNELS)


def test_graph_capture_survives_dead_graphs_in_cycles(cuda_device):
    """A dead session holds its graphs in a reference cycle, which only
    the cyclic collector frees; a collection during another capture would
    destroy a graph inside it and break that capture (seen once in the
    card tests). With the collector firing at every allocation, a capture
    still succeeds and replays."""
    import gc

    from mpc_limx_control_tpu_torch.ops import graphs

    x = torch.ones(8, device=cuda_device)

    class Holder:
        pass

    for _ in range(3):
        h = Holder()
        h.cycle = h
        h.graph = graphs.Graph(lambda: x * 2.0)
        del h
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        g = graphs.Graph(lambda: [Holder() for _ in range(200)] and x + 1.0)
    finally:
        gc.set_threshold(*thresholds)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(g.out, x + 1.0)
    gc.collect()


def test_loopback_session_walks_on_the_card(cuda_device):
    """A 200-tick walking session on the card over the UDP loopback,
    truth odometry, against the torch WirePlant on the CPU: every tick
    sent, one walking_session_tick launch a solve and one
    walking_session_tick_hold launch a held tick, upright at the
    height."""
    from mpc_limx_control_tpu_torch.control import session as ses
    from test_torch_session_walking import WirePlant

    cfg = ControllerConfig.walking()
    plant = WirePlant(cfg, 19944, 19945, publish_truth_odom=True)
    try:
        with ses.ControlSession(cfg, state_port=19944, cmd_port=19945,
                                device="cuda") as s:
            for k in tfc.SESSION_KERNELS:
                k.reset()
            stats = s.run(200, hz=1000.0)
        assert stats["sent"] == 200 and stats["mpc_solves"] == 40
        assert tfc.WALKING_SESSION_TICK.launches == 40
        assert tfc.WALKING_SESSION_TICK_HOLD.launches == 160
        assert stats["kernel_ticks"] == 200
        xi = plant.xi[0].numpy()
        assert 0.6 < xi[5] < 0.7 and abs(xi[0]) < 0.1 and abs(xi[1]) < 0.1
        assert stats["tick_latency_p50"] > 0.0
    finally:
        plant.close()


# ---- the scenario mesh (parallel/mesh.py) -----------------------------------

@pytest.mark.parametrize("style", ["gspmd", "shard_map"])
@pytest.mark.parametrize("est", ["truth", "kf"])
@pytest.mark.parametrize("shards", [1, 4])
def test_mesh_equals_batched_rollout(cuda_device, shards, est, style):
    """A mesh of the card and of 4 shards on it, walking at full width,
    B = 256, 10 steps: the final state bit for bit the unsharded
    batched_rollout's (each scenario is its own block of the tick kernel),
    the mean height within rtol 1e-6 (one shard: every statistic bit for
    bit), one tick launch a shard a step."""
    from mpc_limx_control_tpu_torch.parallel import mesh as pmesh

    cfg = dataclasses.replace(ControllerConfig.walking(), estimator_mode=est)
    s0 = _states(cfg, 256, seed=11, device=cuda_device, yaw=0.0)
    ref, m_ref = ro.batched_rollout(cfg, s0, 10)
    mesh = pmesh.make_mesh([cuda_device] * shards)
    make = (pmesh.sharded_rollout if style == "gspmd"
            else pmesh.shard_map_rollout)
    kern = ro.tick_route(cfg).solve
    kern.reset()
    final, stats = make(cfg, mesh, 10)(s0, 0.0)
    torch.cuda.synchronize()
    assert kern.launches == shards * 10
    got = final.gather()
    assert [p.xi.device for p in final.parts] == [cuda_device] * shards
    for f in ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam", "ref_anchor"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    if est == "kf":
        assert torch.equal(got.kf.p_cov, ref.kf.p_cov)
    want = pmesh.scenario_stats(m_ref)
    mean = want["mean_height"]
    assert float(((stats["mean_height"] - mean).abs() / mean).max()) <= 1e-6
    assert torch.equal(stats["max_qp_residual"], want["max_qp_residual"])
    if shards == 1:
        # one shard: scenario_stats' own arithmetic
        for k, v in stats.items():
            assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("layout", ["1x1", "1x4", "2x1", "4x1"])
def test_mesh_with_staggered_start_equals_resident(cuda_device, layout):
    """A [B] staggered start through a mesh in one process, cards x shards
    a card (one shard, four shards on card 0, or one shard on each of 2 or
    4 cards; skipped with fewer cards), walking at full width, B = 512,
    11 steps: the final state and every scenario's metrics bit for bit
    batched_rollout_resident's on card 0 with the same start; the largest
    residual exactly, the mean height within rtol 1e-6; the call's row of
    the mesh log times each shard's rollout and reduction on its card."""
    from mpc_limx_control_tpu_torch.parallel import mesh as pmesh
    from mpc_limx_control_tpu_torch.utils import profiling

    cards, per_card = (int(x) for x in layout.split("x"))
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} cards, "
                    f"{torch.cuda.device_count()} present")
    cfg = ControllerConfig.walking()
    B, steps = 512, 11
    s0 = _states(cfg, B, seed=23, device=cuda_device, yaw=0.0)
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    start = torch.randint(0, 600, (B,), generator=gen,
                          device=cuda_device).to(torch.float32)
    want, m_want = ro.batched_rollout_resident(cfg, s0, steps,
                                               start_iteration=start)
    mesh = pmesh.make_mesh([torch.device("cuda", c) for c in range(cards)
                            for _ in range(per_card)])
    log = profiling.mesh_log()
    log.clear()
    final, stats, m = pmesh.sharded_rollout(cfg, mesh, steps,
                                            return_metrics=True)(s0, start)
    got = final.gather(cuda_device)
    for f in ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    gm = m.gather(cuda_device)
    for k, v in m_want.items():
        assert torch.equal(gm[k], v), k
    ref = pmesh.scenario_stats(m_want)
    assert torch.equal(stats["max_qp_residual"], ref["max_qp_residual"])
    mean = ref["mean_height"]
    assert float(((stats["mean_height"] - mean).abs() / mean).max()) <= 1e-6
    calls = log.view()
    assert len(calls) == 1 and calls.rollout_ms.shape == (1, cards * per_card)
    assert (calls.rollout_ms > 0).all() and (calls.reduce_ms > 0).all()


def test_two_processes_share_the_card_over_gloo(cuda_device, tmp_path):
    """tools/distributed_rollout_torch.py on the card: two ranks on it over
    gloo, B = 256, 5 steps, equal statistics, within 1e-6 of one
    process."""
    import json
    import subprocess
    import sys

    out = tmp_path / "dist.json"
    proc = subprocess.run(
        [sys.executable, "tools/distributed_rollout_torch.py", "--batch",
         "256", "--steps", "5", "--device", "cuda", "--timeout", "120",
         "--out", str(out)],
        cwd=str(Path(__file__).resolve().parent.parent), capture_output=True,
        text=True, timeout=360)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["ok"] and res["ranks_equal"]
    assert [r["reduce_device"] for r in res["ranks"]] == ["cpu", "cpu"]
    assert all(r["launches"] == {"walking_tick": 5} for r in res["ranks"])


def test_dryrun_multichip_one_card(cuda_device):
    from mpc_limx_control_tpu_torch import entry

    kern = ro.tick_route(ControllerConfig.walking()).solve
    kern.reset()
    entry.dryrun_multichip(1)
    torch.cuda.synchronize()
    assert kern.launches == 12


# ---- the band condensation, the Kronecker-cone ADMM and the corpus ------

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_admm_warm_kron_runs_one_cholesky_kernel(cuda_device):
    """make_admm_warm_kron factors K with the ``cholesky`` kernel, once a
    call, and equals its plain twin (plain factorization) within 1e-4 of
    1 + the largest entry (the f32 rounding of two factorizations through
    the explicit K^-1)."""
    smoke = _smoke()
    cfg = ControllerConfig.walking()
    args, k, Gu, h = smoke.band_kron_inputs(cfg, 257, 40, cuda_device)
    from mpc_limx_control_tpu_torch.ops import condense as cnd

    H, f = cnd.condense_lti_diag(args[0], args[1], k["q_diag"], k["r_diag"],
                                 k["p_diag"], k["N"], args[3], args[2])
    solve = dict(iters=k["iters"], rho=k["rho"], alpha=k["alpha"])
    chol = chol_cuda.KERNELS["cholesky"]
    before = chol.launches
    _, (z, y) = qps.make_admm_warm_kron(Gu, **solve)(H, f, h, args[4],
                                                     args[5])
    assert chol.launches == before + 1
    _, (z_t, y_t) = qps.make_admm_warm_kron(Gu, plain_twins=True, **solve)(
        H, f, h, args[4], args[5])
    assert chol.launches == before + 1
    for a, b in ((z, z_t), (y, y_t)):
        assert float((a - b).abs().max()) <= 1e-4 * (float(b.abs().max())
                                                     + 1.0)


def test_band_kron_matches_dense_and_fused_qp(cuda_device):
    """chip_smoke.py's ``[band_kron]`` checks at B = 257: the band
    condensation against the dense one in f64, the kron ADMM against the
    dense ADMM on the expanded G and its plain twin, and the composition
    against the ``fused_qp_nu3`` kernel at 2e-3 * scale."""
    e = _smoke().band_kron_check(ControllerConfig.walking(), 257, 41,
                                 cuda_device)
    assert e["ok"], e


@pytest.mark.parametrize("mode", ["walk", "stand"])
def test_corpus_on_the_card_within_the_oracle_bands(cuda_device, mode):
    """The corpora of tests/test_active_set_oracle.py captured on the card
    (the fused tick kernels, one launch a tick) against the f64 active-set
    oracle with chip_smoke.py's ``corpus_report`` bands: the in-loop force,
    the f32 ``pdip_qp`` on the K8 kernels and K9 ``pdip_fused`` (20 Newton
    steps; a band miss other than the known ones of
    ``F32_BAND_FAULTS`` fails), K9 also held against its plain version by
    ``pdip_check`` after its 20 steps (the floor over eight arithmetic
    orders)."""
    from mpc_limx_control_tpu_torch.ops import qp_cuda
    from mpc_limx_control_tpu_torch.oracle import corpus

    smoke = _smoke()
    names = ("walk_steady", "walk_pushed") if mode == "walk" else ("stand",)
    tick = ro.tick_route(ControllerConfig.walking() if mode == "walk"
                         else ControllerConfig.standing()).solve
    before = tick.launches
    cqs = []
    for name in names:
        _, ticks, every, skip, kick = smoke.CORPORA[name]
        cfg = ControllerConfig.walking() if mode == "walk" \
            else ControllerConfig.standing()
        cqs += corpus.capture_corpus(cfg, ticks, every, skip_first=skip,
                                     kick=kick)
        assert cqs[-1].u_loop.dtype == np.float64
    assert tick.launches - before == (140 if mode == "walk" else 300)
    batch = smoke.corpus_batch(cqs, torch.float32, cuda_device)
    k9_args = smoke.pdip_start(*batch)
    sols = {"pdip": qps.pdip_qp(*batch, iters=20).u.cpu().numpy(),
            "k9": qp_cuda.pdip_fused(*k9_args, iters=20)[0].cpu().numpy()}
    e = smoke.corpus_report(cqs, sols)
    assert e["ok"], e
    check = smoke.pdip_check(k9_args, 20, smoke.pdip_floor(k9_args, 20,
                                                           orders=8))
    assert check["ok"], check


# ---- the live session's tick kernels (csrc/session_tick.cu) -------------
def _cmd_fields():
    from mpc_limx_control_tpu_torch.control import session as ses

    return (("q", ses.Q), ("dq", ses.DQ), ("tau", ses.TAU),
            ("kp", slice(18, 24)), ("kd", slice(24, 30)))


@pytest.mark.parametrize("phases", ["staggered", "phase_switch"])
@pytest.mark.parametrize("form", ["hold", "solve"])
def test_session_kernels_match_plain_tick(cuda_device, form, phases):
    """walking_session_tick_hold / walking_session_tick against the plain
    controller.tick (exact-solve ADMM) on the same 257 session packets:
    left- and right-swing phases, every fourth anchor outside its band;
    "phase_switch" moves every packet to within two ticks of a swing /
    stance switch. The bands of test_tick_variant_matches_plain; the
    torque within the force's band (the Jacobian's entries are under 1 m)
    where the force is solved, within 1e-3 where it is held."""
    from mpc_limx_control_tpu_torch.control import session as ses

    smoke = _smoke()
    cfg = ControllerConfig.walking()
    pk, (z, y) = smoke.session_packets(cfg, 257, 30, cuda_device)
    if phases == "phase_switch":
        it = pk[:, ses.IT]
        pk[:, ses.IT] = torch.where(it % 600 < 300, 298.0, 598.0) \
            + it % 4.0
    B = pk.shape[0]
    if form == "hold":
        kern = tfc.WALKING_SESSION_TICK_HOLD
        cmd_p, anc_p, _, _ = smoke.session_tick_plain(cfg, pk)
        pk_k = pk.clone()
        out = torch.empty((B, ses.CMD), device=cuda_device)
        before = kern.launches
        tfc.walking_session_tick_hold(cfg, pk_k, out)
        assert kern.launches == before + 1
        anc_k, tau_band = pk_k[:, ses.ANCHOR], 1e-3
        # only the anchor of the packet is written
        head = slice(0, ses.ANCHOR.start)
        assert torch.equal(pk_k[:, head], pk[:, head])
        assert torch.equal(pk_k[:, ses.GRF], pk[:, ses.GRF])
    else:
        kern = tfc.WALKING_SESSION_TICK
        cmd_p, anc_p, grf_p, (z_p, y_p) = smoke.session_tick_plain(
            cfg, pk, z, y, solve_form="subst")
        zk, yk = z.clone(), y.clone()
        out = torch.empty((B, ses.W_GRF.stop), device=cuda_device)
        before = kern.launches
        tfc.walking_session_tick(cfg, pk[:, :ses.SOLVE_IN].contiguous(),
                                 zk, yk, out)
        assert kern.launches == before + 1
        anc_k, tau_band = out[:, ses.W_ANCHOR], 5e-2
        torch.testing.assert_close(out[:, ses.W_GRF], grf_p, atol=5e-2,
                                   rtol=0)
        torch.testing.assert_close(zk[:, :9], z_p[:, :9], atol=5e-2, rtol=0)
    bands = {"q": 5e-4, "dq": 0.0, "tau": tau_band, "kp": 0.0, "kd": 0.0}
    for k, sl in _cmd_fields():
        torch.testing.assert_close(out[:, sl], cmd_p[:, sl], atol=bands[k],
                                   rtol=0, msg=k)
    torch.testing.assert_close(anc_k, anc_p, atol=1e-5, rtol=0)


def test_session_kernel_chains_25_warm_solves(cuda_device):
    """25 warm solves of 257 session packets, the QP state threaded through
    the kernel (in place) and through the plain tick, the iteration
    advancing by mpc_step between solves as in the session: the commands,
    the force and the warm start within the five-tick chain's bands of
    test_tick_variant_matches_plain; 25 launches."""
    from mpc_limx_control_tpu_torch.control import session as ses

    smoke = _smoke()
    cfg = ControllerConfig.walking()
    pk, (z, y) = smoke.session_packets(cfg, 257, 31, cuda_device)
    B = pk.shape[0]
    zk, yk, zp, yp = z.clone(), y.clone(), z, y
    out = torch.empty((B, ses.W_GRF.stop), device=cuda_device)
    kern = tfc.WALKING_SESSION_TICK
    before = kern.launches
    for j in range(25):
        p = pk.clone()
        p[:, ses.IT] += float(cfg.gait.mpc_step * j)
        tfc.walking_session_tick(cfg, p[:, :ses.SOLVE_IN].contiguous(), zk,
                                 yk, out)
        cmd_p, _, grf_p, (zp, yp) = smoke.session_tick_plain(
            cfg, p, zp, yp, solve_form="subst")
    assert kern.launches == before + 25
    torch.testing.assert_close(out[:, ses.Q], cmd_p[:, ses.Q], atol=1e-3,
                               rtol=0)
    torch.testing.assert_close(out[:, ses.W_GRF], grf_p, atol=2e-1, rtol=0)
    torch.testing.assert_close(out[:, ses.TAU], cmd_p[:, ses.TAU], atol=2e-1,
                               rtol=0)
    torch.testing.assert_close(zk[:, :9], zp[:, :9], atol=2e-1, rtol=0)


def test_session_graphs_replay_one_kernel(cuda_device):
    """A walking session's hold and warm graphs each launch one kernel a
    replay, the session kernel (its launch map, and torch.profiler's
    device kernels of one replay); run() counts every tick a kernel
    tick."""
    from torch.autograd import DeviceType

    cfg = ControllerConfig.walking()
    s, stats = _scripted_session(cfg, True, 19946, 10, False)
    assert stats["kernel_ticks"] == 10
    want = {"hold": tfc.WALKING_SESSION_TICK_HOLD,
            "warm": tfc.WALKING_SESSION_TICK}
    try:
        for name, kern in want.items():
            g = s._graphs[name]
            assert g.launches == {kern: 1}
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                g.replay()
                torch.cuda.synchronize()
            names = [e.name for e in p.events()
                     if e.device_type == DeviceType.CUDA]
            assert len(names) == 1 and "walking_session_kernel" in names[0], \
                names
    finally:
        s.close()
