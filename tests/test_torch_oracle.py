"""The port's float64 oracles and QP corpus (``mpc_limx_control_tpu_torch/
oracle/``) against the JAX package's, on the CPU.

* qp_oracle.py, qp_active_set.py, pipeline.py and __init__.py are the JAX
  package's numpy / scipy files copied with the package name renamed (the
  card's machine has no JAX, and the JAX package's __init__ imports it):
  held equal to them, and the active set held against the IPM as in
  tests/test_active_set_oracle.py;
* rnea_oracle.py (Euler-Lagrange by torch.func in float64) against JAX's
  and against the port's ``rnea`` at 1e-12;
* corpus.py: the float64 QP rebuilds against JAX's on the same states at
  1e-9 relative, and ``capture_corpus(device="cpu")`` within the bands of
  chip_smoke.py's ``[corpus]`` phase, the float64 PDIP within 1e-6.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_limx_control_tpu.control import rollout as jro
from mpc_limx_control_tpu.core.config import ControllerConfig as JCfg
from mpc_limx_control_tpu.oracle import corpus as jcorpus
from mpc_limx_control_tpu.oracle import pipeline as jpipeline
from mpc_limx_control_tpu.oracle.rnea_oracle import (
    solve_rnea_oracle as j_rnea_oracle)
from mpc_limx_control_tpu_torch.core.config import ControllerConfig as TCfg
from mpc_limx_control_tpu_torch.models import dynamics as tdyn
from mpc_limx_control_tpu_torch.ops import qp as tqp
from mpc_limx_control_tpu_torch.ops import qp_cuda
from mpc_limx_control_tpu_torch.oracle import corpus as tcorpus
from mpc_limx_control_tpu_torch.oracle import pipeline as tpipeline
from mpc_limx_control_tpu_torch.oracle.qp_active_set import (
    ActiveSetError, solve_qp_active_set)
from mpc_limx_control_tpu_torch.oracle.qp_oracle import solve_qp_oracle
from mpc_limx_control_tpu_torch.oracle.rnea_oracle import solve_rnea_oracle
from mpc_limx_control_tpu_torch.utils import convert

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam", "ref_anchor")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ticks are host loops over many small torch calls: one
    torch thread per test worker while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---- the numpy oracles: verbatim copies --------------------------------

@pytest.mark.parametrize("name", ["__init__", "qp_oracle", "qp_active_set",
                                  "pipeline"])
def test_oracle_copies_equal_jax_modulo_package_name(name):
    a = (REPO / f"mpc_limx_control_tpu/oracle/{name}.py").read_text()
    b = (REPO / f"mpc_limx_control_tpu_torch/oracle/{name}.py").read_text()
    assert a.replace("mpc_limx_control_tpu.", "mpc_limx_control_tpu_torch.") \
        == b


def _random_feasible_qp(rng, n, m):
    A = rng.normal(size=(n, n))
    H = A @ A.T + 0.1 * np.eye(n)
    f = 5.0 * rng.normal(size=n)
    G = rng.normal(size=(m, n))
    h = G @ rng.normal(size=n) + np.abs(rng.normal(size=m)) * 0.5
    return H, f, G, h


def test_active_set_vs_ipm_random():
    """tests/test_active_set_oracle.py's 40 random strictly convex QPs
    (nz up to 120, m up to 2 nz) through the port's copies: agreement
    <= 1e-8, exact KKT residuals <= 1e-9."""
    rng = np.random.default_rng(42)
    worst = 0.0
    for trial in range(40):
        n = int(rng.integers(2, 121))
        m = int(rng.integers(1, 2 * n + 1))
        H, f, G, h = _random_feasible_qp(rng, n, m)
        z_as, _, info = solve_qp_active_set(H, f, G, h)
        assert max(info["residuals"]) < 1e-9, (trial, info["residuals"])
        z_ip, _, _ = solve_qp_oracle(H, f, G, h)
        worst = max(worst, np.max(np.abs(z_as - z_ip))
                    / (1.0 + np.max(np.abs(z_as))))
    assert worst < 1e-8, worst


def test_active_set_hand_cases():
    """The three hand cases: the box clip with its multipliers, a solution
    path that drops a constraint (partial step), an infeasible pair."""
    z, lam, info = solve_qp_active_set(np.eye(3), -np.array([2.0, -1.0, 0.5]),
                                       np.eye(3), np.array([1.0, 0.0, 1.0]))
    np.testing.assert_allclose(z, [1.0, -1.0, 0.5], atol=1e-12)
    np.testing.assert_allclose(lam, [1.0, 0.0, 0.0], atol=1e-12)
    assert info["active_set"] == [0]

    z, _, info = solve_qp_active_set(np.eye(2), np.array([0.0, -10.0]),
                                     np.array([[0.0, 1.0], [1.0, 1.0]]),
                                     np.array([1.0, 1.0]))
    np.testing.assert_allclose(z, [0.0, 1.0], atol=1e-10)
    assert max(info["residuals"]) < 1e-10

    with pytest.raises(ActiveSetError):
        solve_qp_active_set(np.eye(2), np.zeros(2),
                            np.array([[1.0, 0.0], [-1.0, 0.0]]),
                            np.array([-1.0, -1.0]))


def test_pipeline_copy_runs_the_circle_loop():
    """The copied pipeline drives the qpSolver_test circle loop as JAX's
    does (both numpy: equal), and both oracles agree on it <= 1e-8."""
    r_t = tpipeline.run_closed_loop(steps=40)
    r_j = jpipeline.run_closed_loop(steps=40)
    np.testing.assert_array_equal(r_t["controls"], r_j["controls"])
    r_as = tpipeline.run_closed_loop(steps=40, solver=solve_qp_active_set)
    assert np.max(np.abs(r_t["controls"] - r_as["controls"])) < 1e-8


# ---- the Lagrangian inverse-dynamics oracle -------------------------------

@pytest.mark.parametrize("side", ["left", "right"])
def test_rnea_oracle_matches_jax_and_rnea(side):
    rng = np.random.default_rng(3)
    worst = 0.0
    for i in range(10):
        q = rng.uniform(-1.2, 1.2, 3)
        dq = 3.0 * rng.normal(size=3)
        ddq = 10.0 * rng.normal(size=3)
        t_o = solve_rnea_oracle(q, dq, ddq, side=side)
        assert t_o.dtype == torch.float64 and t_o.shape == (3,)
        t_r = tdyn.rnea(*(torch.tensor(a) for a in (q, dq, ddq)), side=side)
        worst = max(worst, float((t_o - t_r).abs().max())
                    / (1.0 + float(t_o.abs().max())))
        if i < 2:
            t_j = np.asarray(j_rnea_oracle(q, dq, ddq, side=side))
            assert (np.abs(t_j - t_o.numpy()).max()
                    / (1.0 + np.abs(t_j).max())) < 1e-12
    assert worst < 1e-12, worst


def test_rnea_oracle_keeps_the_callers_device_in_float64():
    q = torch.tensor([0.1, -0.4, 0.9], dtype=torch.float32)
    tau = solve_rnea_oracle(q, torch.zeros(3), torch.zeros(3))
    assert tau.dtype == torch.float64 and tau.device == q.device
    np.testing.assert_allclose(
        tau.numpy(), tdyn.gravity_torques(q.double()).numpy(), atol=1e-12)


# ---- the QP corpus ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["walk", "stand"])
def test_qp_rebuilds_match_jax(mode):
    """build_walking_qp_f64 / build_standing_qp_f64 against JAX's on the
    same kicked states (carried by plant_state_from_numpy; f32 states, as
    the loop holds them), at 1e-9 relative, at ticks on both gait
    phases."""
    jcfg = JCfg.walking() if mode == "walk" else JCfg.standing()
    tcfg = TCfg.walking() if mode == "walk" else TCfg.standing()
    s0 = jro.initial_plant_state(jcfg)
    rng = np.random.default_rng(12)
    jb = (jcorpus.build_walking_qp_f64 if mode == "walk"
          else jcorpus.build_standing_qp_f64)
    tb = (tcorpus.build_walking_qp_f64 if mode == "walk"
          else tcorpus.build_standing_qp_f64)
    for k, it in enumerate((5.0, 140.0, 333.0, 470.0)):
        xi = np.asarray(s0.xi).copy()
        xi[9:12] += 0.1 * rng.standard_normal(3)
        xi[2] += 0.05 * rng.standard_normal()
        js = s0.replace(xi=jnp.asarray(xi, jnp.float32))
        if js.ref_anchor is not None and k % 2:
            # an anchor the band clips
            js = js.replace(ref_anchor=js.ref_anchor + 0.3)
        ts = convert.plant_state_from_numpy(
            {f: getattr(js, f) for f in FIELDS}, device="cpu")
        for a, b in zip(jb(jcfg, js, it), tb(tcfg, ts, it)):
            a = np.asarray(a)
            assert b.dtype == np.float64 and b.shape == a.shape
            assert np.abs(a - b).max() / (1.0 + np.abs(a).max()) < 1e-9


def test_qp_rebuild_without_anchor():
    """A state without a tracking anchor (ref_anchor None) rebuilds as
    JAX's does: the reference origin at the measured position."""
    jcfg, tcfg = JCfg.walking(), TCfg.walking()
    js = jro.initial_plant_state(jcfg).replace(ref_anchor=None)
    ts = convert.plant_state_from_numpy(
        {f: getattr(js, f) for f in FIELDS}, device="cpu")
    for a, b in zip(jcorpus.build_walking_qp_f64(jcfg, js, 77.0),
                    tcorpus.build_walking_qp_f64(tcfg, ts, 77.0)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def cpu_corpora(smoke):
    """chip_smoke.py's CORPORA captured on the CPU (the plain tick)."""
    out = {}
    for name, (mode, ticks, every, skip, kick) in smoke.CORPORA.items():
        cfg = TCfg.walking() if mode == "walk" else TCfg.standing()
        out[name] = tcorpus.capture_corpus(cfg, ticks, every,
                                           skip_first=skip, kick=kick,
                                           device="cpu")
    return {"walk": out["walk_steady"] + out["walk_pushed"],
            "stand": out["stand"]}


@pytest.mark.parametrize("mode", ["walk", "stand"])
def test_cpu_corpus_within_the_oracle_bands(smoke, cpu_corpora, mode):
    """The captured QPs (cold tick 0, warm steady, pushed with binding
    cones; standing) against the f64 active-set oracle with the bands of
    chip_smoke.py's [corpus] phase (the in-loop force, the batched f32
    pdip_qp and K9's plain version, known misses only), and the f64 PDIP
    (30 Newton steps) within 1e-6 on every QP."""
    cqs = cpu_corpora[mode]
    assert len(cqs) == (6 if mode == "walk" else 3)
    assert [c.warm for c in cqs] == [c.iteration > 0 for c in cqs]
    assert all(c.nu == (3 if mode == "walk" else 6) for c in cqs)
    batch = smoke.corpus_batch(cqs, torch.float32, "cpu")
    sols = {"pdip": tqp.pdip_qp(*batch, iters=20).u.numpy(),
            "k9": qp_cuda.pdip_fused(*smoke.pdip_start(*batch),
                                     iters=20)[0].numpy()}
    e = smoke.corpus_report(cqs, sols)
    assert e["ok"], e
    u64 = tqp.make_pdip(iters=30)(
        *smoke.corpus_batch(cqs, torch.float64, "cpu")).u.numpy()
    for c, u in zip(cqs, u64):
        z_as, _, _ = solve_qp_active_set(c.H, c.f, c.G, c.h)
        assert np.abs(u - z_as).max() / (1.0 + np.abs(z_as).max()) < 1e-6


def test_capture_corpus_kick_and_sampling():
    """The kick lands at its tick (the next sampled QP sees the lateral
    velocity) and sampling starts at skip_first."""
    cfg = TCfg.walking()
    cqs = tcorpus.capture_corpus(cfg, 12, 5, skip_first=2,
                                 kick=(1, (0.0, 0.4, 0.0)), device="cpu")
    assert [c.iteration for c in cqs] == [2, 7]
    assert [c.warm for c in cqs] == [True, True]
    plain = tcorpus.capture_corpus(cfg, 3, 5, skip_first=2, device="cpu")
    assert np.abs(plain[0].f - cqs[0].f).max() > 0.1


def test_capture_corpus_needs_a_card(monkeypatch):
    """Without a card capture_corpus raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcorpus.capture_corpus(TCfg.walking(), 2, 1)
    assert len(tcorpus.capture_corpus(TCfg.standing(), 2, 1,
                                      device="cpu")) == 2
