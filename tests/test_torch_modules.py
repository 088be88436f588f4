"""Module parity of the PyTorch port against the JAX package, on the CPU.

The same numpy-seeded inputs go through each JAX function and its
counterpart in ``mpc_limx_control_tpu_torch``. float64 agrees to 1e-9 (the
two packages run the same formulas; only the summation order of a few
contractions differs); float32 tolerances are stated per test (a few ulp
of the result's scale unless noted).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_limx_control_tpu.control import gait as jgait
from mpc_limx_control_tpu.core import config as jcfg
from mpc_limx_control_tpu.models import kinematics as jkin
from mpc_limx_control_tpu.models import srbd as jsrbd
from mpc_limx_control_tpu.ops import condense as jcnd
from mpc_limx_control_tpu.ops import qp as jqp
from mpc_limx_control_tpu.utils import rotations as jrot
from mpc_limx_control_tpu_torch.control import gait as tgait
from mpc_limx_control_tpu_torch.core import config as tcfg
from mpc_limx_control_tpu_torch.models import kinematics as tkin
from mpc_limx_control_tpu_torch.models import srbd as tsrbd
from mpc_limx_control_tpu_torch.ops import condense as tcnd
from mpc_limx_control_tpu_torch.ops import qp as tqp
from mpc_limx_control_tpu_torch.utils import convert
from mpc_limx_control_tpu_torch.utils import rotations as trot

REPO = Path(__file__).resolve().parents[1]
DTYPES = [pytest.param(np.float64, torch.float64, id="f64"),
          pytest.param(np.float32, torch.float32, id="f32")]


def T(a, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype)


def J(a, np_dtype):
    return jnp.asarray(np.asarray(a, np_dtype))


def close(t, j, atol):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor)
                               else np.asarray(t), np.asarray(j),
                               atol=atol, rtol=0)


def tol(np_dtype, f32):
    return 1e-9 if np_dtype == np.float64 else f32


# ---- config -------------------------------------------------------------

@pytest.mark.parametrize("preset", ["default", "walking", "standing"])
def test_config_copies_are_equal(preset):
    """The port keeps its own copy of core/config.py (the JAX package
    cannot be imported without JAX); the two must stay field-for-field
    equal, including the presets."""
    make = {"default": lambda m: m.ControllerConfig(),
            "walking": lambda m: m.ControllerConfig.walking(),
            "standing": lambda m: m.ControllerConfig.standing()}[preset]
    assert dataclasses.asdict(make(jcfg)) == dataclasses.asdict(make(tcfg))
    assert convert.config_from_dict(make(jcfg)) == make(tcfg)
    assert convert.config_to_dict(make(tcfg)) == dataclasses.asdict(
        make(jcfg))


def test_config_sources_match_verbatim():
    a = (REPO / "mpc_limx_control_tpu/core/config.py").read_text()
    b = (REPO / "mpc_limx_control_tpu_torch/core/config.py").read_text()
    assert a == b


# ---- rotations ----------------------------------------------------------

@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_rotations(np_dtype, t_dtype):
    rng = np.random.default_rng(0)
    rpy = rng.uniform(-1.2, 1.2, (32, 3))
    q = rng.standard_normal((32, 4))
    a = tol(np_dtype, 2e-6)
    close(trot.rpy_to_quat(T(rpy, t_dtype)), jrot.rpy_to_quat(J(rpy, np_dtype)),
          a)
    close(trot.quat_to_rot(T(q, t_dtype)), jrot.quat_to_rot(J(q, np_dtype)), a)
    close(trot.rpy_to_rot(T(rpy, t_dtype)), jrot.rpy_to_rot(J(rpy, np_dtype)),
          a)


# ---- kinematics ---------------------------------------------------------

@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_kinematics(np_dtype, t_dtype, side):
    rng = np.random.default_rng(1)
    q = rng.uniform(-0.8, 0.8, (64, 3))
    guess = q + rng.uniform(-0.3, 0.3, (64, 3))
    gj = jkin.leg_geometry(jcfg.LegOffsets(), side, jnp.dtype(np_dtype))
    gt = tkin.leg_geometry(tcfg.LegOffsets(), side, t_dtype)
    for fj, ft in zip(gj, gt):
        close(ft, fj, 0.0)
    a = tol(np_dtype, 2e-6)
    p_j = jkin.forward_kinematics(gj, J(q, np_dtype))
    p_t = tkin.forward_kinematics(gt, T(q, t_dtype))
    close(p_t, p_j, a)
    close(tkin.contact_jacobian(gt, T(q, t_dtype)),
          jkin.contact_jacobian(gj, J(q, np_dtype)), a)
    close(tkin.inverse_kinematics_analytic(gt, p_t, T(guess, t_dtype)),
          jkin.inverse_kinematics_analytic(gj, p_j, J(guess, np_dtype)),
          tol(np_dtype, 5e-5))   # acos near the workspace boundary
    q6 = rng.uniform(-0.5, 0.5, (8, 6))
    for a_t, a_j in zip(tkin.full_fk(tcfg.LegOffsets(), T(q6, t_dtype)),
                        jkin.full_fk(jcfg.LegOffsets(), J(q6, np_dtype))):
        close(a_t, a_j, a)


def test_geometry_select_matches_tree_map():
    gl = tkin.leg_geometry(side="left", dtype=torch.float64)
    gr = tkin.leg_geometry(side="right", dtype=torch.float64)
    cond = torch.tensor([True, False, True])
    sel = tkin.select_geometry(cond, gl, gr)
    for f_sel, f_l, f_r in zip(sel, gl, gr):
        assert torch.equal(f_sel[0], f_l) and torch.equal(f_sel[1], f_r)


# ---- srbd ---------------------------------------------------------------

def _srbd_inputs(B, K, seed):
    rng = np.random.default_rng(seed)
    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    yaw = 0.3 * rng.standard_normal(B)
    arms = (pos[:, None, :] + np.array([0.02, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, K, 3)))
    return pos, yaw, arms


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_srbd_linearize_discretize(np_dtype, t_dtype):
    robot_j, robot_t = jcfg.RobotParams(), tcfg.RobotParams()
    pos, yaw, arms = _srbd_inputs(5, 20, 2)
    close(tsrbd.inertia_matrix(robot_t, t_dtype),
          jsrbd.inertia_matrix(robot_j, jnp.dtype(np_dtype)), 0.0)
    Ac_j, Bc_j = jsrbd.linearize_shared(robot_j, J(arms, np_dtype),
                                        J(pos, np_dtype), J(yaw, np_dtype),
                                        jnp.dtype(np_dtype))
    Ac_t, Bc_t = tsrbd.linearize_shared(robot_t, T(arms, t_dtype),
                                        T(pos, t_dtype), T(yaw, t_dtype))
    close(Ac_t, Ac_j, tol(np_dtype, 1e-6))
    close(Bc_t, Bc_j, tol(np_dtype, 5e-5))     # |I_w^-1| ~ 10
    ts = 0.02
    Ad_j, Bd_j = jsrbd.discretize_srbd(Ac_j, Bc_j, ts)
    Ad_t, Bd_t = tsrbd.discretize_srbd(Ac_t, Bc_t, ts)
    close(Ad_t, Ad_j, tol(np_dtype, 1e-7))
    close(Bd_t, Bd_j, tol(np_dtype, 1e-7))
    # unbatched-arm form of discretize_srbd
    Ad2_j, Bd2_j = jsrbd.discretize_srbd(Ac_j, Bc_j[:, 0], ts)
    Ad2_t, Bd2_t = tsrbd.discretize_srbd(Ac_t, Bc_t[:, 0], ts)
    close(Bd2_t, Bd2_j, tol(np_dtype, 1e-7))


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_srbd_step_vector(np_dtype, t_dtype):
    rng = np.random.default_rng(3)
    B = 7
    pos, yaw, feet = _srbd_inputs(B, 2, 3)
    xi = np.concatenate([0.05 * rng.standard_normal((B, 2)), yaw[:, None],
                         pos, 0.3 * rng.standard_normal((B, 6)),
                         np.full((B, 1), -9.81)], -1)
    forces = np.abs(rng.standard_normal((B, 2, 3))) * np.array([5, 5, 50])
    a = tol(np_dtype, 2e-6)
    close(tsrbd.srbd_step_vector(tcfg.RobotParams(), T(xi, t_dtype),
                                 T(feet, t_dtype), T(forces, t_dtype), 1e-3),
          jsrbd.srbd_step_vector(jcfg.RobotParams(), J(xi, np_dtype),
                                 J(feet, np_dtype), J(forces, np_dtype),
                                 1e-3), a)
    close(tsrbd.initial_state(T(xi[:, :3], t_dtype), T(xi[:, 3:6], t_dtype),
                              T(xi[:, 6:9], t_dtype), T(xi[:, 9:12], t_dtype)),
          jsrbd.initial_state(J(xi[:, :3], np_dtype), J(xi[:, 3:6], np_dtype),
                              J(xi[:, 6:9], np_dtype),
                              J(xi[:, 9:12], np_dtype)), a)


def test_friction_cone_rows():
    c_j, c_t = jcfg.SRBDConfig.walking(), tcfg.SRBDConfig.walking()
    G_j, h_j = jsrbd.friction_cone_rows(c_j, 20, jnp.float64)
    G_t, h_t = tsrbd.friction_cone_rows(c_t, 20, torch.float64)
    close(G_t, G_j, 0.0)
    close(h_t, h_j, 0.0)


@pytest.mark.parametrize("attitude", ["level", "receding"])
@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_walking_reference(np_dtype, t_dtype, anchored, attitude):
    rng = np.random.default_rng(4)
    B, N = 5, 20
    c_j = dataclasses.replace(jcfg.SRBDConfig.walking(),
                              attitude_ref=attitude)
    c_t = dataclasses.replace(tcfg.SRBDConfig.walking(),
                              attitude_ref=attitude)
    xi0 = rng.standard_normal((B, 13)) * 0.2
    v = rng.standard_normal((B, 3)) * 0.5
    w = rng.standard_normal(B) * 0.3
    anc = rng.standard_normal((B, 3)) * 0.1
    kw_j, kw_t = {}, {}
    if anchored:
        kw_j = dict(pos_anchor=J(anc, np_dtype),
                    yaw_anchor=J(anc[:, 2], np_dtype))
        kw_t = dict(pos_anchor=T(anc, t_dtype),
                    yaw_anchor=T(anc[:, 2], t_dtype))
    r_j = jax.vmap(lambda x, vv, ww, *a: jsrbd.walking_reference(
        x, c_j, N, vv, ww, height_des=0.65,
        **dict(zip(kw_j, a))))(J(xi0, np_dtype), J(v, np_dtype),
                               J(w, np_dtype), *kw_j.values())
    r_t = tsrbd.walking_reference(T(xi0, t_dtype), c_t, N, T(v, t_dtype),
                                  T(w, t_dtype), height_des=0.65, **kw_t)
    close(r_t, r_j, tol(np_dtype, 1e-6))


def test_walking_reference_validates_attitude():
    c = dataclasses.replace(tcfg.SRBDConfig.walking(), attitude_ref="lvl")
    x = torch.zeros(1, 13)
    with pytest.raises(ValueError, match="attitude_ref"):
        tsrbd.walking_reference(x, c, 4, torch.zeros(1, 3), torch.zeros(1))


# ---- gait ---------------------------------------------------------------

def test_gait_clock_switch_ticks_match_jax_f32():
    """Phase switches land on the same tick: the float32 clock over
    60 s of ticks, every field."""
    g_j, g_t = jcfg.ControllerConfig.walking().gait, \
        tcfg.ControllerConfig.walking().gait
    its = np.arange(60000, dtype=np.float32)
    gs_j = jgait.gait_clock(g_j, jnp.asarray(its))
    gs_t = tgait.gait_clock(g_t, torch.from_numpy(its))
    np.testing.assert_array_equal(gs_t.left_swing.numpy(),
                                  np.asarray(gs_j.left_swing))
    for f in ("phase", "remain_swing_time", "swing_progress"):
        close(getattr(gs_t, f), getattr(gs_j, f), 0.0)
    sch_j = jgait.contact_schedule(g_j, jnp.asarray(its[:6000]), 20, 0.02)
    sch_t = tgait.contact_schedule(g_t, torch.from_numpy(its[:6000]), 20,
                                   0.02)
    np.testing.assert_array_equal(sch_t.numpy(), np.asarray(sch_j))


@pytest.mark.parametrize("mode", ["capture", "reference"])
@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_foot_placement_and_swing(np_dtype, t_dtype, mode):
    rng = np.random.default_rng(5)
    B = 16
    cj = dataclasses.replace(jcfg.ControllerConfig.walking(),
                             placement_mode=mode)
    ct = dataclasses.replace(tcfg.ControllerConfig.walking(),
                             placement_mode=mode)
    its = rng.integers(0, 5000, B).astype(np_dtype)
    base = rng.standard_normal((B, 3)) * 0.3
    vd = rng.standard_normal((B, 3)) * 0.5
    va = rng.standard_normal((B, 3)) * 0.5
    foot = rng.standard_normal((B, 3)) * 0.3
    gs_j = jgait.gait_clock(cj.gait, J(its, np_dtype))
    gs_t = tgait.gait_clock(ct.gait, T(its, t_dtype))
    tgt_j = jgait.foot_placement(cj, gs_j, J(base, np_dtype),
                                 J(vd, np_dtype), J(va, np_dtype))
    tgt_t = tgait.foot_placement(ct, gs_t, T(base, t_dtype), T(vd, t_dtype),
                                 T(va, t_dtype))
    a = tol(np_dtype, 1e-6)
    close(tgt_t, tgt_j, a)
    close(tgait.swing_trajectory(ct.gait, gs_t, T(foot, t_dtype), tgt_t,
                                 0.1),
          jgait.swing_trajectory(cj.gait, gs_j, J(foot, np_dtype), tgt_j,
                                 0.1), a)


# ---- condense + ADMM ----------------------------------------------------

def _qp_problem(np_dtype, B=4, N=20, seed=6):
    pos, yaw, arms = _srbd_inputs(B, N, seed)
    rng = np.random.default_rng(seed + 1)
    cfg = jcfg.ControllerConfig.walking()
    Ac, Bc = jsrbd.linearize_shared(cfg.robot, J(arms, np_dtype),
                                    J(pos, np_dtype), J(yaw, np_dtype),
                                    jnp.dtype(np_dtype))
    Ad, Bd = jsrbd.discretize_srbd(Ac, Bc, cfg.srbd.ts)
    x0 = np.concatenate([0.01 * rng.standard_normal((B, 2)), yaw[:, None],
                         pos, np.zeros((B, 3)),
                         np.array([0.4, 0, 0]) + np.zeros((B, 3)),
                         np.full((B, 1), -9.81)], -1)
    x_ref = np.asarray(jax.vmap(lambda x: jsrbd.walking_reference(
        x, cfg.srbd, N, jnp.asarray([0.5, 0.0, 0.0], np_dtype),
        jnp.zeros((), np_dtype), height_des=0.65))(J(x0, np_dtype)))
    z_w = 5.0 * rng.standard_normal((B, 3 * N))
    y_w = np.abs(rng.standard_normal((B, 6 * N)))
    return (cfg, np.asarray(Ad), np.asarray(Bd), x0.astype(np_dtype),
            x_ref, z_w.astype(np_dtype), y_w.astype(np_dtype))


def _weights(cfg, lib, dtype):
    c = cfg.srbd
    if lib == "jax":
        Q = jnp.diag(jnp.asarray(c.q_diag, dtype))
        R = jnp.diag(jnp.asarray(c.r_diag, dtype))
    else:
        Q = torch.diag(torch.tensor(c.q_diag, dtype=dtype))
        R = torch.diag(torch.tensor(c.r_diag, dtype=dtype))
    return Q, R, c.p_scale * Q


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_condense(np_dtype, t_dtype):
    cfg, Ad, Bd, x0, x_ref, _, _ = _qp_problem(np_dtype)
    N = cfg.srbd.horizon
    Qj, Rj, Pj = _weights(cfg, "jax", jnp.dtype(np_dtype))
    Qt, Rt, Pt = _weights(cfg, "torch", t_dtype)
    Gj, hj = jsrbd.friction_cone_rows(cfg.srbd, N, jnp.dtype(np_dtype))
    Gt, ht = tsrbd.friction_cone_rows(cfg.srbd, N, t_dtype)
    qj = jax.vmap(lambda a, b, x, r: jcnd.condense(
        a, b, Qj, Rj, Pj, N, x, r, None, None, extra_G=Gj, extra_h=hj))(
        J(Ad, np_dtype), J(Bd, np_dtype), J(x0, np_dtype),
        J(x_ref, np_dtype))
    qt = tcnd.condense(T(Ad, t_dtype), T(Bd, t_dtype), Qt, Rt, Pt, N,
                       T(x0, t_dtype), T(x_ref, t_dtype), extra_G=Gt,
                       extra_h=ht)
    scale_h = float(np.abs(np.asarray(qj.H)).max())
    scale_f = float(np.abs(np.asarray(qj.f)).max())
    # f32: the dense B'QB contraction sums 273 products per entry
    close(qt.H, qj.H, tol(np_dtype, 2e-6) * scale_h)
    close(qt.f, qj.f, tol(np_dtype, 2e-6) * scale_f)
    close(qt.G, qj.G, 0.0)
    close(qt.h, qj.h, 0.0)
    close(qt.A_blocks, qj.A_blocks, tol(np_dtype, 1e-6))
    close(qt.B_blocks, qj.B_blocks, tol(np_dtype, 1e-6))
    # the input-box rows of the generic condense
    qbj = jax.vmap(lambda a, b, x, r: jcnd.condense(
        a, b, Qj, Rj, Pj, N, x, r, -8.0, 8.0))(
        J(Ad, np_dtype), J(Bd, np_dtype), J(x0, np_dtype),
        J(x_ref, np_dtype))
    qbt = tcnd.condense(T(Ad, t_dtype), T(Bd, t_dtype), Qt, Rt, Pt, N,
                        T(x0, t_dtype), T(x_ref, t_dtype), -8.0, 8.0)
    close(qbt.G, qbj.G, 0.0)
    close(qbt.h, qbj.h, 0.0)


@pytest.mark.parametrize("np_dtype,t_dtype", DTYPES)
def test_batched_admm(np_dtype, t_dtype):
    """"kinv" is the JAX composition's algorithm: f64 agrees to 1e-9 and
    f32 to 2e-3 of the solution scale (the explicit f32 K^-1 carries a
    ~1e-2 relative residual that each library rounds differently).
    "subst" solves exactly: f64 agrees with "kinv" to 1e-9."""
    cfg, Ad, Bd, x0, x_ref, z_w, y_w = _qp_problem(np_dtype)
    N = cfg.srbd.horizon
    Qj, Rj, Pj = _weights(cfg, "jax", jnp.dtype(np_dtype))
    Gj, hj = jsrbd.friction_cone_rows(cfg.srbd, N, jnp.dtype(np_dtype))
    qj = jax.vmap(lambda a, b, x, r: jcnd.condense(
        a, b, Qj, Rj, Pj, N, x, r, None, None, extra_G=Gj, extra_h=hj))(
        J(Ad, np_dtype), J(Bd, np_dtype), J(x0, np_dtype),
        J(x_ref, np_dtype))
    B = x0.shape[0]
    s = cfg.srbd.solver
    args = (s.admm_warm_iters, s.admm_rho, s.admm_alpha)
    sol_j, (z_j, y_j) = jqp._batched_admm(
        qj.H, qj.f, jnp.broadcast_to(Gj, (B, *Gj.shape)),
        jnp.broadcast_to(hj, (B, *hj.shape)), J(z_w, np_dtype),
        J(y_w, np_dtype), *args, False)
    qt = [T(np.asarray(a), t_dtype) for a in
          (qj.H, qj.f, jnp.broadcast_to(Gj, (B, *Gj.shape)),
           jnp.broadcast_to(hj, (B, *hj.shape)))]
    out = {form: tqp._batched_admm(*qt, T(z_w, t_dtype), T(y_w, t_dtype),
                                   *args, solve_form=form)
           for form in ("kinv", "subst")}
    scale = float(np.abs(np.asarray(z_j)).max()) + 1.0
    sol_t, (z_t, y_t) = out["kinv"]
    a = tol(np_dtype, 2e-3) * scale
    close(z_t, z_j, a)
    close(y_t, y_j, a)
    close(sol_t.residual, sol_j.residual, tol(np_dtype, 1e-2))
    assert sol_t.iterations == sol_j.iterations
    z_s = out["subst"][1][0]
    if np_dtype == np.float64:
        close(z_s, z_t, 1e-9 * scale)
    else:
        close(z_s, z_t, 2e-3 * scale)


def test_batched_admm_validates_solve_form():
    z = torch.zeros(1, 3)
    with pytest.raises(ValueError, match="solve_form"):
        tqp._batched_admm(torch.eye(3)[None], z, torch.eye(3)[None], z, z,
                          z, 1, 1.0, 1.6, solve_form="inv")


# ---- package hygiene ----------------------------------------------------

def test_tf32_pins():
    import mpc_limx_control_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_port_imports_without_jax():
    """Every port module (and chip_smoke.py) imports with jax, chex and
    the JAX package made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'chex', 'mpc_limx_control_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import mpc_limx_control_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card chip_smoke.py exits non-zero and prints no result;
    alone in a directory it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_convert_plant_state_round_trip():
    from mpc_limx_control_tpu_torch.control import rollout as tro

    cfg = tcfg.ControllerConfig.walking()
    s = tro.initial_plant_state(cfg, batch=(3,), dtype=torch.float64,
                                device="cpu")
    d = convert.plant_state_to_numpy(s)
    assert set(d) == {"xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam",
                      "ref_anchor"}
    s2 = convert.plant_state_from_numpy(d, device="cpu")
    for k, v in d.items():
        np.testing.assert_array_equal(getattr(s2, k).numpy(), v)
    with pytest.raises(ValueError, match="kf"):
        convert.plant_state_from_numpy(dict(d, kf=np.zeros(3)), device="cpu")
