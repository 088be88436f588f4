"""The port's scenario mesh (``mpc_limx_control_tpu_torch.parallel.mesh``)
on a CPU mesh of 8 shards: the counterparts of tests/test_parallel.py's
first seven tests with JAX's bands (xi 1e-4, the per-step mean height
rtol 1e-6, the rollout statistics 1e-5), and:

* ``scenario_stats`` and the cross-shard reduction against JAX's
  ``scenario_stats`` on the same numpy metrics, with an exact tie of
  |h - mean| across a shard boundary;
* the sharded rollout against JAX's ``batched_rollout`` of the same
  numpy-seeded states in float64 (1e-8);
* ``entry`` against JAX's ``__graft_entry__.entry`` and
  ``dryrun_multichip(2)`` on CPU shards;
* each kernel launch made under the device of its tensors.

The eighth JAX test, the fused kernel under sharding, is the card's
(tests/test_torch_cuda.py, chip_smoke.py's ``[mesh]``).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from mpc_limx_control_tpu.control import rollout as jro
from mpc_limx_control_tpu.core.config import ControllerConfig as JCfg
from mpc_limx_control_tpu.parallel import mesh as jmesh
from mpc_limx_control_tpu_torch import entry as tentry
from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import (ControllerConfig,
                                                    GaitParams, SRBDConfig)
from mpc_limx_control_tpu_torch.ops import _build
from mpc_limx_control_tpu_torch.parallel import mesh as pmesh
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


@pytest.fixture(scope="module")
def cfg():
    """tests/test_parallel.py's walk config (N = 20)."""
    return dataclasses.replace(
        ControllerConfig(), mode="walk",
        gait=dataclasses.replace(GaitParams(), swing_time=0.3,
                                 stance_time=0.3),
        srbd=SRBDConfig.walking(), desired_velocity=(0.5, 0.0, 0.0))


def _mesh(n=8):
    return pmesh.make_mesh(["cpu"] * n)


def _kicked(cfg, B, seed):
    s0 = ro.initial_plant_state(cfg, batch=(B,), device="cpu")
    xi = s0.xi.clone()
    xi[:, 9] += 0.05 * torch.as_tensor(
        np.random.default_rng(seed).standard_normal(B), dtype=xi.dtype)
    return s0.replace(xi=xi)


# ---- tests/test_parallel.py's first seven ----------------------------------

def test_mesh_has_8_devices():
    mesh = _mesh()
    assert mesh.size == 8 and len(mesh.devices) == 8


def test_initialize_multihost_noop():
    # without a coordinator this is a no-op returning the device count
    # (the cards, or the CPU as one device)
    want = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert pmesh.initialize_multihost() == want


def test_sharded_step_matches_single_device(cfg):
    B = 16
    mesh = _mesh()
    s0 = _kicked(cfg, B, seed=0)
    step = pmesh.sharded_batch_step(cfg, mesh)
    out_sharded, stats = step(pmesh.shard_leading(s0, mesh), 0.0)
    out_local, metrics = ro.plant_step(cfg, s0, 0.0)
    np.testing.assert_allclose(out_sharded.gather().xi.numpy(),
                               out_local.xi.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(stats["mean_height"]),
                               float(metrics["height"].mean()), rtol=1e-6)


def test_shard_map_step_collectives(cfg):
    B = 8
    mesh = _mesh()
    s0 = ro.initial_plant_state(cfg, batch=(B,), device="cpu")
    out, stats = pmesh.shard_map_step(cfg, mesh)(
        pmesh.shard_leading(s0, mesh), 0.0)
    assert set(stats) == {"mean_height", "max_qp_residual"}
    assert np.isfinite(float(stats["mean_height"]))
    assert out.gather().xi.shape == (B, 13)


def test_sharding_preserved_across_steps(cfg):
    """Each shard stays on its device with its block of rows across
    steps."""
    B = 8
    mesh = _mesh()
    s0 = pmesh.shard_leading(ro.initial_plant_state(cfg, batch=(B,),
                                                    device="cpu"), mesh)
    step = pmesh.sharded_batch_step(cfg, mesh)
    s1, _ = step(s0, 0.0)
    s2, _ = step(s1, 1.0)
    assert s2.spec == ("data",) and s2.mesh == mesh
    assert s2.offsets == s0.offsets == tuple(range(8))
    for part, dev in zip(s2.parts, mesh.devices):
        for t in pmesh._leaves(part):
            assert t.device == dev and t.shape[0] == 1
    # the shards are copies: the step never wrote the global input
    g = s0.gather()
    np.testing.assert_array_equal(g.xi.numpy(), ro.initial_plant_state(
        cfg, batch=(B,), device="cpu").xi.numpy())


def test_sharded_rollout_matches_single_device(cfg):
    """The multi-step sharded rollout reproduces the unsharded one; its
    per-step statistics match the single-device means."""
    B, steps = 16, 20
    mesh = _mesh()
    s0 = _kicked(cfg, B, seed=2)
    final_sh, stats = pmesh.sharded_rollout(cfg, mesh, steps)(
        pmesh.shard_leading(s0, mesh), 0.0)
    final_1, metrics = ro.batched_rollout(cfg, s0, steps)
    np.testing.assert_allclose(final_sh.gather().xi.numpy(),
                               final_1.xi.numpy(), atol=1e-4)
    np.testing.assert_allclose(stats["mean_height"].numpy(),
                               metrics["height"].mean(0).numpy(), atol=1e-5)
    assert stats["mean_height"].shape == (steps,)
    assert stats["best_scenario"].shape == (steps,)


def test_shard_map_rollout_matches(cfg):
    B, steps = 8, 10
    mesh = _mesh()
    s0 = ro.initial_plant_state(cfg, batch=(B,), device="cpu")
    final, stats = pmesh.shard_map_rollout(cfg, mesh, steps)(
        pmesh.shard_leading(s0, mesh), 0.0)
    final_1, metrics = ro.batched_rollout(cfg, s0, steps)
    np.testing.assert_allclose(final.gather().xi.numpy(),
                               final_1.xi.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(stats["mean_height"][-1]),
                               float(metrics["height"][:, -1].mean()),
                               rtol=1e-5)


# ---- against the JAX package -----------------------------------------------

def _metrics(h, res, grf):
    return {"height": h, "qp_residual": res, "grf": grf}


@pytest.mark.parametrize("tie", [False, True])
def test_scenario_stats_match_jax(tie):
    """The port's scenario_stats and its reduction over 4 shards of 4
    against JAX's scenario_stats on the same numpy metrics. With ``tie``
    the heights are symmetric about an exactly representable mean 0.625,
    and scenarios 3 and 4 (the last of shard 0 and the first of shard 1)
    are equally near it: both pick 3, the first, as jnp.argmin does."""
    rng = np.random.default_rng(5)
    B = 16
    if tie:
        half = np.array([0.25, 0.1875, 0.125, 0.0625, 0.3125, 0.375, 0.4375,
                         0.5])
        dev = np.concatenate([-half, half])
        order = [0, 1, 2, 3, 11, 5, 6, 7, 8, 9, 10, 4, 12, 13, 14, 15]
        h = (0.625 + dev[order]).astype(np.float32)
        assert h.mean() == 0.625
    else:
        h = (0.65 + 0.01 * rng.standard_normal(B)).astype(np.float32)
    res = np.abs(rng.standard_normal(B)).astype(np.float32)
    grf = rng.standard_normal((B, 6)).astype(np.float32)

    want = {k: np.asarray(v) for k, v in
            jmesh.scenario_stats(_metrics(h, res, grf)).items()}
    got = pmesh.scenario_stats(_metrics(*map(torch.from_numpy,
                                             (h, res, grf))))
    mesh = pmesh.make_mesh(["cpu"] * 4)
    parts = [_metrics(*(torch.from_numpy(a[i:i + 4]) for a in (h, res, grf)))
             for i in range(0, B, 4)]
    red = pmesh._reduce_stats(parts, (0, 4, 8, 12), mesh, full=True)
    # one shard: scenario_stats' own arithmetic, bit for bit
    one = pmesh._reduce_stats([_metrics(*map(torch.from_numpy,
                                             (h, res, grf)))], (0,),
                              pmesh.make_mesh(["cpu"]), full=True)
    for k, v in got.items():
        assert torch.equal(one[k], v), k
    if tie:
        assert int(want["best_scenario"]) == 3
    for out in (got, red):
        assert set(out) == set(want)
        assert int(out["best_scenario"]) == int(want["best_scenario"])
        for k in ("mean_height", "max_qp_residual", "grf_mean_fz"):
            np.testing.assert_allclose(out[k].numpy(), want[k], rtol=1e-6,
                                       err_msg=k)


def test_sharded_rollout_matches_jax_f64():
    """The port's sharded rollout (4 CPU shards) against JAX's
    batched_rollout of the same numpy-seeded states in float64: every
    field of the final state and the per-step mean height within 1e-8."""
    jcfg, tcfg = JCfg.walking(), ControllerConfig.walking()
    B, steps = 8, 12
    sj = jro.initial_plant_state(jcfg, batch=(B,), dtype=jnp.float64)
    xi = np.asarray(sj.xi).copy()
    xi[:, 9] += 0.05 * np.random.default_rng(9).standard_normal(B)
    sj = sj.replace(xi=jnp.asarray(xi))
    fj, mj = jax.jit(lambda s: jro.batched_rollout(jcfg, s, steps))(sj)
    st = convert.plant_state_from_numpy(
        {k: np.asarray(getattr(sj, k)) for k in FIELDS}, dtype=torch.float64,
        device="cpu")
    mesh = pmesh.make_mesh(["cpu"] * 4)
    final, stats = pmesh.sharded_rollout(tcfg, mesh, steps)(st, 0.0)
    ft = final.gather()
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ft, f).numpy(),
                                   np.asarray(getattr(fj, f)), atol=1e-8,
                                   rtol=0, err_msg=f)
    np.testing.assert_allclose(stats["mean_height"].numpy(),
                               np.asarray(mj["height"]).mean(0), atol=1e-8,
                               rtol=0)


def test_entry_matches_jax():
    """The single-scenario forward step of ``entry`` against JAX's on the
    same state, three ticks in float32: 1e-4 absolute and relative (the
    warm ADMM iterates are forces of ~100 N)."""
    fj, (sj, itj) = jentry.entry()
    ft, (st, itt) = tentry.entry(device="cpu")
    np.testing.assert_array_equal(st.xi.numpy(), np.asarray(sj.xi))
    for _ in range(3):
        sj, mj = jax.jit(fj)(sj, itj)
        st, mt = ft(st, itt)
        itj, itt = itj + 1, itt + 1
    for f in FIELDS:
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(sj, f)), atol=1e-4,
                                   rtol=1e-4, err_msg=f)
    assert st.xi.shape == (13,) and mt["height"].shape == ()


def test_dryrun_multichip_cpu_shards():
    tentry.dryrun_multichip(2, device="cpu")


# ---- the mesh's own contract ------------------------------------------------

def test_make_mesh_needs_a_card_or_a_cpu_request():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in pmesh.make_mesh().devices)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()
    with pytest.raises(ValueError, match="neither"):
        pmesh.make_mesh(["meta"])


def test_shard_leading_and_replicate(cfg):
    mesh = _mesh(4)
    s0 = ro.initial_plant_state(cfg, batch=(6,), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        pmesh.shard_leading(s0, mesh)
    s8 = ro.initial_plant_state(cfg, batch=(8,), device="cpu")
    sh = pmesh.shard_leading(s8, mesh)
    assert pmesh.shard_leading(sh, mesh) is sh
    assert [p.xi.shape[0] for p in sh.parts] == [2] * 4
    rep = pmesh.replicate(s8, mesh)
    assert rep.spec == () and len(rep.parts) == 4
    for p in rep.parts:
        np.testing.assert_array_equal(p.xi.numpy(), s8.xi.numpy())
    np.testing.assert_array_equal(rep.gather().q.numpy(), s8.q.numpy())
    with pytest.raises(ValueError, match="scalar"):
        pmesh.sharded_batch_step(cfg, mesh)(sh, torch.zeros(8))


def test_kernel_launch_runs_under_its_tensors_device(monkeypatch):
    """``_build.Kernel.launch`` makes the tensors' card current for the
    library call and passes that card's current stream (recorded through
    stand-ins for the CUDA calls: this machine may have no card)."""
    seen = []
    current = {"dev": 0}

    class FakeDevice:
        def __init__(self, device):
            self.idx = torch.device(device).index

        def __enter__(self):
            self.prev, current["dev"] = current["dev"], self.idx

        def __exit__(self, *exc):
            current["dev"] = self.prev

    def stream(device):
        return types.SimpleNamespace(cuda_stream=1000 + device.index)

    def entry_point(params, *args):
        seen.append((current["dev"], args[-1]))
        return 0

    class Lib:
        def sizer(self):
            return 4

        def __getattr__(self, name):
            return entry_point

    lib = Lib()
    monkeypatch.setattr(_build, "build_library", lambda: {"lib": lib})
    monkeypatch.setattr(_build.Kernel, "_fn", lambda self: (entry_point, lib))
    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    kern = _build.Kernel.__new__(_build.Kernel)
    kern.name, kern.n_ptr, kern.params_sizer, kern.launches = \
        "probe", 1, "sizer", 0
    import ctypes

    class P(ctypes.Structure):
        _fields_ = [("x", ctypes.c_float)]

    kern.launch(P(), [0], 1, torch.device("cuda", 1))
    assert seen == [(1, 1001)] and current["dev"] == 0
    assert kern.launches == 1
