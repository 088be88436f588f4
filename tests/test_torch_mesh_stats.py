"""The mesh benchmark's reference for the cross-scenario statistics
(portbench/reference/stats.py, plain torch in float64) against the port's
scenario mesh on the CPU: B = 64 walking scenarios with staggered starts
at horizon 8, 4 CPU shards, 10 steps, held at the limits of the
benchmark's mix (portbench/mixes/mesh.solve.json). A reduction that
leaves out one shard's rows, and the mesh's arithmetic in float16, fail
them; the reference loads neither JAX nor the port.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.parallel import mesh as pmesh
from portbench.reference import stats as rstats

ROOT = Path(__file__).resolve().parent.parent
LIMITS = json.loads((ROOT / "portbench" / "mixes"
                     / "mesh.solve.json").read_text())["limits"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    """The mesh's statistics and every scenario's metrics of one 10-step
    rollout."""
    base = ControllerConfig.walking()
    cfg = dataclasses.replace(base, srbd=dataclasses.replace(base.srbd,
                                                             horizon=8))
    B = 64
    gen = torch.Generator().manual_seed(19)
    s0 = ro.initial_plant_state(cfg, batch=(B,), device="cpu")
    xi = s0.xi.clone()
    xi[:, 9] += 0.05 * torch.randn(B, generator=gen)
    start = torch.randint(0, 600, (B,), generator=gen).to(torch.float32)
    _, stats, m = pmesh.sharded_rollout(
        cfg, pmesh.make_mesh(["cpu"] * 4), 10, return_metrics=True)(
        s0.replace(xi=xi), start)
    return stats, m.gather()


def _fails(gaps: dict) -> bool:
    return (gaps["max_qp_residual"] > 0.0
            or any(gaps[k] > LIMITS["stats_gap"] for k in
                   ("mean_height", "grf_mean_fz", "best_scenario")))


def test_mesh_statistics_meet_the_reference(run):
    stats, m = run
    g = rstats.gaps(stats, m["height"], m["qp_residual"], m["grf"])
    assert set(g) == {"mean_height", "grf_mean_fz", "max_qp_residual",
                      "best_scenario"}
    assert g["max_qp_residual"] == 0.0
    for k in ("mean_height", "grf_mean_fz", "best_scenario"):
        assert g[k] <= LIMITS["stats_gap"], (k, g[k])
    assert not _fails(g)
    ref = rstats.statistics(m["height"], m["qp_residual"], m["grf"])
    assert all(v.dtype == torch.float64 and v.shape == (10,)
               for v in ref.values())


def test_a_reduction_without_a_shard_fails(run):
    """The statistics of 48 of the 64 rows (a rank's block left out) miss
    the limits by ten times at least."""
    _, m = run
    part = {k: v[:48] for k, v in m.items()}
    g = rstats.gaps(pmesh.scenario_stats(part), m["height"],
                    m["qp_residual"], m["grf"])
    assert _fails(g)
    assert g["grf_mean_fz"] > 10 * LIMITS["stats_gap"]


def test_float16_statistics_fail(run):
    """The mesh's arithmetic in float16 (the mesh cell's control run) fails."""
    _, m = run
    half = {k: m[k].half() for k in ("height", "qp_residual", "grf")}
    g = rstats.gaps(pmesh.scenario_stats(half), m["height"],
                    m["qp_residual"], m["grf"])
    assert _fails(g)
    assert g["mean_height"] > 10 * LIMITS["stats_gap"]


def test_gaps_of_non_finite_or_wrong_picks_are_infinite(run):
    stats, m = run
    bad = dict(stats, mean_height=stats["mean_height"] * float("nan"))
    assert rstats.gaps(bad, m["height"], m["qp_residual"],
                       m["grf"])["mean_height"] == float("inf")
    off = dict(stats, best_scenario=torch.full_like(stats["best_scenario"],
                                                    64))
    assert rstats.gaps(off, m["height"], m["qp_residual"],
                       m["grf"])["best_scenario"] == float("inf")


def test_the_reference_loads_neither_jax_nor_the_port():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import portbench.reference.stats\n"
         "print('\\n'.join(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-2000:]
    mods = out.stdout.split()
    assert "portbench.reference.stats" in mods
    bad = [m for m in mods if m.split(".", 1)[0] in
           ("jax", "jaxlib", "chex", "flax", "mpc_limx_control_tpu",
            "mpc_limx_control_tpu_torch")]
    assert bad == []
