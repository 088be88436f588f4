"""The mesh driver end to end on the CPU: four ranks over gloo (rank 0 in
this process, ranks 1-3 started by drivers/mesh.py), 4 scenarios a rank at
full width, 5-tick chunks. The comparison passes, the ranks' mesh logs
reach rank 0, and a program whose mesh takes one start for all scenarios
fails at set-up before any rank starts."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402

SEED = 2 ** 31 + 777


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(**over):
    cfg = run.load_json(ROOT / "portbench" / "configs" / "walking_mesh4.json")
    mix = run.load_json(ROOT / "portbench" / "mixes" / "mesh.solve.json")
    mix.update(batch=16, chunk=5, check_sample=2, **over)
    return run.load_module("drivers", "mesh").Cell(cfg, mix, SEED, "cpu",
                                                   trace=False)


def test_four_cpu_ranks_pass_the_comparison():
    c = _cell()
    try:
        c.setup()
        out = c.window(0.5)
        record = c.record()
        c.release()
        checks = c.check()
    finally:
        c.close()
    assert out["attempted"] == 16 and out["failed"] == 0
    assert out["metrics"]["scenario_ticks_per_s"] > 0
    got = {ch["name"]: ch for ch in checks}
    for tag in ("start", "last"):
        for name in ("force_gap", "residual_gap", "state_gap",
                     "mean_height_gap", "grf_mean_fz_gap",
                     "max_qp_residual_gap", "best_scenario_gap"):
            assert got[f"{name}.{tag}"]["ok"], got[f"{name}.{tag}"]
    ranks = record["mesh_ranks"]
    assert len(ranks) == 4
    for r in ranks:
        n = len(r["profiled"])
        assert n >= 1 and not any(r["profiled"])
        assert len(r["rollout_ms"]) == len(r["reduce_ms"]) == n
    assert len({len(r["profiled"]) for r in ranks}) == 1
    assert all(p.poll() == 0 for p in c.procs)


def test_a_mesh_without_per_scenario_starts_fails_before_the_ranks(
        monkeypatch):
    from mpc_limx_control_tpu_torch.parallel import mesh as pmesh

    def scalar_only(*a, **k):
        def run_(state, start):
            if isinstance(start, torch.Tensor) and start.numel() != 1:
                raise ValueError("start_iteration is replicated over the "
                                 "mesh: a scalar")
        return run_

    monkeypatch.setattr(pmesh, "sharded_rollout", scalar_only)
    c = _cell()
    try:
        with pytest.raises(ValueError, match="scalar"):
            c.setup()
    finally:
        c.close()
    assert c.procs == []
