"""The port's examples and tools through their ``main`` on the CPU at a
tiny size (``--device cpu``, B = 2, a few dozen ticks): each writes what it
says it writes, and each refuses to run without a card unless asked for
the CPU. ``run_soak_torch`` pins the two faults of the JAX example as
fixed: a kill between chunks (or between a checkpoint and its rows) and a
``--resume`` leave each window's row exactly once, and ``--windows 25
--checkpoint-every 10`` runs exactly 25 windows.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = {"run_walking": "examples/run_walking_torch.py",
           "run_soak": "examples/run_soak_torch.py",
           "scaling_sweep": "examples/scaling_sweep_torch.py",
           "visualize_robot": "examples/visualize_robot_torch.py",
           "verify_fused_sharded": "tools/verify_fused_sharded_torch.py",
           "soak": "tools/soak_torch.py",
           "distributed_rollout": "tools/distributed_rollout_torch.py"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_torch_script",
                                                  ROOT / SCRIPTS[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_refuses_without_a_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        _load(name).main(["--out", str(tmp_path / "out")])


@pytest.mark.parametrize("mode,estimator", [("walk", "truth"),
                                            ("walk", "kf"),
                                            ("stand", "truth")])
def test_run_walking(tmp_path, mode, estimator):
    s = _load("run_walking").main(
        ["--device", "cpu", "--batch", "2", "--steps", "60", "--mode", mode,
         "--estimator", estimator, "--out", str(tmp_path)])
    rows = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [0, 50]
    assert set(rows[0]) == {"step", "mean_height", "mean_vx",
                            "max_qp_residual"}
    # the plot where matplotlib imports
    assert (tmp_path / "walking.png").exists() == (
        importlib.util.find_spec("matplotlib") is not None)
    assert s["finite"] and s["height_min"] > 0.6


def _soak_rows(out: Path):
    return [json.loads(ln) for ln in open(out / "stats_truth.jsonl")]


SOAK = ["--device", "cpu", "--batch", "2", "--window", "4"]


def test_run_soak_runs_exactly_the_windows_asked(tmp_path):
    s = _load("run_soak").main(SOAK + ["--windows", "25",
                                       "--checkpoint-every", "10",
                                       "--out", str(tmp_path)])
    assert [r["window"] for r in _soak_rows(tmp_path)] == list(range(25))
    assert s["windows"] == 25 and s["nonfinite_ticks"] == 0


@pytest.mark.parametrize("kill", ["between_chunks", "before_rows"])
def test_run_soak_resume_keeps_each_window_once(tmp_path, monkeypatch,
                                                kill):
    """A run killed after its first chunk of 2 windows -- between two
    chunks, or after the checkpoint and before the chunk's rows reach the
    JSONL -- then resumed: windows 0..4 each once, and the same rows as an
    uninterrupted run."""
    mod = _load("run_soak")
    args = SOAK + ["--windows", "5", "--checkpoint-every", "2"]
    calls = {"soak": 0, "rows": 0}

    class Killed(Exception):
        pass

    soak, write = mod.ro.soak_rollout, mod._write_rows

    def soak_once(*a, **kw):
        calls["soak"] += 1
        if kill == "between_chunks" and calls["soak"] == 2:
            raise Killed
        return soak(*a, **kw)

    def write_once(*a, **kw):
        calls["rows"] += 1
        if kill == "before_rows" and calls["rows"] == 1:
            raise Killed
        return write(*a, **kw)

    monkeypatch.setattr(mod.ro, "soak_rollout", soak_once)
    monkeypatch.setattr(mod, "_write_rows", write_once)
    with pytest.raises(Killed):
        mod.main(args + ["--out", str(tmp_path / "a")])
    monkeypatch.setattr(mod.ro, "soak_rollout", soak)
    monkeypatch.setattr(mod, "_write_rows", write)
    s = mod.main(args + ["--resume", "--out", str(tmp_path / "a")])
    rows = _soak_rows(tmp_path / "a")
    assert [r["window"] for r in rows] == list(range(5))
    assert s["windows"] == 5
    mod.main(args + ["--out", str(tmp_path / "b")])
    assert rows == _soak_rows(tmp_path / "b")


@pytest.mark.parametrize("rollout_steps", [0, 3])
def test_scaling_sweep(tmp_path, rollout_steps):
    out = tmp_path / "sweep.json"
    res = _load("scaling_sweep").main(
        ["--device", "cpu", "--devices", "2", "--batch-per-device", "2",
         "--iters", "2", "--rollout-steps", str(rollout_steps),
         "--out", str(out)])
    got = json.loads(out.read_text())
    assert got == json.loads(json.dumps(res))
    assert got["mode"] == ("rollout" if rollout_steps else "per-step")
    assert [r["devices"] for r in got["results"]] == [1, 2]
    assert [r["batch"] for r in got["results"]] == [2, 4]
    assert all(r["solves_per_s"] > 0 and abs(r["mean_height"] - 0.65) < 0.01
               for r in got["results"])
    assert set(got["weak_scaling_efficiency"]) == {"2"}


def test_verify_fused_sharded(tmp_path):
    out = tmp_path / "v.json"
    res = _load("verify_fused_sharded").main(
        ["--device", "cpu", "--batch", "4", "--steps", "3",
         "--shards-per-device", "2", "--out", str(out)])
    got = json.loads(out.read_text())
    assert got["ok"] and res["ok"] and got["mesh_devices"] == ["cpu"] * 2
    for est in ("truth", "kf"):
        for style in ("gspmd", "shard_map"):
            err = got[est][style]["max_abs_err_vs_unsharded"]
            assert max(err.values()) <= 1e-4
        assert set(got[est]["wall_s"]) == {"unsharded", "gspmd", "shard_map"}


def test_soak_tool(tmp_path):
    out = tmp_path / "soak.json"
    rc = _load("soak").main(["--device", "cpu", "--batch", "2", "--windows",
                             "3", "--window", "20", "--out", str(out)])
    got = json.loads(out.read_text())
    assert rc == (0 if got["ok"] else 1)
    for name in ("walking_truth", "walking_dtmpc", "walking_kf"):
        s = got[name]
        assert s["ticks"] == 60 and s["nonfinite_ticks"] == 0
        assert s["height_min"] > 0.6 and isinstance(s["ok"], bool)
    assert "kf_cov_pos_max_tail" in got["walking_kf"]


def test_visualize_robot(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "robot.png"
    mod = _load("visualize_robot")
    assert mod.main(["--device", "cpu", "--seed", "1",
                     "--out", str(out)]) == str(out)
    assert out.stat().st_size > 0
    # the chain ends at the port's forward kinematics of each leg
    from mpc_limx_control_tpu_torch.core.config import LegOffsets
    from mpc_limx_control_tpu_torch.models import kinematics as kin
    q = torch.tensor([0.1, -0.3, 0.5, -0.2, 0.4, -0.6], dtype=torch.float64)
    pl, pr = kin.full_fk(LegOffsets(), q)
    np.testing.assert_allclose(
        mod.chain_points(LegOffsets(), q[:3], "left")[-1], pl.numpy())
    np.testing.assert_allclose(
        mod.chain_points(LegOffsets(), q[3:], "right")[-1], pr.numpy())
