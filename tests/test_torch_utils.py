"""The port's profiling and checkpoint utilities (counterparts of
tests/test_utils.py:43-64), on the CPU."""

import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.utils import checkpoint as ckpt
from mpc_limx_control_tpu_torch.utils import profiling as prof


def test_checkpoint_roundtrip():
    tree = {"xi": torch.arange(12.0).reshape(3, 4),
            "q": torch.ones((3, 6), dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "state"
        ckpt.save(path, tree)
        restored = ckpt.restore(path, tree)
    for k in tree:
        assert torch.equal(restored[k], tree[k])
        assert restored[k].dtype == tree[k].dtype


def test_checkpoint_plant_state_and_template(tmp_path):
    """A PlantState with the filter and None fields round-trips into the
    template's structure and dtypes; another structure or shape is
    refused."""
    cfg = dataclasses.replace(ControllerConfig.walking(),
                              estimator_mode="kf")
    s = ro.initial_plant_state(cfg, batch=(4,), device="cpu")
    s = s.replace(xi=s.xi + 0.01)
    tree = {"state": s, "it": torch.arange(4), "none": None}
    ckpt.save(tmp_path / "soak", tree)
    like = {"state": ro.initial_plant_state(cfg, batch=(4,), device="cpu",
                                            dtype=torch.float64),
            "it": torch.zeros(4, dtype=torch.long), "none": None}
    back = ckpt.restore(tmp_path / "soak", like)
    assert isinstance(back["state"], ro.PlantState)
    assert back["state"].xi.dtype == torch.float64
    np.testing.assert_array_equal(back["state"].xi.numpy(),
                                  s.xi.double().numpy())
    assert torch.equal(back["state"].kf.p_cov.float(), s.kf.p_cov)
    assert back["state"].qp_z is not None and back["none"] is None
    assert torch.equal(back["it"], tree["it"])
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(tmp_path / "soak", {"state": s})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path / "soak", {
            "state": ro.initial_plant_state(cfg, batch=(2,), device="cpu"),
            "it": torch.zeros(4, dtype=torch.long), "none": None})


def test_measure_throughput():
    x = torch.ones((64, 8))
    stats = prof.measure_throughput(lambda a: a * 2.0, (x,), batch=64,
                                    iters=3)
    assert stats["solves_per_s"] > 0
    assert stats["p50_s"] >= 0
    assert stats["max_s"] >= stats["p50_s"]


def test_metrics_logger(tmp_path):
    p = tmp_path / "m.jsonl"
    with prof.MetricsLogger(p) as log:
        log.log(0, err=torch.tensor(0.5), vec=torch.tensor([1.0, 2.0]),
                arr=np.asarray([3.0]))
        log.log(1, err=0.25)
    lines = p.read_text().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert rec["step"] == 0 and rec["vec"] == [1.0, 2.0]
    assert rec["err"] == 0.5 and rec["arr"] == [3.0]


def test_timer_and_trace(tmp_path):
    """Timer measures its scope (CPU tensors: no card to wait for); trace
    writes a Chrome trace of the operators it saw."""
    with prof.Timer("matmul", torch.ones(2)) as t:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.elapsed > 0.0 and t.name == "matmul"
    with prof.trace(str(tmp_path / "tr")) as p:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "tr" / "trace.json").is_file()
    assert any("mm" in e.key for e in p.key_averages())
