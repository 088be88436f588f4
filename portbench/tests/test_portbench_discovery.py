"""A configuration, a traffic mix and a per-layer metric added as new files
(and a cell naming them in BENCHMARK.json) are found and run with no edit
to a file that is there."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}

    pb = tmp_path / "portbench"
    spec = json.loads((pb / "configs" / "walking.json").read_text())
    spec.update(name="walking_fast", overrides={"desired_velocity":
                                                [0.8, 0.0, 0.0]})
    (pb / "configs" / "walking_fast.json").write_text(json.dumps(spec))
    mix = json.loads((pb / "mixes" / "batched.solve.json").read_text())
    mix.update(batch=4, chunk=5, trace_chunks=1)
    (pb / "mixes" / "batched.tiny.json").write_text(json.dumps(mix))
    (pb / "metrics" / "host_ops_per_tick.batch.py").write_text(
        "def read(record):\n"
        "    t = record.get('ticks')\n"
        "    return len(record['host']) / t if t else None\n")
    manifest["configs"].append(dict(manifest["configs"][0],
                                    name="walking_fast",
                                    file="portbench/configs/walking_fast.json"))
    manifest["workloads"].append({"name": "walkfast.b4.tiny",
                                  "config": "walking_fast",
                                  "traffic": "batched.tiny", "chips": 1,
                                  "why": "a cell added as data"})
    for m in manifest["end_to_end"]:
        if m["name"] == "scenario_ticks_per_s":
            m["workloads"].append("walkfast.b4.tiny")
    manifest["per_layer"].append({"name": "host_ops_per_tick.batch",
                                  "unit": "ops/tick", "better": "lower",
                                  "source": "device_trace",
                                  "layer": "control.rollout",
                                  "moves": "scenario_ticks_per_s",
                                  "workloads": ["walkfast.b4.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    loader = importlib.util.spec_from_file_location(
        "portbench_run_copy", pb / "run.py")
    run = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(run)
    assert run.HERE == pb
    cell = run.cell_of(run.load_json(tmp_path / "BENCHMARK.json"),
                       "walkfast.b4.tiny")
    assert [m["name"] for m in cell["per_layer"]] == \
        ["host_ops_per_tick.batch"]
    assert [m["name"] for m in cell["end_to_end"]] == \
        ["scenario_ticks_per_s", "setup_s"]
    cfg = run.load_json(tmp_path / cell["config"]["file"])
    mix = run.load_json(pb / "mixes" / f"{cell['cell']['traffic']}.json")
    driver = run.load_module("drivers", mix["driver"])
    c = driver.Cell(cfg, mix, 2 ** 33 + 5, "cpu", trace=True)
    c.setup()
    assert c.pcfg.desired_velocity == (0.8, 0.0, 0.0)
    out = c.window(0.2)
    assert out["metrics"]["scenario_ticks_per_s"] > 0
    record = c.record()
    value = run.load_module("metrics",
                            "host_ops_per_tick.batch").read(record)
    assert value is not None and value > 0
    c.release()
    c.close()
    after = {p: p.read_bytes() for p in before}
    assert after == before
