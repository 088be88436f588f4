"""BENCHMARK.json against the benchmark's contract, and the files it names.

    python -m pytest portbench/tests -q -o addopts='' -p no:cacheprovider
"""

import dataclasses
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert (ROOT / cmd[1]).is_file()
    assert any(cmd[1].startswith(p + "/") for p in MANIFEST["paths"])
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    entries = (MANIFEST["configs"] + MANIFEST["workloads"]
               + MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in MANIFEST["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MANIFEST["per_layer"]:
        assert _line(m["layer"])
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[kind]]
        assert len(names) == len(set(names)), kind
    metric_names = [m["name"] for m in MANIFEST["end_to_end"]
                    + MANIFEST["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_bounds_and_end_to_end_sources():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def _reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_setup_another_metric_and_a_layer():
    cells = [w["name"] for w in MANIFEST["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for cell in cells:
        e2e = [m["name"] for m in MANIFEST["end_to_end"]
               if _reports(cell, m)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(cell in m.get("workloads", cells)
                   for m in MANIFEST["per_layer"]), cell


def test_every_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m["workloads"]:
            assert _reports(cell, e2e[m["moves"]]), (m["name"], cell)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])


def test_files_the_cells_name_exist():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for w in MANIFEST["workloads"]:
        cfg = configs[w["config"]]
        assert (ROOT / cfg["file"]).is_file()
        mix = json.loads((ROOT / "portbench" / "mixes"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "drivers"
                / f"{mix['driver']}.py").is_file()
    for m in MANIFEST["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("name", ["walking", "standing"])
def test_config_files_state_the_presets_as_run(name):
    """The configuration file's sizes are the port's preset, and the
    reference's frozen preset equals the port's field by field."""
    from mpc_limx_control_tpu_torch.core import config as pconfig
    from portbench.reference import config as rconfig

    spec = json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())
    entry = {c["name"]: c for c in MANIFEST["configs"]}[name]
    assert spec["source"] == entry["source"]
    assert spec["reduced"] == entry["reduced"] == []
    p = getattr(pconfig.ControllerConfig, spec["preset"])()
    r = getattr(rconfig.ControllerConfig, spec["preset"])()
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    s = spec["sizes"]
    nu = 3 if p.mode == "walk" else 6
    assert (s["mode"], s["nu"], s["N"]) == (p.mode, nu, p.srbd.horizon)
    assert s["n"] == nu * p.srbd.horizon and s["m"] == 2 * s["n"]
    assert s["admm_warm_iters"] == p.srbd.solver.admm_warm_iters
    assert (s["dt_s"], s["mpc_step"], s["ts_s"]) == (
        p.gait.dt, p.gait.mpc_step, p.srbd.ts)
    assert s["estimator_mode"] == p.estimator_mode
    assert tuple(s["desired_velocity"]) == tuple(p.desired_velocity)


def test_check_budget_fits_with_24_cells():
    rs = MANIFEST["run_seconds"]
    assert 1200 + (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 <= 43200
