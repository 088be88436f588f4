"""The four-card deployment `walking.mesh4` against its entries in
BENCHMARK.json: the file states the walking preset as run, cuts only the
deployment's scale, and states the cards, processes and batch its cell and
mix use.

    python -m pytest portbench/tests -q -o addopts='' -p no:cacheprovider
"""

import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def _spec(name):
    entry = {c["name"]: c for c in MANIFEST["configs"]}[name]
    return entry, json.loads((ROOT / entry["file"]).read_text())


def test_mesh_config_file_states_the_preset_as_run():
    """The sizes are the port's walking preset, as `walking`'s are; what
    the file cuts is the deployment's scale, named by a key of its own,
    never a width."""
    from mpc_limx_control_tpu_torch.core import config as pconfig
    from portbench.reference import config as rconfig

    entry, spec = _spec("walking.mesh4")
    assert spec["source"] == entry["source"]
    assert spec["reduced"] == entry["reduced"] == ["hosts"]
    for key in spec["reduced"]:
        assert key in spec and key not in spec["sizes"], key
        assert not key.endswith(("_dim", "_rank", "_size")), key
    p = getattr(pconfig.ControllerConfig, spec["preset"])()
    r = getattr(rconfig.ControllerConfig, spec["preset"])()
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    s = spec["sizes"]
    assert (s["mode"], s["nu"], s["N"]) == (p.mode, 3, p.srbd.horizon)
    assert s["n"] == 3 * p.srbd.horizon and s["m"] == 2 * s["n"]
    assert s["admm_warm_iters"] == p.srbd.solver.admm_warm_iters
    assert (s["dt_s"], s["mpc_step"], s["ts_s"]) == (
        p.gait.dt, p.gait.mpc_step, p.srbd.ts)
    assert s["estimator_mode"] == p.estimator_mode
    assert tuple(s["desired_velocity"]) == tuple(p.desired_velocity)
    _, walking = _spec("walking")
    assert s == walking["sizes"]


def test_the_mesh_deployment_states_its_cards_and_its_mix():
    """walking.mesh4: one host, four cards, one process a card, 16,384
    scenarios a card; its cell asks for the four cards and its mix runs
    that batch over that many processes, every tick solving."""
    _, spec = _spec("walking.mesh4")
    cell = {w["name"]: w for w in MANIFEST["workloads"]}["walk.mesh4.b65536"]
    mix = json.loads((ROOT / "portbench" / "mixes"
                      / f"{cell['traffic']}.json").read_text())
    assert (spec["hosts"], spec["cards"], spec["processes"]) == (1, 4, 4)
    assert cell["chips"] == spec["cards"] == mix["processes"]
    assert mix["batch"] == spec["batch"] == 4 * spec["scenarios_per_card"]
    assert spec["scenarios_per_card"] == 16384
    assert mix["driver"] == "mesh" and mix["mpc_every"] == 1
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    assert [w["chips"] for w in MANIFEST["workloads"]].count(4) == 1
