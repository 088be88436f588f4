"""The comparison that decides ``correct`` fails its control and the faults
a cell can have, at a size a test run holds, on the CPU.

The harness's look for a card is skipped: the drivers run on CPU tensors,
where the port's tick is its plain composition; the program's walking QP
is given the kernels' exact triangular solves ("subst"), the plain twin
of what the card runs. A sound run passes the comparison; the reference
in TF32 put in the program's place fails it (the control), and so does
each fault planted under the timed path: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced. The session's robot is the benchmark's plant stepped in
process.
"""

import functools
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.drivers import session as sesdrv  # noqa: E402
from portbench.plant import wire_plant  # noqa: E402

SEED = 2 ** 31 + 12345
GAPS = ("force_gap", "residual_gap", "state_gap", "cmd_gap")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def subst(monkeypatch):
    """The port's CPU tick with the kernels' solve form."""
    from mpc_limx_control_tpu_torch.control import rollout as ro
    from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as fqp

    monkeypatch.setattr(ro, "plant_step", functools.partial(
        ro._plant_step_ref, solve_form="subst"))
    make = fqp.make_walking_fused
    monkeypatch.setattr(fqp, "make_walking_fused",
                        lambda cfg, solve_form=None: make(
                            cfg, solve_form or "subst"))


def _cell(config, traffic, **mix_over):
    """A configuration and a mix by name (a cell of BENCHMARK.json, or the
    dtMPC mix kept for a later cell)."""
    cfg = run.load_json(ROOT / "portbench" / "configs" / f"{config}.json")
    mix = run.load_json(ROOT / "portbench" / "mixes" / f"{traffic}.json")
    mix.update(mix_over)
    return run.load_module("drivers", mix["driver"]), cfg, mix


def _gap_checks(checks):
    return {c["name"]: c["ok"] for c in checks
            if c["name"].split(".")[0] in GAPS}


# ---- batched cells -----------------------------------------------------

def _batched(config, traffic, fault=None, control=None, **mix_over):
    drv, cfg, mix = _cell(config, traffic, batch=16, chunk=10, **mix_over)
    c = drv.Cell(cfg, mix, SEED, "cpu")
    from mpc_limx_control_tpu_torch.control import rollout as ro

    def step(pcfg, state, steps, start_iteration, mpc_every):
        if fault == "unchanged":
            _, m = ro.batched_rollout(pcfg, state, steps, start_iteration,
                                      mpc_every)
            return state, m
        if fault == "half_batch":
            h = state.xi.shape[0] // 2
            half = ro._map_state(state, lambda x: x[:h])
            s, m = ro.batched_rollout(pcfg, half, steps, start_iteration[:h],
                                      mpc_every)
            # the rest left out: its answers are the first half's
            s = ro._map_state(s, lambda x: torch.cat([x, x], 0))
            return s, {k: torch.cat([v, v], 0) for k, v in m.items()}
        s, m = ro.batched_rollout(pcfg, state, steps, start_iteration,
                                  mpc_every)
        if fault == "altered":
            m["grf"][0, -1, 2] *= 1.01
        return s, m

    c.program_step = step
    c.setup()
    c.window(0.2)
    c.release()
    checks = c.check(control=control)
    c.close()
    return _gap_checks(checks)


@pytest.mark.parametrize("config,traffic", [
    ("walking", "batched.solve"), ("standing", "batched.stand_kick"),
    ("walking", "batched.dtmpc")])
def test_batched_sound_run_passes_and_the_control_fails(subst, config,
                                                        traffic):
    assert all(_batched(config, traffic).values())
    assert not all(_batched(config, traffic, control="tf32").values())


def test_episodes_start_afresh_and_pass(subst):
    """Standing episodes of two chunks: the window starts the batch from
    fresh seeded starts, and the check follows whichever state the last
    chunk was handed."""
    assert all(_batched("standing", "batched.stand_kick",
                        episode_ticks=20).values())


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_batched_faults_fail(subst, fault):
    assert not all(_batched("walking", "batched.solve",
                            fault=fault).values())


# ---- the session -------------------------------------------------------

class LoopLink:
    """The plant stepped in process: ``send_cmd`` steps it, ``recv_*``
    hand out what it published since the last read."""

    def __init__(self, plant_host, plant):
        self.h, self.plant = plant_host, plant

    def recv_state(self):
        s, self.h.state = self.h.state, None
        return s

    def recv_imu(self):
        return None

    def recv_odom(self):
        o, self.h.odom = self.h.odom, None
        return o

    def recv_diag(self):
        return None

    def send_cmd(self, q, dq=None, tau=None, kp=None, kd=None, mode=None,
                 stamp_ns=0):
        self.plant.apply({"q": q, "tau": tau, "kp": kp}, time.monotonic_ns)

    def send_est_odom(self, *a, **k):
        pass

    def close(self):
        pass


class Host:
    state = odom = None
    drop_odom = ()      # ticks whose odometry datagram is late
    ticks = 0

    def publish_state(self, q, dq=None, quat=None, acc=None, gyro=None,
                      stamp_ns=0):
        self.state = {"stamp_ns": stamp_ns, "q": np.array(q, np.float32),
                      "dq": np.array(dq, np.float32),
                      "tau": np.zeros(6, np.float32)}

    def publish_odom(self, pos, quat, v_pos, v_ori, stamp_ns=0):
        self.ticks += 1
        if self.ticks in self.drop_odom:
            return
        self.odom = {"stamp_ns": stamp_ns,
                     **{k: np.array(v, np.float32) for k, v in
                        (("pos", pos), ("quat", quat), ("v_pos", v_pos),
                         ("v_ori", v_ori))}}


class LoopCell(sesdrv.Cell):
    drop_odom = ()

    def start_plant(self, state_port, cmd_port):
        self.host = Host()
        self.host.drop_odom = self.drop_odom
        self.loop = wire_plant.Plant(self.host, self.rcfg, self.seed,
                                     self.mix["perturb"])
        self.loop.publish(time.monotonic_ns)

    def link_for(self, session):
        return LoopLink(self.host, self.loop)

    def stop_plant(self):
        return {"xi": [float(v) for v in self.loop.xi],
                "steps": self.loop.steps}


def _session(fault=None, control=None, drop_odom=()):
    _, cfg, mix = _cell("walking", "session.sync", chunk=40, hz=5000.0)
    c = LoopCell(cfg, mix, SEED, "cpu")
    c.drop_odom = drop_odom
    c.setup()
    s = c.session
    if fault == "unchanged":
        warm = s._fns["warm"]

        def frozen():
            z, y = s._z.clone(), s._y.clone()
            warm()
            s._z.copy_(z)
            s._y.copy_(y)
        s._fns["warm"] = frozen
    elif fault == "altered":
        fetch = s._fetch
        n = [0]

        def altered(packed, pub):
            p = fetch(packed, pub).copy()
            n[0] += 1
            if n[0] % 40 == 17:
                p[12:18] *= 1.01
            return p
        s._fetch = altered
    c.window(0.2)
    c.release()
    checks = c.check(control=control)
    c.close()
    return _gap_checks(checks)


def test_session_sound_run_passes_and_the_control_fails(subst):
    assert all(_session().values())
    assert not all(_session(control="tf32").values())


def test_session_replays_a_late_odometry_datagram(subst):
    """A tick whose odometry datagram has not arrived runs on the last one
    the session received, also at the first tick of a run() call."""
    # publish 1 is the plant's first state; chunk k starts at tick 40 k,
    # whose state is publish 40 k + 1
    late = tuple(40 * k + 1 for k in range(1, 60)) + (7, 95)
    assert all(_session(drop_odom=late).values())


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_session_faults_fail(subst, fault):
    assert not all(_session(fault=fault).values())


def test_the_limits_sit_in_the_mixes():
    for name in ("batched.solve", "batched.stand_kick", "batched.dtmpc",
                 "session.sync"):
        mix = json.loads((ROOT / "portbench" / "mixes"
                          / f"{name}.json").read_text())
        assert mix["limits"] and all(v > 0 for v in mix["limits"].values())
