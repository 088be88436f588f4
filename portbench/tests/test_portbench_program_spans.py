"""The per-layer metrics that read the port's tick log
(utils/profiling.TickLog), on synthetic logs: only the window's ticks
before the profiler first ran count (set-up's run() call, the profiled
ticks and the ticks after them are left out), the answer is None without
a log, and the arithmetic."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from mpc_limx_control_tpu_torch.utils import profiling as prof  # noqa: E402

PHASE_METRICS = {"tick_fill_p50_ms.session": ("fill",),
                 "tick_launch_p50_ms.session": ("launch",),
                 "tick_wait_p50_ms.session": ("wait",),
                 "tick_wire_p50_ms.session": ("wire_in", "wire_out")}
GRAPH_METRICS = {"hold_graph_device_p50_ms": "hold",
                 "solve_graph_device_p50_ms": "warm"}
RECORD = {"window": (0.0, 1.0), "device": [], "host": [], "spans": []}


def metric(name):
    return run.load_module("metrics", name).read


@pytest.fixture
def no_other_logs(monkeypatch):
    """Only the logs a test makes are in the registry."""
    monkeypatch.setattr(prof, "_TICK_LOGS", type(prof._TICK_LOGS)())


def _fill(log, run_ticks, seed):
    """Log ticks whose phases (us) are drawn from the seed: `run_ticks`
    is [(ticks, profiled)] a run() call. Returns what each tick wrote:
    [(run, profiled, kind, phases_ns, {graph: ms})]."""
    rng = np.random.default_rng(seed)
    clock = [10 ** 9]
    out = []

    def fake():
        return clock[0]

    real = prof._clock
    prof._clock = fake
    try:
        for r, (ticks, profiled) in enumerate(run_ticks):
            if profiled:
                prof._autograd_profiler._is_profiler_enabled = True
            try:
                with log.running():
                    for t in range(ticks):
                        phases = rng.integers(1_000, 500_000, 7)
                        kind = prof.SOLVE if t % 5 == 0 else prof.HOLD
                        ms = {"warm" if kind == prof.SOLVE else "hold":
                              float(rng.uniform(0.1, 0.9))}
                        clock[0] += int(phases[prof.POLL])
                        for k in range(prof.WIRE_IN, prof.SLEEP + 1):
                            log.mark(k)
                            clock[0] += int(phases[k])
                        log.device(*ms.values())
                        log.end(kind, False)
                        out.append((r, profiled, kind, phases, ms))
            finally:
                prof._autograd_profiler._is_profiler_enabled = False
    finally:
        prof._clock = real
    return out


def _window(written):
    """What the metrics read: run() calls after the first, up to the first
    profiled tick."""
    out = []
    for w in written:
        if w[1]:
            break
        if w[0] >= 1:
            out.append(w)
    return out


@pytest.mark.parametrize("seed", [1, 2 ** 33 + 7])
def test_metrics_read_the_window_outside_the_profiler(no_other_logs, seed):
    log = prof.TickLog()
    written = _fill(log, [(40, False), (30, False), (25, False), (20, True),
                          (31, False)], seed)
    win = _window(written)
    assert len(win) == 55 and {w[0] for w in win} == {1, 2}
    for name, phases in PHASE_METRICS.items():
        want = np.median([sum(int(p[prof.PHASES.index(x)]) for x in phases)
                          * 1e-6 for _, _, _, p, _ in win])
        assert metric(name)(RECORD) == pytest.approx(want, rel=1e-12), name
    for name, graph in GRAPH_METRICS.items():
        want = np.median([np.float32(ms[graph]) for *_, ms in win
                          if graph in ms])
        assert metric(name)(RECORD) == pytest.approx(float(want),
                                                     rel=1e-6), name
    # the set-up call's ticks, the profiled ones and those after them
    # would move every median: they are not read
    for more in ([w for w in written if w[0] >= 1 and not w[1]], written):
        other = np.median([int(p[prof.PHASES.index("fill")]) * 1e-6
                           for *_, p, _ in more])
        assert metric("tick_fill_p50_ms.session")(RECORD) != other
    log.close()


def test_metrics_read_the_newest_open_log(no_other_logs):
    old = prof.TickLog()
    _fill(old, [(5, False), (5, False)], 3)
    new = prof.TickLog()
    written = _fill(new, [(5, False), (9, False)], 4)
    want = np.median([int(p[prof.PHASES.index("wait")]) * 1e-6
                      for *_, p, _ in _window(written)])
    assert metric("tick_wait_p50_ms.session")(RECORD) == pytest.approx(want)
    new.close()
    assert metric("tick_wait_p50_ms.session")(RECORD) != pytest.approx(want)
    old.close()


def test_none_without_a_log_or_its_ticks(no_other_logs, monkeypatch):
    names = list(PHASE_METRICS) + list(GRAPH_METRICS)
    # no open session
    assert all(metric(n)(RECORD) is None for n in names)
    # only set-up's call, then profiled ticks and ticks after them
    log = prof.TickLog()
    _fill(log, [(10, False), (10, True), (10, False)], 5)
    assert all(metric(n)(RECORD) is None for n in names)
    # a CPU or eager session: phases, no device times
    eager = prof.TickLog()
    calls = [3, 6]
    clock = [1]
    monkeypatch.setattr(prof, "_clock", lambda: clock[0])
    for ticks in calls:
        with eager.running():
            for _ in range(ticks):
                for k in range(prof.WIRE_IN, prof.SLEEP + 1):
                    clock[0] += 1000
                    eager.mark(k)
                clock[0] += 1000
                eager.end(prof.HOLD, False)
    assert metric("tick_fill_p50_ms.session")(RECORD) == pytest.approx(1e-3)
    assert metric("tick_wire_p50_ms.session")(RECORD) == pytest.approx(2e-3)
    assert all(metric(n)(RECORD) is None for n in GRAPH_METRICS)
    # a port with no tick log at all (the registry's function absent)
    monkeypatch.delattr(prof, "tick_logs")
    assert all(metric(n)(RECORD) is None for n in names)
    eager.close()
    log.close()
