"""The live session's tick log (``utils/profiling.TickLog``): the ring, the
phases' arithmetic, run()'s statistics from the log, the spans under a
torch profiler on the log's clock, the registry; and, on the card, each
CUDA graph's device time from the events inside its capture.

The card test needs a CUDA device and skips without one; on a CUDA machine:

    python -m pytest tests/test_torch_tick_log.py -m cuda --noconftest \\
        -o addopts='' -p no:cacheprovider -q

This file imports only torch, numpy and the port.
"""

import gc
import socket

import numpy as np
import pytest
import torch

from mpc_limx_control_tpu_torch.control import session as ses
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.utils import profiling as prof

from test_torch_session_walking import (  # noqa: F401  (a fixture)
    ScriptedLink, WirePlant, _pf_runtime_built, scripted_sensors)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Session ticks at B = 1 on the CPU: one torch thread per test worker
    (tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_ports():
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(2)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _scripted(cfg, ticks, device="cpu", seed=1):
    sp, cp = _free_ports()
    s = ses.ControlSession(cfg, state_port=sp, cmd_port=cp, device=device)
    s.link.close()
    s.link = ScriptedLink(scripted_sensors(cfg, ticks, seed=seed))
    return s


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def test_ring_wraps():
    """Past its capacity the ring keeps the newest ticks, in order, with
    each tick's kind, estimator flag and run() index."""
    log = prof.TickLog(capacity=8)
    kinds = []
    for r in range(3):
        with log.running():
            for t in range(7):
                for phase in range(prof.WIRE_IN, prof.SLEEP + 1):
                    log.mark(phase)
                kinds.append((t % 3, t % 2 == 1, r))
                log.end(t % 3, t % 2 == 1)
    log.close()
    assert log.count == 21 and log.runs == 3
    v = log.view()
    assert len(v) == 8
    assert [(int(k), bool(e), int(r)) for k, e, r in
            zip(v.kind, v.est, v.run)] == kinds[-8:]
    assert (np.diff(v.stamps, axis=1) >= 0).all()
    assert (np.diff(v.stamps[:, 0]) > 0).all()
    assert not v.profiled.any()
    assert len(log.view(first_run=2)) == 7
    assert len(log.view(first_run=2).take(v.profiled[-7:])) == 0


def test_phases_are_contiguous_and_sum_to_the_latency():
    """Each tick's phases follow one another: every stamp is at or after
    the one before, a tick's sleep ends where the next tick's poll
    begins, and wire_in + fill + launch + wait + wire_out is the tick's
    latency exactly (integer nanoseconds)."""
    cfg = ControllerConfig.walking()
    with _scripted(cfg, 12) as s:
        s.run(12, hz=1000.0)
        v = s.tick_log.view()
    assert len(v) == 12
    d = np.diff(v.stamps, axis=1)
    assert (d >= 0).all()
    assert (v.stamps[1:, 0] == v.stamps[:-1, -1]).all()
    inside = d[:, prof.WIRE_IN:prof.WIRE_OUT + 1].sum(axis=1)
    assert np.array_equal(inside, v.latency_ns())
    assert (v.latency_ns() > 0).all()
    ms = sum(v.phase_ms(p) for p in prof.PHASES)
    np.testing.assert_allclose(ms, (v.stamps[:, -1] - v.stamps[:, 0]) * 1e-6,
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", ["truth", "kf", "async"])
def test_session_kinds_and_statistics_come_from_the_log(case):
    """A CPU session against the tests' wire plant: the logged kinds match
    the counters, and every latency statistic of run() is the one
    computed from the log's stamps of that call."""
    cfg = ControllerConfig.walking()
    sp, cp = _free_ports()
    plant = WirePlant(cfg, sp, cp, publish_truth_odom=case != "kf")
    kw = {"truth": {}, "kf": {"use_kf": True},
          "async": {"async_dispatch": True}}[case]
    try:
        with ses.ControlSession(cfg, state_port=sp, cmd_port=cp,
                                device="cpu") as s:
            s.run(5, hz=1000.0, **kw)
            st = s.run(15, hz=1000.0, **kw)
            v = s.tick_log.view(first_run=1)
    finally:
        plant.close()
    assert st["sent"] == len(v) == 15 and (v.run == 1).all()
    kinds = [prof.KINDS[k] for k in v.kind]
    assert st["mpc_holds"] == kinds.count("hold")
    assert st["mpc_solves"] == kinds.count("solve") + kinds.count("cold")
    if case == "async":
        assert st["mpc_holds"] == 15
    else:
        assert st["mpc_solves"] == 3
    assert bool(v.est.all()) == (case == "kf") and bool(v.est.any()) == \
        (case == "kf")
    lat = [(b - a) * 1e-9 for a, b in
           zip(v.stamps[:, prof.WIRE_IN], v.stamps[:, prof.WIRE_OUT + 1])]
    solve = [x for x, k in zip(lat, kinds) if k != "hold"]
    hold = [x for x, k in zip(lat, kinds) if k == "hold"]
    assert st["tick_latency_p50"] == _pct(lat, 0.50)
    assert st["tick_latency_p95"] == _pct(lat, 0.95)
    assert st["tick_latency_max"] == max(lat)
    assert st["ticks_over_1ms"] == sum(x > 1e-3 for x in lat)
    assert st["hold_latency_p50"] == _pct(hold, 0.50)
    if solve:
        assert st["solve_latency_p50"] == _pct(solve, 0.50)
        assert st["solves_over_5ms"] == sum(x > 0.005 for x in solve)
    else:
        assert "solve_latency_p50" not in st
    for phase, span in zip(prof.PHASES, prof.SPANS):
        k = prof.PHASES.index(phase)
        assert st["phase_p50_ms"][span] == _pct(
            [(b - a) * 1e-6 for a, b in zip(v.stamps[:, k],
                                             v.stamps[:, k + 1])], 0.50)
    # the CPU session replays no graph: no device time
    assert "hold_graph_device_p50_ms" not in st
    assert np.isnan(v.graph_ms).all()


def test_profiler_spans_lie_on_the_log_stamps():
    """Under a torch profiler every phase is a record_function span named
    after it, and with the log's epoch offset each span's start and end
    lie within 50 us of the log's stamps; ticks run without the profiler
    emit none and are not flagged."""
    cfg = ControllerConfig.walking()
    with _scripted(cfg, 20) as s:
        s.run(5, hz=1000.0)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            s.run(10, hz=1000.0)
        s.run(5, hz=1000.0)
        v = s.tick_log.view()
        off = s.tick_log.epoch_offset_ns
    assert v.profiled.tolist() == [False] * 5 + [True] * 10 + [False] * 5
    spans = [(e.name(), e.start_ns() - off, e.start_ns() - off
              + e.duration_ns())
             for e in p.profiler.kineto_results.events()
             if e.name().startswith("session.")]
    traced = v.stamps[5:15]
    # seven phases a tick, and the next tick's poll, which run() leaves
    # when it returns
    assert len(spans) == 7 * 10 + 1
    names = [n for n, _, _ in sorted(spans, key=lambda x: x[1])]
    assert names == list(prof.SPANS) * 10 + ["session.poll"]
    for name, start, end in spans:
        k = prof.SPANS.index(name)
        if k == prof.POLL:
            # a tick's poll begins where the tick before it slept
            starts = np.concatenate([traced[:, k], traced[:, -1]])
        else:
            starts = traced[:, k]
        i = int(np.argmin(np.abs(starts - start)))
        assert abs(int(starts[i]) - start) < 50_000, (name, start)
        if i < len(traced):
            assert abs(int(traced[i, k + 1]) - end) < 50_000, (name, end)


def test_registry_drops_a_closed_sessions_log():
    """An open session's log is in the registry; closing the session, or
    dropping the last reference to a log, takes it out."""
    cfg = ControllerConfig.walking()
    s = _scripted(cfg, 4)
    log = s.tick_log
    assert log in prof.tick_logs()
    s.run(2, hz=1000.0)
    s.close()
    assert log not in prof.tick_logs()
    assert len(log.view()) == 2          # still readable after close
    other = prof.TickLog(capacity=4)
    key = id(other)
    assert key in [id(x) for x in prof.tick_logs()]
    del other
    gc.collect()
    assert key not in [id(x) for x in prof.tick_logs()]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs run only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_graph_device_time_on_the_card(cuda_device):
    """Each graph a tick replays is timed by the events inside its
    capture: more than 0 and at most the tick's latency; the hold graph's
    median agrees within 20 % with its kernels' span (first start to last
    end) in a profiler trace of other held ticks."""
    cfg = ControllerConfig.walking()
    with _scripted(cfg, 240, device=cuda_device) as s:
        st = s.run(200, hz=1000.0)
        untraced = s.tick_log.view()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as p:
            s.run(40, hz=1000.0)
        traced = s.tick_log.view(first_run=1)
        off = s.tick_log.epoch_offset_ns
    lat_ms = untraced.latency_ns() * 1e-6
    ms = untraced.graph_ms[:, 0]
    assert (ms > 0).all() and (ms <= lat_ms).all()
    assert np.isnan(untraced.graph_ms[:, 1]).all()          # no estimator
    assert untraced.device_ms("warm").size == (untraced.kind
                                               == prof.SOLVE).sum() == 40
    assert st["hold_graph_device_p50_ms"] == pytest.approx(
        float(np.sort(untraced.device_ms("hold"))[len(
            untraced.device_ms("hold")) // 2]))
    dev = sorted((e.start_ns() - off, e.start_ns() - off + e.duration_ns())
                 for e in p.profiler.kineto_results.events()
                 if str(e.device_type()).endswith("CUDA")
                 and not e.name().startswith(("Memcpy", "Memset",
                                              "session.")))
    starts = np.asarray([a for a, _ in dev])
    spans = []
    for row, kind in zip(traced.stamps, traced.kind):
        if kind != prof.HOLD:
            continue
        lo, hi = np.searchsorted(starts, [row[prof.LAUNCH],
                                          row[prof.WIRE_OUT]])
        if hi > lo:
            spans.append(1e-6 * (max(e for _, e in dev[lo:hi])
                                 - dev[lo][0]))
    assert len(spans) >= 20
    event_ms = float(np.median(untraced.device_ms("hold")))
    assert abs(float(np.median(spans)) - event_ms) <= 0.2 * event_ms, \
        (np.median(spans), event_ms)
