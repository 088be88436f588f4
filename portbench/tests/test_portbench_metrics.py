"""The per-layer metrics' arithmetic on synthetic records, the end-to-end
tail over all ticks, and the frozen work counts."""

import statistics
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run, trace, work  # noqa: E402
from portbench.drivers import session  # noqa: E402


def metric(name):
    return run.load_module("metrics", name).read


def _record():
    # a 100 us window; kernels overlap (two streams) and a copy runs
    return {"window": (0.0, 100.0),
            "device": [("walking_tick", 10.0, 40.0),
                       ("walking_tick", 30.0, 50.0),
                       ("Memcpy HtoD", 45.0, 60.0),
                       ("copy_kernel", 80.0, 90.0),
                       ("outside", 150.0, 160.0)],
            "host": [("aten::empty", 0.0, 12.0), ("aten::copy_", 60.0, 85.0)],
            "spans": [(0.0, 20.0), (70.0, 100.0)],
            "ticks": 2, "bound_ms_per_tick": 0.01}


def test_idle_is_the_union_of_overlapping_device_intervals():
    r = _record()
    # busy: [10, 60] and [80, 90] -> 60 of 100 (the interval past the
    # window is clipped away)
    assert trace.busy_us(r) == pytest.approx(60.0)
    assert metric("device_idle_pct.batch")(r) == pytest.approx(40.0)
    assert trace.gaps(r) == [(0.0, 10.0), (60.0, 80.0), (90.0, 100.0)]


def test_kernels_a_tick_count_kernels_not_copies():
    assert metric("kernels_per_tick.batch")(_record()) == pytest.approx(
        4 / 2)


def test_roofline_divides_the_bound_by_all_kernel_time_a_tick():
    r = _record()
    kernel_ms = (30 + 20 + 10 + 10) * 1e-3
    assert metric("tick_roofline_pct.batch")(r) == pytest.approx(
        100 * 0.01 / (kernel_ms / 2))


def test_idle_inside_tick_spans():
    r = _record()
    # span [0, 20] covered 10; span [70, 100] covered 10 -> 20 of 50
    assert metric("tick_device_idle_pct.session")(r) == pytest.approx(60.0)


def test_breakdown_names_ops_and_gaps_by_host_operator():
    bd = trace.breakdown(_record())
    names = [n for n, _ in bd["device_ops"]]
    assert names[0] == "walking_tick"
    gaps = dict(bd["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(20e-6)
    assert gaps["aten::empty"] == pytest.approx(10e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_stale_polls_are_a_share_of_all_polls():
    assert metric("stale_poll_pct")({"sent": 900, "stale": 100}) == \
        pytest.approx(10.0)
    assert metric("stale_poll_pct")({"sent": 900, "stale": 0}) == 0.0


@pytest.mark.parametrize("name", ["kernels_per_tick.batch",
                                  "tick_roofline_pct.batch",
                                  "device_idle_pct.batch",
                                  "hold_tick_p50_ms", "solve_tick_p50_ms",
                                  "tick_device_idle_pct.session",
                                  "stale_poll_pct"])
def test_a_reader_with_nothing_to_read_returns_none(name):
    assert metric(name)({"window": (0.0, 1.0), "device": [], "host": [],
                         "spans": []}) is None


def test_session_medians_by_tick_kind():
    r = {"hold_ms": [0.5, 0.6, 0.7, 0.8], "solve_ms": [1.0, 2.0, 3.0]}
    assert metric("hold_tick_p50_ms")(r) == pytest.approx(0.65)
    assert metric("solve_tick_p50_ms")(r) == pytest.approx(2.0)


def test_p95_is_over_all_ticks_not_chunk_medians():
    # 20 chunks of 100 ticks: each chunk's median is 1.0 ms, while 8 % of
    # all ticks take 5 ms
    ticks = []
    for c in range(20):
        ticks += [1.0] * 92 + [5.0] * 8
    assert session.percentile(ticks, 95.0) == 5.0
    medians = [statistics.median(ticks[i:i + 100])
               for i in range(0, len(ticks), 100)]
    assert session.percentile(medians, 95.0) == 1.0
    assert session.percentile(list(range(1, 101)), 95.0) == 95
    assert session.percentile([3.0], 95.0) == 3.0


def test_work_pins_the_walking_tick():
    w = work.tick_work(3, 20, 5, hold=False)
    assert w == {"operations": 231108.0, "bytes": 1724}
    assert work.tick_work(6, 20, 5, hold=False)["operations"] == 1066128.0
    assert work.tick_work(3, 20, 5, hold=True) == {"operations": 1000.0,
                                                   "bytes": 308}
    assert work.tick_bound_ms(3, 20, 5, False, 4096) == pytest.approx(
        4096 * 231108 / 67e12 * 1e3)
    assert work.mean_tick_bound_ms(3, 20, 5, 4096, 5) == pytest.approx(
        (work.tick_bound_ms(3, 20, 5, False, 4096)
         + 4 * work.tick_bound_ms(3, 20, 5, True, 4096)) / 5)


def test_work_equals_the_ports_bound_model():
    from mpc_limx_control_tpu_torch.core.config import ControllerConfig
    from mpc_limx_control_tpu_torch.utils import roofline

    for cfg, nu in ((ControllerConfig.walking(), 3),
                    (ControllerConfig.standing(), 6)):
        for hold in (False, True):
            assert work.tick_bound_ms(nu, 20, 5, hold, 4096) == \
                roofline.tick_bound(cfg, 4096, False, hold)["bound_ms"]
