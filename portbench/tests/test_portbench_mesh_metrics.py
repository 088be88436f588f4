"""The mesh cell's per-layer metrics on synthetic records and rank logs:
rank 0's median collective time, the skew between ranks, the tick's roofline
share without the collectives, and the idle share.

    python -m pytest portbench/tests -q -o addopts='' -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402


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


@pytest.mark.parametrize("name", ["mesh_reduce_device_p50_ms",
                                  "rank_skew_pct.mesh",
                                  "tick_roofline_pct.mesh",
                                  "device_idle_pct.mesh"])
def test_a_mesh_reader_with_nothing_to_read_returns_none(name):
    assert metric(name)({"window": (0.0, 1.0), "device": [], "host": [],
                         "spans": []}) is None


def _mesh_ranks():
    """Four ranks' logs as the mesh driver gathers them: rank 2 the
    slowest; a NaN (an untimed call) is left out, and so is every call from
    rank 0's first profiled one on (on every rank)."""
    nan = float("nan")
    late = [False] * 4 + [True, False]
    return [{"rollout_ms": [250.0, 252.0, 251.0, nan, 900.0, 900.0],
             "reduce_ms": [0.5, 9.0, 0.7, nan, 90.0, 90.0],
             "profiled": late},
            {"rollout_ms": [249.0, 250.0, 248.0, 249.0, 1.0, 1.0],
             "reduce_ms": [3.0] * 6, "profiled": [False] * 6},
            {"rollout_ms": [255.0, 256.0, 257.0, 256.0, 1.0, 1.0],
             "reduce_ms": [0.1] * 6, "profiled": [False] * 6},
            {"rollout_ms": [250.0, 251.0, 250.0, 250.0, 1.0, 1.0],
             "reduce_ms": [2.0] * 6, "profiled": [False] * 6}]


def test_mesh_reduce_is_rank_0s_median():
    r = {"mesh_ranks": _mesh_ranks()}
    assert metric("mesh_reduce_device_p50_ms")(r) == pytest.approx(0.7)


def test_rank_skew_is_the_slowest_median_over_the_fastest():
    r = {"mesh_ranks": _mesh_ranks()}
    assert metric("rank_skew_pct.mesh")(r) == pytest.approx(
        100.0 * (256.0 / 249.0 - 1.0))
    one = {"mesh_ranks": _mesh_ranks()[:1]}
    assert metric("rank_skew_pct.mesh")(one) is None
    untraced = _mesh_ranks()
    for rank in untraced:
        rank["rollout_ms"], rank["profiled"] = rank["rollout_ms"][:4], \
            [False] * 4
    assert metric("rank_skew_pct.mesh")({"mesh_ranks": untraced}) == \
        pytest.approx(100.0 * (256.0 / 249.0 - 1.0))
    untimed = _mesh_ranks()
    untimed[3]["rollout_ms"] = [float("nan")] * 6
    assert metric("rank_skew_pct.mesh")({"mesh_ranks": untimed}) is None


def test_mesh_roofline_leaves_the_collectives_out():
    r = _record()
    r["device"].append(("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0.0,
                        100.0))
    kernel_ms = (30 + 20 + 10 + 10) * 1e-3
    assert metric("tick_roofline_pct.mesh")(r) == pytest.approx(
        100 * 0.01 / (kernel_ms / 2))
    # the idle share counts a collective waiting for its peers as busy
    assert metric("device_idle_pct.mesh")(r) == pytest.approx(0.0)
    assert metric("device_idle_pct.mesh")(_record()) == pytest.approx(40.0)
