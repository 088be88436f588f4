"""The port's roofline model (``utils/roofline.py``) on the CPU: it gives
every bound chip_smoke.py printed before the model moved there, chip_smoke
keeps no second copy, the per-stage counts add up to the tick's bound, and
tools/roofline_torch.py writes its fields (a tiny CPU sweep)."""

import importlib.util
import json
from pathlib import Path

import pytest

from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.utils import roofline

REPO = Path(__file__).resolve().parents[1]
MOVED = ("core_flops", "bound", "tick_bound", "chol_bound", "pdip_flops",
         "pdip_bound")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", REPO / "chip_smoke.py")


def test_bounds_equal_those_before_the_move(smoke):
    """Every row of PERF.md's kernel table at B = 4096, bit for bit."""
    got = {k: v["bound_ms"] for k, v in roofline.kernel_bounds(4096).items()}
    assert got == smoke.BOUNDS_BEFORE_MOVE


def test_chip_smoke_imports_the_model(smoke):
    src = (REPO / "chip_smoke.py").read_text()
    for name in MOVED:
        assert f"\ndef {name}(" not in src, name
    assert "HBM_BPS =" not in src and "F32_FLOPS =" not in src
    for name in ("tick_bound", "chol_bound", "pdip_bound"):
        assert getattr(smoke, name) is getattr(roofline, name)


@pytest.mark.parametrize("mode,kf", [("walk", False), ("walk", True),
                                     ("stand", False), ("stand", True)])
def test_fused_tick_counts_make_the_tick_bound(mode, kf):
    cfg = (ControllerConfig.walking() if mode == "walk"
           else ControllerConfig.standing())
    nu = 3 if mode == "walk" else 6
    c = cfg.srbd
    fl = roofline.fused_tick_flops(N=c.horizon, nu=nu, mu_=2 * nu,
                                   iters=c.solver.admm_warm_iters, kf=kf)
    assert fl["total_flops"] == pytest.approx(
        sum(fl["flops_by_stage"].values()), rel=1e-12)
    assert ("kf" in fl["flops_by_stage"]) == kf
    B = 4096
    tb = roofline.tick_bound(cfg, B, kf, hold=False)
    assert tb["bound_operations_ms"] == \
        B * fl["total_flops"] / roofline.F32_FLOPS * 1e3
    nbytes = roofline.fused_tick_hbm_bytes(N=c.horizon, nu=nu, mu_=2 * nu,
                                           kf=kf)
    assert tb["bound_bytes_ms"] == pytest.approx(
        B * nbytes / roofline.HBM_BPS * 1e3, rel=1e-12)


def test_fused_tick_counts_refuse_other_kernels():
    with pytest.raises(ValueError):
        roofline.fused_tick_flops(nx=12)
    with pytest.raises(ValueError):
        roofline.fused_tick_hbm_bytes(nu=3, mu_=4)


def test_roofline_tool_on_the_cpu(tmp_path):
    tool = _load("roofline_torch", REPO / "tools/roofline_torch.py")
    out = tmp_path / "roofline.json"
    assert tool.main(["--device", "cpu", "--batches", "2", "3", "--steps",
                      "2", "--reps", "1", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["device"] == "cpu" and art["ok"]
    assert art["model"]["flops_per_tick"] == roofline.fused_tick_flops()[
        "total_flops"]
    assert [p["B"] for p in art["sweep"]] == [2, 3]
    for p in art["sweep"]:
        assert p["clock"] == "host" and p["tick_ms"] > 0 and p["finite"]
        assert p["bound_by"] in ("bytes", "operations")
        assert p["roofline_share"] is None     # no device peak on the CPU
