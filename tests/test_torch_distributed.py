"""Two-process ``torch.distributed`` run of the port's scenario mesh over
loopback: the counterpart of tests/test_distributed.py.

tools/distributed_rollout_torch.py starts two CPU processes over gloo on a
free loopback port (each imports only the port and runs one torch
thread). Each runs ``initialize_multihost`` and a sharded rollout of the
walking config, B = 8, 3 steps, ``xi[:, 9] += 0.01 * arange(8)``, on its
block of 4 rows. Both must report the same statistics (atol 0), within
1e-6 of a one-process ``sharded_rollout`` of the same problem. The ranks
are killed 60 s after they start, so a stuck rendezvous fails then.
With ``--stagger 600`` each scenario starts at its own iteration, split
over the ranks with the state's rows, and each rank's mesh log counts the
call's collectives and the bytes they reduced.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.parallel import mesh as pmesh

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("style", ["shard_map", "gspmd"])
def test_two_process_distributed_rollout(tmp_path, style):
    out = tmp_path / "dist.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "distributed_rollout_torch.py"),
         "--processes", "2", "--batch", "8", "--steps", "3", "--style", style,
         "--device", "cpu", "--timeout", "60", "--out", str(out)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(out.read_text())
    r0, r1 = res["ranks"]
    assert r0["ndev"] == r1["ndev"] == 2
    assert (r0["rows"], r1["rows"]) == ([0, 4], [4, 8])
    # both processes see identical replicated statistics
    for k in ("mean_height", "max_qp_residual"):
        np.testing.assert_allclose(r0[k], r1[k], rtol=0, atol=0)
    assert res["ranks_equal"] and res["ok"]

    # and they match a one-process run of the identical problem
    cfg = ControllerConfig.walking()
    s0 = ro.initial_plant_state(cfg, batch=(8,), device="cpu")
    xi = s0.xi.clone()
    xi[:, 9] += 0.01 * torch.arange(8, dtype=xi.dtype)
    mesh = pmesh.make_mesh(["cpu"] * 4)
    make = (pmesh.shard_map_rollout if style == "shard_map"
            else pmesh.sharded_rollout)
    _, stats = make(cfg, mesh, 3)(s0.replace(xi=xi), 0.0)
    np.testing.assert_allclose(r0["mean_height"],
                               stats["mean_height"].numpy(), atol=1e-6)
    np.testing.assert_allclose(r0["max_qp_residual"],
                               stats["max_qp_residual"].numpy(), atol=1e-6)


def _run_tool(tmp_path, *extra):
    out = tmp_path / "dist.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "distributed_rollout_torch.py"),
         "--processes", "2", "--device", "cpu", "--timeout", "60",
         "--out", str(out), *extra],
        cwd=str(ROOT), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("style", ["shard_map", "gspmd"])
def test_two_process_staggered_rollout(tmp_path, style):
    """Staggered starts ((97 i) % 600, B = 8, 3 steps) over two ranks: the
    same statistics on both, within 1e-6 of one process with the same
    starts (and not those of a lockstep start); one logged call a rank,
    with 4 all_reduce calls and 24 T + 4 bytes for the full statistics
    (the packed sums and count, the residual, the distance, the index), 2
    and 8 T + 4 for shard_map's (the packed height sums and count, the
    residual)."""
    T = 3
    res = _run_tool(tmp_path, "--batch", "8", "--steps", str(T),
                    "--style", style, "--stagger", "600")
    r0, r1 = res["ranks"]
    assert res["ok"] and res["ranks_equal"] and res["stagger"] == 600
    for k in ("mean_height", "max_qp_residual"):
        np.testing.assert_allclose(r0[k], r1[k], rtol=0, atol=0)
    n, nbytes = (4, 24 * T + 4) if style == "gspmd" else (2, 8 * T + 4)
    for r in (r0, r1):
        assert r["calls"] == 1
        assert r["collectives"] == [n] and r["reduced_bytes"] == [nbytes]

    cfg = ControllerConfig.walking()
    s0 = ro.initial_plant_state(cfg, batch=(8,), device="cpu")
    xi = s0.xi.clone()
    xi[:, 9] += 0.01 * torch.arange(8, dtype=xi.dtype)
    start = ((97 * torch.arange(8)) % 600).to(xi.dtype)
    mesh = pmesh.make_mesh(["cpu"] * 2)
    make = (pmesh.shard_map_rollout if style == "shard_map"
            else pmesh.sharded_rollout)
    _, stats = make(cfg, mesh, T)(s0.replace(xi=xi), start)
    np.testing.assert_allclose(r0["mean_height"],
                               stats["mean_height"].numpy(), atol=1e-6)
    np.testing.assert_allclose(r0["max_qp_residual"],
                               stats["max_qp_residual"].numpy(), atol=1e-6)
    _, lock = make(cfg, mesh, T)(s0.replace(xi=xi), 0.0)
    assert not np.allclose(r0["max_qp_residual"],
                           lock["max_qp_residual"].numpy(), atol=1e-6)
