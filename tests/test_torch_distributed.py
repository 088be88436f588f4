"""Two-process ``torch.distributed`` run of the port's scenario mesh over
loopback: the counterpart of tests/test_distributed.py.

tools/distributed_rollout_torch.py starts two CPU processes over gloo on a
free loopback port (each imports only the port and runs one torch
thread). Each runs ``initialize_multihost`` and a sharded rollout of the
walking config, B = 8, 3 steps, ``xi[:, 9] += 0.01 * arange(8)``, on its
block of 4 rows. Both must report the same statistics (atol 0), within
1e-6 of a one-process ``sharded_rollout`` of the same problem. The ranks
are killed 60 s after they start, so a stuck rendezvous fails then.
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
