"""Multi-process scenario-sharded rollout of the PyTorch/CUDA port.

Launches ``--processes`` local processes of this script over a loopback
coordinator. Each runs ``parallel.mesh.initialize_multihost`` and a
sharded rollout (``shard_map_rollout``, or ``sharded_rollout`` with
``--style gspmd``) of the same global batch on its block of rows: on the
card, each on card ``rank % device_count`` (two processes share one card
over gloo); on the CPU (``--device cpu``), one CPU shard each. Then the
launcher runs the same problem in one process on a mesh of as many shards
and checks that every rank reports the same statistics (atol 0) and that
they are within 1e-6 of the one-process run.

The walking config, ``xi[:, 9] += 0.01 * (arange(B) % 8)`` (the kick of
tests/test_distributed.py at B = 8); with ``--stagger S`` each scenario
starts at its own iteration, ``(97 * arange(B)) % S`` (staggered gait
phases, split over the ranks with the state's rows). Each rank also
reports its call's row of the mesh log (``utils.profiling.mesh_log``):
the collectives made and the bytes they reduced. The launcher kills the
ranks ``--timeout`` seconds after it starts them (a stuck rendezvous
fails then, not at the process group's own timeout).

Usage: python tools/distributed_rollout_torch.py [--processes 2]
           [--batch 256] [--steps 5] [--style shard_map|gspmd]
           [--stagger 0] [--device cuda|cpu] [--timeout 120] [--out F]
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np
import torch

from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import require_device
from mpc_limx_control_tpu_torch.ops import _build
from mpc_limx_control_tpu_torch.parallel import mesh as pmesh
from mpc_limx_control_tpu_torch.utils import profiling

STATS = ("mean_height", "max_qp_residual")


def problem(B: int, device, stagger: int = 0):
    """The walking config, the global batch every rank builds and its
    start iteration (a scalar, or one a scenario with `stagger`)."""
    cfg = ControllerConfig.walking()
    s0 = ro.initial_plant_state(cfg, batch=(B,), device=device)
    xi = s0.xi.clone()
    xi[:, 9] += 0.01 * (torch.arange(B, device=device) % 8).to(xi.dtype)
    start = ((97 * torch.arange(B, device=device)) % stagger).to(xi.dtype) \
        if stagger > 0 else 0.0
    return cfg, s0.replace(xi=xi), start


def run_style(style: str):
    return (pmesh.shard_map_rollout if style == "shard_map"
            else pmesh.sharded_rollout)


def _rank(args) -> None:
    """One rank: its block of the batch, its statistics to --out."""
    torch.set_num_threads(1)
    n = pmesh.initialize_multihost(f"127.0.0.1:{args.port}",
                                   args.processes, args.rank)
    dev = require_device(args.device)
    mesh = pmesh.make_mesh(None if dev.type == "cuda" else [dev])
    cfg, s0, start = problem(args.batch, mesh.devices[0], args.stagger)
    for k in _build.KERNELS:
        k.reset()
    log = profiling.mesh_log()
    log.clear()
    final, stats = run_style(args.style)(cfg, mesh, args.steps)(s0, start)
    calls = log.view()
    with open(args.out, "w") as fh:
        json.dump({"rank": args.rank, "ndev": n,
                   "device": str(mesh.devices[0]),
                   "reduce_device": str(mesh.reduce_device),
                   "rows": [final.offsets[0],
                            final.offsets[0] + final.parts[0].xi.shape[0]],
                   "launches": {k.name: k.launches for k in _build.KERNELS
                                if k.launches},
                   "calls": len(calls),
                   "collectives": calls.collectives.tolist(),
                   "reduced_bytes": calls.reduced_bytes.tolist(),
                   **{k: stats[k].cpu().tolist() for k in STATS}}, fh)
    torch.distributed.destroy_process_group()


def _launch(args) -> list:
    """Start the ranks, wait for them (killing them at the deadline) and
    return what each wrote."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = [sys.executable, str(Path(__file__).resolve()),
            "--processes", str(args.processes), "--batch", str(args.batch),
            "--steps", str(args.steps), "--style", args.style,
            "--stagger", str(args.stagger), "--device", args.device,
            "--port", str(port)]
    with tempfile.TemporaryDirectory(prefix="dist_rollout_") as tmpd:
        tmp = Path(tmpd)
        outs = [tmp / f"rank{i}.json" for i in range(args.processes)]
        logs = [open(tmp / f"rank{i}.log", "w")
                for i in range(args.processes)]
        procs = [subprocess.Popen(base + ["--rank", str(i), "--out", str(o)],
                                  cwd=str(ROOT), stdout=log,
                                  stderr=subprocess.STDOUT)
                 for i, (o, log) in enumerate(zip(outs, logs))]
        deadline = time.time() + args.timeout
        failed = []
        try:
            for i, p in enumerate(procs):
                try:
                    rc = p.wait(timeout=max(1.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                if rc != 0:
                    failed.append((i, rc))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        if failed:
            tail = {i: (tmp / f"rank{i}.log").read_text()[-3000:]
                    for i, _ in failed}
            raise RuntimeError(f"ranks failed {failed}: {tail}")
        return [json.loads(o.read_text()) for o in outs]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--style", choices=("shard_map", "gspmd"),
                    default="shard_map")
    ap.add_argument("--stagger", type=int, default=0,
                    help="start each scenario at its own iteration, "
                         "(97 * index) %% STAGGER")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--out", default="chiprun_out/distributed_torch.json")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args)
        return {}
    dev = require_device(args.device)
    ranks = _launch(args)

    # the same problem in one process, on a mesh of as many shards
    mesh = pmesh.make_mesh([ranks[0]["device"] if dev.type == "cuda"
                            else "cpu"] * args.processes)
    cfg, s0, start = problem(args.batch, mesh.devices[0], args.stagger)
    _, ref = run_style(args.style)(cfg, mesh, args.steps)(s0, start)
    ref = {k: ref[k].cpu().tolist() for k in STATS}
    equal = all(r[k] == ranks[0][k] for r in ranks for k in STATS)
    err = max(float(np.max(np.abs(np.subtract(ranks[0][k], ref[k]))))
              for k in STATS)
    out = {"processes": args.processes, "batch": args.batch,
           "steps": args.steps, "style": args.style,
           "stagger": args.stagger, "ranks": ranks,
           "one_process": ref, "ranks_equal": equal,
           "max_abs_err_vs_one_process": err,
           "ok": bool(equal and err <= 1e-6)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "ranks"}))
    return out


if __name__ == "__main__":
    sys.exit(0 if main().get("ok", True) else 1)
