"""Scaling sweep of the PyTorch/CUDA port: batched MPC throughput against
the number of devices of a scenario mesh (BASELINE config 5's shape).

Sweeps meshes of 1, 2, n/2 and n devices (n: the cards of this machine,
or ``--devices`` CPU shards with ``--device cpu``) at a fixed batch per
device, through ``parallel/mesh.py``: per-step dispatch of
``sharded_batch_step``, or with ``--rollout-steps`` the multi-step
``sharded_rollout`` (each shard's closed loop on its device; on the card
the resident rollout, whose CUDA graph is captured in each timed call).
With one card the sweep has one point and no scaling efficiency.

Usage: python examples/scaling_sweep_torch.py [--batch-per-device 512]
    [--iters 5] [--rollout-steps 0] [--device cuda|cpu] [--devices N]
    [--out sweep.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import require_device
from mpc_limx_control_tpu_torch.parallel import mesh as pmesh
from mpc_limx_control_tpu_torch.utils.profiling import card


def _state(cfg, B: int, device):
    s0 = ro.initial_plant_state(cfg, batch=(B,), device=device)
    xi = s0.xi.clone()
    xi[:, 9] += 0.05 * torch.as_tensor(
        np.random.default_rng(0).standard_normal(B), dtype=xi.dtype,
        device=device)
    return s0.replace(xi=xi)


def _sync(mesh) -> None:
    for d in set(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def bench_mesh(cfg, devices, batch_per_device: int, iters: int) -> dict:
    mesh = pmesh.make_mesh(devices)
    B = batch_per_device * len(devices)
    st = pmesh.shard_leading(_state(cfg, B, mesh.devices[0]), mesh)
    step = pmesh.sharded_batch_step(cfg, mesh)
    st, stats = step(st, 0.0)
    _sync(mesh)
    t0 = time.perf_counter()
    for k in range(iters):
        st, stats = step(st, float(k))
    _sync(mesh)
    dt = time.perf_counter() - t0
    return {"devices": len(devices), "batch": B,
            "solves_per_s": B * iters / dt, "step_ms": dt / iters * 1e3,
            "mean_height": float(stats["mean_height"])}


def bench_mesh_rollout(cfg, devices, batch_per_device: int,
                       steps: int) -> dict:
    """The deployment shape: each shard's multi-step rollout on its
    device, timed after one warm-up run."""
    mesh = pmesh.make_mesh(devices)
    B = batch_per_device * len(devices)
    s0 = pmesh.shard_leading(_state(cfg, B, mesh.devices[0]), mesh)
    run = pmesh.sharded_rollout(cfg, mesh, steps)
    run(s0, 0.0)
    _sync(mesh)
    t0 = time.perf_counter()
    final, stats = run(s0, 0.0)
    _sync(mesh)
    dt = time.perf_counter() - t0
    return {"devices": len(devices), "batch": B, "steps": steps,
            "solves_per_s": B * steps / dt, "step_ms": dt / steps * 1e3,
            "mean_height": float(stats["mean_height"][-1])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-per-device", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rollout-steps", type=int, default=0,
                    help="if >0, time the multi-step sharded rollout "
                         "instead of per-step dispatch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=2,
                    help="CPU shards of the largest mesh (--device cpu)")
    ap.add_argument("--out", type=str, default="",
                    help="write the sweep result as JSON")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = ControllerConfig.walking()
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev] * args.devices)
    counts = sorted({1, 2, len(devs) // 2, len(devs)} - {0})
    results = []
    for n in counts:
        if n > len(devs):
            continue
        if args.rollout_steps > 0:
            r = bench_mesh_rollout(cfg, devs[:n], args.batch_per_device,
                                   args.rollout_steps)
        else:
            r = bench_mesh(cfg, devs[:n], args.batch_per_device, args.iters)
        results.append(r)
        print(json.dumps(r))
    effs = {}
    if len(results) > 1:
        base = results[0]["solves_per_s"]
        for r in results[1:]:
            effs[r["devices"]] = r["solves_per_s"] / (base * r["devices"])
            print(f"devices={r['devices']}: scaling efficiency "
                  f"{effs[r['devices']]:.2f}")
    out = {"mode": "rollout" if args.rollout_steps > 0 else "per-step",
           "platform": dev.type,
           "card": card() if dev.type == "cuda" else "",
           "batch_per_device": args.batch_per_device, "results": results,
           "weak_scaling_efficiency": effs,
           "note": ("CPU shards share the host's cores: the times are the "
                    "host's" if dev.type == "cpu" else
                    "one point a card count; no efficiency with one card"
                    if len(results) == 1 else "")}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
