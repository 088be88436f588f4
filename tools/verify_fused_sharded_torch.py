"""Prove the whole-tick kernel composes with scenario sharding on the card.

Runs the walking config -- whose ``plant_step`` is one launch of the
whole-tick kernel on the card (``tick_fused_cuda.supports_fused_tick``,
asserted) -- with truth odometry and with the Kalman filter in the kernel,
through both sharding styles of ``parallel/mesh.py`` over a mesh of every
card (``--shards-per-device`` shards on each), 10 steps at B = 256, against
the unsharded ``batched_rollout``:

  * GSPMD style (``sharded_rollout``)
  * explicit-collective style (``shard_map_rollout``)

On the card each scenario is computed by its own block or half warp, so
the sharded state must equal the unsharded one bit for bit and the
statistics within rtol 1e-6 of ``scenario_stats`` of the unsharded
metrics (bit for bit with one shard a card); on the CPU (``--device cpu``, the plain
composition) within JAX's bands, xi 1e-4 and the stats 1e-5. Walls are
taken after one warm-up run of each path, with the launches of the timed
run.

Writes the result to ``--out`` (default chiprun_out/fused_sharded_torch.json);
exit code 0 when both configs pass.

Usage:  python tools/verify_fused_sharded_torch.py [--batch 256] [--steps 10]
            [--shards-per-device 1] [--device cuda|cpu] [--out F]
"""

from __future__ import annotations

import argparse
import dataclasses
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
from mpc_limx_control_tpu_torch.ops import _build
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc
from mpc_limx_control_tpu_torch.parallel import mesh as pmesh
from mpc_limx_control_tpu_torch.utils.profiling import card


def _timed(fn, devices):
    """Run once (warm-up), then again timed; returns (result, wall_s,
    launches of the timed run a kernel)."""
    def sync():
        for d in set(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    fn()
    sync()
    before = [k.launches for k in _build.KERNELS]
    t0 = time.perf_counter()
    r = fn()
    sync()
    wall = time.perf_counter() - t0
    return r, wall, {k.name: k.launches - b
                     for k, b in zip(_build.KERNELS, before)
                     if k.launches != b}


def _run_config(name, cfg, mesh, B: int, steps: int) -> dict:
    dev = mesh.devices[0]
    on_card = dev.type == "cuda"
    if on_card:
        assert tfc.supports_fused_tick(cfg), \
            f"[{name}] the tick kernel must be the card's path"
    s0 = ro.initial_plant_state(cfg, batch=(B,), device=dev)
    xi = s0.xi.clone()
    xi[:, 9] += 0.05 * torch.as_tensor(
        np.random.default_rng(11).standard_normal(B), dtype=xi.dtype,
        device=dev)
    s0 = s0.replace(xi=xi)
    tol_xi, rtol_stats = (0.0, 1e-6) if on_card else (1e-4, 1e-5)

    (ref, m_ref), t_ref, l_ref = _timed(
        lambda: ro.batched_rollout(cfg, s0, steps), mesh.devices)
    mean_ref = pmesh.scenario_stats(m_ref)["mean_height"]
    out = {"tick_kernel_path": on_card,
           "wall_s": {"unsharded": t_ref}, "launches": {"unsharded": l_ref}}
    ok = bool(torch.isfinite(ref.xi).all())
    for style, make in (("gspmd", pmesh.sharded_rollout),
                        ("shard_map", pmesh.shard_map_rollout)):
        run = make(cfg, mesh, steps)
        (fin, stats), wall, launches = _timed(lambda: run(s0, 0.0),
                                              mesh.devices)
        got = fin.gather(dev)
        err = {f: float((getattr(got, f) - getattr(ref, f)).abs().max())
               for f in ("xi", "q", "foot_l", "foot_r")}
        rel = float(((stats["mean_height"].to(dev) - mean_ref).abs()
                     / mean_ref.abs()).max())
        out[style] = {"max_abs_err_vs_unsharded": err,
                      "mean_height_rel_err": rel,
                      "mean_height_final": float(stats["mean_height"][-1])}
        out["wall_s"][style] = wall
        out["launches"][style] = launches
        ok = ok and max(err.values()) <= tol_xi and rel <= rtol_stats \
            and bool(torch.isfinite(got.xi).all())
    out["ok"] = ok
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--shards-per-device", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/fused_sharded_torch.json")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    mesh = pmesh.make_mesh([d for d in devices
                            for _ in range(args.shards_per_device)])

    cfg_truth = ControllerConfig.walking()
    cfg_kf = dataclasses.replace(cfg_truth, estimator_mode="kf")
    out = {"platform": dev.type, "card": card() if dev.type == "cuda" else "",
           "mesh_devices": [str(d) for d in mesh.devices],
           "batch": args.batch, "steps": args.steps,
           "truth": _run_config("truth", cfg_truth, mesh, args.batch,
                                args.steps),
           "kf": _run_config("kf", cfg_kf, mesh, args.batch, args.steps)}
    out["ok"] = bool(out["truth"]["ok"] and out["kf"]["ok"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
