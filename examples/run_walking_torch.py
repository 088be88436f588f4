"""Batched TRON1 walking / standing demo on the PyTorch/CUDA port.

Runs B perturbed scenarios closed-loop on the card (each tick one launch
of the whole-tick kernel for both modes and both estimators), logs
structured metrics through the port's MetricsLogger and plots the
trajectories when matplotlib imports.

Usage:
    python examples/run_walking_torch.py [--batch 64] [--steps 1500]
        [--velocity 0.5] [--mode walk|stand] [--estimator truth|kf]
        [--device cuda|cpu] [--out /tmp/walk_torch]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import require_device
from mpc_limx_control_tpu_torch.utils.profiling import MetricsLogger, Timer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--velocity", type=float, default=0.5)
    ap.add_argument("--mode", choices=("walk", "stand"), default="walk")
    ap.add_argument("--estimator", choices=("truth", "kf"),
                    default="truth")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=str, default="/tmp/walk_torch")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    if args.mode == "stand":
        cfg = ControllerConfig.standing()
    else:
        cfg = ControllerConfig.walking(velocity=(args.velocity, 0.0, 0.0))
    if args.estimator == "kf":
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    B = args.batch
    s0 = ro.initial_plant_state(cfg, batch=(B,), device=dev)
    kick = np.random.default_rng(0).standard_normal((B, 3))
    xi = s0.xi.clone()
    xi[:, 9:12] += 0.05 * torch.as_tensor(kick, dtype=xi.dtype, device=dev)
    s0 = s0.replace(xi=xi)

    with Timer("warm-up", dev) as tw:
        # loads the kernel library and the libraries' handles
        ro.batched_rollout(cfg, s0, min(10, args.steps))
    print(f"(warm-up: {tw.elapsed:.1f}s)")
    with Timer("rollout", dev) as t:
        final, metrics = ro.batched_rollout(cfg, s0, args.steps)
    sim_rate = B * args.steps / t.elapsed
    print(f"simulated {B} x {args.steps} ticks in {t.elapsed:.2f}s "
          f"({sim_rate:,.0f} ticks/s)")
    h = metrics["height"].cpu().numpy()             # [B, T]
    v = metrics["velocity"].cpu().numpy()           # [B, T, 3]
    res = metrics["qp_residual"].cpu().numpy()

    with MetricsLogger(out / "metrics.jsonl") as log:
        for k in range(0, args.steps, 50):
            log.log(k, mean_height=h[:, k].mean(), mean_vx=v[:, k, 0].mean(),
                    max_qp_residual=res[:, k].max())

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        t_ms = np.arange(args.steps)
        fig, axes = plt.subplots(3, 1, figsize=(9, 8), sharex=True)
        for b in range(min(8, B)):
            axes[0].plot(t_ms, h[b], lw=0.7)
            axes[1].plot(t_ms, v[b, :, 0], lw=0.7)
            axes[2].plot(t_ms, v[b, :, 1], lw=0.7)
        axes[0].set_ylabel("height [m]")
        axes[0].axhline(cfg.base_height, ls="--", c="k", lw=0.5)
        axes[1].set_ylabel("vx [m/s]")
        axes[1].axhline(cfg.desired_velocity[0], ls="--", c="k", lw=0.5)
        axes[2].set_ylabel("vy [m/s]")
        axes[2].set_xlabel("tick (1 kHz)")
        fig.tight_layout()
        fig.savefig(out / "walking.png", dpi=120)
        plt.close(fig)
        print(f"wrote {out / 'walking.png'}")
    except ImportError as e:                      # matplotlib optional
        print(f"(no plot: {e})")

    tail = max(1, min(200, args.steps))
    summary = {"batch": B, "steps": args.steps, "mode": args.mode,
               "estimator": args.estimator, "device": str(dev),
               "ticks_per_s": sim_rate, "wall_s": t.elapsed,
               "height_min": float(h.min()),
               "height_tail_mean": float(h[:, -tail:].mean()),
               "vx_tail_mean": float(v[:, -tail:, 0].mean()),
               "finite": bool(torch.isfinite(final.xi).all())}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
