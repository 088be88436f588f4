"""60k-tick endurance soaks of the PyTorch/CUDA port on the card.

The port's counterpart of tools/soak_tpu.py: three device-resident
windowed soaks (``control/rollout.py::soak_rollout``) of the walking
closed loop at B = 64, gait phases staggered over the 600-tick cycle,
60 windows of 1,000 ticks (60 s at 1 kHz):

  * truth odometry, every tick solving;
  * the reference's dtMPC schedule (re-solve every 5th tick, hold the
    force in between);
  * the 12-state Kalman filter in the loop.

Each window's metrics are reduced on the device; the statistics are
fetched once, at the end of a soak.

Gates (``soak_stationary`` over the last 80 % of windows), as
tools/soak_tpu.py's:
  * height mean drift |slope| < 2e-4 m a window, tail spread < 5 mm
    (not for the dtMPC soak), tail mean within 0.02 m of 0.65;
  * vx mean within 0.05 m/s of 0.5, drift |slope| < 2e-3;
  * height above 0.6 over every tick; no non-finite tick;
  * KF: the position covariance bounded (tail max < 10x its tail mean)
    and its mean drifting < 1e-6 a window.

Writes the summaries, walls and gates to ``--out`` (default
chiprun_out/soak_torch.json); exit code 0 when every gate holds.

Usage: python tools/soak_torch.py [--device cuda|cpu] [--batch 64]
           [--windows 60] [--window 1000] [--out F]
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
from mpc_limx_control_tpu_torch.utils.profiling import card

GAIT_CYCLE = 600        # walking(): 0.3 s swing + 0.3 s stance at 1 kHz


def _soak(cfg, dev, batch: int, n_windows: int, window: int, seed: int = 7,
          mpc_every: int = 1) -> dict:
    s0 = ro.initial_plant_state(cfg, batch=(batch,), device=dev)
    xi = s0.xi.clone()
    xi[:, 9] += 0.05 * torch.as_tensor(
        np.random.default_rng(seed).standard_normal(batch), dtype=xi.dtype,
        device=dev)
    s0 = s0.replace(xi=xi)
    # stagger the gait phase across the batch so the population average
    # is phase-free (a single-phase batch's window means beat at the gait
    # frequency, which would alias into the drift fit)
    it0 = torch.as_tensor((np.arange(batch) * GAIT_CYCLE) // batch,
                          dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    _, stats = ro.soak_rollout(cfg, s0, n_windows, window,
                               start_iteration=it0, mpc_every=mpc_every)
    wall = time.perf_counter() - t0
    summ = ro.soak_stationary(stats)
    summ.update(ticks=n_windows * window, batch=batch, wall_s=wall,
                ticks_per_s=n_windows * window / wall)
    return summ


def _gate_common(s: dict, spread: bool = True) -> bool:
    return bool(s["nonfinite_ticks"] == 0
                and s["height_min"] > 0.6
                and abs(s["height_mean_tail_mean"] - 0.65) < 0.02
                and (not spread or s["height_mean_tail_ptp"] < 0.005)
                and abs(s["height_mean_drift_per_window"]) < 2e-4
                and abs(s["vx_mean_tail_mean"] - 0.5) < 0.05
                and abs(s["vx_mean_drift_per_window"]) < 2e-3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--windows", type=int, default=60)
    ap.add_argument("--window", type=int, default=1000)
    ap.add_argument("--out", default="chiprun_out/soak_torch.json")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    art = {"device": str(dev), "card": card() if dev.type == "cuda" else "",
           "ticks": args.windows * args.window, "batch": args.batch,
           "window": args.window, "stagger_cycle": GAIT_CYCLE}
    cfg = ControllerConfig.walking()
    kcfg = dataclasses.replace(cfg, estimator_mode="kf")
    runs = (("walking_truth", cfg, 1), ("walking_dtmpc", cfg, 5),
            ("walking_kf", kcfg, 1))
    for name, c, me in runs:
        print(f"soak: {name} {args.windows * args.window} ticks ...",
              file=sys.stderr, flush=True)
        s = _soak(c, dev, args.batch, args.windows, args.window,
                  mpc_every=me)
        # the hold schedule trades solve rate for tracking slack: its
        # tail spread is not gated (tools/soak_tpu.py)
        s["ok"] = _gate_common(s, spread=me == 1)
        if c.estimator_mode == "kf":
            s["ok"] = bool(
                s["ok"] and np.isfinite(s["kf_cov_pos_max"])
                and s["kf_cov_pos_max_tail"] < 10.0 * max(
                    s["kf_cov_pos_mean_tail_mean"], 1e-12)
                and abs(s["kf_cov_pos_mean_drift_per_window"]) < 1e-6)
        art[name] = s
        print(json.dumps(s), file=sys.stderr, flush=True)
    art["ok"] = all(art[name]["ok"] for name, _, _ in runs)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(art, fh, indent=1)
    print(json.dumps({"soak_ok": art["ok"], "out": args.out}))
    return 0 if art["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
