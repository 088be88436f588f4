"""Roofline accounting of the port's whole-tick walking kernel on one card.

Counterpart of tools/roofline.py for the PyTorch/CUDA port:

1. counts the operations and bytes of one solving ``walking_tick`` launch
   a scenario from the kernel's loops (utils/roofline.py:
   ``fused_tick_flops``, ``fused_tick_hbm_bytes``);
2. runs the walking closed loop (truth odometry, every tick solving)
   through ``rollout.batched_rollout_resident`` at B in {1024, 4096,
   16384, 65536} and times it with CUDA events (the whole call over its
   ticks: one launch a tick, replayed from a CUDA graph, the graph's
   capture included);
3. reports the achieved operations/s against the card's published f32
   peak and bytes/s against its HBM peak, each tick's bound
   (``tick_bound``) and which of the two binds it.

Run from the root of a checkout:

    python3 tools/roofline_torch.py --out chiprun_out/roofline_torch.json

``--device cpu`` runs the same sweep on the CPU (the tick's plain
version, timed by the host clock, no share of a device peak): a check of
the tool, not a measurement of the card.
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
from mpc_limx_control_tpu_torch.utils import roofline
from mpc_limx_control_tpu_torch.utils.profiling import card


def _time_ms(fn, cuda: bool) -> float:
    """ms of one call of `fn`: CUDA events on the card, else the host
    clock."""
    if not cuda:
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def sweep_point(cfg, B: int, steps: int, reps: int, device) -> dict:
    """One batch size: the tick time (the fastest of `reps` timed calls
    after a warm-up call) and what it achieves against the model."""
    s0 = ro.initial_plant_state(cfg, batch=(B,), device=device)
    kick = np.random.default_rng(0).standard_normal(B)
    xi = s0.xi.clone()
    xi[:, 9] += torch.tensor(0.05 * kick, dtype=xi.dtype, device=device)
    s0 = s0.replace(xi=xi)
    cuda = device.type == "cuda"

    def run():
        return ro.batched_rollout_resident(cfg, s0, steps)

    final, _ = run()
    finite = bool(torch.isfinite(final.xi).all())
    calls = [_time_ms(run, cuda) for _ in range(reps)]
    tick_ms = min(calls) / steps
    c = cfg.srbd
    fl = roofline.fused_tick_flops(N=c.horizon, iters=c.solver.admm_warm_iters)
    nbytes = roofline.fused_tick_hbm_bytes(N=c.horizon)
    tb = roofline.tick_bound(cfg, B, est_kf=False, hold=False)
    out = dict(B=B, steps=steps, clock="cuda_events" if cuda else "host",
               call_ms=calls, tick_ms=tick_ms, finite=finite,
               scenario_ticks_per_s=B / tick_ms * 1e3, **tb)
    if cuda:
        ops_s = B * fl["total_flops"] / tick_ms * 1e3
        bytes_s = B * nbytes / tick_ms * 1e3
        out.update(achieved_flops_per_s=ops_s,
                   flops_share_of_peak=ops_s / roofline.F32_FLOPS,
                   achieved_bytes_per_s=bytes_s,
                   bytes_share_of_peak=bytes_s / roofline.HBM_BPS,
                   roofline_share=tb["bound_ms"] / tick_ms)
    else:
        out.update(achieved_flops_per_s=None, flops_share_of_peak=None,
                   achieved_bytes_per_s=None, bytes_share_of_peak=None,
                   roofline_share=None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[1024, 4096, 16384, 65536])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/roofline_torch.json")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    cfg = ControllerConfig.walking()
    c = cfg.srbd
    fl = roofline.fused_tick_flops(N=c.horizon, iters=c.solver.admm_warm_iters)
    art = {"device": str(dev),
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "card": card() if dev.type == "cuda" else "",
           "peaks": {"source": roofline.PEAKS, "hbm_bytes_per_s":
                     roofline.HBM_BPS, "f32_flops_per_s": roofline.F32_FLOPS},
           "model": {"kernel": "walking_tick", "flops_per_tick":
                     fl["total_flops"], "flops_by_stage": fl["flops_by_stage"],
                     "hbm_bytes_per_tick": roofline.fused_tick_hbm_bytes(
                         N=c.horizon)},
           "sweep": []}
    for B in args.batches:
        point = sweep_point(cfg, B, args.steps, args.reps, dev)
        art["sweep"].append(point)
        print(json.dumps({k: point[k] for k in (
            "B", "tick_ms", "scenario_ticks_per_s", "bound_ms", "bound_by",
            "roofline_share")}), file=sys.stderr, flush=True)
    art["best_batch"] = max(art["sweep"],
                            key=lambda p: p["scenario_ticks_per_s"])["B"]
    art["ok"] = all(p["finite"] for p in art["sweep"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(art, fh, indent=1)
    print(json.dumps({"roofline_ok": art["ok"], "best_batch":
                      art["best_batch"], "out": args.out}))
    return 0 if art["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
