"""Profile the port's walking or standing tick on a CUDA card.

For each batch size: the per-tick wall time of ``batched_rollout`` (one
``walking_tick*`` or, with ``--mode stand``, ``standing_tick*`` kernel
launch per tick: truth or KF odometry, every tick solving or, with
``--mpc-every 5``, the dtMPC schedule of one solving tick and four held
ones) over a window of ticks, measured twice without the
profiler; then the device time of every kernel in a third window from
``torch.profiler`` (CUPTI), per tick and per launch, and the device share
of the wall time. Prints one JSON line per batch size (and appends it to
``--out`` when given).

``--held`` profiles the held-force form through the wrapper instead: one
``rollout.plant_step`` call with a held force pair a tick, on a fixed
state (the wrapper's checks, the launch and the metric tensors around
the ``*_tick_hold`` / ``*_tick_kf_hold`` kernel); the line then also
names the host operators and, from ``cProfile`` over a fourth window,
the Python functions that take the most host time a tick.

``--solver`` swaps the config's QP solver for one of the general ones,
whose tick is the plain composition on the card with its factorizations
and solves in the ``ops/chol_cuda.py`` kernels: ``pdip`` (warm, 6 Newton
steps), ``pdip-cold`` (20 steps from the cold start, no warm state),
``admm`` (warm dense ADMM) or ``admm-cold`` (60 iterations from zeros).
The line then also counts the kernel launches per tick.

    python3 tools/profile_torch_tick.py [--batches 1 64 1024 4096]
                                        [--ticks 200] [--mode stand]
                                        [--estimator kf] [--mpc-every 5]
                                        [--held]
                                        [--solver pdip|pdip-cold|admm|
                                                  admm-cold]
                                        [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _device_us(evt) -> float:
    """Device time of a kernel event; 0 for a host-side operator, whose
    entry repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType

    if getattr(evt, "device_type", DeviceType.CUDA) != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _window(cfg, s, ticks: int, mpc_every: int, held=None) -> float:
    from mpc_limx_control_tpu_torch.control import rollout as ro

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if held is None:
        ro.batched_rollout(cfg, s, ticks, mpc_every=mpc_every)
    else:
        it = torch.full((s.xi.shape[0],), 123.0, device=s.xi.device)
        for _ in range(ticks):
            ro.plant_step(cfg, s, it, grf_override=held)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ticks


def profile_batch(cfg, B: int, ticks: int, dev, mpc_every: int = 1,
                  held: bool = False) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from mpc_limx_control_tpu_torch.control import rollout as ro

    s = ro.initial_plant_state(cfg, batch=(B,), device=dev)
    force = None
    if held:
        force = torch.tensor([0.0, 0.0, 0.0, 2.0, -1.0, 180.0],
                             device=dev).expand(B, 6).contiguous()
    _window(cfg, s, ticks, mpc_every, force)                # warm up
    walls = [_window(cfg, s, ticks, mpc_every, force),
             _window(cfg, s, ticks, mpc_every, force)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = _window(cfg, s, ticks, mpc_every, force)
    py_top = {}
    if held:
        import cProfile
        import pstats

        pr = cProfile.Profile()
        pr.enable()
        _window(cfg, s, ticks, mpc_every, force)
        pr.disable()
        st = pstats.Stats(pr)
        rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:10]
        py_top = {f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}:{fn[2]}":
                  tt / ticks * 1e3 for fn, (_, _, tt, _, _) in rows}
    by_name, counts, host = {}, {}, {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0.0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
            counts[evt.key] = counts.get(evt.key, 0) + evt.count
        elif evt.self_cpu_time_total > 0.0:
            host[evt.key] = host.get(evt.key, 0.0) + evt.self_cpu_time_total
    dev_ms = sum(by_name.values()) / ticks / 1e3
    wall = min(walls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    launches = sum(counts.values()) / ticks
    return {
        "B": B, "ticks": ticks, "mode": cfg.mode,
        "estimator": cfg.estimator_mode,
        "mpc_every": mpc_every,
        "wall_ms_per_tick": wall * 1e3,
        "wall_ms_per_tick_runs": [w * 1e3 for w in walls],
        "wall_ms_per_tick_profiled": wall_prof * 1e3,
        "device_ms_per_tick": dev_ms,
        "device_over_wall": dev_ms / (wall * 1e3),
        "device_launches_per_tick": launches,
        "solver": cfg.srbd.solver.method,
        "qp_warm_start": cfg.qp_warm_start,
        "ticks_per_s": B / wall,
        "top_kernels_ms_per_tick": {k[:60]: v / ticks / 1e3 for k, v in top},
        "top_kernels_us_per_launch": {k[:60]: v / counts[k] for k, v in top},
        "held": held,
        "top_python_ms_per_tick": py_top,
        "top_host_ms_per_tick": {
            k[:60]: v / ticks / 1e3 for k, v in sorted(
                host.items(), key=lambda kv: -kv[1])[:8]},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[1, 64, 1024, 4096])
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--mode", choices=("walk", "stand"), default="walk")
    ap.add_argument("--estimator", choices=("truth", "kf"), default="truth")
    ap.add_argument("--mpc-every", type=int, default=1)
    ap.add_argument("--held", action="store_true",
                    help="profile plant_step with a held force instead")
    ap.add_argument("--solver", default=None,
                    choices=("pdip", "pdip-cold", "admm", "admm-cold"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_tick: no CUDA device", file=sys.stderr)
        return 1
    import dataclasses

    from mpc_limx_control_tpu_torch.core.config import ControllerConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    base = (ControllerConfig.standing() if args.mode == "stand"
            else ControllerConfig.walking())
    cfg = dataclasses.replace(base, estimator_mode=args.estimator)
    if args.solver is not None:
        from mpc_limx_control_tpu_torch.core.config import SolverConfig

        method, _, cold = args.solver.partition("-")
        solver = (SolverConfig(method="pdip", iters=20) if method == "pdip"
                  else SolverConfig(method="admm", iters=60, admm_rho=0.1))
        cfg = dataclasses.replace(
            cfg, qp_warm_start=not cold,
            srbd=dataclasses.replace(cfg.srbd, solver=solver))
    for B in args.batches:
        line = json.dumps(dict(card=smi, **profile_batch(
            cfg, B, args.ticks, dev, args.mpc_every, args.held)))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
