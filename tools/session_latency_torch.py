"""Live-session latency of the PyTorch/CUDA port on one NVIDIA GPU.

Counterpart of tools/session_latency_tpu.py: the loopback UDP session
(``mpc_limx_control_tpu_torch.control.session.ControlSession.run``, the
production path: the warm fused solve every 5 ticks and the held force in
between) against the torch WirePlant of tests/test_torch_session_walking.py
(on the CPU), for the walking truth, walking KF, walking async-dispatch
and standing runs. Each run is made twice, with the tick functions
replayed as CUDA graphs (the default) and launched eagerly
(``cuda_graphs=False``), and records the session's own statistics
(tick / solve / hold latency, ticks over the 1 ms period, solves over the
5 ms dtMPC budget, force staleness) and the closed-loop quality of the
run. The plant runs in a process of its own, as a robot would: in a
thread of the session's process the two share the interpreter lock, and
each of the session's hundreds of small torch calls a tick waits on the
plant's.

First each tick function alone (walking and standing; graph replay and
eager call, and the kernels a replay launches). Prints the card's name and
power limit, one JSON line a run, and writes all of it as JSON to --out
(default build/session_latency_torch.json).

Usage (from the root of a checkout, on a CUDA machine):
    python3 tools/session_latency_torch.py [--iters 1500] [--eager-too 1]
        [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

RUNS = (  # name, mode, run() keywords, the plant publishes truth odometry
    ("walk_truth", "walk", {}, True),
    ("walk_kf", "walk", {"use_kf": True}, False),
    ("walk_async", "walk", {"async_dispatch": True}, True),
    ("stand", "stand", {}, True),
)


def plant_process(cfg, port, truth, conn):
    """The WirePlant in a process of its own (as a robot is): runs until
    told to stop, then sends back its final state and step count."""
    torch.set_num_threads(1)
    from test_torch_session_walking import WirePlant

    plant = WirePlant(cfg, port, port + 1, publish_truth_odom=truth)
    conn.send("up")
    conn.recv()
    plant.close()
    conn.send((plant.xi[0].numpy(), plant.steps_taken))


def run_one(cfg, iters, kw, truth, port, cuda_graphs):
    from mpc_limx_control_tpu_torch.control import rollout as ro
    from mpc_limx_control_tpu_torch.control import session as ses
    from mpc_limx_control_tpu_torch.ops import _build

    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=plant_process, args=(cfg, port, truth, child))
    proc.start()
    try:
        conn.recv()
        with ses.ControlSession(cfg, state_port=port, cmd_port=port + 1,
                                device="cuda",
                                cuda_graphs=cuda_graphs) as session:
            if kw.get("use_kf"):
                # the filter seeded at the plant's known start pose
                s0 = ro.initial_plant_state(cfg, device="cpu")
                x = session.kf.x_hat
                x[0:3], x[6:9], x[9:12] = s0.xi[3:6], s0.foot_l, s0.foot_r
                session.kf = session.kf.replace(x_hat=x)
            for k in _build.KERNELS:
                k.reset()
            t0 = time.perf_counter()
            stats = session.run(iterations=iters, hz=1000.0, **kw)
            wall = time.perf_counter() - t0
        conn.send("stop")
        xi, steps = conn.recv()
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
    out = dict(stats)
    out.update(
        wall_s=wall, achieved_hz=stats["sent"] / wall,
        final_height=float(xi[5]), final_x=float(xi[3]),
        final_roll_pitch=[float(xi[0]), float(xi[1])], plant_steps=steps,
        launches={k.name: k.launches for k in _build.KERNELS
                  if k.launches})
    return out


def tick_functions(cfg, port):
    """Each tick function of a session alone (no wire): a graph replay and
    an eager call, ms a call by the host clock around 50 synchronized
    calls and by CUDA events, and a replay's kernels (count and summed
    device time) from a torch.profiler trace."""
    from mpc_limx_control_tpu_torch.control import session as ses

    sessions = {g: ses.ControlSession(cfg, state_port=port + 2 * g,
                                      cmd_port=port + 1 + 2 * g,
                                      device="cuda", cuda_graphs=g)
                for g in (True, False)}
    out = {}
    for name in sessions[True]._fns:
        for g, s in sessions.items():
            def call():
                s._run(name)
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 50
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(50):
                call()
            ev[1].record()
            torch.cuda.synchronize()
            r = {"wall_ms": wall, "event_ms": ev[0].elapsed_time(ev[1]) / 50}
            if g:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                kern = [e for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA]
                r.update(kernels=len(kern), device_ms=sum(
                    getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0.0)
                    for e in kern) / 1e3)
            out[f"{name}_{'graph' if g else 'eager'}"] = r
    for s in sessions.values():
        s.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=1500,
                    help="walking ticks a run (standing: 2/3 of it)")
    ap.add_argument("--eager-too", type=int, default=1,
                    help="also run every session with cuda_graphs=False")
    ap.add_argument("--out", default=str(REPO / "build"
                                         / "session_latency_torch.json"),
                    help="where the JSON result is written")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("session_latency_torch: no CUDA device", file=sys.stderr)
        return 1
    import mpc_limx_control_tpu_torch  # noqa: F401  (TF32 pins)
    from mpc_limx_control_tpu_torch.core.config import ControllerConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    result = {"card": smi, "torch": torch.__version__,
              "device": torch.cuda.get_device_name(0), "runs": {}}
    result["tick_functions"] = {}
    for mode in ("walk", "stand"):
        cfg = (ControllerConfig.walking() if mode == "walk"
               else ControllerConfig.standing())
        r = tick_functions(cfg, 19380 + 10 * (mode == "stand"))
        result["tick_functions"][mode] = r
        print(json.dumps({"tick_functions": mode, **r}), flush=True)
    port = 19400
    for graphs in ((True, False) if args.eager_too else (True,)):
        for name, mode, kw, truth in RUNS:
            cfg = (ControllerConfig.walking() if mode == "walk"
                   else ControllerConfig.standing())
            iters = args.iters if mode == "walk" else 2 * args.iters // 3
            port += 2
            key = f"{name}_{'graph' if graphs else 'eager'}"
            r = run_one(cfg, iters, kw, truth, port, graphs)
            result["runs"][key] = r
            print(json.dumps({"run": key, **r}, default=float), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
