"""The session cell's robot: a single-scenario SRBD plant on the CPU that
speaks the pf_runtime wire, in a process of its own.

A frozen copy of the WirePlant of the port's session tests (its step
driven by a received joint command: the stance force reconstructed from
the commanded stance torques, f_body = -(J^T)^-1 tau, the SRBD stepped,
the swing leg executing its command and the stance foot pinned), its step
in float64 numpy (portbench/plant/dynamics.py). It waits for a command,
steps, and publishes the joints, the IMU and the truth odometry; while no
command comes it republishes the last packet every 10 ms, so a lost
datagram cannot stall the lockstep loop. Its start is the standing pose
with the mix's seeded perturbation of the base state.

    python3 portbench/plant/wire_plant.py --state-port P --cmd-port Q
        --config walking --seed N [--perturb JSON]

It prints "up" once its end of the wire is bound, runs until it reads a
line on standard input, then prints one JSON line (the final SRBD state
and the steps taken) and exits.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.plant import dynamics  # noqa: E402
from portbench.reference import config as rconfig  # noqa: E402
from portbench.reference import tick as rtick  # noqa: E402


def start_state(cfg, seed: int, perturb: list):
    """The standing pose with the seeded perturbation of xi, float64."""
    s = rtick.initial_state(cfg, 1, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    xi = s.xi.clone()
    for p in perturb:
        if p["dist"] == "normal":
            d = p["scale"] * torch.randn(1, generator=gen)
        else:
            d = p["low"] + (p["high"] - p["low"]) * torch.rand(
                1, generator=gen)
        xi[:, int(p["index"])] += d
    return tuple(t[0].double().numpy() for t in (xi, s.q, s.foot_l,
                                                 s.foot_r))


POLL_S = 50e-6      # the wait between polls while no command has come


class Plant:
    """The lockstep loop: wait for a command, step, publish. The wait
    polls every ``POLL_S`` with a sleep between, not in a busy loop: the
    robot stands in for a machine of its own, so it takes next to no core
    of the host the session runs on (a spinning poll holds a core whole,
    and on an 8-core H100 host the session's tick latencies then spread
    about twice as widely from run to run)."""

    def __init__(self, host, cfg, seed: int, perturb: list):
        self.host = host
        self.step = dynamics.make_step(cfg)
        self.xi, self.q, self.foot_l, self.foot_r = start_state(
            cfg, seed, perturb)
        self.quat = dynamics.rpy_to_quat(self.xi[0:3])
        self.acc = np.asarray([0, 0, 9.81], np.float32)
        self.gyro = np.zeros(3, np.float32)
        self.dq = np.zeros(6, np.float32)
        self.steps = 0

    def publish(self, now_ns) -> None:
        xi = self.xi
        stamp = now_ns()
        self.host.publish_state(self.q, dq=self.dq,
                                quat=self.quat, acc=self.acc,
                                gyro=self.gyro, stamp_ns=stamp)
        self.host.publish_odom(pos=xi[3:6], quat=self.quat, v_pos=xi[9:12],
                               v_ori=xi[6:9], stamp_ns=stamp)

    def loop(self, stop: threading.Event, now_ns) -> None:
        self.publish(now_ns)
        last = time.monotonic()
        while not stop.is_set():
            cmd = self.host.poll_cmd()
            if cmd is None:
                if time.monotonic() - last > 0.01:
                    self.publish(now_ns)
                    last = time.monotonic()
                time.sleep(POLL_S)
                continue
            self.apply(cmd, now_ns)
            last = time.monotonic()

    def apply(self, cmd: dict, now_ns) -> None:
        """Step on one received command and publish the sensors."""
        (self.xi, self.q, self.foot_l, self.foot_r, self.quat, self.acc,
         self.gyro, self.dq) = self.step(
            self.xi, self.q, self.foot_l, self.foot_r,
            *(np.asarray(cmd[k], np.float64) for k in ("q", "tau", "kp")))
        self.steps += 1
        self.publish(now_ns)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--state-port", type=int, required=True)
    ap.add_argument("--cmd-port", type=int, required=True)
    ap.add_argument("--config", required=True,
                    help="a ControllerConfig preset (walking, standing)")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--perturb", default="[]")
    args = ap.parse_args(argv)
    from mpc_limx_control_tpu_torch import runtime as wire

    cfg = getattr(rconfig.ControllerConfig, args.config)()
    host = wire.RobotHost(state_port=args.state_port,
                          cmd_port=args.cmd_port)
    plant = Plant(host, cfg, args.seed, json.loads(args.perturb))
    stop = threading.Event()
    worker = threading.Thread(target=plant.loop, args=(stop, wire.now_ns),
                              daemon=True)
    worker.start()
    print("up", flush=True)
    sys.stdin.readline()
    stop.set()
    worker.join(timeout=10.0)
    host.close()
    print(json.dumps({"xi": [float(v) for v in plant.xi],
                      "steps": plant.steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
