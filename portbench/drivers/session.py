"""Driver ``session``: one robot at 1 kHz through the port's
``ControlSession`` over the pf_runtime UDP wire on loopback.

The robot is portbench/plant/wire_plant.py in a process of its own on the
CPU (lockstep: it steps on each command and publishes the sensors and
the truth odometry), started from the mix's seeded perturbation. The
session (CUDA graphs of its tick functions, a warm solve every
``mpc_step`` ticks and the held force between) reads the wire through a
proxy of the benchmark's in place of ``session.link``: the proxy passes
every call on, stamps the return of ``recv_state`` and the call of
``send_cmd``, and keeps the packets and commands of the chunk being
recorded. Set-up spawns the plant, makes the session (which captures its
graphs) and runs the first chunk; the window runs ``session.run(chunk)``
until ``--seconds`` have passed. ``session.run`` counts its ticks from 0
on each call, so a chunk is one gait cycle (600 ticks) and the gait's
phase runs on without a jump.

The check replays, in the reference (float64 on the CPU), the first chunk
from the session's cold warm state and the window's last chunk from the
warm state the session held when it began (``session.qp_state``, read
between chunks), on the packets the session received, and compares every
command it sent. The plant's final state is held to the session tests'
bands.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import compare
from portbench.drivers.batched import build_config
from portbench.reference import config as rconfig
from portbench.reference import tick as rtick
from portbench.reference.precision import TF32Products
from portbench.reference.types import OdomState
from portbench.trace import Profiler

PLANT = Path(__file__).resolve().parents[1] / "plant" / "wire_plant.py"
CMD_FIELDS = (("q", slice(0, 6)), ("dq", slice(6, 12)), ("tau", slice(12, 18)),
              ("kp", slice(18, 24)), ("kd", slice(24, 30)))


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile of all samples (the smallest sample with at
    least p percent of the samples at or below it)."""
    s = sorted(xs)
    k = max(1, int(np.ceil(p / 100.0 * len(s))))
    return float(s[k - 1])


def free_udp_ports(n: int) -> list:
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class WireProxy:
    """``session.link``'s stand-in: every call goes to the link; the
    benchmark stamps state receipt and command send, counts stale polls
    (no fresh state: the session sends nothing and waits a period) and
    non-finite commands, and records a chunk's packets and commands when
    asked."""

    def __init__(self, link, mpc_every: int, prof: Profiler):
        self.link, self.mpc_every, self.prof = link, mpc_every, prof
        self.lat, self.solve = [], []
        self.stale = self.bad = self.sent = 0
        self.rec = None
        self.odom = None        # the last odometry received, as the session
        self.spans = False      # keeps it across its run() calls
        self._t = 0.0
        self._span = None

    def __getattr__(self, name):
        return getattr(self.link, name)

    def begin_chunk(self, record: bool) -> None:
        self.sent = 0
        self.rec = ({"state": [], "odom": [], "cmd": [], "odom0": self.odom}
                    if record else None)

    def end_chunk(self):
        rec, self.rec = self.rec, None
        return rec

    def recv_state(self):
        s = self.link.recv_state()
        if s is None:
            self.stale += 1
            return None
        self._t = time.perf_counter()
        if self.spans:
            self._span = self.prof.span()
            self._span.__enter__()
        if self.rec is not None:
            self.rec["state"].append(s["q"])
        return s

    def recv_odom(self):
        o = self.link.recv_odom()
        if o is not None:
            self.odom = o
        if self.rec is not None:
            self.rec["odom"].append(o)
        return o

    def send_cmd(self, q, dq=None, tau=None, kp=None, kd=None, mode=None,
                 stamp_ns: int = 0):
        t = time.perf_counter()
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        self.lat.append(t - self._t)
        self.solve.append(self.sent % self.mpc_every == 0)
        self.sent += 1
        self.link.send_cmd(q, dq=dq, tau=tau, kp=kp, kd=kd, mode=mode,
                           stamp_ns=stamp_ns)
        cmd = np.concatenate([np.asarray(v, np.float32)
                              for v in (q, dq, tau, kp, kd)])
        if not np.isfinite(cmd).all():
            self.bad += 1
        if self.rec is not None:
            self.rec["cmd"].append(cmd)


def _inputs(rec: dict, cfg) -> dict:
    """The replay's inputs [T, ...] (float32 as received): joints and the
    odometry the session used, the last one received where a tick brought
    none (also one received before the chunk; the nominal standing pose
    before any)."""
    T = len(rec["cmd"])
    q = np.stack(rec["state"][:T])
    pos, quat, vp, vo = [], [], [], []
    last = rec["odom0"]
    for o in rec["odom"][:T]:
        if o is not None:
            last = o
        if last is None:
            pos.append([0.0, 0.0, cfg.base_height])
            quat.append([0.0, 0.0, 0.0, 1.0])
            vp.append([0.0] * 3)
            vo.append([0.0] * 3)
        else:
            pos.append(last["pos"])
            quat.append(last["quat"])
            vp.append(last["v_pos"])
            vo.append(last["v_ori"])
    f = np.float32
    return {"q": q.astype(f), "pos": np.asarray(pos, f),
            "quat": np.asarray(quat, f), "v_pos": np.asarray(vp, f),
            "v_ori": np.asarray(vo, f),
            "cmd": np.stack(rec["cmd"][:T]).astype(f)}


def replay(cfg, inputs: list, warm: list, mpc_every: int, dtype,
           device="cpu") -> torch.Tensor:
    """The commands [C, T, 30] the reference sends for C recorded chunks of
    T ticks each, from the warm states (z, y) the session held when each
    began: the anchor seeded at the first tick's pose, a warm solve on
    every tick t % mpc_every == 0, the solved force held between."""
    def stack(key):
        return torch.as_tensor(np.stack([i[key] for i in inputs]),
                               device=device).to(dtype)

    q, pos, quat = stack("q"), stack("pos"), stack("quat")
    v_pos, v_ori = stack("v_pos"), stack("v_ori")
    C, T = q.shape[0], q.shape[1]
    z = torch.stack([torch.as_tensor(w[0]).reshape(-1) for w in warm]) \
        .to(device=device, dtype=dtype)
    y = torch.stack([torch.as_tensor(w[1]).reshape(-1) for w in warm]) \
        .to(device=device, dtype=dtype)
    v_des = torch.tensor(cfg.desired_velocity, dtype=dtype,
                         device=device).expand(C, 3)
    yaw_rate = torch.full((C,), float(cfg.desired_yaw_rate), dtype=dtype,
                          device=device)
    out, anchor, grf = [], None, None
    for t in range(T):
        ori = rtick.session_rpy(quat[:, t])
        odom = OdomState(pos=pos[:, t], ori=ori, quat=quat[:, t],
                         v_pos=v_pos[:, t], v_ori=v_ori[:, t])
        if t == 0:
            anchor = torch.cat([pos[:, t, :2], ori[:, 2:3]], -1)
        it = torch.full((C,), float(t), dtype=torch.float32, device=device)
        if t % mpc_every == 0:
            d = rtick.controller_tick(cfg, odom, q[:, t], it, v_des,
                                      yaw_rate, qp_warm=(z, y),
                                      ref_anchor=anchor)
            z, y = d["qp_state"]
            grf = d["grf"]
        else:
            d = rtick.controller_tick(cfg, odom, q[:, t], it, v_des,
                                      yaw_rate, grf_override=grf,
                                      ref_anchor=anchor)
        if d["anchor_next"] is not None:
            anchor = d["anchor_next"]
        out.append(torch.cat([d["q"], d["dq"], d["tau"], d["kp"], d["kd"]],
                             -1))
    return torch.stack(out, 1)


def command_gap(sent: torch.Tensor, ref: torch.Tensor) -> dict:
    return {name: compare.field_gap(sent[..., sl], ref[..., sl])
            for name, sl in CMD_FIELDS}


class Cell:
    def __init__(self, spec: dict, mix: dict, seed: int, device,
                 trace: bool = False):
        self.spec, self.mix, self.seed = spec, mix, seed
        self.device = torch.device(device)
        self.prof = Profiler(trace)
        self.chunk = int(mix["chunk"])
        self.hz = float(mix.get("hz", 1000.0))
        self.plant = None
        self.session = None

    # -- set-up ---------------------------------------------------------
    def start_plant(self, state_port: int, cmd_port: int) -> None:
        cmd = [sys.executable, str(PLANT), "--state-port", str(state_port),
               "--cmd-port", str(cmd_port), "--config", self.spec["preset"],
               "--seed", str(self.seed),
               "--perturb", json.dumps(self.mix.get("perturb", []))]
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        self.plant = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                      stdout=subprocess.PIPE, text=True,
                                      env=env)

    def wait_plant(self) -> None:
        """Wait for the plant's "up" (it loads torch while the session
        captures its graphs)."""
        if self.plant is None:
            return
        line = self.plant.stdout.readline().strip()
        if line != "up":
            raise RuntimeError(f"the plant did not start (said {line!r})")

    def setup(self) -> None:
        from mpc_limx_control_tpu_torch import runtime as wire
        from mpc_limx_control_tpu_torch.control import session as ses
        from mpc_limx_control_tpu_torch.core import config as pconfig

        wire.now_ns()       # builds the wire library before the plant loads it
        self.pcfg = build_config(pconfig, self.spec)
        self.rcfg = build_config(rconfig, self.spec)
        self.mpc_every = int(self.pcfg.gait.mpc_step)
        state_port, cmd_port = free_udp_ports(2)
        self.start_plant(state_port, cmd_port)
        self.session = ses.ControlSession(
            self.pcfg, state_port=state_port, cmd_port=cmd_port,
            device=self.device,
            cuda_graphs=self.device.type == "cuda")
        self.wait_plant()
        self.proxy = WireProxy(self.link_for(self.session), self.mpc_every,
                               self.prof)
        self.session.link = self.proxy
        warm0 = self.session.qp_state
        self.proxy.begin_chunk(record=True)
        self.session.run(self.chunk, hz=self.hz)
        self.first = ([w.cpu() for w in warm0], self.proxy.end_chunk())

    def link_for(self, session):
        """The link the proxy passes calls to: the session's own."""
        return session.link

    # -- the window -----------------------------------------------------
    def window(self, seconds: float) -> dict:
        p = self.proxy
        sync = (lambda: torch.cuda.synchronize(self.device)) \
            if self.device.type == "cuda" else (lambda: None)
        p.lat, p.solve = [], []
        p.stale = p.bad = 0
        traced = not self.prof.on
        chunks = 0
        t0 = time.perf_counter()
        while True:
            warm = self.session.qp_state
            p.begin_chunk(record=True)
            if not traced and time.perf_counter() - t0 >= seconds / 3:
                p.spans = True
                with self.prof.window(sync):
                    self.session.run(self.chunk, hz=self.hz)
                p.spans = False
                traced = True
            else:
                self.session.run(self.chunk, hz=self.hz)
            self.last = ([w.cpu() for w in warm], p.end_chunk())
            chunks += 1
            if traced and time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        lat_ms = [1e3 * x for x in p.lat]
        self.hold_ms = [x for x, s in zip(lat_ms, p.solve) if not s]
        self.solve_ms = [x for x, s in zip(lat_ms, p.solve) if s]
        sent = len(lat_ms)
        self.sent, self.stale = sent, p.stale
        return {"metrics": {"tick_p50_ms": statistics.median(lat_ms),
                            "tick_p95_ms": percentile(lat_ms, 95.0)},
                "attempted": sent, "failed": p.bad,
                "notes": {"window": f"{sent} ticks ({chunks} chunks) in "
                                    f"{wall:.6f} s, {p.stale} stale, "
                                    f"{p.bad} non-finite commands",
                          "over_period": sum(1 for x in lat_ms
                                             if x > 1e3 / self.hz)}}

    def record(self) -> dict:
        r = dict(self.prof.record)
        r["ticks"] = self.chunk
        r["hold_ms"], r["solve_ms"] = self.hold_ms, self.solve_ms
        r["sent"], r["stale"] = self.sent, self.stale
        return r

    def release(self) -> None:
        """Stop the plant and read its final state; close the session's
        wire."""
        self.plant_final = self.stop_plant()
        if self.session is not None:
            self.session.close()
            self.session = None

    def stop_plant(self):
        if self.plant is None:
            return None
        try:
            out, _ = self.plant.communicate("stop\n", timeout=30)
        except subprocess.TimeoutExpired:
            self.plant.kill()
            self.plant.communicate()
            out = ""
        self.plant = None
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        return json.loads(lines[-1]) if lines else None

    # -- the check ------------------------------------------------------
    def command_gaps(self, control=None) -> dict:
        chunks = (("start", self.first), ("last", self.last))
        inputs = [_inputs(rec, self.rcfg) for _, (_, rec) in chunks]
        warm = [w for _, (w, _) in chunks]
        with torch.no_grad():
            ref = replay(self.rcfg, inputs, warm, self.mpc_every,
                         torch.float64)
            if control == "tf32":
                with TF32Products():
                    sent = replay(self.rcfg, inputs, warm, self.mpc_every,
                                  torch.float32)
            else:
                sent = torch.as_tensor(np.stack([i["cmd"] for i in inputs]))
        return {tag: command_gap(sent[i], ref[i])
                for i, (tag, _) in enumerate(chunks)}

    def check(self, control=None) -> list:
        lim = self.mix["limits"]
        g = self.command_gaps(control)
        checks = []
        for tag, gaps in g.items():
            print(f"note gaps.{tag}: " + " ".join(
                f"{k}={v:.6g}" for k, v in gaps.items()), file=sys.stderr)
            checks.append(compare.at_most(f"cmd_gap.{tag}",
                                          max(gaps.values()),
                                          lim["cmd_gap"]))
        xi = (self.plant_final or {}).get("xi")
        q = {} if xi is None else {"height": xi[5],
                                   "tilt": max(abs(xi[0]), abs(xi[1])),
                                   "x": xi[3]}
        checks += compare.quality_checks(q, self.mix["quality"])
        return checks

    def close(self) -> None:
        if self.plant is not None:
            self.stop_plant()
        if self.session is not None:
            self.session.close()
            self.session = None
