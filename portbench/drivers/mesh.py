"""Driver ``mesh``: the batched walking loop as a deployment over several
cards, one process a card, through the port's scenario mesh
(``parallel/mesh.sharded_rollout`` -> ``batched_rollout_resident`` ->
the tick kernel), the statistics of the global batch reduced over NCCL
after every chunk.

Rank 0 is the benchmark's own process, on card 0; at set-up it starts
ranks 1 .. P - 1 (the mix's ``processes``) as processes of this file on a
loopback coordinator. Every rank calls ``initialize_multihost`` and
``make_mesh()`` (card ``rank % cards``), builds the same seeded global
start (``drivers/batched.perturbed_start``: the mix's batch,
stagger and perturbation) and keeps its block of rows. Rank 0 loads the
kernel library first (a fresh checkout builds it once), then the others.
Set-up runs one chunk on every rank.

The window runs chunks of ``sharded_rollout`` with the full statistics,
the state carried as a ``Sharded``. After each chunk rank 0 reads the
reduced statistics to the host, as a pipeline that logs them would, and
tells the other ranks whether to go on (a broadcast over gloo). The
window ends with a synchronize on every rank and a barrier;
``scenario_ticks_per_s`` is the global batch times the ticks run over the
window on rank 0's clock. With ``--trace 1`` rank 0 alone runs the
profiler over ``trace_chunks`` chunks a third of the way in. At the
window's end the ranks' mesh logs of the window's calls
(``utils.profiling.mesh_log``: each call's device times of the rollout
and of the collectives, and whether a profiler was active) are gathered
for the per-layer metrics.

The check: each rank runs the reference (portbench/reference, float64)
on ``check_sample`` seeded scenarios of its rows for the first chunk from
the start and for the window's last chunk from the state the program
carried into it, as the batched driver does, at the same limits; rank 0
takes the widest gap over the ranks. Rank 0 gathers every scenario's
per-tick height, residual and force of both chunks and holds the mesh's
statistics to portbench/reference/stats.py over the global batch.
``failed`` counts the scenarios gone non-finite over the global batch;
the quality bands are the mix's.

No wait outlasts a run: rank 0 kills the other ranks at ``close()`` and
exits at once when one of them fails; a rank exits when rank 0's process
goes away.

    python3 portbench/drivers/mesh.py --rank R --port N --seed S
        --spec JSON --mix JSON [--device cuda|cpu]
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from portbench import compare, work  # noqa: E402
from portbench.drivers import batched  # noqa: E402
from portbench.reference import stats as rstats  # noqa: E402
from portbench.trace import Profiler  # noqa: E402

RUN, TRACE, STOP = 0, 1, 2
# a rank's life at most, past which it exits (rank 0 ends a run long before)
LIFETIME_S = 1800.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Cell(batched.Cell):
    def __init__(self, spec: dict, mix: dict, seed: int, device,
                 trace: bool = False, rank: int = 0, port: int = 0):
        super().__init__(spec, mix, seed, device, trace=False)
        self.rank, self.port = rank, port
        self.processes = int(mix["processes"])
        self.batch = self.B
        if self.batch % self.processes:
            raise ValueError(f"a batch of {self.batch} does not divide over "
                             f"{self.processes} processes")
        self.B = self.batch // self.processes       # this rank's rows
        if self.mpc_every != 1:
            raise ValueError("the mesh's rollout solves every tick: "
                             f"mpc_every must be 1, got {self.mpc_every}")
        self.prof = Profiler(trace and rank == 0)
        self.procs, self.logs, self.logdir = [], [], None
        self.finished = False
        self.mesh_ranks = None
        self._watching = False

    # -- processes --------------------------------------------------------
    def _spawn(self) -> None:
        """Start ranks 1 .. P - 1, and a thread that ends this process at
        once when one of them fails."""
        self.port = self.port or _free_port()
        self.logdir = tempfile.mkdtemp(prefix="portbench_mesh_")
        for r in range(1, self.processes):
            log = open(Path(self.logdir) / f"rank{r}.log", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--rank", str(r), "--port", str(self.port),
                 "--seed", str(self.seed), "--device", self.device.type,
                 "--spec", json.dumps(self.spec), "--mix",
                 json.dumps(self.mix)],
                cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT))
        self._watching = True
        threading.Thread(target=self._watch_ranks, daemon=True).start()

    def _tails(self) -> str:
        out = []
        for r in range(1, self.processes):
            p = Path(self.logdir or "") / f"rank{r}.log"
            if p.is_file():
                out.append(f"--- rank {r}:\n{p.read_text()[-3000:]}")
        return "\n".join(out)

    def _watch_ranks(self) -> None:
        while self._watching:
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc not in (None, 0) and self._watching:
                    print(f"portbench mesh: rank {r} exited with {rc}\n"
                          f"{self._tails()}", file=sys.stderr, flush=True)
                    self._kill()
                    os._exit(5)
            time.sleep(0.2)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    # -- collectives of the benchmark's own (gloo: host values) -----------
    def _barrier(self) -> None:
        dist.all_reduce(torch.zeros(1))

    def _bcast(self, cmd: int) -> int:
        t = torch.tensor([cmd], dtype=torch.int64)
        dist.broadcast(t, src=0)
        return int(t[0])

    def _sum(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """A value reduced over the ranks where the mesh reduces (NCCL
        between cards, gloo where ranks share a card)."""
        x = x.to(self.mesh.reduce_device, copy=True)
        dist.all_reduce(x, op=op)
        return x

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from mpc_limx_control_tpu_torch.control import rollout as ro
        from mpc_limx_control_tpu_torch.core import config as pconfig
        from mpc_limx_control_tpu_torch.parallel import mesh as pmesh
        from portbench.reference import config as rconfig

        self.ro, self.pmesh = ro, pmesh
        self.pcfg = batched.build_config(pconfig, self.spec)
        self.rcfg = batched.build_config(rconfig, self.spec)
        if self.rank == 0:
            # a program whose mesh takes only one start for all the
            # scenarios fails here, before any process starts
            two = ro.initial_plant_state(self.pcfg, batch=(2,),
                                         device="cpu")
            pmesh.sharded_rollout(self.pcfg, pmesh.make_mesh(["cpu"]), 1)(
                two, torch.tensor([0.0, 300.0]))
            self._spawn()
        cuda = self.device.type == "cuda"
        pmesh.initialize_multihost(f"127.0.0.1:{self.port}", self.processes,
                                   self.rank)
        # one process a card (one process alone: card 0)
        self.mesh = pmesh.make_mesh(
            None if cuda and self.processes > 1
            else [self.device if cuda else "cpu"])
        self.device = self.mesh.devices[0]
        if cuda:
            torch.cuda.set_device(self.device)
        if self.mesh.size != self.processes:
            raise RuntimeError(f"a mesh of {self.mesh.size} shards for "
                               f"{self.processes} processes")
        self.lo = self.rank * self.B
        self.gen = batched.generator(self.seed, self.device)
        s_in, self.it0 = batched.perturbed_start(self.rcfg, self.mix,
                                                 self.gen, self.device)
        start = ro.PlantState(**{f: getattr(s_in, f)
                                 for f in batched.PORT_STATE})
        if cuda:
            from mpc_limx_control_tpu_torch.ops import _build

            # rank 0 builds the kernel library of a fresh checkout, alone
            if self.rank == 0:
                _build.build_library()
            self._barrier()
            if self.rank != 0:
                _build.build_library()
        self.program_step = pmesh.sharded_rollout(
            self.pcfg, self.mesh, self.chunk, return_metrics=True)
        self._reduce_init()
        self.first = self._run_chunk(start, 0)
        self.s = self.first[3]
        self._sync()
        self._barrier()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_chunk(self, state, k: int):
        """Chunk k of the global batch from `state` (the global start, or
        the Sharded state carried); rank 0 reads the statistics to the
        host. Returns (this rank's rows of the state handed in, their
        start iterations, their metrics, the Sharded state after, the
        statistics)."""
        it = self.it0 + float(k * self.chunk)
        out, st, m = self.program_step(state, it)
        rows = slice(self.lo, self.lo + self.B)
        s_in = (state.parts[0] if isinstance(state, self.pmesh.Sharded)
                else self.ro._map_state(state, lambda x: x[rows]))
        self._reduce(m.parts[0], out.parts[0])
        if self.rank == 0:
            self.stats_host = {n: v.cpu() for n, v in st.items()}
        return s_in, it[rows], m.parts[0], out, st

    # -- the window -------------------------------------------------------
    def window(self, seconds) -> dict:
        """Rank 0 times `seconds` and leads; the other ranks follow its
        word (`seconds` unused)."""
        from mpc_limx_control_tpu_torch.utils import profiling

        log = getattr(profiling, "mesh_log", None)
        log = log() if log else None
        self._reduce_init()
        if log is not None:
            log.clear()
        trace_chunks = int(self.mix.get("trace_chunks", 2))
        s, k, chunks, traced = self.s, 1, 0, not self.prof.on
        self._sync()
        self._barrier()
        t0 = time.perf_counter()
        while True:
            cmd = RUN
            if self.rank == 0:
                el = time.perf_counter() - t0
                if not traced and el >= seconds / 3:
                    cmd = TRACE
                elif traced and el >= seconds:
                    cmd = STOP
            cmd = self._bcast(cmd)
            if cmd == STOP:
                break
            n = trace_chunks if cmd == TRACE else 1
            with self.prof.window(self._sync) if cmd == TRACE \
                    else contextlib.nullcontext():
                for _ in range(n):
                    last = self._run_chunk(s, k)
                    s, k, chunks = last[3], k + 1, chunks + 1
            traced = traced or cmd == TRACE
        self._sync()
        self._barrier()
        wall = time.perf_counter() - t0
        self.last = last[:4]
        self.last_stats = last[4]
        self.s = s
        ticks = chunks * self.chunk
        a = self.acc
        n_rows = self.batch * ticks
        height_sum = float(self._sum(a["height_sum"]))
        vx_sum = float(self._sum(a["vx_sum"]))
        height_min = float(self._sum(a["height_min"], dist.ReduceOp.MIN))
        failed = int(self._sum(a["bad"].sum()))
        m = last[2]
        vx_last = float(self._sum(m["velocity"][..., 0].sum(
            dtype=torch.float64))) / (self.batch * self.chunk)
        self.quality = {
            "height_min": height_min,
            "height_mean": float(self.last_stats["mean_height"].to(
                torch.float64).mean()),
            "vx_mean": vx_last}
        self.window_ticks = ticks
        self._gather_logs(log)
        return {"metrics": {"scenario_ticks_per_s": n_rows / wall},
                "attempted": self.batch, "failed": failed,
                "notes": {"window": f"{ticks} ticks x {self.batch} "
                                    f"scenarios on {self.processes} "
                                    f"processes in {wall:.6f} s "
                                    f"({chunks} chunks)",
                          "quality": self.quality,
                          "height_mean_window": height_sum / n_rows,
                          "vx_mean_window": vx_sum / n_rows}}

    def _gather_logs(self, log) -> None:
        """Every rank's log of the window's calls (this rank's shard), to
        rank 0."""
        mine = None
        if log is not None:
            calls = log.view()
            mine = {"rollout_ms": calls.rollout_ms[:, :1].ravel().tolist(),
                    "reduce_ms": calls.reduce_ms[:, :1].ravel().tolist(),
                    "profiled": calls.profiled.tolist()}
        got = [None] * self.processes
        dist.all_gather_object(got, mine)
        self.mesh_ranks = None if any(g is None for g in got) else got

    def record(self) -> dict:
        r = dict(self.prof.record or {})
        c = self.pcfg
        r["ticks"] = int(self.mix.get("trace_chunks", 2)) * self.chunk
        r["bound_ms_per_tick"] = work.mean_tick_bound_ms(
            3 if c.mode == "walk" else 6, c.srbd.horizon,
            c.srbd.solver.admm_warm_iters, self.B, self.mpc_every)
        if self.mesh_ranks is not None:
            r["mesh_ranks"] = self.mesh_ranks
        return r

    def release(self) -> None:
        self.s = None
        self.acc = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    def sample(self) -> torch.Tensor:
        """This rank's ``check_sample`` scenarios, drawn from the seed and
        the rank."""
        n = min(int(self.mix["check_sample"]), self.B)
        gen = torch.Generator(device="cpu")
        gen.manual_seed((int(self.seed) + 1 + self.rank) % (2 ** 63))
        return torch.randperm(self.B, generator=gen)[:n].sort().values.to(
            self.device)

    def _gathered(self, m: dict) -> tuple:
        """Every rank's per-tick height, residual and force, in the global
        batch's order."""
        mine = torch.cat([m["height"][..., None], m["qp_residual"][..., None],
                          m["grf"]], -1).to(self.mesh.reduce_device)
        parts = [torch.empty_like(mine) for _ in range(self.processes)]
        dist.all_gather(parts, mine)
        allm = torch.cat(parts).to(self.device)
        return allm[..., 0], allm[..., 1], allm[..., 2:8]

    def check(self, control=None) -> list:
        lim = self.mix["limits"]
        notes = {}
        idx = self.sample()
        stat_gaps, self.without_a_rank = {}, {}
        for tag, chunk, prog in (("start", self.first, self.first[4]),
                                 ("last", self.last, self.last_stats)):
            s_in, it, m, s_out = chunk[:4]
            s_out = s_out.parts[0]
            g = self.chunk_gaps(
                self.ro._map_state(s_in, lambda x: x[idx]), it[idx],
                {k: v[idx] for k, v in m.items()},
                self.ro._map_state(s_out, lambda x: x[idx]), control)
            notes[tag] = g
            h, r, f = self._gathered(m)
            if self.rank == 0:
                if control == "tf32":
                    # the mesh's arithmetic in float16 in its place
                    prog = self.pmesh.scenario_stats(
                        {"height": h.half(), "qp_residual": r.half(),
                         "grf": f.half()})
                stat_gaps[tag] = rstats.gaps(prog, h, r, f)
                if self.processes > 1:
                    # a reduction that left out the last rank's rows
                    part = slice(0, self.batch - self.B)
                    self.without_a_rank[tag] = rstats.gaps(
                        self.pmesh.scenario_stats({"height": h[part],
                                                   "qp_residual": r[part],
                                                   "grf": f[part]}),
                        h, r, f)
            del h, r, f
        got = [None] * self.processes
        dist.all_gather_object(got, notes)
        self.finished = True
        if self.rank != 0:
            return []
        checks = []
        for tag in ("start", "last"):
            g = {k: max(n[tag][k] for n in got) for k in got[0][tag]}
            state = max(v for k, v in g.items()
                        if k in batched.PER_TICK or k.startswith("final."))
            checks += [
                compare.at_most(f"force_gap.{tag}", g["grf"],
                                lim["force_gap"]),
                compare.at_most(f"residual_gap.{tag}", g["qp_residual"],
                                lim["residual_gap"]),
                compare.at_most(f"state_gap.{tag}", state, lim["state_gap"])]
            sg = stat_gaps[tag]
            checks += [
                compare.at_most(f"mean_height_gap.{tag}", sg["mean_height"],
                                lim["stats_gap"]),
                compare.at_most(f"grf_mean_fz_gap.{tag}", sg["grf_mean_fz"],
                                lim["stats_gap"]),
                compare.at_most(f"max_qp_residual_gap.{tag}",
                                sg["max_qp_residual"], 0.0),
                compare.at_most(f"best_scenario_gap.{tag}",
                                sg["best_scenario"], lim["stats_gap"])]
        checks += compare.quality_checks(self.quality, self.mix["quality"])
        for tag in ("start", "last"):
            print(f"note gaps.{tag}: " + " ".join(
                f"{k}={max(n[tag][k] for n in got):.6g}"
                for k in got[0][tag]), file=sys.stderr)
            print(f"note stats.{tag}: " + " ".join(
                f"{k}={v:.6g}" for k, v in stat_gaps[tag].items()) +
                " | without a rank: " + " ".join(
                f"{k}={v:.6g}" for k, v in
                self.without_a_rank.get(tag, {}).items()), file=sys.stderr)
        return checks

    def close(self) -> None:
        """After a finished check, every rank leaves the process group
        together and rank 0 waits for the others to exit; else rank 0
        kills them at once."""
        self._watching = False
        if self.finished:
            self._barrier()
        else:
            self._kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.procs:
            deadline = time.time() + 30.0
            for p in self.procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    pass
            self._kill()
        for log in self.logs:
            log.close()
        if self.logdir:
            for p in Path(self.logdir).glob("*"):
                p.unlink()
            os.rmdir(self.logdir)
            self.logdir = None


def _watch_parent(parent: int) -> None:
    """Exit at once when the process that started this rank goes away, or
    past LIFETIME_S."""
    end = time.monotonic() + LIFETIME_S

    def watch():
        while os.getppid() == parent and time.monotonic() < end:
            time.sleep(0.5)
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="one rank of the mesh driver")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--mix", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _watch_parent(os.getppid())
    cell = Cell(json.loads(args.spec), json.loads(args.mix), args.seed,
                torch.device(args.device), rank=args.rank, port=args.port)
    try:
        cell.setup()
        cell.window(None)
        cell.release()
        cell.check()
    finally:
        cell.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
