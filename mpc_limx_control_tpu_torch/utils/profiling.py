"""Profiling and observability utilities.

Counterpart of ``mpc_limx_control_tpu.utils.profiling``:

* :class:`Timer`: wall-clock scope timer that synchronizes the card at
  both ends when given a CUDA device or tensor (kernels run after the
  host returns; a host clock without a synchronize measures the enqueue);
* :class:`TickLog`: the live session's per-tick phase log (a ring of
  preallocated arrays, always on), with a weak registry of the logs of
  open sessions (:func:`tick_logs`);
* :class:`MeshLog`: the scenario mesh's log of sharded calls (spans, the
  device times of each shard's rollout and reduction, the collectives;
  always on), one a process (:func:`mesh_log`);
* :class:`MetricsLogger`: structured per-step metrics as JSON lines;
* :func:`trace`: a ``torch.profiler`` scope (CPU, and the card's kernels
  where there is one) that writes a Chrome trace;
* :func:`card`: the card's name and power limit, to keep beside a time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import subprocess
import time
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a tree (tensors, dicts, lists,
    tuples, dataclasses)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, torch.device):
        return {tree} if tree.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in tree))
    return set()


def _sync(*trees) -> None:
    """Wait for the card(s) the trees' CUDA tensors live on."""
    for dev in _cuda_devices(list(trees)):
        torch.cuda.synchronize(dev)


class Timer:
    """``with Timer("name", x) as t: ...`` -> ``t.elapsed`` seconds; with
    a CUDA device or tensor(s) among ``on``, the card is synchronized on
    entry and exit."""

    def __init__(self, name: str = "", *on):
        self.name = name
        self.on = on
        self.elapsed = 0.0

    def __enter__(self):
        _sync(self.on)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.on)
        self.elapsed = time.perf_counter() - self._t0


# -- the live session's tick log ----------------------------------------------

# The phases of a tick, in order; a tick's eight stamps bound them.
PHASES = ("poll", "wire_in", "fill", "launch", "wait", "wire_out", "sleep")
POLL, WIRE_IN, FILL, LAUNCH, WAIT, WIRE_OUT, SLEEP = range(len(PHASES))
SPANS = tuple(f"session.{p}" for p in PHASES)
# what a tick ran: the held force, a warm solve, a cold solve; the session
# graph that a tick of each kind replays (and, on a KF tick, "est" first)
KINDS = ("hold", "solve", "cold")
HOLD, SOLVE, COLD = range(len(KINDS))
KIND_GRAPHS = ("hold", "warm", "cold")
_STAMPS = len(PHASES) + 1
_clock = time.perf_counter_ns
# torch.profiler's light record function (the one torch's compiled code
# emits): ~1 us to enter against tens of us for record_function, whose
# enter is itself a traced operator
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast
_TICK_LOGS: "weakref.WeakValueDictionary[int, TickLog]" = \
    weakref.WeakValueDictionary()
_KEYS = itertools.count()


def tick_logs() -> list:
    """The tick logs of the open sessions, oldest first (held weakly: a
    closed or collected session's log is gone)."""
    return [log for _, log in sorted(_TICK_LOGS.items())]


def _epoch_offset_ns(samples: int = 9) -> int:
    """``time.time_ns() - time.perf_counter_ns()`` from the pair of reads
    that lie closest together: added to a ``perf_counter_ns`` stamp it
    places the stamp on the Unix-epoch clock of torch.profiler's events."""
    best = None
    for _ in range(samples):
        a = _clock()
        epoch = time.time_ns()
        b = _clock()
        if best is None or b - a < best[0]:
            best = (b - a, epoch - (a + b) // 2)
    return best[1]


@dataclasses.dataclass
class Ticks:
    """Ticks of a :class:`TickLog` in the order they ran."""

    stamps: np.ndarray      # [n, 8] int64 perf_counter_ns, the phases' bounds
    kind: np.ndarray        # [n] int8, an index into KINDS
    est: np.ndarray         # [n] bool, the estimator ran
    run: np.ndarray         # [n] int32, the run() call (0: the first)
    profiled: np.ndarray    # [n] bool, a torch profiler was active
    graph_ms: np.ndarray    # [n, 2] float32 device ms of the kind's graph
                            # and of "est" (NaN: not replayed or not timed)

    def __len__(self) -> int:
        return len(self.kind)

    def phase_ms(self, phase: str) -> np.ndarray:
        """[n] milliseconds of one phase (a name of PHASES)."""
        k = PHASES.index(phase)
        return (self.stamps[:, k + 1] - self.stamps[:, k]) * 1e-6

    def latency_ns(self) -> np.ndarray:
        """[n] state receipt to the call of send_cmd: wire_in + fill +
        launch + wait + wire_out, exactly."""
        return self.stamps[:, WIRE_OUT + 1] - self.stamps[:, WIRE_IN]

    def take(self, keep) -> "Ticks":
        """The ticks that `keep` (a mask or indices) selects."""
        return Ticks(stamps=self.stamps[keep], kind=self.kind[keep],
                     est=self.est[keep], run=self.run[keep],
                     profiled=self.profiled[keep],
                     graph_ms=self.graph_ms[keep])

    def device_ms(self, graph: str) -> np.ndarray:
        """The device times of the ticks that replayed `graph` (a name of
        KIND_GRAPHS, or "est") and timed it."""
        if graph == "est":
            x = self.graph_ms[:, 1]
        else:
            x = self.graph_ms[self.kind == KIND_GRAPHS.index(graph), 0]
        return x[~np.isnan(x)]


class TickLog:
    """The per-tick phase log of a live session (``ControlSession.run``),
    always on: a ring of the last `capacity` ticks in preallocated numpy
    arrays, one row a tick.

    A tick's eight ``time.perf_counter_ns`` stamps bound its seven phases
    (PHASES): ``poll`` from the wake-up to a fresh state (diagnostics,
    ``recv_state``, stale polls), ``wire_in`` (the IMU and odometry
    reads), ``fill`` (the sensor packet and its host-to-device copy),
    ``launch`` (the graph replays and the copies around them), ``wait``
    (the device-to-host copy and the wait for the device), ``wire_out``
    (up to the call of ``send_cmd``) and ``sleep`` (``send_cmd``, the
    graphs' device times read, the rate's sleep). The tick's latency is
    wire_in to wire_out. A row also holds the tick's kind (KINDS), whether
    the estimator ran, the index of its run() call, whether a torch
    profiler was active, and the device time of each graph that the tick
    replayed and timed (the kind's, KIND_GRAPHS, and the estimator's).

    While a torch profiler is active each phase is also a record-function
    span of the profiler's named after it (SPANS), within microseconds of
    the stamps, and ``epoch_offset_ns`` (measured once) places any stamp
    on the profiler's clock. The log registers itself (:func:`tick_logs`) until
    :meth:`close`.
    """

    CAPACITY = 65536

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        # one row more than the ticks kept: the tick in progress writes
        # into a row that no reader is shown
        self._rows = rows = capacity + 1
        self.stamps = np.zeros((rows, _STAMPS), np.int64)
        # kind | est << 2 | profiled << 3 | run << 8: one store a tick
        self.info = np.zeros(rows, np.int64)
        self.graph_ms = np.full((rows, 2), np.nan, np.float32)
        self.count = 0          # ticks logged; the ring holds the last ones
        self.runs = 0           # run() calls begun
        self.epoch_offset_ns = _epoch_offset_ns()
        # the per-tick stores go through flat memoryviews of the arrays
        # (a fraction of a numpy item store's cost)
        self._st = memoryview(self.stamps.reshape(-1))
        self._info = memoryview(self.info)
        self._gms = memoryview(self.graph_ms.reshape(-1))
        self._row = self._base = 0
        self._profiling = False
        self._span = None
        self._key = next(_KEYS)
        _TICK_LOGS[self._key] = self

    # -- the stamps of a tick, in order
    @contextlib.contextmanager
    def running(self):
        """The scope of a run() call: its first tick wakes up on entry; the
        span left open is closed on exit."""
        self.runs += 1
        self._open_row(self._wake_up())
        try:
            yield self
        finally:
            if self._span is not None:
                self._span.__exit__(None, None, None)
                self._span = None

    def mark(self, phase: int) -> None:
        """`phase` (an index into PHASES) begins now."""
        if self._span is None:
            self._st[self._base + phase] = _clock()
        else:
            # the next span is entered before the stamp and the last one
            # left after it: the profiler stamps a span's start at the end
            # of its enter and its end at the start of its exit
            span = _RecordFunctionFast(SPANS[phase])
            span.__enter__()
            self._st[self._base + phase] = _clock()
            self._span.__exit__(None, None, None)
            self._span = span

    def device(self, ms: float, est_ms: float = math.nan) -> None:
        """The device times of this tick's graph (its kind's) and of the
        estimator's graph (NaN: not replayed). A log that is given none
        keeps NaN in every row."""
        self._gms[2 * self._row] = ms
        self._gms[2 * self._row + 1] = est_ms

    def end(self, kind: int, est: bool) -> None:
        """The tick's sleep ends, the next tick's poll begins: commit the
        row."""
        if self._span is None and \
                not _autograd_profiler._is_profiler_enabled:
            t = _clock()                # (_wake_up's path with no spans)
        else:
            t = self._wake_up()
        self._st[self._base + _STAMPS - 1] = t
        self._info[self._row] = (kind | est << 2 | self._profiling << 3
                                 | (self.runs - 1) << 8)
        self.count += 1
        self._open_row(t)

    def _wake_up(self) -> int:
        """The wake-up's stamp; with a profiler active the poll span is
        entered (as in mark)."""
        span = None
        if _autograd_profiler._is_profiler_enabled:
            span = _RecordFunctionFast(SPANS[POLL])
            span.__enter__()
        t = _clock()
        if self._span is not None:
            self._span.__exit__(None, None, None)
        self._span = span
        return t

    def _open_row(self, t: int) -> None:
        self._row = i = self.count % self._rows
        self._base = i * _STAMPS
        self._st[self._base] = t
        self._profiling = self._span is not None

    # -- reading
    def view(self, first_run: int = 0) -> Ticks:
        """The logged ticks still in the ring, in order, of run() calls
        from `first_run` on."""
        n = min(self.count, self.capacity)
        idx = np.arange(self.count - n, self.count) % self._rows
        info = self.info[idx]
        ticks = Ticks(stamps=self.stamps[idx],
                      kind=(info & 3).astype(np.int8), est=(info & 4) != 0,
                      run=(info >> 8).astype(np.int32),
                      profiled=(info & 8) != 0, graph_ms=self.graph_ms[idx])
        return ticks.take(ticks.run >= first_run)

    def close(self) -> None:
        """Leave the registry (the arrays stay readable)."""
        _TICK_LOGS.pop(self._key, None)


# -- the scenario mesh's call log ---------------------------------------------

# a sharded call's two host spans: each shard's enqueue, then the
# statistics' reduction and collectives
MESH_SPANS = ("mesh.rollout", "mesh.reduce")


@dataclasses.dataclass
class MeshCalls:
    """Calls of a :class:`MeshLog` in the order they ran, one row a call.
    Device times are NaN on CPU shards and past a call's own shards."""

    profiled: np.ndarray       # [n] bool, a torch profiler was active
    collectives: np.ndarray    # [n] int32, all_reduce calls made
    reduced_bytes: np.ndarray  # [n] int64, bytes those calls reduced
    rollout_ms: np.ndarray     # [n, shards] float64, each shard's step or
                               # rollout on its stream
    reduce_ms: np.ndarray      # [n, shards] float64, the reduction and
                               # collectives on each shard's stream

    def __len__(self) -> int:
        return len(self.profiled)


class MeshCall:
    """One sharded call being logged (made by :meth:`MeshLog.call`): on
    each CUDA shard's current stream a pair of timing events around the
    shard's work (:meth:`shard`) and a pair around the reduction
    (:meth:`reducing` to the call's end); the collectives counted by
    :meth:`collective`."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.events = [[None] * 4 for _ in self.devices]
        self.collectives = self.reduced_bytes = 0
        self.profiled = bool(_autograd_profiler._is_profiler_enabled)
        self._span = None
        self._switch(0)

    def _switch(self, k) -> None:
        """Close the open span; with a profiler active open MESH_SPANS[k]
        (None: open none)."""
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        if k is not None and self.profiled:
            self._span = _RecordFunctionFast(MESH_SPANS[k])
            self._span.__enter__()

    def _record(self, j: int, k: int) -> None:
        d = self.devices[j]
        if d.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(d):
                ev.record(torch.cuda.current_stream(d))
            self.events[j][k] = ev

    @contextlib.contextmanager
    def shard(self, j: int):
        """The scope of shard j's step or rollout."""
        self._record(j, 0)
        yield
        self._record(j, 1)

    def reducing(self) -> None:
        """Every shard's work is enqueued; the reduction begins."""
        for j in range(len(self.devices)):
            self._record(j, 2)
        self._switch(1)

    def collective(self, nbytes: int) -> None:
        self.collectives += 1
        self.reduced_bytes += int(nbytes)

    def _end(self) -> None:
        for j in range(len(self.devices)):
            self._record(j, 3)
        self._switch(None)

    def done(self) -> bool:
        """Whether every event has completed (a query, no wait)."""
        return all(ev is None or ev.query() for evs in self.events
                   for ev in evs)

    def device_ms(self) -> tuple:
        """(each shard's work, each shard's reduction) in device ms, NaN
        where untimed; waits for the events."""
        def ms(a, b):
            if a is None or b is None:
                return math.nan
            b.synchronize()
            return a.elapsed_time(b)

        return (tuple(ms(e[0], e[1]) for e in self.events),
                tuple(ms(e[2], e[3]) for e in self.events))


class MeshLog:
    """The log of the scenario mesh's sharded calls in this process
    (``parallel.mesh``: every sharded step and rollout, both styles),
    always on: the last CAPACITY calls.

    While a torch profiler is active a call's host work is two
    record-function spans (MESH_SPANS): ``mesh.rollout``, each shard's
    step or rollout enqueued, and ``mesh.reduce``, the statistics reduced
    and their collectives (``all_reduce`` over the processes) enqueued. On
    each CUDA shard's stream two pairs of timing events give the device
    time of the shard's work and of the reduction; with one process a
    card, the reduction's time on a card includes its wait for the slowest
    peer. The events are read once they have completed, at a later call or
    at :meth:`view`: the log adds no synchronization to the call. A row
    also holds whether a profiler was active, the collectives made and the
    bytes they reduced.
    """

    CAPACITY = 4096

    def __init__(self):
        self._rows = collections.deque(maxlen=self.CAPACITY)
        self._pending = collections.deque()

    @contextlib.contextmanager
    def call(self, devices):
        """The scope of one sharded call over `devices`, the mesh's
        shards; a call that raises is not logged."""
        self._resolve(wait=False)
        c = MeshCall(devices)
        try:
            yield c
        except BaseException:
            c._switch(None)
            raise
        c._end()
        self._pending.append(c)

    def _resolve(self, wait: bool) -> None:
        """Move the calls whose events have completed (all, with `wait`)
        into the ring, in order."""
        while self._pending and (wait or self._pending[0].done()):
            c = self._pending.popleft()
            roll, red = c.device_ms()
            self._rows.append((c.profiled, c.collectives, c.reduced_bytes,
                               roll, red))

    def clear(self) -> None:
        """Forget every call logged so far."""
        self._rows.clear()
        self._pending.clear()

    def view(self) -> MeshCalls:
        """The logged calls in the ring, in order (waits for their
        events)."""
        self._resolve(wait=True)
        rows = list(self._rows)
        width = max((len(r[3]) for r in rows), default=0)

        def padded(col):
            out = np.full((len(rows), width), np.nan)
            for i, r in enumerate(rows):
                out[i, :len(r[col])] = r[col]
            return out

        return MeshCalls(
            profiled=np.array([r[0] for r in rows], bool),
            collectives=np.array([r[1] for r in rows], np.int32),
            reduced_bytes=np.array([r[2] for r in rows], np.int64),
            rollout_ms=padded(3), reduce_ms=padded(4))


@functools.lru_cache(maxsize=None)
def mesh_log() -> MeshLog:
    """This process's log of the mesh's sharded calls (made at first
    use)."""
    return MeshLog()


class MetricsLogger:
    """Append structured per-step metrics as JSON lines (tensors on any
    device, numpy arrays and scalars)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            if hasattr(v, "tolist"):
                v = np.asarray(v)
                rec[k] = v.tolist() if v.ndim else float(v)
            else:
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """``torch.profiler`` scope over the CPU and, where there is one, the
    card; on exit writes ``trace.json`` (Chrome trace format) into
    `log_dir`. Yields the profiler (``key_averages()`` for sums by
    operator and kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    of the first card ("" where there is none): a card set below its
    power maximum runs slower under load."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else ""
