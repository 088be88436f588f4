"""The traced run's record: device intervals and host operators from
torch.profiler, and the interval arithmetic the per-layer metrics use.

A record is a plain dict, so a metric can be tested on a synthetic one:

* ``window``: (start_us, end_us) of the traced window;
* ``device``: [(name, start_us, end_us)] of every device operation in it
  (kernels, copies, fills);
* ``host``: [(name, start_us, end_us)] of the host operators in it;
* ``spans``: [(start_us, end_us)] of the benchmark's own spans (a session
  tick from state receipt to command handed to the wire), where a cell
  has them;
* cell entries that a driver adds (ticks traced, latencies, the bound of
  the window's work).

Nothing is written to disk: the profiler's events are read in memory and
only the numbers the metrics need are kept.
"""

from __future__ import annotations

import bisect
import contextlib

WINDOW = "portbench.window"
SPAN = "portbench.span"
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel launch (not a copy or fill the
    copy engines run)."""
    return not name.startswith(_NOT_KERNELS)


def merge(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] covered by the union of the intervals."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in merge(intervals))


def busy_us(record: dict) -> float:
    """Time in the window in which some operation ran on the device."""
    lo, hi = record["window"]
    return covered([(s, e) for _, s, e in record["device"]], lo, hi)


def gaps(record: dict) -> list:
    """Idle stretches of the device in the window: [(start, end)]."""
    lo, hi = record["window"]
    out, t = [], lo
    for s, e in merge([(max(s, lo), min(e, hi))
                       for _, s, e in record["device"]]):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps by
    what the host was doing: the innermost host operator running at the
    gap's middle ("python" where none runs: the interpreter, or a sleep),
    each summed by name, in seconds."""
    dev: dict = {}
    for name, s, e in record["device"]:
        dev[name] = dev.get(name, 0.0) + (e - s)
    host = sorted(record["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle: dict = {}
    for gs, ge in gaps(record):
        mid = 0.5 * (gs + ge)
        best, best_len = "python", float("inf")
        i = bisect.bisect_right(starts, mid)
        # operators that start before the middle (a few hundred back: an
        # operator a host runs for longer than that is an outer one)
        for name, s, e in host[max(0, i - 400):i]:
            if e >= mid and e - s < best_len:
                best, best_len = name, e - s
        idle[best] = idle.get(best, 0.0) + (ge - gs)

    def top_of(d):
        return [[k[:120], v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(dev), "idle_gaps": top_of(idle)}


def _events(prof):
    """(name, is_device, start_us, end_us) of every profiler event, read
    from the raw results (the event tree that ``prof.events()`` builds
    takes tens of seconds over a session chunk's events)."""
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        yield (ev.name(), str(ev.device_type()).endswith("CUDA"), start,
               start + ev.duration_ns() / 1e3)


def read_profile(prof) -> dict:
    """The record of a profiler run whose traced ticks sat inside one
    ``record_function(WINDOW)``; every ``record_function(SPAN)`` becomes a
    span."""
    device, host, spans, window = [], [], [], None
    for name, on_device, s, e in _events(prof):
        if on_device:
            # the profiler mirrors each record_function on the device's
            # timeline as an annotation: not an operation
            if name not in (WINDOW, SPAN):
                device.append((name, s, e))
        elif name == WINDOW:
            window = (s, e)
        elif name == SPAN:
            spans.append((s, e))
        else:
            host.append((name, s, e))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW!r} span")
    lo, hi = window
    return {"window": window,
            "device": [d for d in device if d[2] > lo and d[1] < hi],
            "host": [h for h in host if h[2] > lo and h[1] < hi],
            "spans": [p for p in spans if p[1] > lo and p[0] < hi]}


class Profiler:
    """torch.profiler over one window of a traced run (CPU and CUDA
    activity), or nothing when tracing is off. ``window()`` brackets the
    traced work; the work inside ends in a device synchronization."""

    def __init__(self, on: bool):
        self.on = on
        self.record = None

    @contextlib.contextmanager
    def window(self, sync):
        if not self.on:
            yield
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
                sync()
        self.record = read_profile(prof)

    def span(self):
        """A span of the benchmark's own (a context manager); a no-op when
        tracing is off."""
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN)
