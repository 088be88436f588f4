"""Profiling and observability utilities.

Counterpart of ``mpc_limx_control_tpu.utils.profiling``:

* :class:`Timer`: wall-clock scope timer that synchronizes the card at
  both ends when given a CUDA device or tensor (kernels run after the
  host returns; a host clock without a synchronize measures the enqueue);
* :func:`measure_throughput`: solves/s and latency percentiles of any step
  function, synchronizing the card after each call when its arguments or
  results are CUDA tensors;
* :class:`MetricsLogger`: structured per-step metrics as JSON lines;
* :func:`trace`: a ``torch.profiler`` scope (CPU, and the card's kernels
  where there is one) that writes a Chrome trace;
* :func:`card`: the card's name and power limit, to keep beside a time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch


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


def measure_throughput(step_fn: Callable, args: tuple, batch: int,
                       iters: int = 10, warmup: int = 1) -> dict:
    """Time `iters` calls of step_fn(*args), the card synchronized after
    each call where the arguments or results are CUDA tensors.

    Returns dict with solves/s (batch*iters/total) and per-call latency
    stats (p50/p90/max), all in seconds.
    """
    for _ in range(warmup):
        _sync(args, step_fn(*args))
    lat = []
    for _ in range(iters):
        _sync(args)
        t0 = time.perf_counter()
        _sync(args, step_fn(*args))
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)
    total = float(lat.sum())
    return {
        "solves_per_s": batch * iters / total,
        "p50_s": float(np.percentile(lat, 50)),
        "p90_s": float(np.percentile(lat, 90)),
        "max_s": float(lat.max()),
        "total_s": total,
    }


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
