"""CUDA graphs of the port's host loops, with true launch counts.

A tick at B = 1 is a few hundred small launches whose host cost is far
above their device time (PERF.md §5). :class:`Graph` captures such a
function once and replays it as one launch: the counterpart of a
``jax.jit`` closure or a ``lax.scan`` body on the TPU. The function reads
and writes tensors whose addresses stay fixed (static buffers); whatever
it allocates lives in the graph's own memory pool.

A kernel launch made while capturing is recorded, not run: the graph takes
it off the wrapper's counter (``ops/_build.Kernel``) and adds it back at
every replay, so ``launches`` keeps counting the launches that run.
A capture that fails raises; nothing falls back to eager launches. The
cyclic garbage collector is off while capturing: a collection then could
free another graph (a session is a reference cycle), and destroying a
graph is a CUDA call that invalidates the capture in progress.

A capture is ``torch.cuda.graph``'s less its emptying of the caching
allocators: the card is synchronized, then the function is captured on a
side stream of the graph's card (one a card). The resident rollout
captures a graph every call; there emptying the caches freed and
re-allocated every cached block each call (~0.5 GB a 100-tick chunk at
16,384 scenarios, tens of milliseconds of ``cudaFree`` / ``cudaMalloc``).
"""

from __future__ import annotations

import functools
import gc

import torch

from mpc_limx_control_tpu_torch.ops import _build


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream that graphs of `device` are captured on."""
    return torch.cuda.Stream(device)


class Graph:
    """`fn()` captured as a CUDA graph on `device` (default: the current
    device).

    Capture and every replay run with `device` current, so that a graph of
    tensors on another card than the current one is captured and replayed
    on their card. ``out`` is what `fn` returned while capturing (tensors
    in the graph's pool, rewritten by every replay). ``launches`` maps
    each kernel that `fn` launches to its launches a replay.
    """

    def __init__(self, fn, name: str = "graph", device=None):
        self.name = name
        dev = torch.device("cuda" if device is None else device)
        self.device = dev if dev.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
        before = [k.launches for k in _build.KERNELS]
        self.graph = torch.cuda.CUDAGraph()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device):
                torch.cuda.synchronize()
                with torch.cuda.stream(_capture_stream(self.device)):
                    self.graph.capture_begin()
                    try:
                        self.out = fn()
                    finally:
                        self.graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {name} failed: "
                               f"{e}") from e
        finally:
            if gc_on:
                gc.enable()
            after = [k.launches for k in _build.KERNELS]
            for k, n in zip(_build.KERNELS, before):
                k.launches = n
        self.launches = {k: a - b for k, a, b in
                         zip(_build.KERNELS, after, before) if a != b}

    def replay(self) -> None:
        """Launch the graph on its device's current stream."""
        with torch.cuda.device(self.device):
            self.graph.replay()
        for k, n in self.launches.items():
            k.launches += n
