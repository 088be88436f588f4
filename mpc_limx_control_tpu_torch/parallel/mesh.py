"""Device-mesh scaling: scenario-sharded batched MPC.

Counterpart of ``mpc_limx_control_tpu.parallel.mesh``. Thousands of
independent MPC problems are split along the scenario (batch) axis over a
one-axis :class:`Mesh`: per-scenario work is independent, so the only
traffic between shards is the cross-scenario statistics.

Two styles, as in the JAX package:

* :func:`sharded_batch_step` / :func:`sharded_rollout` -- the GSPMD
  counterpart: one program over every shard of the mesh. Each shard is
  stepped on its own device (the launches are asynchronous, so shards on
  different cards overlap) and the program reduces the statistics
  (``scenario_stats`` of the whole batch).
* :func:`shard_map_step` / :func:`shard_map_rollout` -- the explicit-
  collective counterpart: each process holds its slice and the height sum,
  the count and the residual maximum cross processes by
  ``torch.distributed.all_reduce`` (SUM, SUM, MAX) where JAX has
  ``psum`` / ``pmax``.

A mesh spans this process's devices; a card may hold several shards, and a
CPU mesh is n shards on ``"cpu"`` (the counterpart of the virtual CPU
devices JAX's tests use). After :func:`initialize_multihost` the axis
spans every process: process p holds the p-th block of rows and the
statistics of both styles are all-reduced across processes (NCCL between
distinct cards, gloo on the CPU or when processes share a card).

The start iteration of a step or rollout is a scalar, or one a scenario
of the global batch (``[B]``: staggered gait phases), split into the same
blocks of rows as the state. Each shard's rollout is the resident rollout
(``batched_rollout_resident``: the tick kernel on the card, its plain
version on the CPU) where the tick kernels take the config. Each tick
kernel computes a scenario on its own, so on the card a sharded run's
state equals the unsharded run's bit for bit (on the CPU the plain
version's matrix products round by the batch size); only the cross-shard
reductions may differ in their last bits. The rollouts reduce each
statistic's ``[steps]`` vector once, at the end, where JAX reduces inside
its scan at every step: the same values, one collective instead of
`steps`.

Every sharded call is logged in ``utils.profiling.mesh_log()``: its host
spans (``mesh.rollout``, ``mesh.reduce``), the device time of each
shard's work and of the reduction (timing events on each shard's stream,
read after the call), the collectives made and the bytes reduced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import os
import socket
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc
from mpc_limx_control_tpu_torch.utils import profiling

# how long a process group waits for its peers (rendezvous and collectives)
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh of scenario shards.

    ``devices``: this process's shards in order (a device may repeat).
    With ``process_count`` > 1 the axis spans the processes of the
    default process group, each holding ``len(devices)`` shards.
    ``reduce_device``: where the cross-process collectives run (the CPU
    over gloo, this process's card over NCCL).
    """

    devices: tuple
    axis_name: str = "data"
    process_index: int = 0
    process_count: int = 1
    reduce_device: torch.device = torch.device("cpu")

    @property
    def size(self) -> int:
        """Shards of the whole mesh, over every process."""
        return len(self.devices) * self.process_count


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A tree of tensors laid out over a mesh: ``parts[i]`` lives on
    ``mesh.devices[i]``. With ``spec == (axis_name,)`` each part holds a
    block of rows of the leading axis, ``offsets[i]`` its first row in the
    global batch; with ``spec == ()`` each holds the whole tree."""

    parts: tuple
    mesh: Mesh
    spec: tuple
    offsets: tuple

    def gather(self, device=None):
        """This process's rows as one tree on `device` (default: the
        mesh's first device); in one process, the whole batch."""
        dev = torch.device(device) if device is not None \
            else self.mesh.devices[0]
        if not self.spec:
            return _tree_map(lambda x: x.to(dev), self.parts[0])
        return _tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs]),
                         *self.parts)


def _tree_map(fn, *trees):
    """`fn` over the tensors of same-shaped trees (tensors, dicts, lists,
    tuples, dataclasses such as PlantState / KFState; None stays None)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return dataclasses.replace(t0, **{
            f.name: _tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    raise TypeError(f"cannot shard a leaf of type {type(t0).__name__}")


def _leaves(tree) -> list:
    out = []

    def keep(x):
        out.append(x)
        return x

    _tree_map(keep, tree)
    return out


def _on(device: torch.device):
    """The device made current (a CUDA device), else nothing."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _local_device_count() -> int:
    """The devices this process offers: its cards, else the CPU."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Bring up ``torch.distributed`` for a multi-process run and return the
    global device count.

    The coordinator is ``host:port`` (default: the environment variable
    ``JAX_COORDINATOR_ADDRESS``, as the JAX package reads it). Without one
    this is a no-op returning this process's device count (its cards, or
    1 for the CPU). The group is gloo for CPU tensors and, where this
    torch has NCCL and a card, NCCL for CUDA tensors; :func:`make_mesh`
    then picks where the statistics are reduced.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator_address:
        return _local_device_count()
    if not dist.is_initialized():
        if num_processes is None or process_id is None:
            raise ValueError("initialize_multihost: a coordinator needs "
                             "num_processes and process_id")
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   and dist.is_nccl_available() else "gloo")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=TIMEOUT)
    n = torch.tensor([_local_device_count()], dtype=torch.int64)
    dist.all_reduce(n)
    return int(n.item())


def _device_key(d: torch.device) -> int:
    """A number naming one card on one host (63 bits of a hash)."""
    props = torch.cuda.get_device_properties(d)
    name = f"{socket.gethostname()}/{getattr(props, 'uuid', d.index)}"
    return int.from_bytes(hashlib.sha1(name.encode()).digest()[:8],
                          "little") >> 1


def _reduce_device(devices: tuple, count: int) -> torch.device:
    """Where the cross-process collectives run: this process's card when
    every process has cards of its own and the group has NCCL, else the CPU
    (gloo; NCCL refuses two ranks on one card)."""
    if not all(d.type == "cuda" for d in devices) or \
            "nccl" not in str(dist.get_backend()):
        return torch.device("cpu")
    keys = torch.tensor([_device_key(d) for d in devices], dtype=torch.int64)
    got = [torch.empty_like(keys) for _ in range(count)]
    dist.all_gather(got, keys)
    mine = set(keys.tolist())
    others = {k for i, g in enumerate(got) if i != dist.get_rank()
              for k in g.tolist()}
    return devices[0] if not (mine & others) else torch.device("cpu")


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "data") -> Mesh:
    """A mesh over `devices` (torch devices or their names; one may repeat
    to put several shards on a card; ``["cpu"] * n`` is a CPU mesh).

    By default: every card of this process, or, after
    :func:`initialize_multihost`, the card ``rank % device_count`` (one
    process a card). With no card and no devices given it raises: nothing
    falls back to the CPU. In a process group every process must call it
    (it compares the processes' cards).
    """
    count, index = ((dist.get_world_size(), dist.get_rank())
                    if dist.is_available() and dist.is_initialized()
                    else (1, 0))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.is_available() is "
                "False); a CPU mesh is make_mesh(['cpu'] * n)")
        n = torch.cuda.device_count()
        devices = ([torch.device("cuda", index % n)] if count > 1
                   else [torch.device("cuda", i) for i in range(n)])
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"make_mesh: device {d} is neither a card nor "
                             "the CPU")
        devs.append(d)
    if not devs:
        raise ValueError("make_mesh: no devices")
    devs = tuple(devs)
    return Mesh(devices=devs, axis_name=axis_name, process_index=index,
                process_count=count,
                reduce_device=(_reduce_device(devs, count) if count > 1
                               else torch.device("cpu")))


def shard_leading(tree, mesh: Mesh, axis_name: str = "data") -> Sharded:
    """Split every tensor of `tree` (the global batch) along its leading
    axis over the mesh: this process keeps its block of rows, each shard
    a copy on its device. The batch must divide by ``mesh.size``."""
    if isinstance(tree, Sharded):
        if tree.mesh != mesh or tree.spec != (axis_name,):
            raise ValueError("shard_leading: already laid out on another "
                             "mesh or spec")
        return tree
    leaves = _leaves(tree)
    if not leaves or any(x.ndim == 0 for x in leaves):
        raise ValueError("shard_leading: every leaf needs a leading "
                         "(scenario) axis")
    B = leaves[0].shape[0]
    if any(x.shape[0] != B for x in leaves) or B % mesh.size:
        raise ValueError(f"shard_leading: a leading axis of {B} rows (all "
                         f"leaves alike) must divide by the mesh's "
                         f"{mesh.size} shards")
    rows = B // mesh.size
    first = mesh.process_index * len(mesh.devices)
    offsets = tuple((first + j) * rows for j in range(len(mesh.devices)))
    parts = tuple(
        _tree_map(lambda x, o=o, d=d: x[o:o + rows].to(
            device=d, copy=True).contiguous(), tree)
        for o, d in zip(offsets, mesh.devices))
    return Sharded(parts=parts, mesh=mesh, spec=(axis_name,),
                   offsets=offsets)


def replicate(tree, mesh: Mesh) -> Sharded:
    """A copy of the whole tree on each of this process's devices."""
    parts = tuple(_tree_map(lambda x, d=d: x.to(device=d, copy=True), tree)
                  for d in mesh.devices)
    return Sharded(parts=parts, mesh=mesh, spec=(), offsets=(0,) * len(parts))


def scenario_stats(metrics: dict) -> dict:
    """Cross-scenario reductions over the leading (scenario) axis: the mean
    height, the largest QP residual, the scenario whose height is nearest
    the mean (the first on a tie, as ``jnp.argmin``) and the mean vertical
    force of both feet. Metrics of [B] give scalars, as JAX's; [B, T]
    give one value a step."""
    height = metrics["height"]
    n = height.shape[0]
    # sum / n, as the sharded reduction forms it: a mesh of one shard
    # gives these values bit for bit
    mean = height.sum(0) / n
    grf = metrics["grf"]
    return {"mean_height": mean,
            "max_qp_residual": metrics["qp_residual"].amax(0),
            "best_scenario": (height - mean).abs().argmin(0),
            "grf_mean_fz": (grf[..., 2] + grf[..., 5]).sum(0) / n}


def _all_reduce(t: torch.Tensor, op, mesh: Mesh,
                call: Optional[profiling.MeshCall] = None) -> torch.Tensor:
    """`t` reduced over the mesh's processes (itself in one process); the
    collective is counted in `call`."""
    if mesh.process_count == 1:
        return t
    x = t.to(mesh.reduce_device)
    with _on(mesh.reduce_device):
        dist.all_reduce(x, op=op)
    if call is not None:
        call.collective(x.numel() * x.element_size())
    return x.to(t.device)


def _reduce_stats(parts: list, offsets: tuple, mesh: Mesh, full: bool,
                  call: Optional[profiling.MeshCall] = None) -> dict:
    """The statistics of the global batch from each shard's metrics
    ([b] or [b, T]), on the mesh's first device. ``full``: all of
    :func:`scenario_stats` (the GSPMD style); else the mean height and the
    largest residual (shard_map's psum / pmax). The collectives are
    counted in `call`."""
    out_dev = mesh.devices[0]
    scalar = parts[0]["height"].ndim == 1

    def cols(x):   # [b] -> [b, 1]
        return x[:, None] if scalar else x

    h = [cols(m["height"]) for m in parts]
    # each shard's sums in the metrics' dtype, added in shard order
    packed = [torch.stack([x.sum(0).to(out_dev) for x in h]).sum(0)]
    if full:
        fz = [cols(m["grf"][..., 2] + m["grf"][..., 5]) for m in parts]
        packed.append(torch.stack([x.sum(0).to(out_dev)
                                   for x in fz]).sum(0))
    count = sum(x.shape[0] for x in h)
    packed.append(torch.full((1,), float(count), dtype=h[0].dtype,
                             device=out_dev))
    total = _all_reduce(torch.cat(packed), dist.ReduceOp.SUM, mesh, call)
    T = h[0].shape[1]
    n = total[-1]
    mean = total[:T] / n
    res = torch.stack([cols(m["qp_residual"]).amax(0).to(out_dev)
                       for m in parts]).amax(0)
    stats = {"mean_height": mean,
             "max_qp_residual": _all_reduce(res, dist.ReduceOp.MAX, mesh,
                                            call)}
    if full:
        stats["grf_mean_fz"] = total[T:2 * T] / n
        # each shard's nearest scenario to the global mean, then the
        # smallest distance, on a tie the smallest global index
        vals, idx = [], []
        for x, o in zip(h, offsets):
            d = (x - mean.to(x.device)).abs()
            i = d.argmin(0)
            vals.append(d.gather(0, i[None])[0].to(out_dev))
            idx.append((i + o).to(out_dev))
        vals, idx = torch.stack(vals), torch.stack(idx)
        vmin = _all_reduce(vals.amin(0), dist.ReduceOp.MIN, mesh, call)
        big = torch.iinfo(torch.int64).max
        cand = torch.where(vals == vmin, idx, torch.full_like(idx, big))
        stats["best_scenario"] = _all_reduce(cand.amin(0), dist.ReduceOp.MIN,
                                             mesh, call)
    return {k: (v[0] if scalar else v) for k, v in stats.items()}


def _starts(name: str, value, sharded: Sharded) -> list:
    """Each shard's start iteration: a scalar as given, or a [B] tensor of
    the global batch split into the shards' blocks of rows."""
    if not isinstance(value, torch.Tensor) or value.numel() == 1:
        return [value] * len(sharded.parts)
    rows = [_leaves(p)[0].shape[0] for p in sharded.parts]
    B = rows[0] * sharded.mesh.size
    if value.ndim != 1 or value.shape[0] != B:
        raise ValueError(f"{name}: a scalar or one a scenario of the global "
                         f"batch ({B}), got shape {tuple(value.shape)}")
    return [value[o:o + b].to(d) for o, b, d in
            zip(sharded.offsets, rows, sharded.mesh.devices)]


def _shard_rollout(cfg, s, steps: int, start):
    """One shard's closed loop: the resident rollout (the tick kernel on
    the card, its plain version on the CPU; on the card bit for bit
    ``batched_rollout``) where the tick kernels take the config, else
    ``batched_rollout``."""
    if tfc.kernel_refusal(cfg) is None:
        return ro.batched_rollout_resident(cfg, s, steps,
                                           start_iteration=start)
    return ro.batched_rollout(cfg, s, steps, start_iteration=start)


def _run(sharded: Sharded, shard_fn, start_name: str, start, full: bool,
         metrics: bool = False):
    """Each shard's `shard_fn(state, start)` on its device, then the
    statistics of the global batch, logged as one call. Returns (the
    Sharded new state, the statistics), and with `metrics` also the
    Sharded per-scenario metrics."""
    starts = _starts(start_name, start, sharded)
    mesh = sharded.mesh
    with profiling.mesh_log().call(mesh.devices) as call:
        outs = []
        for j, (s, d) in enumerate(zip(sharded.parts, mesh.devices)):
            with _on(d), call.shard(j):
                outs.append(shard_fn(s, starts[j]))
        call.reducing()
        stats = _reduce_stats([o[1] for o in outs], sharded.offsets, mesh,
                              full, call)
    final = dataclasses.replace(sharded, parts=tuple(o[0] for o in outs))
    if metrics:
        return final, stats, dataclasses.replace(
            sharded, parts=tuple(o[1] for o in outs))
    return final, stats


def sharded_batch_step(cfg: ControllerConfig, mesh: Mesh,
                       axis_name: str = "data") -> Callable:
    """Batched plant step with scenario sharding (the GSPMD style).

    Returns step(state, iteration) -> (Sharded new state, stats of
    :func:`scenario_stats`, scalars on the mesh's first device). `state`
    is a :class:`Sharded` of this mesh or the global batch (then sharded
    first); `iteration` a scalar or a [B] tensor of the global batch.
    """
    def step(state, iteration):
        sh = shard_leading(state, mesh, axis_name)
        return _run(sh, lambda s, it: ro.plant_step(cfg, s, it),
                    "iteration", iteration, True)

    return step


def sharded_rollout(cfg: ControllerConfig, mesh: Mesh, steps: int,
                    axis_name: str = "data",
                    return_metrics: bool = False) -> Callable:
    """Multi-step closed loop under scenario sharding: each shard runs the
    whole rollout on its device with no host round trip per tick.

    Returns run(state, start_iteration) -> (final Sharded state, stats of
    :func:`scenario_stats` a step, [steps] tensors on the mesh's first
    device); `start_iteration` a scalar or a [B] tensor of the global
    batch. With `return_metrics` run also returns each scenario's
    metrics ([b, steps, ...] a shard) as a :class:`Sharded` laid out as
    the state.
    """
    def run(state, start_iteration):
        sh = shard_leading(state, mesh, axis_name)
        return _run(sh, lambda s, it: _shard_rollout(cfg, s, steps, it),
                    "start_iteration", start_iteration, True, return_metrics)

    return run


def shard_map_rollout(cfg: ControllerConfig, mesh: Mesh, steps: int,
                      axis_name: str = "data") -> Callable:
    """Explicit-collective multi-step rollout: the per-step mean height
    (SUM of the height sums and of the counts) and largest residual (MAX)
    of the global batch. Functionally :func:`sharded_rollout` with those
    two statistics."""
    def run(state, start_iteration):
        sh = shard_leading(state, mesh, axis_name)
        return _run(sh, lambda s, it: _shard_rollout(cfg, s, steps, it),
                    "start_iteration", start_iteration, False)

    return run


def shard_map_step(cfg: ControllerConfig, mesh: Mesh,
                   axis_name: str = "data") -> Callable:
    """Explicit-collective step: each shard's plant step, then the summed
    heights and counts and the largest residual reduced across shards and
    processes; `iteration` a scalar or a [B] tensor of the global
    batch."""
    def step(state, iteration):
        sh = shard_leading(state, mesh, axis_name)
        return _run(sh, lambda s, it: ro.plant_step(cfg, s, it),
                    "iteration", iteration, False)

    return step
