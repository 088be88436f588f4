"""Entry points of the port.

Counterpart of the JAX package's ``__graft_entry__.py``:

* :func:`entry` -- the forward step of the flagship model, one scenario:
  one full TRON1 walking-controller tick and SRBD plant step (estimate ->
  gait -> placement -> swing IK -> contact-scheduled GRF MPC -> dynamics);
* :func:`dryrun_multichip` -- an n-device scenario mesh: one step in both
  sharding styles, a 5-step sharded rollout held against the unsharded
  ``batched_rollout``, and the Kalman-filter sharded step.

Both run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.parallel import mesh as pmesh


def _cfg() -> ControllerConfig:
    return ControllerConfig.walking()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def entry(device=None):
    """Returns (fn, example_args): fn(state, iteration) -> (state,
    metrics), the single-scenario forward step, and an initial state with
    iteration 0 on `device` (the card by default)."""
    cfg = _cfg()

    def step(state, iteration):
        s, m = ro.plant_step(cfg, ro._map_state(state, lambda x: x[None]),
                             iteration)
        return ro._unbatch(s), {k: v[0] for k, v in m.items()}

    state0 = ro.initial_plant_state(cfg, device=device)
    return step, (state0, torch.zeros((), device=state0.xi.device))


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The full batched controller step over an n_devices mesh (scenario
    sharding and the cross-shard statistics), each style once, then a
    5-step sharded rollout against the unsharded one (atol 1e-4) and the
    KF sharded step. ``device="cpu"``: a mesh of n CPU shards. On the card
    the tick kernel is the path (checked)."""
    if device == "cpu":
        devices = ["cpu"] * n_devices
    else:
        count = torch.cuda.device_count()
        if not torch.cuda.is_available() or n_devices > count:
            raise RuntimeError(f"dryrun_multichip({n_devices}): "
                               f"{count if torch.cuda.is_available() else 0}"
                               " CUDA device(s)")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    cfg = _cfg()
    mesh = pmesh.make_mesh(devices)
    on_card = mesh.devices[0].type == "cuda"
    batch = 2 * n_devices
    state0 = ro.initial_plant_state(cfg, batch=(batch,),
                                    device=mesh.devices[0])
    if on_card:
        _check(ro.tick_route(cfg).path == "kernel", "the tick kernel is not "
               "the card's path")
    sharded = pmesh.shard_leading(state0, mesh)

    # GSPMD style: the program reduces the statistics
    new_state, stats = pmesh.sharded_batch_step(cfg, mesh)(sharded, 0.0)
    # explicit-collective style
    new_state2, stats2 = pmesh.shard_map_step(cfg, mesh)(sharded, 0.0)
    _check(new_state.gather().xi.shape == (batch, 13)
           and new_state2.gather().xi.shape == (batch, 13)
           and float(stats["mean_height"]) > 0.0
           and float(stats2["mean_height"]) > 0.0, "the sharded steps")

    # multi-step rollout under sharding against the unsharded rollout
    steps = 5
    final_sh, roll_stats = pmesh.sharded_rollout(cfg, mesh, steps)(sharded,
                                                                    0.0)
    final_1, _ = ro.batched_rollout(cfg, state0, steps)
    err = float((final_sh.gather().xi - final_1.xi).abs().max())
    _check(err <= 1e-4 and roll_stats["mean_height"].shape == (steps,),
           f"the sharded rollout is {err} off the unsharded one")

    # the KF sharded step: the 12-state filter threads per-scenario state
    # (x_hat [12], P [12,12]) through the sharded tick
    cfg_kf = dataclasses.replace(cfg, estimator_mode="kf")
    if on_card:
        _check(ro.tick_route(cfg_kf).path == "kernel", "the KF tick kernel "
               "is not the card's path")
    state_kf = pmesh.shard_leading(ro.initial_plant_state(
        cfg_kf, batch=(batch,), device=mesh.devices[0]), mesh)
    ns_kf, _ = pmesh.sharded_batch_step(cfg_kf, mesh)(state_kf, 0.0)
    kf = ns_kf.gather().kf
    _check(kf is not None and kf.x_hat.shape == (batch, 12),
           "the KF sharded step")
