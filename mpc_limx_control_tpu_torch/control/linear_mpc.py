"""Closed-loop linear MPC: the double-integrator circle-tracking example.

Counterpart of ``mpc_limx_control_tpu.control.linear_mpc``, the reference's
working numerical core (the 500-step loop of src/qpSolver_test.cpp:38-75 /
src/linear_mpc_example.cpp:133-195):

    setup  (once):  ZOH discretize + cache the condensation
    tick   (loop):  reference -> (f, h) -> batched cold PDIP -> plant step

The rollout is a host loop over ticks on batched tensors; every tick's QPs
(one per scenario, sharing H and G) go through ``ops.qp.make_pdip``, whose
factorizations and solves are the ``ops/chol_cuda.py`` kernels on CUDA
tensors. The plant step x <- Ad x + Bd u mirrors ``QPSolver::updateState``
(src/QPSolver.cpp:108-111).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpc_limx_control_tpu_torch.core.config import MPCConfig
from mpc_limx_control_tpu_torch.core.types import default_device
from mpc_limx_control_tpu_torch.models import double_integrator as di
from mpc_limx_control_tpu_torch.ops import condense as cnd
from mpc_limx_control_tpu_torch.ops import discretize as dsc
from mpc_limx_control_tpu_torch.ops import qp as qps


class LinearMPCParams(NamedTuple):
    Ad: torch.Tensor
    Bd: torch.Tensor
    cache: cnd.CondensationCache
    x_min: torch.Tensor
    x_max: torch.Tensor


def params_from_matrices(cfg: MPCConfig, Ad: torch.Tensor,
                         Bd: torch.Tensor) -> LinearMPCParams:
    """Cache the condensation for given discrete matrices."""
    dtype, device = Ad.dtype, Ad.device
    Q = torch.diag(torch.tensor(cfg.q_diag, dtype=dtype, device=device))
    R = torch.diag(torch.tensor(cfg.r_diag, dtype=dtype, device=device))
    cache = cnd.condense_cache(Ad, Bd, Q, R, cfg.p_scale * Q, cfg.horizon,
                               with_state_rows=cfg.use_state_constraints)
    return LinearMPCParams(
        Ad=Ad, Bd=Bd, cache=cache,
        x_min=torch.tensor(cfg.x_min, dtype=dtype, device=device),
        x_max=torch.tensor(cfg.x_max, dtype=dtype, device=device))


def setup(cfg: MPCConfig, dtype=torch.float32, device=None
          ) -> LinearMPCParams:
    """Discretize and cache the condensation for the configured system, on
    the card unless ``device`` says otherwise."""
    Ac, Bc = di.continuous_matrices(dtype, default_device(device))
    return params_from_matrices(cfg, *dsc.zoh(Ac, Bc, cfg.ts))


def solve_tick(cfg: MPCConfig, params: LinearMPCParams, x: torch.Tensor, k,
               plain_twins: bool = False):
    """One MPC solve at closed-loop step k for x [nx] or [B,nx]: returns
    (u [.., nu], QPSolution)."""
    x_ref = di.circle_reference(k, cfg.ts, cfg.horizon, dtype=x.dtype,
                                device=x.device)
    bounds = ((params.x_min, params.x_max) if cfg.use_state_constraints
              else ())
    f, h = cnd.linear_terms(params.cache, x, x_ref, cfg.u_min, cfg.u_max,
                            *bounds)
    solver = qps.make_pdip(iters=cfg.solver.iters, plain_twins=plain_twins)
    sol = solver(params.cache.H, f, params.cache.G, h)
    return sol.u[..., :cfg.nu], sol


def batched_closed_loop(cfg: MPCConfig, params: LinearMPCParams,
                        x0s: torch.Tensor, steps: int,
                        plain_twins: bool = False):
    """Closed-loop rollout from a batch of initial states x0s [B,nx].

    Returns dict: states [B,steps+1,nx], controls [B,steps,nu], errors
    [B,steps] (position tracking error as printed by the reference,
    src/qpSolver_test.cpp:84-89), residuals [B,steps]. Nothing is fetched
    to the host inside the loop.
    """
    B, nx = x0s.shape
    dtype, device = x0s.dtype, x0s.device
    states = torch.empty((B, steps + 1, nx), dtype=dtype, device=device)
    controls = torch.empty((B, steps, cfg.nu), dtype=dtype, device=device)
    errors = torch.empty((B, steps), dtype=dtype, device=device)
    residuals = torch.empty((B, steps), dtype=dtype, device=device)
    states[:, 0] = x0s
    x = x0s
    AdT, BdT = params.Ad.T, params.Bd.T
    for k in range(steps):
        u, sol = solve_tick(cfg, params, x, float(k), plain_twins)
        x = x @ AdT + u @ BdT
        ref_now = di.circle_reference(float(k), cfg.ts, 0, dtype=dtype,
                                      device=device)[0]
        errors[:, k] = torch.linalg.vector_norm(
            torch.stack([x[:, 0] - ref_now[0], x[:, 2] - ref_now[2]], -1),
            dim=-1)
        states[:, k + 1] = x
        controls[:, k] = u
        residuals[:, k] = sol.residual
    return {"states": states, "controls": controls, "errors": errors,
            "residuals": residuals}


def closed_loop(cfg: MPCConfig, params: LinearMPCParams, x0: torch.Tensor,
                steps: int, plain_twins: bool = False):
    """Closed-loop rollout of ONE scenario from x0 [nx]: states
    [steps+1,nx], controls [steps,nu], errors [steps], residuals [steps]."""
    out = batched_closed_loop(cfg, params, x0[None], steps, plain_twins)
    return {k: v[0] for k, v in out.items()}
