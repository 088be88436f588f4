"""ZOH discretization of continuous-time LTI systems.

Counterpart of ``mpc_limx_control_tpu.ops.discretize`` (reference
``QPSolver::discretizeSystem``, src/QPSolver.cpp:21-29): stack
M = [[Ac, Bc], [0, 0]], take expm(M ts) and read off Ad (top-left) and Bd
(top-right).

* :func:`zoh`: ``torch.linalg.matrix_exp``, exact to machine precision in
  the working dtype.
* :func:`zoh_taylor`: fixed-order truncated Taylor series with a static
  number of squarings; cheap where ||M ts|| << 1.

Both take unbatched [nx,nx] / [nx,nu] or any leading batch dimensions.
"""

from __future__ import annotations

import torch


def _augment(Ac: torch.Tensor, Bc: torch.Tensor, ts: float) -> torch.Tensor:
    nx, nu = Bc.shape[-2], Bc.shape[-1]
    top = torch.cat([Ac, Bc], -1)
    bot = torch.zeros((*Ac.shape[:-2], nu, nx + nu), dtype=Ac.dtype,
                      device=Ac.device)
    return torch.cat([top, bot], -2) * ts


def zoh(Ac: torch.Tensor, Bc: torch.Tensor, ts: float):
    """Exact ZOH: (Ad, Bd) = split(expm([[Ac, Bc], [0, 0]] ts))."""
    nx = Ac.shape[-1]
    E = torch.linalg.matrix_exp(_augment(Ac, Bc, ts))
    return E[..., :nx, :nx], E[..., :nx, nx:]


def zoh_taylor(Ac: torch.Tensor, Bc: torch.Tensor, ts: float,
               order: int = 8, squarings: int = 4):
    """Fixed-order ZOH: Taylor(order) of expm on M ts / 2^squarings, then
    `squarings` repeated squarings (error ~ (||M|| ts / 2^s)^(order + 1) /
    (order + 1)!)."""
    nx = Ac.shape[-1]
    M = _augment(Ac, Bc, ts) / (2.0 ** squarings)
    eye = torch.eye(M.shape[-1], dtype=M.dtype,
                    device=M.device).expand_as(M)
    E = eye
    term = eye
    for k in range(1, order + 1):
        term = (term @ M) / k
        E = E + term
    for _ in range(squarings):
        E = E @ E
    return E[..., :nx, :nx], E[..., :nx, nx:]
