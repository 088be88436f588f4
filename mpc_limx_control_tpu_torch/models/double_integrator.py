"""Planar double-integrator model: the reference's solver scenario.

Counterpart of ``mpc_limx_control_tpu.models.double_integrator``
(src/linear_mpc_example.cpp:16-22,110-117, src/qpSolver_test.cpp:8-24): a
2D point mass with damping, nx = 4 (x, vx, y, vy), nu = 2, tracking a
circle of radius 2 at 0.5 rad/s over a 500-step closed loop.
"""

from __future__ import annotations

import torch


def continuous_matrices(dtype=torch.float32, device=None):
    """(Ac, Bc): damping / mass = 0.1, input gain 1 / mass = 5
    (src/linear_mpc_example.cpp:17-18 with damping 0.02, mass 0.2)."""
    Ac = torch.tensor([[0.0, 1.0, 0.0, 0.0],
                       [0.0, -0.1, 0.0, 0.0],
                       [0.0, 0.0, 0.0, 1.0],
                       [0.0, 0.0, 0.0, -0.1]], dtype=dtype, device=device)
    Bc = torch.tensor([[0.0, 0.0],
                       [5.0, 0.0],
                       [0.0, 0.0],
                       [0.0, 5.0]], dtype=dtype, device=device)
    return Ac, Bc


def circle_reference(k, ts: float, N: int, radius: float = 2.0,
                     angular_vel: float = 0.5, dtype=torch.float32,
                     device=None):
    """Reference trajectory [N + 1, nx] at closed-loop step k
    (src/qpSolver_test.cpp:40-50); `k` a number or a 0-d tensor."""
    i = torch.arange(N + 1, dtype=dtype, device=device)
    theta = angular_vel * ((k + i) * ts)
    return torch.stack([radius * torch.cos(theta),
                        -radius * angular_vel * torch.sin(theta),
                        radius * torch.sin(theta),
                        radius * angular_vel * torch.cos(theta)], -1)
