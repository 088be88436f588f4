"""Single-rigid-body dynamics (SRBD) for the stance-force MPC.

A frozen copy of the port's ``models/srbd.py``, trimmed to what the tick
uses: the corrected convex-MPC linearization of Di Carlo et al. (2018)
with K arms sharing the yaw-dependent pieces (:func:`linearize_shared`),
the 13-state layout x = [theta_rpy(3), p(3), omega(3), v(3), g] of
include/mpcQP.h:66-71, the exact zero-order hold, the vector-form plant
step and the walking reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.config import RobotParams, SRBDConfig
from portbench.reference.types import constant


def _skew(r):
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, -z, y], -1),
        torch.stack([z, o, -x], -1),
        torch.stack([-y, x, o], -1),
    ], -2)


def _rz(yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    o, i = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, o], -1),
        torch.stack([s, c, o], -1),
        torch.stack([o, o, i], -1),
    ], -2)


def inertia_matrix(robot: RobotParams, dtype=torch.float32, device=None):
    """The body inertia [3, 3], made once per device (types.constant)."""
    return constant(tuple(robot.inertia), dtype, device).reshape(3, 3)


@functools.lru_cache(maxsize=16)
def _ac_constant(dtype, device) -> torch.Tensor:
    """The yaw-independent part of Ac [13, 13]: p_dot = v and the gravity
    state on v_z, made once (see types.constant); callers must not modify
    it."""
    Ac = torch.zeros((13, 13), dtype=dtype, device=device)
    Ac[3:6, 9:12] = torch.eye(3, dtype=dtype, device=device)  # p_dot = v
    Ac[11, 12] = 1.0                                   # v_z_dot += g_state
    return Ac


def linearize_shared(robot: RobotParams, arms: torch.Tensor,
                     base_pos: torch.Tensor, yaw: torch.Tensor):
    """Corrected SRBD linearization with the yaw-dependent pieces shared
    across K moment arms.

    arms [B, K, 3]; base_pos [B, 3]; yaw [B].
    Returns (Ac [B, 13, 13], Bc [B, K, 13, 3]).
    """
    dtype, device = arms.dtype, arms.device
    B, K = arms.shape[0], arms.shape[1]
    rz = _rz(yaw)
    rzT = rz.transpose(-1, -2)
    I_body = inertia_matrix(robot, dtype, device)
    # inv_ex: the same inverse without linalg.inv's check of the factor's
    # info on the host, a synchronization a CUDA graph cannot capture
    I_w_inv = torch.linalg.inv_ex(rz @ I_body @ rzT).inverse

    Ac = _ac_constant(dtype, device).expand(B, 13, 13).clone()
    Ac[:, 0:3, 6:9] = rzT                              # Theta_dot = Rz^T w

    r = arms - base_pos[:, None, :]                    # [B, K, 3]
    Bc = torch.zeros((B, K, 13, 3), dtype=dtype, device=device)
    Bc[:, :, 6:9, :] = I_w_inv[:, None] @ _skew(r)     # w_dot = I^-1 [r]x f
    Bc[:, :, 9:12, :] = (torch.eye(3, dtype=dtype, device=device)
                         / robot.mass)                 # v_dot = f/m
    return Ac, Bc


def discretize_srbd(Ac: torch.Tensor, Bc: torch.Tensor, ts: float):
    """Exact ZOH for the nilpotent (index 3) SRBD Ac:
    Ad = I + Ac ts + Ac^2 ts^2/2, Bd = (I ts + Ac ts^2/2 + Ac^2 ts^3/6) Bc.
    Ac [B, 13, 13]; Bc [B, 13, 3] or [B, K, 13, 3]."""
    nx = Ac.shape[-1]
    eye = torch.eye(nx, dtype=Ac.dtype, device=Ac.device)
    Ac2 = Ac @ Ac
    Ad = eye + Ac * ts + Ac2 * (ts * ts / 2.0)
    S = eye * ts + Ac * (ts * ts / 2.0) + Ac2 * (ts ** 3 / 6.0)
    if Bc.ndim == Ac.ndim + 1:
        Bd = S[:, None] @ Bc
    else:
        Bd = S @ Bc
    return Ad, Bd


def srbd_step_vector(robot: RobotParams, xi: torch.Tensor,
                     feet: torch.Tensor, forces: torch.Tensor, ts: float):
    """Exact-ZOH SRBD plant step in vector form (no 13x13 matrices).

    xi [B, 13]; feet [B, K, 3] world foot positions; forces [B, K, 3] world
    GRFs (zero for swing feet). Returns xi_new [B, 13]:

        wd = I_w^{-1} sum_k (r_k x f_k),   ad = sum_k f_k / m + g e_z
        theta' = theta + ts Rz^T w + ts^2/2 Rz^T wd,  p' = p + ts v + ts^2/2 ad
        w' = w + ts wd,  v' = v + ts ad
    """
    dtype, device = xi.dtype, xi.device
    theta, p, w, v = xi[:, 0:3], xi[:, 3:6], xi[:, 6:9], xi[:, 9:12]
    g_state = xi[:, 12]
    c, s = torch.cos(theta[:, 2]), torch.sin(theta[:, 2])

    def rz_t(u):
        return torch.stack([c * u[:, 0] + s * u[:, 1],
                            -s * u[:, 0] + c * u[:, 1], u[:, 2]], -1)

    def rz(u):
        return torch.stack([c * u[:, 0] - s * u[:, 1],
                            s * u[:, 0] + c * u[:, 1], u[:, 2]], -1)

    r = feet - p[:, None, :]
    tau_w = torch.cross(r, forces, dim=-1).sum(-2)
    f_tot = forces.sum(-2)
    I_inv = torch.tensor(
        np.linalg.inv(np.asarray(robot.inertia, np.float64).reshape(3, 3)),
        dtype=dtype, device=device)
    wd = rz(rz_t(tau_w) @ I_inv.T)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    ad = f_tot / robot.mass + g_state[:, None] * ez

    half = ts * ts / 2.0
    theta_new = theta + ts * rz_t(w) + half * rz_t(wd)
    p_new = p + ts * v + half * ad
    w_new = w + ts * wd
    v_new = v + ts * ad
    return torch.cat([theta_new, p_new, w_new, v_new, g_state[:, None]], -1)


def initial_state(orientation, position, angular_velocity, velocity,
                  g_state: float = -9.81):
    """Pack xi = [theta, p, omega, v, g] (include/mpcQP.h:66-71)."""
    g = torch.full((*orientation.shape[:-1], 1), g_state,
                   dtype=orientation.dtype, device=orientation.device)
    return torch.cat([orientation, position, angular_velocity, velocity, g],
                     -1)


def walking_reference(xi0: torch.Tensor, cfg: SRBDConfig, N: int,
                      v_des: torch.Tensor, yaw_rate: torch.Tensor,
                      height_des: float | None = None,
                      pos_anchor: torch.Tensor | None = None,
                      yaw_anchor: torch.Tensor | None = None):
    """Reference trajectory [B, N+1, 13] (generalizes include/mpcQP.h:
    74-97): yaw ramps from yaw_anchor (None = measured yaw) at yaw_rate,
    position ramps from pos_anchor (None = measured position) at v_des,
    omega = (0, 0, yaw_rate), velocity = v_des except step 0 (measured),
    g row constant. Roll/pitch rows follow cfg.attitude_ref: "level" zeroes
    them, "receding" keeps the measured attitude.

    xi0 [B, 13]; v_des [B, 3]; yaw_rate [B]; pos_anchor [B, 3];
    yaw_anchor [B].
    """
    if cfg.attitude_ref not in ("level", "receding"):
        raise ValueError(
            f"attitude_ref must be 'level' or 'receding', "
            f"got {cfg.attitude_ref!r}")
    dtype, device = xi0.dtype, xi0.device
    t = torch.arange(N + 1, dtype=dtype, device=device) * cfg.ts   # [N+1]
    ref = xi0[:, None, :].expand(xi0.shape[0], N + 1, 13).clone()
    # (fills in place: a write of a Python number is a copy from host
    # memory, which a CUDA graph cannot capture)
    if cfg.attitude_ref == "level":
        ref[..., 0:2].zero_()
    yaw0 = xi0[:, 2:3] if yaw_anchor is None else yaw_anchor[:, None]
    ref[..., 2] = yaw0 + t * yaw_rate[:, None]
    origin = xi0[:, None, 3:6] if pos_anchor is None \
        else pos_anchor[:, None, :]
    pos = origin + t[:, None] * v_des[:, None, :]
    if height_des is not None:
        pos[..., 2].fill_(height_des)
    ref[..., 3:6] = pos
    ref[..., 6:8].zero_()
    ref[..., 8] = yaw_rate[:, None]
    ref[..., 9:12] = v_des[:, None, :]
    ref[:, 0, 9:12] = xi0[:, 9:12]          # include/mpcQP.h:89-93
    return ref
