"""The prep-fused walking GRF MPC: CUDA kernel wrapper and plain version.

Counterpart of ``mpc_limx_control_tpu.ops.mpc_fused_pallas``'s walking
entry points. The TPU kernel ``_mpc_kernel_prep`` (mpc_fused_pallas.py:374,
reached through ``fused_walking_qp_prep`` :769 and ``make_walking_fused``
:894) becomes ``csrc/walking_mpc_prep.cu`` on top of the shared device core
``csrc/mpc_core.cuh``: SRBD linearization, exact ZOH and level-attitude
reference in-kernel, band condensation, Cholesky and the warm ADMM with
exact triangular solves.

* :func:`fused_walking_qp_prep` is the kernel wrapper: it launches the
  kernel for CUDA tensors and runs the kernel's plain version
  (``walking_qp_prep_plain`` with ``solve_form="subst"``) for CPU tensors.
* :func:`make_walking_fused` is the controller's entry point: the kernel
  for CUDA tensors, the plain composition with the JAX CPU path's explicit
  f32 K^-1 (``"kinv"``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mpc_limx_control_tpu_torch.core.types import QPSolution
from mpc_limx_control_tpu_torch.models import srbd
from mpc_limx_control_tpu_torch.ops import _build
from mpc_limx_control_tpu_torch.ops import condense as cnd
from mpc_limx_control_tpu_torch.ops import qp as qps

NX = 13
MAX_HORIZON = 21          # n = 3N <= 64: two solve rows per lane of a warp

# The kernel and its launch counter (see ops/_build.py).
WALKING_MPC_PREP = _build.Kernel("walking_mpc_prep", n_ptr=11,
                                 params_sizer="walking_mpc_params_bytes")


class MpcParams(ctypes.Structure):
    """Mirror of ``mpc::MpcParams`` in csrc/mpc_core.cuh."""

    _fields_ = [("N", ctypes.c_int), ("iters", ctypes.c_int),
                ("rho", ctypes.c_float), ("alpha", ctypes.c_float),
                ("ts", ctypes.c_float), ("mass", ctypes.c_float),
                ("height_des", ctypes.c_float),
                ("q", ctypes.c_float * NX), ("p", ctypes.c_float * NX),
                ("dblk", ctypes.c_float * 9), ("Gu", ctypes.c_float * 18),
                ("hu", ctypes.c_float * 6), ("Iinv", ctypes.c_float * 9)]


def walking_constants(cfg) -> dict:
    """The walking QP's constants from the full controller config (the
    static arguments of the JAX fused_walking_qp_prep)."""
    c = cfg.srbd
    mu = float(c.friction_mu)
    return dict(
        N=int(c.horizon), iters=int(c.solver.admm_warm_iters),
        rho=float(c.solver.admm_rho), alpha=float(c.solver.admm_alpha),
        reg=1e-6, ts=float(c.ts), mass=float(cfg.robot.mass),
        height_des=float(cfg.ground_height) + float(cfg.base_height),
        Gu=((1.0, 0.0, -mu), (-1.0, 0.0, -mu), (0.0, 1.0, -mu),
            (0.0, -1.0, -mu), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0)),
        hu=(0.0, 0.0, 0.0, 0.0, float(c.fz_max), -float(c.fz_min)),
        q_diag=tuple(float(v) for v in c.q_diag),
        r_diag=tuple(float(v) for v in c.r_diag),
        p_diag=tuple(float(c.p_scale) * float(v) for v in c.q_diag),
        inertia=tuple(float(v) for v in cfg.robot.inertia))


@functools.lru_cache(maxsize=16)
def mpc_params(cfg) -> MpcParams:
    """Kernel constants for a (frozen, hashable) config; cached so the
    per-call launch builds no structure. Callers must not mutate it."""
    k = walking_constants(cfg)
    Gu = np.asarray(k["Gu"], np.float32)
    dblk = (2.0 * np.diag(np.asarray(k["r_diag"], np.float32))
            + np.float32(k["rho"]) * (Gu.T @ Gu)
            + np.float32(k["reg"]) * np.eye(3, dtype=np.float32))
    iinv = np.linalg.inv(np.asarray(k["inertia"], np.float64).reshape(3, 3))
    p = MpcParams()
    p.N, p.iters = k["N"], k["iters"]
    p.rho, p.alpha, p.ts = k["rho"], k["alpha"], k["ts"]
    p.mass, p.height_des = k["mass"], k["height_des"]
    p.q[:] = list(k["q_diag"])
    p.p[:] = list(k["p_diag"])
    p.dblk[:] = [float(v) for v in dblk.astype(np.float32).reshape(-1)]
    p.Gu[:] = [float(v) for v in Gu.reshape(-1)]
    p.hu[:] = list(k["hu"])
    p.Iinv[:] = [float(v) for v in iinv.astype(np.float32).reshape(-1)]
    return p


def supports_fused_walking_qp(cfg) -> bool:
    """True when the walking kernel implements the config's QP: the
    level-attitude reference (the in-kernel reference rows are level only,
    mpc_fused_pallas.py:913-916) and a horizon of at most 21 steps."""
    return (cfg.srbd.attitude_ref == "level"
            and 1 <= cfg.srbd.horizon <= MAX_HORIZON
            and cfg.srbd.nu == 3)


def walking_qp_prep_plain(cfg, arms, x0, v_des, yaw_rate, z_warm, y_warm,
                          anchor, solve_form: str = "kinv"):
    """Plain composition of the walking QP: srbd.linearize_shared +
    discretize_srbd + walking_reference + condense + _batched_admm.

    arms [B,N,3]; x0 [B,13]; v_des [B,3]; yaw_rate [B]; z_warm [B,3N];
    y_warm [B,6N]; anchor [B,3] = (x, y, yaw) reference-pose origin.
    Returns (QPSolution, xi_pred [B,13], (z, y)).
    """
    k = walking_constants(cfg)
    c = cfg.srbd
    N = k["N"]
    dtype, device = x0.dtype, x0.device
    Ac, Bc_t = srbd.linearize_shared(cfg.robot, arms, x0[:, 3:6], x0[:, 2])
    Ad, Bd_t = srbd.discretize_srbd(Ac, Bc_t, k["ts"])
    anc3 = torch.cat([anchor[:, :2], torch.zeros_like(anchor[:, :1])], -1)
    x_ref = srbd.walking_reference(x0, c, N, v_des, yaw_rate,
                                   height_des=k["height_des"],
                                   pos_anchor=anc3, yaw_anchor=anchor[:, 2])

    def diag(v):
        return torch.diag(torch.tensor(v, dtype=dtype, device=device))

    G, h = srbd.friction_cone_rows(c, N, dtype, device)
    qp = cnd.condense(Ad, Bd_t, diag(k["q_diag"]), diag(k["r_diag"]),
                      diag(k["p_diag"]), N, x0, x_ref, extra_G=G,
                      extra_h=h)
    sol, zy = qps._batched_admm(qp.H, qp.f, qp.G, qp.h, z_warm, y_warm,
                                k["iters"], k["rho"], k["alpha"],
                                solve_form)
    u0 = sol.u[:, :3]
    xp = ((Ad @ x0[..., None])[..., 0]
          + (Bd_t[:, 0] @ u0[..., None])[..., 0])
    return sol, xp, zy


def fused_walking_qp_prep(arms, x0, v_des, yaw_rate, z_warm, y_warm,
                          anchor, *, cfg):
    """Batched prep-fused walking QP solve (kernel wrapper).

    Shapes as :func:`walking_qp_prep_plain`. Returns
    (z [B,3N], y [B,6N], residual [B], xi_pred [B,13]). CUDA tensors
    launch ``walking_mpc_prep``; CPU tensors run its plain version
    (exact triangular solves, ``solve_form="subst"``).
    """
    if not supports_fused_walking_qp(cfg):
        raise ValueError(
            "walking_mpc_prep implements the level-attitude walking QP with "
            f"horizon <= {MAX_HORIZON} (got attitude_ref="
            f"{cfg.srbd.attitude_ref!r}, horizon={cfg.srbd.horizon})")
    if x0.device.type == "cpu":
        sol, xp, (z, y) = walking_qp_prep_plain(
            cfg, arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor,
            solve_form="subst")
        return z, y, sol.residual, xp
    if x0.device.type != "cuda":
        raise ValueError(f"walking_mpc_prep runs on CUDA tensors, got "
                         f"{x0.device}")
    N = int(cfg.srbd.horizon)
    B = x0.shape[0]
    dev = x0.device
    for name, t, shape in (
            ("arms", arms, (B, N, 3)), ("x0", x0, (B, NX)),
            ("v_des", v_des, (B, 3)), ("yaw_rate", yaw_rate, (B,)),
            ("z_warm", z_warm, (B, 3 * N)), ("y_warm", y_warm, (B, 6 * N)),
            ("anchor", anchor, (B, 3))):
        _build.check_tensor(name, t, shape, dev)
    z = torch.empty((B, 3 * N), dtype=torch.float32, device=dev)
    y = torch.empty((B, 6 * N), dtype=torch.float32, device=dev)
    res = torch.empty((B,), dtype=torch.float32, device=dev)
    xp = torch.empty((B, NX), dtype=torch.float32, device=dev)
    ins = (x0, arms, v_des, yaw_rate, z_warm, y_warm, anchor)
    outs = (z, y, res, xp)
    WALKING_MPC_PREP.launch(
        mpc_params(cfg), [t.data_ptr() for t in ins + outs], B,
        torch.cuda.current_stream(dev).cuda_stream)
    return z, y, res, xp


def make_walking_fused(cfg, solve_form: str | None = None):
    """Warm walking GRF solver from the full controller config:
    fn(arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor) ->
    (QPSolution, xi_pred, (z, y)), batch-first.

    solve_form=None: the ``walking_mpc_prep`` kernel for CUDA tensors
    (a config the kernel does not implement raises), the plain composition
    with the explicit f32 K^-1 (``"kinv"``, the JAX CPU path) for CPU
    tensors. solve_form="kinv" / "subst": the plain composition with that
    solve form on any device.
    """
    if solve_form is not None and solve_form not in qps.SOLVE_FORMS:
        raise ValueError(f"solve_form must be None or one of "
                         f"{qps.SOLVE_FORMS}, got {solve_form!r}")
    iters = int(cfg.srbd.solver.admm_warm_iters)

    def solve(arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor):
        if solve_form is None and x0.device.type == "cuda":
            if not supports_fused_walking_qp(cfg):
                raise NotImplementedError(
                    "walking MPC on CUDA: the walking_mpc_prep kernel is "
                    "level-attitude only with horizon <= 21; other configs "
                    "wait for ROADMAP queue 2 (K7, the generic fused QP)")
            args = [t.contiguous() for t in
                    (arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor)]
            z, y, res, xp = fused_walking_qp_prep(*args, cfg=cfg)
            return QPSolution(u=z, iterations=iters, residual=res), xp, (z, y)
        return walking_qp_prep_plain(cfg, arms, x0, v_des, yaw_rate, z_warm,
                                     y_warm, anchor,
                                     solve_form=solve_form or "kinv")

    return solve
