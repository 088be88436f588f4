"""The fused GRF MPC solves: CUDA kernel wrappers and plain versions.

Counterpart of ``mpc_limx_control_tpu.ops.mpc_fused_pallas``. Both TPU
kernels sit on the shared device core ``csrc/mpc_core.cuh`` (band
condensation, Cholesky, warm ADMM with exact triangular solves):

* ``_mpc_kernel_prep`` (mpc_fused_pallas.py:374, reached through
  ``fused_walking_qp_prep`` :769 and ``make_walking_fused`` :894) becomes
  ``csrc/walking_mpc_prep.cu``: SRBD linearization, exact ZOH and
  level-attitude reference in-kernel, for the single-support walking QP.
  :func:`fused_walking_qp_prep` is its wrapper, :func:`make_walking_fused`
  the controller's entry point.
* ``_mpc_kernel`` (mpc_fused_pallas.py:355, reached through
  ``fused_walking_qp`` :644 and ``make_admm_fused`` :1001) becomes
  ``csrc/fused_qp.cu``: the same solve from given Ad, Bd_t and reference
  rows, with one foot (nu = 3) or two feet (nu = 6) per horizon step.
  :func:`fused_walking_qp` is its wrapper, :func:`make_admm_fused` the
  controller's entry point (``controller.stance_mpc``, standing).

Each kernel has a second entry point for ``SolverConfig.solve_form="inv"``
(``walking_mpc_prep_inv``, ``fused_qp_nu3_inv``, ``fused_qp_nu6_inv``):
the Cholesky factor inverted once per solve, mat-vecs per ADMM step
(mpc_fused_pallas.py:230-263), where n = nu N <= 64 (N <= 21 at nu = 3,
N <= 10 at nu = 6); past that the TPU kernel keeps the substitution sweeps
(:249), and so do these entries.

A wrapper launches its kernel for CUDA tensors and runs the kernel's plain
version (exact triangular solves, ``solve_form="subst"``; the explicit
factor inverse, ``"linv"``, for the ``inv`` kernels where n <= 64) for
CPU tensors.
The ``make_*`` entry points run the kernel for CUDA tensors and, for CPU
tensors, the plain composition with the JAX CPU path's explicit f32 K^-1
(``"kinv"``).
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
from mpc_limx_control_tpu_torch.ops.chol_cuda import SMEM_LIMIT_BYTES

NX = 13
MAX_HORIZON = 85          # nu = 3: n = 3 N <= 256, eight solve rows a lane
MAX_HORIZON_STAND = 42    # nu = 6: n = 6 N <= 256, eight solve rows a lane
INV_MAX_N = 64            # "inv" forms the factor inverse up to this n
REG = 1e-6                # added to K's diagonal (f32)

# The kernels and their launch counters (see ops/_build.py).
WALKING_MPC_PREP = _build.Kernel("walking_mpc_prep", n_ptr=11,
                                 params_sizer="walking_mpc_params_bytes")
WALKING_MPC_PREP_INV = _build.Kernel(
    "walking_mpc_prep_inv", n_ptr=11, params_sizer="walking_mpc_params_bytes")
FUSED_QP = {nu: _build.Kernel(f"fused_qp_nu{nu}", n_ptr=9,
                              params_sizer="walking_mpc_params_bytes")
            for nu in (3, 6)}
FUSED_QP_NU3_INV = _build.Kernel("fused_qp_nu3_inv", n_ptr=9,
                                 params_sizer="walking_mpc_params_bytes")
FUSED_QP_NU6_INV = _build.Kernel("fused_qp_nu6_inv", n_ptr=9,
                                 params_sizer="walking_mpc_params_bytes")
FUSED_QP_INV = {3: FUSED_QP_NU3_INV, 6: FUSED_QP_NU6_INV}
# SolverConfig.solve_form values the kernels run
KERNEL_SOLVE_FORMS = ("subst", "inv")


# ---- the core's shared-memory layout (csrc/mpc_core.cuh:smem_layout) -------
_AUX_SIZE = 64            # the aux area
_KW_SIZE = 756            # the solving forms' filter (tick_common.cuh)
_TK_SIZE = 16             # the walking tick's scratch (csrc/walking_tick.cu)
_AD_SIZE = 176            # fused_qp's Ad [13][13] (csrc/fused_qp.cu)
MPC_ENTRIES = _build.MPC_ENTRIES


def entry_nu(entry: str) -> int:
    """Forces per horizon step of an entry point built on the MPC core."""
    if entry not in MPC_ENTRIES:
        raise ValueError(f"{entry!r} is not one of {MPC_ENTRIES}")
    return 6 if entry.startswith(("standing", "fused_qp_nu6")) else 3


def max_horizon(nu: int) -> int:
    """The longest horizon the MPC core takes at nu forces a step."""
    return MAX_HORIZON if nu == 3 else MAX_HORIZON_STAND


def _layout_floats(nu: int, N: int, nbd: int, narms: int,
                   inv: bool) -> int:
    """Floats of mpc::smem_layout<nu>(N, nbd, narms, inv): K packed (at
    least the Gramian recursion's W pair), S_k = W_k Bd_k, Bd, the arm
    sets, the f sweep's errors and f, the packed factor inverse where the
    core forms it, x0 and the aux area."""
    n = nu * N
    tri = n * (n + 1) // 2
    T = tri if inv and n <= INV_MAX_N else 0
    return (max(tri, 2 * 176) + N * NX * nu + nbd * NX * nu + narms * nu
            + N * NX + n + T + 16 + _AUX_SIZE)


def smem_bytes(entry: str, N: int) -> int:
    """Dynamic shared memory per block of `entry` at horizon N, as the
    library's ``<entry>_smem_bytes(N)`` computes it: the core's layout (N
    Bd blocks and arm sets walking; one of each standing; N Bd blocks and
    no arm sets in fused_qp; the factor inverse in an ``_inv`` entry where
    n <= 64), plus the walking tick's scratch, fused_qp's Ad and reference
    rows, and room for the filter's scratch from K's area in the KF
    forms."""
    nu = entry_nu(entry)
    inv = entry.endswith("_inv")
    base = entry[:-len("_inv")] if inv else entry
    if base.startswith("fused_qp"):
        total = _layout_floats(nu, N, N, 0, inv)
        return 4 * (total + _AD_SIZE + (N + 1) * NX)
    sets = 1 if nu == 6 else N
    total = _layout_floats(nu, N, sets, sets, inv)
    if base.startswith("walking_tick"):
        total += _TK_SIZE
    if base.endswith("_kf"):
        total = max(total, _KW_SIZE)      # K's area starts at 0
    return 4 * total


def size_reason(entry: str, N: int) -> str | None:
    """Why entry point `entry` cannot take horizon N (None: it can): nu = 3
    takes 1 to 85 steps, nu = 6 1 to 42 (n = nu N <= 256, eight solve rows
    a lane), each within a block's shared memory."""
    nu = entry_nu(entry)
    top = max_horizon(nu)
    if not 1 <= N <= top:
        kind = "walking" if nu == 3 else "standing"
        return (f"horizon={N}: the {kind} MPC kernels take 1 to {top} "
                f"steps (n = {nu} N <= 256, eight solve rows a lane)")
    need = smem_bytes(entry, N)
    if need > SMEM_LIMIT_BYTES:
        return (f"horizon={N}: {entry} needs {need} bytes of shared memory "
                f"a block, over the {SMEM_LIMIT_BYTES} a block can have")
    return None


def plain_solve_form(solve_form: str, nu: int, N: int) -> str:
    """The ``_batched_admm`` form that repeats what the kernels do for a
    config's solve_form at nu forces a step and horizon N: "inv" is the
    explicit factor inverse ("linv") where n = nu N <= 64 (N <= 21 at
    nu = 3, N <= 10 at nu = 6), as the TPU kernel forms it
    (mpc_fused_pallas.py:249); the sweeps ("subst") past that."""
    if solve_form not in KERNEL_SOLVE_FORMS:
        raise ValueError(f"solve_form must be one of {KERNEL_SOLVE_FORMS}, "
                         f"got {solve_form!r}")
    inv = solve_form == "inv" and nu * N <= INV_MAX_N
    return "linv" if inv else "subst"


class MpcParams(ctypes.Structure):
    """Mirror of ``mpc::MpcParams`` in csrc/mpc_core.cuh."""

    _fields_ = [("N", ctypes.c_int), ("iters", ctypes.c_int),
                ("rho", ctypes.c_float), ("alpha", ctypes.c_float),
                ("ts", ctypes.c_float), ("mass", ctypes.c_float),
                ("height_des", ctypes.c_float),
                ("q", ctypes.c_float * NX), ("p", ctypes.c_float * NX),
                ("dblk", ctypes.c_float * 18), ("Gu", ctypes.c_float * 18),
                ("hu", ctypes.c_float * 12), ("Iinv", ctypes.c_float * 9)]


def cone_constants(cfg_srbd) -> dict:
    """One foot's friction cone and the QP weights from the SRBDConfig:
    Gu [6][3] and hu [6] (|fx|, |fy| <= mu fz, fz_min <= fz <= fz_max),
    the diagonal weights and the warm-ADMM settings."""
    c = cfg_srbd
    mu = float(c.friction_mu)
    return dict(
        N=int(c.horizon), iters=int(c.solver.admm_warm_iters),
        rho=float(c.solver.admm_rho), alpha=float(c.solver.admm_alpha),
        reg=REG,
        Gu=((1.0, 0.0, -mu), (-1.0, 0.0, -mu), (0.0, 1.0, -mu),
            (0.0, -1.0, -mu), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0)),
        hu=(0.0, 0.0, 0.0, 0.0, float(c.fz_max), -float(c.fz_min)),
        q_diag=tuple(float(v) for v in c.q_diag),
        r_diag=tuple(float(v) for v in c.r_diag),
        p_diag=tuple(float(c.p_scale) * float(v) for v in c.q_diag))


def walking_constants(cfg) -> dict:
    """The in-kernel-prep QP's constants from the full controller config
    (the static arguments of the JAX fused_walking_qp_prep): one foot per
    horizon step walking (nu = 3), both feet standing (nu = 6), the
    per-foot cone and weights the same."""
    return dict(
        cone_constants(cfg.srbd), nu=3 if cfg.mode == "walk" else 6,
        ts=float(cfg.srbd.ts), mass=float(cfg.robot.mass),
        height_des=float(cfg.ground_height) + float(cfg.base_height),
        inertia=tuple(float(v) for v in cfg.robot.inertia))


def _fill_params(k: dict, nu: int) -> MpcParams:
    """MpcParams from a constants dict in the one-foot form of
    :func:`cone_constants` (Gu [6][3], hu [6], r_diag [3]; every foot the
    same) plus ts, mass, height_des and inertia (None: the kernel is given
    its dynamics and reads none of the four)."""
    feet = nu // 3
    Gu = np.asarray(k["Gu"], np.float32)
    r = np.asarray(k["r_diag"], np.float32)
    dblk = (2.0 * np.diag(r) + np.float32(k["rho"]) * (Gu.T @ Gu)
            + np.float32(k["reg"]) * np.eye(3, dtype=np.float32)).reshape(-1)
    p = MpcParams()
    p.N, p.iters = k["N"], k["iters"]
    p.rho, p.alpha = k["rho"], k["alpha"]
    p.ts, p.mass, p.height_des = k["ts"], k["mass"], k["height_des"]
    p.q[:] = list(k["q_diag"])
    p.p[:] = list(k["p_diag"])
    p.dblk[:] = [float(v) for v in dblk] * feet + [0.0] * (9 * (2 - feet))
    p.Gu[:] = [float(v) for v in Gu.reshape(-1)]
    p.hu[:] = [float(v) for v in k["hu"]] * 2
    if k["inertia"] is not None:
        iinv = np.linalg.inv(
            np.asarray(k["inertia"], np.float64).reshape(3, 3))
        p.Iinv[:] = [float(v) for v in iinv.astype(np.float32).reshape(-1)]
    return p


@functools.lru_cache(maxsize=16)
def mpc_params(cfg) -> MpcParams:
    """Kernel constants for a (frozen, hashable) config; cached so the
    per-call launch builds no structure. Callers must not mutate it."""
    k = walking_constants(cfg)
    return _fill_params(k, k["nu"])


def supports_fused_walking_qp(cfg) -> bool:
    """True when the in-kernel prep implements the config's QP: the
    level-attitude reference (the in-kernel reference rows are level only,
    mpc_fused_pallas.py:913-916), a horizon of 1 to 85 steps and a solve
    form the core runs ("subst" or "inv")."""
    return (cfg.srbd.attitude_ref == "level"
            and 1 <= cfg.srbd.horizon <= MAX_HORIZON
            and cfg.srbd.nu == 3
            and cfg.srbd.solver.solve_form in KERNEL_SOLVE_FORMS)


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
    launch ``walking_mpc_prep`` (``walking_mpc_prep_inv`` when the config's
    solve_form is "inv"); CPU tensors run the plain version (exact
    triangular solves, ``"subst"``, or, "inv" with n = 3 N <= 64, the
    explicit factor inverse, ``"linv"``).
    """
    if not supports_fused_walking_qp(cfg):
        raise ValueError(
            "walking_mpc_prep implements the level-attitude walking QP with "
            f"horizon <= {MAX_HORIZON} and solve_form 'subst' or 'inv' (got "
            f"attitude_ref={cfg.srbd.attitude_ref!r}, horizon="
            f"{cfg.srbd.horizon}, solve_form="
            f"{cfg.srbd.solver.solve_form!r})")
    inv = cfg.srbd.solver.solve_form == "inv"
    if x0.device.type == "cpu":
        sol, xp, (z, y) = walking_qp_prep_plain(
            cfg, arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor,
            solve_form=plain_solve_form(cfg.srbd.solver.solve_form, 3,
                                        int(cfg.srbd.horizon)))
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
    (WALKING_MPC_PREP_INV if inv else WALKING_MPC_PREP).launch(
        mpc_params(cfg), [t.data_ptr() for t in ins + outs], B, dev)
    return z, y, res, xp


def make_walking_fused(cfg, solve_form: str | None = None):
    """Warm walking GRF solver from the full controller config:
    fn(arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor) ->
    (QPSolution, xi_pred, (z, y)), batch-first.

    solve_form=None: the ``walking_mpc_prep`` / ``walking_mpc_prep_inv``
    kernel for CUDA tensors, the plain composition with the explicit f32
    K^-1 (``"kinv"``, the JAX CPU path) for CPU tensors. A receding
    attitude reference runs that composition on CUDA tensors too: the
    in-kernel reference rows are level only, and the JAX package serves
    the receding form by its composition on the TPU as well
    (mpc_fused_pallas.py:913-916); its factorization is the ``cholesky``
    kernel. Any other config the kernel does not implement raises.
    solve_form="kinv" / "subst" / "linv": the plain composition with that
    solve form on any device.
    """
    if solve_form is not None and solve_form not in qps.SOLVE_FORMS:
        raise ValueError(f"solve_form must be None or one of "
                         f"{qps.SOLVE_FORMS}, got {solve_form!r}")
    iters = int(cfg.srbd.solver.admm_warm_iters)
    receding = cfg.srbd.attitude_ref == "receding"

    def solve(arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor):
        if solve_form is None and x0.device.type == "cuda" and not receding:
            if not supports_fused_walking_qp(cfg):
                raise NotImplementedError(
                    "walking MPC on CUDA: the walking_mpc_prep kernel takes "
                    f"horizon <= {MAX_HORIZON} and solve_form 'subst' or "
                    f"'inv' (got horizon={cfg.srbd.horizon}, solve_form="
                    f"{cfg.srbd.solver.solve_form!r})")
            args = [t.contiguous() for t in
                    (arms, x0, v_des, yaw_rate, z_warm, y_warm, anchor)]
            z, y, res, xp = fused_walking_qp_prep(*args, cfg=cfg)
            return QPSolution(u=z, iterations=iters, residual=res), xp, (z, y)
        return walking_qp_prep_plain(cfg, arms, x0, v_des, yaw_rate, z_warm,
                                     y_warm, anchor,
                                     solve_form=solve_form or "kinv")

    return solve


# ---- the generic fused QP (given Ad, Bd_t, x_ref) ---------------------------

def _one_foot(Gu, h, r_diag, nu: int, N: int):
    """(Gu1 [6][3], hu [6], r [3]) of one foot when Gu [2 nu][nu] is that
    foot's cone block repeated on the diagonal, h [2 nu N] its bounds
    repeated for every foot and step and r_diag [nu] its weights repeated
    per foot -- the only QPs the kernel applies; else ValueError."""
    Gu = np.asarray(Gu, np.float64)
    h = np.asarray(h, np.float64).reshape(-1)
    r = np.asarray(r_diag, np.float64).reshape(-1)
    if (Gu.shape != (2 * nu, nu) or h.shape != (2 * nu * N,)
            or r.shape != (nu,)):
        raise ValueError(f"fused_qp: Gu {Gu.shape} / h {h.shape} / r_diag "
                         f"{r.shape} do not fit nu = {nu}, N = {N}")
    feet = nu // 3
    Gu1, hu, r1 = Gu[:6, :3], h[:6], r[:3]
    if not (np.array_equal(Gu, np.kron(np.eye(feet), Gu1))
            and np.array_equal(h, np.tile(hu, feet * N))
            and np.array_equal(r, np.tile(r1, feet))):
        raise ValueError("fused_qp applies one foot's [6, 3] cone block, "
                         "bounds and weights to every foot and step; got "
                         "another Gu, h or r_diag")
    return tuple(map(tuple, Gu1)), tuple(hu), tuple(r1)


@functools.lru_cache(maxsize=16)
def _qp_params(nu, N, iters, rho, alpha, reg, q_diag, r_diag, p_diag, Gu,
               h) -> MpcParams:
    Gu1, hu, r1 = _one_foot(Gu, h, r_diag, nu, N)
    return _fill_params(dict(N=N, iters=iters, rho=rho, alpha=alpha, reg=reg,
                             q_diag=q_diag, r_diag=r1, p_diag=p_diag,
                             Gu=Gu1, hu=hu, ts=0.0, mass=1.0, height_des=0.0,
                             inertia=None), nu)


def fused_qp_plain(Ad, Bd_t, x_ref, x0, z_warm, y_warm, *, N, iters, rho,
                   alpha, q_diag, r_diag, p_diag, Gu, h,
                   solve_form: str = "kinv"):
    """Plain composition of the fused QP: condense + _batched_admm (the
    JAX make_admm_fused's ``_xla_batched``). Shapes as
    :func:`fused_walking_qp`; returns (QPSolution, (z, y))."""
    dtype, device = x0.dtype, x0.device

    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    G = torch.kron(torch.eye(N, dtype=dtype, device=device), t(Gu))
    qp = cnd.condense(Ad, Bd_t, torch.diag(t(q_diag)), torch.diag(t(r_diag)),
                      torch.diag(t(p_diag)), N, x0, x_ref, extra_G=G,
                      extra_h=t(h))
    return qps._batched_admm(qp.H, qp.f, qp.G, qp.h, z_warm, y_warm, iters,
                             rho, alpha, solve_form)


def fused_walking_qp(Ad, Bd_t, x_ref, x0, z_warm, y_warm, *, N: int,
                     iters: int, rho: float, alpha: float, reg: float,
                     q_diag, r_diag, p_diag, Gu, h,
                     solve_form: str = "subst"):
    """Batched fused condensation + warm-ADMM GRF solve (kernel wrapper).

    Ad [B,13,13] (any matrix); Bd_t [B,N,13,nu], nu = 3 or 6; x_ref
    [B,N+1,13]; x0 [B,13]; z_warm [B,N nu]; y_warm [B,2 N nu]. Static: the
    diagonal weights, the cone rows Gu [2 nu][nu] and bounds h [2 nu N] as
    nested tuples. Returns (z [B,n], y [B,m], residual [B]).

    CUDA tensors launch ``fused_qp_nu3`` / ``fused_qp_nu6``; CPU tensors
    run the plain version with exact triangular solves (``"subst"``).
    solve_form="inv" (the SolverConfig value) launches ``fused_qp_nu3_inv``
    / ``fused_qp_nu6_inv`` (plain: ``"linv"`` where n <= 64, ``"subst"``
    beyond).
    """
    nu = Bd_t.shape[-1]
    if nu not in FUSED_QP:
        raise ValueError(f"fused_qp takes nu = 3 or 6, got nu = {nu}, "
                         f"N = {N}")
    reason = size_reason(f"fused_qp_nu{nu}", N)
    if reason is not None:
        raise ValueError(f"fused_qp: {reason}")
    consts = dict(N=N, iters=iters, rho=rho, alpha=alpha, q_diag=q_diag,
                  r_diag=r_diag, p_diag=p_diag, Gu=Gu, h=h)
    prm = _qp_params(nu, N, iters, float(rho), float(alpha), float(reg),
                     tuple(q_diag), tuple(r_diag), tuple(p_diag),
                     tuple(map(tuple, Gu)), tuple(h))
    form = plain_solve_form(solve_form, nu, N)
    if x0.device.type == "cpu":
        sol, (z, y) = fused_qp_plain(Ad, Bd_t, x_ref, x0, z_warm, y_warm,
                                     solve_form=form, **consts)
        return z, y, sol.residual
    if x0.device.type != "cuda":
        raise ValueError(f"fused_qp runs on CUDA tensors, got {x0.device}")
    B = x0.shape[0]
    dev = x0.device
    ins = (("Ad", Ad, (B, NX, NX)), ("Bd_t", Bd_t, (B, N, NX, nu)),
           ("x_ref", x_ref, (B, N + 1, NX)), ("x0", x0, (B, NX)),
           ("z_warm", z_warm, (B, N * nu)),
           ("y_warm", y_warm, (B, 2 * N * nu)))
    for name, t, shape in ins:
        _build.check_tensor(name, t, shape, dev)
    z = torch.empty((B, N * nu), dtype=torch.float32, device=dev)
    y = torch.empty((B, 2 * N * nu), dtype=torch.float32, device=dev)
    res = torch.empty((B,), dtype=torch.float32, device=dev)
    (FUSED_QP_INV if solve_form == "inv" else FUSED_QP)[nu].launch(
        prm, [t.data_ptr() for _, t, _ in ins]
        + [t.data_ptr() for t in (z, y, res)], B, dev)
    return z, y, res


def make_admm_fused(cfg_srbd, two_feet: bool = False,
                    solve_form: str | None = None):
    """Warm fused condensation + ADMM solver of the stance GRF QP from the
    SRBDConfig: fn(Ad, Bd_t, x_ref, x0, z_warm, y_warm) ->
    (QPSolution, (z, y)), batch-first.

    two_feet=False: the single-support walking form (nu = 3, one cone).
    two_feet=True: the double-support standing form (nu = 6, one cone per
    foot, the input weights duplicated) -- controller.stance_mpc's QP.

    solve_form=None: the ``fused_qp`` kernel for CUDA tensors (the
    ``inv`` entry point when the config's solve_form is "inv"),
    the plain composition with the explicit f32 K^-1 (``"kinv"``, the JAX
    CPU path) for CPU tensors. solve_form="kinv" / "subst" / "linv": the
    plain composition with that solve form on any device.
    """
    if solve_form is not None and solve_form not in qps.SOLVE_FORMS:
        raise ValueError(f"solve_form must be None or one of "
                         f"{qps.SOLVE_FORMS}, got {solve_form!r}")
    k = cone_constants(cfg_srbd)
    feet = 2 if two_feet else 1
    Gu = tuple(map(tuple, np.kron(np.eye(feet), np.asarray(k["Gu"]))))
    consts = dict(N=k["N"], iters=k["iters"], rho=k["rho"], alpha=k["alpha"],
                  q_diag=k["q_diag"], r_diag=k["r_diag"] * feet,
                  p_diag=k["p_diag"], Gu=Gu, h=k["hu"] * feet * k["N"])

    def solve(Ad, Bd_t, x_ref, x0, z_warm, y_warm):
        if solve_form is None and x0.device.type == "cuda":
            args = [t.contiguous() for t in
                    (Ad, Bd_t, x_ref, x0, z_warm, y_warm)]
            z, y, res = fused_walking_qp(
                *args, reg=k["reg"], solve_form=cfg_srbd.solver.solve_form,
                **consts)
            return (QPSolution(u=z, iterations=k["iters"], residual=res),
                    (z, y))
        return fused_qp_plain(Ad, Bd_t, x_ref, x0, z_warm, y_warm,
                              solve_form=solve_form or "kinv", **consts)

    return solve
