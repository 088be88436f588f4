"""Analytic roofline model of the port's CUDA kernels on an NVIDIA H100.

Counterpart of ``mpc_limx_control_tpu.utils.roofline``, for the kernels
under ``ops/csrc``. Each count is derived from the kernel's loops: the
operations (a multiply or an add each) of one scenario, and the floats the
launch must read and write once (its pointer lists). The bound of a launch
is the larger of the two times the card could need for that work
(:func:`bound`); chip_smoke.py prints it beside every kernel's measured
time, and tools/roofline_torch.py divides a measured tick by it.

The peaks are the published ones of the H100 SXM part (NVIDIA's data
sheet, dense rates, at its 700 W power limit): assumed, not measured. A
card set below 700 W runs slower; state its ``nvidia-smi`` name and power
limit beside any share of these peaks.

The TPU model's MXU / VPU split has no counterpart here: the port's MPC
core applies the friction cone row by row (5 operations a row) and runs
no dense cone mat-vec.
"""

from __future__ import annotations

# the card's published peaks (H100 SXM, 700 W): HBM bytes/s, f32 FLOP/s
# outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
PEAKS = ("NVIDIA H100 SXM data sheet (published, not measured; at 700 W): "
         "HBM3 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s")

NX = 13                  # the SRBD state
SCALAR_TICK_OPS = 1e3    # gait, placement, FK / IK, plant step of a tick
KF_OPS = 6e3             # the 12-state filter of a tick


def core_flops_by_stage(N: int, nu: int, iters: int, dense_ad: bool,
                        nbd: int = 0) -> dict:
    """Operations of one condensation + factorization + warm ADMM as
    ops/csrc/mpc_core.cuh runs it, by stage (see :func:`core_flops`)."""
    n, nx = nu * N, NX
    ad_vec = 2 * nx * nx if dense_ad else 22   # Ad x, Ad' t, one column
    blocks, pairs = N * (N + 1) // 2, N * (N - 1) // 2
    return dict(
        prep=(243 + 66 * nbd * (nu // 3)) if nbd else 0,
        gramian=(N - 1) * (2 * nx * ad_vec + nx),    # Ad' W, (.) Ad, + Q
        band=(n * 2 * nx * nx                        # t = W_k Bd_k column
              + blocks * nu * nu * (2 * nx + 1)      # K blocks 2 t' Bd_j
              + pairs * nu * ad_vec),                # t <- Ad' t
        linear_term=N * (2 * ad_vec + 3 * nx + nu * (2 * nx + 1)),
        cholesky=n ** 3 / 3,
        sweeps=2 * (iters + 1) * n * n,    # forward + backward, n^2 each
        cone=((iters + 2) * 10 * n         # G z: 5 per row, 2 n rows
              + (iters + 1) * 20 * n       # -f + rho G'(v - y)
              + iters * 12 * n),           # relaxation, clip, dual
        prediction=ad_vec + 2 * nx * nu)


def core_flops(N: int, nu: int, iters: int, dense_ad: bool,
               nbd: int = 0) -> float:
    """Operations (a multiply or an add each) of one condensation +
    factorization + warm ADMM as ops/csrc/mpc_core.cuh runs it.

    `dense_ad`: every product with Ad is a dense 13-term one (fused_qp:
    2 * 13 per element); else the SRBD closed forms (22 per 13-vector or
    13-row column: two yaw-rotated rows at 5, four single couplings at 2
    and the double one at 4).  `nbd` > 0 adds the
    in-kernel linearization: I_w^-1 (243) and `nbd` Bd blocks of nu / 3
    feet (66 per foot: the moment arm, I_w^-1 [r]x, the scaled rows) --
    N blocks walking, one step-invariant block standing."""
    return sum(core_flops_by_stage(N, nu, iters, dense_ad, nbd).values())


def bound(B: int, floats_in: int, floats_out: int, flops: float) -> dict:
    """The least time the card could take: every input read once and every
    output written once over the HBM rate, or the operations over the f32
    rate, whichever is larger."""
    t_bytes = 4.0 * B * (floats_in + floats_out) / HBM_BPS * 1e3
    t_ops = B * flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes_ms=t_bytes, bound_operations_ms=t_ops)


def add_operations(tb: dict, B: int, ops: float) -> dict:
    """A :func:`bound` with `ops` more operations a scenario."""
    t_ops = tb["bound_operations_ms"] + B * ops / F32_FLOPS * 1e3
    return dict(tb, bound_operations_ms=t_ops,
                bound_ms=max(tb["bound_bytes_ms"], t_ops),
                bound_by="bytes" if tb["bound_bytes_ms"] >= t_ops
                else "operations")


def inv_ops(n: int) -> float:
    """What the ``inv`` solve form adds to the MPC core: the factor's
    inverse, n^3 / 3 operations (its two triangular mat-vecs cost what the
    two sweeps cost)."""
    return n ** 3 / 3


def _tick_floats(nu: int, N: int, est_kf: bool, hold: bool):
    """(floats in, floats out) of one tick launch (the pointer lists of
    ops/tick_fused_cuda.py): state, command, warm state or held force, the
    filter."""
    n = nu * N
    state, cmd = 13 + 6 + 3 + 3, 3 + 1 + 3 + 1
    f_in = state + cmd + (6 if hold else 3 * n) + (165 if est_kf else 0)
    f_out = state + 3 + 1 + 6 + 3 + (0 if hold else 3 * n) \
        + (156 if est_kf else 0)
    return f_in, f_out


def tick_bound(cfg, B: int, est_kf: bool, hold: bool) -> dict:
    """Bound of one tick kernel launch from its tensors' shapes (the
    pointer lists of ops/tick_fused_cuda.py) and the operations of the MPC
    core (none when holding), the filter (~6k) and the scalar tick (~1k)."""
    nu = 6 if cfg.mode == "stand" else 3
    N = cfg.srbd.horizon
    f_in, f_out = _tick_floats(nu, N, est_kf, hold)
    flops = SCALAR_TICK_OPS + (KF_OPS if est_kf else 0.0) + (
        0.0 if hold else core_flops(
            N, nu, cfg.srbd.solver.admm_warm_iters, dense_ad=False,
            nbd=1 if cfg.mode == "stand" else N))
    return bound(B, f_in, f_out, flops)


def prep_bound(B: int, N: int, iters: int, extra_ops: float = 0.0) -> dict:
    """Bound of one ``walking_mpc_prep`` launch (in: x0, arms, v_des, yaw
    rate, z, y, anchor; out: z, y, residual, predicted state)."""
    return bound(B, 13 + 3 * N + 3 + 1 + 9 * N + 3, 9 * N + 1 + 13,
                 core_flops(N, 3, iters, dense_ad=False, nbd=N) + extra_ops)


def fused_qp_bound(B: int, N: int, nu: int, iters: int,
                   extra_ops: float = 0.0) -> dict:
    """Bound of one ``fused_qp_nu{nu}`` launch (in: Ad, Bd_t, x_ref, x0, z,
    y; out: z, y, residual)."""
    n = nu * N
    return bound(B, 169 + N * 13 * nu + (N + 1) * 13 + 13 + 3 * n,
                 3 * n + 1, core_flops(N, nu, iters, dense_ad=True)
                 + extra_ops)


def chol_bound(name: str, B: int, n: int, k: int) -> dict:
    """Bound of one launch of a csrc/chol.cu kernel from its shapes: the
    lower triangle of the matrix (the function reads nothing else) and the
    right-hand sides read once, the result written once (cholesky: all
    n^2 of L, zeros included); n^3 / 3 operations for a factorization,
    2 n^2 k for both sweeps."""
    tri = n * (n + 1) // 2
    if name == "cholesky":
        return bound(B, tri, n * n, n ** 3 / 3)
    factor = 0.0 if name == "chol_solve" else n ** 3 / 3
    return bound(B, tri + n * k, n * k, factor + 2.0 * n * n * k)


def pdip_flops(n: int, m: int) -> float:
    """Operations of one Newton step of csrc/pdip_fused.cu for one QP:
    G' diag(d) G (lower triangle, a multiply-add per term, d applied per
    row), M = H + . + reg I, the factorization n^3 / 3, four sweeps of n^2,
    the mat-vecs H z, G z, G' lam and per direction G' w and G dz, ~40
    operations per inequality row."""
    return (m * n * (n + 1) + m * n + n * (n + 1) / 2 + n ** 3 / 3
            + 4 * n * n + 2 * n * n + 12 * m * n + 40 * m)


def pdip_bound(B: int, n: int, m: int, iters: int) -> dict:
    """Bound of one pdip_fused launch: H, f, G, h, z0, s0, lam0 read once,
    z_best, merit, z_final, lam_final written once; `iters` Newton
    steps."""
    return bound(B, n * n + 2 * n + m * n + 3 * m, 2 * n + 1 + m,
                 iters * pdip_flops(n, m))


def _check_shapes(nx: int, nu: int, mu_: int) -> None:
    if nx != NX or nu not in (3, 6) or mu_ != 2 * nu:
        raise ValueError(f"the tick kernels take nx = {NX}, nu = 3 or 6 "
                         f"and one [6, 3] cone a foot (mu = 2 nu); got "
                         f"nx = {nx}, nu = {nu}, mu = {mu_}")


def fused_tick_flops(N=20, nx=13, nu=3, mu_=6, iters=5, kf=False) -> dict:
    """Operations a scenario of one solving tick launch (``walking_tick``
    for nu = 3, ``standing_tick`` for nu = 6; ``_kf`` with `kf`), by stage
    and in total: the MPC core of :func:`core_flops_by_stage` with the SRBD
    closed forms, the scalar tick and the filter. The total is the one
    :func:`tick_bound` divides by the f32 rate."""
    _check_shapes(nx, nu, mu_)
    stages = core_flops_by_stage(N, nu, iters, dense_ad=False,
                                 nbd=1 if nu == 6 else N)
    stages["tick_rest"] = SCALAR_TICK_OPS
    if kf:
        stages["kf"] = KF_OPS
    total = SCALAR_TICK_OPS + (KF_OPS if kf else 0.0) + core_flops(
        N, nu, iters, dense_ad=False, nbd=1 if nu == 6 else N)
    return {"flops_by_stage": stages, "total_flops": total}


def fused_tick_hbm_bytes(N=20, nu=3, mu_=6, kf=False) -> int:
    """Bytes a scenario one solving tick launch must read and write once
    (float32; the floats of :func:`tick_bound`)."""
    _check_shapes(NX, nu, mu_)
    f_in, f_out = _tick_floats(nu, N, kf, hold=False)
    return 4 * (f_in + f_out)


def kernel_bounds(B: int = 4096) -> dict:
    """Entry point name -> :func:`bound` dict at the shapes chip_smoke.py
    times (``ControllerConfig.walking()`` / ``.standing()``, N = 20; the
    standing ``inv`` entries at N = 8; the Cholesky kernels at n = 60 and
    120, k = 1, keyed ``<name>_n<n>``; ``pdip_fused`` 20 Newton steps on
    the walking (n = 60, m = 120) and standing (120, 240) QPs)."""
    import dataclasses

    from mpc_limx_control_tpu_torch.core.config import ControllerConfig

    walk = ControllerConfig.walking()
    stand = ControllerConfig.standing()
    N, it = walk.srbd.horizon, walk.srbd.solver.admm_warm_iters
    out = {}
    for mode, c in (("walking", walk), ("standing", stand)):
        for kf in (False, True):
            for hold in (False, True):
                name = f"{mode}_tick" + ("_kf" if kf else "") \
                    + ("_hold" if hold else "")
                out[name] = tick_bound(c, B, kf, hold)
    out["walking_mpc_prep"] = prep_bound(B, N, it)
    out["walking_mpc_prep_inv"] = prep_bound(B, N, it, inv_ops(3 * N))
    for nu in (3, 6):
        out[f"fused_qp_nu{nu}"] = fused_qp_bound(B, N, nu, it)
    out["fused_qp_nu3_inv"] = fused_qp_bound(B, N, 3, it, inv_ops(3 * N))
    stand8 = dataclasses.replace(stand, srbd=dataclasses.replace(
        stand.srbd, horizon=8))
    for kf in (False, True):
        sfx = "_kf_inv" if kf else "_inv"
        out["walking_tick" + sfx] = add_operations(
            tick_bound(walk, B, kf, False), B, inv_ops(3 * N))
        out["standing_tick" + sfx] = add_operations(
            tick_bound(stand8, B, kf, False), B, inv_ops(6 * 8))
    out["fused_qp_nu6_inv"] = fused_qp_bound(B, 8, 6, it, inv_ops(6 * 8))
    for name in ("cholesky", "chol_solve", "posdef_solve",
                 "posdef_solve_fast"):
        for n in (60, 120):
            out[f"{name}_n{n}"] = chol_bound(name, B, n, 1)
    out["pdip_fused_n60"] = pdip_bound(B, 60, 120, 20)
    out["pdip_fused_n120"] = pdip_bound(B, 120, 240, 20)
    return out
