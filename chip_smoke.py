"""Chip smoke for the PyTorch/CUDA port: drive the walking and standing
closed loops on one NVIDIA GPU through the port's own entry points and
check its kernels.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is
non-zero):

1. torch / CUDA versions, TF32 flags, the card's name and power limit;
2. build the kernels from ops/csrc (nvcc, sm_90a) and print the build time;
3. ``walking_mpc_prep`` against its plain version (exact-solve ADMM) at
   N = 20 and N = 8, B = 257, numpy-seeded inputs; ``fused_qp_nu3`` /
   ``fused_qp_nu6`` (given, dense Ad) against theirs at N = 20, B = 257;
4. ``walking_tick`` and its hold, KF and KF + hold variants against the
   plain tick at B = 257: one tick with staggered iterations (both swing
   sides, 299/300), then five threaded ticks; the four ``standing_tick``
   forms likewise at full width (n = 120);
5. the main paths, each run with every kernel's launch counter set to 0
   just before it and checked just after (one launch per tick of the
   path's own kind, none of any other): closed-loop quality through
   ``batched_rollout`` / ``rollout`` (walking, turning, push, terrain; the
   KF straight, turning and push gates; the dtMPC schedule with truth and
   with KF odometry; the bands of bench.py and
   tests/test_mpc_schedule.py), a ``controller.tick`` closed loop,
   20-window x 1000-tick ``soak_rollout`` soaks at B = 64 of the KF loop
   and of the dtMPC schedule (the 10k-tick bands of tests/test_soak.py);
   then standing: bench.py's ``stand_ok`` (2000 ticks) and ``kf_stand_ok``
   (1200 ticks), the standing dtMPC schedule with truth and KF odometry,
   a standing ``controller.tick`` closed loop (``fused_qp_nu6``) and the
   ``make_admm_fused`` entry point with one foot (``fused_qp_nu3``, held
   against ``walking_mpc_prep`` on the same QP);
6. with CUDA events at B = 1, 1024 and 4096: the time per tick of each
   tick form through ``plant_step`` and of its plain version, the tick
   kernel alone, and the prep and fused-QP kernels and their plain
   versions; then the ``batched_rollout`` rate at B = 4096 for truth
   odometry, the KF and the dtMPC schedule, walking and standing. Each
   kernel's bound (the card's least time for the same bytes and
   operations) is worked out from the shapes of this run.

It prints the kernels' JSON summary on the line before the last and, as
the last line, {"ok": true, "device": {...}}. Without a CUDA card it exits
with code 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

CSRC = "mpc_limx_control_tpu_torch/ops/csrc/"
PREP_SRC = CSRC + "walking_mpc_prep.cu"
TICK_SRC = CSRC + "walking_tick.cu"
STAND_SRC = CSRC + "standing_tick.cu"
QP_SRC = CSRC + "fused_qp.cu"
PREP_TPU = "mpc_limx_control_tpu/ops/mpc_fused_pallas.py:374"
QP_TPU = "mpc_limx_control_tpu/ops/mpc_fused_pallas.py:355"
TICK_TPU = "mpc_limx_control_tpu/ops/tick_fused_pallas.py:130"
# (est_kf, hold) -> kernel name; the four forms of the TPU tick kernel
VARIANTS = {(False, False): "walking_tick", (False, True): "walking_tick_hold",
            (True, False): "walking_tick_kf",
            (True, True): "walking_tick_kf_hold"}
STAND_VARIANTS = {k: v.replace("walking", "standing")
                  for k, v in VARIANTS.items()}
# the card's published peaks (H100 SXM): HBM bytes/s, f32 FLOP/s outside
# the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# the bench.py push: +0.3 m/s lateral velocity at tick 600
PUSH = torch.tensor([0.0] * 10 + [0.3, 0.0, 0.0])


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=float), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def maxerr(a, b) -> float:
    return float((a - b).abs().max())


def prep_inputs(cfg, B: int, seed: int, device):
    """Walking QP inputs (tests/test_mpc_fused.py:156-175 recipe, drawn
    with numpy): perturbed pose, arms under the hips, warm state."""
    from mpc_limx_control_tpu_torch.models import srbd

    N = cfg.srbd.horizon
    rng = np.random.default_rng(seed)
    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    yaw = 0.1 * rng.standard_normal(B)
    arms = (pos[:, None, :] + np.array([0.02, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, N, 3)))
    ori = np.concatenate([0.01 * rng.standard_normal((B, 2)), yaw[:, None]],
                         -1)
    vel = np.array([0.4, 0.0, 0.0]) + np.zeros((B, 3))
    yaw_rate = 0.05 * rng.standard_normal(B)
    z_w = 5.0 * rng.standard_normal((B, 3 * N))
    y_w = np.abs(rng.standard_normal((B, 6 * N)))

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    x0 = srbd.initial_state(t(ori), t(pos), t(np.zeros((B, 3))), t(vel))
    anchor = torch.cat([x0[:, 3:5], x0[:, 2:3]], -1).contiguous()
    v_des = t(np.broadcast_to([0.5, 0.0, 0.0], (B, 3)).copy())
    return (t(arms), x0.contiguous(), v_des, t(yaw_rate), t(z_w), t(y_w),
            anchor)


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
    n, nx = nu * N, 13
    ad_vec = 2 * nx * nx if dense_ad else 22   # Ad x, Ad' t, one column
    blocks, pairs = N * (N + 1) // 2, N * (N - 1) // 2
    prep = (243 + 66 * nbd * (nu // 3)) if nbd else 0
    gram = (N - 1) * (2 * nx * ad_vec + nx)    # Ad' W, (.) Ad, + Q
    band = (n * 2 * nx * nx                    # t = W_k Bd_k column
            + blocks * nu * nu * (2 * nx + 1)  # K blocks 2 t' Bd_j
            + pairs * nu * ad_vec)             # t <- Ad' t
    fsweep = N * (2 * ad_vec + 3 * nx + nu * (2 * nx + 1))
    chol = n ** 3 / 3
    sweeps = 2 * (iters + 1) * n * n           # forward + backward, n^2 each
    cone = ((iters + 2) * 10 * n               # G z: 5 per row, 2 n rows
            + (iters + 1) * 20 * n             # -f + rho G'(v - y)
            + iters * 12 * n)                  # relaxation, clip, dual
    pred = ad_vec + 2 * nx * nu
    return prep + gram + band + fsweep + chol + sweeps + cone + pred


def bound(B: int, floats_in: int, floats_out: int, flops: float) -> dict:
    """The least time the card could take: every input read once and every
    output written once over the HBM rate, or the operations over the f32
    rate, whichever is larger."""
    t_bytes = 4.0 * B * (floats_in + floats_out) / HBM_BPS * 1e3
    t_ops = B * flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes_ms=t_bytes, bound_operations_ms=t_ops)


def tick_bound(cfg, B: int, est_kf: bool, hold: bool) -> dict:
    """Bound of one tick kernel launch from its tensors' shapes (the
    pointer lists of ops/tick_fused_cuda.py) and the operations of the MPC
    core (none when holding), the filter (~6k) and the scalar tick (~1k)."""
    nu = 6 if cfg.mode == "stand" else 3
    n = nu * cfg.srbd.horizon
    state, cmd = 13 + 6 + 3 + 3, 3 + 1 + 3 + 1
    f_in = state + cmd + (6 if hold else 3 * n) + (165 if est_kf else 0)
    f_out = state + 3 + 1 + 6 + 3 + (0 if hold else 3 * n) \
        + (156 if est_kf else 0)
    N = cfg.srbd.horizon
    flops = 1e3 + (6e3 if est_kf else 0.0) + (0.0 if hold else core_flops(
        N, nu, cfg.srbd.solver.admm_warm_iters, dense_ad=False,
        nbd=1 if cfg.mode == "stand" else N))
    return bound(B, f_in, f_out, flops)


def qp_inputs(cfg, nu: int, B: int, seed: int, device):
    """Inputs of the generic fused QP: the SRBD matrices of perturbed
    poses with a dense perturbation on Ad (the kernel takes any Ad), a
    walking reference and a warm state, drawn with numpy."""
    from mpc_limx_control_tpu_torch.models import srbd

    N = cfg.srbd.horizon
    rng = np.random.default_rng(seed)
    feet = nu // 3

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    ori = np.concatenate([0.01 * rng.standard_normal((B, 2)),
                          0.1 * rng.standard_normal((B, 1))], -1)
    x0 = srbd.initial_state(t(ori), t(pos), t(np.zeros((B, 3))),
                            t(0.1 * rng.standard_normal((B, 3))))
    arms = (pos[:, None, None, :] + np.array([0.0, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, N, feet, 3)))
    if feet == 2:
        arms[:, :, 1, 1] -= 0.2
    Ac, Bc = srbd.linearize_shared(cfg.robot, t(arms.reshape(B, -1, 3)),
                                   x0[:, 3:6], x0[:, 2])
    Ad, Bd = srbd.discretize_srbd(Ac, Bc, cfg.srbd.ts)
    Bd_t = Bd.reshape(B, N, feet, 13, 3).permute(0, 1, 3, 2, 4).reshape(
        B, N, 13, nu)
    Ad = Ad + t(2e-3 * rng.standard_normal((B, 13, 13)))
    x_ref = srbd.walking_reference(
        x0, cfg.srbd, N, t(np.tile([0.3, 0.0, 0.0], (B, 1))),
        t(0.05 * rng.standard_normal(B)), height_des=0.65)
    return (Ad.contiguous(), Bd_t.contiguous(), x_ref.contiguous(),
            x0.contiguous(), t(5.0 * rng.standard_normal((B, N * nu))),
            t(np.abs(rng.standard_normal((B, 2 * N * nu)))))


def perturbed_states(cfg, B: int, seed: int, device, yaw: float = 0.1):
    """Initial states with perturbed vx, vy and yaw
    (tests/test_tick_fused.py:_states recipe, drawn with numpy)."""
    from mpc_limx_control_tpu_torch.control import rollout as ro

    s0 = ro.initial_plant_state(cfg, batch=(B,), device=device)
    if cfg.mode == "stand":
        yaw = 0.0     # standing states are kicked in vx / vy only
    rng = np.random.default_rng(seed)
    xi = s0.xi.clone()
    noise = torch.tensor(rng.standard_normal((3, B)), dtype=torch.float32,
                         device=device)
    xi[:, 9] += 0.08 * noise[0]
    xi[:, 10] += 0.05 * noise[1]
    xi[:, 2] += yaw * noise[2]
    return s0.replace(xi=xi)


def tick_both(cfg, s_k, s_p, its, held=None):
    """One tick through the kernel (plant_step) and the plain tick."""
    from mpc_limx_control_tpu_torch.control import rollout as ro

    s_k, m_k = ro.plant_step(cfg, s_k, its, grf_override=held)
    s_p, m_p = ro._plant_step_ref(cfg, s_p, its, grf_override=held,
                                  solve_form="subst")
    return s_k, m_k, s_p, m_p


def variant_vs_plain(cfg, est_kf: bool, hold: bool, B: int, device):
    """A tick variant (walking or standing, by the config's mode) against
    the plain tick from states three plain ticks in (the filter and
    prev_v / prev_q past their seed): one tick and five threaded ticks.
    Returns (errors after one tick, after five)."""
    from mpc_limx_control_tpu_torch.control import rollout as ro

    if est_kf:
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    # no yaw kick for the filter (as in the JAX KF tests): a yaw off the
    # joints' frame puts its measured feet ~10 cm from its state, and
    # within three ticks some swing targets leave the leg's reach, where
    # the IK branch is a tie that rounding decides
    stand = cfg.mode == "stand"
    s0 = perturbed_states(cfg, B, seed=1, device=device,
                          yaw=0.0 if est_kf else 0.1)
    pattern = torch.tensor([0.0, 40.0, 180.0, 299.0, 300.0, 455.0],
                           dtype=torch.float32, device=device)
    its = pattern.repeat(B // 6 + 1)[:B]
    for j in range(3):
        s0, m0 = ro._plant_step_ref(cfg, s0, its + j, solve_form="subst")
    its = its + 3.0
    held = m0["grf"] if hold else None

    def errs(s_k, m_k, s_p, m_p):
        e = dict(xi=maxerr(s_k.xi, s_p.xi), q=maxerr(s_k.q, s_p.q),
                 foot_l=maxerr(s_k.foot_l, s_p.foot_l),
                 foot_r=maxerr(s_k.foot_r, s_p.foot_r),
                 grf=maxerr(m_k["grf"], m_p["grf"]),
                 target=maxerr(m_k["foot_target"], m_p["foot_target"]),
                 finite=bool(torch.isfinite(s_k.xi).all()))
        if stand:
            check(s_k.ref_anchor is None, "standing state grew an anchor")
            e["anchor"] = 0.0
            if not hold:
                e["z"] = maxerr(s_k.qp_z, s_p.qp_z)
                e["z_scale"] = float(s_p.qp_z.abs().max()) + 1.0
        else:
            e["anchor"] = maxerr(s_k.ref_anchor, s_p.ref_anchor)
        if hold:
            e["res_max"] = float(m_k["qp_residual"].abs().max())
        if est_kf:
            e.update(x_hat=maxerr(s_k.kf.x_hat, s_p.kf.x_hat),
                     p_cov=maxerr(s_k.kf.p_cov, s_p.kf.p_cov),
                     est_error=maxerr(m_k["est_error"], m_p["est_error"]))
        return e

    e1 = errs(*tick_both(cfg, s0, s0, its, held))
    s_k = s_p = s0
    for j in range(5):
        s_k, m_k, s_p, m_p = tick_both(cfg, s_k, s_p, its + j, held)
    torch.cuda.synchronize()
    return e1, errs(s_k, m_k, s_p, m_p)


def loop_rate(cfg, B: int, steps: int, device, mpc_every: int = 1):
    """batched_rollout scenario-ticks/s at B (host clock around a
    synchronized run of `steps` ticks, after a short warm-up)."""
    from mpc_limx_control_tpu_torch.control import rollout as ro

    s = perturbed_states(cfg, B, seed=4, device=device)
    ro.batched_rollout(cfg, s, 10, mpc_every=mpc_every)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ro.batched_rollout(cfg, s, steps, mpc_every=mpc_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return B * steps / wall, 1e3 * wall / steps


def cuda_time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    import mpc_limx_control_tpu_torch  # noqa: F401  (sets the TF32 pins)
    from mpc_limx_control_tpu_torch.control import controller as ctrl
    from mpc_limx_control_tpu_torch.control import rollout as ro
    from mpc_limx_control_tpu_torch.core.config import ControllerConfig
    from mpc_limx_control_tpu_torch.ops import _build
    from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as mfc
    from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc

    dev = torch.device("cuda", 0)
    kernels = {"walking_mpc_prep": mfc.WALKING_MPC_PREP}
    kernels.update({VARIANTS[v]: k for v, k in tfc.TICK_KERNELS.items()})
    kernels.update({STAND_VARIANTS[v]: k
                    for v, k in tfc.STAND_KERNELS.items()})
    kernels.update({f"fused_qp_nu{nu}": k for nu, k in mfc.FUSED_QP.items()})
    for name, kern in kernels.items():
        check(kern.name == name, f"kernel {kern.name} listed as {name}")

    # ---- 1. environment ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 pins are not set")
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
        matmul_precision=torch.get_float32_matmul_precision())

    # ---- 2. build -------------------------------------------------------
    info = _build.build_library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    lib = info["lib"]
    smem = {f"{name}_N{N}": getattr(lib, f"{name}_smem_bytes")(N)
            for name in ("walking_mpc_prep", "walking_tick", "walking_tick_kf",
                         "standing_tick", "standing_tick_kf", "fused_qp_nu3",
                         "fused_qp_nu6")
            for N in (8, 20)}
    say("build", seconds=round(info["seconds"], 3), built=info["built"],
        library=info["path"], ptxas=ptxas, dynamic_smem_bytes=smem)

    summary = {k: {"name": k, "route": "cuda"} for k in kernels}
    summary["walking_mpc_prep"].update(source=PREP_SRC, replaces=PREP_TPU)
    for name in VARIANTS.values():
        summary[name].update(source=TICK_SRC, replaces=TICK_TPU)
    for name in STAND_VARIANTS.values():
        summary[name].update(source=STAND_SRC, replaces=TICK_TPU)
    for nu in mfc.FUSED_QP:
        summary[f"fused_qp_nu{nu}"].update(source=QP_SRC, replaces=QP_TPU)
    # no single PyTorch call computes a whole tick or a condensed-QP ADMM
    # solve, so no kernel has a library yardstick
    for k in kernels:
        summary[k]["library_ms"] = None

    # ---- 3. walking_mpc_prep vs its plain version -----------------------
    base = ControllerConfig.walking()
    prep_err = 0.0
    for N in (20, 8):
        cfg = dataclasses.replace(
            base, srbd=dataclasses.replace(base.srbd, horizon=N))
        args = prep_inputs(cfg, 257, seed=21 + N, device=dev)
        z, y, res, xp = mfc.fused_walking_qp_prep(*args, cfg=cfg)
        torch.cuda.synchronize()
        sol, xp_p, (z_p, y_p) = mfc.walking_qp_prep_plain(
            cfg, *args, solve_form="subst")
        scale = float(z_p.abs().max()) + 1.0
        e = dict(u=maxerr(z, z_p), y=maxerr(y, y_p),
                 xi_pred=maxerr(xp, xp_p), res=maxerr(res, sol.residual))
        say("prep_vs_plain", N=N, B=257, scale=scale, **e,
            finite=bool(torch.isfinite(z).all()))
        check(bool(torch.isfinite(z).all() and torch.isfinite(y).all()),
              "walking_mpc_prep output not finite")
        check(e["u"] <= 2e-3 * scale, f"u error {e['u']} > 2e-3*{scale}")
        check(e["y"] <= 2e-3 * scale, f"y error {e['y']} > 2e-3*{scale}")
        check(e["xi_pred"] <= 1e-3 * scale,
              f"xi_pred error {e['xi_pred']} > 1e-3*{scale}")
        if N == 20:
            prep_err = e["u"]
    summary["walking_mpc_prep"]["max_abs_err"] = prep_err

    # the generic fused QP (given, dense Ad), one and two feet per step
    for nu in mfc.FUSED_QP:
        args = qp_inputs(base, nu, 257, seed=40 + nu, device=dev)
        solve = mfc.make_admm_fused(base.srbd, two_feet=nu == 6)
        sol, (z, y) = solve(*args)
        torch.cuda.synchronize()
        sol_p, (z_p, y_p) = mfc.make_admm_fused(
            base.srbd, two_feet=nu == 6, solve_form="subst")(*args)
        # bands a few times the f32 rounding of the two routes, each on
        # its own scale: forces of ~100 N, duals of a few N
        scale = float(z_p.abs().max()) + 1.0
        y_scale = float(y_p.abs().max()) + 1.0
        e = dict(u=maxerr(z, z_p), y=maxerr(y, y_p),
                 res=maxerr(sol.residual, sol_p.residual))
        say("fused_qp_vs_plain", nu=nu, N=20, B=257, scale=scale,
            y_scale=y_scale, **e, finite=bool(torch.isfinite(z).all()))
        check(bool(torch.isfinite(z).all() and torch.isfinite(y).all()),
              f"fused_qp_nu{nu} output not finite")
        check(e["u"] <= 1e-4 * scale, f"nu={nu} u error {e['u']}")
        check(e["y"] <= 1e-4 * y_scale, f"nu={nu} y error {e['y']}")
        check(e["res"] <= 1e-4, f"nu={nu} residual error {e['res']}")
        summary[f"fused_qp_nu{nu}"]["max_abs_err"] = e["u"]

    # ---- 4. walking_tick vs the plain tick ------------------------------
    cfg = base
    B = 257
    s0 = perturbed_states(cfg, B, seed=0, device=dev)
    pattern = torch.tensor([0.0, 40.0, 180.0, 299.0, 300.0, 455.0],
                           dtype=torch.float32, device=dev)
    its = pattern.repeat(B // 6 + 1)[:B]
    its = its + 600.0 * (torch.arange(B, device=dev) // 6 % 3)
    s_k, m_k, s_p, m_p = tick_both(cfg, s0, s0, its)
    torch.cuda.synchronize()
    e1 = dict(xi=maxerr(s_k.xi, s_p.xi), q=maxerr(s_k.q, s_p.q),
              foot_l=maxerr(s_k.foot_l, s_p.foot_l),
              foot_r=maxerr(s_k.foot_r, s_p.foot_r),
              grf=maxerr(m_k["grf"], m_p["grf"]),
              z9=maxerr(s_k.qp_z[:, :9], s_p.qp_z[:, :9]),
              anchor=maxerr(s_k.ref_anchor, s_p.ref_anchor),
              target=maxerr(m_k["foot_target"], m_p["foot_target"]))
    say("tick_vs_plain_1", B=B, **e1)
    for k, tol in (("xi", 3e-4), ("q", 5e-4), ("foot_l", 5e-4),
                   ("foot_r", 5e-4), ("grf", 5e-2), ("z9", 5e-2)):
        check(e1[k] <= tol, f"one-tick {k} error {e1[k]} > {tol}")
    summary["walking_tick"]["max_abs_err"] = e1["xi"]
    s_k, s_p = s0, s0
    for j in range(5):
        s_k, m_k, s_p, m_p = tick_both(cfg, s_k, s_p, its + 10.0 + j)
    torch.cuda.synchronize()
    e5 = dict(xi=maxerr(s_k.xi, s_p.xi), q=maxerr(s_k.q, s_p.q),
              grf=maxerr(m_k["grf"], m_p["grf"]))
    say("tick_vs_plain_5", B=B, **e5)
    for k, tol in (("xi", 5e-4), ("q", 1e-3), ("grf", 2e-1)):
        check(e5[k] <= tol, f"five-tick {k} error {e5[k]} > {tol}")

    # the hold, KF and KF + hold variants (bands of tests/test_torch_cuda)
    for (est_kf, hold), name in VARIANTS.items():
        if name == "walking_tick":
            continue
        v1, v5 = variant_vs_plain(cfg, est_kf, hold, B, dev)
        say("variant_vs_plain", kernel=name, B=B, one=v1, five=v5)
        bands1 = [("xi", 3e-4), ("q", 5e-4), ("foot_l", 5e-4),
                  ("foot_r", 5e-4), ("grf", 5e-2), ("target", 5e-4),
                  ("anchor", 1e-5)]
        bands5 = [("xi", 5e-4), ("q", 1e-3), ("grf", 2e-1)]
        if est_kf:
            bands1 += [("x_hat", 5e-4), ("p_cov", 1e-5), ("est_error", 5e-4)]
            bands5 += [("x_hat", 5e-4), ("p_cov", 1e-5)]
        for k, tol in bands1:
            check(v1[k] <= tol, f"{name} one-tick {k} error {v1[k]} > {tol}")
        for k, tol in bands5:
            check(v5[k] <= tol, f"{name} five-tick {k} error {v5[k]} > {tol}")
        check(v1["finite"] and v5["finite"], f"{name}: non-finite state")
        if hold:
            check(v1["res_max"] == 0.0 and v5["res_max"] == 0.0,
                  f"{name}: held tick with a non-zero residual")
        summary[name]["max_abs_err"] = v1["xi"]

    # the four standing forms at full width (n = 120), same bands; the
    # feet do not move, the solving forms' z within 2e-3 of its scale
    scfg = ControllerConfig.standing()
    for (est_kf, hold), name in STAND_VARIANTS.items():
        v1, v5 = variant_vs_plain(scfg, est_kf, hold, B, dev)
        say("variant_vs_plain", kernel=name, B=B, one=v1, five=v5)
        bands1 = [("xi", 3e-4), ("q", 5e-4), ("foot_l", 0.0),
                  ("foot_r", 0.0), ("grf", 5e-2), ("target", 5e-4)]
        bands5 = [("xi", 5e-4), ("q", 1e-3), ("grf", 2e-1)]
        if est_kf:
            bands1 += [("x_hat", 5e-4), ("p_cov", 1e-5), ("est_error", 5e-4)]
            bands5 += [("x_hat", 5e-4), ("p_cov", 1e-5)]
        for k, tol in bands1:
            check(v1[k] <= tol, f"{name} one-tick {k} error {v1[k]} > {tol}")
        for k, tol in bands5:
            check(v5[k] <= tol, f"{name} five-tick {k} error {v5[k]} > {tol}")
        check(v1["finite"] and v5["finite"], f"{name}: non-finite state")
        if hold:
            check(v1["res_max"] == 0.0 and v5["res_max"] == 0.0
                  and v1["grf"] == 0.0,
                  f"{name}: held tick changed the force or has a residual")
        else:
            check(v1["z"] <= 2e-3 * v1["z_scale"],
                  f"{name} z error {v1['z']} > 2e-3*{v1['z_scale']}")
        summary[name]["max_abs_err"] = v1["xi"]

    # ---- 5. the main paths: closed-loop quality on the kernels ----------
    # Each path runs with every launch counter set to 0 just before it and
    # read just after: its kernels must have launched once per tick of
    # their kind, and no other kernel at all.
    q = {}
    launches = {k: 0 for k in kernels}
    t_main = time.perf_counter()

    def path(name, run, expect):
        for kern in kernels.values():
            kern.reset()
        run()
        torch.cuda.synchronize()
        got = {k: kern.launches for k, kern in kernels.items()}
        want = {k: expect.get(k, 0) for k in kernels}
        say("path", name=name, launches=got, expected=want)
        check(got == want and all(got[k] > 0 for k in expect),
              f"path {name}: launches {got}, expected {want}")
        for k, v in got.items():
            launches[k] += v

    def ticks(est_kf, steps, mpc_every=1, names=VARIANTS):
        """Launches of a batched rollout: one per tick, the solving
        variant on every mpc_every-th tick, the hold variant between."""
        solves = steps // mpc_every
        out = {names[(est_kf, False)]: solves}
        if steps > solves:
            out[names[(est_kf, True)]] = steps - solves
        return out

    # the four bench.py walking scenarios, truth odometry
    def truth_gates():
        Bw = 64
        s = ro.initial_plant_state(cfg, batch=(Bw,), device=dev)
        rng = np.random.default_rng(7)
        s = s.replace(xi=s.xi + torch.tensor(
            np.outer(0.05 * rng.standard_normal(Bw), np.eye(13)[9]),
            dtype=torch.float32, device=dev))
        _, m = ro.batched_rollout(cfg, s, 3000)
        h, vx = m["height"][:, -600:], m["velocity"][:, -600:, 0]
        q["walk_height_mean"] = float(h.mean())
        q["walk_vx_mean"] = float(vx.mean())
        q["walk_nan_free"] = bool(torch.isfinite(m["height"]).all()
                                  and torch.isfinite(m["velocity"]).all())
        q["walk_ok"] = (q["walk_nan_free"]
                        and abs(q["walk_height_mean"] - 0.65) < 0.02
                        and abs(q["walk_vx_mean"] - 0.5) < 0.05)

        tcfg = dataclasses.replace(cfg, desired_yaw_rate=0.3)
        tf_, tm = ro.rollout(tcfg, ro.initial_plant_state(tcfg, device=dev),
                             1500)
        q["turn_height_min"] = float(tm["height"].min())
        q["turn_yaw"] = float(tf_.xi[2])
        q["turn_ok"] = bool(q["turn_height_min"] > 0.5
                            and abs(q["turn_yaw"] - 0.45) <= 0.045
                            and torch.isfinite(tm["height"]).all())

        p1, pm1 = ro.rollout(cfg, ro.initial_plant_state(cfg, device=dev),
                             600)
        pushed = p1.replace(xi=p1.xi + PUSH.to(dev))
        _, pm2 = ro.rollout(cfg, pushed, 900, start_iteration=600)
        ph = torch.cat([pm1["height"], pm2["height"]])
        pv = pm2["velocity"]
        q["push_height_min"] = float(ph.min())
        q["push_ok"] = bool(q["push_height_min"] > 0.5
                            and abs(float(pv[-300:, 0].mean()) - 0.5) < 0.2
                            and abs(float(pv[-300:, 1].mean())) < 0.2
                            and torch.isfinite(ph).all())

        gcfg = dataclasses.replace(cfg, ground_height=0.15)
        _, gm = ro.rollout(gcfg, ro.initial_plant_state(gcfg, device=dev),
                           900)
        q["terrain_height_mean"] = float(gm["height"][-300:].mean())
        q["terrain_ok"] = bool(abs(q["terrain_height_mean"] - 0.80) < 0.02
                               and torch.isfinite(gm["height"]).all())

    path("truth", truth_gates, ticks(False, 3000 + 1500 + 1500 + 900))

    # controller.tick closed loop: the per-tick controller entry point,
    # whose walking MPC is the walking_mpc_prep kernel on the card
    Bc, Tc = 64, 600

    def ctrl_tick_loop():
        sc = ro.initial_plant_state(cfg, batch=(Bc,), device=dev)
        hc = []
        for t in range(Tc):
            sc, mc = ro._plant_step_ref(cfg, sc, torch.full(
                (Bc,), float(t), device=dev))
            hc.append(mc["height"])
        hc = torch.stack(hc, 1)
        q["ctrl_tick_height_min"] = float(hc.min())
        q["ctrl_tick_ok"] = bool(torch.isfinite(hc).all()
                                 and q["ctrl_tick_height_min"] > 0.6)

    path("ctrl_tick", ctrl_tick_loop, {"walking_mpc_prep": Tc})

    # the KF gates of bench.py:163-233 (straight 3000 ticks, turning, push)
    kcfg = dataclasses.replace(cfg, estimator_mode="kf")

    def kf_gates():
        k0 = ro.initial_plant_state(kcfg, device=dev)
        _, km = ro.rollout(kcfg, k0, 3000)
        kh, kcov = km["height"], km["kf_cov_pos"]
        q["kf_height_min"] = float(kh.min())
        q["kf_vx_mean"] = float(km["velocity"][-600:, 0].mean())
        q["kf_cov_pos_final"] = float(kcov[-1].mean())
        q["kf_ok"] = bool(torch.isfinite(kh).all()
                          and q["kf_height_min"] > 0.6
                          and abs(q["kf_vx_mean"] - 0.5) < 0.05
                          and torch.isfinite(kcov).all())
        ktcfg = dataclasses.replace(kcfg, desired_yaw_rate=0.3)
        ktf, ktm = ro.rollout(ktcfg,
                              ro.initial_plant_state(ktcfg, device=dev), 1200)
        q["kf_turn_height_min"] = float(ktm["height"].min())
        q["kf_turn_yaw"] = float(ktf.xi[2])
        q["kf_turn_ok"] = bool(q["kf_turn_height_min"] > 0.6
                               and abs(q["kf_turn_yaw"] - 0.36) <= 0.036
                               and torch.isfinite(ktm["height"]).all()
                               and torch.isfinite(ktm["kf_cov_pos"]).all())
        kp1, kpm1 = ro.rollout(kcfg, k0, 600)
        kpushed = kp1.replace(xi=kp1.xi + PUSH.to(dev))
        _, kpm2 = ro.rollout(kcfg, kpushed, 900, start_iteration=600)
        kph = torch.cat([kpm1["height"], kpm2["height"]])
        kpv = kpm2["velocity"]
        q["kf_push_height_min"] = float(kph.min())
        q["kf_push_ok"] = bool(q["kf_push_height_min"] > 0.6
                               and abs(float(kpv[-300:, 0].mean()) - 0.5) < 0.2
                               and abs(float(kpv[-300:, 1].mean())) < 0.2
                               and torch.isfinite(kph).all()
                               and torch.isfinite(kpm2["kf_cov_pos"]).all())

    path("kf", kf_gates, ticks(True, 3000 + 1200 + 1500))

    # the dtMPC schedule (tests/test_mpc_schedule.py:12-33): a solve every
    # 5 ticks, the force held in between; with truth and with KF odometry
    def dtmpc(name, c):
        df, dm = ro.rollout(c, ro.initial_plant_state(c, device=dev), 1200,
                            mpc_every=5)
        dres = dm["qp_residual"]
        q[f"{name}_height_min"] = float(dm["height"].min())
        q[f"{name}_vx_mean"] = float(dm["velocity"][-400:, 0].mean())
        q[f"{name}_ok"] = bool(
            q[f"{name}_height_min"] > 0.55
            and abs(q[f"{name}_vx_mean"] - 0.5) < 0.2
            and torch.isfinite(df.xi).all()
            and (dres[::5] > 0).all()
            and float(dres.view(-1, 5)[:, 1:].abs().max()) == 0.0)

    path("dtmpc", lambda: dtmpc("dtmpc", cfg), ticks(False, 1200, 5))
    path("kf_dtmpc", lambda: dtmpc("kf_dtmpc", kcfg), ticks(True, 1200, 5))

    # 20-window x 1000-tick soaks at B = 64, gait phases staggered over a
    # cycle (600 ticks), with the 10k-tick bands of tests/test_soak.py
    Bs, NW, W = 64, 20, 1000
    it0 = torch.tensor((np.arange(Bs) * 600) // Bs, dtype=torch.float32,
                       device=dev)
    kick = np.random.default_rng(7).standard_normal(Bs)

    def soak(name, c, me):
        s0s = ro.initial_plant_state(c, batch=(Bs,), device=dev)
        s0s = s0s.replace(xi=s0s.xi + torch.tensor(
            np.outer(0.05 * kick, np.eye(13)[9]), dtype=torch.float32,
            device=dev))
        t_soak = time.perf_counter()
        _, stats = ro.soak_rollout(c, s0s, NW, W, start_iteration=it0,
                                   mpc_every=me)
        summ = ro.soak_stationary(stats)
        summ["wall_s"] = time.perf_counter() - t_soak
        ok = (summ["nonfinite_ticks"] == 0 and summ["height_min"] > 0.6
              and abs(summ["height_mean_tail_mean"] - 0.65) < 0.02
              and abs(summ["height_mean_drift_per_window"]) < 2e-4
              and abs(summ["vx_mean_tail_mean"] - 0.5) < 0.05)
        if c.estimator_mode == "kf":
            ok = ok and (np.isfinite(summ["kf_cov_pos_max"]) and abs(
                summ["kf_cov_pos_mean_drift_per_window"]) < 1e-5)
        summ["ok"] = bool(ok)
        say(name, B=Bs, windows=NW, window=W, mpc_every=me, **summ)
        q[f"{name}_ok"] = summ["ok"]

    path("soak_kf", lambda: soak("soak_kf", kcfg, 1),
         ticks(True, NW * W))
    path("soak_dtmpc", lambda: soak("soak_dtmpc", cfg, 5),
         ticks(False, NW * W, 5))

    # ---- standing (BASELINE config 2): N = 20, nu = 6, n = 120 ----------
    kscfg = dataclasses.replace(scfg, estimator_mode="kf")
    vy_kick = torch.tensor([0.0] * 10 + [0.05, 0.0, 0.0], device=dev)

    def stand_gate():
        # bench.py:153-161: a lateral kick, 2000 ticks
        s = ro.initial_plant_state(scfg, device=dev)
        _, m = ro.rollout(scfg, s.replace(xi=s.xi + vy_kick), 2000)
        q["stand_height"] = float(m["height"][-500:].mean())
        q["stand_height_min"] = float(m["height"].min())
        q["stand_vy_final"] = float(m["velocity"][-1, 1])
        q["stand_ok"] = bool(torch.isfinite(m["height"]).all()
                             and abs(q["stand_height"] - 0.65) < 0.01)

    def kf_stand_gate():
        # bench.py:237-251: the filter with both feet in contact
        _, m = ro.rollout(kscfg, ro.initial_plant_state(kscfg, device=dev),
                          1200)
        h, cov = m["height"], m["kf_cov_pos"]
        q["kf_stand_height"] = float(h[-300:].mean())
        q["kf_stand_height_min"] = float(h.min())
        q["kf_stand_est_error_max"] = float(m["est_error"].max())
        q["kf_stand_ok"] = bool(torch.isfinite(h).all()
                                and abs(q["kf_stand_height"] - 0.65) < 0.04
                                and q["kf_stand_height_min"] > 0.6
                                and torch.isfinite(cov).all())

    def stand_dtmpc(name, c):
        # a solve every 5 ticks, the force pair held as given between
        Bd_ = 64
        s = ro.initial_plant_state(c, batch=(Bd_,), device=dev)
        kick = torch.tensor(np.outer(np.random.default_rng(3)
                                     .standard_normal(Bd_), np.eye(13)[10]),
                            dtype=torch.float32, device=dev)
        f, m = ro.batched_rollout(c, s.replace(xi=s.xi + 0.05 * kick), 1000,
                                  mpc_every=5)
        res = m["qp_residual"]
        q[f"{name}_height"] = float(m["height"][:, -250:].mean())
        q[f"{name}_height_min"] = float(m["height"].min())
        q[f"{name}_ok"] = bool(
            torch.isfinite(f.xi).all()
            and abs(q[f"{name}_height"] - 0.65) < 0.04
            and q[f"{name}_height_min"] > 0.6
            and (res[:, ::5] > 0).all()
            and float(res.view(Bd_, -1, 5)[:, :, 1:].abs().max()) == 0.0)

    path("stand", stand_gate, ticks(False, 2000, names=STAND_VARIANTS))
    path("kf_stand", kf_stand_gate, ticks(True, 1200, names=STAND_VARIANTS))
    path("stand_dtmpc", lambda: stand_dtmpc("stand_dtmpc", scfg),
         ticks(False, 1000, 5, names=STAND_VARIANTS))
    path("kf_stand_dtmpc", lambda: stand_dtmpc("kf_stand_dtmpc", kscfg),
         ticks(True, 1000, 5, names=STAND_VARIANTS))

    # controller.tick in stand mode: stance_mpc -> make_admm_fused ->
    # fused_qp_nu6, closed through the plain plant step
    Ts = 300

    def stand_ctrl_tick_loop():
        sc = ro.initial_plant_state(scfg, batch=(Bc,), device=dev)
        sc = sc.replace(xi=sc.xi + vy_kick)
        hs = []
        for t in range(Ts):
            sc, mc = ro._plant_step_ref(scfg, sc, torch.full(
                (Bc,), float(t), device=dev))
            hs.append(mc["height"])
        hs = torch.stack(hs, 1)
        q["stand_ctrl_tick_height"] = float(hs[:, -50:].mean())
        q["stand_ctrl_tick_ok"] = bool(
            torch.isfinite(hs).all()
            and float((hs - 0.65).abs().max()) < 0.01)

    path("stand_ctrl_tick", stand_ctrl_tick_loop, {"fused_qp_nu6": Ts})

    # make_admm_fused with one foot per step (fused_qp_nu3): the walking
    # QP from plain-torch SRBD matrices, which walking_mpc_prep builds in
    # the kernel -- the two kernels must agree on the same QP
    def qp_entry():
        from mpc_limx_control_tpu_torch.models import srbd

        solve = mfc.make_admm_fused(cfg.srbd)
        worst = 0.0
        for seed in range(5):
            arms, x0, v_des, w_des, z_w, y_w, anc = prep_inputs(
                cfg, 64, seed=60 + seed, device=dev)
            Ac, Bc = srbd.linearize_shared(cfg.robot, arms, x0[:, 3:6],
                                           x0[:, 2])
            Ad, Bd_t = srbd.discretize_srbd(Ac, Bc, cfg.srbd.ts)
            anc3 = torch.cat([anc[:, :2], torch.zeros_like(anc[:, :1])], -1)
            x_ref = srbd.walking_reference(
                x0, cfg.srbd, cfg.srbd.horizon, v_des, w_des,
                height_des=cfg.ground_height + cfg.base_height,
                pos_anchor=anc3, yaw_anchor=anc[:, 2])
            sol, _ = solve(Ad, Bd_t, x_ref, x0, z_w, y_w)
            z_prep = mfc.fused_walking_qp_prep(arms, x0, v_des, w_des, z_w,
                                               y_w, anc, cfg=cfg)[0]
            worst = max(worst, maxerr(sol.u, z_prep)
                        / (float(z_prep.abs().max()) + 1.0))
        q["qp_entry_vs_prep_rel"] = worst
        q["qp_entry_ok"] = bool(worst <= 2e-3)

    path("qp_entry", qp_entry, {"fused_qp_nu3": 5, "walking_mpc_prep": 5})

    q["main_path_s"] = time.perf_counter() - t_main
    say("quality", launches=launches, **q)
    for k in ("walk_ok", "turn_ok", "push_ok", "terrain_ok", "ctrl_tick_ok",
              "kf_ok", "kf_turn_ok", "kf_push_ok", "dtmpc_ok", "kf_dtmpc_ok",
              "soak_kf_ok", "soak_dtmpc_ok", "stand_ok", "kf_stand_ok",
              "stand_dtmpc_ok", "kf_stand_dtmpc_ok", "stand_ctrl_tick_ok",
              "qp_entry_ok"):
        check(q[k], f"quality gate {k} failed: {q}")
    for k in kernels:
        summary[k]["launches"] = launches[k]
    # the plain controller tick agrees with the kernel one on the card
    cmd_k, dg_k = ctrl.tick(cfg, ro._odom_from_xi(s0.xi),
                            _joints(s0), its,
                            qp_warm=(s0.qp_z, s0.qp_lam),
                            ref_anchor=s0.ref_anchor)
    cmd_p, dg_p = ctrl.tick(cfg, ro._odom_from_xi(s0.xi), _joints(s0), its,
                            qp_warm=(s0.qp_z, s0.qp_lam),
                            ref_anchor=s0.ref_anchor, solve_form="subst")
    e_ct = dict(grf=maxerr(dg_k.grf, dg_p.grf),
                tau=maxerr(cmd_k.tau, cmd_p.tau))
    say("ctrl_tick_vs_plain", B=B, **e_ct)
    check(e_ct["grf"] <= 5e-2, f"controller.tick grf error {e_ct}")
    ss = perturbed_states(scfg, B, seed=6, device=dev)
    stand_ticks = [ctrl.tick(scfg, ro._odom_from_xi(ss.xi), _joints(ss), its,
                             qp_warm=(ss.qp_z, ss.qp_lam), solve_form=form)
                   for form in (None, "subst")]
    e_st = dict(grf=maxerr(stand_ticks[0][1].grf, stand_ticks[1][1].grf),
                tau=maxerr(stand_ticks[0][0].tau, stand_ticks[1][0].tau))
    say("stand_ctrl_tick_vs_plain", B=B, **e_st)
    check(e_st["grf"] <= 5e-2, f"standing controller.tick grf error {e_st}")

    # ---- 6. timing ------------------------------------------------------
    # per call, plain version first and last, the kernel twice between
    reps = {1: (50, 10), 1024: (50, 10), 4096: (20, 3)}

    def turns(kern, plain, Bt):
        r_k, r_p = reps[Bt]
        runs = [cuda_time_ms(plain, r_p), cuda_time_ms(kern, r_k),
                cuda_time_ms(kern, r_k), cuda_time_ms(plain, r_p)]
        return dict(ms=min(runs[1:3]), plain_ms=min(runs[0], runs[3]),
                    runs=runs)

    prep_t = {}
    for Bt in reps:
        args = prep_inputs(cfg, Bt, seed=5, device=dev)
        prep_t[Bt] = turns(
            lambda: mfc.fused_walking_qp_prep(*args, cfg=cfg),
            lambda: mfc.walking_qp_prep_plain(cfg, *args,
                                              solve_form="subst"), Bt)
        say("timing", kernel="walking_mpc_prep", B=Bt, card=smi,
            **prep_t[Bt])
    N20, it5 = cfg.srbd.horizon, cfg.srbd.solver.admm_warm_iters
    summary["walking_mpc_prep"].update(
        ms=prep_t[4096]["ms"], plain_ms=prep_t[4096]["plain_ms"],
        # in: x0, arms, v_des, yaw rate, z, y, anchor; out: z, y, res, xp
        **bound(4096, 13 + 3 * N20 + 3 + 1 + 9 * N20 + 3, 9 * N20 + 1 + 13,
                core_flops(N20, 3, it5, dense_ad=False, nbd=N20)))

    for nu in mfc.FUSED_QP:
        name = f"fused_qp_nu{nu}"
        two = nu == 6
        qt = {}
        for Bt in reps:
            args = qp_inputs(cfg, nu, Bt, seed=8, device=dev)
            kern = mfc.make_admm_fused(cfg.srbd, two_feet=two)
            plain = mfc.make_admm_fused(cfg.srbd, two_feet=two,
                                        solve_form="subst")
            qt[Bt] = turns(lambda: kern(*args), lambda: plain(*args), Bt)
        say("timing", kernel=name, card=smi,
            **{f"B{k}": v for k, v in qt.items()})
        n = nu * N20
        summary[name].update(
            ms=qt[4096]["ms"], plain_ms=qt[4096]["plain_ms"],
            # in: Ad, Bd_t, x_ref, x0, z, y; out: z, y, res
            **bound(4096, 169 + N20 * 13 * nu + (N20 + 1) * 13 + 13 + 3 * n,
                    3 * n + 1, core_flops(N20, nu, it5, dense_ad=True)))

    # each tick form: the tick through plant_step against the plain tick,
    # and the kernel alone (repeated launches on fixed buffers; the host
    # enqueues a launch in ~0.01 ms, so this is the device time of any
    # launch longer than that)
    stream = torch.cuda.current_stream(dev).cuda_stream
    forms = [(cfg, kcfg, VARIANTS), (scfg, kscfg, STAND_VARIANTS)]
    for c_truth, c_kf, names in forms:
        for (est_kf, hold), name in names.items():
            c = c_kf if est_kf else c_truth
            vt = {}
            for Bt in reps:
                st = perturbed_states(c, Bt, seed=3, device=dev)
                it = torch.full((Bt,), 123.0, device=dev)
                vd = torch.tensor(c.desired_velocity, device=dev).expand(
                    Bt, 3).contiguous()
                held = (torch.tensor([0.0, 0.0, 0.0, 2.0, -1.0, 180.0],
                                     device=dev).expand(Bt, 6).contiguous()
                        if hold else None)
                vt[Bt] = turns(
                    lambda: ro.plant_step(c, st, it, grf_override=held,
                                          v_des=vd),
                    lambda: ro._plant_step_ref(c, st, it, grf_override=held,
                                               v_des=vd, solve_form="subst"),
                    Bt)
                kf_args = {} if st.kf is None else dict(
                    kf_x=st.kf.x_hat, kf_p=st.kf.p_cov, prev_v=st.prev_v,
                    prev_q=st.prev_q)
                anc = (st.ref_anchor if st.ref_anchor is not None
                       else torch.cat([st.xi[:, 3:5], st.xi[:, 2:3]],
                                      -1).contiguous())
                plan = tfc.prepare_tick_launch(
                    st.xi, st.q, st.foot_l, st.foot_r, st.qp_z, st.qp_lam,
                    anc, it, vd, torch.zeros(Bt, device=dev),
                    grf_held=held, cfg=c, **kf_args)
                vt[Bt]["kernel_ms"] = cuda_time_ms(
                    lambda: plan.kernel.launch(plan.params, plan.ptrs,
                                               plan.batch, stream),
                    reps[Bt][0])
            say("timing", kernel=name, card=smi,
                **{f"B{k}": v for k, v in vt.items()})
            summary[name].update(
                ms=vt[4096]["ms"], plain_ms=vt[4096]["plain_ms"],
                kernel_ms=vt[4096]["kernel_ms"],
                **tick_bound(c, 4096, est_kf, hold))

    # closed-loop rate through batched_rollout at B = 4096
    rates = {}
    for name, c, me in (("truth", cfg, 1), ("kf", kcfg, 1),
                        ("dtmpc", cfg, 5), ("kf_dtmpc", kcfg, 5),
                        ("stand", scfg, 1), ("kf_stand", kscfg, 1),
                        ("stand_dtmpc", scfg, 5),
                        ("kf_stand_dtmpc", kscfg, 5)):
        steps = 200 if c.mode == "walk" else 100
        r1, ms1 = loop_rate(c, 4096, steps, dev, mpc_every=me)
        r2, ms2 = loop_rate(c, 4096, steps, dev, mpc_every=me)
        rates[name] = dict(scenario_ticks_per_s=max(r1, r2),
                           ms_per_tick=min(ms1, ms2), runs=[r1, r2])
    say("loop_rate", B=4096, card=smi, **rates)

    for k in kernels:
        missing = {"name", "route", "source", "replaces", "launches",
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms"} - set(summary[k])
        check(not missing, f"kernel {k}: summary lacks {missing}")
    print(json.dumps({"kernels": [summary[k] for k in kernels]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _joints(state):
    from mpc_limx_control_tpu_torch.core.types import JointState

    z = torch.zeros_like(state.q)
    return JointState(q=state.q, dq=z, tau=z)


if __name__ == "__main__":
    sys.exit(main())
