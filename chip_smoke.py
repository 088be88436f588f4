"""Chip smoke for the PyTorch/CUDA port: drive the walking closed loop on
one NVIDIA GPU through the port's own entry points and check its kernels.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is
non-zero):

1. torch / CUDA versions, TF32 flags, the card's name and power limit;
2. build both kernels from ops/csrc (nvcc, sm_90a) and print the build time;
3. ``walking_mpc_prep`` against its plain version (exact-solve ADMM) at
   N = 20 and N = 8, B = 257, numpy-seeded inputs;
4. ``walking_tick`` against the plain tick at B = 257: one tick with
   staggered iterations (both swing sides, 299/300), then five threaded
   ticks;
5. the main path: closed-loop quality through ``batched_rollout`` /
   ``rollout`` (walking, turning, push, terrain; the bands of bench.py) and
   a ``controller.tick`` closed loop, with the kernels' launch counters
   reset before and checked after;
6. per-tick time of kernel and plain version with CUDA events at
   B = 1, 1024 and 4096.

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

PREP_SRC = "mpc_limx_control_tpu_torch/ops/csrc/walking_mpc_prep.cu"
TICK_SRC = "mpc_limx_control_tpu_torch/ops/csrc/walking_tick.cu"
PREP_TPU = "mpc_limx_control_tpu/ops/mpc_fused_pallas.py:374"
TICK_TPU = "mpc_limx_control_tpu/ops/tick_fused_pallas.py:130"


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


def perturbed_states(cfg, B: int, seed: int, device):
    """Initial walking states with perturbed vx, vy and yaw
    (tests/test_tick_fused.py:_states recipe, drawn with numpy)."""
    from mpc_limx_control_tpu_torch.control import rollout as ro

    s0 = ro.initial_plant_state(cfg, batch=(B,), device=device)
    rng = np.random.default_rng(seed)
    xi = s0.xi.clone()
    noise = torch.tensor(rng.standard_normal((3, B)), dtype=torch.float32,
                         device=device)
    xi[:, 9] += 0.08 * noise[0]
    xi[:, 10] += 0.05 * noise[1]
    xi[:, 2] += 0.1 * noise[2]
    return s0.replace(xi=xi)


def tick_both(cfg, s_k, s_p, its):
    """One tick through the kernel (plant_step) and the plain tick."""
    from mpc_limx_control_tpu_torch.control import rollout as ro

    s_k, m_k = ro.plant_step(cfg, s_k, its)
    s_p, m_p = ro._plant_step_ref(cfg, s_p, its, solve_form="subst")
    return s_k, m_k, s_p, m_p


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
    kernels = {"walking_mpc_prep": mfc.WALKING_MPC_PREP,
               "walking_tick": tfc.WALKING_TICK}

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
    say("build", seconds=round(info["seconds"], 3), built=info["built"],
        library=info["path"], ptxas=ptxas)

    summary = {k: {"name": k, "route": "cuda"} for k in kernels}
    summary["walking_mpc_prep"].update(source=PREP_SRC, replaces=PREP_TPU)
    summary["walking_tick"].update(source=TICK_SRC, replaces=TICK_TPU)

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

    # ---- 5. the main path: closed-loop quality on the kernels -----------
    for kern in kernels.values():
        kern.reset()
    ticks_run = 0
    t_main = time.perf_counter()
    q = {}
    Bw = 64
    s = ro.initial_plant_state(cfg, batch=(Bw,), device=dev)
    rng = np.random.default_rng(7)
    s = s.replace(xi=s.xi + torch.tensor(
        np.outer(0.05 * rng.standard_normal(Bw), np.eye(13)[9]),
        dtype=torch.float32, device=dev))
    _, m = ro.batched_rollout(cfg, s, 3000)
    ticks_run += 3000
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
    ticks_run += 1500
    q["turn_height_min"] = float(tm["height"].min())
    q["turn_yaw"] = float(tf_.xi[2])
    q["turn_ok"] = bool(q["turn_height_min"] > 0.5
                        and abs(q["turn_yaw"] - 0.45) <= 0.045
                        and torch.isfinite(tm["height"]).all())

    p1, pm1 = ro.rollout(cfg, ro.initial_plant_state(cfg, device=dev), 600)
    pushed = p1.replace(xi=p1.xi + torch.tensor(
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0.3, 0, 0], dtype=torch.float32,
        device=dev))
    p2, pm2 = ro.rollout(cfg, pushed, 900, start_iteration=600)
    ticks_run += 1500
    ph = torch.cat([pm1["height"], pm2["height"]])
    pv = pm2["velocity"]
    q["push_height_min"] = float(ph.min())
    q["push_ok"] = bool(q["push_height_min"] > 0.5
                        and abs(float(pv[-300:, 0].mean()) - 0.5) < 0.2
                        and abs(float(pv[-300:, 1].mean())) < 0.2
                        and torch.isfinite(ph).all())

    gcfg = dataclasses.replace(cfg, ground_height=0.15)
    _, gm = ro.rollout(gcfg, ro.initial_plant_state(gcfg, device=dev), 900)
    ticks_run += 900
    q["terrain_height_mean"] = float(gm["height"][-300:].mean())
    q["terrain_ok"] = bool(abs(q["terrain_height_mean"] - 0.80) < 0.02
                           and torch.isfinite(gm["height"]).all())

    # controller.tick closed loop: the per-tick controller entry point,
    # whose walking MPC is the walking_mpc_prep kernel on the card
    Bc, Tc = 64, 600
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
    torch.cuda.synchronize()
    launches = {k: kern.launches for k, kern in kernels.items()}
    q["main_path_s"] = time.perf_counter() - t_main
    say("quality", ticks_run=ticks_run, ctrl_ticks=Tc, launches=launches,
        **q)
    check(launches["walking_tick"] == ticks_run,
          f"walking_tick launched {launches['walking_tick']} times for "
          f"{ticks_run} ticks")
    check(launches["walking_mpc_prep"] == Tc,
          f"walking_mpc_prep launched {launches['walking_mpc_prep']} times "
          f"for {Tc} controller ticks")
    for k in ("walk_ok", "turn_ok", "push_ok", "terrain_ok", "ctrl_tick_ok"):
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

    # ---- 6. timing ------------------------------------------------------
    timing = {}
    for Bt in (1, 1024, 4096):
        st = perturbed_states(cfg, Bt, seed=3, device=dev)
        it = torch.full((Bt,), 123.0, device=dev)
        vd = torch.tensor(cfg.desired_velocity, device=dev).expand(
            Bt, 3).contiguous()
        reps_k = 50 if Bt < 4096 else 20
        reps_p = 10 if Bt < 4096 else 3
        plain = lambda: ro._plant_step_ref(cfg, st, it, v_des=vd,
                                           solve_form="subst")
        kern = lambda: ro.plant_step(cfg, st, it, v_des=vd)
        t_p1 = cuda_time_ms(plain, reps_p)
        t_k1 = cuda_time_ms(kern, reps_k)
        t_k2 = cuda_time_ms(kern, reps_k)
        t_p2 = cuda_time_ms(plain, reps_p)
        args = prep_inputs(cfg, Bt, seed=5, device=dev)
        pk = lambda: mfc.fused_walking_qp_prep(*args, cfg=cfg)
        pp = lambda: mfc.walking_qp_prep_plain(cfg, *args,
                                               solve_form="subst")
        tp_p1 = cuda_time_ms(pp, reps_p)
        tp_k1 = cuda_time_ms(pk, reps_k)
        tp_k2 = cuda_time_ms(pk, reps_k)
        tp_p2 = cuda_time_ms(pp, reps_p)
        timing[Bt] = dict(tick_ms=min(t_k1, t_k2),
                          tick_plain_ms=min(t_p1, t_p2),
                          prep_ms=min(tp_k1, tp_k2),
                          prep_plain_ms=min(tp_p1, tp_p2),
                          runs=dict(tick=[t_p1, t_k1, t_k2, t_p2],
                                    prep=[tp_p1, tp_k1, tp_k2, tp_p2]))
        say("timing", B=Bt, card=smi, **timing[Bt])
    summary["walking_tick"].update(ms=timing[4096]["tick_ms"],
                                   plain_ms=timing[4096]["tick_plain_ms"])
    summary["walking_mpc_prep"].update(ms=timing[4096]["prep_ms"],
                                       plain_ms=timing[4096]["prep_plain_ms"])

    print(json.dumps({"kernels": [summary["walking_mpc_prep"],
                                  summary["walking_tick"]]}), flush=True)
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
