"""Chip smoke for the PyTorch/CUDA port: drive the walking and standing
closed loops on one NVIDIA GPU through the port's own entry points and
check its kernels.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is
non-zero):

1. torch / CUDA versions, TF32 flags, the card's name and power limit;
2. build the kernels from ops/csrc (nvcc, sm_90a) and print the build time,
   the dynamic shared memory of each entry point on the MPC core (held
   equal to the wrappers' mirror, ``mpc_fused_cuda.smem_bytes``, at
   N = 8 to 85) and its blocks an SM at N = 20 (at least five for
   ``standing_tick{,_kf}``, four for ``fused_qp_nu6``, more than six for
   ``walking_tick{,_kf}`` and ``walking_mpc_prep``), and the blocks an SM
   of the four held-force forms (a half warp a scenario, eight a block;
   at least four, one wave at B = 4096);
3. ``walking_mpc_prep`` against its plain version (exact-solve ADMM) at
   N = 20, 8 and 30, B = 257, numpy-seeded inputs; ``fused_qp_nu3`` /
   ``fused_qp_nu6`` (given, dense Ad) against theirs at N = 20 and 30,
   B = 257;
4. ``walking_tick`` and its hold, KF and KF + hold variants against the
   plain tick at B = 257 (the held-force forms' last warp half full): one
   tick with staggered iterations (both swing sides, 299/300), then five
   threaded ticks; the two walking solving
   forms likewise at N = 22 and 42 (n = 66, 126); the four
   ``standing_tick`` forms at full width (n = 120), the two solving ones
   also at N = 30 (n = 180);
5. the main paths, each run with every kernel's launch counter set to 0
   just before it and checked just after (one launch per tick of the
   path's own kind, none of any other): closed-loop quality through
   ``batched_rollout`` / ``rollout`` (walking, turning, push, terrain; the
   KF straight, turning and push gates; the dtMPC schedule with truth and
   with KF odometry; the bands of bench.py and
   tests/test_mpc_schedule.py), a ``controller.tick`` closed loop,
   10-window x 1000-tick ``soak_rollout`` soaks at B = 64 of the KF loop
   and of the dtMPC schedule (the 10k-tick bands of tests/test_soak.py);
   then standing: bench.py's ``stand_ok`` (2000 ticks) and ``kf_stand_ok``
   (1200 ticks), the standing dtMPC schedule with truth and KF odometry,
   a standing ``controller.tick`` closed loop (``fused_qp_nu6``) and the
   ``make_admm_fused`` entry point with one foot (``fused_qp_nu3``, held
   against ``walking_mpc_prep`` on the same QP); past the 21 steps the MPC
   kernels once took, the compositions at N = 22, the walking fused tick at
   N = 22 and 42 and its refusal at N = 86, and the standing kernels at
   N = 22 (the fused tick and the warm ADMM) and N = 30 (100 ticks each,
   height above 0.6); then this slice's paths, counters likewise:
   ``batched_rollout_resident`` against ``batched_rollout`` bit for bit
   (walking and standing x truth and KF, B = 1 and 4096, 200 / 100 ticks,
   the wall and device ms a tick of both), the session's CUDA graphs
   against its eager tick functions bit for bit over 10 scripted ticks,
   four loopback UDP sessions on the card against the torch WirePlant of
   tests/test_torch_session_walking.py (walking truth, KF and async
   dispatch 1500 ticks, standing 1000; the bands of
   tests/test_session_walking.py, one ``walking_mpc_prep`` /
   ``fused_qp_nu6`` launch a solve, the latency statistics), and
   tests/test_velocity_profile.py's ramp / cruise / stop through
   ``rollout(v_des_schedule=)`` (1800 ticks); then the scenario mesh of
   ``parallel/mesh.py``: both sharding styles over a mesh of the card and
   of 4 shards on it, truth and KF walking, B = 256, 10 steps, the final
   state bit for bit the unsharded ``batched_rollout``'s and the
   statistics within rtol 1e-6; two processes on the card over gloo
   (tools/distributed_rollout_torch.py, B = 256, 5 steps: equal statistics
   on both ranks, within 1e-6 of one process); ``entry()`` and
   ``dryrun_multichip(1)``; and ``examples/run_walking_torch.py`` (B = 64,
   300 ticks), ``examples/run_soak_torch.py`` (3 windows of 500, killed
   before its second chunk and resumed) and
   ``tools/verify_fused_sharded_torch.py`` through their ``main``;
6. with CUDA events at B = 1, 1024 and 4096: the time per tick of each
   tick form through ``plant_step`` and of its plain version, the tick
   kernel alone (also replayed from a CUDA graph: the device time of a
   held-force launch, shorter than the host's cost of one), and the prep
   and fused-QP kernels and their plain
   versions; then the ``batched_rollout`` rate at B = 4096 for truth
   odometry, the KF and the dtMPC schedule, walking and standing. Each
   kernel's bound (the card's least time for the same bytes and
   operations) is worked out from the shapes of this run.

7. the general solvers (cold and warm PDIP, dense ADMM, the linear MPC)
   and ``solve_form="inv"``:
   the four batched Cholesky / SPD-solve kernels (``cholesky``,
   ``chol_solve``, ``posdef_solve``, ``posdef_solve_fast``) against their
   plain versions and f64 numpy.linalg at B = 257, n = 30 / 60 / 120,
   k = 1 / 2 on seeded SPD batches, and against their plain versions on
   matrices captured in the last Newton steps of a cold PDIP on the walking
   QP; the seven ``inv`` entry points against their ``"linv"`` twin and the
   ``"subst"`` kernel (the three standing ones at N = 8, where they form
   the factor inverse, and bit for bit their ``"subst"`` entries at
   N = 11); then, counters reset and checked per path: walking
   with the warm PDIP and with the cold dense ADMM (700 ticks each),
   ``ControllerConfig()`` as it is (cold 20-step PDIP, the reference's
   literal weights) standing and walking, the cold PDIP on the walking
   tuning standing and walking, ``linear_mpc.batched_closed_loop`` at
   B = 4096 for the reference's 500 steps, ``posdef_solve_fast`` on the
   walking QP's cold-start system, and walking with ``solve_form="inv"``
   (truth 3000 ticks at B = 64, KF 1200 ticks, ``controller.tick``, the
   ``make_admm_fused`` entry point), standing with ``solve_form="inv"`` at
   N = 8 (1000 ticks, KF 600 ticks, a 100-tick ``controller.tick`` loop);
   CUDA-event times of each of the eleven entry points added since the
   walking main path beside its plain version, its library call
   (``torch.linalg.cholesky``, ``torch.cholesky_solve``,
   ``torch.linalg.solve``) or its ``"subst"`` form, and the time per tick
   of the general-solver paths at B = 1, 1024 and 4096.

8. the fused interior-point kernel (K9, ``pdip_fused``) against its plain
   version on the QP of tests/test_qp_pallas.py (n = 30, m = 64), the cold
   walking QP (60 / 120) and the ``ControllerConfig()`` standing QP
   (120 / 240) at B = 257 and 1, every scenario (``pdip_check``): the
   merit after 0 and 1 steps within 1e-3 of itself, the best-iterate pick
   bit for bit from the kernel's own launches, all four outputs after 6
   Newton steps, after 20 the best merit within its f32 floor and the
   objective and the feasibility of z_best;
   the entry point held against ``ops.qp._batched_pdip`` (the K8 kernels)
   on the walking QP at B = 4096; the controller variants on the card,
   counters reset and checked per path: the Riccati ADMM walking (400
   ticks, B = 4) and against ``make_admm_fused`` on the same QPs, the
   damped-LS and log6 swing IKs and the receding attitude reference (700
   ticks each); CUDA-event times of K9 at B = 1 / 1024 / 4096 beside its
   plain version and ``_batched_pdip``'s wall time on the same inputs, and
   the time per tick of the variant paths.

9. the last modules of the port, after the examples among the main
   paths, counters reset and checked per path: ``[band_kron]`` at
   B = 4096 on the walking QP (N = 20, nu = 3, mu = 6):
   ``condense_lti_diag`` against the dense ``condense`` in f64,
   ``make_admm_warm_kron`` (one ``cholesky`` launch a call) against
   ``make_admm_warm`` on the expanded G and against its plain twin, the
   composition against the ``fused_qp_nu3`` kernel at 2e-3 * scale, each
   timed; ``[corpus]``: the captured QP corpora of
   tests/test_active_set_oracle.py (walking steady and pushed, standing)
   through ``oracle.corpus.capture_corpus`` on the tick kernels, against
   the f64 active-set and interior-point oracles (``corpus_report``): the
   in-loop force, the f32 ``pdip_qp`` on the K8 kernels and K9
   ``pdip_fused`` on the batched corpus (a band miss outside
   ``F32_BAND_FAULTS`` fails), K9 also by ``pdip_check`` after its 20
   steps; ``[rnea_oracle]``: the torch.func Lagrangian oracle in f64 on the
   card against ``rnea`` on 20 states; and, after the timings,
   ``[roofline]``: every bound printed equals ``BOUNDS_BEFORE_MOVE`` and
   the model of utils/roofline.py.

It prints the kernels' JSON summary on the line before the last and, as
the last line, {"ok": true, "device": {...}}. Without a CUDA card it exits
with code 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mpc_limx_control_tpu_torch.utils import roofline
from mpc_limx_control_tpu_torch.utils.roofline import (
    add_operations, chol_bound, fused_qp_bound, inv_ops, pdip_bound,
    prep_bound, tick_bound)

CSRC = "mpc_limx_control_tpu_torch/ops/csrc/"
PREP_SRC = CSRC + "walking_mpc_prep.cu"
TICK_SRC = CSRC + "walking_tick.cu"
STAND_SRC = CSRC + "standing_tick.cu"
QP_SRC = CSRC + "fused_qp.cu"
CHOL_SRC = CSRC + "chol.cu"
# the four kernels of csrc/chol.cu: the TPU kernel each replaces and the one
# PyTorch call that computes the same function (the library yardstick)
CHOL_TPU = {"cholesky": "mpc_limx_control_tpu/ops/chol_pallas.py:144",
            "chol_solve": "mpc_limx_control_tpu/ops/chol_pallas.py:172",
            "posdef_solve": "mpc_limx_control_tpu/ops/chol_pallas.py:293",
            "posdef_solve_fast":
                "mpc_limx_control_tpu/ops/chol_pallas.py:263"}
CHOL_LIBRARY = {"cholesky": "torch.linalg.cholesky",
                "chol_solve": "torch.cholesky_solve",
                "posdef_solve": "torch.linalg.solve",
                "posdef_solve_fast": "torch.linalg.solve"}
PDIP_SRC = CSRC + "pdip_fused.cu"
PDIP_TPU = "mpc_limx_control_tpu/ops/qp_pallas.py:206"
PREP_TPU = "mpc_limx_control_tpu/ops/mpc_fused_pallas.py:374"
QP_TPU = "mpc_limx_control_tpu/ops/mpc_fused_pallas.py:355"
TICK_TPU = "mpc_limx_control_tpu/ops/tick_fused_pallas.py:130"
SESSION_JAX = ("mpc_limx_control_tpu/control/session.py (XLA's fusion of "
               "the jax.jit tick closures)")
# (est_kf, hold) -> kernel name; the four forms of the TPU tick kernel
VARIANTS = {(False, False): "walking_tick", (False, True): "walking_tick_hold",
            (True, False): "walking_tick_kf",
            (True, True): "walking_tick_kf_hold"}
STAND_VARIANTS = {k: v.replace("walking", "standing")
                  for k, v in VARIANTS.items()}
# K9's shapes (n, m): the QP of tests/test_qp_pallas.py, the cold walking
# QP, the ControllerConfig() standing QP
PDIP_SHAPES = ((30, 64), (60, 120), (120, 240))
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


def session_packets(cfg, B: int, seed: int, device):
    """B session packets (control/session.py's layout) of walking states
    three plain ticks in (perturbed_states, staggered phases, a pair of
    rows on each side of both phase switches), the odometry's quaternion
    from its roll, pitch and yaw, every fourth anchor 0.3 m outside its
    band, the held force of the last tick; and the QP warm state (z, y)
    of those ticks."""
    from mpc_limx_control_tpu_torch.control import rollout as ro
    from mpc_limx_control_tpu_torch.control import session as ses
    from mpc_limx_control_tpu_torch.utils import rotations as rot

    s0 = perturbed_states(cfg, B, seed, device)
    pattern = torch.tensor([0.0, 40.0, 180.0, 296.0, 297.0, 455.0, 596.0,
                            597.0], device=device)
    its = pattern.repeat(B // len(pattern) + 1)[:B]
    for j in range(3):
        s0, m0 = ro._plant_step_ref(cfg, s0, its + j, solve_form="subst")
    pk = torch.zeros((B, ses.PACKET), dtype=torch.float32, device=device)
    xi = s0.xi
    pk[:, ses.Q] = s0.q
    pk[:, ses.POS] = xi[:, 3:6]
    pk[:, ses.ORI] = xi[:, 0:3]
    pk[:, ses.OQUAT] = rot.rpy_to_quat(xi[:, 0:3])
    pk[:, ses.VPOS] = xi[:, 9:12]
    pk[:, ses.VORI] = xi[:, 6:9]
    pk[:, ses.IT] = (its + 3.0)[:, None]
    anchor = s0.ref_anchor.clone()
    anchor[::4, 0] += 0.3
    pk[:, ses.ANCHOR] = anchor
    pk[:, ses.GRF] = m0["grf"]
    return pk, (s0.qp_z.contiguous(), s0.qp_lam.contiguous())


def session_tick_plain(cfg, packet, z=None, y=None, solve_form=None):
    """controller.tick on session packets, as ControlSession's plain tick
    functions call it: the held force (z None), or a warm solve from
    (z, y) (``solve_form`` None: the walking_mpc_prep kernel on the card,
    as _warm_fn). Returns (the command [B, 30], the next anchor, the force,
    the QP warm state)."""
    from mpc_limx_control_tpu_torch.control import controller as ctrl
    from mpc_limx_control_tpu_torch.control import session as ses

    p = packet
    odom, joints, it = ses._odom(p), ses._joints(p), p[:, ses.IT][:, 0]
    if z is None:
        cmd, d = ctrl.tick(cfg, odom, joints, it, grf_override=p[:, ses.GRF],
                           ref_anchor=p[:, ses.ANCHOR])
    else:
        cmd, d = ctrl.tick(cfg, odom, joints, it, qp_warm=(z, y),
                           ref_anchor=p[:, ses.ANCHOR], solve_form=solve_form)
    return ses._packed(cmd), d.ref_anchor, d.grf, d.qp_state


def session_kernel_report(cfg, device, log: str, plain_form=None) -> dict:
    """[session_kernel]: csrc/session_tick.cu against the plain tick
    functions it replaces, and what each costs a replay on the card.

    (a) one held and one solving tick of 257 session packets through the
    kernels and through controller.tick (`plain_form` None: with the
    walking_mpc_prep kernel, as the session's plain _warm_fn), the widest
    gap of each output; (b) each tick kind's device time a graph replay,
    CUDA events recorded inside the capture as the session records them,
    the plain function's graph ("before") and the kernel's ("after"), B =
    1, medians of 300 replays; (c) the ptxas resource lines of the batched
    entry points (every source but session_tick.cu) from the build's
    `log`."""
    from mpc_limx_control_tpu_torch.control import session as ses
    from mpc_limx_control_tpu_torch.ops import _build, graphs
    from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc

    out = {}
    pk, (z, y) = session_packets(cfg, 257, seed=12, device=device)
    B = pk.shape[0]
    # (a) held force
    cmd_p, anc_p, _, _ = session_tick_plain(cfg, pk)
    pk_k = pk.clone()
    cmd_k = torch.empty((B, ses.CMD), device=device)
    tfc.walking_session_tick_hold(cfg, pk_k, cmd_k)
    torch.cuda.synchronize()
    out["hold_gap"] = {k: maxerr(cmd_k[:, sl], cmd_p[:, sl]) for k, sl in
                       (("q", ses.Q), ("dq", ses.DQ), ("tau", ses.TAU),
                        ("kp", slice(18, 24)), ("kd", slice(24, 30)))}
    out["hold_gap"]["anchor"] = maxerr(pk_k[:, ses.ANCHOR], anc_p)
    # (a) solve
    cmd_p, anc_p, grf_p, (z_p, y_p) = session_tick_plain(
        cfg, pk, z, y, solve_form=plain_form)
    zk, yk = z.clone(), y.clone()
    w = torch.empty((B, ses.W_GRF.stop), device=device)
    tfc.walking_session_tick(cfg, pk[:, :ses.SOLVE_IN].contiguous(), zk, yk,
                             w)
    torch.cuda.synchronize()
    out["solve_gap"] = {k: maxerr(w[:, sl], cmd_p[:, sl]) for k, sl in
                        (("q", ses.Q), ("dq", ses.DQ), ("tau", ses.TAU),
                         ("kp", slice(18, 24)), ("kd", slice(24, 30)))}
    out["solve_gap"].update(anchor=maxerr(w[:, ses.W_ANCHOR], anc_p),
                            grf=maxerr(w[:, ses.W_GRF], grf_p),
                            z=maxerr(zk, z_p), y=maxerr(yk, y_p),
                            z_scale=float(z_p.abs().max()))

    # (b) the graphs' device time a replay, before and after
    s = ses.ControlSession(cfg, state_port=19990, cmd_port=19991,
                           device=device, cuda_graphs=False)
    s.link.close()
    s._packet.copy_(pk[:1])
    s._solve_in.copy_(pk[:1, :ses.SOLVE_IN])
    s._z.copy_(z[:1])
    s._y.copy_(y[:1])
    saved = [t.clone() for t in (s._packet, s._z, s._y)]

    def replay_ms(fn, reps=300):
        start, end = (torch.cuda.Event(enable_timing=True, external=True)
                      for _ in range(2))

        def call():
            start.record()
            fn()
            end.record()

        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        g = graphs.Graph(call, name="session_kernel", device=device)
        ms = []
        for _ in range(reps):
            g.replay()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        for t, v in zip((s._packet, s._z, s._y), saved):
            t.copy_(v)
        return float(np.median(ms)), sum(g.launches.values()) or None

    for kind, plain, kern in (("hold", s._hold_fn, s._hold_kernel),
                              ("warm", s._warm_fn, s._warm_kernel)):
        out[f"{kind}_graph_device_ms_before"], _ = replay_ms(plain)
        out[f"{kind}_graph_device_ms_after"], n = replay_ms(kern)
        out[f"{kind}_kernel_launches_a_replay"] = n
    s.close()

    # (c) the batched entry points' ptxas lines
    res = _build.ptxas_resources(log)
    batched = {f"{src}:{name}": v for (src, name), v in sorted(res.items())
               if src != "session_tick.cu"}
    out["ptxas_batched_entries"] = len(batched)
    out["ptxas_batched_sha256"] = hashlib.sha256(
        json.dumps(batched, sort_keys=True).encode()).hexdigest()[:16]
    out["ptxas_session"] = {name: v for (src, name), v in res.items()
                            if src == "session_tick.cu"}
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/ptxas_batched.json").write_text(
        json.dumps(batched, indent=1, sort_keys=True))
    return out


def tick_both(cfg, s_k, s_p, its, held=None):
    """One tick through the kernel (plant_step) and the plain tick."""
    from mpc_limx_control_tpu_torch.control import rollout as ro

    from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as mfc

    form = mfc.plain_solve_form(cfg.srbd.solver.solve_form,
                                6 if cfg.mode == "stand" else 3,
                                cfg.srbd.horizon)
    s_k, m_k = ro.plant_step(cfg, s_k, its, grf_override=held)
    s_p, m_p = ro._plant_step_ref(cfg, s_p, its, grf_override=held,
                                  solve_form=form)
    return s_k, m_k, s_p, m_p


def variant_vs_plain(cfg, est_kf: bool, hold: bool, B: int, device,
                     f64: bool = False):
    """A tick variant (walking or standing, by the config's mode) against
    the plain tick from states three plain ticks in (the filter and
    prev_v / prev_q past their seed): one tick and five threaded ticks.
    Returns (errors after one tick, after five); with f64, also the five
    threaded ticks of the plain tick in float64 on the CPU and, per field,
    the kernel's and the plain f32 tick's distance from them."""
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
    e5 = errs(s_k, m_k, s_p, m_p)
    if f64:
        from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as mfc

        def to64(x):
            return x.cpu().double()

        form = mfc.plain_solve_form(cfg.srbd.solver.solve_form,
                                    6 if stand else 3, cfg.srbd.horizon)
        s_d = ro._map_state(s0, to64)
        for j in range(5):
            s_d, m_d = ro._plant_step_ref(
                cfg, s_d, to64(its + j),
                grf_override=None if held is None else to64(held),
                solve_form=form)
        pairs = [("xi", s_k.xi, s_p.xi, s_d.xi), ("q", s_k.q, s_p.q, s_d.q),
                 ("grf", m_k["grf"], m_p["grf"], m_d["grf"])]
        if est_kf:
            pairs.append(("x_hat", s_k.kf.x_hat, s_p.kf.x_hat, s_d.kf.x_hat))
        e5["f64"] = {k: (maxerr(to64(a), d), maxerr(to64(b), d))
                     for k, a, b, d in pairs}
    return e1, e5


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


def graph_time_ms(fn, reps: int) -> float:
    """Device time of one call of `fn`: `reps` calls captured in a CUDA
    graph, the replay timed by CUDA events (no host launch cost, which
    passes a short kernel's time at small sizes)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_and_device_ms(fn, steps: int):
    """(wall, device) ms a tick of `fn`, a run of `steps` ticks: the host
    clock around a synchronized run (the better of two, after a warm-up
    run), and the kernels' summed time in a torch.profiler trace of one
    run (None when the trace shows no device time)."""
    fn()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages())
    return (1e3 * min(walls) / steps,
            dev_us / 1e3 / steps if dev_us > 0 else None)


def with_solver(cfg, warm=None, **kw):
    """The config with fields of its SolverConfig replaced (and, with
    `warm`, qp_warm_start)."""
    cfg = dataclasses.replace(cfg, srbd=dataclasses.replace(
        cfg.srbd, solver=dataclasses.replace(cfg.srbd.solver, **kw)))
    return cfg if warm is None else dataclasses.replace(
        cfg, qp_warm_start=warm)


def spd_batch(B: int, n: int, k: int, seed: int, device):
    """Seeded SPD batch M = A A' / n + 3 I and right-hand sides
    (tests/test_qp_pallas.py:15-23), as f64 arrays and f32 tensors."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    M = A @ A.transpose(0, 2, 1) / n + 3.0 * np.eye(n)
    rhs = rng.standard_normal((B, n, k))

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return M, rhs, t(M), t(rhs)


def walking_qp(cfg, B: int, seed: int, device):
    """The condensed walking QP (n = 60, m = 120 at N = 20) of perturbed
    poses: (H, f, G, h)."""
    from mpc_limx_control_tpu_torch.models import srbd
    from mpc_limx_control_tpu_torch.ops import condense as cnd

    arms, x0, v_des, w_des, _, _, _ = prep_inputs(cfg, B, seed, device)
    c = cfg.srbd
    N = c.horizon
    Ac, Bc = srbd.linearize_shared(cfg.robot, arms, x0[:, 3:6], x0[:, 2])
    Ad, Bd_t = srbd.discretize_srbd(Ac, Bc, c.ts)
    x_ref = srbd.walking_reference(x0, c, N, v_des, w_des, height_des=0.65)

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    G, h = srbd.friction_cone_rows(c, N, torch.float32, device)
    qp = cnd.condense(Ad, Bd_t, torch.diag(t(c.q_diag)),
                      torch.diag(t(c.r_diag)),
                      torch.diag(c.p_scale * t(c.q_diag)), N, x0, x_ref,
                      extra_G=G, extra_h=h)
    return qp.H, qp.f, qp.G, qp.h


def late_pdip_systems(H, f, G, h, iters: int, keep):
    """(M + reg I, affine right-hand side [B,n,1]) of the Newton steps in
    `keep`, recorded from a cold PDIP run on the plain twins."""
    from mpc_limx_control_tpu_torch.ops import qp as qps

    seen = {"M": [], "r": []}
    chol0, solve0 = qps._posdef_chol, qps._chol_solve

    def spy_chol(M, reg, plain_twins=False):
        seen["M"].append(M + reg * torch.eye(M.shape[-1], device=M.device))
        return chol0(M, reg, plain_twins)

    def spy_solve(L, rhs, plain_twins=False):
        seen["r"].append(rhs[..., None].contiguous())
        return solve0(L, rhs, plain_twins)

    qps._posdef_chol, qps._chol_solve = spy_chol, spy_solve
    try:
        qps._batched_pdip(H, f, G, h, iters, plain_twins=True)
    finally:
        qps._posdef_chol, qps._chol_solve = chol0, solve0
    # the cold start's factorization and solve come first, then one
    # factorization and two solves per Newton step
    return ([seen["M"][1 + i].contiguous() for i in keep],
            [seen["r"][1 + 2 * i] for i in keep])


def recipe_qp(B: int, seed: int, device):
    """tests/test_qp_pallas.py:46-58 (n = 30, m = 64), drawn with numpy:
    H = A A' / n + 3 I, f, G normal, h = |normal| + 1."""
    n, m = 30, 64
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    H = np.einsum("bij,bkj->bik", A, A) / n + 3 * np.eye(n)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return (t(H), t(rng.normal(size=(B, n))), t(rng.normal(size=(B, m, n))),
            t(np.abs(rng.normal(size=(B, m))) + 1.0))


def standing_qp(B: int, seed: int, device):
    """The condensed two-foot QP of ``ControllerConfig()`` standing (N = 20,
    n = 120, m = 240; controller.stance_mpc's cold branch) at perturbed
    standing states: (H, f, G, h)."""
    from mpc_limx_control_tpu_torch.control import controller as ctrl
    from mpc_limx_control_tpu_torch.control import rollout as ro
    from mpc_limx_control_tpu_torch.core.config import ControllerConfig
    from mpc_limx_control_tpu_torch.models import srbd
    from mpc_limx_control_tpu_torch.ops import condense as cnd

    c = dataclasses.replace(ControllerConfig(), mode="stand")
    s = perturbed_states(c, B, seed, device)
    od = ro._odom_from_xi(s.xi)
    xi0 = srbd.initial_state(od.ori, od.pos, od.v_ori, od.v_pos)
    Ac, Bc2 = srbd.linearize_shared(
        c.robot, torch.stack([s.foot_l, s.foot_r], -2), od.pos, od.ori[:, 2])
    Ad, Bd = srbd.discretize_srbd(Ac, torch.cat([Bc2[:, 0], Bc2[:, 1]], -1),
                                  c.srbd.ts)
    N = c.srbd.horizon
    mid = 0.5 * (s.foot_l + s.foot_r)
    height = c.ground_height + c.base_height
    x_ref = srbd.walking_reference(
        xi0, c.srbd, N, torch.zeros(B, 3, device=device),
        torch.zeros(B, device=device), height_des=height,
        pos_anchor=torch.cat([mid[:, :2], torch.full_like(mid[:, 2:],
                                                          height)], -1))
    Q, R, P = ctrl._weights(c.srbd, 2, torch.float32, device)
    ones = torch.ones(B, N, device=device)
    qp = cnd.condense(Ad, Bd[:, None].expand(B, N, 13, 6), Q, R, P, N, xi0,
                      x_ref, extra_G=ctrl._cone_rows(c, torch.float32,
                                                     device),
                      extra_h=ctrl._cone_bounds(c, ones, ones))
    return qp.H, qp.f, qp.G.expand(B, -1, -1), qp.h


def pdip_start(H, f, G, h):
    """The QP with the cold start of ops/qp.py's PDIP, as the seven inputs
    of pdip_fused: z0 = -(H + 1e-6 I)^-1 f (plain solve), the slacks
    h - G z0 pushed interior by 1, lam0 = 1."""
    from mpc_limx_control_tpu_torch.ops import chol as cholp

    n = f.shape[-1]
    z0 = -cholp.posdef_solve_plain(
        H + 1e-6 * torch.eye(n, device=H.device), f[..., None])[..., 0]
    s_raw = h - (G @ z0[..., None])[..., 0]
    s0 = s_raw + torch.clamp(-s_raw.amin(-1, keepdim=True), min=0.0) + 1.0
    return [a.contiguous() for a in (H, f, G, h, z0, s0, torch.ones_like(h))]


def qp_objective(H, f, z):
    return 0.5 * (z[:, None, :] @ H @ z[..., None])[:, 0, 0] + (f * z).sum(-1)


PDIP_FLOOR_X = 8.0   # the merit's band past the f32 floor, in floors


def pdip_floor(args, iters: int, orders: int = 1) -> float:
    """The float32 floor of pdip_fused's best merit after `iters` Newton
    steps: the largest change of the plain version's, over the batch, when
    the constraint rows are taken in reverse order (the same QPs in
    another arithmetic order). `orders` > 1 adds `orders` - 1 seeded
    random orders of the rows and of the variables (which reorders the
    sums of H z too): a batch of a few QPs (the captured corpus) shows the
    floor only over several orders."""
    from mpc_limx_control_tpu_torch.ops import qp_cuda

    H, f, G, h, z0, s0, lam0 = args
    n, m = f.shape[-1], h.shape[-1]
    ref = qp_cuda.pdip_fused_plain(*args, iters=iters)[1]
    rng = np.random.default_rng(0)
    orders_ = [(torch.arange(n), torch.arange(m - 1, -1, -1))] + [
        (torch.tensor(rng.permutation(n)), torch.tensor(rng.permutation(m)))
        for _ in range(orders - 1)]
    floor = 0.0
    for pv, pr in orders_:
        pv, pr = pv.to(f.device), pr.to(f.device)
        perm = (H[:, pv][:, :, pv], f[:, pv], G[:, pr][:, :, pv], h[:, pr],
                z0[:, pv], s0[:, pr], lam0[:, pr])
        floor = max(floor, maxerr(qp_cuda.pdip_fused_plain(
            *[a.contiguous() for a in perm], iters=iters)[1], ref))
    return floor


def pdip_check(args, iters: int, floor: float) -> dict:
    """pdip_fused (K9) against its plain version on one batch of QPs over
    `iters` Newton steps, every scenario held:

    * merit_best after 0 and 1 steps, where the merit stands far above the
      f32 floor and every term of it counts (the walking QP starts
      infeasible), within 1e-3 of itself;
    * the pick, bit for bit from the kernel's own launches at 0..iters
      steps: merit_best never rises; where it falls z_best is that launch's
      z_final, elsewhere the previous launch's z_best;
    * merit_best after `iters` steps within 1e-3 of itself + PDIP_FLOOR_X
      floors (pdip_floor): after 4-6 steps the merit is at the f32 floor,
      where two arithmetic orders of the plain version part by up to 1.5x
      the merit, so no band relative to it alone can hold there;
    * up to 6 steps (M well conditioned): z_final and lam_final of every
      launch within 5e-4 of their scale from the plain iterate of that
      step, so z_best is the plain iterate of the step the kernel picked,
      and the plain merit of that step within the merit band of the plain
      best (where the picks differ, a tie at the floor);
    * the objective of z_best within 1e-3 of 1 + |J| and its violation
      within 4x the plain version's or 1e-5 of 1 + |h| (after 20 steps the
      iterates part: late f32 iterates go NaN in either, by design).

    Returns the measured errors; "ok" says whether every band holds.
    """
    from mpc_limx_control_tpu_torch.ops import qp_cuda

    H, f, G, h, z0 = args[:5]
    B = f.shape[0]
    runs = [qp_cuda.pdip_fused(*args, iters=k) for k in range(iters + 1)]
    its = list(qp_cuda.pdip_iterates(*args, iters=iters))
    best = [its[0][3]]                 # the plain best merit after k steps
    pick_p = torch.zeros(B, dtype=torch.long, device=f.device)
    for k, it in enumerate(its[1:], 1):
        better = it[3] < best[-1]
        best.append(torch.where(better, it[3], best[-1]))
        pick_p = torch.where(better, k, pick_p)
    z_p = torch.stack([it[0] for it in its], 1)
    rows = torch.arange(B, device=f.device)

    pick = torch.zeros_like(pick_p)
    exact = torch.equal(runs[0][0], z0)
    for k in range(1, iters + 1):
        prev, cur = runs[k - 1], runs[k]
        fell = cur[1] < prev[1]
        exact = (exact and bool((cur[1] <= prev[1]).all())
                 and torch.equal(cur[0], torch.where(fell[:, None], cur[2],
                                                     prev[0])))
        pick = torch.where(fell, k, pick)

    band = 1e-3 * best[-1].abs() + PDIP_FLOOR_X * floor
    zs = (runs[-1][0], z_p[rows, pick_p])
    J_k, J_p = (qp_objective(H, f, z) for z in zs)
    viol = [float(torch.clamp((G @ z[..., None])[..., 0] - h, min=0.0)
                  .amax()) for z in zs]
    e = dict(merit_first=max(float(((runs[k][1] - best[k]).abs()
                                    / best[k].abs()).max()) for k in (0, 1)),
             pick_exact=exact,
             merit=maxerr(runs[-1][1], best[-1]), floor=floor,
             merit_in_band=float(((runs[-1][1] - best[-1]).abs()
                                  / band).max()),
             objective=float(((J_k - J_p).abs() / (1.0 + J_p.abs())).max()),
             viol=viol[0], viol_plain=viol[1],
             finite=bool(torch.isfinite(runs[-1][0]).all()
                         and torch.isfinite(runs[-1][1]).all()),
             nan_final=int((~torch.isfinite(runs[-1][2])).any(-1).sum()))
    ok = (e["finite"] and exact and e["merit_first"] <= 1e-3
          and e["merit_in_band"] <= 1.0 and e["objective"] <= 1e-3
          and viol[0] <= max(4.0 * viol[1],
                             1e-5 * (1.0 + float(h.abs().max()))))
    if iters <= 6:
        def rel(a, b):
            return maxerr(a, b) / (float(b.abs().max()) + 1.0)

        m_pick = torch.stack([it[3] for it in its], 1)[rows, pick]
        e.update(z_final_abs=maxerr(runs[-1][2], its[-1][0]),
                 z_final=max(rel(runs[k][2], its[k][0])
                             for k in range(iters + 1)),
                 lam_final=max(rel(runs[k][3], its[k][2])
                               for k in range(iters + 1)),
                 tie=float(((m_pick - best[-1]) / band).max()),
                 picks_apart=float((pick != pick_p).float().mean()))
        ok = (ok and e["z_final"] <= 5e-4 and e["lam_final"] <= 5e-4
              and e["tie"] <= 1.0)
    e["ok"] = bool(ok)
    return e


# the bound (ms) of every entry point at B = 4096 that chip_smoke.py printed
# before its roofline model moved to utils/roofline.py (the shapes of
# roofline.kernel_bounds); the [roofline] phase holds the moved model and
# this run's summary to them exactly
BOUNDS_BEFORE_MOVE = {
    "walking_tick": 0.014128632358208956,
    "walking_tick_hold": 0.0003765874626865672,
    "walking_tick_kf": 0.01449543832835821,
    "walking_tick_kf_hold": 0.0019465170149253733,
    "standing_tick": 0.0651770192238806,
    "standing_tick_hold": 0.0003765874626865672,
    "standing_tick_kf": 0.06554382519402985,
    "standing_tick_kf_hold": 0.0019465170149253733,
    "walking_mpc_prep": 0.014067498029850745,
    "fused_qp_nu3": 0.03531882985074627,
    "fused_qp_nu6": 0.09745135952238805,
    "walking_mpc_prep_inv": 0.01846916967164179,
    "fused_qp_nu3_inv": 0.039720501492537315,
    "walking_tick_inv": 0.018530304,
    "walking_tick_kf_inv": 0.018897109970149255,
    "standing_tick_inv": 0.010753283820895524,
    "standing_tick_kf_inv": 0.011120089791044778,
    "fused_qp_nu6_inv": 0.017759094447761192,
    "cholesky_n60": 0.026556752238805967,
    "cholesky_n120": 0.10593356417910448,
    "chol_solve_n60": 0.009536955223880596,
    "chol_solve_n120": 0.03668059701492537,
    "posdef_solve_n60": 0.009536955223880596,
    "posdef_solve_n120": 0.03697404179104478,
    "posdef_solve_fast_n60": 0.009536955223880596,
    "posdef_solve_fast_n120": 0.03697404179104478,
    "pdip_fused_n60": 0.7739972776119403,
    "pdip_fused_n120": 5.54911407761194,
}

# the captured corpora of tests/test_active_set_oracle.py: name -> (mode,
# ticks, sample_every, skip_first, kick)
CORPORA = {"walk_steady": ("walk", 60, 29, 0, None),
           "walk_pushed": ("walk", 80, 15, 35, (30, (0.0, 0.4, 0.0))),
           "stand": ("stand", 300, 100, 60, None)}


def band_kron_inputs(cfg, B: int, seed: int, device):
    """The walking QP of the generic fused QP's inputs (qp_inputs, nu = 3)
    with its cone: (args of make_admm_fused, the cone constants, Gu
    [6,3], h [B,6N])."""
    from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as mfc

    args = qp_inputs(cfg, 3, B, seed, device)
    k = mfc.cone_constants(cfg.srbd)
    Gu = torch.tensor(k["Gu"], dtype=torch.float32, device=device)
    h = torch.tensor(k["hu"] * k["N"], dtype=torch.float32,
                     device=device).expand(B, -1)
    return args, k, Gu, h


def band_kron_check(cfg, B: int, seed: int, device) -> dict:
    """The band condensation and the Kronecker-cone ADMM on the walking QP
    (N = 20, nu = 3, mu = 6), float32:

    * ``condense_lti_diag`` against the dense ``condense`` in float64 (H
      and f relative to 1 + their largest entry: a few hundred f32
      roundings of the sums, 1e-5);
    * ``make_admm_warm_kron`` against ``make_admm_warm`` on the expanded G
      and against its plain twin (plain Cholesky), the same iterates up to
      the f32 rounding of two orders of K's sum and of two factorizations
      (z, y within 1e-4 of 1 + their largest entry; ~2e-5 on the CPU);
    * the composition ``condense_lti_diag`` + ``make_admm_warm_kron``
      (admm_warm_iters) against the ``fused_qp_nu3`` kernel (exact
      triangular solves) at 2e-3 * scale (tests/test_mpc_fused.py:154).

    On CPU tensors the kernels are their plain versions. Returns the
    errors and "ok"."""
    from mpc_limx_control_tpu_torch.ops import condense as cnd
    from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as mfc
    from mpc_limx_control_tpu_torch.ops import qp as qps

    args, k, Gu, h = band_kron_inputs(cfg, B, seed, device)
    Ad, Bd_t, x_ref, x0, z_w, y_w = args
    N = k["N"]
    H, f = cnd.condense_lti_diag(Ad, Bd_t, k["q_diag"], k["r_diag"],
                                 k["p_diag"], N, x0, x_ref)
    d = torch.float64

    def diag(v):
        return torch.diag(torch.tensor(v, dtype=d, device=device))

    G = torch.kron(torch.eye(N, device=device), Gu)
    qp64 = cnd.condense(Ad.to(d), Bd_t.to(d), diag(k["q_diag"]),
                        diag(k["r_diag"]), diag(k["p_diag"]), N, x0.to(d),
                        x_ref.to(d), extra_G=G.to(d), extra_h=h.to(d))

    def rel(a, b):
        return maxerr(a.to(d), b.to(d)) / (float(b.abs().max()) + 1.0)

    e = dict(H=rel(H, qp64.H), f=rel(f, qp64.f))
    solve = dict(iters=k["iters"], rho=k["rho"], alpha=k["alpha"])
    kron = qps.make_admm_warm_kron(Gu, **solve)
    sol, (z, y) = kron(H, f, h, z_w, y_w)
    sol_d, (z_d, y_d) = qps.make_admm_warm(**solve)(H, f, G, h, z_w, y_w)
    sol_t, (z_t, y_t) = qps.make_admm_warm_kron(Gu, plain_twins=True,
                                                **solve)(H, f, h, z_w, y_w)
    e.update(z_vs_dense=rel(z, z_d), y_vs_dense=rel(y, y_d),
             z_vs_twin=rel(z, z_t), y_vs_twin=rel(y, y_t),
             res_vs_dense=maxerr(sol.residual, sol_d.residual))
    _, (z_k, y_k) = mfc.make_admm_fused(cfg.srbd)(*args)
    scale = float(z_k.abs().max()) + 1.0
    e.update(scale=scale, z_vs_fused=maxerr(z, z_k), y_vs_fused=maxerr(y, y_k),
             finite=bool(torch.isfinite(z).all() and torch.isfinite(y).all()
                         and torch.isfinite(H).all()))
    e["ok"] = bool(e["finite"] and e["H"] <= 1e-5 and e["f"] <= 1e-5
                   and max(e["z_vs_dense"], e["y_vs_dense"], e["z_vs_twin"],
                           e["y_vs_twin"]) <= 1e-4
                   and e["z_vs_fused"] <= 2e-3 * scale
                   and e["y_vs_fused"] <= 2e-3 * scale)
    return e


def corpus_batch(cqs, dtype, device):
    """(H, f, G, h) of a list of CapturedQP stacked into one batch."""
    return tuple(torch.tensor(np.stack([getattr(c, k) for c in cqs]),
                              dtype=dtype, device=device) for k in "HfGh")


# float32 band misses of the captured corpus, known and logged as a fault
# (ROADMAP.md, queue 3): (set, tick) of the QP. On the pushed walking QP at
# tick 65 the best-merit pick of the f32 PDIP (pdip_qp on the K8 kernels
# and K9 alike) takes Newton step 5 (1.17e-2 from the exact solution) over
# step 6 (5.6e-3), as the arithmetic order decides. A miss anywhere else
# fails the [corpus] phase.
F32_BAND_FAULTS = {("walk", 65)}


def corpus_report(cqs, solutions: dict) -> dict:
    """The corpus against the float64 oracles, with the bands of
    tests/test_active_set_oracle.py, each QP relative to 1 + |z_exact|:

    * the active-set oracle against the interior-point oracle within 1e-8,
      its KKT residuals within 1e-8, and at least one QP of a walking
      corpus with an active constraint;
    * u_loop (the force the loop applied) against the exact u0 within 0.10
      where a constraint is active, 0.03 where none is; 5e-3 standing;
    * each float32 solution of `solutions` (name -> [len(cqs), n] array)
      within 1e-2 over the sequence and 1e-3 on u0: a miss is a fault,
      listed under "faults"; "ok" holds only where every miss is one of
      F32_BAND_FAULTS.

    Returns the worst error of each check, the faults and "ok"."""
    from mpc_limx_control_tpu_torch.oracle.qp_active_set import (
        solve_qp_active_set)
    from mpc_limx_control_tpu_torch.oracle.qp_oracle import solve_qp_oracle

    e = dict(qps=len(cqs), iterations=[c.iteration for c in cqs],
             active=[], oracle=0.0, kkt=0.0, u_loop=[], u_loop_ok=True,
             faults=[])
    e.update({f"{s}_seq": 0.0 for s in solutions})
    e.update({f"{s}_u0": 0.0 for s in solutions})
    for i, c in enumerate(cqs):
        z_as, _, info = solve_qp_active_set(c.H, c.f, c.G, c.h)
        z_ip, _, _ = solve_qp_oracle(c.H, c.f, c.G, c.h)
        scale = 1.0 + float(np.max(np.abs(z_as)))
        e["oracle"] = max(e["oracle"], float(np.max(np.abs(z_as - z_ip)))
                          / scale)
        e["kkt"] = max(e["kkt"], max(info["residuals"]) / scale)
        e["active"].append(len(info["active_set"]))
        d = float(np.max(np.abs(c.u_loop - z_as[:c.nu]))) / scale
        limit = 5e-3 if c.nu == 6 else (0.10 if info["active_set"] else 0.03)
        e["u_loop"].append(d)
        e["u_loop_ok"] = bool(e["u_loop_ok"] and d < limit)
        for name, z in solutions.items():
            dz = np.abs(np.asarray(z[i], np.float64) - z_as) / scale
            seq, u0 = float(np.max(dz)), float(np.max(dz[:c.nu]))
            e[f"{name}_seq"] = max(e[f"{name}_seq"], seq)
            e[f"{name}_u0"] = max(e[f"{name}_u0"], u0)
            if not (seq < 1e-2 and u0 < 1e-3):
                e["faults"].append(dict(
                    set="walk" if c.nu == 3 else "stand", tick=c.iteration,
                    solver=name, seq=seq, u0=u0, band_seq=1e-2,
                    band_u0=1e-3))
    e["ok"] = bool(e["oracle"] < 1e-8 and e["kkt"] < 1e-8 and e["u_loop_ok"]
                   and (cqs[0].nu == 6 or sum(e["active"]) > 0)
                   and all((f["set"], f["tick"]) in F32_BAND_FAULTS
                           for f in e["faults"]))
    return e


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    import mpc_limx_control_tpu_torch  # noqa: F401  (sets the TF32 pins)
    from mpc_limx_control_tpu_torch.control import controller as ctrl
    from mpc_limx_control_tpu_torch.control import rollout as ro
    from mpc_limx_control_tpu_torch.core.config import ControllerConfig
    from mpc_limx_control_tpu_torch.control import linear_mpc as lmpc
    from mpc_limx_control_tpu_torch.core.config import (MPCConfig,
                                                        SolverConfig)
    from mpc_limx_control_tpu_torch.ops import _build
    from mpc_limx_control_tpu_torch.ops import chol as cholp
    from mpc_limx_control_tpu_torch.ops import chol_cuda
    from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as mfc
    from mpc_limx_control_tpu_torch.ops import qp as qps
    from mpc_limx_control_tpu_torch.ops import qp_cuda
    from mpc_limx_control_tpu_torch.ops import riccati as ricmod
    from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc
    from mpc_limx_control_tpu_torch.models import dynamics
    from mpc_limx_control_tpu_torch.ops import condense as cnd
    from mpc_limx_control_tpu_torch.oracle import corpus
    from mpc_limx_control_tpu_torch.oracle.rnea_oracle import (
        solve_rnea_oracle)

    dev = torch.device("cuda", 0)
    kernels = {"walking_mpc_prep": mfc.WALKING_MPC_PREP}
    # the tick kernels, each under its entry point's name
    kernels.update({k.name: k for k in tfc.TICK_TABLE.values()})
    kernels.update({f"fused_qp_nu{nu}": k for nu, k in mfc.FUSED_QP.items()})
    kernels.update(chol_cuda.KERNELS)
    INV_TICKS = {False: "walking_tick_inv", True: "walking_tick_kf_inv"}
    kernels.update({"walking_mpc_prep_inv": mfc.WALKING_MPC_PREP_INV,
                    "fused_qp_nu3_inv": mfc.FUSED_QP_NU3_INV})
    STAND_INV_TICKS = {False: "standing_tick_inv",
                       True: "standing_tick_kf_inv"}
    kernels["fused_qp_nu6_inv"] = mfc.FUSED_QP_NU6_INV
    kernels["pdip_fused"] = qp_cuda.PDIP_FUSED
    kernels.update({k.name: k for k in tfc.SESSION_KERNELS})
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
            for name in mfc.MPC_ENTRIES for N in (8, 20, 22, 30, 42, 85)
            if N <= mfc.max_horizon(mfc.entry_nu(name))}
    for key, got in smem.items():
        name, N = key.rsplit("_N", 1)
        check(got == mfc.smem_bytes(name, int(N)),
              f"{name}: the wrapper's shared-memory size is not the "
              f"library's at N = {N}")
    # blocks an SM of each entry on the MPC core at N = 20 (the redesigned
    # core: at least five of the standing solving forms, four of
    # fused_qp_nu6, more than the six of the walking forms before it)
    per_sm = {name: getattr(lib, f"{name}_blocks_per_sm")(20)
              for name in mfc.MPC_ENTRIES}
    # and of the held-force forms (a half warp a scenario, eight a block of
    # 128 threads): at least four, so that B = 4096 runs as one wave
    hold_per_sm = {name: getattr(lib, f"{name}_blocks_per_sm")()
                   for name in _build.HOLD_ENTRIES}
    say("occupancy", N=20, smem_bytes={k: smem[f"{k}_N20"] for k in per_sm},
        blocks_per_sm=per_sm, hold_blocks_per_sm=hold_per_sm)
    check(min(per_sm["standing_tick"], per_sm["standing_tick_kf"]) >= 5
          and per_sm["fused_qp_nu6"] >= 4
          and min(per_sm[e] for e in ("walking_tick", "walking_tick_kf",
                                      "walking_mpc_prep")) > 6,
          f"blocks an SM at N = 20: {per_sm}")
    check(min(hold_per_sm.values()) >= 4,
          f"held-force blocks an SM: {hold_per_sm}")
    smem.update({f"{name}_n{n}_k1": getattr(lib, f"{name}_smem_bytes")(n, 1)
                 for name in chol_cuda.KERNELS for n in (30, 60, 120)})
    for name in chol_cuda.KERNELS:
        check(smem[f"{name}_n120_k1"] == chol_cuda.smem_bytes(name, 120, 1),
              f"{name}: the wrapper's shared-memory size is not the "
              "library's")
    # K9 at its three shapes: H stays in device memory (PERF.md)
    for n, m in PDIP_SHAPES:
        smem[f"pdip_fused_n{n}_m{m}"] = lib.pdip_fused_smem_bytes(n, m)
        check(smem[f"pdip_fused_n{n}_m{m}"] == qp_cuda.smem_bytes(n, m)
              <= qp_cuda.SMEM_LIMIT_BYTES,
              f"pdip_fused n={n} m={m}: shared memory {smem}")
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
    for name in chol_cuda.KERNELS:
        summary[name].update(source=CHOL_SRC, replaces=CHOL_TPU[name],
                             library=CHOL_LIBRARY[name])
    summary["walking_mpc_prep_inv"].update(source=PREP_SRC, replaces=PREP_TPU)
    summary["fused_qp_nu3_inv"].update(source=QP_SRC, replaces=QP_TPU)
    for name in INV_TICKS.values():
        summary[name].update(source=TICK_SRC, replaces=TICK_TPU)
    for name in STAND_INV_TICKS.values():
        summary[name].update(source=STAND_SRC, replaces=TICK_TPU)
    summary["fused_qp_nu6_inv"].update(source=QP_SRC, replaces=QP_TPU)
    summary["pdip_fused"].update(source=PDIP_SRC, replaces=PDIP_TPU,
                                 library="none")
    # the live session's ticks: the counterpart of XLA's fusion of the JAX
    # session's jax.jit closures (no Pallas kernel)
    for k in tfc.SESSION_KERNELS:
        summary[k.name].update(source=CSRC + "session_tick.cu",
                               replaces=SESSION_JAX, library="none")
    # no single PyTorch call computes a whole tick or a condensed-QP ADMM
    # solve: only the four kernels of csrc/chol.cu get a library yardstick
    # (timed in phase 7)
    for k in kernels:
        summary[k]["library_ms"] = None

    # ---- 3. walking_mpc_prep vs its plain version -----------------------
    base = ControllerConfig.walking()
    prep_err = 0.0
    for N in (20, 8, 30):
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

    # the generic fused QP (given, dense Ad), one and two feet per step,
    # also at N = 30 (n = 90: four solve rows a lane; n = 180: eight)
    def horizon(c, N):
        return dataclasses.replace(c, srbd=dataclasses.replace(c.srbd,
                                                               horizon=N))

    for nu, N in ((3, 20), (6, 20), (3, 30), (6, 30)):
        qcfg = horizon(base, N)
        args = qp_inputs(qcfg, nu, 257, seed=40 + nu + (N - 20), device=dev)
        solve = mfc.make_admm_fused(qcfg.srbd, two_feet=nu == 6)
        sol, (z, y) = solve(*args)
        torch.cuda.synchronize()
        sol_p, (z_p, y_p) = mfc.make_admm_fused(
            qcfg.srbd, two_feet=nu == 6, solve_form="subst")(*args)
        # bands a few times the f32 rounding of the two routes, each on
        # its own scale: forces of ~100 N, duals of a few N
        scale = float(z_p.abs().max()) + 1.0
        y_scale = float(y_p.abs().max()) + 1.0
        e = dict(u=maxerr(z, z_p), y=maxerr(y, y_p),
                 res=maxerr(sol.residual, sol_p.residual))
        say("fused_qp_vs_plain", nu=nu, N=N, B=257, scale=scale,
            y_scale=y_scale, **e, finite=bool(torch.isfinite(z).all()))
        check(bool(torch.isfinite(z).all() and torch.isfinite(y).all()),
              f"fused_qp_nu{nu} output not finite")
        check(e["u"] <= 1e-4 * scale, f"nu={nu} u error {e['u']}")
        check(e["y"] <= 1e-4 * y_scale, f"nu={nu} y error {e['y']}")
        check(e["res"] <= 1e-4, f"nu={nu} residual error {e['res']}")
        if N == 20:
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

    # the hold, KF and KF + hold variants (bands of tests/test_torch_cuda;
    # B = 257 leaves the hold forms' last half warp repeating scenario 256);
    # the two solving forms also past the 21 steps the walking core once
    # took (N = 22, 42: two and four solve rows a lane), same bands
    walk_cases = [(v, name, 20) for v, name in VARIANTS.items()
                  if name != "walking_tick"]
    walk_cases += [(v, name, N) for N in (22, 42)
                   for v, name in VARIANTS.items() if not v[1]]
    for (est_kf, hold), name, N in walk_cases:
        v1, v5 = variant_vs_plain(horizon(cfg, N), est_kf, hold, B, dev,
                                  f64=N > 20)
        say("variant_vs_plain", kernel=name, N=N, B=B, one=v1, five=v5)
        bands1 = [("xi", 3e-4), ("q", 5e-4), ("foot_l", 5e-4),
                  ("foot_r", 5e-4), ("grf", 5e-2), ("target", 5e-4),
                  ("anchor", 1e-5)]
        bands5 = [("xi", 5e-4), ("q", 1e-3), ("grf", 2e-1)]
        if est_kf:
            bands1 += [("x_hat", 5e-4), ("p_cov", 1e-5), ("est_error", 5e-4)]
            bands5 += [("x_hat", 5e-4), ("p_cov", 1e-5)]
        for k, tol in bands1:
            check(v1[k] <= tol, f"{name} one-tick {k} error {v1[k]} > {tol}")
        # past 21 steps a field five threaded ticks in may part from the
        # plain f32 tick by more than the N = 20 band (the two f32 routes'
        # rounding grows with the horizon): it then passes only if it stays
        # within twice that band and the kernel is within twice the plain
        # f32 tick's distance of the plain tick in float64
        for k, tol in bands5:
            k64, p64 = v5.get("f64", {}).get(k, (None, None))
            check(v5[k] <= tol or (k64 is not None and v5[k] <= 2.0 * tol
                                   and k64 <= 2.0 * p64),
                  f"{name} N={N} five-tick {k} error {v5[k]} > {tol} "
                  f"(against float64: kernel {k64}, plain f32 {p64})")
        check(v1["finite"] and v5["finite"], f"{name}: non-finite state")
        if hold:
            check(v1["res_max"] == 0.0 and v5["res_max"] == 0.0,
                  f"{name}: held tick with a non-zero residual")
        if N == 20:
            summary[name]["max_abs_err"] = v1["xi"]

    # the four standing forms at full width (n = 120), same bands; the
    # feet do not move, the solving forms' z within 2e-3 of its scale; the
    # solving forms also at N = 30 (n = 180, eight solve rows a lane)
    scfg = ControllerConfig.standing()
    stand_cases = [(v, name, 20) for v, name in STAND_VARIANTS.items()]
    stand_cases += [(v, name, 30) for v, name in STAND_VARIANTS.items()
                    if not v[1]]
    for (est_kf, hold), name, N in stand_cases:
        v1, v5 = variant_vs_plain(horizon(scfg, N), est_kf, hold, B, dev)
        say("variant_vs_plain", kernel=name, N=N, B=B, one=v1, five=v5)
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
        if N == 20:
            summary[name]["max_abs_err"] = v1["xi"]

    # ---- 7a. the batched Cholesky / SPD-solve kernels vs plain ----------
    # seeded SPD batches at B = 257 (not a multiple of 128): against the
    # plain versions and f64 numpy.linalg, bands of tests/test_qp_pallas.py
    # (2e-5 on L, 5e-5 on x)
    chol_err = {name: 0.0 for name in chol_cuda.KERNELS}
    for n in (30, 60, 120):
        for k in (1, 2):
            M64, r64, M, rhs = spd_batch(257, n, k, 100 + n + k, dev)
            L = chol_cuda.cholesky(M)
            xs = {"chol_solve": chol_cuda.chol_solve(L, rhs),
                  "posdef_solve": chol_cuda.posdef_solve(M, rhs),
                  "posdef_solve_fast": chol_cuda.posdef_solve_fast(M, rhs)}
            torch.cuda.synchronize()
            L_p = cholp.cholesky_plain(M)
            x_p = cholp.posdef_solve_plain(M, rhs)
            x64 = np.linalg.solve(M64, r64)
            e = dict(L=maxerr(L, L_p), L_f64=float(np.abs(
                L.double().cpu().numpy() - np.linalg.cholesky(M64)).max()),
                upper=float(torch.triu(L, 1).abs().sum()))
            check(e["L"] <= 2e-5 and e["L_f64"] <= 2e-5 and e["upper"] == 0.0,
                  f"cholesky n={n}: {e}")
            chol_err["cholesky"] = max(chol_err["cholesky"], e["L"])
            for name, x in xs.items():
                e[name] = maxerr(x, x_p)
                e[name + "_f64"] = float(np.abs(
                    x.double().cpu().numpy() - x64).max())
                check(e[name] <= 5e-5 and e[name + "_f64"] <= 5e-5,
                      f"{name} n={n} k={k}: {e}")
                chol_err[name] = max(chol_err[name], e[name])
            e["chol_solve_given_L"] = maxerr(
                xs["chol_solve"], cholp.chol_solve_plain(L, rhs))
            check(e["chol_solve_given_L"] <= 5e-5, f"chol_solve n={n}: {e}")
            say("chol_vs_plain", B=257, n=n, k=k, **e)
    # the last Newton steps of a cold PDIP on the walking QP (d = lam / s
    # up to 1e7): scenarios whose twin factor keeps every pivot above 1e-6
    # (a late f32 iterate can leave the positive definite cone; the solver
    # never returns what follows from it).  At a condition number of ~1e7
    # two f32 solves of one system agree in no digit of x, so the solves
    # are held to their backward error |M x - r| / (|M| |x| + |r|) (inf
    # norms; 1e-5, and within 4x of the twin's) and the factor to 1e-4 of
    # its scale against the twin and 1e-5 of |M| in |L L' - M|
    def backward(Mk, x, rk):
        num = (Mk @ x - rk).abs().amax((-2, -1))
        den = (Mk.abs().sum(-1).amax(-1) * x.abs().amax((-2, -1))
               + rk.abs().amax((-2, -1)))
        return float((num / den).max())

    Hq, fq, Gq, hq = walking_qp(base, 128, 9, dev)
    late_kept, late = 0, dict(L=0.0, LLt=0.0, x_backward=0.0,
                              twin_backward=0.0)
    for Mk, rk in zip(*late_pdip_systems(Hq, fq, Gq, hq, 20, range(15, 20))):
        L_p = cholp.cholesky_plain(Mk)
        piv = torch.diagonal(L_p, dim1=-2, dim2=-1)
        ok = (torch.isfinite(L_p).all(-1).all(-1) & (piv > 1e-6).all(-1)
              & torch.isfinite(rk).all(-1).all(-1))
        if int(ok.sum()) == 0:
            continue
        late_kept += int(ok.sum())
        Mk, rk, L_p = Mk[ok].contiguous(), rk[ok].contiguous(), L_p[ok]
        L = chol_cuda.cholesky(Mk)
        late["L"] = max(late["L"], maxerr(L, L_p) / float(L_p.abs().max()))
        late["LLt"] = max(late["LLt"], float(
            ((L @ L.transpose(-1, -2) - Mk).abs().amax((-2, -1))
             / Mk.abs().amax((-2, -1))).max()))
        late["twin_backward"] = max(late["twin_backward"], backward(
            Mk, cholp.chol_solve_plain(L_p, rk), rk))
        for x in (chol_cuda.chol_solve(L, rk), chol_cuda.posdef_solve(Mk, rk),
                  chol_cuda.posdef_solve_fast(Mk, rk)):
            check(bool(torch.isfinite(x).all()), "late PDIP solve not finite")
            late["x_backward"] = max(late["x_backward"], backward(Mk, x, rk))
    say("chol_vs_plain_late_pdip", scenarios=late_kept,
        spread=float(Mk.abs().max()), **late)
    check(late_kept >= 64 and late["L"] <= 1e-4 and late["LLt"] <= 1e-5
          and late["x_backward"] <= max(1e-5, 4.0 * late["twin_backward"]),
          f"late PDIP matrices: kept {late_kept}, {late}")
    for name in chol_cuda.KERNELS:
        summary[name]["max_abs_err"] = chol_err[name]

    # the whole solvers on the kernels against the same solvers on the
    # plain twins (walking QP, B = 64): 5e-3 of the force scale after a
    # fixed number of Newton steps, where the best-iterate pick can differ
    # between two arithmetic orders (the JAX suite holds 5e-2 on z of
    # O(10), tests/test_qp_pallas.py:66); 2e-3 for the dense ADMM
    Hs, fs_, Gs, hs = (a[:64] for a in (Hq, fq, Gq, hq))
    zw = torch.tensor(5.0 * np.random.default_rng(2).standard_normal(
        (64, 60)), dtype=torch.float32, device=dev)
    for label, run, band in (
            ("pdip_cold", lambda tw: qps._batched_pdip(
                Hs, fs_, Gs, hs, 8, plain_twins=tw), 5e-3),
            ("pdip_warm", lambda tw: qps._batched_pdip(
                Hs, fs_, Gs, hs, 8, z_warm=zw, lam_warm=torch.ones_like(hs),
                plain_twins=tw), 5e-3),
            ("admm", lambda tw: qps._batched_admm(
                Hs, fs_, Gs, hs, zw, torch.zeros_like(hs), 20, 0.3, 1.6,
                plain_twins=tw), 2e-3)):
        u_k, u_p = run(False)[0].u, run(True)[0].u
        scale = float(u_p.abs().max()) + 1.0
        say("solver_vs_twins", solver=label, B=64, scale=scale,
            u=maxerr(u_k, u_p))
        check(maxerr(u_k, u_p) <= band * scale,
              f"{label}: kernels vs twins {maxerr(u_k, u_p)} > {band}*{scale}")

    # ---- 7b. the inv forms vs their "linv" twin and the subst kernels --
    icfg = with_solver(base, solve_form="inv")
    for N in (20, 8):
        c_i = dataclasses.replace(icfg, srbd=dataclasses.replace(
            icfg.srbd, horizon=N))
        c_s = with_solver(c_i, solve_form="subst")
        args = prep_inputs(c_i, 257, seed=21 + N, device=dev)
        z, y, res, xp = mfc.fused_walking_qp_prep(*args, cfg=c_i)
        torch.cuda.synchronize()
        sol, xp_p, (z_p, y_p) = mfc.walking_qp_prep_plain(
            c_i, *args, solve_form="linv")
        z_s = mfc.fused_walking_qp_prep(*args, cfg=c_s)[0]
        scale = float(z_p.abs().max()) + 1.0
        e = dict(u=maxerr(z, z_p), y=maxerr(y, y_p), xi_pred=maxerr(xp, xp_p),
                 u_vs_subst=maxerr(z, z_s))
        say("prep_inv_vs_plain", N=N, B=257, scale=scale, **e)
        check(bool(torch.isfinite(z).all() and torch.isfinite(y).all()),
              "walking_mpc_prep_inv output not finite")
        check(e["u"] <= 2e-3 * scale and e["y"] <= 2e-3 * scale
              and e["xi_pred"] <= 1e-3 * scale,
              f"walking_mpc_prep_inv vs linv twin: {e}")
        # the band tests/test_mpc_fused.py:288 holds the two forms to
        check(e["u_vs_subst"] <= 1e-4 * scale,
              f"walking_mpc_prep_inv vs subst kernel: {e}")
        if N == 20:
            summary["walking_mpc_prep_inv"]["max_abs_err"] = e["u"]
    args = qp_inputs(base, 3, 257, seed=43, device=dev)
    sol, (z, y) = mfc.make_admm_fused(icfg.srbd)(*args)
    torch.cuda.synchronize()
    sol_p, (z_p, y_p) = mfc.make_admm_fused(icfg.srbd,
                                            solve_form="linv")(*args)
    sol_s, _ = mfc.make_admm_fused(base.srbd)(*args)
    scale = float(z_p.abs().max()) + 1.0
    e = dict(u=maxerr(z, z_p), y=maxerr(y, y_p),
             res=maxerr(sol.residual, sol_p.residual),
             u_vs_subst=maxerr(z, sol_s.u))
    say("fused_qp_inv_vs_plain", nu=3, N=20, B=257, scale=scale, **e)
    check(e["u"] <= 1e-4 * scale and e["res"] <= 1e-4
          and e["u_vs_subst"] <= 1e-4 * scale,
          f"fused_qp_nu3_inv: {e}")
    summary["fused_qp_nu3_inv"]["max_abs_err"] = e["u"]
    for est_kf, name in INV_TICKS.items():
        v1, v5 = variant_vs_plain(icfg, est_kf, False, B, dev)
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
        summary[name]["max_abs_err"] = v1["xi"]
        # against the subst kernel's tick from the same state
        c_i = dataclasses.replace(icfg, estimator_mode="kf") if est_kf \
            else icfg
        s_i = perturbed_states(c_i, B, seed=1, device=dev,
                               yaw=0.0 if est_kf else 0.1)
        si2, mi2 = ro.plant_step(c_i, s_i, its)
        ss2, ms2 = ro.plant_step(with_solver(c_i, solve_form="subst"), s_i,
                                 its)
        e = dict(xi=maxerr(si2.xi, ss2.xi), grf=maxerr(mi2["grf"],
                                                       ms2["grf"]))
        say("tick_inv_vs_subst", kernel=name, B=B, **e)
        check(e["xi"] <= 3e-4 and e["grf"] <= 5e-2,
              f"{name} vs the subst tick: {e}")

    # the standing inv entries: the factor inverse where n = 6 N <= 64, so
    # at N = 8 (n = 48) against their "linv" twin (the bands of the subst
    # forms) and within the twin forms' band of the subst kernel; at N = 11
    # (n = 66) the substitution kernel, their subst entry's outputs bit for
    # bit
    for N in (8, 11):
        sc_s = horizon(scfg, N)
        sc_i = with_solver(sc_s, solve_form="inv")
        args = qp_inputs(horizon(base, N), 6, 257, seed=80 + N, device=dev)
        sol, (z, y) = mfc.make_admm_fused(sc_i.srbd, two_feet=True)(*args)
        sol_s, (z_s, y_s) = mfc.make_admm_fused(sc_s.srbd,
                                                two_feet=True)(*args)
        torch.cuda.synchronize()
        if N == 8:
            sol_p, (z_p, y_p) = mfc.make_admm_fused(
                sc_i.srbd, two_feet=True, solve_form="linv")(*args)
            scale = float(z_p.abs().max()) + 1.0
            y_scale = float(y_p.abs().max()) + 1.0
            e = dict(u=maxerr(z, z_p), y=maxerr(y, y_p),
                     res=maxerr(sol.residual, sol_p.residual),
                     u_vs_subst=maxerr(z, z_s))
            say("fused_qp_inv_vs_plain", nu=6, N=N, B=257, scale=scale,
                y_scale=y_scale, **e)
            check(bool(torch.isfinite(z).all() and torch.isfinite(y).all())
                  and e["u"] <= 1e-4 * scale and e["y"] <= 1e-4 * y_scale
                  and e["res"] <= 1e-4 and e["u_vs_subst"] <= 1e-4 * scale,
                  f"fused_qp_nu6_inv: {e}")
            summary["fused_qp_nu6_inv"]["max_abs_err"] = e["u"]
        else:
            same = all(torch.equal(a, b) for a, b in (
                (z, z_s), (y, y_s), (sol.residual, sol_s.residual)))
            say("fused_qp_inv_vs_subst", nu=6, N=N, B=257, bit_equal=same)
            check(same, f"fused_qp_nu6_inv at N = {N} is not the subst "
                  "kernel bit for bit")
        for est_kf, name in STAND_INV_TICKS.items():
            if N == 8:
                v1, v5 = variant_vs_plain(sc_i, est_kf, False, B, dev)
                say("variant_vs_plain", kernel=name, N=N, B=B, one=v1,
                    five=v5)
                bands1 = [("xi", 3e-4), ("q", 5e-4), ("foot_l", 0.0),
                          ("foot_r", 0.0), ("grf", 5e-2), ("target", 5e-4)]
                bands5 = [("xi", 5e-4), ("q", 1e-3), ("grf", 2e-1)]
                if est_kf:
                    bands1 += [("x_hat", 5e-4), ("p_cov", 1e-5),
                               ("est_error", 5e-4)]
                    bands5 += [("x_hat", 5e-4), ("p_cov", 1e-5)]
                for k, tol in bands1:
                    check(v1[k] <= tol,
                          f"{name} one-tick {k} error {v1[k]} > {tol}")
                for k, tol in bands5:
                    check(v5[k] <= tol,
                          f"{name} five-tick {k} error {v5[k]} > {tol}")
                check(v1["finite"] and v5["finite"] and
                      v1["z"] <= 2e-3 * v1["z_scale"],
                      f"{name}: non-finite state or z error {v1['z']}")
                summary[name]["max_abs_err"] = v1["xi"]
            else:
                c_i = dataclasses.replace(sc_i, estimator_mode="kf") \
                    if est_kf else sc_i
                s_i = perturbed_states(c_i, B, seed=1, device=dev)
                si2, mi2 = ro.plant_step(c_i, s_i, its)
                ss2, ms2 = ro.plant_step(with_solver(c_i, solve_form="subst"),
                                         s_i, its)
                pairs = [(si2.xi, ss2.xi), (si2.q, ss2.q),
                         (si2.qp_z, ss2.qp_z), (si2.qp_lam, ss2.qp_lam),
                         (mi2["grf"], ms2["grf"])]
                if est_kf:
                    pairs.append((si2.kf.p_cov, ss2.kf.p_cov))
                same = all(torch.equal(a, b) for a, b in pairs)
                say("tick_inv_vs_subst", kernel=name, N=N, B=B,
                    bit_equal=same)
                check(same, f"{name} at N = {N} is not the subst kernel "
                      "bit for bit")

    # ---- 8a. pdip_fused (K9) vs its plain version ------------------------
    # pdip_check at 6 Newton steps (M well conditioned: all four outputs)
    # and at 20 (d at its 1e7 cap), on B = 257 QPs and on the first of them
    # alone; the merit's floor is measured on the 257.
    def pdip_inputs(n, B, seed):
        if n == 30:
            H, f, G, h = recipe_qp(B, seed, dev)
            return [a.contiguous() for a in (
                H, f, G, h, torch.zeros_like(f), torch.ones_like(h),
                torch.ones_like(h))]
        if n == 60:
            return pdip_start(*walking_qp(base, B, seed, dev))
        return pdip_start(*standing_qp(B, seed, dev))

    pdip_err = 0.0
    for n, m in PDIP_SHAPES:
        args = pdip_inputs(n, 257, 30 + n)
        for iters in (6, 20):
            floor = pdip_floor(args, iters)
            for a in (args, [t[:1].contiguous() for t in args]):
                e = pdip_check(a, iters, floor)
                say("pdip_fused_vs_plain", n=n, m=m, B=a[1].shape[0],
                    steps=iters, **e)
                check(e["ok"], f"pdip_fused n={n} m={m} B={a[1].shape[0]}, "
                      f"{iters} steps: {e}")
                if iters == 6:
                    pdip_err = max(pdip_err, e["z_final_abs"])
    summary["pdip_fused"]["max_abs_err"] = pdip_err

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

    # 10-window x 1000-tick soaks at B = 64, gait phases staggered over a
    # cycle (600 ticks), with the 10k-tick bands of tests/test_soak.py
    Bs, NW, W = 64, 10, 1000
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

    # ---- 7c. the general-solver paths (no tick kernel launches) --------
    def solver_counts(ticks_, iters, cold):
        """Launches of `ticks_` PDIP solves of `iters` Newton steps: one
        factorization and two solves per step, one fused solve per cold
        start."""
        out = {"cholesky": ticks_ * iters, "chol_solve": 2 * ticks_ * iters}
        if cold:
            out["posdef_solve"] = ticks_
        return out

    Bg = 64
    vx_kick = torch.tensor(
        np.outer(0.05 * np.random.default_rng(7).standard_normal(Bg),
                 np.eye(13)[9]), dtype=torch.float32, device=dev)

    def general_walk(name, c, steps, floor):
        s = ro.initial_plant_state(c, batch=(Bg,), device=dev)
        f, m = ro.batched_rollout(c, s.replace(xi=s.xi + vx_kick), steps)
        q[f"{name}_height_min"] = float(m["height"].min())
        q[f"{name}_vx_mean"] = float(m["velocity"][:, -200:, 0].mean())
        q[f"{name}_ok"] = bool(torch.isfinite(f.xi).all()
                               and torch.isfinite(m["height"]).all()
                               and q[f"{name}_height_min"] > floor
                               and (m["qp_residual"] > 0).all())

    # (a) warm PDIP (tests/test_config_variants.py:66-75: height > 0.5)
    pw = dataclasses.replace(base, srbd=dataclasses.replace(
        base.srbd, solver=SolverConfig(method="pdip", iters=12)))
    path("pdip_warm_walk", lambda: general_walk("pdip_warm_walk", pw, 700,
                                                0.5),
         solver_counts(700, pw.srbd.solver.warm_iters, cold=False))
    # (b) cold dense ADMM (tests/test_config_variants.py:43-53: > 0.45)
    ac = dataclasses.replace(base, qp_warm_start=False,
                             srbd=dataclasses.replace(
                                 base.srbd, solver=SolverConfig(
                                     method="admm", iters=60, admm_rho=0.1)))
    path("admm_cold_walk", lambda: general_walk("admm_cold_walk", ac, 700,
                                                0.45), {"cholesky": 700})

    # (c) ControllerConfig() as it is: a cold 20-step PDIP on the
    # reference's literal weights (ts = 1 ms, R = 0.1), whose cheapest
    # answer is a few newtons -- the base sinks under gravity, in the JAX
    # package too (SRBDConfig.walking's note).  Checked: finite, forces
    # inside their cones, and the sink of a body that is barely held up.
    def default_cfg(mode):
        c = dataclasses.replace(ControllerConfig(), mode=mode)
        s = ro.initial_plant_state(c, batch=(Bg,), device=dev)
        check(s.qp_z is None, "the default config threads no warm state")
        f, m = ro.batched_rollout(c, s, 100)
        g = m["grf"]
        name = f"default_{mode}"
        q[f"{name}_height_end"] = float(m["height"][:, -1].mean())
        q[f"{name}_fz_max"] = float(g[..., [2, 5]].max())
        cone = bool((g[..., [2, 5]] >= -1e-3).all()
                    and (g[..., [0, 1]].abs()
                         <= 0.5 * g[..., 2:3] + 5e-2).all()
                    and (g[..., [3, 4]].abs()
                         <= 0.5 * g[..., 5:6] + 5e-2).all())
        q[f"{name}_ok"] = bool(torch.isfinite(f.xi).all() and cone
                               and 0.55 < q[f"{name}_height_end"] < 0.65
                               and (m["qp_residual"] > 0).all())

    for mode in ("stand", "walk"):
        path(f"default_{mode}", lambda mode=mode: default_cfg(mode),
             solver_counts(100, 20, cold=True))

    # the same cold PDIP on the walking tuning holds the height
    def pdip_cold_stand():
        c = with_solver(scfg, warm=False, method="pdip", iters=20)
        s = ro.initial_plant_state(c, batch=(Bg,), device=dev)
        f, m = ro.batched_rollout(c, s.replace(xi=s.xi + vy_kick), 150)
        q["pdip_cold_stand_height"] = float(m["height"][:, -50:].mean())
        q["pdip_cold_stand_ok"] = bool(
            torch.isfinite(f.xi).all()
            and abs(q["pdip_cold_stand_height"] - 0.65) < 0.01
            and float((m["height"] - 0.65).abs().max()) < 0.02)

    path("pdip_cold_stand", pdip_cold_stand,
         solver_counts(150, 20, cold=True))
    pc = with_solver(base, warm=False, method="pdip", iters=20)
    path("pdip_cold_walk", lambda: general_walk("pdip_cold_walk", pc, 150,
                                                0.5),
         solver_counts(150, 20, cold=True))

    # (d) the linear MPC: B = 4096 initial states around the four of
    # tests/test_closed_loop.py:61-66, the reference's 500 steps; scenario
    # 0 reproduces the B = 1 run (its first 100 steps), every scenario
    # tracks (final error < 0.2) inside the input box (:76-81)
    lcfg = MPCConfig(solver=SolverConfig(iters=25))
    Bl, Tl, T1 = 4096, 500, 100
    x0_four = np.asarray([[2.0, 0.0, 0.0, 0.0], [1.5, 0.2, 0.5, -0.1],
                          [2.5, -0.3, -0.5, 0.2], [0.0, 0.0, 0.0, 0.0]])
    x0s = np.tile(x0_four, (Bl // 4, 1)) + 0.05 * np.random.default_rng(
        12).standard_normal((Bl, 4))
    x0s[:4] = x0_four

    def linear_mpc_loop():
        params = lmpc.setup(lcfg)
        check(params.Ad.device.type == "cuda", "linear MPC not on the card")
        runs = lmpc.batched_closed_loop(
            lcfg, params, torch.tensor(x0s, dtype=torch.float32, device=dev),
            Tl)
        one = lmpc.closed_loop(lcfg, params, torch.tensor(
            x0_four[0], dtype=torch.float32, device=dev), T1)
        err = runs["errors"]
        q["linear_mpc_u0_vs_single"] = maxerr(runs["controls"][0, :T1],
                                              one["controls"])
        q["linear_mpc_final_err_max"] = float(err[:, -20:].mean(1).max())
        q["linear_mpc_u_abs_max"] = float(runs["controls"].abs().max())
        q["linear_mpc_ok"] = bool(
            torch.isfinite(runs["states"]).all()
            and q["linear_mpc_u0_vs_single"] < 1e-3
            and q["linear_mpc_final_err_max"] < 0.2
            and q["linear_mpc_u_abs_max"] <= 8.0 + 1e-4)

    path("linear_mpc", linear_mpc_loop,
         solver_counts(Tl + T1, 25, cold=True))

    # posdef_solve_fast is an entry point of its own (no solver calls it,
    # as in the JAX package): the cold-start system (H + reg I) z = -f of
    # the walking QP at B = 4096, held against posdef_solve
    def posdef_fast_entry():
        Hb, fb, _, _ = walking_qp(base, 4096, 13, dev)
        A = (Hb + 1e-6 * torch.eye(60, device=dev)).contiguous()
        rhs = (-fb)[..., None].contiguous()
        z_f = chol_cuda.posdef_solve_fast(A, rhs)
        z_s = chol_cuda.posdef_solve(A, rhs)
        scale = float(z_s.abs().max()) + 1.0
        resid = float(((A @ z_f) - rhs).abs().max()
                      / (float(rhs.abs().max()) + 1.0))
        q["posdef_fast_vs_posdef_rel"] = maxerr(z_f, z_s) / scale
        q["posdef_fast_residual_rel"] = resid
        q["posdef_fast_ok"] = bool(q["posdef_fast_vs_posdef_rel"] <= 1e-5
                                   and resid <= 1e-3)

    path("posdef_fast_entry", posdef_fast_entry,
         {"posdef_solve_fast": 1, "posdef_solve": 1})

    # (e) walking with solve_form="inv": bench.py's walk band at B = 64,
    # the KF gate, controller.tick and the make_admm_fused entry point
    kicfg = dataclasses.replace(icfg, estimator_mode="kf")

    def inv_walk():
        s = ro.initial_plant_state(icfg, batch=(Bg,), device=dev)
        _, m = ro.batched_rollout(icfg, s.replace(xi=s.xi + vx_kick), 3000)
        h, vx = m["height"][:, -600:], m["velocity"][:, -600:, 0]
        q["inv_walk_height_mean"] = float(h.mean())
        q["inv_walk_vx_mean"] = float(vx.mean())
        q["inv_walk_ok"] = bool(torch.isfinite(m["height"]).all()
                                and abs(q["inv_walk_height_mean"] - 0.65)
                                < 0.02
                                and abs(q["inv_walk_vx_mean"] - 0.5) < 0.05)

    def inv_kf():
        _, km = ro.rollout(kicfg, ro.initial_plant_state(kicfg, device=dev),
                           1200)
        q["inv_kf_height_min"] = float(km["height"].min())
        q["inv_kf_ok"] = bool(torch.isfinite(km["height"]).all()
                              and q["inv_kf_height_min"] > 0.6
                              and torch.isfinite(km["kf_cov_pos"]).all())

    def inv_ctrl_tick():
        sc = ro.initial_plant_state(icfg, batch=(Bc,), device=dev)
        hc = []
        for t in range(300):
            sc, mc = ro._plant_step_ref(icfg, sc, torch.full(
                (Bc,), float(t), device=dev))
            hc.append(mc["height"])
        hc = torch.stack(hc, 1)
        q["inv_ctrl_tick_height_min"] = float(hc.min())
        q["inv_ctrl_tick_ok"] = bool(torch.isfinite(hc).all()
                                     and q["inv_ctrl_tick_height_min"] > 0.6)

    def inv_qp_entry():
        from mpc_limx_control_tpu_torch.models import srbd

        solve = mfc.make_admm_fused(icfg.srbd)
        arms, x0, v_des, w_des, z_w, y_w, anc = prep_inputs(
            icfg, 64, seed=70, device=dev)
        Ac, Bc_ = srbd.linearize_shared(icfg.robot, arms, x0[:, 3:6],
                                        x0[:, 2])
        Ad, Bd_t = srbd.discretize_srbd(Ac, Bc_, icfg.srbd.ts)
        anc3 = torch.cat([anc[:, :2], torch.zeros_like(anc[:, :1])], -1)
        x_ref = srbd.walking_reference(
            x0, icfg.srbd, icfg.srbd.horizon, v_des, w_des,
            height_des=icfg.ground_height + icfg.base_height,
            pos_anchor=anc3, yaw_anchor=anc[:, 2])
        sol, _ = solve(Ad, Bd_t, x_ref, x0, z_w, y_w)
        z_prep = mfc.fused_walking_qp_prep(arms, x0, v_des, w_des, z_w, y_w,
                                           anc, cfg=icfg)[0]
        q["inv_qp_entry_vs_prep_rel"] = maxerr(sol.u, z_prep) / (
            float(z_prep.abs().max()) + 1.0)
        q["inv_qp_entry_ok"] = bool(q["inv_qp_entry_vs_prep_rel"] <= 2e-3)

    path("inv_walk", inv_walk, {"walking_tick_inv": 3000})
    path("inv_kf", inv_kf, {"walking_tick_kf_inv": 1200})
    path("inv_ctrl_tick", inv_ctrl_tick, {"walking_mpc_prep_inv": 300})
    path("inv_qp_entry", inv_qp_entry,
         {"fused_qp_nu3_inv": 1, "walking_mpc_prep_inv": 1})

    # (e') standing with solve_form="inv" at N = 8 (n = 48: the factor
    # inverse, as the TPU kernel forms it there): the stand gate's vy kick
    # for 1000 ticks, the KF with both feet down for 600, and a standing
    # controller.tick loop (fused_qp_nu6_inv); finite, height above 0.6
    sicfg = with_solver(horizon(scfg, 8), solve_form="inv")
    ksicfg = dataclasses.replace(sicfg, estimator_mode="kf")

    def inv_stand():
        s = ro.initial_plant_state(sicfg, device=dev)
        _, m = ro.rollout(sicfg, s.replace(xi=s.xi + vy_kick), 1000)
        q["inv_stand_height"] = float(m["height"][-300:].mean())
        q["inv_stand_height_min"] = float(m["height"].min())
        q["inv_stand_ok"] = bool(torch.isfinite(m["height"]).all()
                                 and q["inv_stand_height_min"] > 0.6)

    def inv_kf_stand():
        _, m = ro.rollout(ksicfg, ro.initial_plant_state(ksicfg, device=dev),
                          600)
        q["inv_kf_stand_height_min"] = float(m["height"].min())
        q["inv_kf_stand_ok"] = bool(torch.isfinite(m["height"]).all()
                                    and q["inv_kf_stand_height_min"] > 0.6
                                    and torch.isfinite(m["kf_cov_pos"]).all())

    def inv_stand_ctrl_tick():
        sc = ro.initial_plant_state(sicfg, batch=(Bc,), device=dev)
        sc = sc.replace(xi=sc.xi + vy_kick)
        hs = []
        for t in range(100):
            sc, mc = ro._plant_step_ref(sicfg, sc, torch.full(
                (Bc,), float(t), device=dev))
            hs.append(mc["height"])
        hs = torch.stack(hs, 1)
        q["inv_stand_ctrl_tick_height_min"] = float(hs.min())
        q["inv_stand_ctrl_tick_ok"] = bool(
            torch.isfinite(hs).all()
            and q["inv_stand_ctrl_tick_height_min"] > 0.6)

    path("inv_stand", inv_stand, {"standing_tick_inv": 1000})
    path("inv_kf_stand", inv_kf_stand, {"standing_tick_kf_inv": 600})
    path("inv_stand_ctrl_tick", inv_stand_ctrl_tick,
         {"fused_qp_nu6_inv": 100})

    # (f) K9 as the entry point it is (no controller path calls it, as in
    # the JAX package): the cold walking QP at B = 4096, 20 Newton steps,
    # held against ops.qp's PDIP on the K8 kernels from the same start
    def pdip_fused_entry():
        H, f, G, h = walking_qp(base, 4096, 14, dev)
        args = pdip_start(H, f, G, h)
        zb, merit, _, _ = qp_cuda.pdip_fused(*args, iters=20)
        sol, _ = qps._batched_pdip(H, f, G, h, 20)
        J_k, J_b = qp_objective(H, f, zb), qp_objective(H, f, sol.u)
        viol = float(torch.clamp((G @ zb[..., None])[..., 0] - h,
                                 min=0.0).amax())
        q["pdip_fused_vs_batched_objective"] = float(
            ((J_k - J_b).abs() / (1.0 + J_b.abs())).max())
        q["pdip_fused_viol"] = viol
        q["pdip_fused_merit_max"] = float(merit.max())
        q["pdip_fused_ok"] = bool(
            torch.isfinite(zb).all()
            and q["pdip_fused_vs_batched_objective"] <= 1e-3
            and viol <= 1e-3 * (1.0 + float(h.abs().max())))

    path("pdip_fused_entry", pdip_fused_entry,
         dict(solver_counts(1, 20, cold=True), pdip_fused=1))

    # (g) the controller variants the tick kernels refuse, on the card
    # through plant_step (the composition): the Riccati ADMM walking
    # (tests/test_riccati.py:78-94), Riccati against make_admm_fused on the
    # same QPs (:54-75, 3e-3 of the force scale), the damped-LS and log6
    # swing IKs (tests/test_config_variants.py:20-41) and the receding
    # attitude reference (no closed-loop band in the JAX suite; the
    # damped-LS band, height min > 0.5, is used)
    rcfg = with_solver(base, method="riccati")
    dls = dataclasses.replace(base, ik_method="damped_ls")
    l6 = dataclasses.replace(base, ik_method="log6")
    rec = dataclasses.replace(base, srbd=dataclasses.replace(
        base.srbd, attitude_ref="receding"))
    for c in (rcfg, dls, l6, rec):
        check(ro.tick_route(c).path == "composition",
              f"{c} is not a composition")

    def variant_loop(name, c, steps, floor, batch=None):
        if batch is None:
            f, m = ro.rollout(c, ro.initial_plant_state(c, device=dev), steps)
        else:
            f, m = ro.batched_rollout(c, ro.initial_plant_state(
                c, batch=(batch,), device=dev), steps)
        q[f"{name}_height_min"] = float(m["height"].min())
        q[f"{name}_ok"] = bool(torch.isfinite(f.xi).all()
                               and torch.isfinite(m["height"]).all()
                               and q[f"{name}_height_min"] > floor)

    def riccati_vs_fused():
        from mpc_limx_control_tpu_torch.models import srbd

        arms, x0, v_des, w_des, z_w, y_w, anc = prep_inputs(
            rcfg, 16, seed=80, device=dev)
        Ac, Bc_ = srbd.linearize_shared(rcfg.robot, arms, x0[:, 3:6],
                                        x0[:, 2])
        Ad, Bd_t = srbd.discretize_srbd(Ac, Bc_, rcfg.srbd.ts)
        x_ref = srbd.walking_reference(x0, rcfg.srbd, rcfg.srbd.horizon,
                                       v_des, w_des, height_des=0.65)
        _, (z_r, y_r) = ricmod.make_admm_riccati(rcfg.srbd)(
            Ad, Bd_t, x_ref, x0, z_w, y_w)
        _, (z_c, y_c) = mfc.make_admm_fused(rcfg.srbd)(
            Ad, Bd_t, x_ref, x0, z_w, y_w)
        scale = float(z_c.abs().max()) + 1.0
        q["riccati_vs_fused_z_rel"] = maxerr(z_r, z_c) / scale
        q["riccati_vs_fused_y_rel"] = maxerr(y_r, y_c) / scale
        q["riccati_vs_fused_ok"] = bool(q["riccati_vs_fused_z_rel"] <= 3e-3
                                        and q["riccati_vs_fused_y_rel"]
                                        <= 3e-3)

    path("riccati_walk", lambda: variant_loop("riccati_walk", rcfg, 400,
                                              0.55, batch=4), {})
    path("riccati_vs_fused", riccati_vs_fused, {"fused_qp_nu3": 1})
    path("damped_ls_walk", lambda: variant_loop("damped_ls_walk", dls, 700,
                                                0.5),
         {"walking_mpc_prep": 700})
    path("log6_walk", lambda: variant_loop("log6_walk", l6, 700, 0.45),
         {"walking_mpc_prep": 700})
    path("receding_walk", lambda: variant_loop("receding_walk", rec, 700,
                                               0.5), {"cholesky": 700})

    # (h) a horizon past the 21 steps the MPC kernels once took (N = 22):
    # the compositions that launch no MPC kernel run on the card, their
    # dense QPs (n = 66 walking, 132 standing) on the K8 kernels, with the
    # bands of their N = 20 paths above; the walking MPC kernels take 1 to
    # 85 steps: the fused walking tick runs 100 ticks at N = 22 and 42 and
    # refuses N = 86 before the tick, naming the limit; the standing ones
    # take 1 to 42: the fused standing tick and the warm standing ADMM run
    # their kernels at N = 22, the fused standing tick at N = 30 (n = 180)
    # for 100 ticks
    def n22(c):
        return horizon(c, 22)

    pw22, ric22, rec22 = n22(pw), n22(rcfg), n22(rec)
    cs22 = n22(with_solver(scfg, warm=False, method="pdip", iters=20))
    for c in (pw22, cs22, ric22, rec22):
        check(ro.tick_route(c).path == "composition",
              f"N = 22: {c} is not run")
    T22 = 100
    path("n22_pdip_walk", lambda: variant_loop("n22_pdip_walk", pw22, T22,
                                               0.5, batch=Bg),
         solver_counts(T22, pw22.srbd.solver.warm_iters, cold=False))
    path("n22_cold_stand", lambda: variant_loop("n22_cold_stand", cs22, T22,
                                                0.6, batch=Bg),
         solver_counts(T22, 20, cold=True))
    path("n22_riccati_walk", lambda: variant_loop("n22_riccati_walk", ric22,
                                                  T22, 0.55, batch=4), {})
    path("n22_receding_walk", lambda: variant_loop(
        "n22_receding_walk", rec22, T22, 0.5, batch=Bg), {"cholesky": T22})
    for N in (22, 42):
        check(ro.tick_route(horizon(cfg, N)).path == "kernel",
              f"walking N = {N} is refused")
        path(f"n{N}_walk", lambda: variant_loop(
            f"n{N}_walk", horizon(cfg, N), T22, 0.6, batch=Bg),
            {"walking_tick": T22})

    def n86_refusals():
        said = []
        for c in (horizon(cfg, 86), horizon(kcfg, 86)):
            st = ro.initial_plant_state(c, batch=(2,), device=dev)
            try:
                ro.plant_step(c, st, torch.zeros(2, device=dev))
                said.append("ran")
            except NotImplementedError as exc:
                said.append(str(exc))
        q["n86_refusal_ok"] = all("1 to 85 steps" in m for m in said)

    path("n86_refusals", n86_refusals, {})
    sa22 = n22(with_solver(scfg, method="admm"))
    check(ro.tick_route(n22(scfg)).path == "kernel"
          and ro.tick_route(sa22).path == "composition",
          "standing N = 22 is refused")
    path("n22_stand", lambda: variant_loop("n22_stand", n22(scfg), T22, 0.6,
                                           batch=Bg),
         {"standing_tick": T22})
    path("n22_stand_admm", lambda: variant_loop("n22_stand_admm", sa22, T22,
                                                0.6, batch=Bg),
         {"fused_qp_nu6": T22})
    path("n30_stand", lambda: variant_loop("n30_stand", horizon(scfg, 30),
                                           T22, 0.6, batch=Bg),
         {"standing_tick": T22})

    # ---- 5b. the resident rollout, the live session, the v_des schedule --
    # [resident]: batched_rollout_resident (the state in two buffers, each
    # pair of ticks one CUDA graph replay) against batched_rollout
    # (mpc_every = 1), bit for bit on every field and metric, walking and
    # standing x truth and KF at B = 1 and 4096, with the wall and the
    # device ms a tick of both
    wcfg = ControllerConfig.walking()
    res_ms = {}
    for label, c in (("walk", wcfg), ("walk_kf", kcfg), ("stand", scfg),
                     ("stand_kf", kscfg)):
        Tr = 200 if c.mode == "walk" else 100
        kname = ro.tick_route(c).solve.name
        for Br in (1, 4096):
            s0r = perturbed_states(c, Br, seed=8, device=dev, yaw=0.0)
            it0r = torch.tensor((np.arange(Br) * 600) // Br,
                                dtype=torch.float32, device=dev)
            f_ref, m_ref = ro.batched_rollout(c, s0r, Tr,
                                              start_iteration=it0r)
            got_r = {}

            def resident():
                got_r["out"] = ro.batched_rollout_resident(
                    c, s0r, Tr, start_iteration=it0r)

            path(f"resident_{label}_B{Br}", resident, {kname: Tr})
            f_res, m_res = got_r["out"]
            fields = ["xi", "q", "foot_l", "foot_r", "qp_z", "qp_lam",
                      "ref_anchor", "prev_v", "prev_q"]
            pairs = [(f, getattr(f_res, f), getattr(f_ref, f))
                     for f in fields if getattr(f_ref, f) is not None]
            if c.estimator_mode == "kf":
                pairs += [("kf_x", f_res.kf.x_hat, f_ref.kf.x_hat),
                          ("kf_p", f_res.kf.p_cov, f_ref.kf.p_cov)]
            pairs += [(k, m_res[k], m_ref[k]) for k in m_ref]
            differ = [k for k, a, b in pairs if not torch.equal(a, b)]
            check(set(m_res) == set(m_ref) and not differ,
                  f"resident {label} B = {Br}: not bit for bit {differ}")
            res_ms[f"{label}_B{Br}"] = dict(
                T=Tr, **{f"{n}_{kind}_ms_per_tick": v for n, fn in (
                    ("rollout", lambda: ro.batched_rollout(
                        c, s0r, Tr, start_iteration=it0r)),
                    ("resident", lambda: ro.batched_rollout_resident(
                        c, s0r, Tr, start_iteration=it0r)))
                    for kind, v in zip(("wall", "device"),
                                       wall_and_device_ms(fn, Tr))})
            say("resident", case=f"{label}_B{Br}", bit_equal=not differ,
                card=smi, **res_ms[f"{label}_B{Br}"])
    q["resident_ok"] = True

    # the live session's tests: WirePlant and the scripted link
    sys.path.insert(0, "tests")
    from mpc_limx_control_tpu_torch.control import session as ses
    from test_torch_session_walking import (ScriptedLink, WirePlant,
                                            scripted_sensors)

    # [session_graph]: each tick function's CUDA graph against the same
    # function run eagerly, over 10 scripted ticks (two solves, eight held
    # ticks; walking with the KF every tick, standing with truth
    # odometry): every command and published odometry bit for bit
    for label, c, kf_ in (("walk_kf", wcfg, True), ("stand", scfg, False)):
        sens = scripted_sensors(c, 10, seed=3)
        runs_g = {}
        sessions = {g: ses.ControlSession(c, state_port=19950 + 2 * g,
                                          cmd_port=19951 + 2 * g,
                                          device=dev, cuda_graphs=g)
                    for g in (True, False)}
        for g, sg in sessions.items():
            sg.link.close()
            sg.link = ScriptedLink(sens)

        def graphed(sg=sessions[True]):
            runs_g[True] = sg.run(10, hz=1000.0, use_kf=kf_,
                                  est_odom_every=5)

        path(f"session_graph_{label}", graphed,
             {"walking_session_tick": 2, "walking_session_tick_hold": 8}
             if c.mode == "walk" else {"fused_qp_nu6": 2})
        runs_g[False] = sessions[False].run(10, hz=1000.0, use_kf=kf_,
                                            est_odom_every=5)
        sent = {g: (sg.link.cmds, sg.link.est)
                for g, sg in sessions.items()}
        same = (len(sent[True][0]) == len(sent[False][0]) == 10
                and len(sent[True][1]) == len(sent[False][1])
                == (2 if kf_ else 0)
                and all(np.array_equal(a[k], b[k])
                        for side in (0, 1)
                        for a, b in zip(sent[True][side], sent[False][side])
                        for k in a))
        for sg in sessions.values():
            sg.close()
        say("session_graph", case=label, bit_equal=same,
            graph_tick_p50_ms=1e3 * runs_g[True]["tick_latency_p50"],
            eager_tick_p50_ms=1e3 * runs_g[False]["tick_latency_p50"])
        check(same, f"session graphs differ from the eager functions "
                    f"({label})")
    q["session_graph_ok"] = True

    # [session_kernel]: the walking session's solve and held-force ticks as
    # one kernel each (csrc/session_tick.cu) against the plain tick
    # functions (on the packets of 257 states; the card tests' bands),
    # their graphs' device time a replay before and after, and the batched
    # entry points' ptxas lines (chiprun_out/ptxas_batched.json)
    sk = session_kernel_report(wcfg, dev, info["log"])
    say("session_kernel", card=smi, **sk)
    hg, sg_ = sk["hold_gap"], sk["solve_gap"]
    check(hg["q"] <= 5e-4 and hg["tau"] <= 1e-3 and hg["anchor"] <= 1e-5
          and sg_["q"] <= 5e-4 and sg_["tau"] <= 5e-2 and sg_["grf"] <= 5e-2
          and sg_["anchor"] <= 1e-5
          and max(hg["dq"], hg["kp"], hg["kd"], sg_["dq"], sg_["kp"],
                  sg_["kd"]) == 0.0,
          f"session kernels against the plain tick: {hg}, {sg_}")
    check(sk["hold_kernel_launches_a_replay"] == 1
          and sk["warm_kernel_launches_a_replay"] == 1,
          "a session kernel graph launches more than its kernel")
    # the summary's entries: the widest command gap against the plain
    # function, its graph's device time a replay after (ms) and before
    # (plain_ms); the bound model has no B = 1 session tick
    for kern, kind, gap in ((tfc.WALKING_SESSION_TICK, "warm", sg_),
                            (tfc.WALKING_SESSION_TICK_HOLD, "hold", hg)):
        summary[kern.name].update(
            max_abs_err=max(v for k, v in gap.items() if k != "z_scale"),
            ms=sk[f"{kind}_graph_device_ms_after"],
            plain_ms=sk[f"{kind}_graph_device_ms_before"], bound_ms=None,
            bound_by="not modelled")
    q["session_kernel_ok"] = True

    # [session]: loopback UDP sessions on the card against the WirePlant
    # on the CPU (a thread), with the JAX tests' iteration counts and
    # bands (tests/test_session_walking.py); the walking truth run also
    # within that test's envelope of the port's rollout of the same
    # schedule on the card
    sess = {}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the plant's CPU ticks beside the session

    def live(label, c, iters, truth, kw, port):
        plant = WirePlant(c, port, port + 1, publish_truth_odom=truth)
        try:
            with ses.ControlSession(c, state_port=port, cmd_port=port + 1,
                                    device=dev) as sg:
                if kw.get("use_kf"):
                    x = sg.kf.x_hat
                    x[0:3] = plant.xi[0, 3:6]
                    x[6:9] = plant.foot_l[0]
                    x[9:12] = plant.foot_r[0]
                    sg.kf = sg.kf.replace(x_hat=x)
                kern = ("walking_session_tick" if c.mode == "walk"
                        else "fused_qp_nu6")
                out = {}

                def drive():
                    out["stats"] = sg.run(iterations=iters, hz=1000.0, **kw)

                want = {kern: iters // 5}
                if c.mode == "walk":
                    # the held-force kernel on every tick that holds
                    want["walking_session_tick_hold"] = (
                        iters if kw.get("async_dispatch")
                        else iters - iters // 5)
                path(f"session_{label}", drive, want)
                st = out["stats"]
                est_err = (float(np.linalg.norm(
                    sg.kf.x_hat[0:3].cpu().numpy()
                    - plant.xi[0, 3:6].numpy())) if kw.get("use_kf")
                    else None)
            xi = plant.xi[0].numpy()
            got_est = plant.host.poll_est_odom()
            solves = st["mpc_solves"] + st["solves_dispatched"]
            r = dict(sent=st["sent"], mpc_solves=st["mpc_solves"],
                     solves_dispatched=st["solves_dispatched"],
                     solves_adopted=st["solves_adopted"],
                     est_odom_published=st["est_odom_published"],
                     launches=kernels[kern].launches, solves=solves,
                     plant_steps=plant.steps_taken, height=float(xi[5]),
                     x=float(xi[3]), roll=float(xi[0]), pitch=float(xi[1]),
                     y=float(xi[4]), est_error=est_err,
                     est_cov_finite=bool(got_est is not None and np.isfinite(
                         got_est["cov_diag"]).all()) if est_err else None,
                     **{k: st[k] for k in st if "latency" in k
                        or "staleness" in k or k.endswith("_over_1ms")
                        or k.endswith("_over_5ms")})
            check(r["sent"] == iters and r["launches"] == solves
                  and r["plant_steps"] > 0.9 * iters,
                  f"session {label}: {r}")
            sess[label] = r
            say("session", case=label, card=smi, **r)
            return r
        finally:
            plant.close()

    r = live("walk_truth", wcfg, 1500, True, {}, 19960)
    sim_f, _ = ro.rollout(wcfg, ro.initial_plant_state(wcfg, device=dev),
                          1500, mpc_every=5)
    sim_h, sim_x = float(sim_f.xi[5]), float(sim_f.xi[3])
    q["session_walk_ok"] = bool(
        r["mpc_solves"] == 300 and 0.63 < r["height"] < 0.67
        and abs(r["roll"]) < 0.1 and abs(r["pitch"]) < 0.1 and r["x"] > 0.2
        and abs(r["height"] - sim_h) < 0.03
        and abs(r["x"] - sim_x) < 0.25 * max(1.0, sim_x))
    r = live("walk_kf", wcfg, 1500, False, {"use_kf": True}, 19964)
    q["session_kf_ok"] = bool(
        0.55 < r["height"] < 0.75 and abs(r["roll"]) < 0.2
        and abs(r["pitch"]) < 0.2 and r["x"] > 0.1 and r["est_error"] < 0.1
        and r["est_odom_published"] >= 150 and r["est_cov_finite"])
    r = live("walk_async", wcfg, 1500, True, {"async_dispatch": True}, 19968)
    q["session_async_ok"] = bool(
        r["solves_dispatched"] >= 300 and r["solves_adopted"] >= 1
        and r["grf_staleness_max"] >= r["grf_staleness_p50"] >= 0.0
        and 0.63 < r["height"] < 0.67 and abs(r["roll"]) < 0.1
        and abs(r["pitch"]) < 0.1 and r["x"] > 0.2)
    r = live("stand", scfg, 1000, True, {}, 19972)
    q["session_stand_ok"] = bool(
        r["mpc_solves"] == 200 and 0.63 < r["height"] < 0.67
        and abs(r["x"]) < 0.05 and abs(r["y"]) < 0.05
        and abs(r["roll"]) < 0.05 and abs(r["pitch"]) < 0.05)
    torch.set_num_threads(n_threads)
    say("session_sim_reference", height=sim_h, x=sim_x)

    # [v_des_schedule]: tests/test_velocity_profile.py's ramp / cruise /
    # stop at B = 1, 1800 ticks, one walking_tick a tick
    t_v = np.arange(1800) / 1000.0
    vx_v = np.where(t_v < 0.6, t_v, np.where(t_v < 1.2, 0.6, 0.0))
    sched_v = torch.tensor(np.stack([vx_v, 0 * vx_v, 0 * vx_v], 1),
                           dtype=torch.float32, device=dev)
    got_v = {}

    def v_schedule():
        got_v["out"] = ro.rollout(wcfg, ro.initial_plant_state(
            wcfg, device=dev), 1800, v_des_schedule=sched_v)

    path("v_des_schedule", v_schedule, {"walking_tick": 1800})
    f_v, m_v = got_v["out"]
    h_v, v_v = m_v["height"].cpu().numpy(), m_v["velocity"].cpu().numpy()
    q.update(vdes_height_min=float(h_v.min()),
             vdes_cruise_vx=float(v_v[900:1150, 0].mean()),
             vdes_final_vx=float(v_v[-1, 0]), vdes_vx_1250=float(v_v[1250, 0]))
    q["v_des_schedule_ok"] = bool(
        q["vdes_height_min"] > 0.5 and abs(q["vdes_cruise_vx"] - 0.6) < 0.2
        and q["vdes_final_vx"] < 0.2
        and q["vdes_final_vx"] < 0.5 * q["vdes_vx_1250"]
        and bool(torch.isfinite(f_v.xi).all()))
    say("v_des_schedule", card=smi, **{k: v for k, v in q.items()
                                       if k.startswith("vdes_")})

    # ---- 5c. the scenario mesh, two processes, the entry, the examples --
    # [mesh]: both sharding styles of parallel/mesh.py over a mesh of the
    # one card and of 4 shards on it, truth and KF walking at full width,
    # B = 256, 10 steps: the final state bit for bit the unsharded
    # batched_rollout's (each scenario is its own block of the tick
    # kernel), the statistics within rtol 1e-6 of scenario_stats of its
    # metrics (bit for bit with one shard), one tick launch a shard a step
    from mpc_limx_control_tpu_torch import entry as pentry
    from mpc_limx_control_tpu_torch.parallel import mesh as pmesh
    Bm, Tm = 256, 10
    for label, c in (("walk", wcfg), ("walk_kf", kcfg)):
        kname = ro.tick_route(c).solve.name
        s0m = perturbed_states(c, Bm, seed=11, device=dev, yaw=0.0)
        f_ref, m_ref = ro.batched_rollout(c, s0m, Tm)
        st_ref = pmesh.scenario_stats(m_ref)
        for shards in (1, 4):
            mesh_m = pmesh.make_mesh([dev] * shards)
            for style, make in (("gspmd", pmesh.sharded_rollout),
                                ("shard_map", pmesh.shard_map_rollout)):
                got_m = {}

                def run_mesh():
                    got_m["out"] = make(c, mesh_m, Tm)(s0m, 0.0)

                case = f"{label}_{style}_x{shards}"
                path(f"mesh_{case}", run_mesh, {kname: shards * Tm})
                fin, st = got_m["out"]
                g = fin.gather()
                pairs = [(f, getattr(g, f), getattr(f_ref, f))
                         for f in ("xi", "q", "foot_l", "foot_r", "qp_z",
                                   "qp_lam", "ref_anchor", "prev_v",
                                   "prev_q") if getattr(f_ref, f) is not None]
                if c.estimator_mode == "kf":
                    pairs += [("kf_x", g.kf.x_hat, f_ref.kf.x_hat),
                              ("kf_p", g.kf.p_cov, f_ref.kf.p_cov)]
                differ = [f for f, a, b in pairs if not torch.equal(a, b)]
                rel = {k: float(((st[k] - st_ref[k]).abs()
                                 / st_ref[k].abs().clamp_min(1e-30)).max())
                       for k in st if k != "best_scenario"}
                say("mesh", case=case, B=Bm, steps=Tm, bit_equal=not differ,
                    stats_rel_err=rel, best_scenario_equal=bool(
                        torch.equal(st["best_scenario"],
                                    st_ref["best_scenario"]))
                    if "best_scenario" in st else None)
                # one shard: the reduction is scenario_stats' own
                # arithmetic, so the statistics are bit for bit too
                check(not differ and max(rel.values()) <= 1e-6
                      and (shards > 1 or all(torch.equal(st[k], st_ref[k])
                                             for k in st)),
                      f"mesh {case}: fields {differ} differ, stats {rel}")
    q["mesh_ok"] = True

    # [distributed]: two processes on the one card over gloo, each
    # initialize_multihost + shard_map_rollout on its half of B = 256, 5
    # steps (tools/distributed_rollout_torch.py: a group timeout, a
    # deadline for the ranks): equal statistics on both ranks (atol 0),
    # within 1e-6 of one process, five tick launches a rank
    t_d = time.perf_counter()
    dist_out = "chiprun_out/distributed_torch.json"
    proc = subprocess.run(
        [sys.executable, "tools/distributed_rollout_torch.py",
         "--processes", "2", "--batch", "256", "--steps", "5",
         "--device", "cuda", "--timeout", "120", "--out", dist_out],
        capture_output=True, text=True, timeout=360)
    check(proc.returncode == 0, "distributed rollout failed: "
          + proc.stdout[-2000:] + proc.stderr[-2000:])
    with open(dist_out) as fh:
        dres = json.load(fh)
    say("distributed", processes=2, B=256, steps=5,
        ranks_equal=dres["ranks_equal"],
        max_abs_err_vs_one_process=dres["max_abs_err_vs_one_process"],
        rank_launches=[r["launches"] for r in dres["ranks"]],
        reduce_device=[r["reduce_device"] for r in dres["ranks"]],
        seconds=time.perf_counter() - t_d)
    check(dres["ok"] and all(r["launches"] == {"walking_tick": 5}
                             for r in dres["ranks"]),
          f"distributed: {dres}")
    q["distributed_ok"] = True

    # [entry]: the one-scenario step of entry() and dryrun_multichip(1)
    # (one step of each style, the 5-step sharded rollout against the
    # unsharded one, the KF sharded step)
    def run_entry():
        step_e, args_e = pentry.entry()
        s_e, m_e = step_e(*args_e)
        check(s_e.xi.shape == (13,) and bool(torch.isfinite(s_e.xi).all()),
              "entry step")
        pentry.dryrun_multichip(1)

    path("entry", run_entry, {"walking_tick": 13, "walking_tick_kf": 1})
    q["entry_ok"] = True

    # [examples]: run_walking_torch (B = 64, 300 ticks), run_soak_torch (3
    # windows of 500, killed before its second chunk and resumed) and
    # verify_fused_sharded_torch (B = 256, 10 steps, truth and KF), each
    # through its main
    import importlib.util
    import tempfile

    def script(rel):
        spec = importlib.util.spec_from_file_location(
            rel.replace("/", "_")[:-3], rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    with tempfile.TemporaryDirectory() as tmp_x:
        got_x = {}
        path("example_run_walking", lambda: got_x.update(
            walk=script("examples/run_walking_torch.py").main(
                ["--batch", "64", "--steps", "300", "--out", tmp_x])),
            {"walking_tick": 310})
        soak_mod = script("examples/run_soak_torch.py")
        soak_args = ["--batch", "64", "--windows", "3", "--window", "500",
                     "--checkpoint-every", "2", "--out", tmp_x]
        real_soak = soak_mod.ro.soak_rollout
        chunks = []

        class Killed(Exception):
            pass

        def soak_killed(*a, **kw):
            chunks.append(1)
            if len(chunks) == 2:
                raise Killed("killed between chunks")
            return real_soak(*a, **kw)

        def run_soak_resumed():
            soak_mod.ro.soak_rollout = soak_killed
            try:
                soak_mod.main(soak_args)
            except Killed:
                pass
            finally:
                soak_mod.ro.soak_rollout = real_soak
            got_x["soak"] = soak_mod.main(soak_args + ["--resume"])
            with open(f"{tmp_x}/stats_truth.jsonl") as fh:
                got_x["soak_windows"] = [json.loads(ln)["window"]
                                         for ln in fh]

        path("example_run_soak", run_soak_resumed, {"walking_tick": 1500})
        path("tool_verify_fused_sharded", lambda: got_x.update(
            verify=script("tools/verify_fused_sharded_torch.py").main(
                ["--out", f"{tmp_x}/verify.json"])),
            {"walking_tick": 60, "walking_tick_kf": 60})
    walk_x, soak_x, ver_x = got_x["walk"], got_x["soak"], got_x["verify"]
    say("examples", card=smi, run_walking=walk_x,
        run_soak={k: soak_x[k] for k in ("windows", "height_min",
                                         "nonfinite_ticks")},
        soak_windows=got_x["soak_windows"],
        verify_ok=ver_x["ok"],
        verify_wall_s={e: ver_x[e]["wall_s"] for e in ("truth", "kf")})
    check(walk_x["finite"] and walk_x["height_min"] > 0.6
          and got_x["soak_windows"] == [0, 1, 2]
          and soak_x["nonfinite_ticks"] == 0 and soak_x["height_min"] > 0.6
          and ver_x["ok"], f"examples: {got_x}")
    q["examples_ok"] = True

    # ---- this slice's paths: the band condensation and the Kronecker-cone
    # ADMM, the captured corpora against the f64 oracles, the Lagrangian
    # inverse-dynamics oracle
    Bk = 4096
    ek = band_kron_check(base, Bk, 40, dev)
    kargs, kc, Gu_k, h_k = band_kron_inputs(base, Bk, 40, dev)
    Hk, fk = cnd.condense_lti_diag(kargs[0], kargs[1], kc["q_diag"],
                                   kc["r_diag"], kc["p_diag"], kc["N"],
                                   kargs[3], kargs[2])
    kron = qps.make_admm_warm_kron(Gu_k, kc["iters"], kc["rho"],
                                   kc["alpha"])
    path("band_kron", lambda: kron(Hk, fk, h_k, kargs[4], kargs[5]),
         {"cholesky": 1})
    fused3 = mfc.make_admm_fused(base.srbd)
    kt = dict(
        condense_lti_diag_ms=cuda_time_ms(lambda: cnd.condense_lti_diag(
            kargs[0], kargs[1], kc["q_diag"], kc["r_diag"], kc["p_diag"],
            kc["N"], kargs[3], kargs[2]), 5),
        admm_warm_kron_ms=cuda_time_ms(
            lambda: kron(Hk, fk, h_k, kargs[4], kargs[5]), 5),
        fused_qp_nu3_ms=cuda_time_ms(lambda: fused3(*kargs), 5))
    kt["composition_ms"] = kt["condense_lti_diag_ms"] \
        + kt["admm_warm_kron_ms"]
    say("band_kron", B=Bk, card=smi, **ek, **kt)
    q["band_kron_ok"] = ek["ok"]

    corp = {}

    def capture(names):
        for name in names:
            mode, ticks_, every, skip, kick = CORPORA[name]
            c = ControllerConfig.walking() if mode == "walk" \
                else ControllerConfig.standing()
            corp[name] = corpus.capture_corpus(c, ticks_, every,
                                               skip_first=skip, kick=kick)

    path("corpus_walk", lambda: capture(("walk_steady", "walk_pushed")),
         {"walking_tick": 60 + 80})
    path("corpus_stand", lambda: capture(("stand",)),
         {"standing_tick": 300})
    sets = {"walk": corp["walk_steady"] + corp["walk_pushed"],
            "stand": corp["stand"]}
    batches = {m: corpus_batch(cqs, torch.float32, dev)
               for m, cqs in sets.items()}
    k9_args = {m: pdip_start(*b) for m, b in batches.items()}
    sols = {m: {} for m in sets}

    def corpus_solves(kind):
        for m, b in batches.items():
            sols[m][kind] = (qps.pdip_qp(*b, iters=20).u if kind == "pdip"
                             else qp_cuda.pdip_fused(*k9_args[m],
                                                     iters=20)[0])

    path("corpus_pdip", lambda: corpus_solves("pdip"),
         solver_counts(2, 20, cold=True))
    path("corpus_k9", lambda: corpus_solves("k9"), {"pdip_fused": 2})
    q["corpus_ok"] = True
    for m, cqs in sets.items():
        ec = corpus_report(cqs, {kind: z.cpu().numpy()
                                 for kind, z in sols[m].items()})
        # K9 against its plain version after its 20 steps: a few QPs show
        # the f32 floor of the best merit only over several arithmetic
        # orders
        ec["k9_check"] = pdip_check(k9_args[m], 20,
                                    pdip_floor(k9_args[m], 20, orders=8))
        say("corpus", set=m, card=smi, **ec)
        q["corpus_ok"] = bool(q["corpus_ok"] and ec["ok"]
                              and ec["k9_check"]["ok"])

    def rnea_oracle():
        rng = np.random.default_rng(3)
        worst, t0 = 0.0, time.perf_counter()
        for side in ("left", "right"):
            for _ in range(10):
                q_, dq, ddq = (torch.tensor(a, dtype=torch.float64,
                                            device=dev)
                               for a in (rng.uniform(-1.2, 1.2, 3),
                                         3.0 * rng.normal(size=3),
                                         10.0 * rng.normal(size=3)))
                t_o = solve_rnea_oracle(q_, dq, ddq, side=side)
                t_r = dynamics.rnea(q_, dq, ddq, side=side)
                check(t_o.device == dev and t_o.dtype == torch.float64,
                      f"rnea oracle on {t_o.device}, {t_o.dtype}")
                worst = max(worst, maxerr(t_o, t_r)
                            / (1.0 + float(t_o.abs().max())))
        q["rnea_oracle_err"] = worst
        q["rnea_oracle_ok"] = worst < 1e-12
        say("rnea_oracle", states=20, card=smi, rel_err=worst,
            seconds=time.perf_counter() - t0)

    path("rnea_oracle", rnea_oracle, {})

    q["main_path_s"] = time.perf_counter() - t_main
    say("quality", launches=launches, **q)
    for k in ("walk_ok", "turn_ok", "push_ok", "terrain_ok", "ctrl_tick_ok",
              "kf_ok", "kf_turn_ok", "kf_push_ok", "dtmpc_ok", "kf_dtmpc_ok",
              "soak_kf_ok", "soak_dtmpc_ok", "stand_ok", "kf_stand_ok",
              "stand_dtmpc_ok", "kf_stand_dtmpc_ok", "stand_ctrl_tick_ok",
              "qp_entry_ok", "pdip_warm_walk_ok", "admm_cold_walk_ok",
              "default_stand_ok", "default_walk_ok", "pdip_cold_stand_ok",
              "pdip_cold_walk_ok", "linear_mpc_ok", "posdef_fast_ok",
              "inv_walk_ok", "inv_kf_ok", "inv_ctrl_tick_ok",
              "inv_qp_entry_ok", "pdip_fused_ok", "riccati_walk_ok",
              "riccati_vs_fused_ok", "damped_ls_walk_ok", "log6_walk_ok",
              "receding_walk_ok", "n22_pdip_walk_ok", "n22_cold_stand_ok",
              "n22_riccati_walk_ok", "n22_receding_walk_ok",
              "n22_walk_ok", "n42_walk_ok", "n86_refusal_ok",
              "n22_stand_ok", "n22_stand_admm_ok",
              "n30_stand_ok", "inv_stand_ok", "inv_kf_stand_ok",
              "inv_stand_ctrl_tick_ok", "resident_ok", "session_graph_ok",
              "session_kernel_ok", "session_walk_ok", "session_kf_ok",
              "session_async_ok", "session_stand_ok", "v_des_schedule_ok", "mesh_ok",
              "distributed_ok", "entry_ok", "examples_ok", "band_kron_ok",
              "corpus_ok", "rnea_oracle_ok"):
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
        **prep_bound(4096, N20, it5))

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
            **fused_qp_bound(4096, N20, nu, it5))

    # each tick form: the tick through plant_step against the plain tick,
    # and the kernel alone (repeated launches on fixed buffers; the host
    # enqueues a launch in ~0.01 ms, so this is the device time of any
    # launch longer than that)
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
                    plan.launch,
                    reps[Bt][0])
                # the same launches replayed from a CUDA graph: the device
                # time of a launch shorter than the host's cost of one
                vt[Bt]["kernel_graph_ms"] = graph_time_ms(
                    plan.launch,
                    reps[Bt][0])
            say("timing", kernel=name, card=smi,
                **{f"B{k}": v for k, v in vt.items()})
            summary[name].update(
                ms=vt[4096]["ms"], plain_ms=vt[4096]["plain_ms"],
                kernel_ms=vt[4096]["kernel_ms"],
                kernel_graph_ms=vt[4096]["kernel_graph_ms"],
                **tick_bound(c, 4096, est_kf, hold))

    # ---- 7d. the eight new entry points and the general-solver paths ----
    # the csrc/chol.cu kernels at the walking (n = 60) and standing
    # (n = 120) widths, k = 1: plain version first and last, then the
    # kernel and the one PyTorch call of the same function in turns
    def lib_call(name, M, L, rhs):
        if name == "cholesky":
            return lambda: torch.linalg.cholesky(M)
        if name == "chol_solve":
            return lambda: torch.cholesky_solve(rhs, L)
        return lambda: torch.linalg.solve(M, rhs)

    for name in chol_cuda.KERNELS:
        ct = {}
        for n in (60, 120):
            for Bt in reps:
                _, _, M, rhs = spd_batch(Bt, n, 1, 7, dev)
                L = chol_cuda.cholesky(M)
                fn = getattr(chol_cuda, name)
                kern = (lambda: fn(M)) if name == "cholesky" else (
                    (lambda: fn(L, rhs)) if name == "chol_solve"
                    else (lambda: fn(M, rhs)))
                plain = {"cholesky": lambda: cholp.cholesky_plain(M),
                         "chol_solve": lambda: cholp.chol_solve_plain(L, rhs)
                         }.get(name, lambda: cholp.posdef_solve_plain(M, rhs))
                lib_fn = lib_call(name, M, L, rhs)
                r_k = reps[Bt][0]
                t = turns(kern, plain, Bt)
                lib_runs = [cuda_time_ms(lib_fn, r_k),
                            cuda_time_ms(kern, r_k),
                            cuda_time_ms(lib_fn, r_k)]
                t["graph_ms"] = graph_time_ms(kern, r_k)
                t["ms"] = min(t["ms"], lib_runs[1], t["graph_ms"])
                t["library_ms"] = min(lib_runs[0], lib_runs[2])
                t["runs"] += lib_runs
                t.update(chol_bound(name, Bt, n, 1))
                ct[f"n{n}_B{Bt}"] = t
        say("timing", kernel=name, card=smi, library=CHOL_LIBRARY[name], **ct)
        top = ct["n60_B4096"]
        summary[name].update(
            ms=top["ms"], plain_ms=top["plain_ms"],
            library_ms=top["library_ms"], shape="B=4096 n=60 k=1",
            ms_n120=ct["n120_B4096"]["ms"],
            library_ms_n120=ct["n120_B4096"]["library_ms"],
            plain_ms_n120=ct["n120_B4096"]["plain_ms"],
            bound_ms_n120=ct["n120_B4096"]["bound_ms"],
            **{k: top[k] for k in ("bound_ms", "bound_by", "bound_bytes_ms",
                                   "bound_operations_ms")})

    # each inv form beside its subst form (same inputs) and its twin; the
    # inversion adds n^3 / 3 operations to the core's count, the two
    # triangular mat-vecs cost what the two sweeps cost
    inv_extra = inv_ops(3 * N20)
    pt = {}
    for Bt in reps:
        args = prep_inputs(icfg, Bt, seed=5, device=dev)
        pt[Bt] = turns(
            lambda: mfc.fused_walking_qp_prep(*args, cfg=icfg),
            lambda: mfc.walking_qp_prep_plain(icfg, *args,
                                              solve_form="linv"), Bt)
        pt[Bt]["subst_ms"] = cuda_time_ms(
            lambda: mfc.fused_walking_qp_prep(*args, cfg=cfg), reps[Bt][0])
    say("timing", kernel="walking_mpc_prep_inv", card=smi,
        **{f"B{k}": v for k, v in pt.items()})
    summary["walking_mpc_prep_inv"].update(
        ms=pt[4096]["ms"], plain_ms=pt[4096]["plain_ms"],
        subst_ms=pt[4096]["subst_ms"],
        **prep_bound(4096, N20, it5, inv_extra))
    qi = {}
    for Bt in reps:
        args = qp_inputs(icfg, 3, Bt, seed=8, device=dev)
        k_inv = mfc.make_admm_fused(icfg.srbd)
        k_sub = mfc.make_admm_fused(cfg.srbd)
        twin = mfc.make_admm_fused(icfg.srbd, solve_form="linv")
        qi[Bt] = turns(lambda: k_inv(*args), lambda: twin(*args), Bt)
        qi[Bt]["subst_ms"] = cuda_time_ms(lambda: k_sub(*args), reps[Bt][0])
    say("timing", kernel="fused_qp_nu3_inv", card=smi,
        **{f"B{k}": v for k, v in qi.items()})
    summary["fused_qp_nu3_inv"].update(
        ms=qi[4096]["ms"], plain_ms=qi[4096]["plain_ms"],
        subst_ms=qi[4096]["subst_ms"],
        **fused_qp_bound(4096, N20, 3, it5, inv_extra))
    for est_kf, name in INV_TICKS.items():
        c = kicfg if est_kf else icfg
        c_sub = with_solver(c, solve_form="subst")
        vt = {}
        for Bt in reps:
            st = perturbed_states(c, Bt, seed=3, device=dev)
            it = torch.full((Bt,), 123.0, device=dev)
            vd = torch.tensor(c.desired_velocity, device=dev).expand(
                Bt, 3).contiguous()
            vt[Bt] = turns(
                lambda: ro.plant_step(c, st, it, v_des=vd),
                lambda: ro._plant_step_ref(c, st, it, v_des=vd,
                                           solve_form="linv"), Bt)
            vt[Bt]["subst_ms"] = cuda_time_ms(
                lambda: ro.plant_step(c_sub, st, it, v_des=vd), reps[Bt][0])
            kf_args = {} if st.kf is None else dict(
                kf_x=st.kf.x_hat, kf_p=st.kf.p_cov, prev_v=st.prev_v,
                prev_q=st.prev_q)
            plan = tfc.prepare_tick_launch(
                st.xi, st.q, st.foot_l, st.foot_r, st.qp_z, st.qp_lam,
                st.ref_anchor, it, vd, torch.zeros(Bt, device=dev), cfg=c,
                **kf_args)
            check(plan.kernel.name == name, f"{name}: plan picked "
                  f"{plan.kernel.name}")
            vt[Bt]["kernel_ms"] = cuda_time_ms(
                plan.launch, reps[Bt][0])
        say("timing", kernel=name, card=smi,
            **{f"B{k}": v for k, v in vt.items()})
        tb = add_operations(tick_bound(c, 4096, est_kf, False), 4096,
                            inv_extra)
        summary[name].update(ms=vt[4096]["ms"], plain_ms=vt[4096]["plain_ms"],
                             kernel_ms=vt[4096]["kernel_ms"],
                             subst_ms=vt[4096]["subst_ms"], **tb)

    # the standing inv entries at N = 8 (n = 48), where they form the
    # factor inverse (n^3 / 3 more operations), beside their "linv" twin
    # and their subst forms on the same inputs
    inv48 = inv_ops(6 * 8)
    for est_kf, name in STAND_INV_TICKS.items():
        c = ksicfg if est_kf else sicfg
        c_sub = with_solver(c, solve_form="subst")
        vt = {}
        for Bt in reps:
            st = perturbed_states(c, Bt, seed=3, device=dev)
            it = torch.full((Bt,), 123.0, device=dev)
            vd = torch.tensor(c.desired_velocity, device=dev).expand(
                Bt, 3).contiguous()
            vt[Bt] = turns(
                lambda: ro.plant_step(c, st, it, v_des=vd),
                lambda: ro._plant_step_ref(c, st, it, v_des=vd,
                                           solve_form="linv"), Bt)
            vt[Bt]["subst_ms"] = cuda_time_ms(
                lambda: ro.plant_step(c_sub, st, it, v_des=vd), reps[Bt][0])
            kf_args = {} if st.kf is None else dict(
                kf_x=st.kf.x_hat, kf_p=st.kf.p_cov, prev_v=st.prev_v,
                prev_q=st.prev_q)
            anc = torch.cat([st.xi[:, 3:5], st.xi[:, 2:3]], -1).contiguous()
            plan = tfc.prepare_tick_launch(
                st.xi, st.q, st.foot_l, st.foot_r, st.qp_z, st.qp_lam, anc,
                it, vd, torch.zeros(Bt, device=dev), cfg=c, **kf_args)
            check(plan.kernel.name == name, f"{name}: plan picked "
                  f"{plan.kernel.name}")
            vt[Bt]["kernel_ms"] = graph_time_ms(
                plan.launch, reps[Bt][0])
        say("timing", kernel=name, card=smi, N=8,
            **{f"B{k}": v for k, v in vt.items()})
        tb = add_operations(tick_bound(c, 4096, est_kf, False), 4096, inv48)
        summary[name].update(ms=vt[4096]["ms"], plain_ms=vt[4096]["plain_ms"],
                             kernel_ms=vt[4096]["kernel_ms"],
                             subst_ms=vt[4096]["subst_ms"], shape="N=8", **tb)
    q6t = {}
    for Bt in reps:
        args = qp_inputs(horizon(base, 8), 6, Bt, seed=8, device=dev)
        k_inv = mfc.make_admm_fused(sicfg.srbd, two_feet=True)
        k_sub = mfc.make_admm_fused(horizon(scfg, 8).srbd, two_feet=True)
        twin = mfc.make_admm_fused(sicfg.srbd, two_feet=True,
                                   solve_form="linv")
        q6t[Bt] = turns(lambda: k_inv(*args), lambda: twin(*args), Bt)
        q6t[Bt]["subst_ms"] = cuda_time_ms(lambda: k_sub(*args), reps[Bt][0])
    say("timing", kernel="fused_qp_nu6_inv", card=smi, N=8,
        **{f"B{k}": v for k, v in q6t.items()})
    summary["fused_qp_nu6_inv"].update(
        ms=q6t[4096]["ms"], plain_ms=q6t[4096]["plain_ms"],
        subst_ms=q6t[4096]["subst_ms"], shape="N=8",
        **fused_qp_bound(4096, 8, 6, it5, inv48))

    # the general-solver paths: host clock around a synchronized window
    # of batched_rollout (the composition on the card) after a warm-up
    # window, and steps of the linear MPC
    def tick_ms(c, Bt, n_ticks):
        st = ro.initial_plant_state(c, batch=(Bt,), device=dev)
        st, _ = ro.batched_rollout(c, st, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ro.batched_rollout(c, st, n_ticks, start_iteration=3)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n_ticks

    def lmpc_step_ms(Bt, n_steps):
        params = lmpc.setup(lcfg)
        x = torch.tensor(x0s[:Bt], dtype=torch.float32, device=dev)
        lmpc.batched_closed_loop(lcfg, params, x, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lmpc.batched_closed_loop(lcfg, params, x, n_steps)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n_steps

    general = {}
    for label, c in (("pdip_warm_walk", pw), ("admm_cold_walk", ac),
                     ("default_stand", dataclasses.replace(
                         ControllerConfig(), mode="stand")),
                     ("default_walk", ControllerConfig()),
                     ("riccati_walk", rcfg), ("damped_ls_walk", dls),
                     ("log6_walk", l6), ("receding_walk", rec)):
        general[label] = {f"B{Bt}": tick_ms(c, Bt, 10) for Bt in reps}
    general["linear_mpc_step"] = {f"B{Bt}": lmpc_step_ms(Bt, 10)
                                  for Bt in reps}
    say("general_solver_ms_per_tick", card=smi, **general)

    # ---- 8b. pdip_fused (K9) timing --------------------------------------
    # the walking and standing QPs from their cold start, 20 Newton steps:
    # the kernel against its plain version in turns (CUDA events), and the
    # same solve by ops.qp's PDIP on the K8 kernels (host clock around a
    # synchronized call: it is host-bound at small B, PERF.md §5)
    pdip_reps = {1: (10, 2), 1024: (3, 1), 4096: (2, 1)}
    pt9 = {}
    for label, n, m in (("walk", 60, 120), ("stand", 120, 240)):
        for Bt, (r_k, r_p) in pdip_reps.items():
            args = pdip_inputs(n, Bt, 5)
            Hb, fb, Gb, hb = args[:4]

            def kern():
                return qp_cuda.pdip_fused(*args, iters=20)

            def plain():
                return qp_cuda.pdip_fused_plain(*args, iters=20)

            runs = [cuda_time_ms(plain, r_p), cuda_time_ms(kern, r_k),
                    cuda_time_ms(kern, r_k), cuda_time_ms(plain, r_p)]
            walls = []
            for _ in range(r_p + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                qps._batched_pdip(Hb, fb, Gb, hb, 20)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            pt9[f"{label}_B{Bt}"] = dict(
                ms=min(runs[1:3]), plain_ms=min(runs[0], runs[3]),
                batched_pdip_wall_ms=min(walls[1:]), runs=runs,
                batched_pdip_runs=walls, **pdip_bound(Bt, n, m, 20))
    say("timing", kernel="pdip_fused", card=smi, iters=20, **pt9)
    top, st9 = pt9["walk_B4096"], pt9["stand_B4096"]
    summary["pdip_fused"].update(
        ms=top["ms"], plain_ms=top["plain_ms"], library_ms=None,
        batched_pdip_wall_ms=top["batched_pdip_wall_ms"],
        shape="B=4096 n=60 m=120 iters=20", ms_n120=st9["ms"],
        plain_ms_n120=st9["plain_ms"], bound_ms_n120=st9["bound_ms"],
        batched_pdip_wall_ms_n120=st9["batched_pdip_wall_ms"],
        **{k: top[k] for k in ("bound_ms", "bound_by", "bound_bytes_ms",
                               "bound_operations_ms")})

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

    # ---- the bound model (utils/roofline.py): every bound this run
    # printed equals what chip_smoke printed before the model moved
    model = roofline.kernel_bounds(4096)
    printed = {}
    for k in kernels:
        if summary[k]["bound_ms"] is None:
            continue            # the session's B = 1 ticks: not modelled
        if k in chol_cuda.KERNELS or k == "pdip_fused":
            printed[f"{k}_n60"] = summary[k]["bound_ms"]
            printed[f"{k}_n120"] = summary[k]["bound_ms_n120"]
        else:
            printed[k] = summary[k]["bound_ms"]
    differ = {k: (printed.get(k), model[k]["bound_ms"], v)
              for k, v in BOUNDS_BEFORE_MOVE.items()
              if not printed.get(k) == model[k]["bound_ms"] == v}
    say("roofline", B=4096, card=smi, peaks=roofline.PEAKS,
        walking_tick=roofline.fused_tick_flops(),
        walking_tick_bytes=roofline.fused_tick_hbm_bytes(),
        standing_tick=roofline.fused_tick_flops(nu=6, mu_=12),
        standing_tick_bytes=roofline.fused_tick_hbm_bytes(nu=6, mu_=12),
        bounds_ms=printed, differ=differ)
    check(not differ and set(printed) == set(BOUNDS_BEFORE_MOVE),
          f"bounds moved: {differ}")

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
