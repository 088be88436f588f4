"""Time the kernels built on the MPC core (csrc/mpc_core.cuh) and the
held-force tick kernels of a checkout, split a block's time into its
stages, and compare two checkouts' outputs exactly.

Run on a machine with a CUDA card:

    python3 tools/time_mpc_kernels.py [--root CHECKOUT] [--dump DIR]
                                      [--horizon N] [--entries E ...]
    python3 tools/time_mpc_kernels.py --stages [--horizon N]
    python3 tools/time_mpc_kernels.py --compare DIR_A DIR_B

``--root`` is the checkout whose ``mpc_limx_control_tpu_torch`` is
imported (default: the one holding this script); its kernels are built
there at first use. Prints one JSON line: the card's name and power limit
and, per entry point on the core (the walking ``walking_tick``,
``walking_tick_kf``, ``walking_mpc_prep``, ``fused_qp_nu3`` and their four
``_inv`` forms; the standing ``standing_tick``, ``standing_tick_kf``,
``fused_qp_nu6`` and their three ``_inv`` forms) at horizon N
(``--horizon``, default 20) and per held-force tick (``walking_tick_hold``,
``walking_tick_kf_hold``, ``standing_tick_hold``,
``standing_tick_kf_hold``: no MPC, the horizon only sizes the warm state
they pass through) at B = 1, 257 and 4096, the device time per launch over
launches replayed from a CUDA graph on fixed numpy-seeded inputs, its
dynamic shared memory and, where the library exports them, the blocks an
SM holds; for the held-force ticks also the time of a call of
``rollout.plant_step`` on the same inputs in a loop (through the wrapper:
host-bound); an entry the checkout refuses at that horizon is reported with
its reason. Two checkouts are compared by running this once per
checkout, in turns, inside one call on one card.

``--dump DIR`` also saves every output of those launches to
``DIR/outputs.npz`` (~26 MB: keep DIR out of the files a call brings
back); ``--compare`` (no card needed) reads two such files and prints, per
output, whether they are equal bit for bit and their largest absolute
difference (tools/time_chol_kernels.py's comparison and graph timing).

``--stages`` builds a second library with ``MPC_STAGE_CLOCKS`` defined
(the kernels then record clock64() at their stage boundaries; the normal
build never defines it), launches each entry point from it and prints,
per entry and batch, the mean cycles a block spends in each stage, from
thread 0's stamps: for the entries on the core, prologue (tick prologue,
loads; with the filter, ``filter`` of it), gram (linearization and
Gramians), emit (warp 0's band emission rows), fsweep (warp 0's f
sweeps), band (the emission of every warp and the f sweeps, barrier to
barrier), chol (factorization), admm (the ADMM and its outputs), epilogue
(outputs, plant step), total; for the held-force ticks, the filter's
sensors (inputs loaded, sensors synthesized), predict (P_pred, C P, S),
factor, solves and posterior (with the symmetrization) in the KF forms,
then the hold tick's prologue (gait clock to swing IK; with the truth,
the angles' sines and cosines too) and epilogue (held force, plant step,
next-tick kinematics), total. A block of a hold form holds eight
scenarios, two a warp, a half warp each (truth and KF alike), and thread
0's stamps are lane 0's of its first scenario. A checkout whose hold
blocks are shaped otherwise is split by its own copy of this script
(``python3 CHECKOUT/tools/time_mpc_kernels.py --stages``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from time_chol_kernels import compare, cuda_ms

# batch -> graph-replayed launches (257: a batch that leaves the hold
# forms' last warp half full)
BATCHES = {1: 200, 257: 50, 4096: 20}
ENTRIES = ("walking_tick", "walking_tick_kf", "walking_tick_inv",
           "walking_tick_kf_inv", "walking_mpc_prep", "walking_mpc_prep_inv",
           "fused_qp_nu3", "fused_qp_nu3_inv", "standing_tick",
           "standing_tick_kf", "fused_qp_nu6", "standing_tick_inv",
           "standing_tick_kf_inv", "fused_qp_nu6_inv", "walking_tick_hold",
           "walking_tick_kf_hold", "standing_tick_hold",
           "standing_tick_kf_hold")
# scenarios a block of the held-force forms (csrc/tick_common.cuh
# HOLD_PER_BLOCK)
HOLD_PER_BLOCK = 8
TICK_FIELDS = ("xi", "q", "foot_l", "foot_r", "z", "y", "anchor",
               "residual", "grf", "target", "kf_x", "kf_p")
STAGE_READER = {"standing_tick": "standing_tick_stage_clocks",
                "standing_tick_kf": "standing_tick_stage_clocks",
                "fused_qp_nu6": "fused_qp_stage_clocks",
                "fused_qp_nu3": "fused_qp_stage_clocks",
                "walking_tick": "walking_tick_stage_clocks",
                "walking_tick_kf": "walking_tick_stage_clocks",
                "walking_mpc_prep": "walking_mpc_prep_stage_clocks"}
STAGE_READER.update({f"{e}_inv": STAGE_READER[e] for e in (
    "walking_tick", "walking_tick_kf", "walking_mpc_prep", "fused_qp_nu3",
    "standing_tick", "standing_tick_kf", "fused_qp_nu6")})
STAGE_READER.update({f"{e}_hold": STAGE_READER[e] for e in (
    "walking_tick", "walking_tick_kf", "standing_tick", "standing_tick_kf")})
# the filter's and the hold tick's stage slots (csrc/tick_common.cuh
# KfStage; the core's are 0-8)
KS_SENSE, KS_PRED, KS_FACTOR, KS_SOLVE, KS_POST, KS_HOLD_PRE = range(9, 15)


def _t(a, dev):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)


def tick_call(cfg, B: int, seed: int, dev, hold: bool = False):
    """A launch of the config's solving tick kernel (with `hold`, its
    held-force kernel, holding a seeded force pair) on kicked initial
    states (vx, vy; yaw too for the walking truth form), a seeded warm QP
    state and staggered tick counters (both swing sides); returns
    (launch function, output names, outputs)."""
    from mpc_limx_control_tpu_torch.control import rollout as ro
    from mpc_limx_control_tpu_torch.ops import tick_fused_cuda as tfc

    kf = cfg.estimator_mode == "kf"
    n = (6 if cfg.mode == "stand" else 3) * cfg.srbd.horizon
    s = ro.initial_plant_state(cfg, batch=(B,), device=dev)
    rng = np.random.default_rng(seed)
    xi = s.xi.clone()
    xi[:, 9] += _t(0.08 * rng.standard_normal(B), dev)
    xi[:, 10] += _t(0.05 * rng.standard_normal(B), dev)
    if cfg.mode == "walk" and not kf:
        xi[:, 2] += _t(0.1 * rng.standard_normal(B), dev)
    z = _t(5.0 * rng.standard_normal((B, n)), dev)
    y = _t(np.abs(rng.standard_normal((B, 2 * n))), dev)
    it = _t(np.resize([0.0, 40.0, 180.0, 299.0, 300.0, 455.0], B), dev)
    vd = _t(np.tile(cfg.desired_velocity, (B, 1)), dev)
    anc = torch.cat([xi[:, 3:5], xi[:, 2:3]], -1).contiguous()
    kf_args = dict(kf_x=s.kf.x_hat, kf_p=s.kf.p_cov, prev_v=s.prev_v,
                   prev_q=s.prev_q) if kf else {}
    held = None
    if hold:
        held = _t(np.array([0.0, 0.0, 0.0, 2.0, -1.0, 180.0])
                  + rng.standard_normal((B, 6)), dev)
    inputs = (xi.contiguous(), s.q, s.foot_l, s.foot_r, z, y, anc, it, vd,
              torch.zeros(B, device=dev))
    plan = tfc.prepare_tick_launch(*inputs, cfg=cfg, grf_held=held,
                                   **kf_args)

    def launch():
        # the plan carries raw pointers: `inputs` (and `s`, which holds the
        # filter state) stay referenced here for as long as it is launched,
        # whatever the checkout's plan keeps
        plan.launch()
        return inputs, s, held

    fields = TICK_FIELDS[:len(plan.results)]
    if hold:   # z and y pass through: the outputs are the rest
        keep = [i for i, f in enumerate(fields) if f not in ("z", "y")]
        state = s.replace(
            xi=inputs[0], qp_z=z, qp_lam=y,
            ref_anchor=None if s.ref_anchor is None else anc)

        def wrapper():
            # the same tick through rollout.plant_step, as a loop calls it
            return ro.plant_step(cfg, state, it, grf_override=held, v_des=vd)

        launch.wrapper = wrapper
        return (launch, tuple(fields[i] for i in keep),
                tuple(plan.results[i] for i in keep))
    return launch, fields, plan.results


def prep_call(cfg, B: int, seed: int, dev):
    """walking_mpc_prep on the recipe of tests/test_mpc_fused.py:156-175
    (perturbed pose, arms under the hips, warm state)."""
    from mpc_limx_control_tpu_torch.models import srbd
    from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as mfc

    N = cfg.srbd.horizon
    rng = np.random.default_rng(seed)
    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    yaw = 0.1 * rng.standard_normal(B)
    arms = (pos[:, None, :] + np.array([0.02, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, N, 3)))
    ori = np.concatenate([0.01 * rng.standard_normal((B, 2)), yaw[:, None]],
                         -1)
    x0 = srbd.initial_state(_t(ori, dev), _t(pos, dev),
                            _t(np.zeros((B, 3)), dev),
                            _t(np.tile([0.4, 0.0, 0.0], (B, 1)), dev))
    args = (_t(arms, dev), x0.contiguous(),
            _t(np.tile([0.5, 0.0, 0.0], (B, 1)), dev),
            _t(0.05 * rng.standard_normal(B), dev),
            _t(5.0 * rng.standard_normal((B, 3 * N)), dev),
            _t(np.abs(rng.standard_normal((B, 6 * N))), dev),
            torch.cat([x0[:, 3:5], x0[:, 2:3]], -1).contiguous())
    out = {}

    def launch():
        out["v"] = mfc.fused_walking_qp_prep(*args, cfg=cfg)

    launch()
    return launch, ("z", "y", "residual", "xi_pred"), out


def qp_call(cfg, nu: int, B: int, seed: int, dev):
    """fused_qp_nu3 / _nu6 through make_admm_fused on the SRBD matrices of
    perturbed poses with a dense perturbation on Ad, a walking reference and
    a warm state (chip_smoke.py's recipe)."""
    from mpc_limx_control_tpu_torch.models import srbd
    from mpc_limx_control_tpu_torch.ops import mpc_fused_cuda as mfc

    N = cfg.srbd.horizon
    rng = np.random.default_rng(seed)
    feet = nu // 3
    pos = np.array([0.0, 0.0, 0.65]) + 0.02 * rng.standard_normal((B, 3))
    ori = np.concatenate([0.01 * rng.standard_normal((B, 2)),
                          0.1 * rng.standard_normal((B, 1))], -1)
    x0 = srbd.initial_state(_t(ori, dev), _t(pos, dev),
                            _t(np.zeros((B, 3)), dev),
                            _t(0.1 * rng.standard_normal((B, 3)), dev))
    arms = (pos[:, None, None, :] + np.array([0.0, 0.1, -0.65])
            + 0.03 * rng.standard_normal((B, N, feet, 3)))
    if feet == 2:
        arms[:, :, 1, 1] -= 0.2
    Ac, Bc = srbd.linearize_shared(cfg.robot, _t(arms.reshape(B, -1, 3), dev),
                                   x0[:, 3:6], x0[:, 2])
    Ad, Bd = srbd.discretize_srbd(Ac, Bc, cfg.srbd.ts)
    Bd_t = Bd.reshape(B, N, feet, 13, 3).permute(0, 1, 3, 2, 4).reshape(
        B, N, 13, nu)
    Ad = Ad + _t(2e-3 * rng.standard_normal((B, 13, 13)), dev)
    x_ref = srbd.walking_reference(
        x0, cfg.srbd, N, _t(np.tile([0.3, 0.0, 0.0], (B, 1)), dev),
        _t(0.05 * rng.standard_normal(B), dev), height_des=0.65)
    args = [a.contiguous() for a in (
        Ad, Bd_t, x_ref, x0, _t(5.0 * rng.standard_normal((B, N * nu)), dev),
        _t(np.abs(rng.standard_normal((B, 2 * N * nu))), dev))]
    solve = mfc.make_admm_fused(cfg.srbd, two_feet=nu == 6)
    out = {}

    def launch():
        sol, (z, y) = solve(*args)
        out["v"] = (z, y, sol.residual)

    launch()
    return launch, ("z", "y", "residual"), out


def entry_call(name: str, B: int, dev, N: int):
    """(launch, output names, outputs) of entry `name` at horizon N on the
    walking (or standing) tuning; an ``_inv`` entry through its config's
    solve_form="inv"."""
    from mpc_limx_control_tpu_torch.core.config import ControllerConfig

    def horizon(c):
        solver = dataclasses.replace(
            c.srbd.solver, solve_form="inv" if inv else "subst")
        return dataclasses.replace(c, srbd=dataclasses.replace(
            c.srbd, horizon=N, solver=solver))

    inv = name.endswith("_inv")
    hold = name.endswith("_hold")
    name = name[:-len("_inv")] if inv else name
    name = name[:-len("_hold")] if hold else name
    walk = horizon(ControllerConfig.walking())
    stand = horizon(ControllerConfig.standing())
    kf = name.endswith("_kf")
    if name.startswith(("standing_tick", "walking_tick")):
        cfg = stand if name.startswith("standing") else walk
        if kf:
            cfg = dataclasses.replace(cfg, estimator_mode="kf")
        launch, fields, outs = tick_call(cfg, B, 31 + kf + 2 * hold, dev,
                                         hold=hold)
        return launch, fields, lambda: outs
    if name == "walking_mpc_prep":
        launch, fields, out = prep_call(walk, B, 33, dev)
    else:
        nu = int(name[-1])
        launch, fields, out = qp_call(walk, nu, B, 34 + nu, dev)
    return launch, fields, lambda: out["v"]


def wall_ms(fn, reps: int) -> float:
    """Time of one call in a loop of `reps` calls, by CUDA events around
    the loop (host-bound for a call that enqueues less work than its host
    cost)."""
    for _ in range(3):
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


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def _import(root: str):
    sys.path.insert(0, str(Path(root).resolve()))
    from mpc_limx_control_tpu_torch.ops import _build

    return _build


def library_sizes(lib, name: str, N: int) -> dict:
    """What the library says of entry `name` at horizon N: its dynamic
    shared memory and the blocks an SM holds, where it exports them."""
    row = {}
    for key in ("smem_bytes", "blocks_per_sm"):
        fn = getattr(lib, f"{name}_{key}", None)
        if fn is not None:   # the hold forms' sizer takes no horizon
            row[key] = fn() if name.endswith("_hold") else fn(N)
    return row


def refusal(name: str, dev, N: int) -> str | None:
    """Why the checkout refuses entry `name` at horizon N (None: it runs)."""
    try:
        entry_call(name, 1, dev, N)
    except (ValueError, NotImplementedError) as exc:
        return str(exc)
    return None


def measure(root: str, dump: str | None, N: int, entries) -> dict:
    _build = _import(root)
    dev = torch.device("cuda", 0)
    info = _build.build_library()
    lib = info["lib"]
    out = {"root": root, "card": card(), "N": N,
           "library": str(info["path"])}
    saved = {}
    for name in entries:
        row = library_sizes(lib, name, N)
        reason = refusal(name, dev, N)
        if reason is not None:
            out[name] = dict(row, refused=reason)
            continue
        for B, reps in BATCHES.items():
            launch, fields, results = entry_call(name, B, dev, N)
            row[f"B{B}_ms"] = cuda_ms(launch, reps)
            if hasattr(launch, "wrapper"):
                row[f"B{B}_wrapper_ms"] = wall_ms(launch.wrapper, reps)
            launch()
            torch.cuda.synchronize()
            for field, t in zip(fields, results()):
                saved[f"{name}_B{B}_{field}"] = t.cpu().numpy()
        out[name] = row
    if dump is not None:
        Path(dump).mkdir(parents=True, exist_ok=True)
        np.savez(Path(dump) / "outputs.npz", **saved)
    return out


def stages(root: str, N: int, entries) -> dict:
    """Per entry and batch, the mean cycles a block spends in each stage,
    from the MPC_STAGE_CLOCKS build (see the module docstring)."""
    import ctypes

    _build = _import(root)
    dev = torch.device("cuda", 0)
    info = _build.build_library(("MPC_STAGE_CLOCKS",))
    stamped = info["lib"]
    # every Kernel launches from the stamped library while this runs
    _build.build_library = lambda defines=(): info
    slots, max_b = 16, 4096
    clocks = np.zeros((max_b, slots), np.int64)
    out = {"root": root, "card": card(), "N": N, "library": info["path"]}
    for name in entries:
        read = getattr(stamped, STAGE_READER[name])
        read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
        reason = refusal(name, dev, N)
        if reason is not None:
            out[name] = {"refused": reason}
            continue
        hold = name.endswith("_hold")
        kf = "_kf" in name
        for B in BATCHES:
            launch, _, _ = entry_call(name, B, dev, N)
            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            rc = read(clocks.ctypes.data)
            if rc != 0:
                raise RuntimeError(f"{STAGE_READER[name]}: CUDA error {rc}")
            per_block = HOLD_PER_BLOCK if hold else 1
            c = clocks[:-(-B // per_block)].astype(np.float64)
            if hold:
                span = {}
                if kf:
                    # slots: start, the filter's stages, hold prologue, end
                    span.update(zip(
                        ("sensors", "predict", "factor", "solves",
                         "posterior"),
                        np.diff(c[:, [0, KS_SENSE, KS_PRED, KS_FACTOR,
                                      KS_SOLVE, KS_POST]], axis=1).T))
                pre0 = c[:, KS_POST] if kf else c[:, 0]
                span.update(prologue=c[:, KS_HOLD_PRE] - pre0,
                            epilogue=c[:, 8] - c[:, KS_HOLD_PRE],
                            total=c[:, 8] - c[:, 0])
            else:
                # slots: start, inputs staged, Gramians, warp 0's emission,
                # its f sweeps, the barrier after them, factor, ADMM, end
                step = np.diff(c[:, :9], axis=1)
                span = dict(zip(("prologue", "gram", "emit", "fsweep"),
                                step[:, :4].T))
                span.update(band=c[:, 5] - c[:, 2], chol=step[:, 5],
                            admm=step[:, 6], epilogue=step[:, 7],
                            total=c[:, 8] - c[:, 0])
                if kf and name.startswith(("walking_tick", "standing_tick")):
                    span["filter"] = c[:, KS_POST] - c[:, 0]
            out[f"{name}_B{B}"] = {k: float(v.mean()) for k, v in span.items()}
    out["clocks_sm_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--dump", default=None,
                    help="directory to save every output to (outputs.npz)")
    ap.add_argument("--stages", action="store_true",
                    help="split each block's time into the core's stages")
    ap.add_argument("--compare", nargs=2, metavar=("DIR_A", "DIR_B"),
                    help="compare two --dump directories and exit")
    ap.add_argument("--horizon", type=int, default=20,
                    help="MPC horizon N of every entry (default 20)")
    ap.add_argument("--entries", nargs="+", choices=ENTRIES,
                    default=list(ENTRIES), help="entries to run")
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("time_mpc_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.stages:
        result = stages(args.root, args.horizon, args.entries)
    else:
        result = measure(args.root, args.dump, args.horizon, args.entries)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
