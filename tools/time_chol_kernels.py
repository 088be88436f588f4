"""Time the batched Cholesky / SPD-solve kernels and the fused PDIP of a
checkout, split the fused PDIP's blocks into stages, and compare two
checkouts' outputs exactly.

Run on a machine with a CUDA card:

    python3 tools/time_chol_kernels.py [--root CHECKOUT] [--dump DIR]
    python3 tools/time_chol_kernels.py --stages [--root CHECKOUT]
    python3 tools/time_chol_kernels.py --compare DIR_A DIR_B

``--root`` is the checkout whose ``mpc_limx_control_tpu_torch`` is
imported (default: the one holding this script); its kernels are built
there at first use. Prints one JSON line: the card's name and power limit
and, per kernel, matrix order n (30, 60, 120; one right-hand side) and batch
B (1, 1024, 4096), the device time per launch over 50 launches replayed
from a CUDA graph on fixed seeded SPD inputs; the time of ``pdip_fused``
(20 Newton steps, 3 launches) on seeded QPs of n / m = 60 / 120 and
120 / 240 at the same batches; and beside it the wall time of
``ops.qp._batched_pdip`` (the same 20 steps on the K8 kernels, host clock
around a synchronized call; it is host-bound at small B) on the same QPs.
Two checkouts are compared by running this once per checkout, in turns,
inside one call on one card.

``--dump DIR`` also saves every output of those launches to
``DIR/outputs.npz`` (~0.5 GB: keep DIR out of the files a call brings
back); ``--compare`` (no card needed) reads two such files and prints, per
output, whether they are equal bit for bit and their largest absolute
difference (NaN against NaN counts as equal).

``--stages`` builds a second library with ``MPC_STAGE_CLOCKS`` defined
(``pdip_fused`` then sums thread 0's clock64() time of each stage over the
Newton steps; the normal build never defines it), launches ``pdip_fused``
from it at both QP shapes and B = 1 and 4096, and prints per shape and
batch the mean cycles a block spends in each stage over the 20 steps:
load (inputs and the first merit), prep (the step's right-hand sides rp,
d, rc), form (M = H + G' diag(d) G + reg I), factor, affine (the affine
direction, its step and sigma), corrector (the corrector direction), step
(the damped update), merit (the residuals, merit and pick), end (the
outputs) and total; ``per_step`` divides the six per-step stages by 20.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCHES, REPS, PDIP_REPS, PDIP_ITERS = (1, 1024, 4096), 50, 3, 20
ORDERS = (30, 60, 120)
PDIP_SHAPES = ((60, 120), (120, 240))
STAGE_BATCHES = (1, 4096)
STAGES = ("load", "prep", "form", "factor", "affine", "corrector", "step",
          "merit", "end", "total")     # csrc/pdip_fused.cu PdipStage
PER_STEP = ("prep", "form", "factor", "affine", "corrector", "step",
            "merit")
STAGE_SLOTS, STAGE_MAX_B = 16, 4096


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Device time of one call: `reps` calls captured in a CUDA graph and
    the replay timed by CUDA events, so that the host's launch cost (which
    passes a short kernel's time at n = 30) is not measured."""
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


def wall_ms(fn, reps: int) -> float:
    """Least host time of a synchronized call over `reps` calls after one
    warm-up call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def spd(B: int, n: int, dev):
    rng = np.random.default_rng(7)
    A = rng.standard_normal((B, n, n))
    M = torch.tensor(A @ A.transpose(0, 2, 1) / n + 3.0 * np.eye(n),
                     dtype=torch.float32, device=dev)
    rhs = torch.tensor(rng.standard_normal((B, n, 1)),
                       dtype=torch.float32, device=dev)
    return M, rhs


def qp(B: int, n: int, m: int, dev):
    """H = A A' / n + 3 I, f and G normal, h = |normal| + 1 (the recipe of
    tests/test_qp_pallas.py:46-58), from z0 = 0, s0 = lam0 = 1."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((B, n, n))
    H = A @ A.transpose(0, 2, 1) / n + 3.0 * np.eye(n)
    arrs = (H, rng.standard_normal((B, n)),
            rng.standard_normal((B, m, n)),
            np.abs(rng.standard_normal((B, m))) + 1.0,
            np.zeros((B, n)), np.ones((B, m)), np.ones((B, m)))
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]


def _import(root: str):
    sys.path.insert(0, str(Path(root).resolve()))
    from mpc_limx_control_tpu_torch.ops import _build, chol_cuda, qp, qp_cuda

    return _build, chol_cuda, qp, qp_cuda


def measure(root: str, dump: str | None) -> dict:
    _build, chol_cuda, qps, qp_cuda = _import(root)
    dev = torch.device("cuda", 0)
    out = {"root": root, "card": card(),
           "library": str(_build.build_library()["path"])}
    saved = {}
    for B in BATCHES:
        for n in ORDERS:
            M, rhs = spd(B, n, dev)
            L = chol_cuda.cholesky(M)
            calls = {"cholesky": lambda: chol_cuda.cholesky(M),
                     "chol_solve": lambda: chol_cuda.chol_solve(L, rhs),
                     "posdef_solve": lambda: chol_cuda.posdef_solve(M, rhs),
                     "posdef_solve_fast":
                         lambda: chol_cuda.posdef_solve_fast(M, rhs)}
            for name, fn in calls.items():
                out[f"{name}_n{n}_B{B}_ms"] = cuda_ms(fn, REPS)
                saved[f"{name}_n{n}_B{B}"] = fn().cpu().numpy()
        for n, m in PDIP_SHAPES:
            args = qp(B, n, m, dev)

            def k9():
                return qp_cuda.pdip_fused(*args, iters=PDIP_ITERS)

            key = f"pdip_fused_n{n}_m{m}_B{B}"
            out[f"{key}_ms"] = cuda_ms(k9, PDIP_REPS)
            out[f"batched_pdip_n{n}_m{m}_B{B}_wall_ms"] = wall_ms(
                lambda: qps._batched_pdip(*args[:4], PDIP_ITERS),
                3 if B > 1 else 5)
            for field, t in zip(("z_best", "merit", "z_final", "lam_final"),
                                k9()):
                saved[f"{key}_{field}"] = t.cpu().numpy()
    if dump is not None:
        Path(dump).mkdir(parents=True, exist_ok=True)
        np.savez(Path(dump) / "outputs.npz", **saved)
    return out


def stages(root: str) -> dict:
    """Per QP shape and batch, the mean cycles a pdip_fused block spends in
    each stage over the Newton steps, from the MPC_STAGE_CLOCKS build (see
    the module docstring)."""
    _build, _, _, qp_cuda = _import(root)
    dev = torch.device("cuda", 0)
    info = _build.build_library(("MPC_STAGE_CLOCKS",))
    # the kernel launches from the stamped library while this runs
    _build.build_library = lambda defines=(): info
    read = info["lib"].pdip_fused_stage_clocks
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    clocks = np.zeros((STAGE_MAX_B, STAGE_SLOTS), np.int64)
    out = {"root": root, "card": card(), "library": info["path"],
           "iters": PDIP_ITERS}
    for n, m in PDIP_SHAPES:
        for B in STAGE_BATCHES:
            args = qp(B, n, m, dev)
            for _ in range(2):
                qp_cuda.pdip_fused(*args, iters=PDIP_ITERS)
            torch.cuda.synchronize()
            rc = read(clocks.ctypes.data)
            if rc != 0:
                raise RuntimeError(f"pdip_fused_stage_clocks: CUDA error {rc}")
            c = clocks[:min(B, STAGE_MAX_B), :len(STAGES)].astype(np.float64)
            span = dict(zip(STAGES, c.mean(0)))
            span["per_step"] = {k: span[k] / PDIP_ITERS for k in PER_STEP}
            out[f"pdip_fused_n{n}_m{m}_B{B}"] = span
    out["clocks_sm_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out


def compare(a: str, b: str) -> dict:
    fa = np.load(Path(a) / "outputs.npz")
    fb = np.load(Path(b) / "outputs.npz")
    res = {}
    for key in sorted(set(fa.files) & set(fb.files)):
        x, y = fa[key], fb[key]
        both_nan = np.isnan(x) & np.isnan(y)
        diff = np.where(both_nan, 0.0, np.abs(x.astype(np.float64) - y))
        res[key] = {"bit_equal": bool(np.array_equal(x.view(np.uint32),
                                                     y.view(np.uint32))),
                    "max_abs_diff": float(np.nanmax(diff)),
                    "scale": float(np.max(np.abs(y), initial=0.0,
                                          where=np.isfinite(y)))}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--dump", default=None,
                    help="directory to save every output to (outputs.npz)")
    ap.add_argument("--stages", action="store_true",
                    help="split pdip_fused's blocks into stages")
    ap.add_argument("--compare", nargs=2, metavar=("DIR_A", "DIR_B"),
                    help="compare two --dump directories and exit")
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("time_chol_kernels: no CUDA device", file=sys.stderr)
        return 1
    result = stages(args.root) if args.stages else measure(args.root,
                                                           args.dump)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
