"""Time the batched Cholesky / SPD-solve kernels and the fused PDIP of a
checkout, and compare two checkouts' outputs exactly.

Run on a machine with a CUDA card:

    python3 tools/time_chol_kernels.py [--root CHECKOUT] [--dump DIR]
    python3 tools/time_chol_kernels.py --compare DIR_A DIR_B

``--root`` is the checkout whose ``mpc_limx_control_tpu_torch`` is
imported (default: the one holding this script); its kernels are built
there at first use. Prints one JSON line: the card's name and power limit
and, per kernel and matrix order n (30, 60, 120; one right-hand side), the
device time per launch over 50 launches replayed from a CUDA graph on
B = 4096 fixed seeded SPD inputs, and the time of ``pdip_fused`` (20 Newton
steps, 3 launches) on seeded QPs of n / m = 60 / 120 and 120 / 240. Two
checkouts are compared by running this once per checkout, in turns, inside
one call on one card.

``--dump DIR`` also saves every output of those launches to
``DIR/outputs.npz`` (~0.4 GB: keep DIR out of the files a call brings
back); ``--compare`` (no card needed) reads two such files and prints, per
output, whether they are equal bit for bit and their largest absolute
difference (NaN against NaN counts as equal).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BATCH, REPS, PDIP_REPS, PDIP_ITERS = 4096, 50, 3, 20
ORDERS = (30, 60, 120)
PDIP_SHAPES = ((60, 120), (120, 240))


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


def spd(n: int, dev):
    rng = np.random.default_rng(7)
    A = rng.standard_normal((BATCH, n, n))
    M = torch.tensor(A @ A.transpose(0, 2, 1) / n + 3.0 * np.eye(n),
                     dtype=torch.float32, device=dev)
    rhs = torch.tensor(rng.standard_normal((BATCH, n, 1)),
                       dtype=torch.float32, device=dev)
    return M, rhs


def qp(n: int, m: int, dev):
    """H = A A' / n + 3 I, f and G normal, h = |normal| + 1 (the recipe of
    tests/test_qp_pallas.py:46-58), from z0 = 0, s0 = lam0 = 1."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((BATCH, n, n))
    H = A @ A.transpose(0, 2, 1) / n + 3.0 * np.eye(n)
    arrs = (H, rng.standard_normal((BATCH, n)),
            rng.standard_normal((BATCH, m, n)),
            np.abs(rng.standard_normal((BATCH, m))) + 1.0,
            np.zeros((BATCH, n)), np.ones((BATCH, m)), np.ones((BATCH, m)))
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]


def measure(root: str, dump: str | None) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    from mpc_limx_control_tpu_torch.ops import chol_cuda, qp_cuda

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    out = {"root": root, "card": smi, "batch": BATCH,
           "library": str(chol_cuda._build.build_library()["path"])}
    saved = {}
    for n in ORDERS:
        M, rhs = spd(n, dev)
        L = chol_cuda.cholesky(M)
        calls = {"cholesky": lambda: chol_cuda.cholesky(M),
                 "chol_solve": lambda: chol_cuda.chol_solve(L, rhs),
                 "posdef_solve": lambda: chol_cuda.posdef_solve(M, rhs),
                 "posdef_solve_fast":
                     lambda: chol_cuda.posdef_solve_fast(M, rhs)}
        for name, fn in calls.items():
            out[f"{name}_n{n}_ms"] = cuda_ms(fn, REPS)
            saved[f"{name}_n{n}"] = fn().cpu().numpy()
    for n, m in PDIP_SHAPES:
        args = qp(n, m, dev)

        def k9():
            return qp_cuda.pdip_fused(*args, iters=PDIP_ITERS)

        out[f"pdip_fused_n{n}_m{m}_ms"] = cuda_ms(k9, PDIP_REPS)
        for field, t in zip(("z_best", "merit", "z_final", "lam_final"),
                            k9()):
            saved[f"pdip_fused_n{n}_{field}"] = t.cpu().numpy()
    if dump is not None:
        Path(dump).mkdir(parents=True, exist_ok=True)
        np.savez(Path(dump) / "outputs.npz", **saved)
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
    ap.add_argument("--compare", nargs=2, metavar=("DIR_A", "DIR_B"),
                    help="compare two --dump directories and exit")
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("time_chol_kernels: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(measure(args.root, args.dump)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
