"""Time the four batched Cholesky / SPD-solve kernels of a checkout.

Run on a machine with a CUDA card:

    python3 tools/time_chol_kernels.py [--root CHECKOUT]

``--root`` is the checkout whose ``mpc_limx_control_tpu_torch`` is
imported (default: the one holding this script); its kernels are built
there at first use. Prints one JSON line: the card's name and power limit
and, per kernel and matrix order n (60, 120; one right-hand side), the
CUDA-event time per launch over 50 launches on B = 4096 fixed seeded SPD
inputs. Two checkouts are compared by running this once per checkout, in
turns, inside one call on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BATCH, REPS = 4096, 50


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_chol_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from mpc_limx_control_tpu_torch.ops import chol_cuda

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    out = {"root": args.root, "card": smi, "batch": BATCH,
           "library": str(chol_cuda._build.build_library()["path"])}
    for n in (60, 120):
        rng = np.random.default_rng(7)
        A = rng.standard_normal((BATCH, n, n))
        M = torch.tensor(A @ A.transpose(0, 2, 1) / n + 3.0 * np.eye(n),
                         dtype=torch.float32, device=dev)
        rhs = torch.tensor(rng.standard_normal((BATCH, n, 1)),
                           dtype=torch.float32, device=dev)
        L = chol_cuda.cholesky(M)
        calls = {"cholesky": lambda: chol_cuda.cholesky(M),
                 "chol_solve": lambda: chol_cuda.chol_solve(L, rhs),
                 "posdef_solve": lambda: chol_cuda.posdef_solve(M, rhs),
                 "posdef_solve_fast":
                     lambda: chol_cuda.posdef_solve_fast(M, rhs)}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fn()
            end.record()
            torch.cuda.synchronize()
            out[f"{name}_n{n}_ms"] = start.elapsed_time(end) / REPS
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
