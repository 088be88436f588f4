"""Long-run endurance soak with checkpoint / resume, on the PyTorch/CUDA
port.

Drives ``control/rollout.py::soak_rollout`` in chunks of
``--checkpoint-every`` windows. After each chunk it saves the batched
PlantState, the gait phases and every window's statistics so far
(``utils/checkpoint.py``), and only then appends the chunk's rows to a
JSONL. Kill it at any point and rerun with ``--resume``: it continues from
the last checkpoint and rewrites the JSONL from the checkpoint's rows, so
no window is counted twice or lost. The last chunk runs only the windows
still missing, so exactly ``--windows`` windows run.

Usage:
    python examples/run_soak_torch.py --batch 64 --windows 60 --window 1000 \
        [--estimator truth|kf] [--checkpoint-every 10] [--resume] \
        [--device cuda|cpu] [--out /tmp/soak_torch]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from mpc_limx_control_tpu_torch.control import rollout as ro
from mpc_limx_control_tpu_torch.core.config import ControllerConfig
from mpc_limx_control_tpu_torch.core.types import require_device
from mpc_limx_control_tpu_torch.utils import checkpoint as ckpt

GAIT_CYCLE = 600  # walking(): 0.3 s swing + 0.3 s stance at 1 kHz


def _write_rows(path: Path, stats: torch.Tensor, keys, first: int,
                mode: str = "a") -> None:
    """One JSON line a window: column w of stats [n_keys, n] is window
    first + w."""
    with open(path, mode) as fh:
        for w in range(stats.shape[1]):
            row = {"window": first + w}
            row.update({k: float(stats[i, w]) for i, k in enumerate(keys)})
            fh.write(json.dumps(row) + "\n")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--windows", type=int, default=60)
    ap.add_argument("--window", type=int, default=1000)
    ap.add_argument("--checkpoint-every", type=int, default=10,
                    help="windows per checkpoint chunk")
    ap.add_argument("--estimator", choices=("truth", "kf"),
                    default="truth")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=str, default="/tmp/soak_torch")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    if args.windows < 1 or args.checkpoint_every < 1:
        raise ValueError("--windows and --checkpoint-every must be >= 1")

    cfg = ControllerConfig.walking()
    if args.estimator == "kf":
        cfg = dataclasses.replace(cfg, estimator_mode="kf")
    keys = ro.SOAK_KEYS + (ro.SOAK_KF_KEYS if args.estimator == "kf"
                           else ())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ck_path = out / f"state_{args.estimator}"
    stats_path = out / f"stats_{args.estimator}.jsonl"

    B = args.batch
    s0 = ro.initial_plant_state(cfg, batch=(B,), device=dev)
    xi = s0.xi.clone()
    xi[:, 9] += 0.05 * torch.as_tensor(
        np.random.default_rng(7).standard_normal(B), dtype=xi.dtype,
        device=dev)
    s0 = s0.replace(xi=xi)
    # stagger the gait phase across the batch (phase-free window means)
    it0 = torch.as_tensor((np.arange(B) * GAIT_CYCLE) // B,
                          dtype=torch.float32, device=dev)
    # every window's statistics (NaN until it has run) travel in the
    # checkpoint with the state
    rows = torch.full((len(keys), args.windows), float("nan"),
                      dtype=torch.float64)
    done = 0
    like = {"state": s0, "it0": it0, "rows": rows,
            "done": torch.zeros((), dtype=torch.int64)}
    if args.resume and ck_path.with_suffix(".npz").exists():
        tree = ckpt.restore(ck_path, like)
        s0, it0, rows = tree["state"], tree["it0"], tree["rows"]
        done = int(tree["done"])
        # the JSONL holds exactly the checkpoint's windows again
        _write_rows(stats_path, rows[:, :done], keys, 0, mode="w")
        print(f"resumed after window {done} (tick {done * args.window})")
    else:
        stats_path.unlink(missing_ok=True)

    s, it = s0, it0
    while done < args.windows:
        n = min(args.checkpoint_every, args.windows - done)
        s, stats = ro.soak_rollout(cfg, s, n, args.window,
                                   start_iteration=it)
        it = it + n * args.window
        chunk = torch.stack([stats[k].to(torch.float64) for k in keys])
        rows[:, done:done + n] = chunk
        ckpt.save(ck_path, {"state": s, "it0": it, "rows": rows,
                            "done": torch.tensor(done + n)})
        _write_rows(stats_path, chunk, keys, done)
        done += n
        print(f"windows {done}/{args.windows} (tick {done * args.window}): "
              f"h_mean {float(stats['height_mean'][-1]):.4f} "
              f"vx {float(stats['vx_mean'][-1]):.4f} -> checkpointed")

    # stationarity summary over every window (those before a resume too)
    recorded = [json.loads(ln) for ln in open(stats_path)]
    stats_all = {k: np.asarray([r[k] for r in recorded]) for k in keys}
    stats_all["nonfinite_ticks"] = stats_all["nonfinite_ticks"].astype(
        np.int64)
    summ = ro.soak_stationary(stats_all)
    summ["windows"] = len(recorded)
    print(json.dumps(summ, indent=1))
    return summ


if __name__ == "__main__":
    main()
