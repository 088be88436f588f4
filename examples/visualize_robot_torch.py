"""Stick-figure visualization of the TRON1 kinematic chain, on the
PyTorch/CUDA port.

Renders the base and both leg chains from the port's analytic forward
kinematics (``models/kinematics.leg_geometry``) at a given or random
joint configuration, to a PNG (needs matplotlib).

Usage: python examples/visualize_robot_torch.py [--q q0,...,q5] [--seed 0]
           [--device cuda|cpu] [--out robot_torch.png]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from mpc_limx_control_tpu_torch.core.config import LegOffsets
from mpc_limx_control_tpu_torch.core.types import require_device
from mpc_limx_control_tpu_torch.models.kinematics import (_mv, _rx, _ry,
                                                           forward_kinematics,
                                                           leg_geometry)


def chain_points(offsets: LegOffsets, q3: torch.Tensor, side: str):
    """Joint positions along one leg, base -> abad -> hip -> knee ->
    contact, [5, 3] in the base frame."""
    g = leg_geometry(offsets, side, q3.dtype, q3.device)
    r0 = _rx(q3[0])
    r01 = r0 @ _ry(q3[1])
    p_hip = g.abad + _mv(r0, g.hip)
    p_knee = p_hip + _mv(r01, g.knee)
    p_contact = forward_kinematics(g, q3)
    return torch.stack([torch.zeros_like(g.abad), g.abad, p_hip, p_knee,
                        p_contact]).cpu().numpy()


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--q", type=str, default=None,
                    help="six comma-separated joint angles (rad)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=str, default="/tmp/robot_torch.png")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    if args.q:
        q = np.asarray([float(v) for v in args.q.split(",")])
        if q.shape != (6,):
            raise ValueError(f"--q: six angles, got {q.shape[0]}")
    else:
        q = np.random.default_rng(args.seed).uniform(-0.6, 0.6, 6)
    print("q =", np.round(q, 3))
    qt = torch.as_tensor(q, dtype=torch.float64, device=dev)
    off = LegOffsets()
    left = chain_points(off, qt[:3], "left")
    right = chain_points(off, qt[3:], "right")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    for pts, color, name in ((left, "tab:blue", "left"),
                             (right, "tab:red", "right")):
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], "-o", color=color,
                label=f"{name} leg")
        ax.scatter(*pts[-1], color=color, s=60, marker="v")
    ax.scatter(0, 0, 0, color="k", s=120, marker="s", label="base")
    ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
    ax.set_title("TRON1 point-foot FK (analytic chain)")
    ax.legend()
    lim = 0.9
    ax.set_xlim(-lim / 2, lim / 2)
    ax.set_ylim(-lim / 2, lim / 2)
    ax.set_zlim(-lim, 0.1)
    fig.tight_layout()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print("wrote", args.out)
    return args.out


if __name__ == "__main__":
    main()
