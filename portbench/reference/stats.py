"""The cross-scenario statistics of a global batch in float64, from every
scenario's per-tick values: the plain reference for the statistics the
port's scenario mesh reduces over its shards and processes
(``scenario_stats``: the mean height, the largest QP residual, the mean
vertical force of both feet, the scenario nearest the mean height).

Plain torch; imports neither JAX nor the port.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def statistics(height: torch.Tensor, qp_residual: torch.Tensor,
               grf: torch.Tensor) -> dict:
    """height [B, T], qp_residual [B, T], grf [B, T, 6] (both feet's
    forces, fz at 2 and 5) -> float64 [T] each: ``mean_height``,
    ``max_qp_residual``, ``grf_mean_fz`` and ``nearest``, the least
    distance of a scenario's height to the mean."""
    h = height.to(F64)
    n = h.shape[0]
    mean = h.sum(0) / n
    g = grf.to(F64)
    return {"mean_height": mean,
            "max_qp_residual": qp_residual.to(F64).amax(0),
            "grf_mean_fz": (g[..., 2] + g[..., 5]).sum(0) / n,
            "nearest": (h - mean).abs().amin(0)}


def gaps(program: dict, height: torch.Tensor, qp_residual: torch.Tensor,
         grf: torch.Tensor) -> dict:
    """How far the program's statistics (``mean_height``,
    ``max_qp_residual``, ``grf_mean_fz``, ``best_scenario``: [T] each, of
    the same values) lie from the reference's, widest over the ticks:

    * ``mean_height``, ``grf_mean_fz``: |program - reference| over
      |reference|;
    * ``max_qp_residual``: |program - reference| (a maximum rounds
      nothing: 0);
    * ``best_scenario``: the chosen scenario's distance to the reference
      mean less the least distance, over |mean| (0 where the program chose
      a nearest scenario).

    inf where a program statistic is not finite."""
    ref = statistics(height, qp_residual, grf)
    dev = ref["mean_height"].device

    def prog(k):
        return program[k].to(dev)

    def widest(x):
        x = x.to(F64)
        return float(x.max()) if bool(torch.isfinite(x).all()) else math.inf

    out = {k: widest((prog(k).to(F64) - ref[k]).abs() / ref[k].abs())
           for k in ("mean_height", "grf_mean_fz")}
    out["max_qp_residual"] = widest(
        (prog("max_qp_residual").to(F64) - ref["max_qp_residual"]).abs())
    best = prog("best_scenario").to(torch.long)
    if bool(((best < 0) | (best >= height.shape[0])).any()):
        out["best_scenario"] = math.inf
    else:
        d = (height.to(F64) - ref["mean_height"]).abs()
        picked = d.gather(0, best[None])[0]
        out["best_scenario"] = widest(
            (picked - ref["nearest"]) / ref["mean_height"].abs())
    return out
