"""The comparison that decides ``correct``: widest gaps between what the
program produced and what the reference computes from the same inputs,
and the checks that hold each number to its limit.

A gap of a field is the largest absolute difference over every scenario,
tick and component, over the field's scale: the largest magnitude the
reference gives it, or a floor where that is smaller (1 where the
reference's field is all zero): a widest gap relative to the field's
scale.
"""

from __future__ import annotations

import math

import torch


def field_gap(program: torch.Tensor, ref: torch.Tensor,
              scale: float | None = None, floor: float = 0.0) -> float:
    """Widest gap of one field over `scale`, by default the reference's
    largest magnitude or `floor`, whichever is larger (a field near zero,
    such as a velocity at rest, is judged on the floor: a unit of its SI
    quantity); inf where the program's field is not finite."""
    p = program.to(torch.float64).to(ref.device)
    r = ref.to(torch.float64)
    if p.shape != r.shape:
        raise ValueError(f"shapes differ: {tuple(p.shape)} against "
                         f"{tuple(r.shape)}")
    if not bool(torch.isfinite(p).all()):
        return math.inf
    if scale is None:
        scale = max(float(r.abs().max()) if r.numel() else 0.0, floor)
    diff = float((p - r).abs().max()) if r.numel() else 0.0
    return diff / (scale if scale > 0.0 else 1.0)


def gaps(program: dict, ref: dict, fields, scales=None,
         floor: float = 0.0) -> dict:
    scales = scales or {}
    return {k: field_gap(program[k], ref[k], scales.get(k), floor)
            for k in fields if ref.get(k) is not None}


BIG = 1e300     # what a non-finite reading is printed as (JSON has no inf)


def _check(name, value, limit, op, ok) -> dict:
    value = float(value)
    if not math.isfinite(value):
        value, ok = BIG, False
    return {"name": name, "value": value, "limit": limit, "op": op,
            "ok": bool(ok)}


def at_most(name: str, value: float, limit: float) -> dict:
    return _check(name, value, limit, "<=", value <= limit)


def at_least(name: str, value: float, limit: float) -> dict:
    return _check(name, value, limit, ">=", value >= limit)


def within(name: str, value: float, lo: float, hi: float) -> dict:
    return _check(name, value, [lo, hi], "in", lo <= value <= hi)


def quality_checks(values: dict, bands: dict) -> list:
    """Each band of the mix's ``quality`` ({"min": x} / {"max": y} / both)
    against the window's reading of the same name."""
    out = []
    for name, band in bands.items():
        v = values.get(name, math.nan)
        if "min" in band and "max" in band:
            out.append(within(name, v, band["min"], band["max"]))
        elif "min" in band:
            out.append(at_least(name, v, band["min"]))
        else:
            out.append(at_most(name, v, band["max"]))
    return out
