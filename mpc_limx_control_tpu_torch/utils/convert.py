"""Carry configs and plant state between the JAX package and the port.

The JAX side hands over plain data: a config as ``dataclasses.asdict``
(or the frozen dataclass itself) and a ``PlantState`` as a mapping of
field name -> numpy array, the filter state ``kf`` as a mapping (or any
object) with ``x_hat`` and ``p_cov``. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from mpc_limx_control_tpu_torch.core import config as pcfg
from mpc_limx_control_tpu_torch.core.types import KFState, default_device
from mpc_limx_control_tpu_torch.control import linear_mpc
from mpc_limx_control_tpu_torch.control.rollout import PlantState

PLANT_FIELDS = tuple(f.name for f in dataclasses.fields(PlantState))


def _build(cls, data: Mapping[str, Any]):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        default = f.default
        if dataclasses.is_dataclass(default):
            kw[f.name] = _build(type(default), v if isinstance(v, Mapping)
                                else dataclasses.asdict(v))
        elif isinstance(v, list):
            kw[f.name] = tuple(v)
        else:
            kw[f.name] = v
    return cls(**kw)


def config_from_dict(data) -> pcfg.ControllerConfig:
    """The port's ControllerConfig from ``dataclasses.asdict`` of the JAX
    one (or from the JAX dataclass itself)."""
    if dataclasses.is_dataclass(data):
        data = dataclasses.asdict(data)
    return _build(pcfg.ControllerConfig, data)


def config_to_dict(cfg: pcfg.ControllerConfig) -> dict:
    """``dataclasses.asdict`` of the port's config, for the JAX side to
    rebuild (the two copies of config.py have the same fields)."""
    return dataclasses.asdict(cfg)


def plant_state_from_numpy(data: Mapping[str, Any], device=None,
                           dtype=None) -> PlantState:
    """A PlantState from a mapping of field name -> array-like (missing or
    None fields stay None; unknown fields are refused), on the card unless
    ``device`` says otherwise."""
    device = default_device(device)
    extra = [k for k, v in data.items()
             if k not in PLANT_FIELDS and v is not None]
    if extra:
        raise ValueError(f"fields {extra} are not in the port's "
                         f"PlantState {PLANT_FIELDS}")

    def tensor(v):
        t = torch.tensor(np.asarray(v), device=device)
        return t if dtype is None else t.to(dtype)

    kw = {}
    for name in PLANT_FIELDS:
        v = data.get(name)
        if v is None:
            continue
        if name == "kf":
            parts = [v.get(k) if isinstance(v, Mapping)
                     else getattr(v, k, None) for k in ("x_hat", "p_cov")]
            if any(p is None for p in parts):
                raise ValueError("kf: expected a mapping or an object with "
                                 f"x_hat and p_cov, got {type(v).__name__}")
            kw[name] = KFState(x_hat=tensor(parts[0]), p_cov=tensor(parts[1]))
        else:
            kw[name] = tensor(v)
    return PlantState(**kw)


def plant_state_to_numpy(state: PlantState) -> dict:
    """Field name -> numpy array, ``kf`` -> {"x_hat", "p_cov"} (None
    fields are left out)."""
    def arr(t):
        return t.detach().cpu().numpy()

    out = {}
    for name in PLANT_FIELDS:
        v = getattr(state, name)
        if v is None:
            continue
        out[name] = ({"x_hat": arr(v.x_hat), "p_cov": arr(v.p_cov)}
                     if name == "kf" else arr(v))
    return out


def linear_mpc_params_from_numpy(cfg: pcfg.MPCConfig, Ad, Bd, device=None,
                                 dtype=None) -> linear_mpc.LinearMPCParams:
    """LinearMPCParams from discrete matrices Ad [nx,nx], Bd [nx,nu] given
    as arrays, so that both packages start the linear example from the
    same matrices (the condensation is rebuilt from them); on the card
    unless ``device`` says otherwise."""
    device = default_device(device)
    Ad_t = torch.tensor(np.asarray(Ad), device=device)
    Bd_t = torch.tensor(np.asarray(Bd), device=device)
    if dtype is not None:
        Ad_t, Bd_t = Ad_t.to(dtype), Bd_t.to(dtype)
    return linear_mpc.params_from_matrices(cfg, Ad_t, Bd_t)
