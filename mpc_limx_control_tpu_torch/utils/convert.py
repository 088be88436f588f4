"""Carry configs and plant state between the JAX package and the port.

The JAX side hands over plain data: a config as ``dataclasses.asdict``
(or the frozen dataclass itself) and a ``PlantState`` as a mapping of
field name -> numpy array. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from mpc_limx_control_tpu_torch.core import config as pcfg
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
    """A PlantState from a mapping of field name -> array-like (missing
    or None fields stay None; JAX-only fields such as the KF state are
    refused)."""
    extra = [k for k, v in data.items()
             if k not in PLANT_FIELDS and v is not None]
    if extra:
        raise ValueError(f"fields {extra} are not in this slice's "
                         f"PlantState {PLANT_FIELDS}")
    kw = {}
    for name in PLANT_FIELDS:
        v = data.get(name)
        if v is not None:
            t = torch.tensor(np.asarray(v), device=device)
            kw[name] = t if dtype is None else t.to(dtype)
    return PlantState(**kw)


def plant_state_to_numpy(state: PlantState) -> dict:
    """Field name -> numpy array (None fields are left out)."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in PLANT_FIELDS if getattr(state, name) is not None}
