"""State containers as small dataclasses of tensors.

A frozen copy of the port's ``core/types.py``, trimmed to the odometry
and gait-state containers and the cached constants. Every field carries
an explicit leading batch dimension ``[B, ...]``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch


def constant(values, dtype, device) -> torch.Tensor:
    """A tensor of configuration values (a float or nested tuples of
    floats) on `device`, made once per (values, dtype, device). A tensor
    made from Python values on every call is a copy from pageable host
    memory: it blocks the host behind the kernels queued before it, and
    a CUDA graph cannot capture it. Callers must not modify the result."""
    # keyed by the repr too: -0.0 == 0.0 would otherwise share an entry
    return _constant(repr(values), values, dtype, device)


@functools.lru_cache(maxsize=256)
def _constant(key: str, values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


class _Replace:
    """``.replace(**fields)``, as the JAX package's chex dataclasses have
    it."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _zeros(batch, width, dtype, device, w_one=False):
    """A [*batch, width] zero tensor on `device` (the card unless told
    otherwise); ``w_one`` sets the last entry to 1 (a unit quaternion)."""
    t = torch.zeros((*tuple(batch), width), dtype=dtype,
                    device=default_device(device))
    if w_one:
        t[..., -1] = 1.0
    return t


@dataclasses.dataclass(frozen=True)
class OdomState(_Replace):
    """Base-link odometry: pos/ori(rpy)/quat(x,y,z,w)/v_pos/v_ori."""

    pos: torch.Tensor    # [B, 3]
    ori: torch.Tensor    # [B, 3]
    quat: torch.Tensor   # [B, 4]
    v_pos: torch.Tensor  # [B, 3]
    v_ori: torch.Tensor  # [B, 3]

    @classmethod
    def zeros(cls, batch=(), dtype=torch.float32, device=None):
        """At the origin, level (quat w = 1), at rest."""
        return cls(pos=_zeros(batch, 3, dtype, device),
                   ori=_zeros(batch, 3, dtype, device),
                   quat=_zeros(batch, 4, dtype, device, w_one=True),
                   v_pos=_zeros(batch, 3, dtype, device),
                   v_ori=_zeros(batch, 3, dtype, device))


@dataclasses.dataclass(frozen=True)
class GaitState(_Replace):
    """Gait clock output (MPCController.h:61-75): left_swing [B] bool,
    phase / remain_swing_time / swing_progress [B]."""

    left_swing: torch.Tensor
    phase: torch.Tensor
    remain_swing_time: torch.Tensor
    swing_progress: torch.Tensor


