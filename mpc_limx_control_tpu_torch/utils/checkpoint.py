"""Checkpoint / resume of batched scenario state.

Counterpart of ``mpc_limx_control_tpu.utils.checkpoint`` (which uses orbax
where it is installed and a single ``.npz`` file otherwise): a tree of
tensors -- dicts, lists, tuples and dataclasses such as ``PlantState`` or
``KFState``, ``None`` leaves allowed -- saved to one ``.npz`` file and
restored into the structure, devices and dtypes of a template.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch


def _children(tree):
    """(kind, keys, values) of a container node; None for a leaf."""
    if isinstance(tree, dict):
        return "dict", list(tree), list(tree.values())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return type(tree).__name__, names, [getattr(tree, n) for n in names]
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__, list(range(len(tree))), list(tree)
    return None


def _leaves(tree, out: list) -> str:
    """Append the tensors of `tree` to `out` in order; returns a string
    naming the structure (checked on restore)."""
    node = _children(tree)
    if node is None:
        if tree is None:
            return "None"
        out.append(torch.as_tensor(tree))
        return "T"
    kind, keys, values = node
    return (f"{kind}(" + ",".join(f"{k}:{_leaves(v, out)}"
                                  for k, v in zip(keys, values)) + ")")


def _rebuild(like, leaves):
    node = _children(like)
    if node is None:
        if like is None:
            return None
        t = torch.as_tensor(like)
        x = torch.from_numpy(next(leaves))
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(x.shape)}, "
                             f"the template's is {tuple(t.shape)}")
        return x.to(device=t.device, dtype=t.dtype)
    kind, keys, values = node
    new = [_rebuild(v, leaves) for v in values]
    if kind == "dict":
        return dict(zip(keys, new))
    if isinstance(like, (list, tuple)):
        return type(like)(*new) if hasattr(like, "_fields") \
            else type(like)(new)
    return dataclasses.replace(like, **dict(zip(keys, new)))


def _npz(path) -> Path:
    return Path(path).with_suffix(".npz")


def save(path, tree) -> None:
    """Save a tree of tensors to ``<path>.npz`` (tensors on any device)."""
    leaves: list = []
    treedef = _leaves(tree, leaves)
    np.savez(_npz(path),
             __treedef__=np.frombuffer(treedef.encode(), dtype=np.uint8),
             **{f"leaf_{i}": x.detach().cpu().numpy()
                for i, x in enumerate(leaves)})


def restore(path, like):
    """Restore a tree saved by :func:`save` with the structure, devices
    and dtypes of `like` (ValueError when the structure or a shape
    differs)."""
    with np.load(_npz(path)) as data:
        leaves: list = []
        want = _leaves(like, leaves)
        got = data["__treedef__"].tobytes().decode()
        if got != want:
            raise ValueError(f"checkpoint structure {got} is not the "
                             f"template's {want}")
        arrays = [data[f"leaf_{i}"] for i in range(len(leaves))]
    return _rebuild(like, iter(arrays))
