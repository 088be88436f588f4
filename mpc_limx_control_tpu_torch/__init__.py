"""mpc_limx_control_tpu_torch — the PyTorch/CUDA port of
:mod:`mpc_limx_control_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package keeps its module paths
and function names so every counterpart is easy to find, and it imports
``torch`` only (never ``jax``, ``chex`` or the JAX package).

Slice 1 covers the batched walking closed loop of
``ControllerConfig.walking()``: rotations, leg kinematics, the SRBD model,
the gait schedule, condensation, the warm ADMM, the controller tick and
the rollout harness, plus the two hand-written CUDA kernels that carry the
main path on the card (``ops/csrc``).

Every float32 matrix product runs in full float32: this controller has
failed silently twice under reduced-precision matmuls (walking height 0.56
instead of 0.655, and a NaN Kalman filter), so the TF32 paths are pinned
off when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from mpc_limx_control_tpu_torch.core import config, types  # noqa: E402,F401
