"""mpc_limx_control_tpu_torch — the PyTorch/CUDA port of
:mod:`mpc_limx_control_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package keeps its module paths
and function names so every counterpart is easy to find, and it imports
``torch`` only (never ``jax``, ``chex`` or the JAX package).

It covers the batched walking and standing closed loops (truth odometry
or the Kalman filter, every tick solving or the dtMPC hold schedule) with
every controller configuration of the JAX package (the general QP
solvers -- cold and warm interior point, dense and Riccati-form ADMM --,
the iterative swing IKs, the receding attitude reference), the
condensation, the double-integrator linear MPC and the leg inverse
dynamics, with the hand-written CUDA kernels of every TPU kernel of the
JAX package (``ops/csrc``): the whole-tick and fused MPC kernels, the
batched Cholesky / SPD solves and the fused interior-point solve.

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
