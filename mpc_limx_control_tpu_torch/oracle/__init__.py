from mpc_limx_control_tpu_torch.oracle.qp_oracle import solve_qp_oracle  # noqa: F401
from mpc_limx_control_tpu_torch.oracle import pipeline  # noqa: F401
