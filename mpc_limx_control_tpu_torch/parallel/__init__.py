from mpc_limx_control_tpu_torch.parallel import mesh  # noqa: F401
