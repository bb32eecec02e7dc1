from repro_torch.kernels.ssm.ops import ssm_update, ssm_update_plain  # noqa: F401
