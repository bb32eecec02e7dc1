from repro_torch.kernels.rglru.ops import rglru_scan  # noqa: F401
