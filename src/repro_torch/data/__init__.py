from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: F401
