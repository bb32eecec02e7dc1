"""stablelm-12b [dense]. [hf:stabilityai/stablelm-2-1_6b; hf]

A copy of ``repro.configs.stablelm_12b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        scan_layers=True,
        remat_policy="full",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        scan_layers=True,
        remat_policy="none",
        dtype="float32",
    )
