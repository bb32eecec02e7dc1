"""deepseek-67b [dense] — llama-arch, GQA kv=8. [arXiv:2401.02954; hf]

A copy of ``repro.configs.deepseek_67b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        scan_layers=True,
        remat_policy="full",
        remat_group=5,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b-reduced",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        scan_layers=True,
        remat_policy="none",
        dtype="float32",
    )
