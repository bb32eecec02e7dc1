"""starcoder2-3b [dense] — GQA kv=2, RoPE. [arXiv:2402.19173; hf]

A copy of ``repro.configs.starcoder2_3b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        scan_layers=True,
        remat_policy="full",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-reduced",
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
