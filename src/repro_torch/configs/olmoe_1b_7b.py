"""olmoe-1b-7b [moe] — 64 experts top-8. [arXiv:2409.02060; hf]

A copy of ``repro.configs.olmoe_1b_7b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        n_experts=64,
        experts_per_token=8,
        capacity_factor=1.25,
        scan_layers=True,
        remat_policy="full",  # MoE dispatch buffers are too large to save
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-reduced",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab_size=256,
        n_experts=8,
        experts_per_token=4,
        scan_layers=True,
        remat_policy="none",
        dtype="float32",
    )
