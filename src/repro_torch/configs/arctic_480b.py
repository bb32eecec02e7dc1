"""arctic-480b [moe] — 128 experts top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base; hf]

A copy of ``repro.configs.arctic_480b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        n_experts=128,
        experts_per_token=2,
        moe_dense_ff=4864,
        capacity_factor=1.25,
        scan_layers=True,
        remat_policy="full",
        remat_group=5,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-reduced",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        n_experts=8,
        experts_per_token=2,
        moe_dense_ff=96,
        scan_layers=True,
        remat_policy="none",
        dtype="float32",
    )
