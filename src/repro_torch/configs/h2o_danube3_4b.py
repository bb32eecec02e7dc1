"""h2o-danube-3-4b [dense] — llama+mistral mix, SWA.

[arXiv:2401.16818; unverified] — window size not pinned by the source;
we assume a mistral-style 4096 sliding window (recorded in DESIGN.md).

A copy of ``repro.configs.h2o_danube3_4b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        window=4096,
        scan_layers=True,
        remat_policy="full",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        window=16,
        scan_layers=True,
        remat_policy="none",
        dtype="float32",
    )
