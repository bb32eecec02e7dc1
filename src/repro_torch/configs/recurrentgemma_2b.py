"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, pattern 1:2
(a copy of ``repro.configs.recurrentgemma_2b``).

[arXiv:2402.19427; hf].  Two recurrent (RG-LRU) blocks followed by one
local-attention block (window 2048), cycling over 26 layers.  The RG-LRU
recurrence is the second first-class target of the Unfolded schedule.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        window=2048,
        block_pattern=("rglru", "rglru", "attn"),
        rglru_width=2560,
        scan_layers=False,  # heterogeneous pattern; unrolled
        remat_policy="full",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-reduced",
        family="hybrid",
        n_layers=3,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        window=16,
        block_pattern=("rglru", "rglru", "attn"),
        rglru_width=64,
        scan_layers=False,
        remat_policy="none",
        dtype="float32",
    )
