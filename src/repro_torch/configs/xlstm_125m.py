"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks.

[arXiv:2405.04517; unverified].  d_ff=0: xLSTM blocks carry their own
up/down projections instead of a residual MLP.  This family is the
first-class target of the paper's Unfolded schedule (see DESIGN.md §4).

A copy of ``repro.configs.xlstm_125m``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=("mlstm", "slstm"),
        scan_layers=False,  # heterogeneous blocks; 12 layers unrolled is cheap
        remat_policy="full",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-reduced",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=256,
        block_pattern=("mlstm", "slstm"),
        scan_layers=False,
        remat_policy="none",
        dtype="float32",
    )
