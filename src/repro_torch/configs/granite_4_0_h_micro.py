"""granite-4.0-h-micro [hybrid] — Mamba-2 + NoPE GQA, 9:1 (IBM, 2025-10;
huggingface.co/ibm-granite/granite-4.0-h-micro, config.json).

40 layers at hidden 2,048 in a period of 10 repeated 4 times: five
Mamba-2 layers, one attention layer, four Mamba-2 layers.  A Mamba-2
layer has 64 heads of 64, d_state 128, one group of B and C, a depthwise
conv of width 4 with bias, expand 2; an attention layer 32 query heads and
8 KV heads of 64 with no positional encoding; every layer a SwiGLU MLP of
8,192.  Vocabulary 100,352, tied embeddings; RMSNorm eps 1e-5; the four
scalars: embeddings x 12, each block's output x 0.22 before its residual
add, a softmax scale of 1/64, logits / 8.  About 3.19B parameters.

The port holds no JAX counterpart of it (the JAX package has no Mamba-2
block), so it is not in ``configs.list_archs()``, the reference's list.
"""
from repro_torch.configs.base import ModelConfig

#: layer_types of the published config: one period
PATTERN = ("mamba2",) * 5 + ("attn",) + ("mamba2",) * 4


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-micro",
        family="hybrid",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=100352,
        block_pattern=PATTERN,
        mamba_n_heads=64,
        mamba_d_head=64,
        mamba_d_state=128,
        mamba_n_groups=1,
        mamba_d_conv=4,
        mamba_expand=2,
        mamba_chunk_size=256,
        mamba_conv_bias=True,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        attention_multiplier=0.015625,
        logits_scaling=8.0,
        position_embedding="nope",
        rope_theta=10_000.0,
        norm_eps=1e-5,
        tie_embeddings=True,
        scan_layers=False,  # heterogeneous pattern; unrolled
        remat_policy="full",
    )


def reduced() -> ModelConfig:
    """One period at toy widths, fp32: the CPU tests' size."""
    return ModelConfig(
        name="granite-4.0-h-micro-reduced",
        family="hybrid",
        n_layers=10,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=PATTERN,
        mamba_n_heads=8,
        mamba_d_head=16,
        mamba_d_state=16,
        mamba_n_groups=2,
        mamba_d_conv=4,
        mamba_expand=2,
        mamba_chunk_size=8,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        attention_multiplier=0.0625,
        logits_scaling=8.0,
        position_embedding="nope",
        norm_eps=1e-5,
        tie_embeddings=True,
        scan_layers=False,
        remat_policy="none",
        dtype="float32",
    )
