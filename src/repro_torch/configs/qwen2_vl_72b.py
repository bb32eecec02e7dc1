"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution.

[arXiv:2409.12191; hf].  Backbone only: the vision tower is a stub —
the caller passes precomputed patch embeddings as ``embeds``.  M-RoPE
splits the head_dim rotary bands into (temporal, height, width)
sections.

A copy of ``repro.configs.qwen2_vl_72b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        mrope_sections=(16, 24, 24),  # sums to head_dim//2 = 64
        embed_stub=True,
        scan_layers=True,
        remat_policy="full",
        remat_group=4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-reduced",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        mrope_sections=(2, 3, 3),  # head_dim 16 -> half=8
        embed_stub=True,
        scan_layers=True,
        remat_policy="none",
        dtype="float32",
    )
