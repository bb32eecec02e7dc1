"""musicgen-large [audio] — decoder-only over EnCodec tokens.

[arXiv:2306.05284; hf].  Backbone only: the EnCodec frontend is a stub —
the caller passes precomputed frame embeddings (B, S, d_model) as
``embeds``.

A copy of ``repro.configs.musicgen_large``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        embed_stub=True,
        scan_layers=True,
        remat_policy="full",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-reduced",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        embed_stub=True,
        scan_layers=True,
        remat_policy="none",
        dtype="float32",
    )
