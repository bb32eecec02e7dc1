"""Rotary position embeddings — the port of ``repro.models.layers.rope``
(standard RoPE; M-RoPE is not ported yet, ROADMAP.md 'Queued in the port'
item P9)."""
from __future__ import annotations

import torch


def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim//2) in fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, S, H, D); cos/sin (B, S, D//2) or (S, D//2).  The rotation is
    computed in fp32 (x's dtype promotes against the fp32 angles) and each
    half rounded back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> broadcast over batch
        cos = cos[None]
        sin = sin[None]
    cos = cos[:, :, None, :]  # (B, S, 1, half)
    sin = sin[:, :, None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1.to(x.dtype), o2.to(x.dtype)], dim=-1)
