"""Rotary position embeddings, including Qwen2-VL style M-RoPE — the port
of ``repro.models.layers.rope``.

M-RoPE splits the head_dim/2 rotary frequency bands into (temporal,
height, width) sections, each driven by its own position-id stream.
Text-only positions degenerate to all three streams equal, which reduces
M-RoPE to standard RoPE.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers.common import on_mesh


def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim//2) in fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * on_mesh(freqs)
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions3, head_dim: int, theta: float,
                 sections: Tuple[int, ...]):
    """positions3 (3, B, S) -> cos/sin (B, S, head_dim//2) in fp32.

    Section i of the frequency bands takes its positions from stream i."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope_angles: sections {tuple(sections)} must sum "
                         f"to head_dim // 2 = {half}")
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions3.device) / half))
    freqs = on_mesh(freqs)
    pos = positions3.float()
    bands, lo = [], 0
    for i, n in enumerate(sections):  # stream i drives bands lo .. lo + n
        bands.append(pos[i][..., None] * freqs[lo:lo + n])
        lo += n
    ang = torch.cat(bands, dim=-1)  # (B, S, half)
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
