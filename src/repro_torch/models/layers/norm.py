"""RMSNorm (fp32 statistics, cast back to input dtype) — the port of
``repro.models.layers.norm``."""
from __future__ import annotations

import torch


def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.reciprocal(torch.sqrt(var + eps))
    return (y * (1.0 + scale.float())).to(dtype)


def init_norm(d: int, dtype, device="cpu"):
    return torch.zeros((d,), dtype=dtype, device=device)
