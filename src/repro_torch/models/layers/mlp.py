"""Gated (SwiGLU-style) MLP — the port of ``repro.models.layers.mlp``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import dense_init, project, shard_act


def init_mlp(gen: torch.Generator, d: int, ff: int, dtype, device="cpu"):
    return {
        "w_gate": dense_init(gen, (d, ff), dtype, device=device),
        "w_up": dense_init(gen, (d, ff), dtype, device=device),
        "w_down": dense_init(gen, (ff, d), dtype, device=device),
    }


def apply_mlp(params, x, *, decode: bool = False):
    """silu(x·w_gate) * (x·w_up) · w_down, each product accumulated in fp32
    and rounded to x's dtype; ``decode=True`` sends the three through the
    mvm kernel (``common.project``)."""
    g = project(x, params["w_gate"], decode=decode)
    u = project(x, params["w_up"], decode=decode)
    h = F.silu(g.float()).to(x.dtype) * u
    h = shard_act(h, "batch", "seq", "ff")
    return project(h, params["w_down"], decode=decode)
