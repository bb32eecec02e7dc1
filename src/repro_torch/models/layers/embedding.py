"""Token embedding and output head — the port of
``repro.models.layers.embedding``."""
from __future__ import annotations

import torch

from repro_torch.models.layers.common import dense_init


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype,
                   tie: bool, device="cpu"):
    p = {"table": dense_init(gen, (vocab, d), dtype, scale=1.0,
                             device=device)}
    if not tie:
        p["unembed"] = dense_init(gen, (d, vocab), dtype, device=device)
    return p


def embed(params, tokens, dtype):
    return params["table"].to(dtype)[tokens]


def unembed(params, x):
    """x (B, S, d) -> fp32 logits (B, S, vocab): the model-dtype operands
    multiplied in fp32, as the reference's einsum with an fp32 result does
    (TF32 stays off on the card, ``rnn.resolve_device``).  Not a
    projection in ``common.project``'s sense: it never goes through mvm."""
    w = params["unembed"] if "unembed" in params else params["table"].T
    return torch.matmul(x.float(), w.float())
