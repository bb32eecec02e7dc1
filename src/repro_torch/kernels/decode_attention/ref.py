"""Plain PyTorch oracle for single-token GQA decode attention (the port of
``repro.kernels.decode_attention.ref``)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, valid):
    """q (B, Hq, D); k/v_cache (B, T, Hk, D); valid (B,) int32 live slots.

    Returns (B, Hq, D).  Scores in fp32, softmax in fp32, the
    probabilities rounded to v's dtype before the fp32-accumulated p·v, as
    the reference's oracle does."""
    B, Hq, D = q.shape
    T, Hk = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hk
    qg = q.reshape(B, Hk, G, D).float()
    s = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.float())
    s = s / torch.tensor(math.sqrt(D), dtype=torch.float32)
    ok = (torch.arange(T, device=q.device)[None, :]
          < valid.to(q.device)[:, None])  # (B, T)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, Hq, D).to(q.dtype)
