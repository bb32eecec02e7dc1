"""The plain reference of the Mamba-2 / attention hybrids (granite-4.0-h):
the whole model's forward pass in float32, written from the published
equations (the Mamba-2 paper, arXiv:2405.21060, and Hugging Face's
``granitemoehybrid`` code) with plain torch operations.  It imports
nothing but torch: no kernel of the port, no layer of it, nothing of the
JAX package.  It has no cache, no batching of requests and no chunked
form: the SSM runs the per-step recurrence as written, step by step.  TF32
is switched off for its products on a card.

    x_0 = E[tokens] · embedding_multiplier
    x += residual_multiplier · mixer(RMSNorm(x))     (mixer: Mamba-2 or attention)
    x += residual_multiplier · MLP(RMSNorm(x))       (SwiGLU)
    logits = RMSNorm(x) · Eᵀ / logits_scaling        (tied embeddings)

Attention: causal GQA with no positional encoding (``position_embedding``
"nope"; RoPE otherwise, rotate-half over the head's two halves), softmax
scale ``attention_multiplier`` (1 / sqrt(D) where it is 0).  Mamba-2: as
``models/layers/mamba2.py``'s docstring writes it, the gated RMSNorm over
each of the G groups of d_inner / G channels.

Departures, each kept equal in the program: the RMSNorm scales are held
as s and applied as 1 + s (a published weight w is w - 1); the conv
weight is (k, conv_dim); projections are (in, out).

``cfg`` is anything with ``ModelConfig``'s attribute names; ``params`` is
the port's tree (``models.transformer.init_params``, a list of per-layer
dicts), read in fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _f(t):
    return t.float()


def rms_norm(x, scale, eps):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(var + eps) * (1.0 + _f(scale))


def _rope(x, positions, theta):
    """Rotate-half RoPE of x (B, S, heads, D) at positions (S,)."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(cfg, p, x):
    """Causal GQA over x (B, S, d)."""
    B, S, _ = x.shape
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ _f(p["w_q"])).reshape(B, S, Hq, D)
    k, v = (x @ _f(p["w_kv"])).split(Hk * D, dim=-1)
    k, v = k.reshape(B, S, Hk, D), v.reshape(B, S, Hk, D)
    if cfg.position_embedding != "nope":
        pos = torch.arange(S, device=x.device)
        q, k = _rope(q, pos, cfg.rope_theta), _rope(k, pos, cfg.rope_theta)
    scale = cfg.attention_multiplier or 1.0 / math.sqrt(D)
    rep = Hq // Hk
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), v)
    return o.reshape(B, S, Hq * D) @ _f(p["w_o"])


def mamba2(cfg, p, x):
    """The Mamba-2 mixer over x (B, S, d), its recurrence step by step."""
    B, S, _ = x.shape
    H, P, N, G = (cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state,
                  cfg.mamba_n_groups)
    di = H * P
    zxbcdt = x @ _f(p["in_proj"])
    z, xbc, dt = zxbcdt.split([di, di + 2 * G * N, H], dim=-1)
    # causal depthwise conv: output t sees inputs t - k + 1 .. t
    w = _f(p["conv_w"])                                    # (k, C)
    k = w.shape[0]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[:, j:j + S] * w[j] for j in range(k))
    if "conv_b" in p:
        conv = conv + _f(p["conv_b"])
    xbc = F.silu(conv)
    xs = xbc[..., :di].reshape(B, S, H, P)
    bm = xbc[..., di:di + G * N].reshape(B, S, G, N)
    cm = xbc[..., di + G * N:].reshape(B, S, G, N)
    rep = H // G
    bm, cm = (t.repeat_interleave(rep, dim=2) for t in (bm, cm))
    delta = F.softplus(dt + _f(p["dt_bias"]))                  # (B, S, H)
    A = -torch.exp(_f(p["A_log"]))
    state = x.new_zeros((B, H, P, N))
    ys = []
    for t in range(S):
        dA = torch.exp(delta[:, t] * A)                         # (B, H)
        state = (state * dA[..., None, None]
                 + (delta[:, t, :, None] * xs[:, t])[..., None]
                 * bm[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cm[:, t])
                  + _f(p["D"])[:, None] * xs[:, t])
    y = torch.stack(ys, dim=1).reshape(B, S, di) * F.silu(z)
    yg = y.reshape(B, S, G, di // G)
    yg = yg / torch.sqrt(torch.mean(yg * yg, dim=-1, keepdim=True)
                         + cfg.norm_eps)
    y = yg.reshape(B, S, di) * (1.0 + _f(p["norm"]))
    return y @ _f(p["out_proj"])


def mlp(p, x):
    return (F.silu(x @ _f(p["w_gate"])) * (x @ _f(p["w_up"]))) @ _f(
        p["w_down"])


def forward(cfg, params, tokens):
    """fp32 logits (B, S, vocab) of tokens (B, S)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        table = _f(params["head"]["table"])
        x = table[tokens] * cfg.embedding_multiplier
        r = cfg.residual_multiplier
        kinds = cfg.layer_kinds()
        for kind, p in zip(kinds, params["layers"]):
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            if kind == "mamba2":
                x = x + r * mamba2(cfg, p["mamba"], h)
            elif kind == "attn":
                x = x + r * attention(cfg, p["attn"], h)
            else:
                raise ValueError(f"the plain hybrid takes mamba2 and attn "
                                 f"layers, not {kind!r}")
            if "mlp" in p:
                x = x + r * mlp(p["mlp"], rms_norm(x, p["norm2"],
                                                   cfg.norm_eps))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        unembed = (params["head"]["unembed"] if "unembed" in params["head"]
                   else params["head"]["table"].T)
        return (x @ _f(unembed)) / cfg.logits_scaling
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


__all__ = ["forward", "mamba2", "attention", "mlp", "rms_norm"]
