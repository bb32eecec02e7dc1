"""The benchmark's plain reference of the Mamba-2 / attention hybrids: the
whole model's forward pass over one sequence in fp32 (TF32 off), from the
published equations (arXiv:2405.21060; Hugging Face ``granitemoehybrid``),
with plain torch operations.  It imports nothing of the program; it reads
the configuration's own keys and the weights in the program's tree as
``families/mamba_hybrid.py`` draws them (RMSNorm scales applied as 1 + s;
the conv weight (k, conv_dim); projections (in, out)).

    x = E[tokens] · embedding_multiplier
    x += residual_multiplier · mixer(RMSNorm(x))     Mamba-2 or attention
    x += residual_multiplier · MLP(RMSNorm(x))       SwiGLU
    logits = RMSNorm(x) · Eᵀ / logits_scaling

The SSM recurrence, per head h of group g, S_t = exp(delta_t A) S_(t-1)
+ delta_t x_t ⊗ B_t and y_t = S_t C_t + D x_t, runs in blocks of
``block`` steps (``ssm_blocks``): within a block the quadratic form
(each step's output from every earlier step of the block through the
products of their decays), between blocks the state carried, so that a
5,120-token sequence fits and runs in time on the card; ``ssm_steps`` is
the same recurrence step by step, which the CPU tests hold the block form
to.  Attention is causal GQA with no positional encoding ("nope"), its
softmax scale ``attention_multiplier``, in blocks of queries.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: steps of one block of the SSM, queries of one block of attention
BLOCK = 128
QUERIES = 512


def _f(t):
    return t.float()


def rms_norm(x, scale, eps):
    return x / torch.sqrt(torch.mean(x * x, -1, keepdim=True) + eps) * (
        1.0 + _f(scale))


def segsum(x):
    """x (..., Q) -> (..., Q, Q): entry (i, j) the sum of x over (j, i] for
    j <= i, -inf above the diagonal, as a cumulative sum of masked
    copies."""
    Q = x.shape[-1]
    xs = x[..., None].expand(*x.shape, Q)
    ones = torch.ones(Q, Q, dtype=torch.bool, device=x.device)
    xs = xs.masked_fill(~torch.tril(ones, -1), 0.0)
    return torch.cumsum(xs, -2).masked_fill(~torch.tril(ones), float("-inf"))


def ssm_steps(xs, delta, A, bh, ch):
    """The recurrence step by step: xs (S, H, P), delta (S, H), A (H,),
    bh, ch (S, H, N) -> y (S, H, P) without D x."""
    S, H, P = xs.shape
    state = xs.new_zeros((H, P, bh.shape[-1]))
    ys = []
    for t in range(S):
        state = (state * torch.exp(delta[t] * A)[:, None, None]
                 + (delta[t][:, None] * xs[t])[..., None] * bh[t][:, None])
        ys.append(torch.einsum("hpn,hn->hp", state, ch[t]))
    return torch.stack(ys)


def ssm_blocks(xs, delta, A, bh, ch, block: int = BLOCK):
    """The same recurrence in blocks of ``block`` steps (module doc)."""
    S, H, P = xs.shape
    state = xs.new_zeros((H, P, bh.shape[-1]))
    ys = []
    for s0 in range(0, S, block):
        sl = slice(s0, min(S, s0 + block))
        dA = (delta[sl] * A).T                              # (H, Q)
        decay = torch.exp(segsum(dA))                       # (H, Q, Q)
        xd = xs[sl] * delta[sl][..., None]                  # (Q, H, P)
        from_start = torch.exp(torch.cumsum(dA, -1))        # (H, Q)
        cb = torch.einsum("ihn,jhn->hij", ch[sl], bh[sl])
        y = torch.einsum("hij,jhp->ihp", cb * decay, xd)
        y = y + (torch.einsum("ihn,hpn->ihp", ch[sl], state)
                 * from_start.T[..., None])
        # the state at the block's end: the carried one decayed over the
        # block, plus each step's input decayed over the steps after it
        state = (state * from_start[:, -1, None, None]
                 + torch.einsum("jhn,hj,jhp->hpn", bh[sl], decay[:, -1], xd))
        ys.append(y)
    return torch.cat(ys)


def mamba(cfg, p, x, block):
    """The Mamba-2 mixer over x (S, d)."""
    S = x.shape[0]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    G, N = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    di = H * P
    z, xbc, dt = (x @ _f(p["in_proj"])).split([di, di + 2 * G * N, H], -1)
    w = _f(p["conv_w"])
    k = w.shape[0]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[j:j + S] * w[j] for j in range(k))
    if "conv_b" in p:
        conv = conv + _f(p["conv_b"])
    xbc = F.silu(conv)
    xs = xbc[:, :di].reshape(S, H, P)
    rep = H // G
    bh = xbc[:, di:di + G * N].reshape(S, G, N).repeat_interleave(rep, 1)
    ch = xbc[:, di + G * N:].reshape(S, G, N).repeat_interleave(rep, 1)
    delta = F.softplus(dt + _f(p["dt_bias"]))
    A = -torch.exp(_f(p["A_log"]))
    y = (ssm_steps(xs, delta, A, bh, ch) if block == 1
         else ssm_blocks(xs, delta, A, bh, ch, block))
    y = (y + _f(p["D"])[:, None] * xs).reshape(S, di) * F.silu(z)
    yg = y.reshape(S, G, di // G)
    yg = yg / torch.sqrt(torch.mean(yg * yg, -1, keepdim=True)
                         + cfg["rms_norm_eps"])
    return (yg.reshape(S, di) * (1.0 + _f(p["norm"]))) @ _f(p["out_proj"])


def attention(cfg, p, x):
    """Causal GQA with no positional encoding over x (S, d)."""
    S, d = x.shape
    Hq, Hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim") or d // Hq
    if cfg["position_embedding_type"] != "nope":
        raise ValueError("the hybrid reference takes position_embedding_type "
                         "'nope' only")
    q = (x @ _f(p["w_q"])).reshape(S, Hq, D)
    k, v = (x @ _f(p["w_kv"])).reshape(S, 2, Hk, D).unbind(1)
    k = k.repeat_interleave(Hq // Hk, 1)
    v = v.repeat_interleave(Hq // Hk, 1)
    scale = cfg["attention_multiplier"]
    pos = torch.arange(S, device=x.device)
    out = []
    for q0 in range(0, S, QUERIES):
        qs = q[q0:q0 + QUERIES]
        s = torch.einsum("ihd,jhd->hij", qs, k) * scale
        s = s.masked_fill(pos[None, None, :] > (q0 + pos[:len(qs)])[None, :,
                                                                    None],
                          float("-inf"))
        out.append(torch.einsum("hij,jhd->ihd", torch.softmax(s, -1), v))
    return torch.cat(out).reshape(S, Hq * D) @ _f(p["w_o"])


def logits(cfg, params, tokens, first: int = 0, block: int = BLOCK):
    """fp32 logits (S - first, vocab) of the sequence ``tokens`` (S,), at
    positions first .. S - 1."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
        table = params["head"]["table"]
        x = _f(table[tokens]) * cfg["embedding_multiplier"]
        types = cfg["layer_types"][:cfg["num_hidden_layers"]]
        for kind, p in zip(types, params["layers"]):
            h = rms_norm(x, p["norm1"], eps)
            x = x + r * (mamba(cfg, p["mamba"], h, block) if kind == "mamba"
                         else attention(cfg, p["attn"], h))
            m = p["mlp"]
            h = rms_norm(x, p["norm2"], eps)
            x = x + r * ((F.silu(h @ _f(m["w_gate"])) * (h @ _f(m["w_up"])))
                         @ _f(m["w_down"]))
        x = rms_norm(x[first:], params["final_norm"], eps)
        return (x @ _f(table).T) / cfg["logits_scaling"]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
