"""Mamba-2 block (the SSD layer of Dao & Gu, arXiv:2405.21060), as the
granite-4.0-h hybrids use it (Hugging Face ``granitemoehybrid``).  The
JAX package has no counterpart: this block is the port's own.

For an input x (B, L, d), with H heads of P channels, G groups of B and
C of width N, and d_inner = H P:

    z, xBC, dt = split(x · in_proj)              (d_inner, d_inner + 2 G N, H)
    xBC = silu(causal depthwise conv_k(xBC) + conv_b)
    x, B, C = split(xBC)                          (H P, G N, G N)
    delta = softplus(dt + dt_bias),  A = -exp(A_log)
    per head h (group g):  S_t = exp(delta_t A) S_(t-1) + delta_t x_t ⊗ B_t
                           y_t = S_t C_t + D x_t
    out = RMSNorm_G(y · silu(z)) · out_proj

RMSNorm_G normalises each of the G groups of d_inner / G channels (the
``mamba_ssm`` gated norm; Hugging Face's granite code normalises all of
d_inner, the same at G = 1, granite's value).  Its scale is stored as s
and applied as 1 + s, the port's RMSNorm convention (a published weight
w is held as w - 1).  The conv weight is (k, conv_dim) (Hugging Face's
``conv1d.weight`` (conv_dim, 1, k) transposed); in_proj and out_proj are
(in, out) as every projection of the port.

Numbers: the projections run in the model's dtype with fp32
accumulation (``common.project``: decode through ``mvm``); the conv, the
recurrence, the gate and the norm run in fp32 from the projection's
rounded output, and the norm's output is rounded once to the model's
dtype.  A prefill runs the chunked (SSD) form in torch operations: within
a chunk of ``mamba_chunk_size`` steps the quadratic form, between chunks
the state carried (``ssd_chunked``), from the cache's state; a decode
step runs the conv step and the state update
(``kernels.ssm.ssm_update``: the kernel on the card, its plain version on
the CPU).  Both write the final state and the conv state (the last k - 1
xBC inputs) into the cache they are given, in place, and return those
same tensors; both states are fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm.ops import ssm_update
from repro_torch.models.layers.common import dense_init, project
from repro_torch.models.layers.norm import init_norm
from repro_torch.runtime.obs import active_tracer

#: the ranges Mamba-2's reference init draws A and the step size from
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)
DT_FLOOR = 1e-4


def init_mamba2(gen: torch.Generator, cfg, dtype, device="cpu"):
    """One block's parameters drawn from ``gen``: in_proj and out_proj
    fan-in truncated normals; the conv uniform within 1 / sqrt(k) (a
    depthwise ``nn.Conv1d``'s default); A = -exp(A_log) with A uniform in
    A_RANGE; dt_bias the inverse softplus of a step log-uniform in
    DT_RANGE; D ones; the norm's s zeros.  A_log, dt_bias and D are fp32."""
    d, H = cfg.d_model, cfg.mamba_n_heads
    di, c, k = cfg.mamba_d_inner, cfg.mamba_conv_dim, cfg.mamba_d_conv
    g = gen.device
    bound = 1.0 / math.sqrt(k)
    conv_w = torch.empty((k, c), device=g).uniform_(-bound, bound,
                                                    generator=gen)
    a = torch.empty((H,), device=g).uniform_(*A_RANGE, generator=gen)
    lo, hi = (math.log(v) for v in DT_RANGE)
    dt = torch.exp(torch.empty((H,), device=g).uniform_(lo, hi,
                                                        generator=gen))
    dt = torch.clamp_min(dt, DT_FLOOR)
    p = {
        "in_proj": dense_init(gen, (d, di + c + H), dtype, device=device),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(device),
        "A_log": torch.log(a).to(device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "norm": init_norm(di, dtype, device),
        "out_proj": dense_init(gen, (di, d), dtype, device=device),
    }
    if cfg.mamba_conv_bias:
        p["conv_b"] = torch.empty((c,), device=g).uniform_(
            -bound, bound, generator=gen).to(device=device, dtype=dtype)
    return p


def init_cache(cfg, batch: int, device="cpu"):
    """A block's zeroed decode state: ``ssm`` (B, H, P, N) and ``conv``
    (B, k - 1, conv_dim), both fp32."""
    return {
        "ssm": torch.zeros((batch, cfg.mamba_n_heads, cfg.mamba_d_head,
                            cfg.mamba_d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.mamba_conv_dim),
                            dtype=torch.float32, device=device),
    }


def causal_conv(params, xbc, conv_state):
    """xbc (B, L, C) through the causal depthwise conv (and its bias) and
    SiLU, in fp32, after the k - 1 inputs of ``conv_state`` (B, k-1, C)
    (zeros without one).  Returns (the conv's output (B, L, C) fp32, the
    window (B, L + k - 1, C) whose last k - 1 rows are the next state).
    Taps are summed in order 0 .. k - 1, then the bias."""
    B, L, C = xbc.shape
    w = params["conv_w"].float()
    k = w.shape[0]
    if conv_state is None:
        conv_state = xbc.new_zeros((B, k - 1, C), dtype=torch.float32)
    win = torch.cat([conv_state.float(), xbc.float()], dim=1)
    acc = win[:, 0:L] * w[0]
    for j in range(1, k):
        acc = acc + win[:, j:j + L] * w[j]
    if "conv_b" in params:
        acc = acc + params["conv_b"].float()
    return F.silu(acc), win


def segsum(x):
    """x (..., Q) -> (..., Q, Q): entry (i, j) the sum of x over (j, i]
    for j <= i, -inf above the diagonal (the stable form: a cumulative sum
    of masked copies, not a difference of two cumulative sums)."""
    Q = x.shape[-1]
    xs = x[..., None].expand(*x.shape, Q)  # [..., i, j] = x_i
    strict = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device),
                        -1)
    xs = xs.masked_fill(~strict, 0.0)
    out = torch.cumsum(xs, dim=-2)
    lower = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    return out.masked_fill(~lower, float("-inf"))


def ssd_chunked(x, delta, A, bm, cm, chunk: int, s0=None):
    """The recurrence over a whole sequence in the chunked (SSD) form, all
    fp32: x (B, L, H, P), delta (B, L, H), A (H,), bm and cm (B, L, G, N),
    s0 (B, H, P, N) or None (zeros).  Returns (y (B, L, H, P) without the
    D x skip, the state after step L).  L is padded with steps of delta 0
    and x 0 (which leave the state as it is) to a multiple of ``chunk``."""
    Bsz, L, H, P = x.shape
    G, N = bm.shape[2], bm.shape[3]
    rep = H // G
    pad = (-L) % chunk
    if pad:
        x, delta, bm, cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                            for t in (x, delta, bm, cm))
    c = x.shape[1] // chunk
    dA = (delta * A).reshape(Bsz, c, chunk, H).permute(0, 3, 1, 2)
    xd = (x * delta[..., None]).reshape(Bsz, c, chunk, H, P)
    bh = bm.repeat_interleave(rep, dim=2).reshape(Bsz, c, chunk, H, N)
    ch = cm.repeat_interleave(rep, dim=2).reshape(Bsz, c, chunk, H, N)
    a_cs = torch.cumsum(dA, dim=-1)                      # (B, H, c, Q)
    # within each chunk: the quadratic form
    decay = torch.exp(segsum(dA))                        # (B, H, c, Q, Q)
    cb = torch.einsum("bclhn,bcshn->bhcls", ch, bh)
    y = torch.einsum("bhcls,bcshp->bclhp", cb * decay, xd)
    # each chunk's own contribution to the state at its end
    to_end = torch.exp(a_cs[..., -1:] - a_cs)            # (B, H, c, Q)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bh, to_end, xd)
    # the state carried from chunk to chunk
    if s0 is None:
        s0 = x.new_zeros((Bsz, H, P, N))
    states = torch.cat([s0.float()[:, None], states], dim=1)
    carry = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))  # (B,H,c+1,c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)
    # the carried state's part of each step's output
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", ch, states[:, :-1],
                         torch.exp(a_cs))
    return y.reshape(Bsz, c * chunk, H, P)[:, :L], states[:, -1]


def gated_norm(y, z, scale, groups: int, eps: float):
    """RMSNorm over each of ``groups`` groups of y · silu(z), in fp32, times
    1 + scale; y, z (..., d_inner).  Returns fp32."""
    h = y.float() * F.silu(z.float())
    lead, di = h.shape[:-1], h.shape[-1]
    hg = h.reshape(*lead, groups, di // groups)
    var = torch.mean(torch.square(hg), dim=-1, keepdim=True)
    hg = hg * torch.reciprocal(torch.sqrt(var + eps))
    return hg.reshape(*lead, di) * (1.0 + scale.float())


def apply_mamba2(cfg, params, x, cache, mode: str):
    """The block on x (B, L, d).  ``mode`` "train" (no cache), "prefill"
    (from the cache's state, which it overwrites in place) or "decode"
    (L = 1: the conv step and ``ssm_update``, in place).  Returns (out
    (B, L, d) in x's dtype, the cache: the same tensors, or None)."""
    decode = mode == "decode"
    B, L, _ = x.shape
    H, P, N, G = (cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state,
                  cfg.mamba_n_groups)
    di, c = cfg.mamba_d_inner, cfg.mamba_conv_dim
    zxbcdt = project(x, params["in_proj"], decode=decode)
    z, xbc, dt = zxbcdt.split([di, c, H], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, win = causal_conv(params, xbc, conv_state)
    A = -torch.exp(params["A_log"].float())
    if decode:
        y = ssm_update(cache["ssm"], xbc[:, 0], dt[:, 0], params["dt_bias"],
                       A, params["D"], heads=H, head_dim=P, groups=G,
                       d_state=N)[:, None]
    else:
        xs = xbc[..., :di].reshape(B, L, H, P)
        bm = xbc[..., di:di + G * N].reshape(B, L, G, N)
        cm = xbc[..., di + G * N:].reshape(B, L, G, N)
        delta = F.softplus(dt.float() + params["dt_bias"].float())
        chunk = cfg.mamba_chunk_size
        with active_tracer().span("mamba2.prefill", chunks=-(-L // chunk),
                                  tokens=L):
            y, s_end = ssd_chunked(xs, delta, A, bm, cm, chunk,
                                   None if cache is None else cache["ssm"])
        y = y + params["D"].float()[:, None] * xs
        if cache is not None:
            cache["ssm"].copy_(s_end)
    if cache is not None:
        cache["conv"].copy_(win[:, L:])
    h = gated_norm(y.reshape(B, L, di), z, params["norm"], G, cfg.norm_eps)
    out = project(h.to(x.dtype), params["out_proj"], decode=decode)
    return out, cache


__all__ = ["init_mamba2", "init_cache", "causal_conv", "segsum",
           "ssd_chunked", "gated_norm", "apply_mamba2"]
