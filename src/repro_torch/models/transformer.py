"""Decoder assembly — the port of ``repro.models.transformer`` for the
architectures the port carries: unrolled (``scan_layers=False``) stacks of
local-attention and RG-LRU blocks with a gated MLP, i.e. RecurrentGemma.

What the reference also covers raises ``NotImplementedError`` naming its
entry in ROADMAP.md's 'Queued in the port' list: stacked
(``scan_layers=True``) layer params (P6), the MoE FFN (P7), mLSTM/sLSTM
blocks (P8), M-RoPE (P9), the ``embed_stub`` frontends (P10), and
``loss_fn`` with everything else of training (P11).  The remat policy
only matters when gradients are taken: it is accepted and ignored.

Caches (per layer, a list over the stack, plus a global cursor):
  attn   -> {"k","v"} (B, T_cache, Hk*D) flattened kv, ring-buffered at
            ``window`` when the sliding window bounds it
  rglru  -> {"state" (B,W) fp32, "conv" (B,k-1,W)}
  idx    -> (B,) int32

Which products run the ``mvm`` kernel and which run ``torch.matmul``:
``models.layers.common.project``.  On CUDA tensors the decode step runs
the ``mvm`` and ``decode_attention`` kernels and a prefill the
``rglru_scan`` kernel; on the CPU their plain versions.  Functions are
functional, as in the reference, with one exception that saves a copy of
every ring per layer and step: a decode step writes the new token's k/v
slot into the attention rings of the cache it is given, in place, and
returns those same ring tensors (the RG-LRU state, the conv state and the
cursor come back as new tensors).  A caller that needs the cache as it was
clones it first.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import rglru as rglru_lib
from repro_torch.models.layers.common import dense_init, param_dtype, project
from repro_torch.models.layers.embedding import embed, init_embedding, unembed
from repro_torch.models.layers.mlp import apply_mlp, init_mlp
from repro_torch.models.layers.norm import init_norm, rms_norm
from repro_torch.models.layers.rope import apply_rope, rope_angles
from repro_torch.runtime.errors import not_ported

NAIVE_ATTN_MAX_SEQ = 1024  # above this, blockwise/local paths engage
KINDS = ("attn", "rglru")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for an architecture or option the port does not carry yet."""
    if cfg.family == "rnn":
        raise ValueError(
            f"{cfg.name!r} is an rnn stack, not a decoder: run it through "
            "repro_torch.rnn.compile or serving.RecurrentServingEngine")
    if cfg.scan_layers:
        raise not_ported("stacked layer params (scan_layers=True)", "P6")
    if cfg.n_experts:
        raise not_ported("the MoE FFN", "P7")
    if any(k in ("mlstm", "slstm") for k in cfg.layer_kinds()):
        raise not_ported("mLSTM/sLSTM blocks", "P8")
    if cfg.mrope_sections:
        raise not_ported("M-RoPE", "P9")
    if cfg.embed_stub:
        raise not_ported("stub frontends (embed_stub)", "P10")
    bad = sorted(set(cfg.layer_kinds()) - set(KINDS))
    if bad:
        raise ValueError(f"unknown layer kinds {bad}; allowed: "
                         f"{', '.join(KINDS)}")


# ===========================================================================
# init
# ===========================================================================


def _init_attn(cfg: ModelConfig, gen, dtype, device):
    d = cfg.d_model
    return {
        "w_q": dense_init(gen, (d, cfg.q_dim), dtype, device=device),
        "w_kv": dense_init(gen, (d, 2 * cfg.kv_dim), dtype, device=device),
        "w_o": dense_init(gen, (cfg.q_dim, d), dtype, device=device),
    }


def _init_layer(cfg: ModelConfig, gen, kind: str, dtype, device):
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": init_norm(d, dtype, device)}
    if kind == "attn":
        p["attn"] = _init_attn(cfg, gen, dtype, device)
    else:
        w = cfg.rglru_width
        p["rec"] = {
            "w_in": dense_init(gen, (d, w), dtype, device=device),
            "w_gate": dense_init(gen, (d, w), dtype, device=device),
            "conv": rglru_lib.init_conv1d(gen, w, cfg.conv1d_width, dtype,
                                          device),
            "rglru": rglru_lib.init_rglru(gen, w, dtype, device),
            "w_out": dense_init(gen, (w, d), dtype, device=device),
        }
    if cfg.d_ff:
        p["norm2"] = init_norm(d, dtype, device)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` (a seeded ``torch.Generator``)
    on the generator's device, stored on ``device`` (the generator's by
    default).  The reference's tree layout: {"final_norm", "head",
    "layers": [per-layer dicts]}, so ``convert.from_jax`` carries a JAX
    ``init_params`` tree over one to one."""
    check_supported(cfg)
    device = gen.device if device is None else torch.device(device)
    dtype = param_dtype(cfg)
    params: Dict[str, Any] = {
        "final_norm": init_norm(cfg.d_model, dtype, device),
        "head": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype,
                               cfg.tie_embeddings, device),
    }
    params["layers"] = [_init_layer(cfg, gen, kind, dtype, device)
                        for kind in cfg.layer_kinds()]
    return params


# ===========================================================================
# caches
# ===========================================================================


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """SWA bounds the live KV working set to a ring of ``window`` slots."""
    if cfg.window and cfg.window < seq_len:
        return cfg.window
    return seq_len


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, T: int, dtype,
                      device):
    if kind == "attn":
        kv = cfg.kv_dim
        return {"k": torch.zeros((batch, T, kv), dtype=dtype, device=device),
                "v": torch.zeros((batch, T, kv), dtype=dtype, device=device)}
    w = cfg.rglru_width
    return {
        "state": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                            device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cpu") -> Dict[str, Any]:
    check_supported(cfg)
    dtype = param_dtype(cfg)
    T = cache_len(cfg, seq_len)
    layers = [_init_layer_cache(cfg, k, batch, T, dtype, device)
              for k in cfg.layer_kinds()]
    return {"layers": layers,
            "idx": torch.zeros((batch,), dtype=torch.int32, device=device)}


# ===========================================================================
# blocks
# ===========================================================================


def _attn_block(cfg: ModelConfig, p, x, rope_cs, cache, idx, mode: str):
    """x (B,S,d).  Returns (out, new_cache)."""
    B, S, d = x.shape
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    decode = mode == "decode"
    q = project(x, p["w_q"], decode=decode).reshape(B, S, Hq, D)
    kv = project(x, p["w_kv"], decode=decode)
    k, v = kv.split(cfg.kv_dim, dim=-1)
    cos, sin = rope_cs
    q = apply_rope(q, cos, sin)
    k = apply_rope(k.reshape(B, S, Hk, D), cos, sin).reshape(B, S, Hk * D)

    new_cache = cache
    if decode:
        T = cache["k"].shape[1]
        ring = bool(cfg.window and cfg.window <= T)
        slot = (idx % T if ring else torch.clamp_max(idx, T - 1)).long()
        rows = torch.arange(B, device=x.device)
        # the new slot is written into the given ring in place (module doc)
        k_cache = cache["k"].index_put_((rows, slot), k[:, 0])
        v_cache = cache["v"].index_put_((rows, slot), v[:, 0])
        new_cache = {"k": k_cache, "v": v_cache}
        valid = torch.clamp_max(idx + 1, T)  # number of live slots
        o = attn_lib.decode_attention(
            q, k_cache.reshape(B, T, Hk, D), v_cache.reshape(B, T, Hk, D),
            valid, window=0 if ring else cfg.window)
    else:
        k4 = k.reshape(B, S, Hk, D)
        v4 = v.reshape(B, S, Hk, D)
        if cfg.window and S > cfg.window:
            o = attn_lib.local_attention(q, k4, v4, window=cfg.window)
        elif S > NAIVE_ATTN_MAX_SEQ:
            o = attn_lib.blockwise_attention(q, k4, v4)
        else:
            o = attn_lib.naive_attention(q, k4, v4, window=cfg.window)
        if mode == "prefill":
            T = cache["k"].shape[1]
            if T >= S:
                new_cache = {"k": F.pad(k, (0, 0, 0, T - S)),
                             "v": F.pad(v, (0, 0, 0, T - S))}
            else:  # ring: keep the last T positions at slot = pos % T
                shift = (S - T) % T
                new_cache = {"k": torch.roll(k[:, S - T:], shift, dims=1),
                             "v": torch.roll(v[:, S - T:], shift, dims=1)}
    o = o.reshape(B, S, Hq * D)
    return project(o, p["w_o"], decode=decode), new_cache


def _rglru_block(cfg: ModelConfig, p, x, cache, mode: str):
    decode = mode == "decode"
    r = p["rec"]
    # jax.nn.gelu is the tanh approximation by default
    gate = F.gelu(project(x, r["w_gate"], decode=decode).float(),
                  approximate="tanh").to(x.dtype)
    h = project(x, r["w_in"], decode=decode)
    conv_state = cache["conv"] if cache is not None else None
    h, new_conv = rglru_lib.apply_conv1d(r["conv"], h, conv_state)
    h0 = cache["state"] if cache is not None else None
    if decode:
        y, new_state = rglru_lib.decode_step(r["rglru"], h[:, 0], h0)
        y = y[:, None, :]
    else:
        y, new_state = rglru_lib.apply_rglru(r["rglru"], h, h0)
    y = y * gate
    out = project(y, r["w_out"], decode=decode)
    new_cache = None
    if cache is not None:
        new_cache = {"state": new_state, "conv": new_conv}
    return out, new_cache


def _layer_apply(cfg: ModelConfig, kind: str, p, x, rope_cs, cache, idx,
                 mode: str):
    """Pre-norm residual block.  Returns (x, new_cache); the reference's
    third value, the MoE aux loss, is 0 without MoE (P7)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "attn":
        o, new_cache = _attn_block(cfg, p["attn"], h, rope_cs, cache, idx,
                                   mode)
    else:
        o, new_cache = _rglru_block(cfg, p, h, cache, mode)
    x = x + o
    if "norm2" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + apply_mlp(p["mlp"], h, decode=mode == "decode")
    return x, new_cache


# ===========================================================================
# forward
# ===========================================================================


def forward(cfg: ModelConfig, params, *, tokens=None, embeds=None,
            positions=None, cache=None, mode: str = "train"):
    """Returns (logits fp32, new_cache, aux_loss); aux_loss is the MoE
    load-balancing loss of the reference, 0 here (no MoE, P7).

    train/prefill: tokens (B,S) or embeds (B,S,d); "train" is the
    full-sequence forward without a cache (no gradients are taken here).
    decode: tokens (B,1) / embeds (B,1,d) + cache (required)."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode={mode!r} invalid; allowed: train, prefill, "
                         "decode")
    dtype = param_dtype(cfg)
    if embeds is None:
        x = embed(params["head"], tokens, dtype)
    else:
        x = embeds.to(dtype)
    B, S = x.shape[:2]
    if mode != "train" and cache is None:
        raise ValueError(f"mode={mode!r} needs a cache")
    if mode == "decode" and S != 1:
        raise ValueError(f"decode takes one token per row, got S={S}")

    idx = cache["idx"] if cache is not None else None
    if positions is None:
        if mode == "decode":
            positions = idx[:, None]  # (B,1)
        else:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device)[None].expand(B, S)
    rope_cs = rope_angles(positions, cfg.head_dim, cfg.rope_theta)

    new_layer_caches = []
    for i, kind in enumerate(cfg.layer_kinds()):
        cache_l = cache["layers"][i] if cache is not None else None
        x, new_cache_l = _layer_apply(cfg, kind, params["layers"][i], x,
                                      rope_cs, cache_l, idx, mode)
        new_layer_caches.append(new_cache_l)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["head"], x)

    new_cache = None
    if cache is not None:
        step = 1 if mode == "decode" else S
        new_cache = {"layers": new_layer_caches, "idx": idx + step}
    return logits, new_cache, torch.zeros((), dtype=torch.float32,
                                          device=x.device)


# ===========================================================================
# step functions
# ===========================================================================


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token cross-entropy: training is not ported yet."""
    raise not_ported("training (loss_fn, optim/, checkpoint/, data/)", "P11")


def prefill(cfg: ModelConfig, params, batch, seq_len: int):
    """Full-sequence forward that also builds the cache."""
    tokens = batch.get("tokens")
    embeds = batch.get("embeds")
    src = tokens if tokens is not None else embeds
    cache = init_cache(cfg, src.shape[0], seq_len, device=src.device)
    logits, new_cache, _ = forward(cfg, params, tokens=tokens, embeds=embeds,
                                   positions=batch.get("positions"),
                                   cache=cache, mode="prefill")
    return logits, new_cache


def decode_step(cfg: ModelConfig, params, cache, batch):
    """One token for every sequence in the batch.  Returns (logits,
    new_cache).  The attention rings of ``cache`` are updated in place
    (the new slot is written into them, and new_cache holds the same ring
    tensors); new_cache's RG-LRU ``state``, ``conv`` state and ``idx`` are
    new tensors, and the ones in ``cache`` keep their values."""
    logits, new_cache, _ = forward(cfg, params, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"),
                                   positions=batch.get("positions"),
                                   cache=cache, mode="decode")
    return logits, new_cache


__all__ = ["NAIVE_ATTN_MAX_SEQ", "check_supported", "init_params",
           "cache_len", "init_cache", "forward", "loss_fn", "prefill",
           "decode_step"]
