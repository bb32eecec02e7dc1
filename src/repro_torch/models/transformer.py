"""Decoder assembly — the port of ``repro.models.transformer`` for every
architecture of the reference: dense GQA transformers (optional SWA) over
stacked (``scan_layers=True``) layer params, their M-RoPE (Qwen2-VL) and
``embed_stub`` (precomputed embeddings: MusicGen, Qwen2-VL) variants, the
MoE FFN in place of the MLP (OLMoE; Arctic with its dense residual
branch), unrolled (``scan_layers=False``) stacks of local-attention and
RG-LRU blocks (RecurrentGemma), each with a gated MLP, and of mLSTM and
sLSTM blocks (xLSTM).

``loss_fn`` is the reference's next-token cross-entropy; training takes
its gradient by autograd through ``forward(mode="train")``, which writes
in place into no tensor that autograd saved (the rings are written only
with a cache, and the MoE dispatch's ``index_add_`` fills a fresh
buffer).  The remat policy and ``remat_group`` change what the backward
holds, not any value: they are accepted and ignored, and autograd keeps
every layer's activations (the reference's grouped branch runs only
without a cache, and gives the same values).

Layer params: with ``scan_layers`` the reference's layout, one dict whose
leaves are (L, ...) tensors; the port has no scan to trace, so the layers
are walked in order over views ``leaf[l]`` (``layer_view``), which copy
nothing.  Without it, a list of per-layer dicts.

Caches (plus a global ``idx`` (B,) int32 cursor):
  attn   -> {"k","v"} (B, T_cache, Hk*D) flattened kv, ring-buffered at
            ``window`` when the sliding window bounds it
  rglru  -> {"state" (B,W) fp32, "conv" (B,k-1,W)}
  mlstm  -> {"C" (B,H,dh,dh), "n" (B,H,dh), "m" (B,H)} fp32, dh = 2 d / H
  slstm  -> {"h","c","n","m"} (B,d) fp32
a list over the layers, or with ``scan_layers`` one dict of (L, B, ...)
tensors, as in the reference.

Which products run the ``mvm`` kernel and which run ``torch.matmul``:
``models.layers.common.project``.  On CUDA tensors the decode step runs
the ``mvm`` and ``decode_attention`` kernels and a prefill the
``rglru_scan`` kernel; on the CPU their plain versions.  The MoE router
and experts and the xLSTM recurrences have no kernel in the reference and
none here (``models.layers.moe``, ``models.layers.xlstm``).  Functions
are functional, as in the reference, with one exception that saves a
copy of every ring per layer and step: a prefill writes the prompt's keys
and values, and a decode step the new token's k/v slot, into the
attention rings of the cache it is given, in place, and returns those
same ring tensors — with stacked caches the (L, B, T, KV) tensors
themselves, each layer written through its view (the recurrent states
and the cursor come back as new tensors).  A caller that needs the cache as it
was clones it first.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import rglru as rglru_lib
from repro_torch.models.layers import xlstm as xlstm_lib
from repro_torch.models.layers.common import (current_mesh, dense_init,
                                              device_mesh, on_mesh,
                                              param_dtype, project,
                                              shard_act, split_last)
from repro_torch.models.layers.embedding import embed, init_embedding, unembed
from repro_torch.models.layers.mlp import apply_mlp, init_mlp
from repro_torch.models.layers.moe import apply_moe, init_moe
from repro_torch.models.layers.norm import init_norm, rms_norm
from repro_torch.models.layers.rope import (apply_rope, mrope_angles,
                                            rope_angles)
from repro_torch.sharding.partition import (axis_sizes, cache_shardings,
                                            distribute, is_dtensor)

NAIVE_ATTN_MAX_SEQ = 1024  # above this, blockwise/local paths engage
KINDS = ("attn", "rglru", "mlstm", "slstm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for an architecture or option the port does not carry yet."""
    if cfg.family == "rnn":
        raise ValueError(
            f"{cfg.name!r} is an rnn stack, not a decoder: run it through "
            "repro_torch.rnn.compile or serving.RecurrentServingEngine")
    bad = sorted(set(cfg.layer_kinds()) - set(KINDS))
    if bad:
        raise ValueError(f"unknown layer kinds {bad}; allowed: "
                         f"{', '.join(KINDS)}")
    if cfg.scan_layers and set(cfg.layer_kinds()) != {"attn"}:
        raise ValueError(f"{cfg.name!r}: stacked layers (scan_layers=True) "
                         "take one block kind, attention; other patterns "
                         "are unrolled")


def map_layers(fn, layers, *others):
    """``fn`` over the tensors of layer trees of one layout (a list of
    per-layer dicts, or a stacked dict of (L, ...) leaves), ``others``
    walked key by key beside ``layers``.  Returns the results in
    ``layers``' layout."""
    if isinstance(layers, dict):
        return {k: map_layers(fn, v, *(o[k] for o in others))
                for k, v in layers.items()}
    if isinstance(layers, list):
        return [map_layers(fn, v, *(o[i] for o in others))
                for i, v in enumerate(layers)]
    return fn(layers, *others)


def layer_view(layers, i):
    """Layer ``i`` (an int, or a slice of layers) of a parameter or cache
    tree: the list's entry, or of a stacked dict the same dict with every
    leaf's view ``leaf[i]`` (no copy: a write into the view is a write
    into the stacked tensor)."""
    if isinstance(layers, list):
        return layers[i]
    return map_layers(lambda t: t[i], layers)


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


def _init_layer(cfg: ModelConfig, gen, kind: str, dtype, device,
                experts=None):
    """One layer's tree; ``experts`` as ``moe.init_moe`` takes it."""
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": init_norm(d, dtype, device)}
    if kind == "attn":
        p["attn"] = _init_attn(cfg, gen, dtype, device)
    elif kind == "mlstm":
        p["mlstm"] = xlstm_lib.init_mlstm(gen, d, cfg.n_heads, dtype, device)
    elif kind == "slstm":
        p["slstm"] = xlstm_lib.init_slstm(gen, d, cfg.n_heads, dtype, device)
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
    if kind in ("attn", "rglru") and cfg.d_ff:
        p["norm2"] = init_norm(d, dtype, device)
        if cfg.n_experts:
            p["moe"] = init_moe(gen, d, cfg.d_ff, cfg.n_experts, dtype,
                                cfg.moe_dense_ff, device, experts)
        else:
            p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


def _stacked_experts(cfg: ModelConfig, dtype, device):
    """The stacked MoE expert leaves (L, E, d, ff) / (L, E, ff, d),
    allocated once and drawn into layer by layer and expert by expert
    (``moe.draw_experts``): an arctic layer's experts are 27 GB in bf16,
    so no layer of them is drawn whole and then copied."""
    L, E, d, ff = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    shapes = {"w_gate": (L, E, d, ff), "w_up": (L, E, d, ff),
              "w_down": (L, E, ff, d)}
    return {k: torch.empty(s, dtype=dtype, device=device)
            for k, s in shapes.items()}


def _stack_into(out, tree, i: int, n: int):
    """Copy ``tree``'s leaves into slice ``[i]`` of ``out``'s (n, ...)
    leaves, allocating them at the first layer (a leaf drawn in place,
    already ``out[i]`` itself, is left as it is); returns ``out``."""
    if isinstance(tree, dict):
        out = {} if out is None else out
        for k, v in tree.items():
            out[k] = _stack_into(out.get(k), v, i, n)
        return out
    if out is None:
        out = tree.new_empty((n,) + tuple(tree.shape))
    if tree.data_ptr() != out[i].data_ptr():
        out[i].copy_(tree)
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` (a seeded ``torch.Generator``)
    on the generator's device, stored on ``device`` (the generator's by
    default).  The reference's tree layout: {"final_norm", "head",
    "layers"}, the layers a list of per-layer dicts or, with
    ``scan_layers``, one dict of (L, ...) leaves; an ``embed_stub`` head is
    {"unembed"} alone.  So ``convert.from_jax`` carries a JAX
    ``init_params`` tree over one to one.  Stacked leaves are allocated
    once and layer l is drawn into slice [l], so the peak is the model and
    one layer, not two models; a stacked MoE's expert leaves are drawn
    straight into their slices, expert by expert (``_stacked_experts``)."""
    check_supported(cfg)
    device = gen.device if device is None else torch.device(device)
    dtype = param_dtype(cfg)
    params: Dict[str, Any] = {
        "final_norm": init_norm(cfg.d_model, dtype, device)}
    if cfg.embed_stub:
        params["head"] = {"unembed": dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype, device=device)}
    else:
        params["head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, cfg.tie_embeddings, device)
    kinds = cfg.layer_kinds()
    if not cfg.scan_layers:
        params["layers"] = [_init_layer(cfg, gen, kind, dtype, device)
                            for kind in kinds]
        return params
    stacked, experts = None, None
    if cfg.n_experts and cfg.d_ff:
        experts = _stacked_experts(cfg, dtype, device)
        stacked = {"moe": dict(experts)}
    for i, kind in enumerate(kinds):
        layer = _init_layer(cfg, gen, kind, dtype, device,
                            None if experts is None
                            else layer_view(experts, i))
        stacked = _stack_into(stacked, layer, i, len(kinds))
    params["layers"] = stacked
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
    if kind == "mlstm":
        dh = 2 * cfg.d_model // cfg.n_heads
        return xlstm_lib.mlstm_state_init(batch, cfg.n_heads, dh, device)
    if kind == "slstm":
        return xlstm_lib.slstm_state_init(batch, cfg.d_model, device)
    w = cfg.rglru_width
    return {
        "state": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                            device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cpu") -> Dict[str, Any]:
    """Zeroed caches for ``batch`` rows of up to ``seq_len`` positions:
    per-layer dicts in a list, or with ``scan_layers`` one dict of
    (L, B, ...) tensors (the attention rings (L, B, T, KV))."""
    check_supported(cfg)
    dtype = param_dtype(cfg)
    T = cache_len(cfg, seq_len)
    kinds = cfg.layer_kinds()
    if cfg.scan_layers:
        one = _init_layer_cache(cfg, kinds[0], batch, T, dtype, device)
        layers = {k: t.new_zeros((len(kinds),) + tuple(t.shape))
                  for k, t in one.items()}
    else:
        layers = [_init_layer_cache(cfg, k, batch, T, dtype, device)
                  for k in kinds]
    return {"layers": layers,
            "idx": torch.zeros((batch,), dtype=torch.int32, device=device)}


# ===========================================================================
# blocks
# ===========================================================================


def _rope_for(cfg: ModelConfig, positions):
    """cos/sin of ``positions``: (B, S), or with M-RoPE (3, B, S) — a
    (B, S) input (decode's ``idx[:, None]`` among them) is three equal
    streams."""
    if cfg.mrope_sections:
        if positions.dim() == 2:
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return mrope_angles(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _attn_block(cfg: ModelConfig, p, x, rope_cs, cache, idx, mode: str):
    """x (B,S,d).  Returns (out, new_cache)."""
    B, S, d = x.shape
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    decode = mode == "decode"
    q = split_last(project(x, p["w_q"], decode=decode), Hq, D)
    kv = project(x, p["w_kv"], decode=decode)
    k, v = kv.split(cfg.kv_dim, dim=-1)
    cos, sin = rope_cs
    q = apply_rope(q, cos, sin)
    k = apply_rope(split_last(k, Hk, D), cos, sin).reshape(B, S, Hk * D)

    new_cache = cache
    if decode:
        T = cache["k"].shape[1]
        ring = bool(cfg.window and cfg.window <= T)
        slot = (idx % T if ring else torch.clamp_max(idx, T - 1)).long()
        # the new slot is written into the given ring in place (module doc)
        # under a mesh each rank writes its slice; the rings keep the
        # layout cache_specs gave them (the reference's shard_act on them
        # names the same one), so they stay the tensors written in place
        if is_dtensor(cache["k"]):
            from repro_torch.sharding import local
            k_cache = local.ring_write(cache["k"], slot, k[:, 0])
            v_cache = local.ring_write(cache["v"], slot, v[:, 0])
        else:
            rows = torch.arange(B, device=x.device)
            k_cache = cache["k"].index_put_((rows, slot), k[:, 0])
            v_cache = cache["v"].index_put_((rows, slot), v[:, 0])
        new_cache = {"k": k_cache, "v": v_cache}
        valid = torch.clamp_max(idx + 1, T)  # number of live slots
        o = attn_lib.decode_attention(
            q, k_cache.reshape(B, T, Hk, D), v_cache.reshape(B, T, Hk, D),
            valid, window=0 if ring else cfg.window)
    else:
        k4 = split_last(k, Hk, D)
        v4 = split_last(v, Hk, D)
        k4, v4 = _repeat_kv_for_mesh(cfg, k4, v4)
        if cfg.window and S > cfg.window:
            o = attn_lib.local_attention(q, k4, v4, window=cfg.window)
        elif S > NAIVE_ATTN_MAX_SEQ:
            o = attn_lib.blockwise_attention(q, k4, v4)
        else:
            o = attn_lib.naive_attention(q, k4, v4, window=cfg.window)
        if mode == "prefill":  # into the given rings, as decode does
            for key, t in (("k", k), ("v", v)):
                if is_dtensor(cache[key]):  # each rank its slice
                    from repro_torch.sharding import local
                    t = t.full_tensor() if is_dtensor(t) else t
                    local.ring_fill(cache[key], _fill_ring(
                        t.new_empty(cache[key].shape), t))
                else:
                    _fill_ring(cache[key], t)
    o = shard_act(o.reshape(B, S, Hq * D), "batch", "seq", "qdim")
    return project(o, p["w_o"], decode=decode), new_cache


def _repeat_kv_for_mesh(cfg: ModelConfig, k4, v4):
    """Under a mesh whose model axis the kv heads do not divide (GQA's
    2-8 kv heads on a 16-way axis), the prefill's k and v repeated to
    Hk r heads, the smallest r with (Hk r) % model == 0 and Hq % (Hk r)
    == 0, so that every attention product is head-local; the grouping
    stays valid (query head h G + g still meets a copy of kv head h) and
    no value changes.  Without a mesh, or with no such r, as they are."""
    mesh = current_mesh()
    Hq, Hk = cfg.n_heads, cfg.n_kv_heads
    if mesh is None or Hk >= Hq:
        return k4, v4
    msize = axis_sizes(mesh).get("model", 1)
    if Hk % msize == 0:
        return k4, v4
    rep = next((r for r in range(2, Hq // Hk + 1)
                if (Hk * r) % msize == 0 and Hq % (Hk * r) == 0), None)
    if rep is None:
        return k4, v4
    return tuple(shard_act(torch.repeat_interleave(t, rep, dim=2), "batch",
                           "seq", "heads", None) for t in (k4, v4))


def _fill_ring(ring, t):
    """A prefill's keys or values t (B, S, KV) written into ring (B, T, KV)
    in place: the S positions then zeros when T >= S, else the last T
    positions at slot = pos % T.  Returns ring."""
    S, T = t.shape[1], ring.shape[1]
    if T >= S:
        ring[:, :S].copy_(t)
        ring[:, S:].zero_()
    else:
        ring.copy_(torch.roll(t[:, S - T:], (S - T) % T, dims=1))
    return ring


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
    """Pre-norm residual block.  Returns (x, new_cache, aux_loss): the MoE
    load-balancing loss of the layer, fp32 0 without MoE."""
    decode = mode == "decode"
    aux = on_mesh(torch.zeros((), dtype=torch.float32, device=x.device))
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "attn":
        o, new_cache = _attn_block(cfg, p["attn"], h, rope_cs, cache, idx,
                                   mode)
    elif kind == "rglru":
        o, new_cache = _rglru_block(cfg, p, h, cache, mode)
    elif kind == "mlstm":
        if decode:
            o, state = xlstm_lib.apply_mlstm(p["mlstm"], h, cfg.n_heads,
                                             cache, decode=True)
        else:  # chunkwise-parallel: the state touched once a chunk
            o, state = xlstm_lib.apply_mlstm_chunked(p["mlstm"], h,
                                                     cfg.n_heads, cache)
        new_cache = state if cache is not None else None
    else:
        o, state = xlstm_lib.apply_slstm(p["slstm"], h, cfg.n_heads, cache,
                                         decode=decode)
        new_cache = state if cache is not None else None
    x = x + o
    if "norm2" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if "moe" in p:
            cap = 0
            if decode:
                # the reference's decode capacity: drop-free at T <= 8
                # without sizing every expert's buffer at T
                T = h.shape[0] * h.shape[1]
                cf = max(4.0, cfg.capacity_factor)
                cap = min(T, max(8, math.ceil(
                    T * cfg.experts_per_token * cf / cfg.n_experts)))
            o, aux = apply_moe(p["moe"], h, k=cfg.experts_per_token,
                               capacity_factor=cfg.capacity_factor,
                               deterministic_capacity=cap, decode=decode)
        else:
            o = apply_mlp(p["mlp"], h, decode=decode)
        x = x + o
    x = shard_act(x, "batch", "seq", "embed")
    return x, new_cache, aux


# ===========================================================================
# forward
# ===========================================================================


def forward(cfg: ModelConfig, params, *, tokens=None, embeds=None,
            positions=None, cache=None, mode: str = "train"):
    """Returns (logits fp32, new_cache, aux_loss); aux_loss is the MoE
    load-balancing loss summed over the layers (fp32 0 without MoE).

    train/prefill: tokens (B,S) or embeds (B,S,d); "train" is the
    full-sequence forward without a cache, the one ``loss_fn``
    differentiates.
    decode: tokens (B,1) / embeds (B,1,d) + cache (required)."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode={mode!r} invalid; allowed: train, prefill, "
                         "decode")
    dtype = param_dtype(cfg)
    # under a mesh the inputs join the DTensor params (plain ones as
    # replicated); without one this changes nothing
    tokens, embeds, positions = (on_mesh(t) for t in (tokens, embeds,
                                                     positions))
    if embeds is None:
        x = embed(params["head"], tokens, dtype)
    else:
        x = embeds.to(dtype)
    B, S = x.shape[:2]
    x = shard_act(x, "batch", "seq", "embed")
    if mode != "train" and cache is None:
        raise ValueError(f"mode={mode!r} needs a cache")
    if mode == "decode" and S != 1:
        raise ValueError(f"decode takes one token per row, got S={S}")

    idx = cache["idx"] if cache is not None else None
    if positions is None:
        if mode == "decode":
            positions = idx[:, None]  # (B,1)
        else:
            positions = on_mesh(torch.arange(
                S, dtype=torch.int32, device=x.device))[None].expand(B, S)
    rope_cs = _rope_for(cfg, positions)

    # a stacked cache's layers are written through their views, in place
    caches = cache["layers"] if cache is not None else None
    new_layer_caches = caches if cfg.scan_layers else []
    aux_total = on_mesh(torch.zeros((), dtype=torch.float32,
                                    device=x.device))
    for i, kind in enumerate(cfg.layer_kinds()):
        cache_l = layer_view(caches, i) if cache is not None else None
        x, new_cache_l, aux = _layer_apply(cfg, kind,
                                           layer_view(params["layers"], i),
                                           x, rope_cs, cache_l, idx, mode)
        aux_total = aux_total + aux
        if not cfg.scan_layers:
            new_layer_caches.append(new_cache_l)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["head"], x)

    new_cache = None
    if cache is not None:
        step = 1 if mode == "decode" else S
        new_cache = {"layers": new_layer_caches, "idx": idx + step}
    return logits, new_cache, aux_total


# ===========================================================================
# step functions
# ===========================================================================


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token CE.  batch: {tokens|embeds, labels?}.  Returns (total,
    {"loss", "aux_loss"}): the mean negative log-likelihood in fp32 over
    ``log_softmax`` of the fp32 logits, of ``labels`` where the batch has
    them and of each next token otherwise, plus 0.01 x the MoE aux loss
    that ``forward`` sums (fp32 0 without MoE)."""
    tokens = batch.get("tokens")
    embeds = batch.get("embeds")
    logits, _, aux = forward(cfg, params, tokens=tokens, embeds=embeds,
                             positions=batch.get("positions"), mode="train")
    if "labels" in batch:
        labels = batch["labels"]
        tgt_logits = logits
    else:
        labels = tokens[:, 1:]
        tgt_logits = logits[:, :-1]
    logp = F.log_softmax(tgt_logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    loss = nll.mean()
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux}


def prefill(cfg: ModelConfig, params, batch, seq_len: int):
    """Full-sequence forward that also builds the cache."""
    tokens = batch.get("tokens")
    embeds = batch.get("embeds")
    src = tokens if tokens is not None else embeds
    cache = init_cache(cfg, src.shape[0], seq_len, device=src.device)
    mesh = device_mesh()
    if mesh is not None:  # the rings and states laid out by cache_specs
        cache = distribute(cache, cache_shardings(cache, mesh))
    logits, new_cache, _ = forward(cfg, params, tokens=tokens, embeds=embeds,
                                   positions=batch.get("positions"),
                                   cache=cache, mode="prefill")
    return logits, new_cache


def decode_step(cfg: ModelConfig, params, cache, batch):
    """One token for every sequence in the batch.  Returns (logits,
    new_cache).  The attention rings of ``cache`` are updated in place
    (the new slot is written into them, and new_cache holds the same ring
    tensors); new_cache's recurrent states (RG-LRU ``state`` and ``conv``,
    the mLSTM and sLSTM states) and ``idx`` are new tensors, and the ones
    in ``cache`` keep their values."""
    logits, new_cache, _ = forward(cfg, params, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"),
                                   positions=batch.get("positions"),
                                   cache=cache, mode="decode")
    return logits, new_cache


__all__ = ["NAIVE_ATTN_MAX_SEQ", "check_supported", "map_layers",
           "layer_view", "init_params", "cache_len", "init_cache", "forward",
           "loss_fn", "prefill", "decode_step"]
