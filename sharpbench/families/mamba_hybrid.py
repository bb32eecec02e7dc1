"""The Mamba-2 / attention hybrids (granite-4.0-h): a configuration's
``layer_types`` of "mamba" and "attention" layers, each with a SwiGLU MLP,
tied embeddings, in the Hugging Face config's own keys.  Drawn and
counted by the benchmark's own rules; its plain reference is
``families/mamba_hybrid_reference.py``.

Work of one token (``flops_per_item``): 2 FLOPs a weight of every
projection and of the unembedding (the model FLOPs that ``mfu`` reads),
and the SSM's 4 H P N a Mamba-2 layer (the decay and the outer product
into the state, and y = S C).  A decode call adds its attention over the
live slots, 4 Hq D a slot and attention layer.

Bytes of a decode call (``call_work``: the batched tick, kind "decode",
or a batch-1 remainder step of a bucketed prefill, kind "remainder"),
each counted once: every weight in the type it is bound in (the tied
table once, for the unembedding); each row's SSM and conv state read and
written; the live keys and values read and the new ones written; the
tokens read and the fp32 logits written.
"""
from __future__ import annotations

import math

import torch

from sharpbench import generate

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BYTES = {"float32": 4, "bfloat16": 2}
KINDS = {"mamba": "mamba2", "attention": "attn"}
#: every drawn tensor starts on a multiple of this many elements, so that
#: each is 16-byte aligned (the kernels' operand rule) in any weight type
ALIGN = 64


def dims(cfg: dict) -> dict:
    """The sizes the counts and the draw read, by short names."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    G, N = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    return dict(d=d, ff=cfg["intermediate_size"], V=cfg["vocab_size"],
                Hq=heads, Hk=cfg["num_key_value_heads"],
                D=cfg.get("head_dim") or d // heads, H=H, P=P, G=G, N=N,
                k=cfg["mamba_d_conv"], di=H * P, conv=H * P + 2 * G * N)


def kinds(cfg: dict) -> list:
    return [KINDS[t] for t in cfg["layer_types"][:cfg["num_hidden_layers"]]]


def mamba_layers(cfg: dict) -> int:
    return kinds(cfg).count("mamba2")


def matrices(cfg: dict):
    """(path, shape, fan-in) of every projection, in the program's tree."""
    m = dims(cfg)
    d, ff = m["d"], m["ff"]
    out = []
    for l, kind in enumerate(kinds(cfg)):
        pre = ("layers", l)
        if kind == "mamba2":
            out += [(pre + ("mamba", "in_proj"), (d, m["di"] + m["conv"]
                                                  + m["H"])),
                    (pre + ("mamba", "out_proj"), (m["di"], d))]
        else:
            q, kv = m["Hq"] * m["D"], m["Hk"] * m["D"]
            out += [(pre + ("attn", "w_q"), (d, q)),
                    (pre + ("attn", "w_kv"), (d, 2 * kv)),
                    (pre + ("attn", "w_o"), (q, d))]
        out += [(pre + ("mlp", "w_gate"), (d, ff)),
                (pre + ("mlp", "w_up"), (d, ff)),
                (pre + ("mlp", "w_down"), (ff, d))]
    return out


def vectors(cfg: dict):
    """(path, length) of every norm scale (applied as 1 + s)."""
    m = dims(cfg)
    out = [(("final_norm",), m["d"])]
    for l, kind in enumerate(kinds(cfg)):
        pre = ("layers", l)
        out += [(pre + ("norm1",), m["d"]), (pre + ("norm2",), m["d"])]
        if kind == "mamba2":
            out.append((pre + ("mamba", "norm"), m["di"]))
    return out


def weight_bytes(cfg: dict) -> int:
    """Every weight once, in the type it is bound in: the projections, the
    tied table, the norms and the conv in the weight type; A_log, dt_bias
    and D in fp32."""
    m = dims(cfg)
    per = BYTES[cfg["weight_dtype"]]
    n = sum(math.prod(s) for _, s in matrices(cfg)) + m["V"] * m["d"]
    n += sum(v for _, v in vectors(cfg))
    conv = m["conv"] * (m["k"] + (1 if cfg["mamba_conv_bias"] else 0))
    L = mamba_layers(cfg)
    return (n + L * conv) * per + L * 3 * m["H"] * 4


def state_bytes(cfg: dict, rows: int) -> int:
    """One read (or one write) of ``rows`` rows' SSM and conv state."""
    m = dims(cfg)
    ssm = m["H"] * m["P"] * m["N"] * BYTES[cfg["state_dtype"]]
    conv = (m["k"] - 1) * m["conv"] * BYTES[cfg["conv_state_dtype"]]
    return mamba_layers(cfg) * rows * (ssm + conv)


def ssm_update_bytes(cfg: dict, rows: int) -> int:
    """One state update of a Mamba-2 layer over ``rows`` rows: the state
    read and written, the conv's output row (x, B, C), dt, the head
    parameters read, y written (fp32)."""
    m = dims(cfg)
    state = rows * m["H"] * m["P"] * m["N"] * BYTES[cfg["state_dtype"]]
    return (2 * state + 4 * rows * (m["conv"] + m["H"] + m["di"])
            + 3 * 4 * m["H"])


def flops_per_item(cfg: dict) -> int:
    """Model FLOPs of one token (module doc), attention's context left
    out."""
    m = dims(cfg)
    weights = sum(math.prod(s) for _, s in matrices(cfg)) + m["V"] * m["d"]
    return 2 * weights + mamba_layers(cfg) * 4 * m["H"] * m["P"] * m["N"]


def call_work(cfg: dict, kind: str, args):
    """(FLOPs, bytes) of one decode call, wrapped as ``(graph, tokens)``:
    the engine's DecodeGraph (whose cache's ``idx``, read after the call,
    is each row's count of live slots) and the (rows, 1) tokens."""
    if kind not in ("decode", "remainder"):
        raise ValueError(f"mamba_hybrid counts decode calls, not {kind!r}")
    graph, tokens = args
    m = dims(cfg)
    rows = int(tokens.shape[0])
    ring = next(int(layer["k"].shape[1]) for layer in graph.cache["layers"]
                if "k" in layer)
    live = sum(min(int(i), ring) for i in graph.cache["idx"].tolist())
    attn = kinds(cfg).count("attn")
    kv = 2 * m["Hk"] * m["D"] * BYTES[cfg["weight_dtype"]]
    flops = rows * flops_per_item(cfg) + attn * live * 4 * m["Hq"] * m["D"]
    nbytes = (weight_bytes(cfg) + 2 * state_bytes(cfg, rows)
              + attn * (live + rows) * kv + rows * (8 + 4 * m["V"]))
    return flops, nbytes


def draw(cfg: dict, seed: int, device) -> dict:
    """The weights in the program's tree (``models.transformer``'s layout,
    a list of per-layer dicts): every projection, the table and the norms'
    scales drawn in fp32 in ONE call into one buffer (truncated normal
    within 2 sd), scaled in place (``init``: matrix_gain / sqrt(fan_in),
    embed_std, norm_std) and cast in one more; the conv uniform within
    ``conv_bound``; the Mamba-2 head parameters by its reference init:
    A = -exp(A_log) with A uniform in ``a_range``, dt_bias the inverse
    softplus of a step log-uniform in ``dt_range`` (at least
    ``dt_floor``), D ones."""
    m, init = dims(cfg), cfg["init"]
    dtype = DTYPES[cfg["weight_dtype"]]
    spans = [(path, shape, init["matrix_gain"] / math.sqrt(shape[0]))
             for path, shape in matrices(cfg)]
    spans.append((("head", "table"), (m["V"], m["d"]), init["embed_std"]))
    spans += [(path, (n,), init["norm_std"]) for path, n in vectors(cfg)]
    offs, total = [], 0
    for _, shape, _ in spans:
        offs.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(
        generate.torch_seed(seed, 7))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    for (_, shape, scale), o in zip(spans, offs):
        flat[o:o + math.prod(shape)].mul_(scale)
    flat = flat.to(dtype)
    tree = {"layers": [{} for _ in kinds(cfg)]}

    def put(path, t):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {}) if isinstance(key, str) \
                else node[key]
        node[path[-1]] = t

    for (path, shape, _), o in zip(spans, offs):
        put(path, flat[o:o + math.prod(shape)].view(shape))
    L = mamba_layers(cfg)
    bound, k, c, H = init["conv_bound"], m["k"], m["conv"], m["H"]
    conv = torch.empty((L, k + 1, c), device=device).uniform_(
        -bound, bound, generator=gen).to(dtype)
    a = torch.empty((L, H), device=device).uniform_(*init["a_range"],
                                                    generator=gen)
    lo, hi = (math.log(v) for v in init["dt_range"])
    dt = torch.exp(torch.empty((L, H), device=device).uniform_(
        lo, hi, generator=gen)).clamp_min(init["dt_floor"])
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    n = 0
    for l, kind in enumerate(kinds(cfg)):
        if kind != "mamba2":
            continue
        p = tree["layers"][l]["mamba"]
        p["conv_w"] = conv[n, :k]
        if cfg["mamba_conv_bias"]:
            p["conv_b"] = conv[n, k]
        p["A_log"] = torch.log(a[n])
        p["dt_bias"] = dt_bias[n].contiguous()
        p["D"] = torch.ones((H,), dtype=torch.float32, device=device)
        n += 1
    return tree
