"""Public entry point of the flash-decode attention kernel:
``decode_attention`` (one query token per sequence against its KV cache,
ONE launch).  Its (m, l) form (``return_stats=True``) also gives each
head's softmax statistics and the output in fp32, for a ring sharded over
T whose slices are combined across ranks.

The device of the tensors decides how it runs: on the CPU it runs the
plain PyTorch version (``decode_attention_plain``, the Pallas kernel's
tiled online softmax in fp32); on a CUDA device it launches the
hand-written kernel (``csrc/decode_attention.cu``) or raises.  There is no
fallback from one to the other.  Like every kernel entry point it carries
the ``calls`` and ``kernel_launches`` counters and its cost
(``kernels.common.counted``, ``decode_attention_cost``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.common import (Cost, check_operands, check_shape,
                                        count_launch, counted, dtype_flag,
                                        launched, nbytes, on_cuda, operand,
                                        tracing)
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import (NEG_INF,
                                                      decode_attention_ref)

#: the largest head dim the kernel takes: its shared memory (a ring of 32-slot
#: tiles, 16 query rows and the merge's buffers) is laid out for D <= 256
#: (csrc/decode_attention.cu)
MAX_HEAD_DIM = 256
#: the cluster sizes the kernel takes (the CTAs that share a row's ring)
#: and its tile of slots
SPLITS = (1, 2, 4, 8, 16)
TILE = 32


def splits(T: int) -> int:
    """S, the CTAs of one cluster, from the ring's length alone — never
    from B, valid or a timing, so each output is summed in the same order
    at every B and in every run.  CTA r of a (row, kv head) takes the
    ring's tiles of TILE slots r, r + S, r + 2 S, ... for all of its query
    heads; S is the largest in SPLITS that leaves every CTA two tiles of a
    full ring (T >= 2 S TILE).  The heads and the head dim do not enter:
    every kv head (and group of up to 16 query heads) takes its own S
    CTAs."""
    S = SPLITS[0]
    for s in SPLITS[1:]:
        if T >= 2 * s * TILE:
            S = s
    return S


def default_block_t(T: int) -> int:
    """The reference's default KV tile: the largest of 512, 256, ... that
    divides T."""
    block_t = min(512, T)
    while T % block_t:
        block_t //= 2
    return block_t


def decode_attention_plain(q, k_cache, v_cache, valid, *, block_t: int,
                           return_stats: bool = False):
    """What the Pallas kernel computes, in plain PyTorch: q (B, Hq, D),
    caches (B, T, Hk, D), valid (B,) -> (B, Hq, D) in q's dtype.

    The cache is walked in tiles of ``block_t`` slots with the kernel's
    online softmax, everything in fp32 (p is not rounded to v's dtype, as
    it is in ``decode_attention_ref``).

    ``return_stats``: (o, m, l), o (B, Hq, D) in fp32, m the max of each
    head's live scores and l the sum of their exp(s - m), (B, Hq) fp32;
    a row with no live slot gives (0, -inf, 0), the identity of the
    combine over T's shards."""
    B, Hq, D = q.shape
    T, Hk = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hk
    qg = q.reshape(B, Hk, G, D).float()
    valid = valid.to(device=q.device, dtype=torch.int32)
    sqrt_d = torch.tensor(math.sqrt(D), dtype=torch.float32)
    m = torch.full((B, Hk, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hk, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hk, G, D), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, block_t):
        k = k_cache[:, t0:t0 + block_t].float()
        v = v_cache[:, t0:t0 + block_t].float()
        s = torch.einsum("bhgd,bthd->bhgt", qg, k) / sqrt_d
        pos = t0 + torch.arange(block_t, device=q.device)
        live = pos[None, :] < valid[:, None]  # (B, block_t)
        s = torch.where(live[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgt,bthd->bhgd", p, v)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    if not return_stats:
        return out.reshape(B, Hq, D).to(q.dtype)
    empty = (valid < 1)[:, None, None]
    out = torch.where(empty[..., None], 0.0, out)
    m = torch.where(empty, float("-inf"), m)
    l = torch.where(empty, 0.0, l)
    return out.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


def decode_attention_cuda(q, k_cache, v_cache, valid,
                          return_stats: bool = False):
    """Launch ``csrc/decode_attention.cu`` on the current stream; shapes as
    ``decode_attention_plain`` (its (m, l) form with ``return_stats``); q
    and the caches fp32 or bf16 (k and v of one dtype), valid int32.  One
    launch over clusters of ``splits(T)`` CTAs, which take the ring's
    TILE-slot tiles in turn."""
    B, Hq, D = q.shape
    T, Hk = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    check_operands("decode_attention", dev, q=q, k_cache=k_cache,
                   v_cache=v_cache, valid=valid)
    check_shape("decode_attention", "v_cache", v_cache, (B, T, Hk, D))
    check_shape("decode_attention", "valid", valid, (B,))
    if valid.dtype != torch.int32:
        raise TypeError("decode_attention: valid must be int32")
    if v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention: k_cache is {k_cache.dtype}, "
                        f"v_cache {v_cache.dtype}; they must match")
    G = Hq // Hk
    if D > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {D}; the kernel takes "
                         f"at most {MAX_HEAD_DIM}")
    q_type = dtype_flag("decode_attention", "q", q)
    kv_type = dtype_flag("decode_attention", "k_cache", k_cache)
    out, ml = _outs(q, return_stats)
    launch = kernel.entry("decode_attention")
    with torch.cuda.device(dev):
        rc = launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    valid.data_ptr(), out.data_ptr(),
                    None if ml is None else ml.data_ptr(), B, T, Hk, G, D,
                    splits(T), q_type, kv_type,
                    torch.cuda.current_stream(dev).cuda_stream)
    launched("decode_attention", rc)
    count_launch(decode_attention)
    if return_stats:
        return out, ml[..., 0], ml[..., 1]
    return out


def _outs(q, return_stats: bool):
    """(o, the (m, l) pairs or None), as ``decode_attention_cuda``
    allocates them."""
    out = torch.empty(q.shape, device=q.device,
                      dtype=torch.float32 if return_stats else q.dtype)
    ml = (torch.empty(q.shape[:2] + (2,), dtype=torch.float32,
                      device=q.device) if return_stats else None)
    return out, ml


def decode_attention_cost(q, k_cache, v_cache, valid, *, block_t: int = 0,
                          return_stats: bool = False) -> Cost:
    """Attention of B·Hq query rows over the whole ring of T slots (the
    live count is data, which a trace on fake tensors does not have, and
    the reference's HLO prices the whole ring too): q·K and p·V, 4·B·Hq·T·D
    FLOPs; q, both caches and ``valid`` (int32) read and o (and (m, l))
    written once; B·Hq·T exps."""
    B, T = k_cache.shape[0], k_cache.shape[1]
    Hq, D = q.shape[-2], q.shape[-1]
    out = B * Hq * D * (4 if return_stats else q.element_size())
    if return_stats:
        out += 8 * B * Hq
    return Cost(flops=4 * B * Hq * T * D,
                bytes=nbytes(q, k_cache, v_cache) + 4 * B + out,
                transcendentals=B * Hq * T)


@counted(cost=decode_attention_cost)
def decode_attention(q, k_cache, v_cache, valid, *, block_t: int = 0,
                     return_stats: bool = False):
    """Flash-decode GQA attention.  q (B, Hq, D) or (B, 1, Hq, D); caches
    (B, T, Hk, D); valid (B,) int32, the live slots of each row (slots
    t < valid attend).  Returns q's shape and dtype.

    ``block_t`` is the reference's KV tile (default: the largest of 512,
    256, ... dividing T); T % block_t == 0 is required, as in the
    reference.  The plain version walks the cache in these tiles; the CUDA
    kernel splits T by its own rule (``splits``) and ignores ``block_t``
    once it is checked, as the sequence kernels ignore theirs: the tiling
    changes only the order in which fp32 sums are taken.

    ``return_stats``: (o, m, l) as ``decode_attention_plain`` gives them,
    o in fp32 (q's shape)."""
    decode_attention.calls += 1
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    B, Hq, D = q.shape
    T, Hk = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (B, T, Hk, D) or Hq % Hk:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k_cache "
                         f"{tuple(k_cache.shape)} do not form (B, Hq, D) / "
                         "(B, T, Hk, D) with Hk dividing Hq")
    if not block_t:
        block_t = default_block_t(T)
    if block_t < 1 or T % block_t:
        raise ValueError(f"decode_attention: T={T} is not a multiple of "
                         f"block_t={block_t}")
    if tracing():
        o, ml = _outs(q, return_stats)
        if return_stats:
            o = (o, ml[..., 0], ml[..., 1])
    elif on_cuda("decode_attention", q.device):
        o = decode_attention_cuda(operand(q), operand(k_cache),
                                  operand(v_cache),
                                  operand(valid.to(torch.int32)),
                                  return_stats)
    else:
        o = decode_attention_plain(q, k_cache, v_cache, valid,
                                   block_t=block_t,
                                   return_stats=return_stats)
    if return_stats:
        o, m, l = o
        return (o[:, None] if squeeze else o), m, l
    return o[:, None] if squeeze else o


def max_clusters(B: int, T: int, Hk: int, G: int, D: int,
                 dtype=torch.bfloat16) -> int:
    """How many of a launch's clusters (of ``splits(T)`` CTAs) can be
    resident on the current card at once: cudaOccupancyMaxActiveClusters
    for the kernel instance that q and caches of ``dtype`` take."""
    query = kernel.bind("decode_attention", "decode_attention_max_clusters",
                        [ctypes.c_int] * 8 + [ctypes.c_void_p])
    flag = int(dtype == torch.bfloat16)
    out = ctypes.c_int(0)
    launched("decode_attention (cluster occupancy)",
             query(B, T, Hk, G, D, splits(T), flag, flag,
                   ctypes.addressof(out)))
    return out.value


__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_cuda", "decode_attention_ref",
           "decode_attention_cost",
           "default_block_t", "splits", "max_clusters"]
