"""Attention — the port of ``repro.models.layers.attention``: GQA/MQA,
full-causal, sliding-window, blockwise (flash-style), and single-token
decode against a KV cache.

Three prefill paths, plain PyTorch as the reference leaves them to XLA:

* ``naive_attention``      — exact O(S^2) reference; short sequences.
* ``blockwise_attention``  — flash-style online softmax over KV chunks;
  bounded memory, used for long prefill.  KV chunks that lie wholly above
  the causal diagonal are skipped where the reference masks them: every
  score there is NEG_INF, so p is exactly 0 and alpha exactly 1 and
  skipping them leaves every number as it was.
* ``local_attention``      — sliding-window (SWA) via chunking: each chunk
  of size W attends to [previous chunk, own chunk] with a banded causal
  mask; exact for window <= W and O(S*W).

Scores, softmax statistics and accumulations are fp32; probabilities are
rounded to v's dtype before the p·v product, as in the reference.

``decode_attention`` (one new token against the cache) goes through the
``kernels.decode_attention`` entry point on every device: the hand-written
kernel on CUDA tensors, its plain version on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import trips
from repro_torch.kernels.decode_attention import ops as decode_kernel
from repro_torch.models.layers.common import on_mesh
from repro_torch.sharding.partition import is_dtensor

NEG_INF = -1e30


def _inv_sqrt(D: int) -> torch.Tensor:
    """1 / sqrt(D) in fp32, as the reference computes it."""
    return on_mesh(1.0 / torch.sqrt(torch.tensor(float(D),
                                                 dtype=torch.float32)))


def _gqa_scores(q, k):
    """q (B,S,Hq,D), k (B,T,Hk,D) -> scores (B,Hk,G,S,T) in fp32."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    qg = q.reshape(B, S, Hk, G, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())
    return s * _inv_sqrt(D).to(s.device)


def _gqa_out(probs, v, dtype):
    """probs (B,Hk,G,S,T), v (B,T,Hk,D) -> (B,S,Hq,D)."""
    B, Hk, G, S, T = probs.shape
    o = torch.einsum("bhgst,bthd->bshgd", probs.to(v.dtype).float(),
                     v.float())
    return o.reshape(B, S, Hk * G, -1).to(dtype)


def causal_mask(S: int, T: int, q_offset=0, window: int = 0, device="cpu"):
    """(S, T) additive mask; query i sits at absolute position q_offset + i."""
    qpos = q_offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return on_mesh(torch.where(ok, zero, NEG_INF))


def naive_attention(q, k, v, *, window: int = 0, q_offset=0):
    s = _gqa_scores(q, k)  # (B,Hk,G,S,T)
    s = s + causal_mask(q.shape[1], k.shape[1], q_offset, window, q.device)
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v, q.dtype)


# ---------------------------------------------------------------------------
# blockwise / flash-style
# ---------------------------------------------------------------------------


def blockwise_attention(q, k, v, *, q_chunk: int = 512, kv_chunk: int = 1024):
    """Causal attention with online softmax; memory O(q_chunk * kv_chunk)."""
    B, S, Hq, D = q.shape
    T = k.shape[1]
    Hk = k.shape[2]
    G = Hq // Hk
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    if S % q_chunk or T % kv_chunk:
        raise ValueError(f"blockwise_attention: S={S} and T={T} must be "
                         f"multiples of q_chunk={q_chunk} and "
                         f"kv_chunk={kv_chunk}")
    nq, nk = S // q_chunk, T // kv_chunk
    scale = _inv_sqrt(D).to(q.device)
    dev = q.device
    outs = []
    for i in range(nq):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk].reshape(
            B, q_chunk, Hk, G, D).float()
        qpos = on_mesh(i * q_chunk + torch.arange(q_chunk,
                                                  device=dev)[:, None])
        m = on_mesh(torch.full((B, Hk, G, q_chunk), NEG_INF,
                               dtype=torch.float32, device=dev))
        l = on_mesh(torch.zeros((B, Hk, G, q_chunk), dtype=torch.float32,
                                device=dev))
        o = on_mesh(torch.zeros((B, Hk, G, q_chunk, D), dtype=torch.float32,
                                device=dev))
        # the key blocks up to the diagonal: those wholly above it are
        # skipped (module doc)
        for j in trips(min(nk, ((i + 1) * q_chunk - 1) // kv_chunk + 1)):
            kj = k[:, j * kv_chunk:(j + 1) * kv_chunk]
            vj = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj.float()) * scale
            kpos = on_mesh(j * kv_chunk
                           + torch.arange(kv_chunk, device=dev)[None, :])
            s = torch.where(kpos <= qpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vj.dtype).float(),
                              vj.float())
            o = o * alpha[..., None] + pv
            m = m_new
        o = o / torch.clamp_min(l[..., None], 1e-30)
        # (B,Hk,G,q_chunk,D) -> (B,q_chunk,Hq,D)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, Hq, D))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# sliding window via chunking
# ---------------------------------------------------------------------------


def local_attention(q, k, v, *, window: int):
    """Exact SWA (kpos in (qpos-window, qpos]) with O(S*window) cost."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    W = window
    pad = (-S) % W
    if pad:
        zq = q.new_zeros((B, pad, Hq, D))
        zk = k.new_zeros((B, pad, Hk, D))
        q = torch.cat([q, zq], 1)
        k = torch.cat([k, zk], 1)
        v = torch.cat([v, zk], 1)
    Sp = q.shape[1]
    n = Sp // W
    qc = q.reshape(B, n, W, Hk, G, D)
    kc = k.reshape(B, n, W, Hk, D)
    vc = v.reshape(B, n, W, Hk, D)
    # keys for chunk i: chunk i-1 ++ chunk i
    prev_k = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    prev_v = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([prev_k, kc], dim=2)
    v2 = torch.cat([prev_v, vc], dim=2)
    s = torch.einsum("bnqhgd,bnkhd->bnhgqk", qc.float(), k2.float())
    s = s * _inv_sqrt(D).to(s.device)
    dev = q.device
    qpos = torch.arange(W, device=dev)[:, None] + W  # position in the 2W keys
    kpos = torch.arange(2 * W, device=dev)[None, :]
    ok = (kpos <= qpos) & (kpos > qpos - W)
    first = torch.arange(n, device=dev) == 0  # chunk 0 has no previous chunk
    ok = on_mesh(ok[None, :, :] & ~(first[:, None, None] & (kpos < W)[None]))
    s = torch.where(ok[None, :, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bnhgqk,bnkhd->bnqhgd", p.to(v2.dtype).float(),
                     v2.float())
    o = o.reshape(B, Sp, Hq, D)[:, :S]
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# decode (single new token against a cache)
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, cache_index, *, window: int = 0):
    """q (B,1,Hq,D); caches (B,T,Hk,D); cache_index (B,) int32 = current
    length (the new token's k/v must already be written at
    cache_index - 1).  Slots kpos < cache_index attend.

    Runs the ``decode_attention`` kernel entry point: the hand-written
    kernel on CUDA tensors, its plain version on the CPU.  The kernel walks
    the cache in tiles with an online softmax for every T, which is what
    the reference's chunked branch (T > 4096) computes, summed in another
    order, so the port has no separate chunked branch.

    The kernel has no window mask.  The model passes ``window=0`` when the
    ring bounds the cache and otherwise a window larger than the cache, so
    that every live slot attends; a window that would mask a live slot
    (0 < window < T) raises.

    Under a mesh (DTensor operands) the kernel runs on each rank's slice
    of the ring and the slices' (o, m, l) are combined
    (``sharding.local.decode_attention``)."""
    T = k_cache.shape[1]
    if 0 < window < T:
        raise ValueError(
            f"decode_attention: window={window} < cache length {T} would "
            "mask live slots, and the decode kernel masks only slots at or "
            "past cache_index; the model never asks for it")
    if is_dtensor(q, k_cache, v_cache, cache_index):
        from repro_torch.sharding import local
        return local.decode_attention(decode_kernel.decode_attention, q,
                                      k_cache, v_cache, cache_index)
    return decode_kernel.decode_attention(q, k_cache, v_cache, cache_index)


__all__ = ["NEG_INF", "causal_mask", "naive_attention",
           "blockwise_attention", "local_attention", "decode_attention"]
