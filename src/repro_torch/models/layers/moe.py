"""Mixture-of-Experts FFN: top-k routing with capacity-based scatter
dispatch — the port of ``repro.models.layers.moe``.

GShard/Switch-style: tokens pick top-k experts; each expert has a fixed
capacity C = ceil(T * k * capacity_factor / E), clamped to [8, T];
overflowing picks are dropped (their contribution is zero — the residual
connection carries them).  Dispatch and combine scatter and gather with
(expert, slot) index pairs into an (E, C, d) buffer.

Invariants (as the reference's, property-tested):
  * combine weights per token sum to <= 1 (== 1 when nothing dropped)
  * each (expert, slot) holds at most one token
  * with capacity_factor large enough, output == the dense reference

Top-k is a stable descending sort, so ties go to the lower expert index
as ``jax.lax.top_k`` sends them (``torch.topk`` does not promise it):
which pick crosses the k-th boundary on a tie decides which tokens a full
expert drops.  Nothing here syncs with the host (no ``.item()``,
``nonzero``, boolean-mask indexing or ``bincount``), so the layer runs
inside the decode step's CUDA graph capture.  The expert products are
``common.matmul_f32`` (bf16 operands, fp32 result): the reference computes
them outside any Pallas kernel, and so does the port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import (dense_init, matmul_f32, on_mesh,
                                              shard_act)
from repro_torch.models.layers.mlp import apply_mlp, init_mlp
from repro_torch.sharding.partition import is_dtensor


def draw_experts(gen: torch.Generator, out: torch.Tensor) -> torch.Tensor:
    """Draw an (E, a, b) expert leaf into ``out`` expert by expert, at the
    reference's scale: ``dense_init`` takes its fan-in from shape[0],
    which for the (E, d, ff) leaves is E, so every expert's weights are
    drawn at 1/sqrt(E).  One expert's fp32 draw at a time is the only
    temporary (an arctic layer's three leaves are 27 GB in bf16)."""
    scale = 1.0 / math.sqrt(out.shape[0])
    for e in range(out.shape[0]):
        out[e].copy_(dense_init(gen, out.shape[1:], out.dtype, scale=scale,
                                device=out.device))
    return out


def init_moe(gen: torch.Generator, d: int, ff: int, n_experts: int, dtype,
             dense_ff: int = 0, device="cpu", experts=None):
    """The reference's tree: {"router" (d, E) fp32, "w_gate", "w_up"
    (E, d, ff), "w_down" (E, ff, d)} and, with ``dense_ff``, arctic's
    parallel dense MLP {"dense"}.  ``experts`` may give the three expert
    leaves preallocated (views of stacked (L, E, ...) leaves): they are
    drawn into in place."""
    p = {"router": dense_init(gen, (d, n_experts), torch.float32,
                              device=device)}
    shapes = {"w_gate": (n_experts, d, ff), "w_up": (n_experts, d, ff),
              "w_down": (n_experts, ff, d)}
    for name, shape in shapes.items():
        out = (experts[name] if experts is not None else
               torch.empty(shape, dtype=dtype, device=device))
        p[name] = draw_experts(gen, out)
    if dense_ff:
        p["dense"] = init_mlp(gen, d, dense_ff, dtype, device)
    return p


def _capacity(T: int, k: int, E: int, factor: float) -> int:
    c = math.ceil(T * k * factor / E)
    return max(8, min(c, T))


def _top_k(probs, k: int):
    """(values, indices) of the k largest entries of each row, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], e[..., :k]


def route(router_logits, k: int, capacity: int, n_experts: int):
    """router_logits (T, E) fp32 -> dispatch info.

    Returns (expert_idx, slot_idx, weight, valid), each (T, k).
    """
    probs = torch.softmax(router_logits, dim=-1)
    top_w, top_e = _top_k(probs, k)  # (T, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    slot, valid = assign_slots(top_e, capacity, n_experts)
    return top_e, slot, top_w, valid


def _into(buf, op: str, *args):
    """``buf.<op>_(*args)``, in place; on a DTensor (under a mesh) out of
    place, since DTensor's in-place scatter-adds may re-place ``buf``
    without moving its data.  The same values either way."""
    if is_dtensor(buf):
        return getattr(buf, op)(*args)
    return getattr(buf, op + "_")(*args)


def assign_slots(top_e, capacity: int, n_experts: int):
    """(slot_idx, valid), each (T, k), of the picks ``top_e`` (T, k): the
    position of each (token, choice) within its expert, ordered
    token-major (tokens earlier in the batch win capacity); a pick at or
    past ``capacity`` is not valid (dropped)."""
    T, k = top_e.shape
    flat_e = top_e.reshape(-1)  # (T*k,)
    experts = on_mesh(torch.arange(n_experts, device=flat_e.device))
    onehot = (flat_e[:, None] == experts).to(torch.int32)  # (T*k, E)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]  # (T*k,)
    valid = slot < capacity
    return slot.reshape(T, k), valid.reshape(T, k)


def aux_load_balance_loss(router_logits, top_e, n_experts: int):
    """Switch-style load balance loss (mean over experts of f_e * p_e * E).
    The counts are sums of ones, exact in any order."""
    probs = torch.softmax(router_logits, dim=-1)
    p_mean = probs.mean(dim=0)  # (E,)
    flat = top_e.reshape(-1)
    counts = _into(on_mesh(torch.zeros((n_experts,), dtype=torch.float32,
                                       device=flat.device)), "index_add",
                   0, flat, on_mesh(torch.ones(flat.shape,
                                               dtype=torch.float32,
                                               device=flat.device)))
    f = counts / torch.clamp_min(counts.sum(), 1.0)
    return n_experts * torch.sum(f * p_mean)


def apply_moe(params, x, *, k: int, capacity_factor: float,
              deterministic_capacity: int = 0, decode: bool = False):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar fp32).  ``decode``
    sends arctic's dense branch through the mvm kernel
    (``common.project``); the router and the experts stay
    ``torch.matmul`` / ``matmul_f32`` in every mode."""
    B, S, d = x.shape
    E = params["router"].shape[1]
    T = B * S
    # laid out over the batch here so that its two cotangents (the router's
    # and the dispatch's) come back to the view in one layout: DTensor's
    # sum of them may keep a nested Shard(0) that the view back cannot cut
    xt = shard_act(x.reshape(T, d), "batch", None)
    C = deterministic_capacity or _capacity(T, k, E, capacity_factor)

    logits = torch.matmul(xt.float(), params["router"])
    expert_idx, slot_idx, weight, valid = route(logits, k, C, E)
    aux = aux_load_balance_loss(logits, expert_idx, E)

    # ---- dispatch: scatter tokens into (E, C, d) buffers --------------
    # a dropped pick adds exact zeros into slot 0 of its expert (the
    # reference's clamp), so each (expert, slot) receives one token plus
    # zeros and the scatter-add is exact in any order
    flat_e = expert_idx.reshape(-1)
    flat_v = valid.reshape(-1)
    flat_s = torch.where(flat_v, slot_idx.reshape(-1), 0)
    src = (xt[:, None].expand(T, k, d).reshape(T * k, d)
           * flat_v[:, None].to(x.dtype))
    buf = on_mesh(torch.zeros((E * C, d), dtype=x.dtype, device=x.device))
    buf = _into(buf, "index_add", 0, flat_e * C + flat_s, src)
    # EP over experts only
    buf = shard_act(buf.reshape(E, C, d), "experts", None, None)

    # ---- expert computation (E, C, d) x (E, d, f) ---------------------
    g = matmul_f32(buf, params["w_gate"])
    u = matmul_f32(buf, params["w_up"])
    h = (F.silu(g) * u).to(x.dtype)
    h = shard_act(h, "experts", None, "ff_fsdp")
    out = matmul_f32(h, params["w_down"]).to(x.dtype)

    # ---- combine: gather back and weight ------------------------------
    gathered = out[flat_e, flat_s]  # (T*k, d)
    w = (weight.reshape(-1) * flat_v).to(x.dtype)
    y = (gathered * w[:, None]).reshape(T, k, d).sum(dim=1)
    y = y.reshape(B, S, d)

    if "dense" in params:
        y = y + apply_mlp(params["dense"], x, decode=decode)
    return y, aux


def moe_reference(params, x, *, k: int):
    """Dense all-experts reference (no capacity drops): every token computes
    every expert, combined by renormalized top-k weights.  O(T*E*ff)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    logits = torch.matmul(xt.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    E = probs.shape[-1]
    mask = _into(on_mesh(torch.zeros((xt.shape[0], E), dtype=torch.float32,
                                     device=x.device)), "scatter", 1, top_e,
                 top_w)
    xe = xt[None].expand(E, -1, -1)  # (E, T, d)
    g = matmul_f32(xe, params["w_gate"])  # (E, T, f)
    u = matmul_f32(xe, params["w_up"])
    h = F.silu(g) * u
    o = matmul_f32(h.to(x.dtype), params["w_down"])  # (E, T, d)
    y = (o.transpose(0, 1) * mask[..., None]).sum(dim=1)
    y = y.to(x.dtype).reshape(B, S, d)
    if "dense" in params:
        y = y + apply_mlp(params["dense"], x)
    return y


__all__ = ["init_moe", "draw_experts", "route", "assign_slots",
           "aux_load_balance_loss",
           "apply_moe", "moe_reference"]
