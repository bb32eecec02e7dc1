"""Kernels under a mesh: no hand-written kernel takes a DTensor, so each
kernel entry point, given DTensors, is run here once on every rank's
local shards, with the placements written down per mesh dim, and its
local result is wrapped back into a DTensor (``to_local`` /
``from_local``; both are differentiable, so the scan's backward runs the
same way).

* ``mvm`` and the fp32-result products (x (B, X) @ W (X, N)): W sharded
  on its columns gives ``Shard(1)`` outputs from a replicated x; W
  sharded on its rows takes x sharded on its columns and gives a
  ``Partial`` sum, reduced where a later operation needs it; a
  replicated W keeps x's batch sharding.
* ``decode_attention``: a ring sharded over its batch takes q sharded
  the same way; a ring sharded over its slots T (the sequence-sharded
  cache) takes q replicated, runs the kernel on its slice with that
  slice's live count, and the ranks combine (o, m, l) in fp32 — the
  softmax statistics, not the rows, cross the mesh.
* ``rglru_scan``: batch and channels may be sharded, T is gathered.
* ``ring_write`` / ``ring_fill``: the decode step's new slot and the
  prefill's rings written into a (sharded) ring in place, each rank into
  its own slice.

Nothing here runs without a mesh: the model's call sites of the kernels
(``models.layers.common.project`` and ``_mm_f32``,
``attention.decode_attention``, ``rglru.scan_recurrence``) call it only
for DTensor operands (``partition.is_dtensor``), and the kernel modules
know nothing of a mesh, so a run without a mesh computes what it always
did.  Each kernel is called once per call, so its
counters move as they do without a mesh.

The collectives this module issues itself (the combine's reductions, the
TP LSTM's gather: ``all_reduce_over``, ``all_gather_over``) are c10d's,
on the mesh dim's process group, not DTensor's functional collectives:
on PyTorch 2.11 the latter crash (a segfault in ``wait_tensor``) under
gloo on CUDA tensors, the backend that two ranks sharing one card need,
while c10d's collectives run there.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def wrap(t: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A rank's local ``t`` as the DTensor of global ``shape``."""
    shape = tuple(shape)
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def as_dtensor(t, mesh) -> DTensor:
    """``t`` on ``mesh``: a plain tensor (every rank holds it whole) as a
    replicated DTensor."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _mesh_of(*ts):
    for t in ts:
        if isinstance(t, DTensor):
            return t.device_mesh
    raise TypeError("no DTensor operand")


def all_reduce_over(t: torch.Tensor, mesh, dims, op=dist.ReduceOp.SUM):
    """``t`` (a rank's local tensor) reduced in place over the mesh dims
    ``dims`` (c10d, each dim's group)."""
    for i in dims:
        dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


def all_gather_over(t: torch.Tensor, mesh, i: int, dim: int):
    """The ranks' local ``t`` along mesh dim ``i`` concatenated on tensor
    dim ``dim``, in rank order (c10d's all-gather into one buffer)."""
    t = t.contiguous()
    n = mesh.size(i)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=mesh.get_group(i))
    return torch.cat(out.chunk(n, dim=0), dim=dim)


def _offset(t: DTensor, dim: int) -> int:
    """Where this rank's shard of ``t`` starts along ``dim``, in Python
    ints from the rank's mesh coordinate: each mesh dim that shards
    ``dim`` (in mesh order, the first the major one) cuts what the ones
    before it left into chunks of ceil(size / n), as ``torch.chunk``
    does.  No tensor is read, so this also runs under fake tensors
    (``calib.hlo``)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    size, off = t.shape[dim], 0
    for i, p in enumerate(t.placements):
        if p == Shard(dim):
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            off += start
            size = min(chunk, size - start)
    return off


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def matmul(entry, x, W, b=None, **kw):
    """``entry(x, W, b, **kw)`` (the ``mvm`` kernel entry point, or a
    product with an fp32 result) on the local shards of x (B, X) or (X,)
    and W (X, N)."""
    mesh = _mesh_of(x, W, b)
    x, W = as_dtensor(x, mesh), as_dtensor(W, mesh)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    xp, yp, bp = [], [], []
    for i, pw in enumerate(W.placements):
        px = x.placements[i]
        if pw == Shard(1):  # columns: every rank the whole x
            xp.append(Replicate())
            yp.append(Shard(1))
            bp.append(Shard(0))
        elif pw == Shard(0):  # rows: x's matching columns, a partial sum
            if b is not None:
                raise ValueError("mvm: a bias with W sharded on its rows")
            xp.append(Shard(1))
            yp.append(Partial())
            bp.append(Replicate())
        elif pw.is_replicate():  # x keeps its batch sharding
            keep = px == Shard(0)
            xp.append(Shard(0) if keep else Replicate())
            yp.append(Shard(0) if keep else Replicate())
            bp.append(Replicate())
        else:
            raise ValueError(f"mvm: W placed {pw} on mesh dim {i}")
    xl = x.redistribute(mesh, xp).to_local()
    bl = None if b is None else as_dtensor(b, mesh).redistribute(
        mesh, bp).to_local()
    yl = entry(xl, W.to_local(), bl, **kw)
    y = wrap(yl, mesh, yp, (x.shape[0], W.shape[1]))
    return y[0] if squeeze else y


# ---------------------------------------------------------------------------
# decode attention over a (sequence-sharded) ring
# ---------------------------------------------------------------------------


def decode_attention(entry, q, k_cache, v_cache, valid, *, block_t: int = 0):
    """``entry`` (the ``decode_attention`` kernel entry point) on the local
    shards of a ring (B, T, Hk, D) sharded over B, T, both or neither.
    Where T is sharded, every rank's kernel returns (o, m, l) of its
    slice (a slice with no live slot gives (0, -inf, 0)), and the
    combine: M = max_r m_r, w_r = l_r exp(m_r - M), o = sum_r w_r o_r /
    sum_r w_r, in fp32, rounded to q's dtype once."""
    mesh = _mesh_of(q, k_cache, v_cache, valid)
    q, k_cache, v_cache, valid = (as_dtensor(t, mesh)
                                  for t in (q, k_cache, v_cache, valid))
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    B, Hq, D = q.shape
    rowp, seq_dims = [], []
    for i, pk in enumerate(k_cache.placements):
        if pk == Shard(0):
            rowp.append(Shard(0))
        elif pk == Shard(1) or pk.is_replicate():
            rowp.append(Replicate())
            if pk == Shard(1):
                seq_dims.append(i)
        else:
            raise ValueError(f"decode_attention: ring placed {pk} on mesh "
                             f"dim {i}; it may be sharded over B or T")
    ql = q.redistribute(mesh, rowp).to_local()
    validl = valid.redistribute(mesh, rowp).to_local()
    kl = k_cache.to_local()
    vl = v_cache.redistribute(mesh, k_cache.placements).to_local()
    n_seq = math.prod(mesh.size(i) for i in seq_dims)
    Tl = kl.shape[1]
    bt = block_t if block_t and Tl % block_t == 0 else 0
    if n_seq == 1:  # the whole ring on every rank: the kernel's own output
        o = entry(ql, kl, vl, validl, block_t=bt)
    else:
        live = torch.clamp(validl.to(torch.int32) - _offset(k_cache, 1),
                           0, Tl).to(torch.int32)
        ol, m, l = entry(ql, kl, vl, live, block_t=bt, return_stats=True)
        M = all_reduce_over(m.clone(), mesh, seq_dims, dist.ReduceOp.MAX)
        w = l * torch.exp(m - M)
        num = all_reduce_over(ol * w[..., None], mesh, seq_dims)
        den = all_reduce_over(w, mesh, seq_dims)
        o = (num / den[..., None]).to(q.dtype)
    out = wrap(o, mesh, rowp, (B, Hq, D))
    return out[:, None] if squeeze else out


# ---------------------------------------------------------------------------
# the RG-LRU scan
# ---------------------------------------------------------------------------


def rglru_scan(entry, log_a, gx, h0, **kw):
    """``entry`` (the ``rglru_scan`` kernel entry point) on the local
    shards: (B, T, W) inputs keep a sharded B or W, a sharded T is
    gathered; h0 (B, W) takes the same B and W placements."""
    mesh = _mesh_of(log_a, gx, h0)
    log_a, gx, h0 = (as_dtensor(t, mesh) for t in (log_a, gx, h0))
    seqp, statep = [], []
    for p in log_a.placements:
        if p == Shard(0) or p == Shard(2):
            seqp.append(p)
            statep.append(Shard(0) if p == Shard(0) else Shard(1))
        else:
            seqp.append(Replicate())
            statep.append(Replicate())
    hs, hT = entry(log_a.redistribute(mesh, seqp).to_local(),
                   gx.redistribute(mesh, seqp).to_local(),
                   h0.redistribute(mesh, statep).to_local(), **kw)
    return (wrap(hs, mesh, seqp, log_a.shape),
            wrap(hT, mesh, statep, h0.shape))


# ---------------------------------------------------------------------------
# writing into a sharded ring
# ---------------------------------------------------------------------------


def _row_placements(ring: DTensor):
    """The placements of a per-row operand of ``ring`` (B, T, ...): B
    sharded where the ring's B is, replicated elsewhere."""
    return [Shard(0) if p == Shard(0) else Replicate()
            for p in ring.placements]


def ring_write(ring, slot, val):
    """``ring[b, slot[b]] = val[b]`` for every row b, in place: each rank
    writes the rows it holds whose slot lies in its slice of T.  ring
    (B, T, KV) DTensor, slot (B,) int, val (B, KV)."""
    mesh = ring.device_mesh
    rowp = _row_placements(ring)
    rl = ring.to_local()
    sl = as_dtensor(slot, mesh).redistribute(mesh, rowp).to_local()
    vl = as_dtensor(val, mesh).redistribute(mesh, rowp).to_local()
    Tl = rl.shape[1]
    loc = sl.long() - _offset(ring, 1)
    mine = (loc >= 0) & (loc < Tl)
    loc = torch.clamp(loc, 0, Tl - 1)
    rows = torch.arange(rl.shape[0], device=rl.device)
    rl.index_put_((rows, loc), torch.where(mine[:, None], vl.to(rl.dtype),
                                           rl[rows, loc]))
    return ring


def ring_fill(ring, content):
    """``ring.copy_(content)`` in place, each rank its own slice:
    ``content`` (a DTensor or plain tensor of the ring's global shape) is
    laid out as the ring first."""
    mesh = ring.device_mesh
    src = as_dtensor(content, mesh).redistribute(mesh, ring.placements)
    ring.to_local().copy_(src.to_local())
    return ring


__all__ = ["wrap", "as_dtensor", "all_reduce_over", "all_gather_over",
           "matmul", "decode_attention", "rglru_scan",
           "ring_write", "ring_fill"]
