"""Shared building blocks of the model layers: the dtype policy, parameter
initialisers, the products with fp32 accumulation, the scan over time of
the recurrent blocks, and the mesh helpers.

Model code annotates activations with logical axis names (``shard_act``);
a thread-local context (``sharding_ctx``) binds those names to physical
mesh axes.  Without an active context the annotation is a no-op, so a run
with no mesh never touches ``torch.distributed``.  Under a ``DeviceMesh``
the parameters are DTensors, ``shard_act`` is ``DTensor.redistribute``
(JAX's ``with_sharding_constraint``), and every tensor the model creates
itself (rope tables, masks, scan carries, zero states, MoE buffers) joins
them as a replicated DTensor through ``on_mesh``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import card_path, torch_dtype, trips
from repro_torch.kernels.mvm_tile.ops import mvm
from repro_torch.sharding.partition import (P, axis_sizes, is_dtensor,
                                            placements)


def param_dtype(cfg) -> torch.dtype:
    """The parameters' (and activations') dtype of a model config."""
    return torch_dtype(cfg.dtype)


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               scale: Optional[float] = None,
               device="cpu") -> torch.Tensor:
    """Truncated-normal fan-in init (within two standard deviations), drawn
    in float32 from ``gen`` on the generator's own device and then cast
    and moved, so one seed gives the same weights on every device it is
    moved to.  (A CUDA generator draws other numbers than a CPU one: the
    full-width models draw on the card.)  On the ``meta`` device nothing
    is drawn (``launch.steps.input_specs``)."""
    if torch.device(device).type == "meta":  # shapes only: nothing drawn
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(device=device, dtype=dtype)


def project(x, w, *, decode: bool):
    """A model projection x (..., d) @ w (d, f): fp32 accumulation, output
    in x's dtype (x and w share the model's dtype).

    The rule for which products go through the ``mvm`` kernel: every
    projection of the decode step (``decode=True``: the transformer's
    ``mode == "decode"``, which includes the batch-1 remainder steps of a
    bucketed prefill) — the MLP's w_gate, w_up and w_down, the attention
    block's w_q, w_kv and w_o, the RG-LRU block's w_gate, w_in and w_out:
    6 launches per layer.  Every prefill or full-sequence product goes to
    ``torch.matmul``, which accumulates same-dtype bf16 products in fp32
    (on the card with cuBLAS's reduced-precision reductions off, see
    ``rnn.resolve_device``).  Products that are not such a
    projection stay ``torch.matmul`` in every mode: the RG-LRU gates'
    ``x @ w_a + b_a`` and ``x @ w_x + b_x`` (the reference rounds the
    product to the model dtype before the bias add, which is not mvm's
    fp32 bias epilogue) and the fp32-logit unembed.

    Under a mesh (DTensor operands) the kernel runs on each rank's local
    shards (``sharding.local.matmul``)."""
    if not decode:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if is_dtensor(x2, w):
        from repro_torch.sharding import local
        y = local.matmul(mvm, x2, w)
    else:
        y = mvm(x2, w)
    return y.reshape(*lead, w.shape[1])


def promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype JAX's ``@`` promotes mixed operands to
    (bfloat16 with float32 -> float32); torch's matmul wants one dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def input_half(params, xs: torch.Tensor) -> torch.Tensor:
    """The hoisted input GEMM of every step of a recurrent layer:
    (B, T, X) @ W (X, gates·H) + b, in JAX's promoted dtype."""
    return promoted_matmul(xs, params["W"]) + params["b"]


def bf16_split(x: torch.Tensor):
    """An fp32 tensor as three bf16 tensors whose fp32 sum is ``x`` exactly
    (each takes the next 8 bits of the 24-bit significand; values whose
    last part would fall below bf16's normal range lose it)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _mm_f32(a, b):
    """a @ b of bf16 operands summed in fp32 into an fp32 result: ``mm`` or
    ``bmm`` with ``out_dtype`` (``aten::mm.dtype`` / ``aten::bmm.dtype``);
    a 2-D product of DTensors on their local shards (``sharding.local``)."""
    if a.dim() == 2 and is_dtensor(a, b):
        from repro_torch.sharding import local
        return local.matmul(lambda x, w, _: _mm_f32(x, w), a, b)
    mm = torch.mm if a.dim() == 2 else torch.bmm
    return mm(a, b, out_dtype=torch.float32)


def _mixed_mm(parts, w, left: bool):
    """An fp32 tensor c, given as its three bf16 ``parts``
    (``bf16_split``), times bf16 w as it is (``left``: c @ w; else w @ c),
    each part's product summed in fp32 into an fp32 result: no fp32 copy
    of w.  A product of two bf16 values is exact in fp32, so this is the
    fp32 product of c and w up to the order of summation."""
    out = None
    for part in parts:
        y = _mm_f32(part, w) if left else _mm_f32(w, part)
        out = y if out is None else out + y
    return out


def _t(x):
    return x.transpose(-1, -2)


class _MatmulF32(torch.autograd.Function):
    """bf16 a (…, i, k) @ bf16 b (…, k, j) -> fp32, with the cotangents
    ``jax.grad`` gives the reference's einsum with
    ``preferred_element_type=float32``: the fp32 cotangent dC multiplied
    by the other bf16 operand with an fp32 result, rounded to bf16 once:
    dA = bf16(dC · bᵀ), dB = bf16(aᵀ · dC).  Both products run as three
    bf16 products of dC's parts (``_mixed_mm``), so no fp32 copy of either
    operand (the expert weights, the unembed table) is made."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        parts = bf16_split(dc.float())
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mixed_mm(parts, _t(b), left=True).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _mixed_mm(parts, _t(a), left=False).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (i, k) @ b (k, j), or batched (n, i, k) @ (n, k, j), with an fp32
    result, as the reference's einsums with ``preferred_element_type=
    jnp.float32`` (the MoE experts, sLSTM's recurrent product, the
    unembed).  On CUDA, bf16 operands are multiplied as they are and
    summed in fp32 into an fp32 result (``aten::mm.dtype`` /
    ``aten::bmm.dtype``): a product of two bf16 values is exact in fp32,
    and no fp32 copy of the weights is made (olmoe's experts are 12.9 GB,
    RecurrentGemma-2B's unembed 1.3 GB).  Those ATen ops have no
    derivative, so the product runs as ``_MatmulF32``, whose backward
    mirrors the reference's cotangents (fp32, rounded to bf16 once) with
    bf16 products.  On the CPU, where ``aten::mm.dtype`` has no kernel,
    and for fp32 operands, both are upcast to fp32 and multiplied (and
    autograd differentiates that).  A cost trace of the card's path
    (``calib.hlo``) takes the CUDA form on any device.  Batched DTensor
    operands (the MoE experts under a mesh) are upcast too: DTensor has
    no sharding rule for ``aten::bmm.dtype``."""
    if (not card_path(a) or a.dtype == torch.float32
            or (a.dim() == 3 and is_dtensor(a, b))):
        return torch.matmul(a.float(), b.float())
    return _MatmulF32.apply(a, b)


def _on_local(fn, t: torch.Tensor, dim: Optional[int] = None):
    """``fn(t)`` for an ``fn`` that keeps ``t``'s shape and works along
    ``dim`` at most (elementwise otherwise); on a DTensor, on each rank's
    local shard, a partial sum reduced and ``dim`` gathered first, where
    DTensor has no rule for ``fn`` or a wrong backward."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding import local

    def spread(p):
        return p.is_partial() or (dim is not None and p == Shard(dim))

    if any(spread(p) for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate() if spread(p) else p
                                           for p in t.placements])
    return local.wrap(fn(t.to_local()), t.device_mesh, t.placements,
                      t.shape)


def log_sigmoid(t: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid`` (DTensor has no sharding rule for it)."""
    return _on_local(F.logsigmoid, t)


def cummax(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cummax(t, dim).values`` (under a mesh DTensor's backward of
    it mixes plain and distributed tensors)."""
    dim %= t.dim()
    return _on_local(lambda x: torch.cummax(x, dim=dim).values, t, dim)


def split_last(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``t`` with its last dim split into ``sizes`` (heads and head dim,
    or a head's gates).  Under a mesh whose axes on that dim do not divide
    ``sizes[0]`` (RecurrentGemma-2B's 10 query heads, xlstm-125m's 4 heads
    on a 4- or 16-way model axis), the dim is gathered first: DTensor cuts
    no head in two (XLA's partitioner pads instead)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        last = Shard(t.dim() - 1)
        n = 1
        for i, pl in enumerate(t.placements):
            if pl == last:
                n *= t.device_mesh.size(i)
        if sizes[0] % n:
            t = t.redistribute(t.device_mesh, [Replicate() if pl == last
                                               else pl for pl in t.placements])
    return t.reshape(*t.shape[:-1], *sizes)


def _at(xs, t):
    return (type(xs)(a[t] for a in xs) if isinstance(xs, (tuple, list))
            else xs[t])


def _stack(ys):
    if isinstance(ys[0], (tuple, list)):
        return type(ys[0])(torch.stack(col) for col in zip(*ys))
    return torch.stack(ys)


def chunked_scan(step, carry, xs, chunk: int = 128, remat: bool = True):
    """``lax.scan`` over the leading (time) axis of ``xs`` (a tensor, or a
    tuple or list of them): ``carry, y_t = step(carry, x_t)`` for
    t = 0, 1, ..., returning (the last carry, the y_t stacked on a new
    leading axis).  The reference scans in rematerialised chunks to save
    memory for the backward pass.  Rematerialisation changes what is held
    for the backward, not a value of the forward or of a gradient, so
    ``chunk`` and ``remat`` are accepted and ignored: autograd keeps every
    step's activations (the reference's chunked scan gives the plain
    scan's values, in the same order)."""
    T = (xs[0] if isinstance(xs, (tuple, list)) else xs).shape[0]
    ys = []
    for t in trips(T):
        carry, y = step(carry, _at(xs, t))
        ys.append(y)
    if len(ys) < T:  # a cost trace ran one step for T (``trips``)
        ys = ys * T
    return carry, _stack(ys)


# ---------------------------------------------------------------------------
# logical-axis sharding annotations
# ---------------------------------------------------------------------------

_CTX = threading.local()

# logical name -> physical mesh axes (tuple -> sharded over multiple axes)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "qdim": "model",
    "ff": "model",
    "experts": "model",
    "capacity": None,
    "ff_fsdp": ("pod", "data"),
    "vocab": "model",
    "state": "model",
    "cache_seq": "model",
}


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[dict] = None):
    """Bind the logical names to ``mesh``'s axes (a ``DeviceMesh``, or a
    ``sharding.MeshShape`` where only specs are asked for) for the
    duration; ``None`` turns the annotations off."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = ((mesh, dict(DEFAULT_RULES, **(rules or {})))
                  if mesh is not None else None)
    try:
        yield
    finally:
        _CTX.state = prev


def current_mesh():
    st = getattr(_CTX, "state", None)
    return st[0] if st else None


def logical_spec(names: Sequence[Optional[str]], shape=None) -> Optional[P]:
    """Resolve logical names to a ``P`` under the active rules.

    Axes absent from the mesh are dropped (a single-pod mesh ignores
    'pod').  If ``shape`` is given, dims whose size does not divide evenly
    by the mesh-axis product are dropped (replicated)."""
    st = getattr(_CTX, "state", None)
    if st is None:
        return None
    mesh, rules = st
    present = set(axis_sizes(mesh))
    spec = []
    for i, nm in enumerate(names):
        axes = rules.get(nm) if nm else None
        if isinstance(axes, str):
            axes = (axes,)
        if axes is not None:
            axes = tuple(a for a in axes if a in present)
            if not axes:
                axes = None
        if axes is not None and shape is not None:
            if shape[i] % _axis_size(mesh, axes) != 0:
                axes = None
        if axes is not None and len(axes) == 1:
            axes = axes[0]
        spec.append(axes)
    return P(*spec)


def device_mesh():
    """The active context's mesh if it is a ``DeviceMesh``, else None."""
    mesh = current_mesh()
    return mesh if hasattr(mesh, "mesh_dim_names") else None


def shard_act(x, *names: Optional[str]):
    """``with_sharding_constraint`` by logical names: a DTensor is
    redistributed to the names' placements on the active mesh (no-op
    without a context, or for a plain tensor).  A dim the names' axes do
    not divide stays replicated, as in the partition rules, so that no
    rank holds an empty shard a kernel would be launched on."""
    mesh = device_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = logical_spec(names, tuple(x.shape))
    return x.redistribute(mesh, placements(spec, mesh))


def on_mesh(t):
    """A tensor the model made itself, as a replicated DTensor on the
    active ``DeviceMesh`` (every rank makes the same one), so that it
    meets the DTensor parameters; as it is without a mesh."""
    mesh = device_mesh()
    if mesh is None or t is None:
        return t
    from repro_torch.sharding.local import as_dtensor

    return as_dtensor(t, mesh)
