"""Shared building blocks of the model layers: the dtype policy, parameter
initialisers, the products with fp32 accumulation, and the scan over
time of the recurrent blocks."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels.common import torch_dtype
from repro_torch.kernels.mvm_tile.ops import mvm


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
    full-width models draw on the card.)"""
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
    fp32 bias epilogue) and the fp32-logit unembed."""
    if not decode:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    return mvm(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[1])


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
    ``bmm`` with ``out_dtype`` (``aten::mm.dtype`` / ``aten::bmm.dtype``)."""
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
    autograd differentiates that)."""
    if a.device.type != "cuda" or a.dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    return _MatmulF32.apply(a, b)


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
    for t in range(T):
        carry, y = step(carry, _at(xs, t))
        ys.append(y)
    return carry, _stack(ys)
