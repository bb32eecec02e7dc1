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


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a (n, i, k) @ b (n, k, j) with an fp32 result, as the
    reference's einsums with ``preferred_element_type=jnp.float32`` (the
    MoE experts, sLSTM's recurrent product).  On CUDA, bf16 operands are
    multiplied as they are and summed in fp32 into an fp32 result
    (``torch.bmm(..., out_dtype=torch.float32)``, ``aten::bmm.dtype``): a
    product of two bf16 values is exact in fp32, and no fp32 copy of the
    weights is made (olmoe's experts are 12.9 GB).  On the CPU, where
    ``aten::bmm.dtype`` has no kernel, and for fp32 operands, both are
    upcast to fp32 and multiplied."""
    if a.device.type != "cuda" or a.dtype == torch.float32:
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


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
    memory for the backward pass; no gradients are taken here, so
    ``chunk`` and ``remat`` are accepted and ignored (the reference's
    chunked scan gives the plain scan's values, in the same order)."""
    T = (xs[0] if isinstance(xs, (tuple, list)) else xs).shape[0]
    ys = []
    for t in range(T):
        carry, y = step(carry, _at(xs, t))
        ys.append(y)
    return carry, _stack(ys)
