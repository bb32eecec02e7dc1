"""Parameter initialisers shared by the model layers."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               scale: Optional[float] = None,
               device="cpu") -> torch.Tensor:
    """Truncated-normal fan-in init (within two standard deviations), drawn
    in float32 on the CPU from ``gen`` and then cast and moved, so one seed
    gives the same weights on every device."""
    fan_in = shape[0] if len(shape) > 1 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(device=device, dtype=dtype)


def promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype JAX's ``@`` promotes mixed operands to
    (bfloat16 with float32 -> float32); torch's matmul wants one dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def input_half(params, xs: torch.Tensor) -> torch.Tensor:
    """The hoisted input GEMM of every step of a recurrent layer:
    (B, T, X) @ W (X, gates·H) + b, in JAX's promoted dtype."""
    return promoted_matmul(xs, params["W"]) + params["b"]
