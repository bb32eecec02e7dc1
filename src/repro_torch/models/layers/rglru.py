"""RG-LRU recurrent block (RecurrentGemma / Griffin) — the port of
``repro.models.layers.rglru``.

Recurrence (per channel):
    r_t = sigmoid(x_t W_a + b_a)              -- recurrence gate
    i_t = sigmoid(x_t W_x + b_x)              -- input gate
    log a_t = c * r_t * log sigmoid(Lambda)   -- c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The input-dependent pieces (r, i, gated x, a) have no recurrent
dependency: ``gate_inputs`` computes them for the whole sequence at once
(two W x W products, left to ``torch.matmul`` as the reference leaves them
to XLA), and the scan keeps only the serial per-channel update.
``scan_recurrence`` (and so ``apply_rglru``, the model's prefill) runs
the scan through the ``kernels.rglru.rglru_scan`` entry point — the
hand-written kernel on CUDA tensors, its plain version on the CPU — as
``dispatch.execute`` does for rglru items.  Both evaluate each step as
the reference's compiled scan does (``kernels.rglru.ref``), so the
prefill keeps the reference's numbers.

Parameters keep the reference's layout, so ``repro_torch.convert.from_jax``
carries a JAX ``init_rglru`` tree over one to one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import torch_dtype
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import xla_exp
from repro_torch.models.layers.common import dense_init, promoted_matmul

C_EXP = 8.0


def init_rglru(gen: torch.Generator, width: int, dtype, device="cpu"):
    """RG-LRU parameters drawn from ``gen`` (a seeded ``torch.Generator``);
    Lambda is set so that a^c spans ~(0.9, 0.999), as in Griffin."""
    dtype = torch_dtype(dtype)
    w_a = dense_init(gen, (width, width), dtype, device=device)
    w_x = dense_init(gen, (width, width), dtype, device=device)
    u = torch.empty((width,), dtype=torch.float32,
                    device=gen.device).uniform_(0.9, 0.999, generator=gen)
    root = u ** (1.0 / C_EXP)
    lam = torch.log(root / (1 - root))
    return {
        "w_a": w_a,
        "b_a": torch.zeros((width,), dtype=dtype, device=device),
        "w_x": w_x,
        "b_x": torch.zeros((width,), dtype=dtype, device=device),
        "Lambda": lam.to(device),
    }


def gate_inputs(params, x):
    """The sequence-parallel half: x (B, T, W) -> (log_a (B,T,W) fp32,
    gx (B,T,W) fp32)."""
    r = torch.sigmoid(
        (promoted_matmul(x, params["w_a"]) + params["b_a"]).float())
    i = torch.sigmoid(
        (promoted_matmul(x, params["w_x"]) + params["b_x"]).float())
    log_a = C_EXP * r * F.logsigmoid(params["Lambda"])
    gx = i * x.float()
    return log_a, gx


def scan_recurrence(log_a, gx, h0):
    """The serial half: h_t = a_t h_(t-1) + sqrt(1 - a_t^2) gx_t, all
    fp32; log_a, gx (B, T, W), h0 (B, W) -> (h_T (B, W), hs (B, T, W)),
    in the reference's order.  One ``rglru_scan`` call: one kernel launch
    on the card."""
    hs, hT = rglru_scan(log_a, gx, h0)
    return hT, hs


def apply_rglru(params, x, h0=None):
    """x (B, T, W) -> (y (B, T, W) in x's dtype, h_T fp32)."""
    B, T, W = x.shape
    if h0 is None:
        h0 = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    log_a, gx = gate_inputs(params, x)
    hT, hs = scan_recurrence(log_a, gx, h0)
    return hs.to(x.dtype), hT


def decode_step(params, x_t, h_prev):
    """x_t (B, W), h_prev (B, W) fp32 -> (y_t in x_t's dtype, h_t fp32).

    One step written as the reference writes it, a·h + sqrt(max(1 − a·a,
    0))·g with XLA's exp: outside a compiled scan JAX evaluates that
    expression op by op, with none of the scan's rewrites."""
    log_a, gx = gate_inputs(params, x_t[:, None, :])
    a = xla_exp(log_a[:, 0])
    h = a * h_prev + torch.sqrt(torch.clamp_min(1.0 - a * a, 0.0)) * gx[:, 0]
    return h.to(x_t.dtype), h


# ---------------------------------------------------------------------------
# temporal conv (width-k causal depthwise conv), part of the Griffin block
# ---------------------------------------------------------------------------


def init_conv1d(gen: torch.Generator, width: int, k: int, dtype,
                device="cpu"):
    dtype = torch_dtype(dtype)
    return {"w": dense_init(gen, (k, width), dtype, scale=0.5, device=device),
            "b": torch.zeros((width,), dtype=dtype, device=device)}


def apply_conv1d(params, x, state=None):
    """Causal depthwise conv.  x (B,T,W); state (B,k-1,W) for decode.

    Returns (y, new_state)."""
    k = params["w"].shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)  # (B, T+k-1, W)
    y = sum(xp[:, i:i + x.shape[1]] * params["w"][i] for i in range(k))
    y = y + params["b"]
    new_state = xp[:, xp.shape[1] - (k - 1):]
    return y.to(x.dtype), new_state


__all__ = ["C_EXP", "init_rglru", "gate_inputs", "scan_recurrence",
           "apply_rglru", "decode_step", "init_conv1d", "apply_conv1d"]
