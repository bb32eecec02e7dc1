"""The paper's LSTM: cell math + stack init.

Gate layout follows the paper's Fig. 2: order (i, f, g, o) stacked along the
4H axis so one GEMM produces all four gate pre-activations.  Parameters use
the JAX package's layout — {"W": (X, 4H), "U": (H, 4H), "b": (4H,)} per
layer, {"fwd": ..., "bwd": ...} per bidirectional layer — so the two
packages' stacks convert one to one (``repro_torch.convert``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import torch_dtype
from repro_torch.models.layers.common import dense_init


def init_lstm_layer(gen: torch.Generator, x_dim: int, hidden: int, dtype,
                    device="cpu"):
    dtype = torch_dtype(dtype)
    return {
        "W": dense_init(gen, (x_dim, 4 * hidden), dtype, device=device),
        "U": dense_init(gen, (hidden, 4 * hidden), dtype, device=device),
        "b": torch.zeros((4 * hidden,), dtype=dtype, device=device),
    }


def init_lstm_stack(gen: torch.Generator, cfg, dtype, device="cpu"):
    """A {"layers": [...]} stack for ``cfg`` with weights drawn from
    ``gen`` (a seeded ``torch.Generator``)."""
    layers = []
    x_dim = cfg.lstm_input
    for _ in range(cfg.n_layers):
        if cfg.bidirectional:
            layers.append({
                "fwd": init_lstm_layer(gen, x_dim, cfg.lstm_hidden, dtype,
                                       device),
                "bwd": init_lstm_layer(gen, x_dim, cfg.lstm_hidden, dtype,
                                       device),
            })
            x_dim = 2 * cfg.lstm_hidden
        else:
            layers.append(init_lstm_layer(gen, x_dim, cfg.lstm_hidden, dtype,
                                          device))
            x_dim = cfg.lstm_hidden
    return {"layers": layers}


def split_gates(g):
    """(..., 4H) -> i, f, g, o each (..., H)."""
    return torch.chunk(g, 4, dim=-1)


def cell_update(gates, c_prev):
    """Pointwise tail of the LSTM cell (SHARP's A-MFU + Cell-Updater stages).

    gates (..., 4H) pre-activation; returns (h, c).  fp32 internally.
    """
    i, f, g, o = split_gates(gates.float())
    c = torch.sigmoid(f) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_step(params, x_t, h_prev, c_prev):
    """One full step: both product halves + pointwise tail.  x_t (B, X);
    the weights and h_prev are cast to x_t's dtype, as in the reference."""
    dt = x_t.dtype
    gates = (x_t @ params["W"].to(dt) + h_prev.to(dt) @ params["U"].to(dt)
             + params["b"].to(dt))
    h, c = cell_update(gates, c_prev)
    return h.to(dt), c


def reference_unroll(params, xs):
    """Ground-truth layer evaluation: Python loop over time. xs (B, T, X)."""
    B, T, _ = xs.shape
    H = params["U"].shape[0]
    h = xs.new_zeros((B, H))
    c = torch.zeros((B, H), dtype=torch.float32, device=xs.device)
    outs = []
    for t in range(T):
        h, c = lstm_step(params, xs[:, t], h, c)
        outs.append(h)
    return torch.stack(outs, dim=1)
