"""GRU under SHARP's schedules (paper §8: "the same improvement can be
achieved in other networks that have similar design, such as GRU").

A copy of ``repro.core.gru`` in PyTorch.  The candidate gate
    n_t = tanh(W_n x_t + r_t * (U_n h_{t-1}) + b_n)
couples the recurrent product with the reset gate *multiplicatively*, so
only W·x is hoistable and the three recurrent products (U_z, U_r, U_n)
stay serial.  The schedules below mirror ``core.schedules`` and agree
numerically; ``fused`` runs the whole recurrence as ONE ``gru_seq``
launch (``kernels.gru_cell``).  The deprecated ``run_layer`` shim of the
reference is not ported.

Gate order along the 3H axis: (z, r, n).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import torch_dtype
from repro_torch.models.layers.common import (dense_init, input_half,
                                              promoted_matmul)

SCHEDULES = ("sequential", "intergate", "unfolded", "fused")


def init_gru_layer(gen: torch.Generator, x_dim: int, hidden: int, dtype,
                   device="cpu"):
    dtype = torch_dtype(dtype)
    return {
        "W": dense_init(gen, (x_dim, 3 * hidden), dtype, device=device),
        "U": dense_init(gen, (hidden, 3 * hidden), dtype, device=device),
        "b": torch.zeros((3 * hidden,), dtype=dtype, device=device),
    }


def init_gru_stack(gen: torch.Generator, x_dim: int, hidden: int,
                   n_layers: int, dtype, device="cpu"):
    """Multi-layer GRU stack params, shaped like ``init_lstm_stack``'s
    ({"layers": [...]}) so the dispatcher treats LSTM and GRU stacks
    uniformly; weights drawn from ``gen`` (a seeded ``torch.Generator``)."""
    return {"layers": [init_gru_layer(gen, x_dim if i == 0 else hidden,
                                      hidden, dtype, device)
                       for i in range(n_layers)]}


def _gates(xw, hu, H):
    """xw, hu (B, 3H) pre-activations -> (z, n) in fp32."""
    z = torch.sigmoid((xw[:, :H] + hu[:, :H]).float())
    r = torch.sigmoid((xw[:, H:2 * H] + hu[:, H:2 * H]).float())
    n = torch.tanh(xw[:, 2 * H:].float() + r * hu[:, 2 * H:].float())
    return z, n


def _update(z, n, h, dtype):
    return ((1 - z) * n + z * h.float()).to(dtype)


def gru_step(params, x_t, h):
    H = params["U"].shape[0]
    xw = promoted_matmul(x_t, params["W"]) + params["b"]
    hu = promoted_matmul(h, params["U"])
    z, n = _gates(xw, hu, H)
    return _update(z, n, h, x_t.dtype)


def reference_unroll(params, xs):
    B, T, _ = xs.shape
    H = params["U"].shape[0]
    h = xs.new_zeros((B, H))
    outs = []
    for t in range(T):
        h = gru_step(params, xs[:, t], h)
        outs.append(h)
    return torch.stack(outs, dim=1)


def run_layer_sequential(params, xs):
    """One gate product pair after another per step."""
    B, T, _ = xs.shape
    H = params["U"].shape[0]
    h = xs.new_zeros((B, H))
    outs = []
    for t in range(T):
        x_t = xs[:, t]
        parts_x, parts_h = [], []
        for g in range(3):
            cols = slice(g * H, (g + 1) * H)
            parts_x.append(promoted_matmul(x_t, params["W"][:, cols])
                           + params["b"][cols])
            parts_h.append(promoted_matmul(h, params["U"][:, cols]))
        z, n = _gates(torch.cat(parts_x, -1), torch.cat(parts_h, -1), H)
        h = _update(z, n, h, xs.dtype)
        outs.append(h)
    return torch.stack(outs, dim=1)


def run_layer_intergate(params, xs):
    """All three gate products fused per step: ``gru_step`` walked over T,
    the step order of ``reference_unroll``."""
    return reference_unroll(params, xs)


def run_layer_unfolded(params, xs):
    """Input half W·x hoisted for every step; U·h (all three gates, fused)
    stays serial — the GRU-shaped Unfolded split."""
    B, T, _ = xs.shape
    H = params["U"].shape[0]
    xw = input_half(params, xs)
    h = xs.new_zeros((B, H))
    outs = []
    for t in range(T):
        z, n = _gates(xw[:, t], promoted_matmul(h, params["U"]), H)
        h = _update(z, n, h, xs.dtype)
        outs.append(h)
    return torch.stack(outs, dim=1)


def run_layer_fused(params, xs, block_t: int = 0,
                    return_state: bool = False):
    """Sequence-fused schedule: the whole GRU recurrence in ONE
    ``gru_seq`` launch.  ``return_state``: also return the exact t=T
    hidden state."""
    from repro_torch.kernels.gru_cell.ops import gru_seq

    B, T, _ = xs.shape
    H = params["U"].shape[0]
    xw = input_half(params, xs).reshape(B, T, 3, H)
    hs, h_n = gru_seq(params["U"].reshape(H, 3, H), xw, block_t=block_t)
    hs = hs.to(xs.dtype)
    return (hs, h_n.to(xs.dtype)) if return_state else hs


LAYER_FNS = {"sequential": run_layer_sequential,
             "intergate": run_layer_intergate,
             "unfolded": run_layer_unfolded, "fused": run_layer_fused}


# --- perf-model hook (3 gates instead of 4; tail has no cell state) --------


def gru_step_cycles(H: int, X: int, design) -> float:
    """Critical-path cycles per GRU step under the SHARP model."""
    from repro_torch.core.perfmodel import ACT_LAT, _tile_for
    from repro_torch.core.tiling import mvm_cycles

    tile = _tile_for(design, 3 * H, max(H, X))
    rc = design.reconfigure
    upd_chunk = max(1, math.ceil(3 * H / tile.k) // 3)
    s = design.schedule
    if s == "sequential":
        mvm = 3 * (mvm_cycles(H, X, tile, rc) + mvm_cycles(H, H, tile, rc))
        return (mvm + ACT_LAT + upd_chunk * 3
                + design.pipeline_penalty) / design.efficiency
    if s == "intergate":
        mvm = mvm_cycles(3 * H, X, tile, rc) + mvm_cycles(3 * H, H, tile, rc)
        return (mvm + ACT_LAT + upd_chunk
                + design.pipeline_penalty) / design.efficiency
    if s == "unfolded":
        mvm_h = mvm_cycles(3 * H, H, tile, rc)
        mvm_in = mvm_cycles(3 * H, X, tile, rc)
        return (mvm_h + max(mvm_in, ACT_LAT + upd_chunk)
                + design.pipeline_penalty) / design.efficiency
    raise ValueError(s)
