"""SHARP's LSTM schedules (paper §5, Fig. 8) as PyTorch computation orders,
the per-layer stack walk, and the wavefront geometry the dispatch planner
uses — the port of ``repro.core.schedules``.

All schedules compute the same function; they differ in dependence
structure:

  sequential  one gate after another per time step; the cell/hidden update
              waits for the last (output) gate.
  batch       same order, the 4H gate axis dispatched in column tiles.
  intergate   all four gates as one fused product per step.
  unfolded    SHARP's contribution: the input half W·x_t of EVERY step is
              hoisted into one sequence-parallel GEMM; the walk keeps only
              U·h_{t-1} + the pointwise tail.  ``cell_kernel`` plugs a fused
              one-step kernel in (``kernels.lstm_cell.as_cell_kernel``: the
              per_step schedule, one ``lstm_cell`` launch per step).
  fused       the recurrence itself in ONE ``lstm_seq`` launch per layer.

The research schedules (sequential, batch, intergate, plain unfolded) run
in plain PyTorch on any device, as the reference runs them in plain jnp.
``reference_stack`` is the per-layer oracle over a whole stack (mixed
lstm/gru and bidirectional aware).  The reference's deprecated
``run_layer`` / ``run_stack`` shims are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.core.unfolded import unfold
from repro_torch.kernels.common import cdiv
from repro_torch.models.layers.common import input_half, promoted_matmul
from repro_torch.models.layers.lstm import cell_update

SCHEDULES = ("sequential", "batch", "intergate", "unfolded", "fused")
STACK_SCHEDULES = SCHEDULES + ("wavefront",)


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------


def _init_state(B: int, H: int, dtype, device):
    return (torch.zeros((B, H), dtype=dtype, device=device),
            torch.zeros((B, H), dtype=torch.float32, device=device))


def _walk(seq, H, dtype, step):
    """Walk ``step((h, c), seq[:, t]) -> (h, c)`` over T from zero state
    (h in ``dtype``, c fp32); returns the stacked h (B, T, H)."""
    B, T, _ = seq.shape
    state = _init_state(B, H, dtype, seq.device)
    outs = []
    for t in range(T):
        state = step(state, seq[:, t])
        outs.append(state[0])
    return torch.stack(outs, dim=1)


def _cell(gates, c, dtype):
    h, c = cell_update(gates, c)
    return h.to(dtype), c


def run_layer_sequential(params, xs):
    """One gate at a time; update strictly after the O gate (Fig. 8.a)."""
    H = params["U"].shape[0]
    W, U, b = params["W"], params["U"], params["b"]

    def step(state, x_t):
        h, c = state
        gates = []
        for g in range(4):  # i, f, g, o — strictly in order
            cols = slice(g * H, (g + 1) * H)
            gates.append(promoted_matmul(x_t, W[:, cols])
                         + promoted_matmul(h, U[:, cols]) + b[cols])
        return _cell(torch.cat(gates, dim=-1), c, xs.dtype)

    return _walk(xs, H, xs.dtype, step)


def run_layer_batch(params, xs, tile_cols: int = 0):
    """Tiled dispatch: the 4H gate axis is processed in column tiles whose
    partial results stream into the accumulator (Fig. 8.b)."""
    H = params["U"].shape[0]
    W, U, b = params["W"], params["U"], params["b"]
    tc = tile_cols or min(4 * H, 512)
    n_tiles = cdiv(4 * H, tc)

    def step(state, x_t):
        h, c = state
        parts = []
        for i in range(n_tiles):  # tile-by-tile dispatch
            cols = slice(i * tc, min((i + 1) * tc, 4 * H))
            parts.append(promoted_matmul(x_t, W[:, cols])
                         + promoted_matmul(h, U[:, cols]) + b[cols])
        return _cell(torch.cat(parts, dim=-1), c, xs.dtype)

    return _walk(xs, H, xs.dtype, step)


def run_layer_intergate(params, xs):
    """All four gates fused per step (Fig. 8.c)."""
    H = params["U"].shape[0]

    def step(state, x_t):
        h, c = state
        gates = (promoted_matmul(x_t, params["W"])
                 + promoted_matmul(h, params["U"]) + params["b"])
        return _cell(gates, c, xs.dtype)

    return _walk(xs, H, xs.dtype, step)


def run_layer_unfolded(params, xs, cell_kernel=None):
    """SHARP: hoisted input GEMM + recurrent-only walk (Fig. 8.d).

    ``cell_kernel``: optional fused recurrent-step implementation with
    signature (U, xw_t, h, c) -> (h, c) — ``lstm_cell`` plugs in here
    through ``kernels.lstm_cell.ops.as_cell_kernel``."""
    H = params["U"].shape[0]
    xw = input_half(params, xs)

    if cell_kernel is None:
        def step(state, xw_t):
            h, c = state
            return _cell(xw_t + promoted_matmul(h, params["U"]), c,
                         xs.dtype)
    else:
        def step(state, xw_t):
            return cell_kernel(params["U"], xw_t, *state)

    return _walk(xw, H, xs.dtype, step)


def run_layer_fused(params, xs, block_t: int = 0, seq_kernel=None,
                    return_state: bool = False):
    """Sequence-fused schedule: the whole recurrence in ONE kernel launch.

    The input half is hoisted exactly as in ``unfolded`` (routed through
    ``core.unfolded.unfold``), and the walk is the sequence kernel's.
    ``return_state``: also return the exact t=T (h, c)."""
    from repro_torch.kernels.lstm_cell.ops import as_seq_kernel

    B, _, _ = xs.shape
    H = params["U"].shape[0]
    kern = seq_kernel or as_seq_kernel(block_t=block_t)

    def seq_fn(state, pre):
        h0, c0 = state
        hs, h_n, c_n = kern(params["U"], pre, h0, c0)
        return (h_n.to(xs.dtype), c_n), hs.to(xs.dtype)

    state, hs = unfold(lambda x: input_half(params, x), None, xs,
                       _init_state(B, H, xs.dtype, xs.device),
                       seq_fn=seq_fn)
    return (hs, state) if return_state else hs


LAYER_FNS = {
    "sequential": run_layer_sequential,
    "batch": run_layer_batch,
    "intergate": run_layer_intergate,
    "unfolded": run_layer_unfolded,
    "fused": run_layer_fused,
}


# ---------------------------------------------------------------------------
# stack introspection, the per-layer walk and the oracle
# ---------------------------------------------------------------------------


def stack_families(stack_params):
    """Per-layer recurrence family of a parameter stack, inferred from the
    gate-axis width: U (H, 4H) -> lstm, U (H, 3H) -> gru.  Bidirectional
    layers are classified by their fwd half."""
    fams = []
    for i, layer in enumerate(stack_params["layers"]):
        half = layer.get("fwd", layer)
        H, G = half["U"].shape
        if G == 4 * H:
            fams.append("lstm")
        elif G == 3 * H:
            fams.append("gru")
        else:
            raise ValueError(
                f"layer {i}: unrecognized gate width {G} for H={H} "
                "(expected 4H lstm / 3H gru)")
    return tuple(fams)


def walk_stack(stack_params, xs, one):
    """THE per-layer stack walk (family- and bidirectional-aware), shared
    by the oracle and the executor's external path: ``one(family,
    layer_params, y) -> y`` is applied layer by layer, with bidirectional
    layers running fwd on y and bwd on the time-flipped y, concatenated on
    the feature axis."""
    fams = stack_families(stack_params)
    y = xs
    for fam, layer in zip(fams, stack_params["layers"]):
        if "fwd" in layer:  # bidirectional
            f = one(fam, layer["fwd"], y)
            b = one(fam, layer["bwd"], torch.flip(y, dims=[1]))
            y = torch.cat([f, torch.flip(b, dims=[1])], dim=-1)
        else:
            y = one(fam, layer, y)
    return y


def _family_fns(fam):
    if fam == "lstm":
        return LAYER_FNS
    from repro_torch.core import gru as gru_mod

    return gru_mod.LAYER_FNS


def reference_stack(stack_params, xs, schedule: str = "unfolded"):
    """Run a stack through the per-layer reference implementations —
    family-aware per layer (mixed lstm/gru stacks run each layer through
    its own library) and bidirectional-aware.  Not routed through the
    dispatcher."""
    def one(fam, layer, y):
        fns = _family_fns(fam)
        if schedule not in fns:
            raise ValueError(f"unknown schedule {schedule!r}; "
                             f"{fam} options {tuple(fns)}")
        return fns[schedule](layer, y)

    return walk_stack(stack_params, xs, one)


# ---------------------------------------------------------------------------
# wavefront geometry (shared with the dispatch planner)
# ---------------------------------------------------------------------------


def wavefront_slots(n_layers: int, T: int, block_t: int) -> int:
    """Number of anti-diagonal slots: L + ceil(T / block_t) - 1."""
    return n_layers + cdiv(T, block_t) - 1


def wavefront_active(s: int, n_layers: int, nk: int):
    """Layer range [lo, hi] whose cells (l, k=s-l) are live in slot ``s``
    of an (n_layers x nk) wavefront; empty range when s is out of bounds."""
    lo = max(0, s - nk + 1)
    hi = min(n_layers - 1, s)
    return lo, hi
