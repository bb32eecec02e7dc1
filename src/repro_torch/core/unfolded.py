"""Generalized Unfolded scheduling: the paper's technique as a reusable
tool (the port of ``repro.core.unfolded``).

``unfold`` factors any gated recurrence into:
  (1) an input half computed for all T steps as one sequence-parallel GEMM
      (no recurrent dependency), and
  (2) a recurrent walk whose body consumes the precomputed slice.

``run_layer_unfolded_tp`` is its distributed form: the 4H gate axis is
sharded over the ``model`` axis of a ``DeviceMesh``, so each rank holds a
(H x 4H/n) slice of U and computes its slice of every step's gates with
the ``mvm`` kernel — the mesh's rendition of Fig. 8.d, where the tree
adder's implicit synchronisation becomes a collective.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.mvm_tile.ops import mvm


def unfold(input_fn: Callable, recur_fn: Optional[Callable], xs, state, *,
           seq_fn: Optional[Callable] = None):
    """Generic unfolded runner.

    input_fn: xs (B,T,...) -> precomputed (B,T,...) input-half tensor
    recur_fn: (state, pre_t) -> (state, out_t)
    seq_fn:   (state, pre) -> (state, outs) — a sequence-fused recurrence
              (e.g. ``kernels.lstm_cell.ops.as_seq_kernel``) that consumes
              the whole precomputed tensor in ONE kernel launch, replacing
              the per-step walk entirely.  ``pre``/``outs`` stay batch-major.
    """
    pre = input_fn(xs)
    if seq_fn is not None:
        return seq_fn(state, pre)
    outs = []
    for t in range(pre.shape[1]):
        state, out = recur_fn(state, pre[:, t])
        outs.append(out)
    return state, torch.stack(outs, dim=1)


# ---------------------------------------------------------------------------
# distributed LSTM layer (gate-dim tensor parallel)
# ---------------------------------------------------------------------------


def lstm_param_specs(mesh_axis: str = "model"):
    """Partition specs for an LSTM layer: gate (4H) axis sharded."""
    from repro_torch.sharding.partition import P

    return {"W": P(None, mesh_axis), "U": P(None, mesh_axis),
            "b": P(mesh_axis)}


def run_layer_unfolded_tp(params, xs, mesh, axis: str = "model"):
    """Unfolded schedule with the gate axis tensor-parallel over ``axis``
    of ``mesh`` (a ``DeviceMesh``).

    params {"W", "U", "b"} in the reference's gate-major layout, plain or
    DTensors; they are laid out by ``lstm_param_specs`` (contiguous 4H/n
    slices of [i|f|g|o]).  xs (B, T, X) is replicated on ``axis`` (a
    batch sharding over another mesh axis is kept).  Returns hs (B, T, H)
    in xs's dtype as a DTensor, replicated on ``axis``.

    Rank r's slice of the gate axis holds whole gates of only some kinds,
    and ``cell_update`` needs all four gates of a unit.  So, as GSPMD
    does for the reference, each step gathers the gates: every rank
    computes its 4H/n gate columns (its slice of the hoisted input half
    plus h @ U_r through the ``mvm`` kernel), the columns are all-gathered
    to (B, 4H), and every rank runs the cell update on all of them, which
    leaves h (and c) replicated for the next step's product."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.layers.common import promoted_matmul
    from repro_torch.models.layers.lstm import cell_update
    from repro_torch.sharding import local
    from repro_torch.sharding.partition import NamedSharding, shard_tensor

    specs = lstm_param_specs(axis)
    W, U, b = (shard_tensor(params[k], NamedSharding(mesh, specs[k]))
               .to_local() for k in ("W", "U", "b"))
    xs = local.as_dtensor(xs, mesh)
    names = mesh.mesh_dim_names
    rowp = [Shard(0) if n != axis and p == Shard(0) else Replicate()
            for n, p in zip(names, xs.placements)]
    ax = names.index(axis)
    xl = xs.redistribute(mesh, rowp).to_local()
    Bg, T = xs.shape[0], xs.shape[1]
    H = U.shape[0]
    # sequence-parallel input half: one GEMM for every step, gate-sharded
    xw = promoted_matmul(xl, W) + b
    h = torch.zeros((xl.shape[0], H), dtype=xl.dtype, device=xl.device)
    c = torch.zeros((xl.shape[0], H), dtype=torch.float32, device=xl.device)
    outs = []
    for t in range(T):
        gates = xw[:, t] + mvm(h, U)  # this rank's 4H/n gate columns
        gates = local.all_gather_over(gates, mesh, ax, 1)
        h, c = cell_update(gates, c)
        h = h.to(xl.dtype)
        outs.append(h)
    return local.wrap(torch.stack(outs, dim=1), mesh, rowp, (Bg, T, H))
