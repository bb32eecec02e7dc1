"""Generalized Unfolded scheduling: the paper's technique as a reusable
tool (the single-device half of ``repro.core.unfolded``).

``unfold`` factors any gated recurrence into:
  (1) an input half computed for all T steps as one sequence-parallel GEMM
      (no recurrent dependency), and
  (2) a recurrent walk whose body consumes the precomputed slice.

The reference's tensor-parallel half (``run_layer_unfolded_tp``, the gate
axis sharded over a device mesh) waits for the port of ``sharding/``
(ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


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
