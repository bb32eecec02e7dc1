"""Stack introspection and wavefront geometry (the part of
``repro.core.schedules`` the dispatch planner and the rnn front-end use).

The research schedules and the pure reference walk of that module are
queued in ROADMAP.md; the port's oracle is the JAX package itself.
"""
from __future__ import annotations

from repro_torch.kernels.common import cdiv


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


def wavefront_slots(n_layers: int, T: int, block_t: int) -> int:
    """Number of anti-diagonal slots: L + ceil(T / block_t) - 1."""
    return n_layers + cdiv(T, block_t) - 1


def wavefront_active(s: int, n_layers: int, nk: int):
    """Layer range [lo, hi] whose cells (l, k=s-l) are live in slot ``s``
    of an (n_layers x nk) wavefront; empty range when s is out of bounds."""
    lo = max(0, s - nk + 1)
    hi = min(n_layers - 1, s)
    return lo, hi
