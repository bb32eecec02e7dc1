"""The yardstick: one H100's published peaks and the work of a recurrent
stack's calls, counted from shapes alone, whatever implements them.

Work of one item (one time step of one stream, through every layer and
direction): a layer reads its input x (X_l wide) and its previous h (H
wide), and both products feed an LSTM's 4 gates, so it costs
2 * (X_l + H) * 4 * H FLOPs.  The pointwise tail is left out: it is
O(H) an item against O(H^2) for the products.

Bytes of one call, each counted once: every layer's W and U in the type
they are bound in, the call's input items and initial states, its top
layer's output items and its final states.  A prefill call starts from
zero state, so it reads none.

Bound of a call: the larger of its bytes over the HBM bandwidth and its
FLOPs over the dense rate of the weights' precision, so that no kernel,
tensor cores included, can read over 100%.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense rates (no sparsity), at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "int8": 1979e12, "float8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12

GATES = 4  # an LSTM's i, f, g, o
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}
STATE_BYTES = 4  # the recurrent state and the frames are fp32


def dirs(cfg: dict) -> int:
    return 2 if cfg["bidirectional"] else 1


def layer_inputs(cfg: dict) -> list:
    """X_l of every layer: the frame width at layer 0, then H times the
    number of directions."""
    H = cfg["hidden"]
    return [cfg["input"]] + [H * dirs(cfg)] * (cfg["n_layers"] - 1)


def flops_per_item(cfg: dict) -> int:
    """Model FLOPs of one item through the whole stack."""
    H, g = cfg["hidden"], GATES
    return sum(2 * (x + H) * g * H for x in layer_inputs(cfg)) * dirs(cfg)


def weight_bytes(cfg: dict) -> int:
    """Every layer's W, U and b, once, in the type they are bound in."""
    H, g = cfg["hidden"], GATES
    per = DTYPE_BYTES[cfg["weight_dtype"]]
    n = sum(x * g * H + H * g * H + g * H for x in layer_inputs(cfg))
    return n * dirs(cfg) * per


def state_bytes(cfg: dict, rows: int) -> int:
    """The recurrent state of ``rows`` streams: h and c of every layer
    and direction."""
    return (cfg["n_layers"] * dirs(cfg) * 2 * rows * cfg["hidden"]
            * STATE_BYTES)


def call_work(cfg: dict, items: int, rows: int, reads_state: bool):
    """(FLOPs, bytes) of one call over ``items`` items in ``rows``
    streams: a prefill wave (``reads_state`` False) or a decode tick
    (True, ``items == rows``)."""
    io = items * (cfg["input"] + cfg["hidden"] * dirs(cfg)) * STATE_BYTES
    states = state_bytes(cfg, rows) * (2 if reads_state else 1)
    return (items * flops_per_item(cfg),
            weight_bytes(cfg) + io + states)


def bound_s(cfg: dict, flops: float, nbytes: float) -> float:
    """The least time the chip could take for this work."""
    return max(nbytes / PEAK_BYTES_PER_S,
               flops / PEAK_FLOPS[cfg["weight_dtype"]])
