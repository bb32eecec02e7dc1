"""Workload descriptors for the tile dispatcher (a copy of
``repro.dispatch.workitem``).

A ``WorkItem`` is the dispatcher's unit of admission: one recurrent stack
evaluation (family, B, T, H, L, dtype) plus scheduling metadata (priority,
soft deadline).  It is deliberately *shape-only* — parameters and inputs
are bound later, at execution — so the planner can be run offline over a
traffic mix (the software analogue of SHARP's offline configuration
exploration, §6.2.2) and its plans cached per shape.

``WorkItem.from_config`` extracts the recurrent core of any
``repro_torch.configs`` ModelConfig:

  family "rnn"            -> lstm  (the paper's own stacks; set
                                    ``rnn_family="gru"`` for the §8 GRU
                                    variant of the same dims)
  family "ssm" / "hybrid" -> rglru (the gated-linear-recurrence core of
                                    each recurrent block)

Anything without a recurrence (dense/moe/audio/vlm) has nothing for this
dispatcher to do and raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig

FAMILIES = ("lstm", "gru", "rglru")
GATES = {"lstm": 4, "gru": 3, "rglru": 1}

#: Weight precisions the fused sequence kernels execute: "fp32" is the
#: bit-exact default; "bf16" round-trips the recurrent matrix through
#: bfloat16 (exact vs its dequantized oracle); "int8" stores U as a
#: per-gate absmax int8 payload (4x smaller VMEM residency, fp32
#: accumulate) — bounded-error vs the dequantized oracle, not bit-equal
#: (see kernels.quant).
PRECISIONS = ("fp32", "bf16", "int8")

#: "none" runs dense; "block" row-compacts each layer's recurrent matrix
#: to its occupied MXU row-tiles (the ``tile_map`` bitmap) and the kernel
#: gathers h to the surviving rows — value-exact up to dot reduction
#: order.
SPARSITIES = ("none", "block")


@dataclass(frozen=True)
class WorkItem:
    uid: int
    family: str            # lstm | gru | rglru (layer-0 family)
    B: int                 # batch rows of this item (1 per serving request)
    T: int                 # time steps
    H: int                 # hidden / recurrence width
    L: int                 # recurrent layers
    X: int = 0             # layer-0 input width; 0 -> H
    dtype: str = "float32"
    priority: int = 0      # lower runs earlier within a slot/admission wave
    deadline_us: float = math.inf  # soft; tie-breaks equal priorities
    bidirectional: bool = False
    share: Optional[int] = None  # items with one non-None share key promise
    #                              to bind the SAME parameter stack at
    #                              execution (e.g. requests of one served
    #                              model), so their same-layer cells may
    #                              concatenate on B into one launch row
    #                              (cross-B packing) instead of occupying
    #                              separate G rows
    families: Optional[tuple] = None  # per-layer family, length L; None ->
    #                              homogeneous (family,) * L.  A mixed
    #                              lstm/gru stack wavefronts through the
    #                              same slot timeline — cells group into
    #                              launches by their OWN layer's family —
    #                              which is how the repro_torch.rnn facade runs
    #                              heterogeneous stacks (rglru layers have
    #                              no (h, c)-state sequence kernel and
    #                              cannot appear in a mixed stack)
    precision: str = "fp32"  # recurrent-weight precision (PRECISIONS); the
    #                              executor hoists the quantized payload and
    #                              the planner prices the narrowed VMEM
    #                              residency + MAC discount
    tile_map: Optional[tuple] = None  # block-sparsity occupancy: one
    #                              length-cdiv(H, MXU_ROWS) tuple of 0/1
    #                              per layer (bidirectional layers OR-union
    #                              their halves); None = dense.  Hashable,
    #                              so shape-keyed plan caching still works

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; {FAMILIES}")
        if self.X == 0:
            object.__setattr__(self, "X", self.H)
        if min(self.B, self.H, self.L) < 1 or self.T < 0:
            raise ValueError(f"degenerate item {self}")
        if self.families is None:
            object.__setattr__(self, "families", (self.family,) * self.L)
        else:
            fams = tuple(self.families)
            object.__setattr__(self, "families", fams)
            if len(fams) != self.L:
                raise ValueError(
                    f"item {self.uid}: families has {len(fams)} entries for "
                    f"L={self.L} layers")
            bad = [f for f in fams if f not in FAMILIES]
            if bad:
                raise ValueError(
                    f"item {self.uid}: unknown families {bad}; {FAMILIES}")
            if fams[0] != self.family:
                raise ValueError(
                    f"item {self.uid}: family={self.family!r} must equal "
                    f"families[0]={fams[0]!r}")
            if len(set(fams)) > 1:
                if not set(fams) <= {"lstm", "gru"}:
                    raise ValueError(
                        f"item {self.uid}: mixed-family stacks support "
                        f"lstm/gru layers only, got {sorted(set(fams))}")
                if self.bidirectional:
                    raise ValueError(
                        f"item {self.uid}: mixed-family stacks cannot be "
                        "bidirectional")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"item {self.uid}: unknown precision {self.precision!r}; "
                f"{PRECISIONS}")
        if self.tile_map is not None:
            from repro_torch.core.perfmodel import MXU_ROWS
            tm = tuple(tuple(int(b) for b in layer) for layer in self.tile_map)
            object.__setattr__(self, "tile_map", tm)
            n_tiles = -(-self.H // MXU_ROWS)
            if len(tm) != self.L:
                raise ValueError(
                    f"item {self.uid}: tile_map has {len(tm)} layers for "
                    f"L={self.L}")
            for li, layer in enumerate(tm):
                if len(layer) != n_tiles or not set(layer) <= {0, 1}:
                    raise ValueError(
                        f"item {self.uid}: tile_map[{li}] must be "
                        f"{n_tiles} 0/1 tile bits for H={self.H}, got "
                        f"{layer}")

    @property
    def gates(self) -> int:
        """Widest gate axis across the item's layers — what tiling / VMEM
        sizing must budget for (exact for homogeneous items)."""
        return max(GATES[f] for f in self.families)

    @property
    def dirs(self) -> int:
        """Directions per layer: 2 for bidirectional stacks, whose every
        layer contributes a fwd and a bwd cell walk to the planner's
        interleaved timeline (each with its own parameter half and
        recurrent state)."""
        return 2 if self.bidirectional else 1

    @property
    def heterogeneous(self) -> bool:
        return len(set(self.families)) > 1

    @property
    def density(self) -> float:
        """Mean occupied-tile fraction of the recurrent matrices (1.0 when
        dense) — the planner's skipped-tile discount."""
        if self.tile_map is None:
            return 1.0
        return (sum(sum(layer) for layer in self.tile_map)
                / sum(len(layer) for layer in self.tile_map))

    def layer_density(self, layer: int) -> float:
        """Occupied-tile fraction of one layer's recurrent matrix."""
        if self.tile_map is None:
            return 1.0
        bits = self.tile_map[layer]
        return sum(bits) / len(bits)

    @property
    def max_density(self) -> float:
        """Densest layer's occupied-tile fraction — what VMEM stripe
        selection must budget for (``block_t`` is item-uniform, so the
        densest layer's resident set is the binding constraint; ``density``
        is the mean, for launch-cost pricing)."""
        if self.tile_map is None:
            return 1.0
        return max(self.layer_density(l) for l in range(self.L))

    def order_key(self):
        """Admission / intra-slot ordering: priority, then deadline, then
        uid (total, deterministic)."""
        return (self.priority, self.deadline_us, self.uid)

    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg: ModelConfig, T: int, *, B: int = 1,
                    uid: int = 0, priority: int = 0,
                    deadline_us: float = math.inf,
                    rnn_family: str = "lstm",
                    share: Optional[int] = None) -> "WorkItem":
        """Extract the recurrent workload of ``cfg`` as a WorkItem."""
        if cfg.family == "rnn":
            return cls(uid=uid, family=rnn_family, B=B, T=T,
                       H=cfg.lstm_hidden, L=cfg.n_layers, X=cfg.lstm_input,
                       dtype=cfg.dtype, priority=priority,
                       deadline_us=deadline_us,
                       bidirectional=cfg.bidirectional, share=share)
        if cfg.family in ("ssm", "hybrid"):
            kinds = cfg.layer_kinds()
            n_rec = sum(1 for k in kinds if k != "attn") or cfg.n_layers
            return cls(uid=uid, family="rglru", B=B, T=T,
                       H=cfg.rglru_width or cfg.d_model, L=n_rec,
                       X=cfg.rglru_width or cfg.d_model, dtype=cfg.dtype,
                       priority=priority, deadline_us=deadline_us,
                       share=share)
        raise ValueError(
            f"config {cfg.name!r} (family {cfg.family!r}) has no recurrent "
            "core to dispatch")
