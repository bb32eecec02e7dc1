"""Critical-path cycle model of SHARP: the planner-facing half.

A copy of the dispatch-plan scoring half of ``repro.core.perfmodel``: the
``Design`` point, the per-step critical path of the paper's Fig. 8
schedules, and the plan/slot/decode cycle estimates the dispatch planner
scores candidates with.  The constants are the reference's (Table 1 of the
paper: 500 MHz, K/4 hidden elements retired per cycle, ACT_LAT fill
latency), so the port's plans equal the reference's.  The paper-figure
half (Fig. 9 to Table 6) is queued in ROADMAP.md.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.tiling import TileConfig, mvm_cycles, select_tile

FREQ_HZ = 500e6
ACT_LAT = 15  # pipeline-fill latency of the A-MFU (29.14ns @ ~2ns stages)


@dataclass(frozen=True)
class Design:
    macs: int
    k: int = 0                  # 0 -> offline-autotuned K_opt per model
    schedule: str = "unfolded"
    reconfigure: bool = True    # §6.2.1 padding reconfiguration
    freq_hz: float = FREQ_HZ
    pipeline_penalty: int = 0   # extra dependent-writeback stall (BrainWave)
    efficiency: float = 1.0     # static pipeline efficiency (BrainWave)


def _tile_for(design: Design, rows: int, cols: int) -> TileConfig:
    if design.k:
        return TileConfig(k=design.k, macs=design.macs)
    return select_tile(rows, cols, design.macs, reconfigure=design.reconfigure)


def step_cycles(H: int, X: int, design: Design) -> float:
    """Critical-path cycles of one LSTM time step under a schedule (Fig. 8)."""
    tile = _tile_for(design, 4 * H, max(H, X))
    rc = design.reconfigure
    upd_full = math.ceil(4 * H / tile.k)
    upd_chunk = max(1, upd_full // 4)  # output-based tiling: only last chunk exposed
    s = design.schedule
    if s == "sequential":
        mvm = 4 * (mvm_cycles(H, X, tile, rc) + mvm_cycles(H, H, tile, rc))
        cp = mvm + ACT_LAT + upd_full
    elif s == "batch":
        mvm = 4 * (mvm_cycles(H, X, tile, rc) + mvm_cycles(H, H, tile, rc))
        cp = mvm + ACT_LAT + upd_chunk + 2
    elif s == "intergate":
        mvm = mvm_cycles(4 * H, X, tile, rc) + mvm_cycles(4 * H, H, tile, rc)
        cp = mvm + ACT_LAT + upd_chunk
    elif s == "unfolded":
        mvm_h = mvm_cycles(4 * H, H, tile, rc)
        mvm_in = mvm_cycles(4 * H, X, tile, rc)
        # the serial tail hides under the (independent) next-step input MVM
        cp = mvm_h + max(mvm_in, ACT_LAT + upd_chunk)
    elif s == "epur":
        # E-PUR (paper §5/§9): hoists ALL input MVMs up front (locality), but
        # the recurrent phase is fully serial — hidden MVM then the complete
        # activation + cell/hidden update, nothing overlapped across steps.
        mvm_h = mvm_cycles(4 * H, H, tile, rc)
        mvm_in = mvm_cycles(4 * H, X, tile, rc)
        cp = mvm_in + mvm_h + ACT_LAT + upd_full
    else:
        raise ValueError(s)
    return (cp + design.pipeline_penalty) / design.efficiency


# ===========================================================================
# dispatch-plan scoring (repro.dispatch planner)
# ===========================================================================

# Fixed cost charged per kernel launch (dispatch + state HBM round-trip) —
# the cycle-model analogue of what the sequence-fused kernels eliminate.
# Calibrated coarse: a launch is worth a few hundred retired tiles.
LAUNCH_CYCLES = 400


def recurrent_step_cycles(family: str, H: int, X: int, design: Design) -> float:
    """Per-step critical-path cycles of one recurrent cell under the design's
    schedule, per family.  RG-LRU has no recurrent MVM (diagonal recurrence):
    its step is the pointwise tail only."""
    if family == "lstm":
        return step_cycles(H, X, design)
    if family == "gru":
        from repro_torch.core.gru import gru_step_cycles

        return gru_step_cycles(H, X, design)
    if family == "rglru":
        return ACT_LAT + math.ceil(H / max(design.k or 64, 1))
    raise ValueError(family)


def stack_plan_cycles(family: str, H: int, X: int, T: int, L: int,
                      design: Design, *, nk: int,
                      launch_cycles: float = LAUNCH_CYCLES) -> float:
    """Wall-clock cycle estimate of running an L-layer stack over T steps as
    an (L x nk) wavefront of time-chunks (nk=1 == the per-layer fused path).

    Slot s holds up to min(L, nk) cells which execute *concurrently* on the
    tile engine (one G-batched launch), so the wall is the slot count times
    one chunk's serial cost, plus the per-launch overhead — the quantity the
    planner minimizes when it chooses a schedule and T-striping per item.
    """
    nk = max(1, min(nk, T)) if T else 1
    bt = -(-T // nk) if T else 0
    per0 = recurrent_step_cycles(family, H, X, design)
    per = recurrent_step_cycles(family, H, H, design) if L > 1 else per0
    # a slot's serial cost is one chunk through one (average) layer: the
    # wave mixes layer-0 and deeper cells, so charge the stack's per-layer
    # mean — this also keeps nk=1 exactly equal to per_step's compute
    # (same work, L launches instead of L·T)
    slot_cost = bt * (per0 + (L - 1) * per) / L
    slots = L + nk - 1
    return slots * slot_cost + slots * launch_cycles


def bidir_stack_plan_cycles(family: str, H: int, X: int, T: int, L: int,
                            design: Design, *, nk: int,
                            launch_cycles: float = LAUNCH_CYCLES) -> float:
    """Wall-clock cycle estimate of an L-layer *bidirectional* stack run as
    the interleaved fwd/bwd wavefront (dispatch planner).

    Each layer contributes a fwd chunk walk (time-ascending) and a bwd walk
    (time-descending) over the same nk chunk boundaries.  The concat
    dependency — layer l+1's chunk k needs BOTH fwd chunk k and bwd chunk k
    of layer l — means the walks of consecutive layers barely overlap, so
    the timeline is L·nk waves; but within a wave the two directions are
    data-independent and share ONE G-batched launch (they hide each other's
    serial tails), halving the serial wall versus running the directions
    back to back.  Ragged T adds two unmerged waves per layer (the
    remainder chunk meets a full-length chunk of the opposite direction,
    breaking the launch signature), each costing one extra launch.
    """
    nk = max(1, min(nk, T)) if T else 1
    bt = -(-T // nk) if T else 0
    per0 = recurrent_step_cycles(family, H, X, design)
    # deeper layers consume the previous layer's CONCAT output (2H wide)
    per = recurrent_step_cycles(family, H, 2 * H, design) if L > 1 else per0
    slot_cost = bt * (per0 + (L - 1) * per) / L
    waves = L * nk
    ragged = 2 if (T and nk > 1 and T % bt) else 0
    launches = L * (nk + ragged)
    return waves * slot_cost + launches * launch_cycles


def per_step_plan_cycles(family: str, H: int, X: int, T: int, L: int,
                         design: Design, *,
                         launch_cycles: float = LAUNCH_CYCLES) -> float:
    """Wall-clock cycle estimate of the per-step fallback: every (layer,
    timestep) cell is its own launch with its state round-tripping HBM."""
    per0 = recurrent_step_cycles(family, H, X, design)
    per = recurrent_step_cycles(family, H, H, design) if L > 1 else per0
    return T * (per0 + (L - 1) * per) + L * T * launch_cycles


# B rows retire through the datapath in row-tiles of this width (the MXU/
# sublane granularity): padding a cell's B up to the tile edge is free,
# which is what makes B-widened (padded + masked) slots usually beat an
# extra same-signature launch.
MXU_ROWS = 8

#: Relative per-step MAC cost under each recurrent-weight precision.
#: fp32 is the unit; bf16 narrows the weight operand (half the weight
#: bandwidth feeding the MXU); int8 halves it again plus the dequantize
#: ride-along on the accumulate.  These are planner-scoring ratios, not
#: silicon truth — ``cost_model="measured"`` replaces them with replayed
#: reality (calib signatures carry the precision tag).
PRECISION_MAC_FACTOR = {"fp32": 1.0, "bf16": 0.75, "int8": 0.5}


def slot_launch_cycles(family: str, H: int, chunk_len: int,
                       widths: Sequence[int], design: Design, *,
                       launch_cycles: float = LAUNCH_CYCLES,
                       precision: str = "fp32",
                       density: float = 1.0) -> float:
    """Cycle cost of ONE G-batched sequence-kernel launch whose g-rows are
    the given batch widths, padded to max(widths).

    The kernel grid walks rows serially; each row's per-step cost scales
    with its padded B-row-tile count.  The planner uses this to score a
    B-widened slot (pad ragged widths to one launch, mask the dead rows)
    against splitting by width (exact rows, one more launch each) — the
    "B-widened vs G-batched" decision of cross-B packing.

    ``precision`` applies the PRECISION_MAC_FACTOR discount and
    ``density`` the block-sparse skipped-row-tile discount (the recurrent
    MVM only visits occupied input-row tiles) — both scale the per-step
    MAC term, never the launch overhead."""
    per = recurrent_step_cycles(family, H, H, design)
    per *= PRECISION_MAC_FACTOR[precision] * density
    row_tiles = math.ceil(max(widths) / MXU_ROWS)
    return len(widths) * chunk_len * per * row_tiles + launch_cycles


def decode_plan_cycles(family: str, H: int, X: int, L: int, design: Design, *,
                       launch_cycles: float = LAUNCH_CYCLES) -> float:
    """Wall-clock cycle estimate of one chained T=1 decode launch: the L
    layer cells are serially dependent (no wavefront exists at T=1), but
    they share a single launch — the layer chain runs through VMEM scratch
    inside one kernel — so only one launch overhead is paid per tick,
    versus L for the per-layer path (stack_plan_cycles with nk=1)."""
    per0 = recurrent_step_cycles(family, H, X, design)
    per = recurrent_step_cycles(family, H, H, design) if L > 1 else per0
    return per0 + (L - 1) * per + launch_cycles
