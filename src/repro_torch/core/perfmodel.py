"""Critical-path cycle model of SHARP (and the E-PUR / BrainWave baselines).

A copy of ``repro.core.perfmodel``: plain Python arithmetic over the
paper's ASIC, with no tensors and no device, so every number equals the
reference's.  It models the three-stage pipeline (Compute Unit -> A-MFU
-> Cell Updater) per schedule, and serves two callers:

* the dispatch planner, which scores candidate plans with the
  plan/slot/decode cycle estimates (``stack_plan_cycles`` ...
  ``decode_plan_cycles``);
* the paper's figures and tables, regenerated from the same model:

  Fig. 9   K-width exploration          -> ``fig9_kwidth_sweep``
  Fig. 10  padding reconfiguration      -> ``fig10_padding_speedup``
  Fig. 11  schedule comparison          -> ``fig11_schedule_speedups``
  Fig. 12  latency & utilization        -> ``fig12_latency_utilization``
  Table 4  vs BrainWave (DeepBench)     -> ``table4_vs_brainwave``
  Table 6  vs E-PUR (4 networks)        -> ``table6_vs_epur``
  Fig. 14  energy vs E-PUR              -> ``fig14_energy``

Model constants follow Table 1 of the paper: 500 MHz, K/4 hidden
elements retired per cycle by the Cell Updater, pipelined activation
(1/cycle throughput, ACT_LAT fill latency from the 29.14 ns synthesized
tanh critical path).  The cycles, powers and GFLOPS/W here are the
paper's ASIC's, never the card's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiling import K_CHOICES, TileConfig, mvm_cycles, select_tile

FREQ_HZ = 500e6
ACT_LAT = 15  # pipeline-fill latency of the A-MFU (29.14ns @ ~2ns stages)
# Fig. 15 caption: total power under 1K..64K MACs
POWER_W = {1024: 8.11, 4096: 11.36, 16384: 22.13, 65536: 47.7}
# §8: SHARP dissipates 1.4%..36% more power than E-PUR at 1K..64K
EPUR_POWER_RATIO = {1024: 1.014, 4096: 1.10, 16384: 1.25, 65536: 1.36}
PEAK_TFLOPS = {1024: 0.46e12, 4096: 1.86e12, 16384: 7.4e12, 65536: 29.8e12}


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


def layer_cycles(H: int, X: int, T: int, design: Design,
                 bidirectional: bool = False) -> float:
    per = step_cycles(H, X, design)
    dirs = 2 if bidirectional else 1
    return dirs * T * per


def network_cycles(cfg: ModelConfig, T: int, design: Design) -> float:
    """Whole network: layer l>0 consumes the previous layer's hidden output
    ((2)H wide when bidirectional)."""
    H = cfg.lstm_hidden
    X = cfg.lstm_input
    total = 0.0
    for l in range(cfg.n_layers):
        x_dim = X if l == 0 else H * (2 if cfg.bidirectional else 1)
        total += layer_cycles(H, x_dim, T, design, cfg.bidirectional)
    return total


def network_time_s(cfg: ModelConfig, T: int, design: Design) -> float:
    return network_cycles(cfg, T, design) / design.freq_hz


def ideal_cycles(cfg: ModelConfig, T: int, macs: int) -> float:
    H, X = cfg.lstm_hidden, cfg.lstm_input
    dirs = 2 if cfg.bidirectional else 1
    total = 0.0
    for l in range(cfg.n_layers):
        x_dim = X if l == 0 else H * dirs
        total += dirs * T * (4 * H * x_dim + 4 * H * H) / macs
    return total


def utilization(cfg: ModelConfig, T: int, design: Design) -> float:
    return min(1.0, ideal_cycles(cfg, T, design.macs) / network_cycles(cfg, T, design))


def energy_j(cfg: ModelConfig, T: int, design: Design,
             power_w: Optional[float] = None) -> float:
    p = power_w if power_w is not None else POWER_W[design.macs]
    return p * network_time_s(cfg, T, design)


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


# ===========================================================================
# paper figure/table generators
# ===========================================================================

from repro_torch.configs.sharp_lstm import (  # noqa: E402
    DEEPBENCH, MAC_BUDGETS, PAPER_NETWORKS, SWEEP_HIDDEN_DIMS, lstm_config,
)


def fig9_kwidth_sweep(k_widths=K_CHOICES, dims=SWEEP_HIDDEN_DIMS,
                      budgets=MAC_BUDGETS) -> Dict:
    """Speedup of (K, H, M) vs the 1K-MAC best design (paper's normalization)."""
    out = {}
    for m in budgets:
        base = {h: network_cycles(lstm_config(h), 25, Design(macs=1024))
                for h in dims}
        for k in k_widths:
            if k > m:
                continue
            for h in dims:
                d = Design(macs=m, k=k, reconfigure=False)
                out[(m, k, h)] = base[h] / network_cycles(lstm_config(h), 25, d)
    return out


def fig9_best_k(budget: int, dims=SWEEP_HIDDEN_DIMS) -> Dict[int, int]:
    """argmax_K speedup per hidden dim (the 'no single best K' claim)."""
    sweep = fig9_kwidth_sweep(budgets=[budget], dims=dims)
    best = {}
    for h in dims:
        ks = [(v, k) for (m, k, hh), v in sweep.items() if hh == h]
        best[h] = max(ks)[1]
    return best


def fig10_padding_speedup(dims=SWEEP_HIDDEN_DIMS, budgets=MAC_BUDGETS) -> Dict:
    """Speedup of edge reconfiguration vs fixed K (paper: <=1.22x, =1 @512).

    Faithful to §6.2.1: K_opt is configured per (dim, budget) first; the two
    designs share that K and differ only in the edge-stripe reconfiguration.
    """
    out = {}
    for m in budgets:
        for h in dims:
            cfg = lstm_config(h)
            k_opt = select_tile(4 * h, h, m, reconfigure=True).k
            fixed = Design(macs=m, k=k_opt, reconfigure=False)
            rec = Design(macs=m, k=k_opt, reconfigure=True)
            out[(m, h)] = network_cycles(cfg, 25, fixed) / network_cycles(cfg, 25, rec)
    return out


def fig11_schedule_speedups(dims=SWEEP_HIDDEN_DIMS, budgets=MAC_BUDGETS) -> Dict:
    """Speedup of each schedule vs Sequential (k=32 column-wise per §8)."""
    out = {}
    for m in budgets:
        for h in dims:
            cfg = lstm_config(h)
            seq = network_cycles(cfg, 25, Design(macs=m, k=32, schedule="sequential"))
            for s in ("sequential", "batch", "intergate", "unfolded"):
                c = network_cycles(cfg, 25, Design(macs=m, k=32, schedule=s))
                out[(m, h, s)] = seq / c
    return out


def fig12_latency_utilization(dims=SWEEP_HIDDEN_DIMS, budgets=MAC_BUDGETS) -> Dict:
    out = {}
    for m in budgets:
        for h in dims:
            cfg = lstm_config(h)
            d = Design(macs=m)
            out[(m, h)] = {
                "latency_us": network_time_s(cfg, 25, d) * 1e6,
                "utilization": utilization(cfg, 25, d),
                "epur_utilization": utilization(cfg, 25, _epur(m)),
            }
    return out


def _epur(macs: int) -> Design:
    """E-PUR: fixed dot-product tiling, input MVMs hoisted for locality,
    serial recurrent tail (no across-step overlap), no reconfiguration."""
    return Design(macs=macs, k=64, schedule="epur", reconfigure=False)


def table6_vs_epur(budgets=MAC_BUDGETS) -> Dict:
    out = {}
    for name, (cfg, T) in PAPER_NETWORKS.items():
        for m in budgets:
            sharp = network_cycles(cfg, T, Design(macs=m))
            epur = network_cycles(cfg, T, _epur(m))
            out[(name, m)] = epur / sharp
    return out


# --- BrainWave (Table 4) ----------------------------------------------------
# Modeled as a sequential-schedule NPU with a large hardened tile and a deep
# dependent-writeback pipeline; (K_bw, penalty, efficiency) are calibrated
# against the paper's reported speedups, mirroring the paper's own
# "Structurally-Constrained Model Critical-Path" validation of its BW model.

BW_MACS = 96 * 1024
BW_FREQ = 250e6
TABLE4_PAPER = {(256, 150): 5.39, (512, 25): 3.57, (1024, 25): 1.85, (1536, 50): 1.73}


def _bw_design(k_bw: int, penalty: int, eff: float) -> Design:
    return Design(macs=BW_MACS, k=k_bw, schedule="sequential", reconfigure=False,
                  freq_hz=BW_FREQ, pipeline_penalty=penalty, efficiency=eff)


def table4_vs_brainwave(k_bw: int = 0, penalty: int = 0, eff: float = 0.0) -> Dict:
    """SHARP@96K-MAC/250MHz vs the BrainWave model on DeepBench dims."""
    if not k_bw:
        k_bw, penalty, eff = fit_brainwave()
    out = {}
    for (h, T) in DEEPBENCH:
        cfg = lstm_config(h)
        sharp = network_cycles(cfg, T, Design(macs=BW_MACS, freq_hz=BW_FREQ))
        bw = network_cycles(cfg, T, _bw_design(k_bw, penalty, eff))
        out[(h, T)] = bw / sharp
    return out


def fit_brainwave() -> Tuple[int, int, float]:
    """Small grid search calibrating the BW model to Table 4."""
    best = None
    for k_bw in (512, 1024, 2048, 4096):
        for penalty in (0, 10, 20, 40, 80, 160):
            for eff in (0.3, 0.4, 0.5, 0.6, 0.8, 1.0):
                pred = table4_vs_brainwave(k_bw, penalty, eff)
                err = sum((math.log(pred[k] / v)) ** 2 for k, v in TABLE4_PAPER.items())
                if best is None or err < best[0]:
                    best = (err, (k_bw, penalty, eff))
    return best[1]


def fig14_energy(budgets=MAC_BUDGETS, dims=SWEEP_HIDDEN_DIMS) -> Dict:
    """Energy (J), normalized to E-PUR@1K per dim, plus the avg reduction."""
    out = {}
    for m in budgets:
        for h in dims:
            cfg = lstm_config(h)
            e_sharp = energy_j(cfg, 25, Design(macs=m))
            p_epur = POWER_W[m] / EPUR_POWER_RATIO[m]
            e_epur = energy_j(cfg, 25, _epur(m), power_w=p_epur)
            out[(m, h)] = {"sharp": e_sharp, "epur": e_epur,
                           "reduction": 1.0 - e_sharp / e_epur}
    return out


def gflops_per_watt(macs: int = 65536, dims=SWEEP_HIDDEN_DIMS) -> float:
    """Paper §10: 50% avg utilization of 29.8 TFLOPS at 47.7 W -> ~0.32 TF/W."""
    utils = [utilization(lstm_config(h), 25, Design(macs=macs)) for h in dims]
    avg_u = sum(utils) / len(utils)
    return PEAK_TFLOPS[macs] * avg_u / POWER_W[macs] / 1e9
