"""Reconfigurable MVM tile-engine, abstracted (paper §4.2, §6).

The hardware: N vector-scalar units of width K=32 ganged row-/column-wise
(Config1..4 in Fig. 7), so a fixed MAC budget M yields tile shapes
(K rows x M/K cols) for K in {32, 64, 128, 256}.  A tile is retired per
cycle; an MVM over a (rows x cols) weight matrix costs
ceil(rows/K) * ceil(cols/(M/K)) cycles, and every ceil() is *padding waste*.

Two artifacts live here:

1. The paper-faithful cycle/padding math + per-model tile selection
   (``select_tile``) and edge reconfiguration (``cycles`` with
   ``reconfigure=True`` shrinks K at the last row stripe — §6.2.1, the
   <=1.22x of Fig. 10).

2. The TPU translation (``select_block_shape``): BlockSpec tiles for the
   Pallas kernels, minimizing the same ceil-padding waste subject to MXU
   lane alignment (8, 128) and a VMEM budget — the paper's "offline table"
   becomes a block-shape autotuner.

A copy of ``repro.core.tiling``, plus the device models (``DeviceModel``):
which sequence stripes and chained decode slots a device admits.  The
reference's constants (``SEQ_VMEM_BUDGET``, the (8, 128) tiling) stay:
under ``REFERENCE`` (the CPU's model) the port's plans equal the
reference's; a card's model (``card_model``) holds a slot to the limits of
the card's own kernels instead.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

K_CHOICES = (32, 64, 128, 256, 512)  # paper Fig. 9 exploration range


@dataclass(frozen=True)
class TileConfig:
    k: int        # VS width = tile rows
    macs: int     # total multiply-adders

    @property
    def cols(self) -> int:  # tile columns
        return max(1, self.macs // self.k)


def mvm_cycles(rows: int, cols: int, tile: TileConfig, reconfigure: bool = False) -> int:
    """Cycles to stream a (rows x cols) MVM through the tile engine.

    ``reconfigure``: at the final row stripe, the controller re-gangs the VS
    units to the largest K' <= K (power-of-two multiple of 32, or 8/16 for
    the smallest remainders) that does not overshoot the remaining rows —
    the padding reconfiguration of §6.2.1.
    """
    full_stripes, rem = divmod(rows, tile.k)
    col_passes = math.ceil(cols / tile.cols)
    cycles = full_stripes * col_passes
    if rem:
        if not reconfigure:
            cycles += col_passes
        else:
            # re-gang: bring K' as close to the remainder as the 32-wide
            # VS units allow (halving K doubles the columns)
            k2 = tile.k
            while k2 > 32 and k2 // 2 >= rem:
                k2 //= 2
            # K' halves free VS units to double the columns
            cols2 = max(1, tile.macs // k2)
            stripes2 = math.ceil(rem / k2)
            cycles += stripes2 * math.ceil(cols / cols2)
    return max(cycles, 1)


def padding_waste(rows: int, cols: int, tile: TileConfig) -> float:
    """Fraction of MAC-cycles burned on padding (fixed configuration)."""
    eff_r = math.ceil(rows / tile.k) * tile.k
    eff_c = math.ceil(cols / tile.cols) * tile.cols
    return 1.0 - (rows * cols) / (eff_r * eff_c)


def select_tile(rows: int, cols: int, macs: int,
                k_choices: Sequence[int] = K_CHOICES,
                reconfigure: bool = True) -> TileConfig:
    """The paper's offline exploration: argmin cycles over the K family."""
    best, best_cycles = None, None
    for k in k_choices:
        if k > macs:
            continue
        t = TileConfig(k=k, macs=macs)
        c = mvm_cycles(rows, cols, t, reconfigure=reconfigure)
        if best_cycles is None or c < best_cycles:
            best, best_cycles = t, c
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# TPU translation: Pallas block shapes
# ---------------------------------------------------------------------------

LANE = 128     # MXU/VPU lane width (last dim)
SUBLANE = 8    # second-to-last dim granule (fp32)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def block_waste(m: int, n: int, bm: int, bn: int) -> float:
    em = math.ceil(m / bm) * bm
    en = math.ceil(n / bn) * bn
    return 1.0 - (m * n) / (em * en)


@functools.lru_cache(maxsize=None)
def select_block_shape(m: int, n: int, *, vmem_budget: int = 4 * 2**20,
                       bytes_per_el: int = 4,
                       bm_choices: Sequence[int] = (8, 16, 32, 64, 128, 256, 512),
                       bn_choices: Sequence[int] = (128, 256, 512, 1024, 2048),
                       ) -> Tuple[int, int]:
    """Choose (bm, bn) minimizing ceil-padding waste, then maximizing tile
    area (fewer grid steps), under a VMEM footprint bound — the TPU analogue
    of the paper's K-width table."""
    best = None
    for bm in bm_choices:
        if bm % SUBLANE and bm < m:
            continue
        for bn in bn_choices:
            if bm * bn * bytes_per_el > vmem_budget:
                continue
            w = block_waste(m, n, bm, bn)
            area = min(bm, _round_up(m, SUBLANE)) * min(bn, _round_up(n, LANE))
            key = (round(w, 6), -area)
            if best is None or key < best[0]:
                best = (key, (bm, bn))
    assert best is not None, (m, n)
    bm, bn = best[1]
    return min(bm, _round_up(m, SUBLANE)), min(bn, _round_up(n, LANE))


SEQ_VMEM_BUDGET = 8 * 2**20  # working-set bound for the sequence kernels

# bytes per element of the RESIDENT recurrent weight U under each weight
# precision (activations/state keep the launch dtype's width); int8 adds
# the per-gate f32 scale vector on top, accounted separately below
PRECISION_WEIGHT_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def seq_block_footprint(bt: int, B: int, H: int, *, gates: int = 4,
                        bytes_per_el: int = 4, precision: str = "fp32",
                        density: float = 1.0) -> int:
    """VMEM working set of one sequence-kernel grid step at T-stripe ``bt``:
    resident U (gates·H²) + streamed xw stripe (B·bt·gates·H) + hs stripe
    (B·bt·H) + state/seed tiles (≤4·B·H).

    ``precision`` narrows the resident U term only (int8 is 1 byte/weight
    + a gates-wide f32 scale vector; bf16 is 2; fp32 keeps ``bytes_per_el``
    so the formula is byte-identical to the historical one), and
    ``density`` scales it for the block-sparse row-compacted payload
    (Ha ≈ density·H surviving rows + a 4-byte int32 row index each)."""
    if precision == "fp32":
        w_bytes = bytes_per_el * gates * H * H
    else:
        w_bytes = PRECISION_WEIGHT_BYTES[precision] * gates * H * H
        if precision == "int8":
            w_bytes += 4 * gates  # the per-gate f32 scale vector
    if density < 1.0:
        # Ha compacted weight rows + the (Ha,) int32 row-index operand
        w_bytes = int(w_bytes * density) + 4 * int(density * H)
    return w_bytes + bytes_per_el * (B * bt * (gates + 1) * H + 4 * B * H)


def decode_block_footprint(B: int, H: int, *, gates: int = 4,
                           bytes_per_el: int = 4) -> int:
    """VMEM of one layer of a chained decode launch: the layer's W and U
    tiles, its bias, the chained xw row, and the (h, c) state rows (fp32).
    The decode kernel grid streams layers, so the budget is per layer, not
    the whole (L, ...) stack."""
    weights = 2 * H * gates * H * bytes_per_el + gates * H * bytes_per_el
    rows = B * gates * H * bytes_per_el + 4 * B * H * 4
    return weights + rows


@dataclass(frozen=True)
class DeviceModel:
    """Which sequence-kernel slots (a T-stripe ``bt`` of G recurrences of B
    rows) and chained decode slots a device admits.

    ``REFERENCE`` is the reference's TPU model: a sequence slot's VMEM
    working set (``seq_block_footprint``) and a chained decode slot's
    per-layer one (``decode_block_footprint``) within ``budget``
    (``SEQ_VMEM_BUDGET``), so plans equal the reference's bit for bit.

    A card's model (``card_model``, ``on_card``) holds a slot to the
    limits of the card's kernels, and to no footprint: the sequence
    kernels keep U (or a leading share of it and a ring) in a cluster's
    shared memory and read xw and write hs in HBM one step at a time, so
    no stripe adds to a CTA's working set, and a CTA's shared memory
    (``kernels.common.seq_smem``) is at most ``SEQ_MAX_SMEM`` at any H,
    which ``card_model`` has already held the card's opt-in (``budget``)
    to.  A sequence slot is admitted when H is within the sequence
    kernels' limit (``seq_max_h``) and the launch's C ints within theirs
    (``kernels.common.seq_launch_refusal``: T, G, B); a chained decode
    slot when H is within the decode kernels' limit (``decode_max_h``)."""
    name: str
    budget: int            # REFERENCE: the VMEM bound; a card: its opt-in
    on_card: bool = False
    sms: int = 0           # the card's SMs (describe only)
    seq_max_h: int = 0     # widest H of the card's sequence kernels
    decode_max_h: int = 0  # widest H of the card's decode kernels

    def describe(self) -> str:
        if not self.on_card:
            return (f"{self.name}: a slot's VMEM working set within "
                    f"{self.budget} B")
        return (f"{self.name}: {self.sms} SMs, {self.budget} B of shared "
                f"memory a block (opt-in); sequence slots at H <= "
                f"{self.seq_max_h} within the launch's C ints, chained "
                f"decode slots at H <= {self.decode_max_h}")

    def _bound(self, budget: Optional[int]) -> int:
        if budget is None:
            return self.budget
        if self.on_card:
            raise ValueError(
                f"{self.name} holds a slot to its kernels' limits, not to "
                f"a footprint: a budget override ({budget}B) applies to "
                "the reference's model only")
        return budget

    def seq_refusal(self, bt: int, B: int, H: int, *, gates: int = 4,
                    G: int = 1, bytes_per_el: int = 4,
                    precision: str = "fp32", density: float = 1.0,
                    budget: Optional[int] = None) -> Optional[str]:
        """Why this device refuses a sequence slot, or None.  ``budget``
        overrides the reference's VMEM bound (a card has none)."""
        bound = self._bound(budget)
        if self.on_card:
            from repro_torch.kernels.common import seq_launch_refusal

            if H > self.seq_max_h:
                return (f"H={H} is past the sequence kernels' H <= "
                        f"{self.seq_max_h} on {self.name}")
            why = seq_launch_refusal(G, B, bt)
            return f"{why} on {self.name}" if why else None
        used = seq_block_footprint(bt, B, H, gates=gates,
                                   bytes_per_el=bytes_per_el,
                                   precision=precision, density=density)
        return (None if used <= bound
                else f"footprint {used}B exceeds budget {bound}B")

    def seq_fits(self, bt: int, B: int, H: int, **kw) -> bool:
        return self.seq_refusal(bt, B, H, **kw) is None

    def decode_refusal(self, B: int, H: int, *, gates: int = 4,
                       bytes_per_el: int = 4,
                       budget: Optional[int] = None) -> Optional[str]:
        """Why this device refuses a chained decode slot of B rows at width
        H, or None.  ``budget`` overrides the reference's VMEM bound; a
        card holds the slot to its decode kernels' limit on H."""
        bound = self._bound(budget)
        if self.on_card:
            return (f"H={H} is past the decode kernels' H <= "
                    f"{self.decode_max_h} on {self.name}"
                    if H > self.decode_max_h else None)
        used = decode_block_footprint(B, H, gates=gates,
                                      bytes_per_el=bytes_per_el)
        return (None if used <= bound
                else f"footprint {used}B exceeds budget {bound}B")


#: the reference's TPU model: every plan equals the reference's
REFERENCE = DeviceModel(name="reference", budget=SEQ_VMEM_BUDGET)


def card_model(props) -> DeviceModel:
    """The model of a CUDA card from its properties (what
    ``torch.cuda.get_device_properties`` returns: ``name``,
    ``multi_processor_count``, ``shared_memory_per_block_optin``), with
    the kernels' limits from ``kernels.common``.  A card whose blocks
    cannot opt in to the sequence kernels' shared memory
    (``SEQ_MAX_SMEM``) is refused (``KernelLaunchRefused``)."""
    from repro_torch.kernels.common import (MAX_H, SEQ_MAX_SMEM,
                                            KernelLaunchRefused)

    name = f"cuda({props.name})"
    optin = int(props.shared_memory_per_block_optin)
    if optin < SEQ_MAX_SMEM:
        raise KernelLaunchRefused(
            f"{name} offers {optin} B of shared memory a block; the "
            f"sequence kernels take up to {SEQ_MAX_SMEM} B")
    return DeviceModel(
        name=name, budget=optin, on_card=True,
        sms=int(props.multi_processor_count),
        seq_max_h=min(MAX_H["lstm_seq"], MAX_H["gru_seq"]),
        decode_max_h=min(MAX_H["lstm_decode"], MAX_H["gru_decode"]))


def device_model(device) -> DeviceModel:
    """The model of the device a stack runs on: ``REFERENCE`` for the CPU
    (the kernels' plain versions plan as the reference), the card's own
    for CUDA."""
    import torch

    device = torch.device(device)
    if device.type == "cpu":
        return REFERENCE
    if device.type == "cuda":
        return card_model(torch.cuda.get_device_properties(device))
    raise ValueError(f"device_model: no model for {device}; allowed: cpu, "
                     "cuda")


@functools.lru_cache(maxsize=None)
def select_time_block(T: int, B: int, H: int, *,
                      vmem_budget: Optional[int] = None,
                      bytes_per_el: int = 4, gates: int = 4,
                      precision: str = "fp32", density: float = 1.0,
                      bt_choices: Sequence[int] = (1, 2, 4, 8, 16, 32, 64,
                                                   128, 256),
                      device_model: DeviceModel = REFERENCE,
                      ) -> int:
    """T-block for the sequence-fused recurrent kernels (kernels.lstm_cell,
    kernels.gru_cell).

    The kernel's VMEM working set per grid step is the resident recurrent
    weight U (gates·H²), the streamed xw stripe (B·bt·gates·H), the hs
    output stripe (B·bt·H), and the state + seed tiles (4·B·H for the LSTM's
    (h, c), half for GRU's h-only — bounded above by the LSTM case).  Pick
    the bt minimizing the T-edge ceil-padding waste, then the largest such
    bt (fewest grid steps / launch amortization), under the budget — the
    time-axis analogue of ``select_block_shape``.  ``gates`` is 4 for the
    LSTM, 3 for GRU.  ``precision``/``density`` narrow the resident weight
    term (see seq_block_footprint), so quantized/sparse launches re-tune
    to larger time stripes at the same budget.  ``device_model`` decides
    which stripes are admitted (``vmem_budget`` overrides its bound)."""
    if T <= 0:
        return 1

    best = None
    for bt in bt_choices:
        bt = min(bt, T)
        if bt > 1 and not device_model.seq_fits(
                bt, B, H, gates=gates, bytes_per_el=bytes_per_el,
                precision=precision, density=density, budget=vmem_budget):
            continue
        waste = math.ceil(T / bt) * bt - T
        key = (round(waste / T, 6), -bt)
        if best is None or key < best[0]:
            best = (key, bt)
    return best[1]
