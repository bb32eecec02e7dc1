"""The dispatch planner: WorkItems -> an explicit, inspectable DispatchPlan.

A copy of ``repro.dispatch.planner`` (pure Python).  Under the reference's
device model (``core.tiling.REFERENCE``, the default and the CPU's) the
port's plans, and their ``describe()`` strings, equal the reference's; a
card's model (``device_model=``) admits the stripes and slots the card's
kernels take instead of those within the TPU's VMEM budget.

This is the software rendition of SHARP's intelligent tile-based dispatch
(§5) plus dynamic reconfiguration (§6): for every admitted item the planner

  1. *tiles* it — the paper tile-engine K for its MVMs via
     ``core.autotune.table().tile`` (offline table, §6.2.2), the Pallas MVM
     block via ``table().block``, and the sequence kernel's T-stripe via
     ``table().seq_block`` (VMEM-budgeted, per gate count);
  2. *schedules* it — scores candidate execution shapes (per-layer
     ``fused`` = one launch per layer, ``wavefront`` = anti-diagonal
     (layer, time-chunk) cells, ``per_step`` fallback = one launch per
     cell) with ``core.perfmodel`` cycle estimates and picks the cheapest;
  3. *packs* it — cells of different items that share a launch signature
     (family, H, chunk length, dtype) are co-scheduled into one global
     slot timeline, each slot one G-batched sequence-kernel launch, so
     independent recurrences hide each other's serial dependencies.
     Cross-B packing goes further: same-layer cells of parameter-sharing
     items concatenate on B into one launch row, and ragged widths pad
     into one slot (in-kernel masked) when the perfmodel scores the
     widened launch cheaper than an extra one.

Bidirectional stacks are first-class in the packed timeline:
each bidirectional layer contributes a fwd cell walk (time-ascending
chunks) and a bwd walk (time-descending) interleaved into one wave
timeline — the two directions of a wave are data-independent and G-merge
into a single launch (and cross-B pack with other requests), instead of
the retired per-layer fused fallback that launched each direction of each
layer on its own with no packing at all.

``plan_decode`` plans a serving decode tick: T=1 items over one shared
stack become a single *chained* slot — one launch walks the L dependent
layer cells in grid order with the inter-layer value in VMEM scratch —
instead of L per-layer launches.

The emitted ``DispatchPlan`` is a plain ordered tuple of ``Slot``s — every
launch the executor will make, with its tile/block configuration — so plans
can be printed, diffed, and unit-tested for determinism and launch counts.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.autotune import table
from repro_torch.core.perfmodel import (Design, LAUNCH_CYCLES,
                                        bidir_stack_plan_cycles, decode_plan_cycles,
                                        per_step_plan_cycles, slot_launch_cycles,
                                        stack_plan_cycles)
from repro_torch.core.schedules import wavefront_active
from repro_torch.core.tiling import REFERENCE, DeviceModel
from repro_torch.dispatch.workitem import GATES, WorkItem
from repro_torch.kernels.common import cdiv
from repro_torch.runtime.obs import NULL_TRACER, as_tracer, slot_signature

DEFAULT_MACS = 16384  # planner's reference tile-engine budget (paper 16K)


@dataclass(frozen=True)
class Cell:
    """One (item, layer, time-chunk, direction) unit of recurrent work.

    ``direction`` is "fwd" for unidirectional items and the forward half of
    bidirectional layers; "bwd" cells walk their chunk in *descending* time
    (the executor feeds the sequence kernel the time-reversed chunk slice
    and flips the produced stripe back — exact, including remainders)."""
    uid: int
    layer: int
    chunk: int
    direction: str = "fwd"


@dataclass(frozen=True)
class Slot:
    """One batched kernel launch: G independent rows sharing a signature.

    Each entry of ``groups`` is one launch row (one g of the G-batched
    sequence kernel): ordinarily a single cell, but under cross-B packing
    several same-layer cells of parameter-sharing items (WorkItem.share)
    concatenated on B.  ``group_b`` records each row's valid batch width;
    rows narrower than ``B`` are padded and masked in-kernel (ragged-B),
    so padded rows are exact no-ops.

    ``wave`` is the anti-diagonal index (all of a slot's cells have
    layer + chunk == wave for their item); slots execute in ``index``
    order and every cell's dependencies ran in an earlier wave.  The one
    exception is ``chained`` slots (T=1 decode): their groups are the L
    *serially dependent* layer cells of one tick, executed in group order
    inside ONE launch (the layer chain runs through VMEM scratch), so the
    whole tick is a single launch instead of L.
    """
    index: int
    wave: int
    family: str
    H: int
    B: int                  # the launch's (padded) batch width per row
    chunk_len: int          # timesteps per cell in this launch
    dtype: str
    tile_k: int             # paper tile-engine K for this launch's MVMs
    mvm_block: Tuple[int, int]  # Pallas (bk, bh) block for the cell MVM
    groups: Tuple[Tuple[Cell, ...], ...]
    group_b: Tuple[int, ...]    # valid batch rows per group (<= B)
    chained: bool = False
    precision: str = "fp32"     # recurrent-weight precision of every cell
    #                             in this launch (part of the signature —
    #                             int8 and fp32 launches never share a
    #                             slot or a measured-cost entry)

    @property
    def g(self) -> int:
        return len(self.groups)

    @property
    def cells(self) -> Tuple[Cell, ...]:
        return tuple(c for grp in self.groups for c in grp)

    def signature(self) -> str:
        """The launch signature string traces and the measured-launch cost
        table key on (family, G, padded B, H, T-stripe, dtype, direction
        mix, precision, chained) — see ``runtime.obs.slot_signature``."""
        return slot_signature(self.family, self.H, self.g, self.B,
                              self.chunk_len, self.dtype,
                              directions=[c.direction for c in self.cells],
                              chained=self.chained, precision=self.precision)

    def describe(self) -> str:
        grps = " ".join(
            "[" + " ".join(
                f"({c.uid},l{c.layer},k{c.chunk}"
                + ("" if c.direction == "fwd" else ",bwd") + ")"
                for c in grp)
            + f"]b{b}" for grp, b in zip(self.groups, self.group_b))
        tag = " chained" if self.chained else ""
        return (f"slot {self.index:3d} wave {self.wave:3d}  "
                f"{self.family} H{self.H} B{self.B} bt{self.chunk_len} "
                f"K{self.tile_k} blk{self.mvm_block}  G={self.g}{tag}  {grps}")


@dataclass(frozen=True)
class ItemPlan:
    """Per-item planning outcome (shape, chosen schedule, tiling)."""
    item: WorkItem
    schedule: str           # wavefront | fused | per_step | per_layer |
    #                         decode | a forced reference schedule
    #                         (sequential/batch/intergate/unfolded — these
    #                         route external through core.schedules/core.gru)
    block_t: int            # chosen T-stripe (0 for non-striped fallbacks)
    nk: int                 # number of time chunks
    tile_k: int
    mvm_block: Tuple[int, int]
    naive_launches: int     # launches if this item ran alone
    est_cycles: float       # perfmodel score of the chosen schedule

    @property
    def uid(self) -> int:
        return self.item.uid

    @property
    def executable(self) -> bool:
        """False for plan-only items (priced for admission control but not
        runnable by the executor): multi-layer rglru, whose inter-layer
        block mixing lives outside the recurrence dispatcher."""
        return not (self.item.family == "rglru" and self.item.L != 1)

    def describe(self) -> str:
        it = self.item
        tag = "" if self.executable else " [plan-only]"
        if it.bidirectional:
            tag = " bidir" + tag
        return (f"item {it.uid:3d}  {it.family} H{it.H} L{it.L} B{it.B} "
                f"T{it.T} X{it.X} prio{it.priority}  -> {self.schedule} "
                f"bt={self.block_t} nk={self.nk} K={self.tile_k} "
                f"blk={self.mvm_block} launches={self.naive_launches} "
                f"est={self.est_cycles:.0f}cy{tag}")


@dataclass(frozen=True)
class DispatchPlan:
    items: Tuple[ItemPlan, ...]
    slots: Tuple[Slot, ...]     # the packed timeline (wavefront/fused items)
    external: Tuple[int, ...]   # uids executed outside the slot timeline
    macs: int

    def item(self, uid: int) -> ItemPlan:
        for ip in self.items:
            if ip.uid == uid:
                return ip
        raise KeyError(uid)

    @property
    def launches(self) -> int:
        ext = sum(ip.naive_launches for ip in self.items
                  if ip.uid in self.external)
        return len(self.slots) + ext

    @property
    def naive_launches(self) -> int:
        """Launch count if every item ran alone (no cross-item packing)."""
        return sum(ip.naive_launches for ip in self.items)

    @property
    def est_cycles(self) -> float:
        return sum(ip.est_cycles for ip in self.items)

    def describe(self) -> str:
        lines = [f"DispatchPlan: {len(self.items)} items, "
                 f"{len(self.slots)} packed slots, {self.launches} launches "
                 f"(naive {self.naive_launches}), macs={self.macs}"]
        lines += [ip.describe() for ip in self.items]
        lines += [s.describe() for s in self.slots]
        if self.external:
            lines.append(f"external (unpacked fallback): {self.external}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# per-item scheduling
# ---------------------------------------------------------------------------


def _chunk_lens(T: int, bt: int) -> List[int]:
    """Chunk lengths of a T walk striped at bt (last chunk = remainder)."""
    if T == 0:
        return []
    nk = cdiv(T, bt)
    out = [bt] * (nk - 1)
    out.append(T - (nk - 1) * bt)
    return out


def bidir_wavefront_launches(L: int, T: int, bt: int) -> int:
    """Launch count of one L-layer bidirectional item packed alone at
    T-stripe ``bt``: L·nk waves (see ``_item_cells``), each merging its fwd
    and bwd cells into ONE G-batched launch — except, under ragged T, the
    two waves per layer where the remainder chunk meets a full-length chunk
    of the opposite direction (different chunk_len -> different launch
    signature).  At most 2·L·nk, the per-direction-per-chunk count, and
    strictly below it except the nk=2 ragged boundary case, where every
    wave splits (L·(2+2) == 2·L·2); divisible stripes and nk=1 give the
    full win (L·nk — at nk=1 half the retired fallback's 2·L)."""
    nk = cdiv(T, bt)
    ragged = 2 if (nk > 1 and T % bt) else 0
    return L * (nk + ragged)


def _item_cells(ip: ItemPlan) -> Dict[int, List[Tuple[int, Cell]]]:
    """wave -> [(chunk_len, Cell)] for one packable item.

    Unidirectional items wavefront on the classic anti-diagonal (layer l's
    chunk k in wave l + k).  Bidirectional items run the *interleaved*
    timeline: layer l's fwd walk visits chunks ascending, its bwd walk
    descending, over the same chunk boundaries; layer l+1's chunk k becomes
    ready only once fwd has produced chunk k AND bwd has produced chunk k
    (the concat dependency — in the bwd walk's own order that is its chunk
    nk-1-k), so the earliest-start schedule is

        wave(l, fwd, k) = l·nk + k        wave(l, bwd, k) = l·nk + (nk-1-k)

    — L·nk waves, each holding one fwd and one bwd cell of one layer, the
    two directions hiding each other's serial dependence in one G-batched
    launch (same-signature merge in ``_pack``)."""
    it = ip.item
    lens = _chunk_lens(it.T, ip.block_t)
    nk = len(lens)
    waves: Dict[int, List[Tuple[int, Cell]]] = {}
    if it.bidirectional:
        for l in range(it.L):
            for k in range(nk):
                waves.setdefault(l * nk + k, []).append(
                    (lens[k], Cell(uid=it.uid, layer=l, chunk=k)))
                waves.setdefault(l * nk + (nk - 1 - k), []).append(
                    (lens[k], Cell(uid=it.uid, layer=l, chunk=k,
                                   direction="bwd")))
        return waves
    for s in range(it.L + nk - 1):
        lo, hi = wavefront_active(s, it.L, nk)
        for l in range(lo, hi + 1):
            k = s - l
            waves.setdefault(s, []).append(
                (lens[k], Cell(uid=it.uid, layer=l, chunk=k)))
    return waves


def _slot_config(family: str, H: int, macs: int) -> Tuple[int, Tuple[int, int]]:
    """The slot's own launch shape: its in-kernel MVM is the recurrent
    half (H x gates·H) per cell — X-independent, so cells of different-X
    items share this config honestly."""
    gates = GATES.get(family, 1)
    tile_k = table().tile(gates * H, H, macs).k if macs else 0
    mvm_block = table().block(H, H, vmem_budget=2 * 2**20)
    return tile_k, mvm_block


def _active_cost_model(cost_model):
    """Normalize the planner's ``cost_model`` kwarg: the model itself when
    it can actually score (a populated table for this backend), else None
    — an EMPTY table must leave every decision on the analytic path, so
    cold-start measured mode is bit-identical to analytic mode."""
    return cost_model if (cost_model is not None
                          and cost_model.active) else None


def _slots_us(slots: Sequence[Slot], cm) -> float:
    """Measured µs of a slot timeline: the sum of each launch's cost under
    the measured cost model (exact hit -> interpolated neighbor ->
    analytic-converted fallback; see ``calib.MeasuredCostModel``)."""
    return sum(
        cm.slot_us(s.family, s.H, s.g, s.B, s.chunk_len, s.dtype,
                   dirs=[c.direction for c in s.cells], chained=s.chained,
                   precision=s.precision)
        for s in slots)


def _pack(item_plans: Sequence[ItemPlan], macs: int, *,
          cross_b: bool = True, cost_model=None,
          device_model: DeviceModel = REFERENCE) -> Tuple[Slot, ...]:
    """Merge items' wavefront cells into one slot timeline.

    Every slot is one G-batched launch; cells group by launch signature
    (family, H, chunk_len, dtype — plus B when ``cross_b`` is off).  Under
    ``cross_b``, two extra merges apply:

      * same-layer cells of parameter-sharing items (equal non-None
        ``WorkItem.share``) concatenate on B into ONE launch row — the
        recurrent MVM is identical (one U), so the rows simply widen;
      * rows of different widths may share a slot by padding to the widest
        row with in-kernel ragged-B masking — adopted only when the
        cost model says the padded walk beats the extra launch: analytic
        ``slot_launch_cycles`` (B-widened vs G-batched) by default, or
        measured µs for the same two shapes when ``cost_model`` is an
        active ``calib.MeasuredCostModel``.

    Deterministic: slots ordered by (wave, signature), rows by the lead
    cell's item order_key then layer, cells within a row likewise.
    """
    cm = _active_cost_model(cost_model)
    design = Design(macs=macs or DEFAULT_MACS, schedule="unfolded")
    by_item = [(ip, _item_cells(ip)) for ip in item_plans]
    items_by_uid = {ip.uid: ip.item for ip in item_plans}
    n_waves = max((max(w) + 1 for _, w in by_item if w), default=0)
    slots: List[Slot] = []
    for s in range(n_waves):
        sigs: Dict[Tuple, Dict[Tuple, List[Tuple[Tuple, Cell, int]]]] = {}
        for ip, waves in by_item:
            it = ip.item
            for chunk_len, cell in waves.get(s, []):
                # the launch signature carries the CELL's layer family, not
                # the item's head family — a mixed lstm/gru stack's cells
                # land in per-family slots of the same wave timeline
                fam = it.families[cell.layer]
                # direction is part of every group key: a B-concat row
                # shares ONE recurrent matrix U, and a bidirectional
                # layer's fwd/bwd halves are distinct parameters (they may
                # still share the LAUNCH — different g rows of one slot)
                # precision joins every launch signature: an int8 cell can
                # never share a launch (or a measured-cost entry) with an
                # fp32 one — the U operands have different dtypes/shapes
                if cross_b:
                    sig = (fam, it.H, chunk_len, it.dtype, it.precision)
                    gkey = (("share", it.share, cell.layer, cell.direction)
                            if it.share is not None else
                            ("solo", it.uid, cell.layer, cell.chunk,
                             cell.direction))
                else:
                    sig = (fam, it.H, it.B, chunk_len, it.dtype,
                           it.precision)
                    gkey = ("solo", it.uid, cell.layer, cell.chunk,
                            cell.direction)
                sigs.setdefault(sig, {}).setdefault(gkey, []).append(
                    (it.order_key() + (cell.layer, cell.direction), cell,
                     it.B))
        for sig in sorted(sigs, key=str):
            if cross_b:
                family, H, chunk_len, dtype, precision = sig
            else:
                family, H, _, chunk_len, dtype, precision = sig
            gates = GATES.get(family, 1)

            def fits(width: int) -> bool:
                # every item validated its block_t at its OWN B; a concat
                # row is wider, so re-check the device's admission of the
                # sequence slot before widening (a singleton row always
                # fits by the per-item validation).  The precision-narrowed
                # weight term applies; density stays conservative at 1.0 —
                # widening never ASSUMES sparsity
                return device_model.seq_fits(chunk_len, width, H,
                                             gates=gates,
                                             precision=precision)

            rows = []  # (lead order key, cells, valid B)
            for members in sigs[sig].values():
                members.sort(key=lambda m: m[0])
                run, width = [], 0
                for m in members:
                    if run and not fits(width + m[2]):
                        rows.append((run[0][0],
                                     tuple(c for _, c, _ in run), width))
                        run, width = [], 0
                    run.append(m)
                    width += m[2]
                rows.append((run[0][0], tuple(c for _, c, _ in run), width))
            rows.sort(key=lambda r: r[0])
            widths = [b for _, _, b in rows]
            classes = sorted(set(widths))
            if len(classes) > 1:
                # B-widened (one padded launch) vs G-batched by width
                # (exact rows, one launch per width class) — scored under
                # the slot's precision discount and the cells' mean
                # skipped-tile density
                cell_dens = [items_by_uid[c.uid].layer_density(c.layer)
                             for _, cells, _ in rows for c in cells]
                dens = sum(cell_dens) / len(cell_dens)
                if cm is not None:
                    dirs = sorted({c.direction for _, cells, _ in rows
                                   for c in cells})
                    merged = cm.slot_us(family, H, len(rows), max(widths),
                                        chunk_len, dtype, dirs=dirs,
                                        precision=precision)
                    split = sum(cm.slot_us(
                        family, H, sum(1 for w in widths if w == cls), cls,
                        chunk_len, dtype, dirs=dirs, precision=precision)
                        for cls in classes)
                else:
                    merged = slot_launch_cycles(family, H, chunk_len,
                                                widths, design,
                                                precision=precision,
                                                density=dens)
                    split = sum(slot_launch_cycles(
                        family, H, chunk_len,
                        [w for w in widths if w == cls],
                        design, precision=precision, density=dens)
                        for cls in classes)
                buckets = ([rows] if merged <= split else
                           [[r for r in rows if r[2] == cls]
                            for cls in classes])
            else:
                buckets = [rows]
            tile_k, mvm_block = _slot_config(family, H, macs)
            for bucket in buckets:
                slots.append(Slot(
                    index=len(slots), wave=s, family=family, H=H,
                    B=max(b for _, _, b in bucket), chunk_len=chunk_len,
                    dtype=dtype, tile_k=tile_k, mvm_block=mvm_block,
                    groups=tuple(cells for _, cells, _ in bucket),
                    group_b=tuple(b for _, _, b in bucket),
                    precision=precision))
    return tuple(slots)


REFERENCE_SCHEDULES = ("sequential", "batch", "intergate", "unfolded")
FORCED_SCHEDULES = REFERENCE_SCHEDULES + ("wavefront", "fused", "per_step")


def _fit_stripe(bt: int, B: int, H: int, gates: int,
                precision: str = "fp32", density: float = 1.0,
                device_model: DeviceModel = REFERENCE) -> int:
    """Halve a requested T-stripe until the device admits its sequence
    slot — under the reference's model, until its working set fits the
    VMEM budget (shared by the forced and auto paths).  The
    precision/density-narrowed weight residency applies — an int8 item
    keeps stripes an fp32 one would have to halve."""
    while bt > 1 and not device_model.seq_fits(
            bt, B, H, gates=gates, precision=precision, density=density):
        bt //= 2
    return bt


def _stack_est(it: WorkItem, design: Design, *, nk: int) -> float:
    """Perfmodel stack estimate, per-layer-family aware: a mixed stack's
    cost is approximated as the sum of each family's sub-stack (the slot
    timeline splits by family anyway); exact for homogeneous items."""
    return sum(stack_plan_cycles(f, it.H, it.X, it.T, n, design, nk=nk)
               for f, n in sorted(Counter(it.families).items()))


def _wave_est(it: WorkItem, design: Design, *, nk: int) -> float:
    """Perfmodel estimate of the item's packed-timeline shape at striping
    ``nk``: the anti-diagonal wavefront for unidirectional items, the
    interleaved fwd/bwd timeline for bidirectional ones (which are always
    homogeneous, so the single-family bidir model is exact)."""
    if it.bidirectional:
        return bidir_stack_plan_cycles(it.family, it.H, it.X, it.T, it.L,
                                       design, nk=nk)
    return _stack_est(it, design, nk=nk)


def _per_step_plan(it: WorkItem, design: Design, tile_k, mvm_block,
                   dirs: int = 1) -> ItemPlan:
    """lstm per_step runs one cell-kernel launch per (layer, step); gru has
    no per-step pallas kernel (pure-jnp scan -> zero launches)."""
    est = dirs * sum(per_step_plan_cycles(f, it.H, it.X, it.T, n, design)
                     for f, n in sorted(Counter(it.families).items()))
    n_lstm = sum(1 for f in it.families if f == "lstm")
    return ItemPlan(item=it, schedule="per_step", block_t=0, nk=it.T,
                    tile_k=tile_k, mvm_block=mvm_block,
                    naive_launches=dirs * n_lstm * it.T, est_cycles=est)


def _forced_plan(it: WorkItem, design: Design, force: str, force_bt: int,
                 tile_k, mvm_block,
                 device_model: DeviceModel = REFERENCE) -> ItemPlan:
    """Plan one item under an explicitly requested schedule (the repro_torch.rnn
    ``ExecutionPolicy.schedule`` preference) instead of the scorer's pick.

    Reference schedules (sequential/batch/intergate/unfolded) route
    external: the executor runs them through the pure research
    implementations in core.schedules / core.gru (zero kernel launches).
    ``fused`` is the legacy per-layer fused path (one internally-striped
    sequence-kernel launch per layer -> schedule tag "per_layer") for
    unidirectional items, and the one-wave-per-layer interleaved shape for
    bidirectional ones (whose per-layer fallback was retired);
    ``wavefront`` enters the packed slot timeline at the forced (or
    autotuned) T-stripe.
    """
    dirs = it.dirs
    if force in REFERENCE_SCHEDULES:
        if force == "batch" and set(it.families) != {"lstm"}:
            raise ValueError(
                f"item {it.uid}: schedule 'batch' has no gru reference "
                f"implementation (gru schedules: sequential, intergate, "
                f"unfolded, fused)")
        d = replace(design, schedule=force)
        est = dirs * sum(
            per_step_plan_cycles(f, it.H, it.X, it.T, n, d, launch_cycles=0)
            for f, n in sorted(Counter(it.families).items()))
        return ItemPlan(item=it, schedule=force, block_t=0, nk=1,
                        tile_k=tile_k, mvm_block=mvm_block,
                        naive_launches=0, est_cycles=est)
    if force == "per_step":
        return _per_step_plan(it, design, tile_k, mvm_block, dirs=dirs)
    if force == "fused":
        if not it.bidirectional:
            # per-layer fused launches (the sequence kernel stripes
            # internally, so any T fits in one launch per layer)
            est = _stack_est(it, design, nk=1)
            return ItemPlan(item=it, schedule="per_layer", block_t=force_bt,
                            nk=1, tile_k=tile_k, mvm_block=mvm_block,
                            naive_launches=it.L, est_cycles=est)
        # bidirectional "fused" is the one-wave-per-layer shape of the
        # interleaved timeline (nk collapses to 1 when the whole T fits the
        # VMEM budget — one G=2 launch per layer, fwd and bwd merged —
        # otherwise the minimal striping that does fit)
        force_bt = force_bt or it.T
    # wavefront: forced stripe if given (admission-checked), else the autotuned
    # one — nk may collapse to 1, which IS the packable fused shape
    bt = _fit_stripe(min(it.T, force_bt) if force_bt else
                     table().seq_block(it.T, it.B, it.H, gates=it.gates,
                                       precision=it.precision,
                                       density=it.max_density,
                                       device_model=device_model),
                     it.B, it.H, it.gates, it.precision, it.max_density,
                     device_model)
    nk = cdiv(it.T, bt)
    est = _wave_est(it, design, nk=nk)
    ip = ItemPlan(item=it, schedule="wavefront" if nk > 1 else "fused",
                  block_t=bt, nk=nk, tile_k=tile_k, mvm_block=mvm_block,
                  naive_launches=0, est_cycles=est)
    return _with_naive(ip)


def _per_step_us(it: WorkItem, cm, design: Design) -> float:
    """Measured µs of the per_step candidate: its lstm launches priced by
    the cost model (one cell-kernel launch per (layer, step): the G=1,
    bt=1 signature at the item's B), plus any zero-launch gru scan compute
    converted from the analytic estimate — per_step must not look free
    just because pure-jnp work never hits the launch table."""
    n_lstm = sum(1 for f in it.families if f == "lstm")
    other = it.dirs * sum(
        per_step_plan_cycles(f, it.H, it.X, it.T, n, design,
                             launch_cycles=0)
        for f, n in sorted(Counter(it.families).items()) if f != "lstm")
    launches_us = (it.dirs * n_lstm * it.T *
                   cm.slot_us("lstm", it.H, 1, it.B, 1, it.dtype,
                              precision=it.precision)
                   if n_lstm else 0.0)
    return launches_us + (cm.cycles_to_us(other) if other else 0.0)


def _schedule_item(it: WorkItem, macs: int, design: Design,
                   force: Optional[str] = None,
                   force_bt: int = 0, tracer=NULL_TRACER,
                   cost_model=None,
                   device_model: DeviceModel = REFERENCE) -> ItemPlan:
    """Tile + score one item: pick fused/wavefront striping or fallback.

    With an active measured ``cost_model``, the CHOICE among candidates is
    made on measured µs — each wavefront/fused candidate is solo-packed
    into its slot timeline and priced launch by launch, per_step through
    ``_per_step_us`` — while ``est_cycles`` stays the analytic estimate of
    whatever won (one unit for all downstream cycle accounting).  The
    ``plan_candidates`` instant then records BOTH scores per candidate, so
    analytic-vs-measured divergence stays observable in traces."""
    tile_k = table().tile(it.gates * it.H, max(it.H, it.X), macs).k
    mvm_block = table().block(it.H, it.H, vmem_budget=2 * 2**20)

    if it.family == "rglru":
        if force is not None:
            raise ValueError(
                f"item {it.uid}: rglru items have no schedule override "
                "(diagonal recurrence plans per-layer fused only)")
        # diagonal recurrence: one fused scan launch per recurrent layer,
        # no cross-layer wavefront (layers are separated by block mixing
        # that lives outside the dispatcher)
        est = stack_plan_cycles("rglru", it.H, it.X, it.T, it.L, design, nk=1)
        return ItemPlan(item=it, schedule="fused", block_t=it.T or 1, nk=1,
                        tile_k=tile_k, mvm_block=mvm_block,
                        naive_launches=it.L, est_cycles=est)

    if it.T == 0:
        return ItemPlan(item=it, schedule="fused", block_t=1, nk=0,
                        tile_k=tile_k, mvm_block=mvm_block,
                        naive_launches=0, est_cycles=0.0)

    if force is not None:
        return _forced_plan(it, design, force, force_bt, tile_k, mvm_block,
                            device_model)

    if force_bt:
        # an explicit stripe override (ExecutionPolicy.block_t) pins the
        # wavefront candidate even under "auto" — the scorer still weighs
        # it against per_step, but never re-stripes it
        cands = [_fit_stripe(min(it.T, force_bt), it.B, it.H, it.gates,
                             it.precision, it.max_density, device_model)]
    else:
        bt0 = table().seq_block(it.T, it.B, it.H, gates=it.gates,
                                precision=it.precision,
                                density=it.max_density,
                                device_model=device_model)
        cands = sorted({min(it.T, bt0), min(it.T, max(1, bt0 // 2)),
                        min(it.T, bt0 * 2), it.T})
        # wider-than-bt0 candidates must still be admitted by the device
        # (under the reference's model: the VMEM bound the autotune table
        # enforces)
        cands = [bt for bt in cands
                 if bt <= 1 or device_model.seq_fits(
                     bt, it.B, it.H, gates=it.gates,
                     precision=it.precision, density=it.max_density)
                 ] or [min(it.T, bt0)]
    scored = []
    for bt in cands:
        nk = cdiv(it.T, bt)
        est = _wave_est(it, design, nk=nk)
        scored.append((est, -bt, bt, nk, "wavefront" if nk > 1 else "fused"))
    ps = _per_step_plan(it, design, tile_k, mvm_block, dirs=it.dirs)
    cm = _active_cost_model(cost_model)
    if not (cm is not None and cm.on_card and "gru" in it.families):
        # The port departs from the reference here, on the card only: the
        # reference prices a gru layer's per_step as launch-free compute
        # (its pure-jnp scan), which a table measured on a card converts to
        # a few µs, so measured mode would pick it for every gru item.  On
        # the card that road is plain PyTorch (or, collecting state, L
        # launches the plan does not count), which the port never takes
        # by itself; a table of any other backend plans as the reference.
        scored.append((ps.est_cycles, 0, 0, it.T, "per_step"))

    measured_us: Dict[Tuple[str, int], float] = {}
    if cm is not None:
        # re-rank on measured µs: price each candidate's actual launches
        for e, _, b, n, s in scored:
            if s == "per_step":
                measured_us[(s, b)] = _per_step_us(it, cm, design)
                continue
            trial = ItemPlan(item=it, schedule=s, block_t=b, nk=n,
                             tile_k=tile_k, mvm_block=mvm_block,
                             naive_launches=0, est_cycles=e)
            measured_us[(s, b)] = _slots_us(
                _pack([trial], macs, cost_model=cm,
                      device_model=device_model), cm)
        mu, _, bt, nk, sched = min(
            (measured_us[(s, b)], negb, b, n, s)
            for _, negb, b, n, s in scored)
        est = next(e for e, _, b, n, s in scored
                   if (s, b) == (sched, bt))
    else:
        est, _, bt, nk, sched = min(scored)

    if tracer.enabled:
        # chosen-vs-rejected: every candidate the scorer weighed, so a
        # trace shows WHY a shape won (and by how little); under an active
        # measured cost model each candidate carries both scores
        tracer.instant(
            "plan_candidates", uid=it.uid, chosen=f"{sched}@bt{bt}",
            cost_model="measured" if cm is not None else "analytic",
            candidates=[
                dict({"schedule": s, "block_t": b, "nk": n,
                      "est_cycles": e},
                     **({"est_us": measured_us[(s, b)]}
                        if cm is not None else {}))
                for e, _, b, n, s in sorted(scored)])

    if sched == "per_step":
        return ps
    ip = ItemPlan(item=it, schedule=sched, block_t=bt, nk=nk, tile_k=tile_k,
                  mvm_block=mvm_block, naive_launches=0, est_cycles=est)
    return _with_naive(ip)


def _with_naive(ip: ItemPlan) -> ItemPlan:
    """naive_launches = this item's own slot count when packed alone."""
    alone = _pack([replace(ip, naive_launches=0)], macs=0)
    return replace(ip, naive_launches=len(alone))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def validate_unique_uids(items: Sequence[WorkItem]) -> None:
    """Reject duplicate ``uid``s — the one identity rule every planner
    entry point (and the static verifier's coverage check) shares.  A uid
    names one request's row range across every slot; a duplicate would
    silently alias two requests' state.  Raises ``PlanRejected`` (a
    ``ValueError``: duplicate ids are an input error)."""
    seen = Counter(it.uid for it in items)
    dups = sorted(u for u, n in seen.items() if n > 1)
    if dups:
        from repro_torch.runtime.errors import PlanRejected
        raise PlanRejected(f"duplicate WorkItem uids {dups}", uids=dups)


def plan(items: Iterable[WorkItem], *, macs: int = DEFAULT_MACS,
         align_stripes: bool = True, cross_b: bool = True,
         schedule: Optional[str] = None, block_t: int = 0,
         tracer=None, cost_model=None,
         device_model: DeviceModel = REFERENCE) -> DispatchPlan:
    """Plan a batch of WorkItems into an explicit DispatchPlan.

    ``align_stripes``: items that could share launches (same family/H/
    dtype) re-align to a common T-stripe when the perfmodel says the
    re-striping cost is worth the packing (scored, not assumed).

    ``cross_b``: allow cells that differ only in batch rows to share a
    launch — parameter-sharing items' same-layer cells concatenate on B,
    and ragged widths pad+mask into one slot when the perfmodel scores the
    widened launch cheaper (see ``_pack``).  Off = the launch signature
    includes B, every cell its own row (the pre-cross-B behaviour, kept as
    the benchmark baseline).

    ``schedule``: force every item onto one schedule instead of the
    scorer's pick (the repro_torch.rnn ``ExecutionPolicy.schedule`` preference);
    ``block_t`` pins the wavefront T-stripe (honored under ``schedule=None``
    too — the scorer then only weighs the pinned stripe against per_step).
    None/0 = score freely.

    ``tracer``: an optional ``runtime.obs.Tracer`` — planning gets a
    ``plan`` span tagged with the outcome (slots/launches/est_cycles) and
    each auto-scored item emits a ``plan_candidates`` instant with its
    chosen-vs-rejected schedule scores.

    ``cost_model``: an optional ``calib.MeasuredCostModel`` — when active
    (non-empty table for this backend), schedule/block_t choice and
    ``_pack``'s merge-vs-split are decided on measured µs instead of
    analytic cycles (``plan_candidates`` records both); when None or
    cold (empty table) every decision is exactly the analytic one.
    Stripe alignment stays analytic either way (a launch-credit
    heuristic, not a launch-shape choice).

    ``device_model``: which stripes and cross-B rows the device admits
    (``core.tiling.DeviceModel``; the reference's VMEM budget by default,
    a card's own limits from ``core.tiling.device_model("cuda")``).
    """
    tracer = as_tracer(tracer)
    if schedule is not None and schedule not in FORCED_SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"options {FORCED_SCHEDULES}")
    items = sorted(items, key=WorkItem.order_key)
    validate_unique_uids(items)
    design = Design(macs=macs, schedule="unfolded")
    cm = _active_cost_model(cost_model)

    with tracer.span("plan", n_items=len(items),
                     schedule=schedule or "auto",
                     cost_model="measured" if cm is not None
                     else "analytic") as sp:
        plans = {it.uid: _schedule_item(it, macs, design, force=schedule,
                                        force_bt=block_t, tracer=tracer,
                                        cost_model=cm,
                                        device_model=device_model)
                 for it in items}

        # a pinned block_t is a contract — alignment must not re-stripe it
        if align_stripes and schedule is None and not block_t:
            _align_group_stripes(items, plans, design, cross_b=cross_b,
                                 device_model=device_model)

        packable, external = [], []
        for it in items:
            ip = plans[it.uid]
            if ip.schedule in ("wavefront", "fused") \
                    and it.family != "rglru" and it.T > 0:
                packable.append(ip)
            else:
                external.append(ip.uid)

        slots = _pack(packable, macs, cross_b=cross_b, cost_model=cm,
                      device_model=device_model)
        out = DispatchPlan(items=tuple(plans[it.uid] for it in items),
                           slots=slots, external=tuple(external), macs=macs)
        sp.tag(slots=len(out.slots), launches=out.launches,
               est_cycles=out.est_cycles)
    return out


def plan_decode(items: Iterable[WorkItem], *, macs: int = DEFAULT_MACS,
                tracer=None, cost_model=None,
                device_model: DeviceModel = REFERENCE) -> DispatchPlan:
    """Plan one serving decode tick: each item is a T=1 evaluation of the
    SAME parameter stack (all items must carry one non-None ``share`` key)
    for some batch rows — one active request each, in the serving engine.

    A T=1 item has no wavefront (its L layer cells are serially
    dependent), so the generic planner would emit L per-layer slots.  But
    the dependence chain can run inside ONE launch — the kernel grid walks
    layers in order and the inter-layer value chains through VMEM scratch
    (ROADMAP: "a T=1 wavefront over layers is a single slot") — and the
    items' rows concatenate on B (cross-B packing, trivially un-ragged:
    every layer carries the same rows).  The choice is scored, not
    assumed: ``decode_plan_cycles`` (1 launch) vs ``stack_plan_cycles``
    at nk=1 (L launches); analytically the chain wins whenever
    LAUNCH_CYCLES > 0.

    With an active measured ``cost_model``, chained-vs-loop becomes a REAL
    decision: the chained signature's measured µs against the per-layer
    timeline's (the generic planner at schedule="wavefront", block_t=1 —
    the exact plan shape ``repro_torch.rnn`` already executes for mixed-stack
    decode, so the executor, plancheck, and the serving engine all handle
    it unchanged).  On backends where one chained launch wall-clocks worse
    than L small launches (every interpret backend we measure), the
    measured table flips this tick to the per-layer plan.

    ``device_model`` plans that per-layer alternative (see ``plan``); the
    chained slot itself is admitted or refused by ``analysis.plancheck``.
    """
    tracer = as_tracer(tracer)
    items = sorted(items, key=WorkItem.order_key)
    if not items:
        raise ValueError("plan_decode needs at least one item")
    validate_unique_uids(items)
    head = items[0]
    if head.family not in ("lstm", "gru"):
        raise ValueError(f"no decode kernel for family {head.family!r}")
    for it in items:
        if it.T != 1:
            raise ValueError(f"item {it.uid}: decode items are T=1, got "
                             f"T={it.T}")
        if it.heterogeneous:
            raise ValueError(
                f"item {it.uid}: mixed-family stacks have no chained decode "
                "kernel; repro_torch.rnn falls back to a per-layer T=1 plan")
        if it.share is None:
            raise ValueError(f"item {it.uid}: decode items must declare a "
                             "shared parameter stack (share=...)")
        if it.bidirectional:
            raise ValueError(
                f"item {it.uid}: bidirectional stacks have no streaming "
                f"decode — the backward walk of its {it.L} layer(s) "
                "consumes the FULL sequence, so a T=1 tick cannot exist; "
                "run whole sequences through forward()/prefill() (the "
                "interleaved-wavefront prefill path) instead")
        key = (it.family, it.H, it.L, it.X, it.dtype, it.share, it.precision)
        if key != (head.family, head.H, head.L, head.X, head.dtype,
                   head.share, head.precision):
            raise ValueError(f"item {it.uid}: decode tick items must share "
                             f"(family, H, L, X, dtype, share, precision); "
                             f"{key} != first item's")

    design = Design(macs=macs, schedule="unfolded")
    tile_k, mvm_block = _slot_config(head.family, head.H, macs)
    est_chain = decode_plan_cycles(head.family, head.H, head.X, head.L,
                                   design)
    est_layers = stack_plan_cycles(head.family, head.H, head.X, 1, head.L,
                                   design, nk=1)
    # scoring sanity, not a choice: the chain does the identical serial
    # compute with ONE launch instead of L — the estimates can only differ
    # by the (L-1)·LAUNCH_CYCLES term, so a flip means the perfmodel broke
    # (fail here with context rather than confuse the serving engine with
    # an unexpected plan shape)
    if est_chain > est_layers:
        from repro_torch.runtime.errors import PlanInvariantError
        raise PlanInvariantError(
            f"decode cost model inverted: chained launch estimated at "
            f"{est_chain} cycles > {est_layers} for the per-layer walk, "
            f"but they differ only by the (L-1)·LAUNCH_CYCLES term "
            f"({head.family} H{head.H} L{head.L}) — the perfmodel broke",
            rule="decode-cost-model", uids=[it.uid for it in items])
    B_total = sum(it.B for it in items)

    # measured mode: chained-vs-loop is a real decision, scored in µs.
    # The per-layer alternative is the generic planner's own plan (the
    # shape repro_torch.rnn already executes for mixed stacks) so returning it
    # changes nothing downstream but the launch count.
    cm = _active_cost_model(cost_model)
    chosen = "chained"
    alt = None
    est_chain_us = est_layers_us = None
    if cm is not None:
        est_chain_us = cm.slot_us(head.family, head.H, head.L, B_total, 1,
                                  head.dtype, chained=True,
                                  precision=head.precision)
        alt = plan(items, macs=macs, cross_b=True, schedule="wavefront",
                   block_t=1, tracer=None, cost_model=cost_model,
                   device_model=device_model)
        est_layers_us = _slots_us(alt.slots, cm)
        if est_layers_us < est_chain_us:
            chosen = "per_layer"

    if tracer.enabled:
        cands = [{"schedule": "chained", "est_cycles": est_chain},
                 {"schedule": "per_layer", "est_cycles": est_layers}]
        if cm is not None:
            cands[0]["est_us"] = est_chain_us
            cands[1]["est_us"] = est_layers_us
        tracer.instant(
            "plan_candidates", uids=[it.uid for it in items],
            chosen=chosen,
            cost_model="measured" if cm is not None else "analytic",
            candidates=cands)

    if chosen == "per_layer":
        return alt

    with tracer.span("plan", n_items=len(items), schedule="decode",
                     est_cycles=est_chain):
        item_plans = tuple(
            ItemPlan(item=it, schedule="decode", block_t=1, nk=1,
                     tile_k=tile_k, mvm_block=mvm_block,
                     naive_launches=it.L,
                     est_cycles=est_chain / len(items))
            for it in items)
        slot = Slot(index=0, wave=0, family=head.family, H=head.H,
                    B=B_total, chunk_len=1, dtype=head.dtype, tile_k=tile_k,
                    mvm_block=mvm_block,
                    groups=tuple(tuple(Cell(uid=it.uid, layer=l, chunk=0)
                                       for it in items)
                                 for l in range(head.L)),
                    group_b=(B_total,) * head.L, chained=True,
                    precision=head.precision)
    return DispatchPlan(items=item_plans, slots=(slot,), external=(),
                        macs=macs)


def _align_group_stripes(items: Sequence[WorkItem],
                         plans: Dict[int, ItemPlan],
                         design: Design, *, cross_b: bool = True,
                         device_model: DeviceModel = REFERENCE) -> None:
    """Re-stripe packable same-signature items to one shared block_t.

    Candidate stripes are the members' chosen ones; each candidate is
    scored as the group's summed perfmodel cycles MINUS a launch credit
    for the cells that would merge into shared launches under that stripe
    (computed by actually packing the trial plans) — so the planner only
    re-stripes when the dependency structure genuinely lets items hide
    each other's launches."""
    groups: Dict[Tuple, List[WorkItem]] = {}
    for it in items:
        ip = plans[it.uid]
        if ip.schedule in ("wavefront", "fused") and it.family != "rglru" \
                and it.T > 0 and not it.bidirectional \
                and not it.heterogeneous:
            # under cross-B, different-B items can share launches too.
            # heterogeneous items keep their own validated stripe (their
            # perfmodel trial costs are per-family sums, not comparable);
            # bidirectional items likewise — their interleaved timeline is
            # costed by bidir_stack_plan_cycles, and their cells still
            # pack with any same-signature wave through _pack
            sig = ((it.family, it.H, it.dtype, it.precision) if cross_b
                   else (it.family, it.H, it.B, it.dtype, it.precision))
            groups.setdefault(sig, []).append(it)

    def trial_plans(members, bt):
        out = []
        for m in members:
            mbt = min(bt, m.T) if bt else plans[m.uid].block_t
            # a cross-B group mixes batch widths: the device must admit
            # the shared stripe at each member's OWN B (its original
            # block_t was only validated there) — members the stripe
            # doesn't fit keep their own validated choice
            if mbt > 1 and not device_model.seq_fits(
                    mbt, m.B, m.H, gates=m.gates, precision=m.precision,
                    density=m.max_density):
                mbt = plans[m.uid].block_t
            nk = cdiv(m.T, mbt)
            est = stack_plan_cycles(m.family, m.H, m.X, m.T, m.L, design,
                                    nk=nk)
            out.append(replace(plans[m.uid], block_t=mbt, nk=nk,
                               schedule="wavefront" if nk > 1 else "fused",
                               est_cycles=est))
        return out

    def group_cost(trial):
        naive = sum(len(_pack([t], 0, cross_b=cross_b,
                              device_model=device_model)) for t in trial)
        packed = len(_pack(trial, 0, cross_b=cross_b,
                           device_model=device_model))
        return (sum(t.est_cycles for t in trial)
                - LAUNCH_CYCLES * (naive - packed))

    for sig, members in groups.items():
        if len(members) < 2:
            continue
        # bt=0 keeps every member's own choice (the no-alignment baseline)
        cands = [0] + sorted({plans[m.uid].block_t for m in members})
        best = min(cands, key=lambda bt: (group_cost(trial_plans(members, bt)),
                                          bt))
        for t in trial_plans(members, best):
            plans[t.uid] = _with_naive(t)
