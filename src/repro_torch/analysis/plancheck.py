"""Static verification of ``DispatchPlan``s: prove dispatch invariants
before launch, with no execution.  A copy of ``repro.analysis.plancheck``
(same 13 rules; under the reference's device model, the default, the same
VMEM budget, so plans verify identically).

SHARP's core claim is that a tiled dispatch mechanism handles RNN data
dependencies safely across arbitrary model shapes.  The planner constructs
plans it *believes* satisfy that claim, and the property tests *sample* it
— this module closes the loop by checking every emitted plan against the
formal rules, turning "the wavefront readiness rule holds" from a tested
hope into a machine-checked theorem per plan (the compile-time dataflow
check MASR-style accelerators bake into their schedulers — PAPERS.md).

``check_plan(plan)`` proves, per plan:

Coverage (``coverage-missing`` / ``coverage-duplicate`` /
``coverage-unknown``)
    Every packed item's ``(uid, layer, chunk, direction)`` cell is
    scheduled exactly once; no slot carries a cell of an unknown item, an
    external-fallback item, or an out-of-range layer/chunk/direction.

Chunk tiling (``chunk-tiling``)
    Each covered walk's chunk boundaries tile ``[0, T)`` with no gap or
    overlap: the item's ``nk`` chunks are exactly ``_chunk_lens(T,
    block_t)`` and every slot launches its cells at the chunk's true
    length (remainders included) — together with coverage this is the
    executor's layer-0 slicing contract.

Dependency safety (``readiness-chunk`` / ``readiness-layer`` /
``wave-monotone``)
    The race/hazard check over the wavefront timeline.  Each cell's wave
    index is *strictly* after all its producers': the previous chunk of
    the same (layer, direction) walk (for "bwd" cells, walking descending
    time, that is chunk ``k+1``); and layer ``l-1``'s chunk ``k`` — BOTH
    directions of it for bidirectional items (the fwd‖bwd concat
    barrier).  Strictness also rules out producer/consumer sharing one
    launch.  ``wave-monotone`` ties the executor's slot-tuple order to
    the wave timeline (non-decreasing wave along ``plan.slots``); the two
    rules together prove execution-order safety: producer wave < consumer
    wave and waves non-decreasing in tuple order imply the producer's
    launch really happens first.

Chained decode order (``decode-chain``)
    A chained slot's groups ARE the serial layer chain: group ``g`` holds
    exactly layer ``g``'s cells, chunk 0, direction "fwd", with one cell
    per item in the identical row order at every layer (the in-kernel
    VMEM chain scatters by fixed row offsets).

Packing legality (``pack-row-mix`` / ``pack-width`` / ``pack-signature``)
    No cross-B row mixes directions, layers, dtypes, or non-``share``
    items (a concatenated row binds ONE recurrent matrix U — the
    ``WorkItem.share`` contract); ``group_b`` widths are the exact sums
    of member batch rows, none exceeding the slot's padded ``B``, whose
    value is the widest row; every cell's own layer family / H / dtype
    matches the slot signature it shares.

Tiling provenance (``stripe-align``)
    The slot's ``tile_k`` / ``mvm_block`` are what the autotune table
    prescribes for (family, H) at the plan's MAC budget — a slot cannot
    smuggle in a launch shape the offline exploration never validated.

Resource budget (``vmem-budget``)
    The device admits every slot (``core.tiling.DeviceModel``).  Under the
    reference's model: the per-slot VMEM footprint from tile shapes × dtype
    — the sequence kernels' working set for packed slots, the per-layer
    resident set for chained decode slots — fits a configurable budget
    (default: the autotune table's own ``SEQ_VMEM_BUDGET``).
    Precision-aware: an int8 slot is budgeted at its 1-byte resident
    payload plus per-gate scales (bf16 at 2 bytes), and a block-sparse slot
    at its densest member layer's occupied row-tiles plus the gather index.
    Under a card's model: the card's kernels' limits (H, the launch's C
    ints), each message naming the card's limit.

Any violation raises a structured ``runtime.errors.PlanInvariantError``
naming the rule, slot, and cell; a clean pass returns a
``PlanCheckReport``.  Wired in as ``ExecutionPolicy(verify="plan")`` (the
default): the rnn facade verifies each plan ONCE at build time, under an
obs ``verify`` span so the overhead is measured (it amortizes to zero
across plan-cache hits; ``BENCH_dispatch.json`` prices it).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.tiling import REFERENCE, DeviceModel
from repro_torch.dispatch.planner import (DispatchPlan, ItemPlan, Slot,
                                          _chunk_lens, _slot_config,
                                          validate_unique_uids)
from repro_torch.dispatch.workitem import GATES
from repro_torch.kernels.common import itemsize as dtype_itemsize
from repro_torch.runtime.errors import PlanInvariantError

#: every invariant rule ``check_plan`` proves, in check order
RULES = (
    "vmem-budget",        # per-slot VMEM footprint under the budget
    "stripe-align",       # tile_k / mvm_block match the autotune table
    "pack-width",         # group_b arithmetic: sums, bounds, slot B
    "pack-row-mix",       # no row mixes direction/layer/dtype/non-share
    "pack-signature",     # cell family/H/dtype match the slot signature
    "chunk-tiling",       # chunks tile [0, T) exactly, true lengths
    "coverage-unknown",   # no cell outside the plan's covered spec
    "coverage-missing",   # every expected cell scheduled
    "coverage-duplicate", # ... exactly once
    "decode-chain",       # chained slots walk layers in-order, fixed rows
    "readiness-chunk",    # wave strictly after previous chunk same walk
    "readiness-layer",    # wave strictly after layer l-1 (concat barrier)
    "wave-monotone",      # slot tuple order consistent with wave order
)


@dataclass(frozen=True)
class PlanCheckReport:
    """A clean verification outcome (violations raise instead)."""

    items: int            # covered (packed-timeline) items
    slots: int            # slots walked (packed + chained)
    cells: int            # cells proven covered + hazard-free
    chained: int          # chained decode slots among them

    @property
    def rules(self) -> Tuple[str, ...]:
        return RULES

    def describe(self) -> str:
        tag = f", {self.chained} chained" if self.chained else ""
        return (f"plancheck: OK — {self.items} items, {self.slots} slots, "
                f"{self.cells} cells{tag}; {len(RULES)} rules proven")


def _fail(rule: str, msg: str, *, slot: Optional[Slot] = None,
          cell=None, uids=()) -> PlanInvariantError:
    where = f" (slot {slot.index}" + (f", cell {cell}" if cell else "") + ")" \
        if slot is not None else (f" (cell {cell})" if cell else "")
    return PlanInvariantError(
        f"plan invariant {rule!r} violated{where}: {msg}", rule=rule,
        slot=None if slot is None else slot.index, cell=cell, uids=uids)


def _covered_items(plan: DispatchPlan) -> Dict[int, ItemPlan]:
    """The items whose cells the slot timeline must cover: everything the
    planner did not route external (reference schedules, per_step, rglru,
    T=0 all land in ``plan.external`` and execute off-timeline)."""
    return {ip.uid: ip for ip in plan.items if ip.uid not in plan.external}


def _item_spec(ip: ItemPlan):
    """(expected cell set, chunk length per k, directions) of one covered
    item — the ground truth its scheduled cells are checked against."""
    it = ip.item
    if ip.schedule == "decode":
        lens = [1]
        dirs = ("fwd",)
    else:
        lens = _chunk_lens(it.T, ip.block_t)
        dirs = ("fwd", "bwd") if it.bidirectional else ("fwd",)
    if len(lens) != ip.nk or sum(lens) != it.T or (lens and min(lens) < 1):
        raise _fail(
            "chunk-tiling",
            f"item {it.uid}: nk={ip.nk} chunks at block_t={ip.block_t} "
            f"cannot tile T={it.T} (lens {lens})", uids=(it.uid,))
    expected = {(it.uid, l, k, d)
                for l in range(it.L) for k in range(len(lens)) for d in dirs}
    return expected, lens, dirs


def _check_slot_budget(slot: Slot, budget: Optional[int],
                       covered: Dict[int, ItemPlan],
                       device_model: DeviceModel) -> None:
    """The device admits the slot: a chained decode slot by its per-layer
    rule, a sequence slot by its stripe's.  The reference's footprint is
    precision-aware (an int8 slot's resident U is the 1-byte payload +
    per-gate scales) and sparsity-aware: a row-compacted launch keeps only
    the densest member layer's occupied row-tiles resident (slot-uniform
    Ha), so that density bounds the true set.  Unknown uids fall back
    dense — ``coverage-unknown`` fires right after.
    """
    gates = GATES[slot.family]
    if slot.chained:
        why = device_model.decode_refusal(
            slot.B, slot.H, gates=gates,
            bytes_per_el=dtype_itemsize(slot.dtype), budget=budget)
    else:
        dens = max((covered[grp[0].uid].item.layer_density(grp[0].layer)
                    for grp in slot.groups
                    if grp and grp[0].uid in covered), default=1.0)
        why = device_model.seq_refusal(
            slot.chunk_len, slot.B, slot.H, gates=gates, G=slot.g,
            precision=slot.precision, density=dens, budget=budget)
    if why:
        raise _fail("vmem-budget",
                    f"{why} ({slot.family} H{slot.H} B{slot.B} "
                    f"bt{slot.chunk_len} {slot.dtype} "
                    f"p{slot.precision})", slot=slot)


def _check_slot_tiling(slot: Slot, macs: int) -> None:
    tile_k, mvm_block = _slot_config(slot.family, slot.H, macs)
    if slot.tile_k != tile_k or tuple(slot.mvm_block) != tuple(mvm_block):
        raise _fail(
            "stripe-align",
            f"tile config K{slot.tile_k} blk{tuple(slot.mvm_block)} is not "
            f"the autotune table's K{tile_k} blk{tuple(mvm_block)} for "
            f"{slot.family} H{slot.H} at macs={macs}", slot=slot)


def _check_slot_rows(slot: Slot, covered: Dict[int, ItemPlan]) -> None:
    """Packing legality: group_b arithmetic + cross-B row homogeneity +
    per-cell signature match (also rejects cells of unknown/external
    items before any width arithmetic trusts their B)."""
    if len(slot.groups) != len(slot.group_b):
        raise _fail("pack-width",
                    f"{len(slot.groups)} rows but {len(slot.group_b)} "
                    "group_b widths", slot=slot)
    if not slot.groups or any(not grp for grp in slot.groups):
        raise _fail("pack-width", "empty launch row", slot=slot)
    for grp, b in zip(slot.groups, slot.group_b):
        for cell in grp:
            ip = covered.get(cell.uid)
            if ip is None:
                raise _fail(
                    "coverage-unknown",
                    f"cell of item {cell.uid} which is not on the packed "
                    "timeline (unknown or external-fallback uid)",
                    slot=slot, cell=cell, uids=(cell.uid,))
            it = ip.item
            if not (0 <= cell.layer < it.L) or cell.direction not in (
                    ("fwd", "bwd") if it.bidirectional else ("fwd",)):
                raise _fail(
                    "coverage-unknown",
                    f"layer {cell.layer} / direction {cell.direction!r} "
                    f"outside item {cell.uid}'s walk (L={it.L})",
                    slot=slot, cell=cell, uids=(cell.uid,))
        if len(grp) > 1 and not slot.chained:
            # row homogeneity first: a merged row of mismatched cells is
            # a packing error even when one of them matches the slot
            shares = {covered[c.uid].item.share for c in grp}
            if (len(shares) != 1 or None in shares
                    or len({c.layer for c in grp}) != 1
                    or len({c.direction for c in grp}) != 1
                    or len({covered[c.uid].item.dtype for c in grp}) != 1):
                raise _fail(
                    "pack-row-mix",
                    "cross-B row mixes directions, layers, dtypes, or "
                    f"non-share items: {grp}", slot=slot,
                    uids=sorted({c.uid for c in grp}))
        for cell in grp:
            it = covered[cell.uid].item
            if (it.families[cell.layer] != slot.family or it.H != slot.H
                    or it.dtype != slot.dtype):
                raise _fail(
                    "pack-signature",
                    f"cell binds {it.families[cell.layer]} H{it.H} "
                    f"{it.dtype}, slot signature is {slot.family} "
                    f"H{slot.H} {slot.dtype}",
                    slot=slot, cell=cell, uids=(cell.uid,))
        width = sum(covered[c.uid].item.B for c in grp)
        if width != b or b > slot.B:
            raise _fail(
                "pack-width",
                f"row of {len(grp)} cell(s) holds {width} batch rows but "
                f"group_b says {b} (slot B={slot.B})", slot=slot,
                uids=sorted({c.uid for c in grp}))
    if slot.B != max(slot.group_b):
        raise _fail("pack-width",
                    f"slot B={slot.B} is not the widest row "
                    f"({max(slot.group_b)})", slot=slot)


def _check_chained(slot: Slot, covered: Dict[int, ItemPlan]) -> None:
    """A chained slot's groups are the serial layer walk of one decode
    tick: group g == layer g, chunk 0, "fwd", one cell per item in the
    same row order at every layer."""
    rows0 = tuple(c.uid for c in slot.groups[0])
    for g, grp in enumerate(slot.groups):
        bad = [c for c in grp
               if c.layer != g or c.chunk != 0 or c.direction != "fwd"]
        if bad:
            raise _fail(
                "decode-chain",
                f"group {g} must hold exactly layer {g}'s chunk-0 fwd "
                f"cells, got {bad[0]}", slot=slot, cell=bad[0],
                uids=(bad[0].uid,))
        if tuple(c.uid for c in grp) != rows0:
            raise _fail(
                "decode-chain",
                f"group {g} row order {[c.uid for c in grp]} differs from "
                f"layer 0's {list(rows0)} — the in-kernel chain scatters "
                "by fixed row offsets", slot=slot,
                uids=sorted(set(rows0)))
    for ip in (covered[u] for u in rows0):
        if ip.schedule != "decode":
            raise _fail(
                "decode-chain",
                f"item {ip.uid} (schedule {ip.schedule!r}) inside a "
                "chained slot; only decode items chain", slot=slot,
                uids=(ip.uid,))


def _check_readiness(cell_wave: Dict[tuple, int],
                     covered: Dict[int, ItemPlan],
                     specs: Dict[int, tuple]) -> None:
    """The wavefront hazard detector: every producer strictly earlier."""
    for (uid, l, k, d), w in cell_wave.items():
        nk = len(specs[uid][1])
        it = covered[uid].item
        prev = (uid, l, k - 1, d) if d == "fwd" else (uid, l, k + 1, d)
        if (d == "fwd" and k > 0) or (d == "bwd" and k < nk - 1):
            if cell_wave[prev] >= w:
                raise _fail(
                    "readiness-chunk",
                    f"cell {(uid, l, k, d)} at wave {w} but its walk's "
                    f"previous chunk {prev} is at wave {cell_wave[prev]} "
                    "(must be strictly earlier)", cell=(uid, l, k, d),
                    uids=(uid,))
        if l > 0:
            for dep_d in specs[uid][2]:
                dep = (uid, l - 1, k, dep_d)
                if cell_wave[dep] >= w:
                    barrier = (" — the fwd‖bwd concat barrier"
                               if it.bidirectional else "")
                    raise _fail(
                        "readiness-layer",
                        f"cell {(uid, l, k, d)} at wave {w} but its "
                        f"layer-{l - 1} producer {dep} is at wave "
                        f"{cell_wave[dep]} (must be strictly earlier"
                        f"{barrier})", cell=(uid, l, k, d), uids=(uid,))


def check_plan(plan: DispatchPlan, *,
               vmem_budget: Optional[int] = None,
               device_model: DeviceModel = REFERENCE) -> PlanCheckReport:
    """Statically verify ``plan`` against every rule in ``RULES``.

    Pure inspection — no kernel launches, no parameters, no inputs.
    Raises ``PlanInvariantError`` (naming rule, slot, cell) on the first
    violation; returns a ``PlanCheckReport`` on a clean pass.

    ``device_model``: the device whose admission ``vmem-budget`` proves
    (``core.tiling.DeviceModel``; by default the reference's, whose bound
    is ``core.tiling.SEQ_VMEM_BUDGET``, the same working-set budget the
    autotune table stripes against).  ``vmem_budget`` overrides the
    reference's bound on a slot's footprint; a card's model holds slots to
    its kernels' limits, not to a footprint, and refuses an override
    (``ValueError``).
    """
    validate_unique_uids([ip.item for ip in plan.items])
    covered = _covered_items(plan)
    specs = {uid: _item_spec(ip) for uid, ip in covered.items()}

    scheduled: Counter = Counter()
    cell_wave: Dict[tuple, int] = {}
    chained = 0
    for slot in plan.slots:
        _check_slot_budget(slot, vmem_budget, covered, device_model)
        _check_slot_tiling(slot, plan.macs)
        _check_slot_rows(slot, covered)
        if slot.chained:
            chained += 1
            _check_chained(slot, covered)
        for cell in slot.cells:
            key = (cell.uid, cell.layer, cell.chunk, cell.direction)
            lens = specs[cell.uid][1]
            if cell.chunk >= len(lens):
                raise _fail(
                    "coverage-unknown",
                    f"chunk {cell.chunk} outside item {cell.uid}'s "
                    f"{len(lens)}-chunk walk", slot=slot, cell=cell,
                    uids=(cell.uid,))
            if slot.chunk_len != lens[cell.chunk]:
                raise _fail(
                    "chunk-tiling",
                    f"slot launches chunk {cell.chunk} at length "
                    f"{slot.chunk_len}, but item {cell.uid}'s tiling of "
                    f"[0, {covered[cell.uid].item.T}) "
                    f"makes it {lens[cell.chunk]}", slot=slot, cell=cell,
                    uids=(cell.uid,))
            scheduled[key] += 1
            if not slot.chained:
                cell_wave[key] = slot.wave

    expected = set().union(*(s[0] for s in specs.values())) if specs else set()
    extra = sorted(set(scheduled) - expected)
    if extra:
        raise _fail("coverage-unknown",
                    f"scheduled cell {extra[0]} is outside every covered "
                    "item's walk", cell=extra[0], uids=(extra[0][0],))
    missing = sorted(expected - set(scheduled))
    if missing:
        raise _fail("coverage-missing",
                    f"cell {missing[0]} is never scheduled "
                    f"({len(missing)} missing in total)", cell=missing[0],
                    uids=(missing[0][0],))
    dup = sorted(k for k, n in scheduled.items() if n > 1)
    if dup:
        raise _fail("coverage-duplicate",
                    f"cell {dup[0]} scheduled {scheduled[dup[0]]} times",
                    cell=dup[0], uids=(dup[0][0],))

    _check_readiness(cell_wave, covered, specs)

    waves = [s.wave for s in plan.slots if not s.chained]
    if any(a > b for a, b in zip(waves, waves[1:])):
        raise _fail("wave-monotone",
                    f"slot tuple order contradicts the wave timeline "
                    f"(waves {waves}): the executor runs slots in tuple "
                    "order, so a later-wave slot before an earlier-wave "
                    "one reorders dependencies")

    return PlanCheckReport(items=len(covered), slots=len(plan.slots),
                           cells=sum(scheduled.values()), chained=chained)


def check_decode_tick(plan: DispatchPlan, n_active: int, *,
                      device_model: DeviceModel = REFERENCE) -> None:
    """The serving engine's per-tick dispatch claim, as a plan invariant:
    a decode tick over ``n_active`` active slots plans exactly
    ``n_active``-row cells in every slot — empty pool slots are never
    computed (rule "decode-active-rows"; replaces the engine's former bare
    ``assert``) — and every chained slot is one ``device_model`` admits
    (rule "vmem-budget").  Raises ``PlanInvariantError``."""
    for slot in plan.slots:
        if slot.B != n_active or any(b != n_active for b in slot.group_b):
            raise PlanInvariantError(
                f"decode tick planned {slot.B} batch rows (group_b "
                f"{slot.group_b}) for {n_active} active slots — empty "
                "slots must never be computed:\n" + plan.describe(),
                rule="decode-active-rows", slot=slot.index)
        if slot.chained:
            _check_slot_budget(slot, None, {}, device_model)


__all__ = ["check_plan", "check_decode_tick", "PlanCheckReport", "RULES"]
