"""The dispatch executor: runs a DispatchPlan through the recurrent
kernels.

The port of ``repro.dispatch.executor``.  The packed slot timeline
executes in order; each ``Slot`` becomes exactly one G-batched
sequence-fused launch (``kernels.lstm_cell.lstm_seq`` or
``kernels.gru_cell.gru_seq``).  The final chunk of every layer is
launched at its true remainder length, so the state left behind after
the last slot is the exact t=T state — which is what the serving engine
splices into its decode slots.

A slot's operands take a fixed number of tensor operations, whatever
the number of cells it packs.  Each call lays its packed items into
device buffers, one set per pool of items that share (H, dtype):

  * recurrent state: one tensor of h rows (the items' dtype) and, when a
    layer is an LSTM, one of c rows (fp32); a row per (item, direction,
    layer, batch row);
  * layer outputs: one tensor of H-wide rows holding every layer's
    output of every item, laid (batch row, t, direction) within each
    (item, layer) in the item's own T — packed ragged time, no padding
    to the longest item — so a bidirectional layer's fwd‖bwd output is
    one 2H-wide row of the same tensor to the next layer;
  * layer 0's input products: ONE GEMM per parameter stack over every
    input frame of the call (a bidirectional stack's two directions' W
    side by side), before the first slot.

Per plan (``_PlanOperands``: built once with numpy, sent to the device in
one transfer and kept in the caller's cache, so a plan-cache hit reuses
it) each slot holds index tensors into those buffers: every group's
source rows — in descending time for a "bwd" cell, so nothing is
flipped —, its state rows and its output rows.  A padding row reads a
zero row and is written to a sink row nothing reads.  A slot gathers xw
(one gather a source; for deeper layers one batched product with W), h0
and c0, launches, and scatters out, h_n and c_n with one operation each.
Weights come from banks kept for the cache's lifetime (``_Bank``): the
recurrent matrices under the slot's precision and block sparsity, and W
and b cast once to the product's dtype.  A slot takes a view of a bank
where its groups' layers lie consecutively in it, one gather otherwise.

Slots that do not depend on each other run at once on the card: the plan
gives each slot a lane (a stream) and the slots on other lanes it waits
for — those that wrote its cells' previous chunks and the layer below
(``_PlanOperands._lanes``) — so a bidirectional batch's ragged
utterances, each a chain of launches of its own length, fill the card
side by side instead of one after another.

Cross-B packing: a slot row may be several parameter-sharing cells'
batches concatenated (same U and W — the WorkItem.share contract), and
rows narrower than the slot's width are padded and masked in-kernel
(``b_valid``) to exact no-ops.  ``chained`` slots (T=1 decode) run a
whole tick's dependent layer chain in ONE ``lstm_decode`` /
``gru_decode`` launch, straight from the caller's (L, B, H) state.  A
mixed lstm/gru stack's cells pack into per-family slots of one
timeline; its gru layers carry no cell state.

Bidirectional cells execute in the packed timeline: a "bwd" cell walks
its chunk in descending time — its rows are gathered in that order, and
its produced stripe is scattered back to the same rows (exact,
remainder chunks included).  Each direction carries its own recurrent
state and its own parameter half (layer["fwd"] / layer["bwd"]), and a
deeper cell's input is the chunk of the previous layer's fwd‖bwd
output.

Fault isolation: every packed/chained launch runs behind the guarded
execution ladder.  Under ``on_fault="fallback"`` a launch that raises (or
that a ``runtime.errors.FaultInjector`` makes raise) re-executes per-step
— the same kernels at block_t=1, one launch per timestep (per *layer* for
chained decode slots).  On CUDA tensors the ladder ends there and the
fault is raised: the port never computes a slot in plain PyTorch on the
card.  On CPU tensors every rung is plain PyTorch, and a third rung, the
reference (``kernels.lstm_cell.ref``), keeps the reference ladder's three
levels so injected faults report as they do in ``repro.dispatch``.  Each
degradation is recorded in the caller's ``ExecutionReport``;
``on_fault="raise"`` fails fast with a structured ``LaunchError``.  A
kernel that does not BUILD is not a launch fault: ``KernelBuildError``
passes through every rung, and so does ``KernelLaunchRefused``, a launch
configuration the card refuses (the decode kernels' thread-block
clusters).  ``check_finite`` raises ``NonFiniteStateError`` naming
exactly the poisoned items.

Recurrent-weight precision and block sparsity (a slot's ``precision``,
its items' ``tile_map``): a bank holds every layer's U of one stack and
family transformed once — bf16 round-tripped, int8 quantized per gate
(the payload plus (gates,) scales) and/or row-compacted to the slot's
one active-row width Ha (plus an (Ha,) row index) — and every kernel
rung receives the same operands; the CPU reference rung dequantizes and
expands them back to dense.  Decode ticks run the dense decode kernels
on the fake-quantized weights (``prepare_decode_stack(precision=)``).

Items the planner routes off the packed timeline (the reference
schedules, per_step, T=0 items, and single-layer rglru items, which run
``kernels.rglru.rglru_scan`` on a ``(log_a, gx)`` input pair) run first,
one at a time (``_run_reference``, ``_run_stack_collect``,
``_run_rglru``).
"""
from __future__ import annotations

import contextlib
import functools
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.perfmodel import MXU_ROWS
from repro_torch.core.schedules import stack_families
from repro_torch.dispatch.planner import REFERENCE_SCHEDULES, DispatchPlan
from repro_torch.dispatch.workitem import GATES
from repro_torch.kernels.common import (_SEQ_ROWS, MAX_H, KernelBuildError,
                                        KernelLaunchRefused, cdiv,
                                        seq_splits, torch_dtype)
from repro_torch.kernels.gru_cell.ops import gru_decode, gru_seq
from repro_torch.kernels.gru_cell.ref import gru_seq_ref, gru_step_ref
from repro_torch.kernels.lstm_cell.ops import lstm_decode, lstm_seq
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref, lstm_seq_ref
from repro_torch.kernels.quant import (active_row_indices, bf16_roundtrip,
                                       compact_rows, expand_rows,
                                       fake_quant_stack, quantize_per_gate)
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.runtime.errors import (FALLBACK_LEVELS, ExecutionReport,
                                        FaultInjector, LaunchError,
                                        NonFiniteStateError)
from repro_torch.runtime.obs import NULL_TRACER, as_tracer

#: bytes of per-plan index tensors a caller-owned cache keeps, the
#: oldest plan's dropped first (the newest is always kept)
PLAN_OPERAND_BYTES = 64 * 2**20

#: the cache entry holding the per-plan operands (an LRU by plan)
_PLANS = "plans"

#: every input product of a sequence slot runs as a batched product of at
#: least 2 entries of at least 32 rows (zero rows and a zero entry pad
#: it): the card's batched fp32 GEMM gives a row the same bits at every
#: such shape (NVIDIA H100, K 340-1024, N 1020-4096, 17-6000 rows, 2-4
#: entries), where a plain one picks other kernels by its row count, so a
#: request's rows do not depend on what shares its launches
PRODUCT_ROWS, PRODUCT_ENTRIES = 32, 2


@functools.lru_cache(maxsize=None)
def _promote(*dtypes):
    """The dtype JAX's einsum promotes its operands to."""
    out = dtypes[0]
    for dt in dtypes[1:]:
        out = torch.promote_types(out, dt)
    return out


def _hoist(layer_params, src, gates: int):
    """One cell's input half: (B, bt, X) @ (X, gates·H) + b -> (B,bt,g,H),
    in the dtype JAX's einsum would promote to.

    On the card a one-row product runs as two rows (the row twice):
    cuBLAS takes another kernel for one row, whose sums differ in the last
    bit from the one every larger row count takes, and a request's rows
    must not depend on how many rows share its launch — a decode tick
    whose other slots were quarantined or retired runs one row."""
    B, bt, _ = src.shape
    W, b = layer_params["W"], layer_params["b"]
    H = layer_params["U"].shape[0]
    dt = _promote(src.dtype, W.dtype, b.dtype)
    x = src.to(dt)
    if B * bt == 1 and _on_card(x):
        xw = torch.matmul(torch.cat([x, x]), W.to(dt))[:1] + b.to(dt)
    else:
        xw = torch.matmul(x, W.to(dt)) + b.to(dt)
    return xw.reshape(B, bt, gates, H)


@torch.no_grad()
def execute(plan: DispatchPlan, params: Dict[int, dict],
            inputs: Dict[int, torch.Tensor], *,
            collect_state: bool = False,
            init_state: Optional[Dict[int, dict]] = None,
            prepared: Optional[Dict[int, dict]] = None,
            operand_cache: Optional[dict] = None,
            on_fault: str = "raise",
            check_finite: bool = False,
            inject: Optional[FaultInjector] = None,
            report: Optional[ExecutionReport] = None,
            tracer=None):
    """Run ``plan``.  params[uid] = stack params ({"layers": [...]}),
    inputs[uid] = xs (B, T, X) on the device the stack's tensors lie on —
    for an rglru item the (log_a, gx) pair of its hoisted gate inputs, each
    (B, T, W) fp32 (``models.layers.rglru.gate_inputs``), with no params.
    Returns outputs {uid: (B, T, H)} — (B, T, 2H) for bidirectional items
    (fwd‖bwd concat), hs (B, T, W) for rglru items — or (outputs, states)
    when ``collect_state``: states[uid] is {"h": (L,B,H)[, "c": (L,B,H)]}
    (exact t=T recurrent state; "c" whenever any layer is an LSTM, a mixed
    stack's gru rows zeros), for bidirectional items a per-direction pair
    {"fwd": {...}, "bwd": {...}} (fwd is the exact t=T state, bwd the
    exact t=0 state — the end of its walk), or ``None`` for items that
    expose no (h[, c]) state: rglru items and items executed through an
    external stateless schedule.  A packed item's outputs and states may
    be views of tensors the call allocated for all its items.

    ``init_state`` optionally seeds the recurrent state of packed items:
    init_state[uid] = {"h": (L,B,H)[, "c": (L,B,H)]} replaces the zero
    initial state (the serving engine's decode ticks resume from it; a
    chained tick launches on these tensors as they are).
    External items reject it (their schedule surfaces start from zeros),
    and so do bidirectional items: their two walks start from opposite
    sequence ends, so there is no mid-stream resume point.

    ``prepared`` optionally carries pre-stacked decode weights per uid
    (see ``prepare_decode_stack``) so steady-state decode ticks don't
    restack unchanged parameters every tick.

    ``operand_cache`` memoizes, across calls when the caller owns the dict
    (``CompiledStack`` keeps one for its lifetime, its parameters never
    changing), what depends only on the parameters or only on the plan:
    per stack the weight banks (U under each precision and active-row
    width, W and b cast to the product's dtype, the decode operands), and
    per plan its operand indices (the newest plans' up to
    ``PLAN_OPERAND_BYTES``).  None builds a per-call cache, so each
    layer's weights are still transformed at most once per execute().

    ``collect_state`` reroutes external unidirectional items through the
    per-layer fused path (``_run_stack_collect``) — the only surface that
    returns exact state — so for those items the plan's per_step/per_layer
    launch accounting describes the stateless execution, not this one.

    ``on_fault``/``check_finite``/``inject``/``report`` drive the guarded
    execution ladder (module doc).  ``tracer`` (optional
    ``runtime.obs.Tracer``): every slot gets a ``hoist`` span and a
    ``slot_launch`` span, each the host's time to issue its work, and
    layer 0's products one ``hoist`` span (tag ``layer=0``) before them;
    each ``hoist`` is tagged with ``cells`` (the cells whose operands it
    assembled) and ``gemms`` (the input products it issued).  None binds
    the shared no-op tracer — no events, outputs bit-identical.
    """
    tracer = as_tracer(tracer)
    if on_fault not in ("raise", "fallback"):
        raise ValueError(f"execute: on_fault={on_fault!r} invalid; "
                         "allowed: raise, fallback")
    # fail fast, before any work: a plan may legitimately carry plan-only
    # items (ItemPlan.executable == False) for admission pricing — callers
    # filter those out before executing (see examples/dispatch_demo.py)
    plan_only = [ip.uid for ip in plan.items if not ip.executable]
    if plan_only:
        raise NotImplementedError(
            f"plan contains plan-only items (uids {plan_only}): multi-layer "
            "rglru executes through its model, not the dispatcher — filter "
            "by ItemPlan.executable before execute()")
    # state resume is a packed-timeline feature only; silently dropping a
    # caller's init_state for an external item would compute from zeros
    dropped = sorted(set(init_state or {}) & set(plan.external))
    if dropped:
        raise ValueError(
            f"init_state given for external-fallback items {dropped}: their "
            "schedule surfaces start from zero state — plan them onto the "
            "packed timeline (e.g. schedule='wavefront') to resume")
    for ip in plan.items:
        if (ip.item.bidirectional
                and (init_state or {}).get(ip.uid) is not None):
            raise ValueError(
                f"init_state given for bidirectional item {ip.uid}: the "
                "fwd/bwd walks start from opposite sequence ends, so there "
                "is no mid-stream state to resume from")

    outputs: Dict[int, torch.Tensor] = {}
    states: Dict[int, dict] = {}
    owned = operand_cache is not None
    cache = operand_cache if owned else {}

    # ---- external items (reference schedules / per_step / rglru / T=0) —
    # bidirectional items land here only under a forced stateless
    # schedule; their planned path is the interleaved packed timeline ----
    for ip in plan.items:
        if ip.uid not in plan.external:
            continue
        it = ip.item
        xs = inputs[it.uid]
        if it.family == "rglru":
            outputs[it.uid] = _run_rglru(xs)
            if collect_state:
                states[it.uid] = None  # rglru exposes no (h, c) state
            continue
        if collect_state and not it.bidirectional:
            # state collection forces the per-layer fused path (the seq
            # kernels are the only surface that returns exact t=T state)
            outputs[it.uid], states[it.uid] = _run_stack_collect(
                it, params[it.uid], xs)
            continue
        # per_layer (the forced-"fused" shape) is the per-layer fused
        # path; everything else external runs its own named schedule
        sched = ("fused" if ip.schedule in ("per_layer", "fused")
                 else ip.schedule)
        outputs[it.uid] = _run_reference(params[it.uid], xs, sched,
                                         block_t=ip.block_t)
        if collect_state:
            states[it.uid] = None  # stateless external schedule

    # ---- the packed slot timeline ---------------------------------------
    guard = dict(on_fault=on_fault, check_finite=check_finite,
                 inject=inject, report=report, tracer=tracer)
    run = None
    if any(not s.chained for s in plan.slots):
        ops = _plan_operands(plan, params, inputs, cache, owned)
        with tracer.span("hoist", layer=0, cells=ops.x0_cells,
                         gemms=ops.x0_gemms):
            run = _Run(ops, inputs, init_state, cache)
    try:
        for slot in plan.slots:
            if slot.chained:
                _run_chained_slot(slot, plan, params, inputs, init_state,
                                  prepared, cache, outputs,
                                  states if collect_state else None,
                                  **guard)
            else:
                run.slot(slot, **guard)
    finally:
        if run is not None:
            run.join()
    if run is not None:
        run.collect(outputs, states if collect_state else None)
    return (outputs, states) if collect_state else outputs


# ---------------------------------------------------------------------------
# weight banks: per stack, for the cache's lifetime
# ---------------------------------------------------------------------------


class _Bank:
    """Operands of one stack's (layer, direction) cells stacked on a
    leading axis: ``pos[(layer, direction)]`` is a cell's row in each of
    ``tensors`` (None entries stay None).  ``take`` gives a slot its
    groups' rows: a view where they are consecutive, else the rows to
    gather at launch time."""

    def __init__(self, pos: dict, *tensors):
        self.pos = pos
        self.tensors = tensors
        self._views: dict = {}

    def take(self, rows: List[int]):
        lo = rows[0]
        if rows == list(range(lo, lo + len(rows))):
            key = (lo, len(rows))
            views = self._views.get(key)
            if views is None:
                views = self._views[key] = tuple(
                    None if t is None else t[lo:lo + len(rows)]
                    for t in self.tensors)
            return _Take(views, None)
        return _Take(None, self, rows)

    @staticmethod
    def joint(banks) -> "_Bank":
        """The rows of several banks in one: ``pos`` keyed (bank index,
        layer, direction)."""
        pos, off = {}, 0
        for i, bank in enumerate(banks):
            for key, row in bank.pos.items():
                pos[(i,) + key] = off + row
            off += len(bank.tensors[0])
        return _Bank(pos, *(None if ts[0] is None else torch.cat(ts)
                            for ts in zip(*(b.tensors for b in banks))))


class _Take:
    """A slot's rows of a bank: ``views`` ready, or ``bank`` rows to
    gather with the index ``idx`` (a device tensor once uploaded)."""

    __slots__ = ("views", "bank", "idx")

    def __init__(self, views, bank, idx=None):
        self.views, self.bank, self.idx = views, bank, idx

    def get(self):
        if self.views is not None:
            return self.views
        return tuple(None if t is None else t.index_select(0, self.idx)
                     for t in self.bank.tensors)


def _memo(cache: dict, key, owner, build):
    """``cache[key]``, built once per owner: the entry holds the owner,
    so the id() in the key cannot be reused while the entry lives."""
    hit = cache.get(key)
    if hit is None or hit[0] is not owner:
        hit = cache[key] = (owner, build())
    return hit[1]


def _halves(stack: dict, layer: int) -> list:
    """A layer's parameter dicts by direction: [layer] or [fwd, bwd]."""
    p = stack["layers"][layer]
    return [p["fwd"], p["bwd"]] if "fwd" in p else [p]


def _bitmap(tile_map, layer: int, H: int) -> tuple:
    """A layer's 8-row tile occupancy (all ones for a dense item)."""
    if tile_map is None:
        return (1,) * cdiv(H, MXU_ROWS)
    return tile_map[layer]


@functools.lru_cache(maxsize=4096)
def _active_rows(bitmap: tuple, H: int) -> int:
    return len(active_row_indices(bitmap, H))


def _u_bank(cache: dict, stack: dict, families, family: str,
            precision: str, Ha: int, tile_map) -> _Bank:
    """Every ``family`` layer's recurrent matrix of ``stack`` as a launch
    takes it: (n, H, gates, H) — bf16 round-tripped, int8 quantized per
    gate (plus (n, gates) scales), row-compacted to ``Ha`` rows (plus
    (n, Ha) row indices; only the layers with at most Ha active rows)
    when Ha >= 0."""

    def build():
        gates = GATES[family]
        pos, us, scales, rows = {}, [], [], []
        for l, fam in enumerate(families):
            if fam != family:
                continue
            for d, half in enumerate(_halves(stack, l)):
                H = half["U"].shape[0]
                bitmap = _bitmap(tile_map, l, H)
                if Ha >= 0 and _active_rows(bitmap, H) > Ha:
                    continue
                U = half["U"].reshape(H, gates, H)
                if precision == "bf16":
                    U = bf16_roundtrip(U)
                s = r = None
                if precision == "int8":
                    U, s = quantize_per_gate(U)
                if Ha >= 0:
                    U, r = compact_rows(U, bitmap, pad_to=Ha)
                pos[(l, d)] = len(us)
                us.append(U)
                scales.append(s)
                rows.append(r)
        return _Bank(pos, torch.stack(us),
                     torch.stack(scales) if precision == "int8" else None,
                     torch.stack(rows) if Ha >= 0 else None)

    return _memo(cache, ("u", id(stack), family, precision, Ha, tile_map),
                 stack, build)


def _w_bank(cache: dict, stack: dict, families, family: str,
            dt: torch.dtype) -> _Bank:
    """Every deeper ``family`` layer's input half of ``stack`` cast once
    to the product's dtype ``dt``: W (n, X, gates·H) and b (n, 1,
    gates·H), for one batched product a slot."""

    def build():
        pos, ws, bs = {}, [], []
        for l, fam in enumerate(families):
            if l == 0 or fam != family:
                continue
            for d, half in enumerate(_halves(stack, l)):
                pos[(l, d)] = len(ws)
                ws.append(half["W"].to(dt))
                bs.append(half["b"].to(dt).reshape(1, -1))
        return _Bank(pos, torch.stack(ws), torch.stack(bs))

    return _memo(cache, ("w", id(stack), family, dt), stack, build)


def _w0(cache: dict, stack: dict, dt: torch.dtype):
    """Layer 0's W and b of ``stack`` cast once to ``dt``, the directions
    side by side: (X, dirs·gates·H), (dirs·gates·H,)."""

    def build():
        halves = _halves(stack, 0)
        W = [h["W"].to(dt) for h in halves]
        b = [h["b"].to(dt) for h in halves]
        if len(halves) == 1:
            return W[0], b[0]
        return torch.cat(W, dim=1), torch.cat(b)

    return _memo(cache, ("w0", id(stack), dt), stack, build)


# ---------------------------------------------------------------------------
# per plan: the buffers' layout and every slot's index tensors
# ---------------------------------------------------------------------------


class _Item:
    """One packed item's place in its pool's buffers (rows of the layer-0
    products ``x0``, of each layer's output ``y[l]`` and of its state
    ``s``)."""

    def __init__(self, k, ip, stack, pool, x0key):
        it = ip.item
        self.k, self.ip, self.it, self.stack = k, ip, it, stack
        self.pool, self.x0key = pool, x0key
        self.dirs = 2 if it.bidirectional else 1
        self.wset = (id(stack), it.tile_map)   # one set of U banks
        self.x0 = self.s = 0
        self.y: List[int] = []


class _Pool:
    """The buffers of the items that share (H, dtype): the layer-0
    products by (family, dtype) (``x0``: per stack a segment of rows and
    its cast W), the layer outputs' rows (``n_y``: each item's non-top
    layers, then every item's top layer in [top_lo, top_hi), two zero
    rows at ``y_zero``, sink rows) and the state rows (``n_s``: the
    items' rows, a zero row ``s_zero``, sink rows)."""

    def __init__(self, H: int, dtype: torch.dtype):
        self.H, self.dtype = H, dtype
        self.items: List[_Item] = []
        self.x0: Dict[tuple, dict] = {}
        self.has_c = False
        self.n_y = self.y_zero = self.top_lo = self.top_hi = 0
        self.n_s = self.s_zero = 0


class _Class:
    """The groups of one slot that read one source: layer 0's products
    (``w`` None: a gather is their xw) or a layer's outputs, 1 or 2
    directions wide (``w``: the groups' W and b for one batched product
    in ``dt`` of ``rows`` rows a group, padded by ``pad``, a
    ``constant_pad_nd`` of (rows, entries), to the product's least
    shape)."""

    __slots__ = ("source", "g", "rows", "X", "dt", "w", "pad", "gidx")

    def __init__(self, source, g, rows, X, dt, w):
        self.source, self.g, self.rows, self.X, self.dt, self.w = (
            source, g, rows, X, dt, w)
        more = (max(rows, PRODUCT_ROWS) - rows,
                max(g, PRODUCT_ENTRIES) - g)
        self.pad = (0, 0, 0, more[0], 0, more[1]) if any(more) else None
        self.gidx = None


class _SlotOps:
    """One sequence slot's operands: its classes, its U rows, and index
    tensors for the state rows read (``sread``) and written
    (``swrite``), the output rows written (``oidx``) and the valid rows
    among the launch's (``vpos``; ``vuid`` their uids).  A slot without
    padding rows writes the rows it reads, and all its rows are valid
    (``vpos`` None)."""

    __slots__ = ("pool", "G", "B", "bt", "gates", "H", "lstm", "classes",
                 "u", "b_valid", "sread", "swrite", "oidx", "vpos", "vuid",
                 "nvalid", "nseg", "uids", "cells", "gemms", "lane",
                 "waits", "signal")


def _expand(base, sb, sj, nb, bt):
    """Rows of segments: segment i gives nb[i]·bt[i] rows base[i] +
    b·sb[i] + j·sj[i], for b < nb[i] outer and j < bt[i] inner."""
    seg = np.repeat(np.arange(len(nb)), nb)           # a row's segment
    b = np.arange(len(seg)) - (np.cumsum(nb) - nb)[seg]
    first = base[seg] + b * sb[seg]                  # each row's j = 0
    w, step = bt[seg], sj[seg]
    start = np.cumsum(w) - w
    return (np.repeat(first - start * step, w)
            + np.arange(int(w.sum())) * np.repeat(step, w))


def _upload(arrays, dtype, device, sizes):
    """numpy int arrays as one device tensor, split into views of
    ``sizes``: one transfer, which does not wait for the device (from
    pageable memory the driver stages the bytes before it returns)."""
    flat = torch.from_numpy(np.concatenate(arrays).astype(dtype,
                                                          copy=False))
    if device.type != "cpu":
        flat = flat.to(device, non_blocking=True)
    return flat.split(sizes), flat.numel() * flat.element_size()


class _PlanOperands:
    """Everything about a plan's sequence slots that the plan and the
    stacks' parameters decide: the pools' layout and each slot's
    ``_SlotOps``, for one device."""

    def __init__(self, plan: DispatchPlan, params, device, cache: dict):
        self.plan, self.device = plan, device
        seq = [s for s in plan.slots if not s.chained]
        used = {c.uid for s in seq for grp in s.groups for c in grp}
        self.items: Dict[int, _Item] = {}
        self.pools: List[_Pool] = []
        pool_of: Dict[tuple, int] = {}
        for ip in plan.items:
            if ip.uid not in used:
                continue
            it = ip.item
            key = (it.H, it.dtype)
            if key not in pool_of:
                pool_of[key] = len(self.pools)
                self.pools.append(_Pool(it.H, torch_dtype(it.dtype)))
            pool = self.pools[pool_of[key]]
            stack = params[ip.uid]
            half = _halves(stack, 0)[0]
            dt = _promote(pool.dtype, half["W"].dtype, half["b"].dtype)
            li = _Item(len(self.items), ip, stack, pool_of[key],
                       (it.families[0], dt))
            self.items[ip.uid] = li
            pool.items.append(li)
            pool.has_c |= "lstm" in it.families
            src = pool.x0.setdefault(li.x0key, {"segs": {}, "rows": 0})
            seg = src["segs"].setdefault(id(stack), {
                "items": [], "frames": 0, "dirs": li.dirs,
                "X": it.X, "w": _w0(cache, stack, dt)})
            li.x0 = seg["frames"]   # frame offset; rows once laid below
            seg["items"].append(li)
            seg["frames"] += it.B * it.T
        self.uids = tuple(self.items)
        self.stacks = tuple(id(params[u]) for u in self.uids)
        self.x0_cells = sum(len(grp) for s in seq for grp in s.groups
                            if grp[0].layer == 0)
        self.x0_gemms = 0
        for pool in self.pools:
            self._lay(pool)
            self.x0_gemms += sum(len(src["segs"]) for src in pool.x0.values())
        self._joints: Dict[tuple, _Bank] = {}
        self.slots: Dict[int, _SlotOps] = {}
        self.nbytes = 0
        self._build(seq, cache)

    def _lay(self, pool: _Pool) -> None:
        for src in pool.x0.values():
            for seg in src["segs"].values():
                seg["row0"] = src["rows"]
                for li in seg["items"]:
                    li.x0 = src["rows"] + li.x0 * seg["dirs"]
                # one batched product of PRODUCT_ENTRIES entries
                seg["entry"] = max(cdiv(seg["frames"], PRODUCT_ENTRIES),
                                   PRODUCT_ROWS)
                src["rows"] += PRODUCT_ENTRIES * seg["entry"] * seg["dirs"]
            src["zero"] = src["rows"]   # one zero row after them
        n = 0
        for top in (False, True):
            if top:
                pool.top_lo = n
            for li in pool.items:
                it = li.it
                size = it.B * it.T * li.dirs
                layers = [it.L - 1] if top else range(it.L - 1)
                for _ in layers:
                    n += n % 2      # a 2H-wide row starts at an even row
                    li.y.append(n)
                    n += size
        pool.top_hi = n
        pool.y_zero = n + n % 2
        n = 0
        for li in pool.items:
            li.s = n
            n += li.dirs * li.it.L * li.it.B
        pool.s_zero = n

    def _lead(self, key, li, layer, d, family, precision, Ha, pool):
        """A group's U bank and row, its source class, its W bank (deeper
        layers) and its place in the slot: classes contiguous, layer 0's
        first, then bank order."""
        ubank = _u_bank(self.cache, li.stack, li.it.families, family,
                        precision, Ha, li.it.tile_map)
        if layer == 0:
            cls, wbank = ("x0",) + li.x0key, None
        else:
            half = _halves(li.stack, layer)[d]
            dt = _promote(pool.dtype, half["W"].dtype, half["b"].dtype)
            cls = ("y", li.dirs, dt)
            wbank = _w_bank(self.cache, li.stack, li.it.families, family, dt)
        rank = (cls[0] != "x0", str(cls), ubank.pos[(layer, d)])
        hit = self._memo[key] = (rank, ubank, (layer, d), cls, wbank)
        return hit

    def _build(self, seq, cache: dict) -> None:
        self.cache, self._memo = cache, {}
        segs = []   # (k, layer, d, t_first, step, nb, bt, pad, zero, pad_y,
        #             pad_s, x0): a cell's rows, or a group's padding rows
        memo = self._memo
        metas = []
        for slot in seq:
            before = len(segs)
            so = _SlotOps()
            groups = slot.groups
            lead = [self.items[grp[0].uid] for grp in groups]
            pool = self.pools[lead[0].pool]
            so.pool, so.G, so.B, so.bt = lead[0].pool, len(groups), slot.B, \
                slot.chunk_len
            so.H, so.gates = slot.H, GATES[slot.family]
            so.lstm = slot.family == "lstm"
            so.cells = sum(len(grp) for grp in groups)
            so.uids = sorted({c.uid for grp in groups for c in grp})
            # U: one bank per stack under the slot's precision and, where
            # any lead carries a tile map, the slot's one active-row width
            Ha = -1
            if any(li.it.tile_map is not None for li in lead):
                Ha = max(max(_active_rows(
                    _bitmap(li.it.tile_map, grp[0].layer, slot.H), slot.H)
                    for li, grp in zip(lead, groups)), 1)
            order = []
            for g, (li, grp) in enumerate(zip(lead, groups)):
                c = grp[0]
                key = (li.wset, c.layer, c.direction, slot.family,
                       slot.precision, Ha)
                info = memo.get(key) or self._lead(
                    key, li, c.layer, int(c.direction == "bwd"),
                    slot.family, slot.precision, Ha, pool)
                order.append((info[0], g, info[1:]))
            order.sort()
            so.u = self._take([o[2][:2] for o in order])
            runs, bvalid = [], []
            pad_y = pad_s = 0
            for _, g, info in order:
                cls = info[2]
                if not runs or runs[-1][0] != cls:
                    runs.append((cls, []))
                runs[-1][1].append(info)
                x0 = int(cls[0] == "x0")
                for c in groups[g]:
                    li = self.items[c.uid]
                    d = int(c.direction == "bwd")
                    t0 = c.chunk * li.ip.block_t
                    segs.append((li.k, c.layer, d,
                                 t0 + so.bt - 1 if d else t0, 1 - 2 * d,
                                 li.it.B, so.bt, 0, 0, 0, 0, x0))
                gb = slot.group_b[g]
                if gb < so.B:
                    zero = (pool.x0[cls[1:]]["zero"] if x0
                            else pool.y_zero // cls[1])
                    segs.append((0, 0, 0, 0, 0, so.B - gb, so.bt, 1, zero,
                                 pad_y, pad_s, x0))
                    pad_y += (so.B - gb) * so.bt
                    pad_s += so.B - gb
                bvalid.append(gb)
            pool.n_y = max(pool.n_y, pad_y)
            pool.n_s = max(pool.n_s, pad_s)
            so.b_valid = bvalid if any(b < so.B for b in bvalid) else None
            so.nvalid = sum(bvalid)
            so.classes = [
                _Class(cls[:2] if cls[0] == "y" else cls, len(infos),
                       so.B * so.bt, pool.H * cls[1] if cls[0] == "y"
                       else 0, cls[-1],
                       None if cls[0] == "x0" else
                       self._take([(i[3], i[1]) for i in infos]))
                for cls, infos in runs]
            so.gemms = sum(1 for c in so.classes if c.w is not None)
            so.nseg = len(segs) - before
            metas.append(so)
            self.slots[slot.index] = so
        del self.cache, self._memo
        self._lanes(seq, metas)
        for pool in self.pools:
            # sinks after the zero rows; an even count keeps the 2H view
            pool.n_y = pool.y_zero + 2 + pool.n_y
            pool.n_y += pool.n_y % 2
            pool.n_s = pool.s_zero + 1 + pool.n_s
        self._index(segs, metas)

    def _lanes(self, seq, metas) -> None:
        """Which stream (lane) each slot issues on, and the slots on other
        lanes it waits for.  A slot waits for the slots that wrote what it
        reads: its cells' previous chunks (the state rows) and the layer
        below's chunks (the source rows).  It issues on the lane of the
        latest of them, so a chain of dependent slots stays on one lane;
        a slot that depends on none takes the next lane in turn."""
        self.n_lanes = _lane_count(self.device, seq)
        where = {}
        for pos, slot in enumerate(seq):
            for grp in slot.groups:
                for c in grp:
                    where[(c.uid, c.layer, c.chunk, c.direction)] = pos
        turn = 0
        for pos, (slot, so) in enumerate(zip(seq, metas)):
            preds = set()
            for grp in slot.groups:
                for c in grp:
                    step = 1 if c.direction == "bwd" else -1
                    deps = [(c.uid, c.layer, c.chunk + step, c.direction)]
                    if c.layer:
                        deps += [(c.uid, c.layer - 1, c.chunk, d)
                                 for d in ("fwd", "bwd")]
                    preds.update(where[k] for k in deps if k in where)
            preds.discard(pos)
            if preds:
                so.lane = metas[max(preds)].lane
            else:
                so.lane, turn = turn % self.n_lanes, turn + 1
            waits = sorted(p for p in preds if metas[p].lane != so.lane)
            so.waits = [seq[p].index for p in waits]
            so.signal = False
            for p in waits:
                metas[p].signal = True

    def _take(self, rows) -> "_Take":
        """One ``_Take`` of cells given as (bank, (layer, direction))."""
        bank = rows[0][0]
        if all(r[0] is bank for r in rows):
            return bank.take([bank.pos[cell] for _, cell in rows])
        banks = []
        for b, _ in rows:
            if all(b is not x for x in banks):
                banks.append(b)
        ids = tuple(id(b) for b in banks)
        joint = self._joints.get(ids)
        if joint is None:
            joint = self._joints[ids] = _Bank.joint(banks)
            self.nbytes += sum(t.numel() * t.element_size()
                               for t in joint.tensors if t is not None)
        return joint.take([joint.pos[(ids.index(id(b)),) + cell]
                           for b, cell in rows])

    def _index(self, segs, metas) -> None:
        """Every slot's index tensors, from the segments in one pass."""
        A = np.array(segs, dtype=np.int64).reshape(-1, 12)
        k, l, d, tf, step, nb, bt, pad, zero, pad_y, pad_s, x0 = A.T
        items = list(self.items.values())

        def per_item(values):
            return np.array(values, np.int64)[k]

        T, B, L = (per_item([li.it.T for li in items]),
                   per_item([li.it.B for li in items]),
                   per_item([li.it.L for li in items]))
        dirs = per_item([li.dirs for li in items])
        ycat = np.array([y for li in items for y in li.y], np.int64)
        yfirst = per_item(np.cumsum([0] + [li.it.L for li in items])[:-1])
        y_out = ycat[yfirst + l]
        y_in = ycat[yfirst + np.maximum(l - 1, 0)] // dirs
        pools = [self.pools[li.pool] for li in items]
        y_sink = per_item([p.y_zero + 2 for p in pools])
        s_zero = per_item([p.s_zero for p in pools])
        cell = pad == 0
        one, nil = np.ones_like(nb), np.zeros_like(nb)
        # sources: layer 0's products, a row per (frame, direction); a
        # deeper layer's, a row per frame of the layer below's output
        xb = per_item([li.x0 for li in items]) + tf * dirs + d
        gather = _expand(
            np.where(cell, np.where(x0 == 1, xb, y_in + tf), zero),
            np.where(cell, np.where(x0 == 1, T * dirs, T), 0),
            np.where(cell, np.where(x0 == 1, step * dirs, step), 0), nb, bt)
        out = _expand(np.where(cell, y_out + tf * dirs + d, y_sink + pad_y),
                      np.where(cell, T * dirs, bt),
                      np.where(cell, step * dirs, 1), nb, bt)
        srow = per_item([li.s for li in items]) + (d * L + l) * B
        sread = _expand(np.where(cell, srow, s_zero), cell * one, nil, nb,
                        one)
        swrite = _expand(np.where(cell, srow, s_zero + 1 + pad_s), one, nil,
                         nb, one)
        # a slot with padding rows: the rows it writes, and the valid rows
        # among its launch's G·B state rows (their uids for every slot)
        padded = np.array([so.b_valid is not None for so in metas])
        swrite = swrite[np.repeat(padded, [so.G * so.B for so in metas])]
        first = np.cumsum([0] + [so.G * so.B for so in metas])[:-1]
        at = np.cumsum(nb) - nb - np.repeat(first, [so.nseg for so in metas])
        keep = cell & np.repeat(padded, [so.nseg for so in metas])
        vpos = _expand(at[keep], one[keep], nil[keep], nb[keep], one[keep])
        vuid = np.repeat(per_item([li.it.uid for li in items])[cell],
                         nb[cell])
        takes = [t for so in metas for t in [so.u] + [c.w for c in so.classes]
                 if t is not None and t.views is None]
        pads = [so for so in metas if so.b_valid is not None]
        sizes = ([c.g * so.B * so.bt for so in metas for c in so.classes]
                 + [so.G * so.B * so.bt for so in metas]
                 + [so.G * so.B for so in metas]
                 + [so.G * so.B for so in pads] + [so.nvalid for so in pads]
                 + [len(t.idx) for t in takes])
        views, nbytes = _upload(
            [gather, out, sread, swrite, vpos]
            + [np.asarray(t.idx, np.int64) for t in takes], np.int64,
            self.device, sizes)
        self.nbytes += nbytes
        views = iter(views)
        for so in metas:
            for c in so.classes:
                c.gidx = next(views)
        for so in metas:
            so.oidx = next(views)
        for so in metas:
            so.sread = so.swrite = next(views)
            so.vpos = None
        for name in ("swrite", "vpos"):
            for so in pads:
                setattr(so, name, next(views))
        for t in takes:
            t.idx = next(views)
        v0 = 0
        for so in metas:
            so.vuid = vuid[v0:v0 + so.nvalid]
            v0 += so.nvalid
        bv = [so for so in metas if so.b_valid is not None]
        if bv:
            views = _upload([np.concatenate([so.b_valid for so in bv])],
                            np.int32, self.device, [so.G for so in bv])[0]
            for so, v in zip(bv, views):
                so.b_valid = v


def _lane_count(device, seq) -> int:
    """How many lanes a plan's sequence slots issue on: on the card, as
    many of the plan's smallest launch as its SMs hold at once (a launch
    takes a cluster of S CTAs a recurrence and ``_SEQ_ROWS`` rows);
    elsewhere one, the current stream."""
    if device.type != "cuda":
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ctas = min(s.g * cdiv(s.B, _SEQ_ROWS)
               * seq_splits(s.H, GATES[s.family], 2, s.H) for s in seq)
    return max(1, sms // ctas)


def _plan_operands(plan: DispatchPlan, params, inputs, cache: dict,
                   owned: bool) -> _PlanOperands:
    """The plan's operands on its items' device: from the cache when the
    same plan ran there with the same stacks bound, else built (and kept,
    in a caller-owned cache, up to ``PLAN_OPERAND_BYTES``)."""
    seq_uid = next(c.uid for s in plan.slots if not s.chained
                   for c in s.cells)
    x = inputs[seq_uid]
    device = x.device
    key = (id(plan), str(device))
    plans = cache.setdefault(_PLANS, OrderedDict())
    ops = plans.get(key)
    if (ops is not None and ops.plan is plan
            and ops.stacks == tuple(id(params[u]) for u in ops.uids)):
        plans.move_to_end(key)
        return ops
    ops = _PlanOperands(plan, params, device, cache)
    if owned:
        plans[key] = ops
        total = sum(o.nbytes for o in plans.values())
        while len(plans) > 1 and total > PLAN_OPERAND_BYTES:
            total -= plans.popitem(last=False)[1].nbytes
    return ops


class _Run:
    """One call's buffers (per pool: the layer-0 products, the layer
    outputs, the h and c rows) and its sequence slots, issued on the
    plan's lanes: on the card each lane is a stream of the caller's
    cache, which waits for the caller's stream's work before the first
    slot and which the caller's stream waits for after the last
    (``join``); elsewhere the one lane is the current stream."""

    def __init__(self, ops: _PlanOperands, inputs, init_state,
                 cache: dict):
        self.ops = ops
        self.lanes: list = [None]
        self.events: dict = {}
        self.bufs = []
        dev = ops.device
        for pool in ops.pools:
            H = pool.H
            y = torch.empty((pool.n_y, H), dtype=pool.dtype, device=dev)
            y[pool.y_zero:pool.y_zero + 2].zero_()
            h = torch.zeros((pool.n_s, H), dtype=pool.dtype, device=dev)
            c = (torch.zeros((pool.n_s, H), dtype=torch.float32,
                             device=dev) if pool.has_c else None)
            for li in pool.items:
                st0 = (init_state or {}).get(li.it.uid)
                if st0 is None:
                    continue
                it = li.it
                n = it.L * it.B
                h[li.s:li.s + n].view(it.L, it.B, H).copy_(st0["h"])
                if "c" not in st0 or "lstm" not in it.families:
                    continue
                rows = c[li.s:li.s + n].view(it.L, it.B, H)
                if "gru" not in it.families:
                    rows.copy_(st0["c"])
                    continue
                for l, fam in enumerate(it.families):
                    if fam == "lstm":   # a gru layer's c rows stay zeros
                        rows[l].copy_(st0["c"][l])
            src = {("y", 1): y, ("y", 2): y.view(-1, 2 * H)}
            for (family, dt), x0 in pool.x0.items():
                gH = GATES[family] * H
                buf = torch.empty((x0["rows"] + 1, gH), dtype=dt,
                                  device=dev)
                buf[x0["zero"]].zero_()
                for seg in x0["segs"].values():
                    n, X = PRODUCT_ENTRIES * seg["entry"], seg["X"]
                    xs = [inputs[li.it.uid].reshape(-1, X)
                          for li in seg["items"]]
                    xs.append(xs[0].new_zeros((n - seg["frames"], X)))
                    x = torch.cat(xs).to(dt).view(PRODUCT_ENTRIES, -1, X)
                    part = buf[seg["row0"]:seg["row0"] + n * seg["dirs"]]
                    part = part.view(PRODUCT_ENTRIES, seg["entry"], -1)
                    W, b = seg["w"]
                    torch.bmm(x, W.expand(PRODUCT_ENTRIES, -1, -1),
                              out=part)
                    part.add_(b)
                src[("x0", family, dt)] = buf
            self.bufs.append((src, y, h, c))
        if ops.n_lanes > 1:
            pool = cache.setdefault(("lanes", str(dev)), [])
            while len(pool) < ops.n_lanes:
                pool.append(torch.cuda.Stream(device=dev))
            self.lanes = pool[:ops.n_lanes]
            main = torch.cuda.current_stream(dev)
            for lane in self.lanes:
                lane.wait_stream(main)

    def join(self) -> None:
        """The caller's stream waits for every lane's work."""
        if self.lanes[0] is not None:
            main = torch.cuda.current_stream(self.ops.device)
            for lane in self.lanes:
                main.wait_stream(lane)

    def slot(self, slot, **guard) -> None:
        so = self.ops.slots[slot.index]
        lane = self.lanes[so.lane]
        for p in so.waits:
            lane.wait_event(self.events[p])
        with (contextlib.nullcontext() if lane is None
              else torch.cuda.stream(lane)):
            self._slot(slot, so, **guard)
            if so.signal:
                self.events[slot.index] = lane.record_event()

    def _slot(self, slot, so, *, on_fault, check_finite, inject, report,
              tracer) -> None:
        src, y, h, c = self.bufs[so.pool]
        with tracer.span("hoist", slot=slot.index, cells=so.cells,
                         gemms=so.gemms):
            parts = []
            for cl in so.classes:
                x = src[cl.source].index_select(0, cl.gidx)
                if cl.w is not None:
                    W, b = cl.w.get()
                    x = x.view(cl.g, cl.rows, cl.X).to(cl.dt)
                    if cl.pad is not None:
                        x = torch.constant_pad_nd(x, cl.pad)
                        W = W.expand(x.shape[0], -1, -1)
                    x = torch.bmm(x, W).add_(b)
                    if cl.pad is not None:
                        x = x[:cl.g, :cl.rows].contiguous()
                parts.append(x)
            xw = (parts[0] if len(parts) == 1 else
                  torch.cat([p.view(-1, so.gates * so.H) for p in parts]))
            xw = xw.view(so.G, so.B, so.bt, so.gates, so.H)
            U, u_scales, u_rows = so.u.get()
            h0 = h.index_select(0, so.sread).view(so.G, so.B, so.H)
            c0 = (c.index_select(0, so.sread).view(so.G, so.B, so.H)
                  if so.lstm else None)
        sig = slot.signature() if tracer.enabled else ""
        with tracer.span("slot_launch", slot=slot.index, sig=sig,
                         uids=so.uids):
            out, h_n, c_n = _guarded_launch(
                slot.index, so.uids,
                _seq_ladder(slot, U, xw, h0, c0, so.b_valid,
                            u_scales=u_scales, u_rows=u_rows),
                on_fault=on_fault, inject=inject, report=report,
                tracer=tracer)
        h_n = h_n.reshape(-1, so.H)
        c_n = None if c_n is None else c_n.reshape(-1, so.H)
        y.index_copy_(0, so.oidx, out.reshape(-1, so.H))
        h.index_copy_(0, so.swrite, h_n)
        if c_n is not None:
            c.index_copy_(0, so.swrite, c_n)
        if check_finite:
            if so.vpos is not None:
                h_n = h_n.index_select(0, so.vpos)
                c_n = None if c_n is None else c_n.index_select(0, so.vpos)
            bad = _nonfinite_uids(h_n, c_n, so.vuid)
            if bad:
                raise NonFiniteStateError(
                    f"non-finite recurrent state after slot {slot.index} "
                    f"(uids {bad})", uids=bad, slot=slot.index,
                    where="slot state")

    def collect(self, outputs, states) -> None:
        """Each item's top-layer output (one copy a pool, out of the
        buffers) and, with ``states``, its end-of-walk state rows."""
        for pool, (_, y, h, c) in zip(self.ops.pools, self.bufs):
            top = y[pool.top_lo:pool.top_hi].clone()
            for li in pool.items:
                it = li.it
                a = li.y[-1] - pool.top_lo
                outputs[it.uid] = top[a:a + it.B * it.T * li.dirs].view(
                    it.B, it.T, li.dirs * it.H)
                if states is None:
                    continue
                n = it.L * it.B

                def one(d, li=li, it=it, n=n):
                    s = li.s + d * n
                    st = {"h": h[s:s + n].view(it.L, it.B, it.H)}
                    if "lstm" in it.families:
                        st["c"] = c[s:s + n].view(it.L, it.B, it.H)
                    return st

                states[it.uid] = ({"fwd": one(0), "bwd": one(1)}
                                  if it.bidirectional else one(0))


def _nonfinite_uids(h_rows, c_rows, row_uids) -> List[int]:
    """The uids of the rows (2-D, a row each) of h and c that hold a
    non-finite value: one reduction, and the per-row one only when it
    finds one."""
    ok = torch.isfinite(h_rows).all()
    if c_rows is not None:
        ok = ok & torch.isfinite(c_rows).all()
    if bool(ok):
        return []
    fin = torch.isfinite(h_rows).all(dim=1)
    if c_rows is not None:
        fin &= torch.isfinite(c_rows).all(dim=1)
    return sorted({int(u) for u in np.asarray(row_uids)[
        ~fin.cpu().numpy()]})


# ---------------------------------------------------------------------------
# guarded execution ladder
# ---------------------------------------------------------------------------


def _guarded_launch(slot_index: int, uids, ladder, *, on_fault: str,
                    inject: Optional[FaultInjector],
                    report: Optional[ExecutionReport],
                    tracer=NULL_TRACER):
    """Run one slot's launch down the guarded execution ladder.

    ``ladder`` holds one thunk per rung, shallowest first, named by
    ``FALLBACK_LEVELS`` (two rungs on the card, three on the CPU).  Any
    exception a rung raises (including an injected one) is wrapped in a
    structured ``LaunchError``; under ``on_fault="fallback"`` the next
    rung is tried, a recovery at rung > 0 is recorded in ``report``, and
    a fault at the last rung is raised.  A ``KernelBuildError`` or a
    ``KernelLaunchRefused`` is re-raised from any rung: a kernel that does
    not compile, or whose launch configuration the card refuses, is a
    broken checkout or card, not a fault another rung may hide."""
    cause = None
    last = len(ladder) - 1
    for level, attempt in enumerate(ladder):
        try:
            if inject is not None:
                inject.maybe_fail(slot_index, level, uids, last_level=last)
            if level == 0:
                result = attempt()
            else:
                # recovery rungs get their own nested span so a trace shows
                # exactly where a launch's time went when it degraded
                with tracer.span("fallback_rung", slot=slot_index,
                                 rung=FALLBACK_LEVELS[level]):
                    result = attempt()
        except (KernelBuildError, KernelLaunchRefused):
            raise
        except Exception as err:  # noqa: BLE001 — the ladder IS the boundary
            fault = err if isinstance(err, LaunchError) else LaunchError(
                f"launch failed: slot {slot_index} at ladder level "
                f"{FALLBACK_LEVELS[level]!r} "
                f"(uids {sorted(set(uids))}): {err!r}",
                uids=uids, slot=slot_index, level=FALLBACK_LEVELS[level])
            if tracer.enabled:
                tracer.instant("launch_fault", slot=slot_index,
                               rung=FALLBACK_LEVELS[level],
                               error=type(err).__name__)
            if on_fault != "fallback" or level == last:
                raise fault from err
            cause = fault
            continue
        if level > 0 and report is not None:
            report.record(slot_index, level, cause)
        return result
    raise LaunchError(
        f"guarded ladder for slot {slot_index} exhausted every rung "
        "without returning or raising — executor invariant broken",
        uids=uids, slot=slot_index, level=FALLBACK_LEVELS[last])


def _on_card(t) -> bool:
    """True when the slot's tensors lie on a CUDA device."""
    return t.device.type == "cuda"


def _rungs(on_card: bool, kernel_rungs, reference):
    """A ladder for one slot: the kernel rungs, plus the plain reference
    rung only off the card.  On the CPU every rung is plain PyTorch
    anyway; on the card a plain rung would serve at plain speed behind a
    fault, so the ladder ends at the last kernel rung and raises."""
    return list(kernel_rungs) + ([] if on_card else [reference])


def _seq_ladder(slot, U, xw, h0, c0, b_valid, *, u_scales=None,
                u_rows=None):
    """The launch strategies for a packed sequence slot, shallowest first:
    the planned fused launch; per-step — the same kernel at block_t=1, one
    launch per timestep; and, on the CPU only, the plain reference.  All
    consume the identical pre-hoisted ``xw`` (bwd cells' rows gathered in
    walk order), so the scatter after the launch is rung-agnostic.
    Quantized / row-compacted slots pass their operands down the kernel
    rungs unchanged; the reference rung dequantizes and expands them back
    to the dense matrix (value-identical to what the kernel computes with,
    see ``kernels.quant``).

    What per-step can recover on the card: it relaunches the same kernel
    template with the same shared memory and grid, so a deterministic
    launch error (shared memory past 227 KB, a grid too large) recurs
    there and is raised.  It recovers only a fault confined to one launch
    (an injected one, or a transient error that leaves the context
    usable); if the card never shows such a fault, a later slice may drop
    this rung."""

    lstm = slot.family == "lstm"

    def launch(xw_, h, c, block_t):
        # (hs, h_T, c_T | None) from the slot family's sequence kernel
        kw = dict(b_valid=b_valid, u_scales=u_scales, u_rows=u_rows,
                  block_t=block_t)
        if lstm:
            return lstm_seq(U, xw_, h, c, **kw)
        return gru_seq(U, xw_, h, **kw) + (None,)

    def fused():
        return launch(xw, h0, c0, slot.chunk_len)

    def per_step():
        outs, h, c = [], h0, c0
        for t in range(slot.chunk_len):
            o, h, c = launch(xw[:, :, t:t + 1], h, c, 1)
            outs.append(o)
        return torch.cat(outs, dim=2), h, c

    def reference():
        Ud = U
        if u_scales is not None:  # dequantize the int8 payload
            Ud = Ud.float() * u_scales[:, None, :, None]
        if u_rows is not None:    # scatter compacted rows back to dense
            Ud = torch.stack([expand_rows(Ud[g], u_rows[g], slot.H)
                              for g in range(Ud.shape[0])])
        if lstm:
            return lstm_seq_ref(Ud, xw, h0, c0)
        return gru_seq_ref(Ud, xw, h0) + (None,)

    return _rungs(_on_card(xw), [fused, per_step], reference)




def prepare_decode_stack(stack_params: dict, family: str,
                         precision: str = "fp32") -> dict:
    """Stack a parameter stack of one ``family`` ("lstm" or "gru") into
    the decode kernels' (L, ...) weight layout: {"Ws", "bs", "Us"}.
    Steady-state callers (the serving engine) compute this ONCE per stack
    and pass it to ``execute(prepared=...)``.

    Ws[0] is a zero placeholder when layer 0's input width differs from H;
    the kernel never reads it (layer 0's input half arrives pre-hoisted).

    ``precision`` != "fp32" round-trips each layer's recurrent matrix
    through the precision's fake-quant (``kernels.quant.fake_quant_stack``,
    U only) before stacking: decode ticks run the dense decode kernels on
    the dequantized values, so a quantized stack's decode matches its
    dequantized oracle; the int8 error budget is spent only in the
    sequence kernels' scaled dot.
    """
    gates = GATES[family]
    if precision != "fp32":
        stack_params = fake_quant_stack(stack_params, precision)
    stack = stack_params["layers"]
    H = stack[0]["U"].shape[0]
    L = len(stack)
    W0 = stack[0]["W"]
    W0 = (W0.reshape(H, gates, H) if W0.shape[0] == H else
          W0.new_zeros((H, gates, H)))
    return {
        "Ws": torch.stack([W0] + [stack[l]["W"].reshape(H, gates, H)
                                  for l in range(1, L)]),
        "bs": torch.stack([stack[l]["b"].reshape(gates, H)
                           for l in range(L)]),
        "Us": torch.stack([stack[l]["U"].reshape(H, gates, H)
                           for l in range(L)]),
    }



def _run_chained_slot(slot, plan, params, inputs, init_state, prepared,
                      cache: dict, outputs, states, *,
                      on_fault: str = "raise",
                      check_finite: bool = False,
                      inject: Optional[FaultInjector] = None,
                      report: Optional[ExecutionReport] = None,
                      tracer=NULL_TRACER):
    """Execute a chained decode slot: ONE launch for a whole T=1 tick.

    The slot's groups are the L serially dependent layer cells, each the
    B-concatenation of the tick's parameter-sharing items; the decode
    kernel walks the layers inside the launch.  Layer 0's input GEMM is
    hoisted here (it exists before launch; ``_hoist``, W and b cast once
    a stack); deeper layers' input GEMMs run in-kernel off the chain.
    One item (every tick of the serving engine) launches on its
    ``init_state`` tensors as they are and gets ``h_n`` / ``c_n`` back as
    its state, ``h_n[L-1]`` as its frame; several items concatenate on B.
    Runs behind the same guarded ladder as sequence slots — the per_step
    rung here is per-*layer*: L separate T=1 sequence-kernel launches
    chaining the inter-layer value on the host.
    """
    gates = GATES[slot.family]
    rows = slot.groups[0]           # request row order, fixed across layers
    lead = rows[0].uid
    stack = params[lead]
    L = len(slot.groups)
    lstm = slot.family == "lstm"
    items = {ip.uid: ip.item for ip in plan.items}
    with tracer.span("hoist", slot=slot.index, cells=len(slot.cells),
                     gemms=1):
        xs = [inputs[c.uid] for c in rows]
        x = xs[0] if len(xs) == 1 else torch.cat(xs)
        xw0 = _hoist(_layer0(cache, stack, x.dtype), x, gates)[:, 0]
        prep = ((prepared or {}).get(lead)
                or _memo(cache, ("decode", id(stack), slot.family,
                                 slot.precision), stack,
                         lambda: prepare_decode_stack(
                             stack, slot.family, precision=slot.precision)))
        hs, cs = [], []
        for cell in rows:
            it = items[cell.uid]
            st0 = (init_state or {}).get(cell.uid)
            hs.append(st0["h"] if st0 is not None else
                      x.new_zeros((L, it.B, it.H)))
            if lstm:
                cs.append(st0["c"] if st0 is not None and "c" in st0 else
                          torch.zeros((L, it.B, it.H), dtype=torch.float32,
                                      device=x.device))
        h0 = hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)
        c0 = (cs[0] if len(cs) == 1 else torch.cat(cs, dim=1)) if lstm \
            else None
        if h0.shape[1] < slot.B:    # rows past the items' are zeros
            pad = slot.B - h0.shape[1]
            xw0 = torch.cat([xw0, xw0.new_zeros((pad,) + xw0.shape[1:])])
            h0 = torch.cat([h0, h0.new_zeros((L, pad, slot.H))], dim=1)
            if lstm:
                c0 = torch.cat([c0, c0.new_zeros((L, pad, slot.H))], dim=1)
    uids = sorted({c.uid for c in rows})
    sig = slot.signature() if tracer.enabled else ""
    with tracer.span("slot_launch", slot=slot.index, sig=sig,
                     uids=uids):
        h_n, c_n = _guarded_launch(
            slot.index, uids,
            _chained_ladder(slot.family, xw0, prep["Ws"], prep["bs"],
                            prep["Us"], h0, c0),
            on_fault=on_fault, inject=inject, report=report, tracer=tracer)

    if check_finite:
        B = h_n.shape[1]
        bad = _nonfinite_uids(
            h_n.transpose(0, 1).reshape(B, -1),
            None if c_n is None else c_n.transpose(0, 1).reshape(B, -1),
            [c.uid for c in rows for _ in range(items[c.uid].B)]
            + [-1] * (B - sum(items[c.uid].B for c in rows)))
        bad = [u for u in bad if u >= 0]
        if bad:
            raise NonFiniteStateError(
                f"non-finite recurrent state after chained slot "
                f"{slot.index} (uids {bad})", uids=bad, slot=slot.index,
                where="decode tick")
    off = 0
    for cell in rows:
        it = items[cell.uid]
        h, c = h_n, c_n
        if it.B != slot.B:
            h = h_n[:, off:off + it.B]
            c = None if c_n is None else c_n[:, off:off + it.B]
        off += it.B
        # layer L-1's new h IS the tick's output frame
        outputs[cell.uid] = h[L - 1][:, None].to(inputs[cell.uid].dtype)
        if states is not None:
            states[cell.uid] = {"h": h} if c is None else {"h": h, "c": c}


def _layer0(cache: dict, stack: dict, x_dtype: torch.dtype) -> dict:
    """Layer 0's parameters with W and b cast once to the dtype its input
    product takes for inputs of ``x_dtype`` (``_hoist`` then casts
    nothing)."""
    layer = stack["layers"][0]
    dt = _promote(x_dtype, layer["W"].dtype, layer["b"].dtype)
    return _memo(cache, ("layer0", id(stack), dt), stack, lambda: {
        "W": layer["W"].to(dt), "b": layer["b"].to(dt), "U": layer["U"]})


def _chained_ladder(family: str, xw0, Ws, bs, Us, h0, c0):
    """The launch strategies for a chained T=1 decode slot: the planned
    single decode-kernel launch; per-layer — L separate T=1
    sequence-kernel launches with the inter-layer value (and its input
    GEMM) chained on the host; and, on the CPU only, the plain reference
    cells walked the same way.  All return ((L,B,H) h_n, (L,B,H) c_n fp32
    or None for a gru stack).

    What per-layer can recover on the card: it runs the other kernel
    (the sequence kernel), so it absorbs a fault raised around the decode
    kernel's launch (an injected one).  Every error the decode kernel's C
    entry point returns is a launch configuration the card refused (its
    cluster, its shared memory, H past 2048); the wrapper raises it as
    ``KernelLaunchRefused``, which the ladder re-raises, so a tick never
    runs the chain's input GEMMs in plain PyTorch because a cluster could
    not form."""
    lstm = family == "lstm"
    L = h0.shape[0]

    def fused():
        if lstm:
            return lstm_decode(xw0, Ws, bs, Us, h0, c0)
        return gru_decode(xw0, Ws, bs, Us, h0), None

    def chain(step):
        # walk the layer chain on the host: layer l>0's input half is the
        # previous layer's fresh h through that layer's input GEMM, in the
        # dtype the reference's einsum promotes to
        hs, cs = [], []
        xw_t = xw0
        for l in range(L):
            if l:
                y = hs[-1]
                dt = torch.promote_types(y.dtype, Ws.dtype)
                xw_t = (torch.einsum("bh,hgj->bgj", y.to(dt), Ws[l].to(dt))
                        + bs[l].to(dt)).to(xw0.dtype)
            h, c = step(l, xw_t)
            hs.append(h)
            cs.append(c)
        return torch.stack(hs), (torch.stack(cs) if lstm else None)

    def per_layer(l, xw_t):
        if lstm:
            _, h, c = lstm_seq(Us[l][None], xw_t[None, :, None],
                               h0[l][None], c0[l][None], block_t=1)
            return h[0], c[0]
        _, h = gru_seq(Us[l][None], xw_t[None, :, None], h0[l][None],
                       block_t=1)
        return h[0], None

    def reference(l, xw_t):
        if lstm:
            return lstm_cell_ref(Us[l], xw_t, h0[l], c0[l])
        return gru_step_ref(Us[l], xw_t, h0[l]), None

    return _rungs(_on_card(h0), [fused, lambda: chain(per_layer)],
                  lambda: chain(reference))


# ---------------------------------------------------------------------------
# off the packed timeline: the schedule library
# ---------------------------------------------------------------------------


def kernel_refusal(params: dict, policy) -> Optional[str]:
    """Why the card would refuse the forward of the stack ``params`` under
    ``policy`` (an ``rnn.ExecutionPolicy``; its schedule is read), or
    None: the first kernel that forward may launch whose limit on H the
    stack's H passes.  What each schedule launches is this module's
    dispatch: the planned schedules ("auto", "wavefront", "fused") run the
    families' sequence kernels (under "auto" the planner may pick them at
    any T); "per_step" runs LSTM layers through ``lstm_cell`` (its h rows
    in a CTA's shared memory) and GRU layers in plain PyTorch
    (``_run_reference``), as the research schedules run every layer.  Each
    kernel's limit is its entry in ``kernels.common.MAX_H``, the table the
    card's device model reads too.  Reads shapes only."""
    schedule = policy.schedule
    if not params.get("layers") or schedule in REFERENCE_SCHEDULES:
        return None  # an empty stack is named by CompiledStack
    layer0 = params["layers"][0]
    H = int(layer0.get("fwd", layer0)["U"].shape[0])
    families = sorted(set(stack_families(params)))
    if schedule == "per_step":
        names = ["lstm_cell"] if "lstm" in families else []
    else:
        names = [f"{f}_seq" for f in families]
    for name in names:
        limit = MAX_H[name]
        if H > limit:
            return (f"{name} takes H <= {limit} on the card, and this "
                    f"stack's forward under schedule={schedule!r} launches "
                    f"it at H={H}")
    return None


def _run_reference(stack, xs, schedule, *, block_t: int = 0):
    """External (unpacked) execution of a stack through the schedule
    library — per-layer family aware (families inferred from the bound
    parameters by ``core.schedules.walk_stack``), with the bidirectional
    fwd/bwd split.

    ``fused`` is one sequence-kernel launch per layer (and per direction);
    ``per_step`` is one ``lstm_cell`` launch per (layer, step) for lstm
    layers.  Two paths run plain PyTorch on any device, because the
    reference runs no Pallas kernel there either: the research schedules
    (sequential/batch/intergate/unfolded, which ARE the oracle), and a gru
    layer under per_step ("gru has no per-step pallas kernel — pure-jnp
    unfolded scan, zero launches" in the reference planner and executor).
    Everywhere else the kernels launch on the card or raise."""
    from repro_torch.core import gru as gru_mod
    from repro_torch.core import schedules as sch
    from repro_torch.kernels.lstm_cell.ops import as_cell_kernel

    if schedule not in ("fused", "per_step"):
        # research schedules ARE the oracle: delegate, one dispatch table
        return sch.reference_stack(stack, xs, schedule)

    def one(family, layer, y):
        if schedule == "fused":
            fn = (sch.run_layer_fused if family == "lstm"
                  else gru_mod.run_layer_fused)
            return fn(layer, y, block_t=block_t)
        if family == "lstm":  # per_step: one cell-kernel launch per step
            return sch.run_layer_unfolded(layer, y,
                                          cell_kernel=as_cell_kernel())
        return gru_mod.run_layer_unfolded(layer, y)

    return sch.walk_stack(stack, xs, one)


def _run_stack_collect(item, stack, xs):
    """Unidirectional stack, layer by layer through the fused schedules
    (``return_state=True``), returning (outputs, exact t=T states) — the
    path when a caller needs state (serving prefill) for an unpacked item.
    Mixed stacks: gru layers contribute zero rows to "c" (present whenever
    any layer is an LSTM)."""
    from repro_torch.core import gru as gru_mod
    from repro_torch.core import schedules as sch

    y = xs
    any_lstm = "lstm" in item.families
    hs_f, cs_f = [], []
    for fam, layer in zip(item.families, stack["layers"]):
        if fam == "lstm":
            y, (h_n, c_n) = sch.run_layer_fused(layer, y, return_state=True)
            cs_f.append(c_n)
        else:
            y, h_n = gru_mod.run_layer_fused(layer, y, return_state=True)
            if any_lstm:
                cs_f.append(torch.zeros((xs.shape[0], item.H),
                                        dtype=torch.float32,
                                        device=xs.device))
        hs_f.append(h_n.to(xs.dtype))
    state = {"h": torch.stack(hs_f)}
    if cs_f:
        state["c"] = torch.stack(cs_f)
    return y, state


def _run_rglru(xs):
    """An rglru item: the recurrence core only (the block mixing around it
    belongs to the model), ONE ``rglru_scan`` launch.  ``xs`` is the
    (log_a, gx) pair of the item's hoisted gate inputs; the scan starts
    from zero state and returns hs.  Multi-layer rglru items are plan-only
    (``execute`` refuses them before any work)."""
    log_a, gx = xs
    B, T, W = gx.shape
    h0 = torch.zeros((B, W), dtype=gx.dtype, device=gx.device)
    hs, _ = rglru_scan(log_a, gx, h0)
    return hs
