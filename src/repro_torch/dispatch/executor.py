"""The dispatch executor: runs a DispatchPlan through the recurrent
kernels.

The port of ``repro.dispatch.executor``.  The packed slot timeline
executes in order; each ``Slot`` becomes exactly one G-batched
sequence-fused launch (``kernels.lstm_cell.lstm_seq`` or
``kernels.gru_cell.gru_seq``), with each cell's hoisted input GEMM issued
in the same slot.  Per-(item, layer, direction) recurrent state lives in
device tensors between slots and in shared memory within a launch; the
final chunk of every layer is launched at its true remainder length, so
the state left behind after the last slot is the exact t=T state — which
is what the serving engine splices into its decode slots.

Cross-B packing executes here too: a slot row may be several parameter-
sharing cells' batches concatenated (same U — the WorkItem.share
contract), and rows narrower than the slot's width are zero-padded and
masked in-kernel (``b_valid``) to exact no-ops.  ``chained`` slots (T=1
decode) run a whole tick's dependent layer chain in ONE ``lstm_decode`` /
``gru_decode`` launch.  A mixed lstm/gru stack's cells pack into
per-family slots of one timeline; its gru layers carry no cell state.

Bidirectional cells execute in the packed timeline: a "bwd" cell walks
its chunk in descending time — the executor feeds the sequence kernel the
time-reversed chunk slice and flips the produced stripe back into original
time order before storing it (pre-launch reversal; exact, remainder chunks
included).  Each direction carries its own recurrent state and its own
parameter half (layer["fwd"] / layer["bwd"]), and a deeper cell's input is
the chunk of the previous layer's fwd‖bwd feature concat.

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
its items' ``tile_map``): ``_slot_weights`` hoists each cell's U once per
plan — bf16 round-tripped, int8 quantized per gate (the payload plus
(G, gates) scales) and/or row-compacted to the slot's one active-row
width Ha (plus a (G, Ha) row index) — and every kernel rung receives the
same operands; the CPU reference rung dequantizes and expands them back to
dense.  Decode ticks run the dense decode kernels on the fake-quantized
weights (``prepare_decode_stack(precision=)``).

Items the planner routes off the packed timeline (the reference
schedules, per_step, T=0 items, and single-layer rglru items, which run
``kernels.rglru.rglru_scan`` on a ``(log_a, gx)`` input pair) run first,
one at a time (``_run_reference``, ``_run_stack_collect``,
``_run_rglru``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.core.perfmodel import MXU_ROWS
from repro_torch.core.schedules import stack_families
from repro_torch.dispatch.planner import (REFERENCE_SCHEDULES, DispatchPlan,
                                          ItemPlan)
from repro_torch.dispatch.workitem import GATES
from repro_torch.kernels.common import (MAX_H, KernelBuildError,
                                        KernelLaunchRefused, cdiv)
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
    dt = torch.promote_types(torch.promote_types(src.dtype, W.dtype),
                             b.dtype)
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
            quant_cache: Optional[dict] = None,
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
    external stateless schedule.

    ``init_state`` optionally seeds the recurrent state of packed items:
    init_state[uid] = {"h": (L,B,H)[, "c": (L,B,H)]} replaces the zero
    initial state (the serving engine's decode ticks resume from it).
    External items reject it (their schedule surfaces start from zeros),
    and so do bidirectional items: their two walks start from opposite
    sequence ends, so there is no mid-stream resume point.

    ``prepared`` optionally carries pre-stacked decode weights per uid
    (see ``prepare_decode_stack``) so steady-state decode ticks don't
    restack unchanged parameters every tick.

    ``quant_cache`` memoizes per-(item, layer, direction, precision, Ha)
    quantized / row-compacted recurrent-weight operands across slots (and
    across calls, when the caller owns the dict — ``CompiledStack`` keeps
    one for its lifetime).  None builds a per-call cache, so each layer is
    still transformed at most once per execute().  Only consulted for
    slots whose ``precision != "fp32"`` or whose items carry a tile_map.

    ``collect_state`` reroutes external unidirectional items through the
    per-layer fused path (``_run_stack_collect``) — the only surface that
    returns exact state — so for those items the plan's per_step/per_layer
    launch accounting describes the stateless execution, not this one.

    ``on_fault``/``check_finite``/``inject``/``report`` drive the guarded
    execution ladder (module doc).  ``tracer`` (optional
    ``runtime.obs.Tracer``): every slot gets a ``hoist`` span and a
    ``slot_launch`` span, each the host's time to issue its work; None
    binds the shared no-op tracer — no events, outputs bit-identical.
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

    outputs: Dict[int, torch.Tensor] = {}
    states: Dict[int, dict] = {}
    if quant_cache is None:
        quant_cache = {}  # per-call memo: each layer transforms at most once

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
    # live state is keyed (layer, direction): unidirectional items only
    # ever touch direction "fwd"; a bidirectional item's two walks carry
    # independent state and parameter halves
    live: Dict[int, dict] = {}
    for ip in plan.items:
        if ip.uid in plan.external:
            continue
        it = ip.item
        dirs = ("fwd", "bwd") if it.bidirectional else ("fwd",)
        x = inputs[it.uid]
        st0 = (init_state or {}).get(it.uid)
        if st0 is not None and it.bidirectional:
            raise ValueError(
                f"init_state given for bidirectional item {it.uid}: the "
                "fwd/bwd walks start from opposite sequence ends, so there "
                "is no mid-stream state to resume from")

        def _h0(l):
            if st0 is not None:
                return st0["h"][l]
            return torch.zeros((it.B, it.H), dtype=x.dtype, device=x.device)

        def _c0(l):
            # cell state exists per LSTM layer only; a mixed stack's gru
            # layers carry None (their slots never read or write c)
            if it.families[l] != "lstm":
                return None
            if st0 is not None and "c" in st0:
                return st0["c"][l]
            return torch.zeros((it.B, it.H), dtype=torch.float32,
                               device=x.device)

        live[it.uid] = {
            "plan": ip,
            "h": {(l, d): _h0(l) for l in range(it.L) for d in dirs},
            "c": ({(l, d): _c0(l) for l in range(it.L) for d in dirs}
                  if "lstm" in it.families else None),
            "outs": {(l, d): [None] * ip.nk
                     for l in range(it.L) for d in dirs},
        }

    for slot in plan.slots:
        if slot.chained:
            _run_chained_slot(slot, params, inputs, live,
                              prepared=prepared,
                              on_fault=on_fault, check_finite=check_finite,
                              inject=inject, report=report,
                              tracer=tracer)
            continue
        gates = GATES[slot.family]
        with tracer.span("hoist", slot=slot.index):
            xws, hs, cs = [], [], []
            for grp in slot.groups:
                xw_rows, h_rows, c_rows = [], [], []
                for cell in grp:
                    st = live[cell.uid]
                    layer = _cell_layer_params(params, st, cell)
                    src = _cell_src(inputs, st, cell, slot.chunk_len)
                    xw_rows.append(_hoist(layer, src, gates))
                    h_rows.append(st["h"][(cell.layer, cell.direction)])
                    if slot.family == "lstm":
                        c_rows.append(st["c"][(cell.layer, cell.direction)])
                # cross-B row: parameter-sharing cells concatenate on B
                # (same U by the share contract — take the lead cell's);
                # rows narrower than the slot's width pad with zeros,
                # masked in-kernel to exact no-ops
                xws.append(_cat_pad(xw_rows, slot.B))
                hs.append(_cat_pad(h_rows, slot.B))
                if slot.family == "lstm":
                    cs.append(_cat_pad(c_rows, slot.B))

            xw = torch.stack(xws)          # (G, B, bt, gates, H)
            U, u_scales, u_rows = _slot_weights(slot, params, live,
                                                quant_cache)
            h0 = torch.stack(hs)           # (G, B, H)
            c0 = torch.stack(cs) if slot.family == "lstm" else None
        b_valid = (list(slot.group_b)
                   if any(b < slot.B for b in slot.group_b) else None)
        uids = sorted({c.uid for grp in slot.groups for c in grp})
        sig = slot.signature() if tracer.enabled else ""
        with tracer.span("slot_launch", slot=slot.index, sig=sig,
                         uids=uids):
            out, h_n, c_n = _guarded_launch(
                slot.index, uids,
                _seq_ladder(slot, U, xw, h0, c0, b_valid,
                            u_scales=u_scales, u_rows=u_rows),
                on_fault=on_fault, inject=inject, report=report,
                tracer=tracer)

        bad: List[int] = []
        for g, grp in enumerate(slot.groups):
            off = 0
            for cell in grp:
                st = live[cell.uid]
                nb = st["plan"].item.B
                key = (cell.layer, cell.direction)
                st["h"][key] = h_n[g, off:off + nb].to(h0.dtype)
                if c_n is not None:
                    st["c"][key] = c_n[g, off:off + nb]
                if check_finite and not _rows_finite(
                        h_n[g, off:off + nb],
                        None if c_n is None else c_n[g, off:off + nb]):
                    bad.append(cell.uid)
                chunk = out[g, off:off + nb].to(inputs[cell.uid].dtype)
                if cell.direction == "bwd":
                    # the kernel walked the chunk in reversed time; store
                    # the stripe back in original time order
                    chunk = torch.flip(chunk, dims=[1])
                st["outs"][key][cell.chunk] = chunk
                off += nb
        if bad:
            bad = sorted(set(bad))
            raise NonFiniteStateError(
                f"non-finite recurrent state after slot {slot.index} "
                f"(uids {bad})", uids=bad, slot=slot.index,
                where="slot state")

    for uid, st in live.items():
        it = st["plan"].item
        top = torch.cat(st["outs"][(it.L - 1, "fwd")], dim=1)
        if it.bidirectional:
            bwd = torch.cat(st["outs"][(it.L - 1, "bwd")], dim=1)
            top = torch.cat([top, bwd], dim=-1)
        outputs[uid] = top
        if collect_state:
            if it.bidirectional:
                # per-direction state: fwd's walk ends at t=T, bwd's at
                # t=0 — two exact end-of-walk states, no single t=T one
                states[uid] = {d: _dir_state(st, it, d)
                               for d in ("fwd", "bwd")}
            else:
                states[uid] = _dir_state(st, it, "fwd")

    return (outputs, states) if collect_state else outputs


def _slot_weights(slot, params, live, cache: dict):
    """Stack one sequence slot's per-group recurrent-weight operands under
    the slot's precision and its items' block-sparsity tile maps.

    Returns ``(U, u_scales, u_rows)``: dense ``(G, H, gates, H)`` with None
    markers for a plain fp32 slot; bf16 round-trips the values (still fp32
    storage — exact); int8 swaps in the per-gate quantized payload plus
    ``u_scales (G, gates)``; a tile_map row-compacts to the slot's one
    active-row width ``Ha`` plus ``u_rows (G, Ha)``.  Groups without a
    tile_map in a sparse slot ride along dense (all-ones bitmap).
    Per-(item, layer, direction, precision, Ha) transforms memoize in
    ``cache``, so the chunk slots of one layer transform the weights ONCE
    per plan."""
    gates = GATES[slot.family]
    leads = [grp[0] for grp in slot.groups]
    quant = slot.precision == "int8"

    def _bitmap(cell):
        tm = live[cell.uid]["plan"].item.tile_map
        if tm is None:
            return (1,) * cdiv(slot.H, MXU_ROWS)
        return tm[cell.layer]

    sparse = any(live[c.uid]["plan"].item.tile_map is not None
                 for c in leads)
    Ha = 0
    if sparse:
        # one padded row count for the launch: the stacked (G, Ha) gather
        # index needs one Ha; padding rows are exact no-ops (kernels.quant)
        Ha = max(max(len(active_row_indices(_bitmap(c), slot.H))
                     for c in leads), 1)

    us, scales, rows = [], [], []
    for cell in leads:
        key = (cell.uid, cell.layer, cell.direction, slot.precision,
               Ha if sparse else -1)
        entry = cache.get(key)
        if entry is None:
            U = _cell_layer_params(params, live[cell.uid], cell)["U"] \
                .reshape(slot.H, gates, slot.H)
            if slot.precision == "bf16":
                U = bf16_roundtrip(U)
            s = None
            if quant:
                U, s = quantize_per_gate(U)
            r = None
            if sparse:
                U, r = compact_rows(U, _bitmap(cell), pad_to=Ha)
            entry = cache[key] = (U, s, r)
        us.append(entry[0])
        scales.append(entry[1])
        rows.append(entry[2])
    return (torch.stack(us),
            torch.stack(scales) if quant else None,
            torch.stack(rows) if sparse else None)


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
    consume the identical pre-hoisted ``xw`` (bwd cells arrive
    pre-flipped), so the scatter after the launch is rung-agnostic.
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


def _rows_finite(h_rows, c_rows=None) -> bool:
    """True when one cell's slice of post-launch state is all-finite."""
    ok = bool(torch.isfinite(h_rows).all())
    if ok and c_rows is not None:
        ok = bool(torch.isfinite(c_rows).all())
    return ok


def _dir_state(st, item, direction: str) -> dict:
    """Stack one direction's per-layer end-of-walk state into the
    documented {"h": (L,B,H)[, "c": (L,B,H)]} shape ("c" whenever any
    layer is an LSTM; a mixed stack's gru rows are fp32 zeros)."""
    out = {"h": torch.stack([st["h"][(l, direction)]
                             for l in range(item.L)])}
    if st["c"] is not None:
        zeros = torch.zeros((item.B, item.H), dtype=torch.float32,
                            device=out["h"].device)
        out["c"] = torch.stack(
            [zeros if st["c"][(l, direction)] is None
             else st["c"][(l, direction)] for l in range(item.L)])
    return out


def _cell_layer_params(params, st, cell):
    """The parameter dict one cell's launch row binds: the cell's layer,
    and for bidirectional items the cell's direction half."""
    layer = params[cell.uid]["layers"][cell.layer]
    if st["plan"].item.bidirectional:
        layer = layer[cell.direction]
    return layer


def _cell_src(inputs, st, cell, chunk_len: int):
    """One cell's input chunk, in the cell's own walk order.

    Layer 0 reads the item's input slice; deeper layers read the previous
    layer's just-produced chunk — for bidirectional items the fwd‖bwd
    feature concat (both stored in original time order).  "bwd" cells walk
    descending time: the chunk slice is flipped before the hoist."""
    ip: ItemPlan = st["plan"]
    it = ip.item
    if cell.layer == 0:
        t0 = cell.chunk * ip.block_t
        src = inputs[cell.uid][:, t0:t0 + chunk_len]
    elif it.bidirectional:
        src = torch.cat(
            [st["outs"][(cell.layer - 1, "fwd")][cell.chunk],
             st["outs"][(cell.layer - 1, "bwd")][cell.chunk]], dim=-1)
    else:
        src = st["outs"][(cell.layer - 1, "fwd")][cell.chunk]
    if cell.direction == "bwd":
        src = torch.flip(src, dims=[1])
    return src


def _cat_pad(rows, B: int):
    """Concatenate row tensors on the batch axis, zero-padding to width B
    (the padded rows are masked to exact no-ops in-kernel)."""
    cat = torch.cat(rows) if len(rows) > 1 else rows[0]
    if cat.shape[0] == B:
        return cat
    return torch.cat([cat, cat.new_zeros((B - cat.shape[0],)
                                         + tuple(cat.shape[1:]))])


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


def _run_chained_slot(slot, params, inputs, live, *, prepared=None,
                      on_fault: str = "raise",
                      check_finite: bool = False,
                      inject: Optional[FaultInjector] = None,
                      report: Optional[ExecutionReport] = None,
                      tracer=NULL_TRACER):
    """Execute a chained decode slot: ONE launch for a whole T=1 tick.

    The slot's groups are the L serially dependent layer cells, each the
    B-concatenation of the tick's parameter-sharing items; the decode
    kernel walks the layers inside the launch.  Layer 0's input GEMM is
    hoisted here (it exists before launch); deeper layers' input GEMMs
    run in-kernel off the chain.  Runs behind the same guarded ladder as
    sequence slots — the per_step rung here is per-*layer*: L separate
    T=1 sequence-kernel launches chaining the inter-layer value on the
    host.
    """
    gates = GATES[slot.family]
    row_cells = slot.groups[0]      # request row order, fixed across layers
    lead_uid = row_cells[0].uid
    stack = params[lead_uid]["layers"]
    L = len(slot.groups)

    with tracer.span("hoist", slot=slot.index):
        xw0 = _cat_pad([_hoist(stack[0], inputs[c.uid], gates)[:, 0]
                        for c in row_cells], slot.B)    # (B, gates, H)
        prep = ((prepared or {}).get(lead_uid)
                or prepare_decode_stack(params[lead_uid], slot.family,
                                        precision=slot.precision))
        Ws, bs, Us = prep["Ws"], prep["bs"], prep["Us"]
        h0 = torch.stack([_cat_pad([live[c.uid]["h"][(l, "fwd")]
                                    for c in row_cells], slot.B)
                          for l in range(L)])   # (L, B, H)
        c0 = None
        if slot.family == "lstm":
            c0 = torch.stack([_cat_pad([live[c.uid]["c"][(l, "fwd")]
                                        for c in row_cells], slot.B)
                              for l in range(L)])
    uids = sorted({c.uid for c in row_cells})
    sig = slot.signature() if tracer.enabled else ""
    with tracer.span("slot_launch", slot=slot.index, sig=sig,
                     uids=uids):
        h_n, c_n = _guarded_launch(
            slot.index, uids,
            _chained_ladder(slot.family, xw0, Ws, bs, Us, h0, c0),
            on_fault=on_fault, inject=inject, report=report, tracer=tracer)

    off = 0
    bad: List[int] = []
    for cell in row_cells:
        st = live[cell.uid]
        nb = st["plan"].item.B
        dtype = inputs[cell.uid].dtype
        if check_finite and not _rows_finite(
                h_n[:, off:off + nb],
                None if c_n is None else c_n[:, off:off + nb]):
            bad.append(cell.uid)
        for l in range(L):
            st["h"][(l, "fwd")] = h_n[l, off:off + nb].to(h0.dtype)
            if c_n is not None:
                st["c"][(l, "fwd")] = c_n[l, off:off + nb]
            # layer l's new h IS its T=1 output frame
            st["outs"][(l, "fwd")][0] = h_n[l, off:off + nb, None].to(dtype)
        off += nb
    if bad:
        bad = sorted(set(bad))
        raise NonFiniteStateError(
            f"non-finite recurrent state after chained slot {slot.index} "
            f"(uids {bad})", uids=bad, slot=slot.index, where="decode tick")


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
