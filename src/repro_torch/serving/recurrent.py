"""Recurrent-stack serving: session management over the unified front-end.

The port of ``repro.serving.recurrent``, with the same semantics.  The
engine runs on ``device`` ("cuda" by default — the hand-written
``lstm_seq`` / ``lstm_decode`` kernels, or ``gru_seq`` / ``gru_decode``
for ``rnn_family="gru"``; "cpu" for their plain versions) and keeps its
batched decode state there in fp32: (h, c) for an LSTM stack, h alone
for a GRU stack (``self.c`` is None).

A transformer engine admits requests one prefill at a time; recurrent stacks can do strictly better, because *prefill itself is a
recurrence* — an (L layers x T steps) dependency grid.  This engine admits
every free slot's request in one wave and hands the batch to ONE
``repro_torch.rnn.CompiledStack.prefill`` call: the requests' (layer, time-chunk)
cells share wavefront slots, so G-batched sequence-kernel launches hide the
per-request serial dependencies behind each other (ROADMAP item "Wavefront
in serving").  The compiled stack leaves behind each request's exact t=T
per-layer (h, c), which splices into the engine's batched decode state
the way a transformer engine splices KV-cache rows.

Decode is planned, not hand-rolled: one tick = one ``CompiledStack.decode``
call over the *active* slots only — their T=1 layer chains B-concatenate
into a single chained slot, ONE kernel launch per tick instead of L, with
each new top-layer output frame fed back as the next step's input (requires
X == H, which the paper's stacks satisfy).  Ticks in steady state reuse the
compiled stack's cached decode plans instead of replanning — the Zhao et
al. steady-state serving story (PAPERS.md).  Requests are *frame* streams,
not token streams — the serving analogue of an RNN acoustic/regression
service (cf. the MASR-style per-shape serving story, PAPERS.md).

The engine is ONLY the session layer — admission, slot pool,
state splicing, retirement.  It holds no planner/executor calls of its
own: serving, batch, and single-call users all exercise the identical
planned pipeline and plan caching through ``CompiledStack``.

Fault isolation: requests share packed launches, never failure
domains.  Every completion carries ``status`` ("ok" | "failed" |
"timeout") plus error detail, and the engine quarantines per request:

  * a non-finite prompt is rejected at ``submit`` (structured
    ``NonFiniteStateError`` naming the uid) before it can poison a slot;
  * a launch fault inside a packed prefill wave (surfaced as the guarded
    ladder's ``LaunchError``) bisects the wave — each request re-admits
    solo, so exactly the faulty one fails and the co-batched ones proceed
    bit-identically (packed rows are independent by the cross-B masking
    contract);
  * a non-finite spliced prefill state or decode frame fails ONLY the
    offending request's slot — the row check runs per request, the slot
    frees, co-batched rows keep their (independent) values;
  * admission is bounded (``max_queue`` + ``backpressure``: "reject"
    raises ``QueueFull``, "drop_oldest" evicts the queue head as a
    ``status="failed"`` completion — no request is ever silently lost);
  * deadlines retire: per-request ``max_ticks`` (decode ticks) and
    ``deadline_s`` (wall time from admission) produce ``status="timeout"``
    completions carrying the frames generated so far, and
    ``run_to_completion`` raises ``RequestTimeout`` carrying ``.done``
    so an engine-level overrun never loses finished work;
  * a ``runtime.ft.StragglerWatchdog`` (an EWMA detector) optionally
    flags slow decode ticks in ``straggler_ticks``.

A decode-tick ``LaunchError`` that survives the whole guarded ladder is
re-raised (both on_fault modes): the tick is one chained launch over all
active rows, and a fault that the whole ladder cannot absorb has no
per-request attribution to quarantine on.

Fault-injection hooks: ``fail_prefill_of`` (uids whose admission wave's launch raises, through
the full ladder) and ``poison_slot_at`` (uid -> decode tick whose state
turns NaN; -1 poisons the spliced prefill state) make every quarantine
path provable in CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.analysis.plancheck import check_decode_tick
from repro_torch.configs.base import ModelConfig
from repro_torch.dispatch.planner import DispatchPlan
from repro_torch.rnn import (CompiledStack, ExecutionPolicy,
                             compile as rnn_compile)
from repro_torch.runtime import obs
from repro_torch.runtime.errors import (LaunchError, NonFiniteStateError,
                                        PlanRejected, QueueFull,
                                        RequestTimeout)
from repro_torch.runtime.ft import StragglerWatchdog

#: completion statuses: "ok" = ran to its frame budget; "failed" = faulted
#: (launch fault, poisoned state, backpressure eviction) and quarantined;
#: "timeout" = a per-request deadline retired it mid-flight.
STATUSES = ("ok", "failed", "timeout")

#: bounded-admission policies: "reject" raises QueueFull at the submit
#: call; "drop_oldest" evicts the queue head as a failed completion.
BACKPRESSURE = ("reject", "drop_oldest")


@dataclasses.dataclass
class RecurrentRequest:
    uid: int
    frames: np.ndarray          # (T, X) prompt feature frames
    max_new_frames: int = 0     # autoregressive continuation steps
    priority: int = 0
    max_ticks: Optional[int] = None     # decode-tick deadline (per request)
    deadline_s: Optional[float] = None  # wall-time budget from admission


@dataclasses.dataclass
class RecurrentCompletion:
    uid: int
    prompt_len: int
    outputs: np.ndarray         # (T, H) top-layer prefill outputs
    generated: np.ndarray       # (n, H) fed-back continuation (n may be
                                # short of max_new_frames when status != ok)
    status: str = "ok"          # one of STATUSES
    error: Optional[str] = None  # fault detail when status != "ok"


class RecurrentServingEngine:
    """Continuous batching over a fixed slot pool, recurrent edition.

    ``cost_model`` / ``cost_table`` pass through to the compiled stack's
    ``ExecutionPolicy`` (``"measured"`` plans every wave and tick against
    the device's calibration table, ``repro_torch.calib``)."""

    def __init__(self, cfg: ModelConfig, stack_params, max_batch: int = 4,
                 macs: int = 16384, rnn_family: str = "lstm", *,
                 on_fault: str = "fallback",
                 max_queue: Optional[int] = None,
                 backpressure: str = "reject",
                 watchdog_factor: Optional[float] = None,
                 watchdog_alpha: float = 0.3,
                 trace: bool = False, device="cuda",
                 cost_model: str = "analytic",
                 cost_table: Optional[str] = None):
        if cfg.family != "rnn":
            raise PlanRejected(
                f"recurrent engine serves rnn stacks, got config "
                f"{cfg.name!r} (family {cfg.family!r})")
        if cfg.bidirectional:
            raise PlanRejected(
                "bidirectional stacks have no streaming decode — serve "
                "whole sequences through CompiledStack.forward instead")
        if rnn_family not in ("lstm", "gru"):
            raise PlanRejected(f"rnn_family={rnn_family!r} invalid; "
                               "allowed: lstm, gru")
        if backpressure not in BACKPRESSURE:
            raise ValueError(f"backpressure={backpressure!r} invalid; "
                             f"allowed: {', '.join(BACKPRESSURE)}")
        self.cfg = cfg
        self.family = rnn_family
        self.max_batch = max_batch
        L, H = cfg.n_layers, cfg.lstm_hidden
        self.L, self.H = L, H

        # the planned execution path: every prefill wave and decode tick
        # goes through this one CompiledStack (shared plan cache included);
        # the engine defaults to on_fault="fallback" — a serving process
        # wants the guarded ladder, library callers keep fail-fast
        self.on_fault = on_fault
        self.compiled: CompiledStack = rnn_compile(
            stack_params, ExecutionPolicy(macs=macs, on_fault=on_fault,
                                          trace=trace, cost_model=cost_model,
                                          cost_table=cost_table),
            device=device)
        self.device = self.compiled.device
        #: the compiled stack's tracer (runtime.obs) — the engine folds its
        #: serving spans (each step and its pieces, admit and splice spans,
        #: per-request admit->retire spans on the "requests" track,
        #: watchdog instants) into the SAME trace the executor's launch
        #: spans land in; the shared no-op tracer when ``trace=False``
        self.tracer = self.compiled.tracer
        if self.compiled.families != (rnn_family,) * L:
            raise PlanRejected(
                f"stack families {self.compiled.families} do not match "
                f"rnn_family={rnn_family!r} x {L} layers")

        # batched recurrent state: one column per slot (the recurrent
        # analogue of the transformer engine's batch cache)
        dev = self.device
        self.h = torch.zeros((L, max_batch, H), dtype=torch.float32,
                             device=dev)
        # cell state exists for LSTM stacks only; a GRU engine keeps h
        self.c = (torch.zeros((L, max_batch, H), dtype=torch.float32,
                              device=dev) if rnn_family == "lstm" else None)
        self.last_y = torch.zeros((max_batch, 1, H), dtype=torch.float32,
                                  device=dev)

        self.queue: List[RecurrentRequest] = []
        self.max_queue = max_queue
        self.backpressure = backpressure
        self.slots: List[Optional[RecurrentRequest]] = [None] * max_batch
        self.prefill_out: List[Optional[np.ndarray]] = [None] * max_batch
        self.generated: List[List[np.ndarray]] = [[] for _ in range(max_batch)]
        self.slot_ticks: List[int] = [0] * max_batch
        self.admitted_at: List[Optional[float]] = [None] * max_batch
        # per-slot admission timestamps on the TRACER clock (µs), so
        # retirement can file the retroactive request span
        self._admit_us: List[Optional[float]] = [None] * max_batch
        self.done: List[RecurrentCompletion] = []
        self.steps = 0
        # dispatch accounting (inspected by tests/benchmarks); plan-cache
        # counters live on compiled.stats — see the properties below
        self.prefill_waves = 0
        self.packed_launches = 0
        self.naive_launches = 0
        self.last_plan: Optional[DispatchPlan] = None
        self.decode_ticks = 0
        self.decode_launches = 0
        self.last_decode_plan: Optional[DispatchPlan] = None
        # fault accounting + optional straggler detection
        self.quarantined = 0         # requests failed/evicted in isolation
        self.prefill_retries = 0     # solo re-admissions after a wave fault
        self.dropped = 0             # backpressure evictions
        self.watchdog = (StragglerWatchdog(watchdog_factor, watchdog_alpha)
                         if watchdog_factor is not None else None)
        self.straggler_ticks: List[int] = []
        # fault-injection hooks:
        # uids whose admission wave's launch raises through the full ladder
        self.fail_prefill_of: Set[int] = set()
        # uid -> decode tick whose pre-tick state turns NaN (-1 = poison
        # the spliced prefill state instead)
        self.poison_slot_at: Dict[int, int] = {}

    @property
    def decode_plans_built(self) -> int:
        """Decode plans constructed (cache misses in the compiled stack):
        stays flat across steady-state ticks while decode_ticks grows."""
        return self.compiled.stats.decode_plans_built

    # ------------------------------------------------------------------
    def submit(self, req: RecurrentRequest):
        frames = np.asarray(req.frames)
        if frames.ndim != 2 or frames.shape[0] == 0:
            raise PlanRejected(f"request {req.uid}: prompt must be (T>0, X)",
                               uids=(req.uid,))
        if frames.shape[1] != self.cfg.lstm_input:
            raise PlanRejected(
                f"request {req.uid}: X={frames.shape[1]} != "
                f"lstm_input={self.cfg.lstm_input}", uids=(req.uid,))
        if req.max_new_frames > 0 and self.cfg.lstm_input != self.H:
            raise PlanRejected("feedback decode requires lstm_input == "
                               "hidden", uids=(req.uid,))
        if not np.isfinite(frames).all():
            # reject at the door: an admitted NaN frame propagates through
            # the prompt recurrence and poisons the slot's spliced state
            raise NonFiniteStateError(
                f"request {req.uid}: prompt frames contain NaN/Inf — "
                "rejected at submit", uids=(req.uid,), where="prompt")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.backpressure == "reject":
                raise QueueFull(
                    f"admission queue at capacity ({self.max_queue}); "
                    f"request {req.uid} rejected", uids=(req.uid,))
            evicted = self.queue.pop(0)  # drop_oldest: head is stalest
            self.dropped += 1
            self.quarantined += 1
            self.done.append(RecurrentCompletion(
                uid=evicted.uid, prompt_len=len(evicted.frames),
                outputs=np.zeros((0, self.H), np.float32),
                generated=np.zeros((0, self.H), np.float32),
                status="failed",
                error=f"evicted by backpressure='drop_oldest' "
                      f"(queue bound {self.max_queue})"))
        self.queue.append(req)

    # ------------------------------------------------------------------
    def _admit(self):
        """One admission wave -> one packed CompiledStack.prefill over ALL
        newly admitted prompts (the requests' cells share one
        DispatchPlan's wavefront slots and cross-B rows)."""
        pairs = []
        for slot in range(self.max_batch):
            if self.slots[slot] is None and self.queue:
                pairs.append((slot, self.queue.pop(0)))
        if not pairs:  # queue drained mid-tick: nothing to dispatch
            return
        self._prefill_wave(pairs)
        self._retire()  # zero-new-frame requests complete right here

    def _prefill_wave(self, pairs):
        seqs = [torch.as_tensor(np.asarray(req.frames, np.float32),
                                device=self.device)[None]
                for _, req in pairs]
        armed = self._arm_injected_prefill_fault(pairs)
        with self.tracer.span("admit", n_requests=len(pairs),
                              uids=[req.uid for _, req in pairs]):
            try:
                results = self.compiled.prefill(
                    seqs, priorities=[req.priority for _, req in pairs])
            except LaunchError as err:
                if self.on_fault != "fallback":
                    raise  # fail-fast mode
                self._quarantine_wave(pairs, err)
                return
            finally:
                if armed:
                    self.compiled.fault.disarm()
            p = self.compiled.plan
            self.prefill_waves += 1
            self.packed_launches += p.launches
            self.naive_launches += p.naive_launches
            self.last_plan = p
            for (slot, req), (out_b, st) in zip(pairs, results):
                with self.tracer.span("serve.splice", uid=req.uid):
                    self._splice(slot, req, out_b, st)

    def _arm_injected_prefill_fault(self, pairs) -> bool:
        """``fail_prefill_of`` hook: for waves containing a targeted uid,
        arm the compiled stack's injector through the WHOLE ladder, so the
        resulting ``LaunchError`` reaches the engine's quarantine even
        under on_fault="fallback" (a shallower arm would just be absorbed
        by the per-step rung)."""
        if not any(req.uid in self.fail_prefill_of for _, req in pairs):
            return False
        self.compiled.fault.arm([0], through_level=2)
        return True

    def _quarantine_wave(self, pairs, err: LaunchError):
        """Launch-fault bisection.  A single-request wave names its
        culprit: fail exactly that request.  A multi-request wave
        re-admits each request as its own solo wave — packed rows are
        independent by the cross-B masking contract (the dispatch bench
        asserts bit-equality of packed vs unpacked rows), so the healthy
        requests' solo outputs are bit-identical to the packed ones."""
        if len(pairs) == 1:
            _, req = pairs[0]
            self._fail_unadmitted(req, f"prefill launch fault: {err}")
            return
        self.prefill_retries += len(pairs)
        for pair in pairs:
            self._prefill_wave([pair])

    def _fail_unadmitted(self, req: RecurrentRequest, error: str):
        """A request that faulted before occupying a slot: surface a
        failed completion (empty outputs — prefill never finished)."""
        self.quarantined += 1
        if self.tracer.enabled:
            self.tracer.instant("request_failed", track="requests",
                                uid=req.uid, error=error)
        self.done.append(RecurrentCompletion(
            uid=req.uid, prompt_len=len(req.frames),
            outputs=np.zeros((0, self.H), np.float32),
            generated=np.zeros((0, self.H), np.float32),
            status="failed", error=error))

    def _splice(self, slot: int, req: RecurrentRequest, out_b, st):
        """Splice one request's prefill result into its slot — or
        quarantine it (non-finite state/outputs fail ONLY this request)."""
        if st is None or "h" not in st:
            # the executor returns None (rglru, stateless schedules) or a
            # per-direction dict (bidirectional) for items with no single
            # t=T state — nothing to splice, and silently proceeding would
            # serve garbage decode frames.  A config-level mismatch, not a
            # per-request fault: raise (PlanRejected is a RuntimeError).
            raise PlanRejected(
                f"request {req.uid}: prefill returned no spliceable "
                f"recurrent state (family {self.family!r}); the engine "
                "can only serve stacks whose executor surfaces exact "
                "t=T (h[, c]) state", uids=(req.uid,))
        h_col = st["h"][:, 0].float()
        c_col = st["c"][:, 0].float() if self.c is not None else None
        if self.poison_slot_at.get(req.uid) == -1:
            # injected fault: the quarantine below sees a REAL poisoned
            # splice, not a simulated flag
            h_col = torch.full_like(h_col, float("nan"))
        out_t = out_b[0]                            # (T, H)
        finite = bool(torch.isfinite(h_col).all()
                      and torch.isfinite(out_t).all()
                      and (c_col is None or torch.isfinite(c_col).all()))
        out = out_t.float().cpu().numpy()
        if not finite:
            self._fail_unadmitted(req, str(NonFiniteStateError(
                f"request {req.uid}: non-finite spliced prefill state — "
                "quarantined, slot stays free", uids=(req.uid,),
                where="prefill state")))
            return
        self.h[:, slot] = h_col
        if self.c is not None:
            self.c[:, slot] = c_col
        self.prefill_out[slot] = out
        self.last_y[slot, 0] = out_t[-1].float()
        self.slots[slot] = req
        self.generated[slot] = []
        self.slot_ticks[slot] = 0
        self.admitted_at[slot] = obs.monotonic_s()
        if self.tracer.enabled:
            self._admit_us[slot] = self.tracer.now_us()

    # ------------------------------------------------------------------
    def _decode_tick(self):
        """One planned decode step across the *active* slots only: their
        T=1 layer chains B-concatenate into a single chained slot — ONE
        kernel launch per tick instead of L — with each request's last
        top-layer frame fed back as its next input.  Plans are cached per
        active-slot signature inside the CompiledStack (plans are
        shape-only: WHICH slots are active changes the gather, not the
        plan).  Per-row finiteness quarantine after the launch fails only
        poisoned requests; the co-batched rows are independent and keep
        their values."""
        tr = self.tracer
        active = [s for s in range(self.max_batch)
                  if self.slots[s] is not None]
        with tr.span("serve.gather", rows=len(active)):
            # poison_slot_at hook: corrupt the targeted request's live
            # state just before its poisoned tick, so quarantine handles
            # real NaN propagation through the kernels
            for s in active:
                if self.poison_slot_at.get(
                        self.slots[s].uid) == self.slot_ticks[s]:
                    self.h[:, s] = float("nan")
            idx = torch.as_tensor(active, device=self.device)
            state = {"h": self.h[:, idx]}
            if self.c is not None:
                state["c"] = self.c[:, idx]
            x_t = self.last_y[idx]
        t0 = obs.monotonic_s()
        y, st = self.compiled.decode(x_t, state)
        p = self.compiled.last_decode_plan
        with tr.span("serve.check"):
            # the dispatch claim, verified every tick: k active slots plan
            # exactly k-row cells — empty slots are never computed — in a
            # chained slot the stack's device admits
            check_decode_tick(p, len(active),
                              device_model=self.compiled.device_model)
        self.decode_ticks += 1
        self.decode_launches += p.launches
        self.last_decode_plan = p
        if self.watchdog is not None and self.watchdog.observe(
                self.decode_ticks, obs.monotonic_s() - t0):
            self.straggler_ticks.append(self.decode_ticks)
            if tr.enabled:
                tr.instant("straggler", tick=self.decode_ticks)

        with tr.span("serve.scatter"):
            self.h[:, idx] = st["h"].float()
            if self.c is not None:
                self.c[:, idx] = st["c"]
            frames = y[:, 0].float()                        # (k, H)
            self.last_y[idx, 0] = frames
            # one host copy per tick: the frames and a per-row finiteness
            # flag
            rows_ok = (torch.isfinite(st["h"]).all(dim=2).all(dim=0)
                       & torch.isfinite(frames).all(dim=1))
            if self.c is not None:
                rows_ok &= torch.isfinite(st["c"]).all(dim=2).all(dim=0)
        with tr.span("serve.readback"):
            # the tick's wait on the device
            rows_ok = rows_ok.tolist()
            frames_np = frames.cpu().numpy()
        with tr.span("serve.deliver"):
            poisoned = []
            for i, s in enumerate(active):
                if rows_ok[i]:
                    self.generated[s].append(frames_np[i])
                    self.slot_ticks[s] += 1
                else:
                    poisoned.append(s)
            for s in poisoned:
                uid = self.slots[s].uid
                self.quarantined += 1
                self._finish(s, status="failed", error=str(
                    NonFiniteStateError(
                        f"request {uid}: non-finite decode state/frame at "
                        f"tick {self.slot_ticks[s]} — quarantined, slot "
                        "freed", uids=(uid,), slot=s,
                        where="decode frame")))

    def _finish(self, slot: int, status: str = "ok",
                error: Optional[str] = None):
        """Retire one slot into a completion (whatever frames it got)."""
        req = self.slots[slot]
        gen = (np.stack(self.generated[slot]) if self.generated[slot]
               else np.zeros((0, self.H), np.float32))
        if self.tracer.enabled:
            # the request's whole admit->retire lifetime as ONE retroactive
            # span on the "requests" track, beside the exec track's launches
            now = self.tracer.now_us()
            start = self._admit_us[slot]
            self.tracer.span_at(
                "request", start if start is not None else now, now,
                track="requests", uid=req.uid, slot=slot, status=status,
                ticks=self.slot_ticks[slot], frames=len(gen))
        self.done.append(RecurrentCompletion(
            uid=req.uid, prompt_len=len(req.frames),
            outputs=self.prefill_out[slot], generated=gen,
            status=status, error=error))
        self.slots[slot] = None
        self.generated[slot] = []
        self.admitted_at[slot] = None
        self._admit_us[slot] = None

    def _retire(self):
        """Deadline-aware retirement: frame-budget completion ("ok"),
        decode-tick deadline (``max_ticks``), and wall-time deadline
        (``deadline_s``, measured from admission) — expired requests
        retire as ``status="timeout"`` carrying their partial output."""
        with self.tracer.span("serve.retire"):
            now = obs.monotonic_s()
            for slot, req in enumerate(self.slots):
                if req is None:
                    continue
                if len(self.generated[slot]) >= req.max_new_frames:
                    self._finish(slot)
                elif (req.max_ticks is not None
                      and self.slot_ticks[slot] >= req.max_ticks):
                    self._finish(slot, status="timeout", error=(
                        f"request {req.uid}: max_ticks={req.max_ticks} "
                        f"expired with {len(self.generated[slot])}/"
                        f"{req.max_new_frames} frames"))
                elif (req.deadline_s is not None
                      and self.admitted_at[slot] is not None
                      and now - self.admitted_at[slot] > req.deadline_s):
                    self._finish(slot, status="timeout", error=(
                        f"request {req.uid}: wall-time deadline "
                        f"{req.deadline_s}s expired with "
                        f"{len(self.generated[slot])}/"
                        f"{req.max_new_frames} frames"))

    # ------------------------------------------------------------------
    def step(self):
        """One engine tick: admit (packed prefill) -> planned decode ->
        retire, inside one ``serve.step`` span."""
        with self.tracer.span("serve.step"):
            self._admit()
            if not any(s is not None for s in self.slots):
                return
            self._decode_tick()
            self.steps += 1
            self._retire()

    def run_to_completion(self, max_ticks: int = 10_000
                          ) -> List[RecurrentCompletion]:
        """Drive until queue and slots drain; ``max_ticks`` bounds THIS
        call (a local counter — repeated calls each get the full budget).
        On overrun, raises ``RequestTimeout`` carrying the completions
        already finished in ``.done`` — an engine-level deadline never
        loses completed work."""
        ticks = 0
        while self.queue or any(s is not None for s in self.slots):
            self.step()
            ticks += 1
            if ticks > max_ticks:
                stuck = sorted({r.uid for r in self.queue}
                               | {r.uid for r in self.slots
                                  if r is not None})
                raise RequestTimeout(
                    f"engine did not drain within {max_ticks} ticks; "
                    f"in-flight request uids {stuck} (finished "
                    "completions preserved in .done)",
                    uids=stuck, done=self.done)
        return self.done
