"""compile() -> CompiledStack: the one planned execution path.

The port of ``repro.rnn.compiled``.  ``compile`` takes either a
``repro_torch.configs`` ModelConfig (family "rnn", initialised as an LSTM
or, with ``rnn_family="gru"``, as the paper's §8 GRU) or a parameter
stack ``{"layers": [...]}`` (lstm, gru or mixed lstm/gru layers, the
family inferred per layer from the gate width) plus an
``ExecutionPolicy`` and a device, and returns a ``CompiledStack`` whose
every entry point lowers to ``dispatch.WorkItem``s and executes through
the tile dispatcher's planner/executor:

    forward(xs)          whole-sequence evaluation (one stack; batch B)
    prefill(xs | [xs..]) forward + exact t=T recurrent state; a list packs
                         all requests into ONE DispatchPlan (the serving
                         admission wave)
    decode(x_t, state)   one T=1 tick resumed from ``state`` — a single
                         chained ``lstm_decode`` / ``gru_decode`` launch
                         (a mixed stack: L per-layer launches)
    plan                 the most recent DispatchPlan (``.describe()``
                         prints every launch the executor will make)
    stats                launches / est_cycles / plans_built accounting

Plans are shape-only and cached per (direction, B, T, dtype) signature, so
repeated calls at one shape replan nothing.  A bidirectional stack runs
the interleaved fwd/bwd wavefront — forward returns the (B, T, 2H) fwd‖bwd
concat, prefill per-direction end-of-walk state, and decode raises (no
streaming decode exists).

The policy's ``precision`` ("bf16"/"int8") and ``sparsity`` ("block")
act on the recurrent weights U only: the stack binds their fake-quant
view once at compile, the planner prices the narrowed weights, and the
executor hands the sequence kernels the int8 payload and/or the
row-compacted U (decode ticks run the dense decode kernels on the
fake-quant view).

Entry points run on ``device`` ("cuda" by default: the hand-written
kernels); ``device="cpu"`` runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedules import stack_families
from repro_torch.dispatch import (DispatchPlan, WorkItem, execute, plan,
                                  plan_decode, prepare_decode_stack)
from repro_torch.dispatch.executor import kernel_refusal
from repro_torch.kernels.common import (KernelLaunchRefused, dtype_name,
                                        torch_dtype)
from repro_torch.kernels.quant import fake_quant_stack, stack_tile_maps
from repro_torch.rnn.policy import ExecutionPolicy
from repro_torch.runtime.errors import ExecutionReport, FaultInjector
from repro_torch.runtime.obs import NULL_TRACER, Tracer


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is the default; without a
    card the caller must ask for the CPU explicitly — the port never moves
    to the CPU on its own.

    On CUDA this also sets ``torch.backends.cuda.matmul.allow_tf32 =
    False`` (PyTorch's default) for the process: the executor's hoisted
    input GEMM and the transformer's fp32 products stand for the
    reference's fp32 einsums and must not run in TF32; and it sets
    ``allow_bf16_reduced_precision_reduction = False``, so that cuBLAS
    sums a bf16 product in fp32 as the reference's einsums do.  They are
    set here, once per compiled stack or engine, not on each call."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device=\"cpu\" to run the plain PyTorch versions "
            "of the kernels on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device={str(device)!r} invalid; allowed: cuda, "
                         "cpu")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return device


def _to_device(tree, device):
    """A parameter stack with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


@dataclasses.dataclass
class StackStats:
    """Execution accounting of one CompiledStack (all counters cumulative).

    ``launches``/``est_cycles`` include decode ticks; ``plans_built``
    counts plan-cache misses (flat counters across steady-state reuse are
    the plan-cache proof the serving tests assert).

    ``degraded_launches`` counts slots the guarded execution ladder had to
    re-execute below their planned rung (policy ``on_fault="fallback"``);
    ``fallback_level`` is the deepest rung ever used (index into
    ``runtime.errors.FALLBACK_LEVELS``: 0 planned, 1 per-step, 2 plain
    reference, reached on the CPU only); ``faults`` is the human-readable fault trail — a ring
    buffer keeping the ``MAX_FAULT_TRAIL`` most recent entries
    (``faults_total`` counts every fault ever).  All of these stay
    zero/empty on a healthy stack — they are the degradation signal the
    serving layer watches."""

    #: ring-buffer bound on ``faults``
    MAX_FAULT_TRAIL = 64

    forward_calls: int = 0
    decode_calls: int = 0
    launches: int = 0
    est_cycles: float = 0.0
    plans_built: int = 0
    plans_verified: int = 0
    decode_launches: int = 0
    decode_plans_built: int = 0
    degraded_launches: int = 0
    fallback_level: int = 0
    faults: List[str] = dataclasses.field(default_factory=list)
    faults_total: int = 0

    def record_faults(self, entries: Sequence[str]) -> None:
        """Append to the fault trail, keeping only the last
        ``MAX_FAULT_TRAIL`` entries (ring-buffer semantics)."""
        self.faults_total += len(entries)
        self.faults.extend(entries)
        if len(self.faults) > self.MAX_FAULT_TRAIL:
            del self.faults[:len(self.faults) - self.MAX_FAULT_TRAIL]


def _as_policy(policy) -> ExecutionPolicy:
    if policy is None:
        return ExecutionPolicy()
    if not isinstance(policy, ExecutionPolicy):
        raise TypeError(
            f"compile(..., policy=...) takes an ExecutionPolicy, got "
            f"{type(policy).__name__} — schedule strings moved into "
            "ExecutionPolicy(schedule=...)")
    return policy


def compile(model, policy: Optional[ExecutionPolicy] = None, *,
            params: Optional[dict] = None, rnn_family: str = "lstm",
            seed: int = 0, device="cuda") -> "CompiledStack":
    """Compile a recurrent stack into the planned execution path.

    ``model``: a ModelConfig (family "rnn") or a parameter stack
    ``{"layers": [...]}``.  For a config, ``params`` binds existing
    parameters; otherwise they are initialized from a ``torch.Generator``
    seeded with ``seed`` (``rnn_family`` picks lstm or the paper §8 GRU
    variant).  For a parameter stack, families are inferred per layer from
    the gate widths — mixed lstm/gru stacks are first-class.  ``device``:
    where every entry point runs ("cuda" by default; "cpu" for the plain
    PyTorch versions); the parameters are moved there.  On the card a
    stack whose forward would launch a kernel past its limit on H
    (``dispatch.executor.kernel_refusal``) is refused here with
    ``KernelLaunchRefused``.
    """
    policy = _as_policy(policy)
    device = resolve_device(device)
    if rnn_family not in ("lstm", "gru"):
        raise ValueError(f"compile: rnn_family={rnn_family!r} invalid; "
                         "allowed: lstm, gru")
    if isinstance(model, ModelConfig):
        if model.family != "rnn":
            raise ValueError(
                f"compile: config {model.name!r} (family {model.family!r}) "
                "is not a recurrent stack; the rnn facade compiles "
                "family='rnn' configs or {'layers': [...]} parameter stacks")
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            dtype = torch_dtype(model.dtype)
            if rnn_family == "lstm":
                from repro_torch.models.layers.lstm import init_lstm_stack

                params = init_lstm_stack(gen, model, dtype)
            else:
                if model.bidirectional:
                    raise ValueError(
                        "compile: no bidirectional GRU initializer; pass "
                        "params= explicitly")
                from repro_torch.core.gru import init_gru_stack

                params = init_gru_stack(gen, model.lstm_input,
                                        model.lstm_hidden, model.n_layers,
                                        dtype)
    elif isinstance(model, dict) and "layers" in model:
        if params is not None:
            raise ValueError(
                "compile: pass EITHER a parameter stack as model OR a "
                "config plus params=, not both")
        params = model
    else:
        raise TypeError(
            f"compile: expected a ModelConfig or a {{'layers': [...]}} "
            f"parameter stack, got {type(model).__name__}")
    if device.type == "cuda":
        refusal = kernel_refusal(params, policy)
        if refusal:
            raise KernelLaunchRefused(f"rnn.compile: {refusal}")
    return CompiledStack(_to_device(params, device), policy, device)


class CompiledStack:
    """One recurrent stack bound to one ExecutionPolicy and one device;
    see module doc."""

    def __init__(self, params: dict, policy: ExecutionPolicy,
                 device: torch.device):
        if not params.get("layers"):
            raise ValueError("CompiledStack: empty parameter stack")
        self.policy = policy
        self.device = device
        if policy.precision != "fp32":
            # bind the fake-quant view ONCE: packed kernels (which
            # re-quantize it, an exact idempotent round-trip), decode ticks
            # and the external schedules then all compute with the SAME
            # dequantized values, so one oracle (reference_stack over these
            # params) covers every surface
            params = fake_quant_stack(params, policy.precision)
        self.params = params
        self.families: Tuple[str, ...] = stack_families(params)
        self.bidirectional = any("fwd" in l for l in params["layers"])
        if self.bidirectional and not all("fwd" in l
                                          for l in params["layers"]):
            raise ValueError(
                "CompiledStack: mixed uni/bidirectional layers unsupported")
        if self.bidirectional and self.heterogeneous:
            # fail at compile() like every other stack-shape error, not at
            # the first forward() from WorkItem validation
            raise ValueError(
                "CompiledStack: mixed-family stacks cannot be bidirectional")
        layer0 = params["layers"][0]
        half0 = layer0.get("fwd", layer0)
        self.H = int(half0["U"].shape[0])
        self.X = int(half0["W"].shape[0])
        self.L = len(params["layers"])
        widths = {int(l.get("fwd", l)["U"].shape[0])
                  for l in params["layers"]}
        if widths != {self.H}:
            raise ValueError(
                f"CompiledStack: layers must share one hidden width, got "
                f"{sorted(widths)}")
        self.stats = StackStats()
        #: the observability surface (policy ``trace=True``): a
        #: runtime.obs.Tracer recording plan/hoist/launch/decode-tick spans
        #: + metrics; the shared no-op tracer when tracing is off
        self.tracer = Tracer() if policy.trace else NULL_TRACER
        #: test/chaos hook: arm with plan slot indices to make launches
        #: raise (see runtime.errors.FaultInjector); disarmed = no-op
        self.fault = FaultInjector()
        #: block-sparsity occupancy of the bound parameters, derived ONCE
        #: at compile (policy ``sparsity="block"``): per-layer 8-row tile
        #: bitmaps the planner prices and the executor row-compacts
        #: against.  None = dense.
        self._tile_map: Optional[tuple] = None
        if policy.sparsity == "block":
            self._tile_map = stack_tile_maps(params)
        #: memo of quantized / row-compacted weight operands — valid for
        #: this stack's lifetime (the bound parameters never change), so
        #: each layer is transformed at most once across every call
        self._quant_cache: dict = {}
        self.last_decode_plan: Optional[DispatchPlan] = None
        self._last_plan: Optional[DispatchPlan] = None
        self._plans: Dict[tuple, DispatchPlan] = {}
        self._prepared: Optional[dict] = None

    # ------------------------------------------------------------------
    @property
    def heterogeneous(self) -> bool:
        """True for a mixed lstm/gru stack."""
        return len(set(self.families)) > 1

    @property
    def plan(self) -> Optional[DispatchPlan]:
        """The most recent forward/prefill DispatchPlan (decode keeps its
        own ``last_decode_plan``); None before the first call — use
        ``lower(B, T)`` to build one without executing."""
        return self._last_plan

    # ------------------------------------------------------------------
    def _item(self, uid: int, B: int, T: int, dtype: str,
              priority: int = 0) -> WorkItem:
        return WorkItem(uid=uid, family=self.families[0], B=B, T=T,
                        H=self.H, L=self.L, X=self.X, dtype=dtype,
                        priority=priority, bidirectional=self.bidirectional,
                        share=0, families=self.families,
                        precision=self.policy.precision,
                        tile_map=self._tile_map)

    @property
    def _dir_key(self) -> str:
        """Direction component of every plan-cache key: a bidirectional
        stack's plans are interleaved fwd/bwd timelines, never
        interchangeable with a unidirectional stack's at the same shape."""
        return "bi" if self.bidirectional else "uni"

    #: plan-cache bound (LRU): a long-running serving process with ragged
    #: prompt lengths almost never repeats an admission-wave signature
    MAX_CACHED_PLANS = 128

    def _cached(self, key, build) -> DispatchPlan:
        p = self._plans.get(key)
        if p is None:
            p = build()
            if self.policy.verify == "plan":
                # verify ONCE per cache miss, before the plan is ever
                # executable from the cache
                from repro_torch.analysis.plancheck import check_plan
                with self.tracer.span("verify", slots=len(p.slots)):
                    check_plan(p)
                self.stats.plans_verified += 1
            while len(self._plans) >= self.MAX_CACHED_PLANS:
                self._plans.pop(next(iter(self._plans)))
            self._plans[key] = p
            self.stats.plans_built += 1
            if key[0] == "dec":
                self.stats.decode_plans_built += 1
        else:
            self._plans[key] = self._plans.pop(key)  # LRU refresh
        return p

    def lower(self, B: int, T: int, dtype: str = "float32",
              priority: int = 0) -> DispatchPlan:
        """Build (or fetch) the DispatchPlan for a shape without executing
        — the introspection entry point (``lower(...).describe()``).
        Shares its cache key with forward() and single-request prefill()."""
        return self._lower_many(((B, T, dtype),), (priority,))

    def _lower_many(self, shapes: Tuple[Tuple[int, int, str], ...],
                    prios: Tuple[int, ...]) -> DispatchPlan:
        """One plan over per-request (B, T, dtype) signatures — the single
        cache-key shape every entry point funnels through."""
        pol = self.policy
        force = None if pol.schedule == "auto" else pol.schedule
        key = ("fwd", self._dir_key, shapes, prios)
        return self._cached(key, lambda: plan(
            [self._item(i, b, t, dt, priority=p)
             for i, ((b, t, dt), p) in enumerate(zip(shapes, prios))],
            macs=pol.macs, cross_b=pol.packing, align_stripes=pol.packing,
            schedule=force, block_t=pol.block_t, tracer=self.tracer))

    # ------------------------------------------------------------------
    def _as_input(self, x):
        """A tensor on this stack's device; float64 arrives as float32
        (the JAX package's default precision), and the policy's dtype
        applies."""
        x = torch.as_tensor(x, device=self.device)
        if x.dtype == torch.float64:
            x = x.float()
        if self.policy.dtype is not None:
            x = x.to(torch_dtype(self.policy.dtype))
        return x

    def _prep(self, xs, name: str):
        xs = self._as_input(xs)
        squeeze = xs.ndim == 2
        if squeeze:
            xs = xs[None]
        if xs.ndim != 3 or xs.shape[-1] != self.X:
            raise ValueError(
                f"CompiledStack.{name}: expected xs of shape "
                f"(B, T, {self.X}) or (T, {self.X}), got {tuple(xs.shape)}")
        return xs, squeeze

    def _guard(self) -> Tuple[ExecutionReport, dict]:
        """Per-call guarded-ladder kwargs for execute(): the policy's fault
        knobs, this stack's injector, and a fresh degradation report that
        ``_account`` folds into ``.stats`` after a successful call."""
        rep = ExecutionReport()
        return rep, {"on_fault": self.policy.on_fault,
                     "check_finite": self.policy.check_finite,
                     "inject": self.fault, "report": rep,
                     "tracer": self.tracer}

    def _account(self, p: DispatchPlan, decode: bool = False,
                 report: Optional[ExecutionReport] = None) -> None:
        self.stats.launches += p.launches
        self.stats.est_cycles += p.est_cycles
        if report is not None and report.degraded_launches:
            self.stats.degraded_launches += report.degraded_launches
            self.stats.fallback_level = max(self.stats.fallback_level,
                                            report.fallback_level)
            self.stats.record_faults(report.faults)
        if decode:
            self.stats.decode_calls += 1
            self.stats.decode_launches += p.launches
            self.last_decode_plan = p
        else:
            self.stats.forward_calls += 1
            self._last_plan = p

    # ------------------------------------------------------------------
    def forward(self, xs):
        """Whole-sequence evaluation: (B, T, X) -> (B, T, H·dirs) (2-D
        input auto-batches and squeezes back)."""
        xs, squeeze = self._prep(xs, "forward")
        B, T, _ = xs.shape
        if T == 0:
            raise ValueError("CompiledStack.forward: T=0 sequence")
        tr = self.tracer
        with tr.span("forward", B=B, T=T) as sp:
            p = self.lower(B, T, dtype_name(xs.dtype))
            rep, guard = self._guard()
            outs = execute(p, {0: self.params}, {0: xs},
                           quant_cache=self._quant_cache, **guard)
            outs = tr.fence(outs)
            if tr.enabled:
                sp.tag(plan=tr.plan_id(p), launches=p.launches)
        self._account(p, report=rep)
        ys = outs[0]
        return ys[0] if squeeze else ys

    def prefill(self, xs, priorities: Optional[Sequence[int]] = None):
        """forward + exact t=T recurrent state.

        One array -> ``(ys, state)`` with state {"h": (L, B, H)[, "c"]}
        ("c" whenever any layer is an LSTM; rows of a mixed stack's gru
        layers are zeros).  A SEQUENCE of arrays (the serving admission
        wave) packs every request into ONE DispatchPlan — their (layer,
        time-chunk) cells share wavefront slots and cross-B rows — and
        returns a list of (ys, state).

        Bidirectional stacks return per-direction state
        ``{"fwd": {"h", "c"}, "bwd": {...}}`` — fwd's walk ends at t=T,
        bwd's at t=0, so there is no single t=T state to splice into a
        decode (the serving engine checks for a plain {"h": ...} dict).
        """
        if self.policy.schedule in ("sequential", "batch", "intergate",
                                    "unfolded", "per_step"):
            raise ValueError(
                f"ExecutionPolicy.schedule={self.policy.schedule!r} has no "
                "t=T state surface; prefill requires a dispatcher schedule "
                "(auto, wavefront, fused) — use forward() for "
                "reference-schedule evaluation")
        single = not isinstance(xs, (list, tuple))
        seqs = [xs] if single else list(xs)
        if not seqs:
            raise ValueError("CompiledStack.prefill: empty request list")
        prios = list(priorities) if priorities is not None else [0] * len(seqs)
        if len(prios) != len(seqs):
            raise ValueError(
                f"CompiledStack.prefill: {len(prios)} priorities for "
                f"{len(seqs)} requests")
        prepped = [self._prep(x, "prefill") for x in seqs]
        inputs = {i: x for i, (x, _) in enumerate(prepped)}
        if any(x.shape[1] == 0 for x in inputs.values()):
            raise ValueError("CompiledStack.prefill: T=0 sequence")
        tr = self.tracer
        with tr.span("prefill", n_requests=len(seqs)) as sp:
            # per-request dtype: a mixed-precision wave must not share
            # launch signatures (the planner keys slots on dtype per item)
            p = self._lower_many(
                tuple((x.shape[0], x.shape[1], dtype_name(x.dtype))
                      for x in inputs.values()), tuple(prios))
            rep, guard = self._guard()
            outs, states = execute(p, {i: self.params for i in inputs},
                                   inputs, collect_state=True,
                                   quant_cache=self._quant_cache, **guard)
            outs, states = tr.fence((outs, states))
            if tr.enabled:
                sp.tag(plan=tr.plan_id(p), launches=p.launches)
        self._account(p, report=rep)
        res = []
        for i, (_, squeeze) in enumerate(prepped):
            ys = outs[i][0] if squeeze else outs[i]
            res.append((ys, states[i]))
        return res[0] if single else res

    def decode(self, x_t, state):
        """One planned T=1 tick resumed from ``state`` ({"h": (L, B, H)
        [, "c"]}); returns (y_t (B, 1, H), new_state).

        Homogeneous lstm/gru stacks run the whole tick as ONE chained
        ``lstm_decode`` / ``gru_decode`` launch (the serving steady state);
        mixed stacks run a per-layer T=1 plan (L launches).  The policy's
        schedule preference does not apply here — decode is always
        state-resumed, which only the dispatcher paths support.
        """
        if self.bidirectional:
            raise ValueError(
                f"CompiledStack.decode: bidirectional stacks ({self.L} "
                "layers, both directions) have no streaming decode — the "
                "backward walk consumes the full sequence; run whole "
                "sequences through forward()/prefill() (the interleaved-"
                "wavefront path) instead")
        x_t = self._as_input(x_t)
        if x_t.ndim == 2:
            x_t = x_t[:, None, :]
        if x_t.ndim != 3 or x_t.shape[1] != 1 or x_t.shape[-1] != self.X:
            raise ValueError(
                f"CompiledStack.decode: expected x_t of shape (B, 1, "
                f"{self.X}) or (B, {self.X}), got {tuple(x_t.shape)}")
        B = x_t.shape[0]
        dtype = dtype_name(x_t.dtype)
        state = {k: torch.as_tensor(v, device=self.device)
                 for k, v in state.items()}
        tr = self.tracer
        with tr.span("decode_tick", B=B) as sp:
            key = ("dec", B, dtype)
            if not self.heterogeneous:
                p = self._cached(key, lambda: plan_decode(
                    [self._item(0, B, 1, dtype)], macs=self.policy.macs,
                    tracer=tr))
                if self._prepared is None:
                    # self.params already carries the fake-quant view, so
                    # the precision round-trip here is an exact idempotent
                    # no-op — passed anyway to keep the surfaces honest
                    # about what decode computes with
                    self._prepared = prepare_decode_stack(
                        self.params, self.families[0],
                        precision=self.policy.precision)
                prepared = {0: self._prepared}
            else:
                # mixed stacks: per-layer T=1 plan — FORCED onto the packed
                # timeline (schedule="wavefront" at bt=1 collapses to
                # packable per-layer cells), because only packed items
                # resume from init_state; at T=1 the auto scorer's fused
                # and per_step estimates tie to within rounding, and a
                # per_step pick would route external, where execute()
                # rejects init_state
                p = self._cached(key, lambda: plan(
                    [self._item(0, B, 1, dtype)], macs=self.policy.macs,
                    cross_b=self.policy.packing, schedule="wavefront",
                    block_t=1, tracer=tr))
                prepared = None
            rep, guard = self._guard()
            outs, states = execute(p, {0: self.params}, {0: x_t},
                                   collect_state=True,
                                   init_state={0: state},
                                   prepared=prepared,
                                   quant_cache=self._quant_cache, **guard)
            outs, states = tr.fence((outs, states))
            if tr.enabled:
                sp.tag(plan=tr.plan_id(p), launches=p.launches)
        if tr.enabled:
            tr.metrics.histogram("decode_tick_us").observe(sp.dur_us)
        self._account(p, decode=True, report=rep)
        return outs[0], states[0]

    # ------------------------------------------------------------------
    def describe(self) -> str:
        fams = ("/".join(self.families) if self.heterogeneous
                else self.families[0])
        bi = " bidirectional" if self.bidirectional else ""
        s = self.stats
        lines = [
            f"CompiledStack: {fams} L{self.L} H{self.H} "
            f"X{self.X}{bi} on {self.device}",
            f"  {self.policy.describe()}",
            "  cost model: analytic (perfmodel cycle formulas)",
            f"  stats: {s.forward_calls} forward / {s.decode_calls} decode "
            f"calls, {s.launches} launches ({s.decode_launches} decode), "
            f"{s.plans_built} plans built ({s.decode_plans_built} decode, "
            f"{s.plans_verified} verified), "
            f"est {s.est_cycles:.0f}cy",
            f"  plan cache: {len(self._plans)} shapes",
        ]
        if s.degraded_launches:
            from repro_torch.runtime.errors import FALLBACK_LEVELS
            lines.append(
                f"  DEGRADED: {s.degraded_launches} launches fell back "
                f"(deepest rung: {FALLBACK_LEVELS[s.fallback_level]}; "
                f"{s.faults_total} faults, trail keeps last "
                f"{s.MAX_FAULT_TRAIL})")
        if self.tracer.enabled:
            lines.append("  observability:")
            lines += ["    " + ln
                      for ln in self.tracer.describe().splitlines()]
        if self._last_plan is not None:
            lines.append("  last plan:")
            lines += ["    " + ln
                      for ln in self._last_plan.describe().splitlines()]
        return "\n".join(lines)
