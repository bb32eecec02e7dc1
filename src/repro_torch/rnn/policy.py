"""ExecutionPolicy: the validated, frozen description of how a
CompiledStack runs (the port of ``repro.rnn.policy``).

A policy is *how* to run, never *what* to run — it carries no shapes and no
parameters, so one policy object serves every stack and every call, and a
``CompiledStack`` can hash plan-cache keys without inspecting it twice.
Every field is validated at construction with an error that names the
offending field and the allowed values (the old surface let an unknown
schedule string travel all the way into ``core.gru.run_layer``'s function
table and die as a bare KeyError).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.dispatch.planner import DEFAULT_MACS
from repro_torch.dispatch.workitem import PRECISIONS, SPARSITIES

#: "auto" lets the planner score wavefront/fused/per_step per shape;
#: the rest force one execution shape (the research schedules
#: sequential/batch/intergate/unfolded run the pure reference
#: implementations through the planner's external path).
SCHEDULES = ("auto", "wavefront", "fused", "per_step",
             "sequential", "batch", "intergate", "unfolded")

DTYPES = ("float32", "bfloat16", "float16")

#: "raise" = fail fast: the first launch failure unwinds the caller.
#: "fallback" = the guarded execution ladder: a failed fused/chained launch
#: re-executes per-step and, failing that, raises on the card (on the CPU
#: it re-executes through the plain PyTorch reference), with the
#: degradation recorded in ``CompiledStack.stats``.
ON_FAULT = ("raise", "fallback")

#: "plan" (the default) statically verifies every DispatchPlan the stack
#: builds — coverage, wavefront readiness, packing legality, VMEM budget
#: (``analysis.plancheck``) — raising a structured ``PlanInvariantError``
#: before any launch; runs once per plan-cache build, under an obs
#: ``verify`` span.  "off" skips verification (the benchmark baseline).
VERIFY = ("off", "plan")

# PRECISIONS / SPARSITIES (imported above, shared with the planner's
# WorkItems): the port runs "fp32" / "none" (see the module doc).

#: "analytic" scores plans with the perfmodel's cycle formulas (the
#: default, zero-IO).  "measured" loads the replay-calibrated table
#: (``repro_torch.calib``, ``artifacts/measured_costs.json``) for the stack's
#: device (``calib.current_backend``: ``cuda(<device name>)`` or
#: ``torch(cpu)``) and scores merge/schedule/chained decisions in measured
#: µs, falling back to analytic scaling for unmeasured shapes; an empty or
#: missing table plans exactly as "analytic".
COST_MODELS = ("analytic", "measured")


def _bad(field: str, value, allowed) -> ValueError:
    return ValueError(
        f"ExecutionPolicy.{field}={value!r} is invalid; allowed: "
        f"{', '.join(str(a) for a in allowed)}")


@dataclass(frozen=True)
class ExecutionPolicy:
    """How a CompiledStack executes.

    schedule:  "auto" (planner-scored) or a forced schedule — one of
               ``SCHEDULES``.
    block_t:   wavefront T-stripe override, honored under "auto" too (the
               scorer then only weighs the pinned stripe against
               per_step); 0 = autotuned (VMEM-budgeted).
    dtype:     cast inputs before execution; None = keep the caller's.
    precision: recurrent-weight precision — "fp32" (the weights as bound),
               "bf16" (U round-tripped through bfloat16: bit-identical to
               the fp32 path on the fake-quant view) or "int8" (per-gate
               absmax int8 U; fp32 accumulate, scale after the dot;
               bounded error vs the dequantized oracle).  The input GEMM
               (W) always stays full precision.
    sparsity:  "none" (dense) or "block" — skip all-zero 8-row tiles of U
               (value-exact; the kernels gather h to the surviving rows).
    packing:   cross-B packing + stripe alignment on/off (off = every cell
               its own launch row; the benchmark baseline).
    macs:      planner tile-engine budget (the paper's K-width exploration
               space; DEFAULT_MACS = 16K, the paper's reference design).
    on_fault:  "raise" (fail fast) or "fallback" (guarded execution
               ladder: failed launches re-execute per-step, then, on the
               CPU only, through the plain PyTorch reference, recorded in
               ``.stats`` — see ``ON_FAULT``).
    check_finite: verify each launch's recurrent state is finite and raise
               a structured ``NonFiniteStateError`` naming the poisoned
               items (fallback cannot fix a NaN — it re-derives
               deterministically — so this raises under either on_fault).
    verify:    "plan" (default) statically verifies every plan the stack
               builds against the dispatch invariants — exact coverage,
               wavefront readiness, packing legality, stripe/VMEM budgets
               (``analysis.plancheck``) — raising ``PlanInvariantError``
               before anything launches; "off" skips the check.  Runs
               once per plan-cache build (amortizes to zero across cache
               hits) and is counted in ``.stats.plans_verified``.
    cost_model: "analytic" (perfmodel cycle formulas, the default) or
               "measured" (score planner decisions — merge-vs-split,
               schedule choice, chained-vs-loop decode — against the
               replay-calibrated ``repro_torch.calib`` table for the
               stack's device; unmeasured shapes interpolate from the
               nearest measured neighbour or fall back to analytic, and an
               empty table plans exactly as "analytic").
    cost_table: path to the measured-cost JSON; None = the default
               ``artifacts/measured_costs.json``.  Only read when
               ``cost_model="measured"``.
    trace:     record host-clock spans of every plan, verification,
               execution, launch and decode tick on
               ``CompiledStack.tracer`` (a ``runtime.obs.Tracer`` — per-
               span-name totals, Chrome-trace export on the profiler's
               clock).  Spans never wait on the device, traced or not.
               Off (the default) binds the shared no-op tracer: no
               events, outputs bit-identical to the traced path.
    """

    schedule: str = "auto"
    block_t: int = 0
    dtype: Optional[str] = None
    precision: str = "fp32"
    sparsity: str = "none"
    packing: bool = True
    macs: int = DEFAULT_MACS
    on_fault: str = "raise"
    check_finite: bool = False
    verify: str = "plan"
    cost_model: str = "analytic"
    cost_table: Optional[str] = None
    trace: bool = False

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise _bad("schedule", self.schedule, SCHEDULES)
        if (not isinstance(self.block_t, int) or isinstance(self.block_t, bool)
                or self.block_t < 0):
            raise _bad("block_t", self.block_t,
                       ("a non-negative int (0 = autotuned)",))
        if self.dtype is not None and self.dtype not in DTYPES:
            raise _bad("dtype", self.dtype, (None,) + DTYPES)
        if self.precision not in PRECISIONS:
            raise _bad("precision", self.precision, PRECISIONS)
        if self.sparsity not in SPARSITIES:
            raise _bad("sparsity", self.sparsity, SPARSITIES)
        if not isinstance(self.packing, bool):
            raise _bad("packing", self.packing, (True, False))
        if (not isinstance(self.macs, int) or isinstance(self.macs, bool)
                or self.macs < 1):
            raise _bad("macs", self.macs, ("a positive int (MAC budget)",))
        if self.on_fault not in ON_FAULT:
            raise _bad("on_fault", self.on_fault, ON_FAULT)
        if not isinstance(self.check_finite, bool):
            raise _bad("check_finite", self.check_finite, (True, False))
        if self.verify not in VERIFY:
            raise _bad("verify", self.verify, VERIFY)
        if self.cost_model not in COST_MODELS:
            raise _bad("cost_model", self.cost_model, COST_MODELS)
        if not (self.cost_table is None or isinstance(self.cost_table, str)):
            raise _bad("cost_table", self.cost_table,
                       (None, "a path to a measured-cost JSON"))
        if not isinstance(self.trace, bool):
            raise _bad("trace", self.trace, (True, False))

    def describe(self) -> str:
        return (f"ExecutionPolicy(schedule={self.schedule}, "
                f"block_t={self.block_t or 'auto'}, "
                f"dtype={self.dtype or 'keep'}, "
                f"precision={self.precision}, sparsity={self.sparsity}, "
                f"packing={self.packing}, macs={self.macs}, "
                f"on_fault={self.on_fault}, "
                f"check_finite={self.check_finite}, "
                f"verify={self.verify}, cost_model={self.cost_model}, "
                f"trace={self.trace})")
