"""Structured error taxonomy + fault-injection hooks for the serving path.

A copy of ``repro.runtime.errors``, plus ``not_ported`` (the one error
every feature of the JAX package that the port does not carry yet raises)
and ``DeviceUnavailable`` (an entry point asked for a card the process
cannot see).

A production RNN service is a low-latency datacenter workload where many
requests share one packed launch — which must NOT mean they share one
failure domain.  Every fault the dispatch/rnn/serving layers can surface
is a subclass of ``ServingFault`` carrying the *ids involved* (launch slot
index, request uids), so callers can quarantine exactly the offending
work instead of unwinding the whole engine:

  * ``LaunchError``        — a kernel launch raised (or a fault-injection
                             hook made it raise); carries the slot index,
                             the uids whose cells shared the launch, and
                             the deepest fallback rung that was attempted.
  * ``NonFiniteStateError`` — recurrent state or output frames went
                             non-finite (NaN/Inf); carries the uids whose
                             rows are poisoned and where they were caught.
  * ``PlanRejected``       — a request's shape/configuration cannot be
                             served by the planned path (also a
                             ``ValueError``: rejection is an input error).
  * ``PlanInvariantError`` — a ``DispatchPlan`` failed static verification
                             (``analysis.plancheck``): a dispatch invariant
                             — coverage, wavefront readiness, packing
                             legality, resource budget — does not hold.
                             Carries the violated ``rule`` name, the slot
                             index, and the offending cell, so a CI failure
                             or a serving-side rejection names the exact
                             broken theorem instead of a launch-time
                             mystery.
  * ``RequestTimeout``     — a deadline expired; carries the uids still in
                             flight and, from the engine's
                             ``run_to_completion``, the completions already
                             finished (``.done``) so an overrun never loses
                             completed work.
  * ``QueueFull``          — bounded-admission backpressure: the engine's
                             queue is at capacity and the policy is
                             "reject".

``FaultInjector`` is the serving-path analogue of
``runtime.ft.TrainLoop.failure_at_steps``: armed with launch (slot)
indices, it makes the executor's guarded ladder raise on demand so every
recovery path — per-step re-execution, reference fallback, engine
quarantine — is provable in CPU tests.  ``ExecutionReport`` is the
per-execute() degradation record the CompiledStack folds into ``.stats``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set, Tuple

#: The guarded execution ladder, shallowest first: 0 = the planned fused/
#: chained launch, 1 = per-step (per-layer for chained slots) kernel
#: launches, 2 = the plain PyTorch reference — a rung for CPU tensors
#: only: on the card the ladder ends at per_step and raises.
FALLBACK_LEVELS = ("fused", "per_step", "reference")


class ServingFault(RuntimeError):
    """Base class: a structured fault naming the work it affects."""

    def __init__(self, msg: str, *, uids: Sequence[int] = (),
                 slot: Optional[int] = None):
        super().__init__(msg)
        self.uids: Tuple[int, ...] = tuple(uids)
        self.slot = slot


class LaunchError(ServingFault):
    """A kernel launch raised.  ``slot`` is the plan's slot index,
    ``uids`` the items whose cells shared the launch, ``level`` the
    deepest ladder rung attempted (a ``FALLBACK_LEVELS`` name), and
    ``injected`` whether a fault-injection hook raised it."""

    def __init__(self, msg: str, *, uids: Sequence[int] = (),
                 slot: Optional[int] = None, level: str = "fused",
                 injected: bool = False):
        super().__init__(msg, uids=uids, slot=slot)
        self.level = level
        self.injected = injected


class NonFiniteStateError(ServingFault):
    """Recurrent state / output frames went NaN or Inf.  ``where`` names
    the check point (e.g. "prompt", "prefill state", "decode frame")."""

    def __init__(self, msg: str, *, uids: Sequence[int] = (),
                 slot: Optional[int] = None, where: str = "state"):
        super().__init__(msg, uids=uids, slot=slot)
        self.where = where


class PlanRejected(ServingFault, ValueError):
    """The planned path cannot serve this request/configuration (shape,
    family, or state-surface mismatch).  Also a ValueError: rejection is
    a property of the input, not a runtime failure."""


class PlanInvariantError(ServingFault):
    """A ``DispatchPlan`` failed static verification.

    Raised by ``analysis.plancheck`` (and by planner-internal consistency
    checks) with no execution involved: ``rule`` names the violated
    invariant (one of ``analysis.plancheck.RULES`` plus the planner's
    "decode-cost-model" and the engine's "decode-active-rows"), ``slot``
    the plan slot it anchors to (None for plan-level rules), and ``cell``
    the offending ``(uid, layer, chunk, direction)`` cell when one exists.
    """

    def __init__(self, msg: str, *, rule: str, uids: Sequence[int] = (),
                 slot: Optional[int] = None, cell=None):
        super().__init__(msg, uids=uids, slot=slot)
        self.rule = rule
        self.cell = cell


class RequestTimeout(ServingFault):
    """A per-request or engine-level deadline expired.  ``done`` carries
    the completions already finished (never lose completed work on an
    overrun); ``uids`` the requests still in flight."""

    def __init__(self, msg: str, *, uids: Sequence[int] = (),
                 done: Optional[list] = None):
        super().__init__(msg, uids=uids)
        self.done = list(done) if done is not None else []


class QueueFull(ServingFault):
    """Bounded admission queue at capacity under backpressure="reject"."""


class DeviceUnavailable(ServingFault):
    """An entry point was asked for a CUDA device the process cannot
    reach.  The port never moves to the CPU on its own: the message names
    ``device="cpu"``, which the caller passes to run the plain versions."""


# ---------------------------------------------------------------------------
# fault injection + degradation accounting
# ---------------------------------------------------------------------------


@dataclass
class FaultInjector:
    """Makes executor launches raise on demand (CPU-provable recovery).

    ``fail_launch_at`` holds plan slot indices whose launch attempts
    raise an (injected) ``LaunchError``; ``fail_through_level`` is the
    deepest ladder rung that still fails (0 = only the fused attempt
    fails, so the per-step rung recovers; 1 = every rung fails on the
    card; 2 = every rung fails on either device, and the error escapes
    even under ``on_fault="fallback"``).  With ``once``
    (the ``ft.failure_at_steps`` semantics) an armed index is discarded
    after its final failing rung fires — ``fail_through_level``, or the
    ladder's last rung where the ladder is shorter (per_step on the card)
    — so a retry succeeds; bench/soak callers set ``once=False`` to
    degrade every call.
    """

    fail_launch_at: Set[int] = field(default_factory=set)
    fail_through_level: int = 0
    once: bool = True
    fired: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def armed(self) -> bool:
        return bool(self.fail_launch_at)

    def arm(self, slots: Sequence[int], *, through_level: int = 0,
            once: bool = True) -> None:
        self.fail_launch_at = set(slots)
        self.fail_through_level = through_level
        self.once = once

    def disarm(self) -> None:
        self.fail_launch_at = set()

    def maybe_fail(self, slot_index: int, level: int, uids: Sequence[int],
                   *, last_level: int) -> None:
        """Called by the executor before each launch attempt;
        ``last_level`` is the deepest rung of the slot's ladder."""
        if slot_index not in self.fail_launch_at:
            return
        if level > self.fail_through_level:
            return
        self.fired.append((slot_index, level))
        if self.once and level >= min(self.fail_through_level, last_level):
            self.fail_launch_at.discard(slot_index)
        raise LaunchError(
            f"injected launch fault: slot {slot_index} at ladder level "
            f"{FALLBACK_LEVELS[level]!r} (uids {sorted(set(uids))})",
            uids=uids, slot=slot_index, level=FALLBACK_LEVELS[level],
            injected=True)


def not_ported(feature: str, item: str) -> NotImplementedError:
    """The error for a feature of the JAX package the port does not carry
    yet; ``item`` names its entry in ROADMAP.md's "Queued in the port"
    list.  The port never falls back silently to something else."""
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet (ROADMAP.md, "
        f"'Queued in the port', item {item})")


@dataclass
class ExecutionReport:
    """Per-execute() degradation record (folded into ``StackStats``).

    ``degraded_launches`` counts slots that needed any fallback rung;
    ``fallback_level`` is the deepest rung used (index into
    ``FALLBACK_LEVELS``); ``faults`` is the human-readable fault trail
    (one entry per recovered launch failure)."""

    degraded_launches: int = 0
    fallback_level: int = 0
    faults: List[str] = field(default_factory=list)

    def record(self, slot_index: int, level: int, cause: Exception) -> None:
        self.degraded_launches += 1
        self.fallback_level = max(self.fallback_level, level)
        self.faults.append(
            f"slot {slot_index}: fell back to "
            f"{FALLBACK_LEVELS[level]!r} after {cause!r}")


__all__ = ["ServingFault", "LaunchError", "NonFiniteStateError",
           "PlanRejected", "PlanInvariantError", "RequestTimeout",
           "QueueFull", "DeviceUnavailable", "FaultInjector",
           "ExecutionReport", "FALLBACK_LEVELS", "not_ported"]
