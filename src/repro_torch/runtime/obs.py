"""Tracing + metrics for the planned execution path (the port of
``repro.runtime.obs``).

The ROADMAP's standing caveat is that the analytic ``perfmodel`` optimizes
a proxy nobody has measured: several launch-count wins are wall-clock
losses and nothing records per-launch timing to say why.  This module is
the instrument — it measures the pipeline the perfmodel only estimates,
and produces the calibration signal the future measured-launch cost model
will consume.

Three cooperating pieces (``time`` + ``json``; torch is used only to
fence and to time device work):

``Tracer``
    Records nested wall-clock spans (``plan``, ``hoist``, ``slot_launch``,
    ``fallback_rung``, ``decode_tick``, ``admit``, ``request`` ...) tagged
    with the slot signature (family, G, B, H, block_t, direction,
    chained), plan id, and request uids.  Launch spans are *fenced*: the
    instrumented call sites run ``tracer.fence(result)`` —
    ``torch.cuda.synchronize`` when the result lies on the card — inside
    the span, so a span's duration is the wall-clock of the work it
    encloses, not of its asynchronous launch.
    Exports: ``export_chrome_trace(path)`` (chrome://tracing /
    ``about:tracing`` trace-event JSON), ``snapshot()`` (machine-readable
    dict), ``describe()`` (text, merged into ``CompiledStack.describe()``).

``MetricsRegistry``
    Counters and streaming histograms (bounded reservoir; nearest-rank
    p50/p90/p99) for launch latency per slot signature, decode tick
    latency, queue depth, slot occupancy, degraded launches.

``LaunchCostTable``
    The predicted-vs-measured record: per slot signature, the perfmodel's
    ``est_cycles`` next to the measured µs distribution, and their ratio
    (cycles per measured µs — flat across signatures iff the analytic
    model ranks shapes correctly; the spread IS the miscalibration).
    ``save()`` persists a ``signature -> measured µs`` table next to the
    autotune table (``artifacts/launch_costs.json``) for the
    measured-launch cost model to consume as its warm-start.

The whole subsystem is opt-in via ``ExecutionPolicy(trace=True)``.  Off
(the default), every instrumented call site holds the module-level
``NULL_TRACER`` whose ``span()`` returns one reused no-op context manager
and whose ``fence()`` is the identity — no events, no fencing, and
executor outputs bit-identical to the un-instrumented code.

``measure_us`` is the one timer (warmup exclusion + CUDA-event timing of
device work + median/min reduction).
"""
from __future__ import annotations

import json
import math
import os
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

#: persisted measured-launch table, next to artifacts/autotune_table.json
LAUNCH_COSTS_PATH = os.path.join("artifacts", "launch_costs.json")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


class Counter:
    """A monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def add(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus a bounded
    reservoir the quantiles are computed over (Vitter's algorithm R with a
    deterministic LCG, so identical observation streams give identical
    snapshots).  Quantiles are nearest-rank over the retained sample —
    exact while ``count <= cap``."""

    __slots__ = ("count", "total", "min", "max", "_sample", "_cap", "_lcg")

    def __init__(self, cap: int = 2048):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._sample: List[float] = []
        self._cap = cap
        self._lcg = 0x2545F4914F6CDD1D

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if len(self._sample) < self._cap:
            self._sample.append(value)
            return
        # deterministic reservoir replacement (64-bit LCG)
        self._lcg = (self._lcg * 6364136223846793005 + 1442695040888963407) \
            & 0xFFFFFFFFFFFFFFFF
        j = self._lcg % self.count
        if j < self._cap:
            self._sample[j] = value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the retained sample (q in [0, 1])."""
        if not self._sample:
            return 0.0
        vals = sorted(self._sample)
        rank = max(1, math.ceil(q * len(vals)))
        return vals[min(rank, len(vals)) - 1]

    def snapshot(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def describe(self) -> str:
        if not self.count:
            return "n=0"
        return (f"n={self.count} mean={self.mean:.1f} p50="
                f"{self.quantile(.5):.1f} p90={self.quantile(.9):.1f} "
                f"p99={self.quantile(.99):.1f} max={self.max:.1f}")


class MetricsRegistry:
    """Named counters + histograms with text and dict export."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self._hists.items())},
        }

    def describe(self) -> str:
        lines = []
        if self._counters:
            lines.append("counters: " + " ".join(
                f"{k}={c.value}" for k, c in sorted(self._counters.items())))
        for k, h in sorted(self._hists.items()):
            lines.append(f"{k}: {h.describe()}")
        return "\n".join(lines) if lines else "metrics: (none)"


# ---------------------------------------------------------------------------
# predicted vs measured
# ---------------------------------------------------------------------------


class LaunchCostTable:
    """Per-slot-signature measured launch cost next to the perfmodel's
    estimate.  ``cycles_per_us = est_cycles / median measured µs`` is the
    calibration signal: if the analytic model were right up to one clock
    constant, the ratio would be flat across signatures — the spread is
    exactly what the measured-launch cost model (ROADMAP) must correct."""

    def __init__(self):
        self._est: Dict[str, float] = {}
        self._us: Dict[str, Histogram] = {}

    def record(self, sig: str, est_cycles: float, us: float) -> None:
        self._est[sig] = float(est_cycles)
        h = self._us.get(sig)
        if h is None:
            h = self._us[sig] = Histogram()
        h.observe(us)

    def __len__(self) -> int:
        return len(self._us)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for sig in sorted(self._us):
            h = self._us[sig]
            med = h.quantile(0.5)
            out[sig] = {"n": h.count, "med_us": med,
                        "p90_us": h.quantile(0.9),
                        "est_cycles": self._est[sig],
                        "cycles_per_us": (self._est[sig] / med
                                          if med > 0 else 0.0)}
        return out

    def describe(self) -> str:
        rows = self.snapshot()
        if not rows:
            return "launch costs: (none measured)"
        lines = ["launch costs (predicted vs measured):"]
        for sig, r in rows.items():
            lines.append(
                f"  {sig}: n={r['n']} med={r['med_us']:.1f}us "
                f"est={r['est_cycles']:.0f}cy "
                f"ratio={r['cycles_per_us']:.2f}cy/us")
        return "\n".join(lines)

    def save(self, path: str = LAUNCH_COSTS_PATH) -> str:
        """Persist ``signature -> measured µs summary`` (merging with an
        existing table: this run's signatures overwrite, unseen ones are
        kept — the same accumulate-across-runs contract as the autotune
        table next door)."""
        merged: Dict[str, Dict[str, float]] = {}
        if os.path.exists(path):
            with open(path) as f:
                merged = json.load(f).get("signatures", {})
        merged.update(self.snapshot())
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"signatures": merged}, f, indent=1, sort_keys=True)
        return path

    @staticmethod
    def load(path: str = LAUNCH_COSTS_PATH) -> Dict[str, Dict[str, float]]:
        with open(path) as f:
            return json.load(f)["signatures"]


# ---------------------------------------------------------------------------
# spans + tracer
# ---------------------------------------------------------------------------


class Span:
    """One completed (or in-flight) traced region.  Context manager:
    entering stamps ``start_us``, exiting stamps ``dur_us`` and files the
    span with its tracer.  ``depth`` is the nesting level at entry (the
    span-tree proof the tests assert)."""

    __slots__ = ("name", "track", "tags", "start_us", "dur_us", "depth",
                 "_tracer")

    def __init__(self, tracer: "Tracer", name: str, track: str, tags: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.tags = tags
        self.start_us: float = 0.0
        self.dur_us: Optional[float] = None
        self.depth: int = 0

    def tag(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    def __enter__(self) -> "Span":
        self.depth = len(self._tracer._stack)
        self._tracer._stack.append(self)
        self.start_us = self._tracer.now_us()
        return self

    def __exit__(self, *exc) -> None:
        self.dur_us = self._tracer.now_us() - self.start_us
        self._tracer._stack.pop()
        self._tracer.events.append(self)


class _NullSpan:
    """The reused no-op span NULL_TRACER hands out (overhead: one attribute
    lookup + two no-op calls per instrumented region)."""

    __slots__ = ()
    name = track = ""
    tags: dict = {}
    start_us = 0.0
    dur_us = None
    depth = 0

    def tag(self, **tags) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Nested wall-clock span recorder + metrics + launch-cost table.

    Timestamps are µs since tracer construction (``time.perf_counter``
    based).  Spans nest per the call stack (single-threaded, like the
    executor); retroactive spans (``span_at``) and instants land on named
    *tracks* — chrome://tracing rows — so per-request admit→retire spans
    live on a "requests" track beside the "exec" track's launches."""

    enabled = True

    def __init__(self):
        self._t0 = time.perf_counter()
        self.events: List[Span] = []
        self._stack: List[Span] = []
        self.metrics = MetricsRegistry()
        self.launch_costs = LaunchCostTable()
        self._plan_ids: Dict[int, int] = {}

    # -- time ----------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def fence(self, value):
        """``fence(value)`` — call INSIDE a span so its duration measures
        the enclosed work, not its asynchronous launch."""
        return fence(value)

    # -- recording -----------------------------------------------------
    def span(self, name: str, track: str = "exec", **tags) -> Span:
        return Span(self, name, track, tags)

    def span_at(self, name: str, start_us: float, end_us: float,
                track: str = "exec", **tags) -> Span:
        """File an already-elapsed span (e.g. a request's admit→retire
        lifetime, closed at retirement)."""
        sp = Span(self, name, track, tags)
        sp.start_us = start_us
        sp.dur_us = max(0.0, end_us - start_us)
        self.events.append(sp)
        return sp

    def instant(self, name: str, track: str = "exec", **tags) -> Span:
        """A zero-duration marker (fault, straggler, candidate scores)."""
        sp = Span(self, name, track, tags)
        sp.start_us = self.now_us()
        self.events.append(sp)
        return sp

    def plan_id(self, plan) -> int:
        """Small stable id for a plan object (plans are cached and live as
        long as their CompiledStack, so id() aliasing is not a concern)."""
        pid = self._plan_ids.get(id(plan))
        if pid is None:
            pid = len(self._plan_ids)
            self._plan_ids[id(plan)] = pid
        return pid

    def observe_launch(self, sig: str, est_cycles: float,
                       dur_us: float) -> None:
        """One measured launch: feeds both the per-signature latency
        histogram and the predicted-vs-measured table."""
        self.metrics.histogram(f"launch_us/{sig}").observe(dur_us)
        self.launch_costs.record(sig, est_cycles, dur_us)

    # -- export --------------------------------------------------------
    def export_chrome_trace(self, path: str) -> str:
        """Write chrome://tracing (about:tracing / Perfetto) trace-event
        JSON: complete ("X") events for spans, instant ("i") events for
        markers, metadata thread names for tracks."""
        tracks = {"exec": 0}
        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "repro_torch"}},
        ]
        for sp in self.events:
            tid = tracks.setdefault(sp.track, len(tracks))
            ev = {"name": sp.name, "pid": 0, "tid": tid,
                  "ts": round(sp.start_us, 3), "args": sp.tags}
            if sp.dur_us is None:
                ev.update(ph="i", s="t")
            else:
                ev.update(ph="X", dur=round(sp.dur_us, 3))
            events.append(ev)
        for track, tid in tracks.items():
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tid, "args": {"name": track}})
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path

    def snapshot(self) -> Dict[str, Any]:
        """Machine-readable state: span count, metrics (counters +
        histogram quantiles), the per-signature launch-cost table, and the
        aggregate predicted-vs-measured ratio."""
        costs = self.launch_costs.snapshot()
        ratios = [r["cycles_per_us"] for r in costs.values()
                  if r["cycles_per_us"] > 0]
        return {
            "spans": len(self.events),
            "metrics": self.metrics.snapshot(),
            "launch_costs": costs,
            "predicted_vs_measured": {
                "signatures": len(ratios),
                "mean_cycles_per_us": (sum(ratios) / len(ratios)
                                       if ratios else 0.0),
                "spread": (max(ratios) / min(ratios)
                           if len(ratios) > 1 and min(ratios) > 0 else 1.0),
            },
        }

    def describe(self) -> str:
        lines = [f"trace: {len(self.events)} spans"]
        lines += self.metrics.describe().splitlines()
        lines += self.launch_costs.describe().splitlines()
        return "\n".join(lines)


class NullTracer:
    """The disabled tracer: every hook is a no-op, ``enabled`` is False so
    instrumented sites skip fencing/metric work entirely.  One shared
    instance (``NULL_TRACER``) serves every untraced stack."""

    enabled = False

    def __init__(self):
        self.events: List[Span] = ()  # immutable: nothing ever records
        self.metrics = MetricsRegistry()
        self.launch_costs = LaunchCostTable()

    def now_us(self) -> float:
        return 0.0

    def fence(self, value):
        return value

    def span(self, name: str, track: str = "exec", **tags) -> _NullSpan:
        return _NULL_SPAN

    def span_at(self, name, start_us, end_us, track="exec",
                **tags) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name, track="exec", **tags) -> _NullSpan:
        return _NULL_SPAN

    def plan_id(self, plan) -> int:
        return 0

    def observe_launch(self, sig, est_cycles, dur_us) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"spans": 0, "metrics": self.metrics.snapshot(),
                "launch_costs": {}, "predicted_vs_measured": {
                    "signatures": 0, "mean_cycles_per_us": 0.0,
                    "spread": 1.0}}

    def describe(self) -> str:
        return "trace: disabled"


NULL_TRACER = NullTracer()


def as_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Normalize an optional tracer kwarg: None -> the shared no-op."""
    return NULL_TRACER if tracer is None else tracer


# ---------------------------------------------------------------------------
# the one benchmark timer (and the serving path's one clock)
# ---------------------------------------------------------------------------


def monotonic_s() -> float:
    """Monotonic seconds — the serving/runtime layers' one wall-clock for
    deadlines and tick durations.  ``analysis.repolint`` (rule
    timing-outside-obs) bans direct ``time.*`` calls on those paths so
    every measurement funnels through this module's discipline; interval
    consumers call this instead."""
    return time.monotonic()


def _on_cuda(value) -> bool:
    """True when ``value`` (a tensor or a nest of dicts/lists/tuples of
    them) holds a tensor on a CUDA device."""
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, dict):
        return any(_on_cuda(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_on_cuda(v) for v in value)
    return False


def fence(value):
    """Wait for the device work behind ``value``: ``torch.cuda.synchronize``
    when it holds a CUDA tensor, a no-op for CPU tensors (which are ready
    when the call returns).  Returns ``value``."""
    if _on_cuda(value):
        torch.cuda.synchronize()
    return value


def measure_samples(fn: Callable, *args, repeats: int = 3, warmup: int = 1,
                    **kwargs) -> List[float]:
    """The raw samples behind ``measure_us``: ``warmup`` untimed calls
    (build/plan-cache exclusion), then ``repeats`` timed calls, returned
    as a list of µs.  A call whose result lies on the card is timed with
    CUDA events recorded on the current stream around it (the device's
    clock); a call that returns CPU tensors with the host clock."""
    for _ in range(max(0, warmup)):
        fn(*args, **kwargs)
    cuda = torch.cuda.is_available()
    ts = []
    for _ in range(max(1, repeats)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if cuda and _on_cuda(out):
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3)
        else:
            ts.append((time.perf_counter() - t0) * 1e6)
    return ts


def measure_us(fn: Callable, *args, repeats: int = 3, warmup: int = 1,
               reduce: str = "median", **kwargs) -> float:
    """Time ``fn(*args)`` through ``measure_samples``, reduced by
    ``median`` (default) or ``min``.  Returns µs."""
    if reduce not in ("median", "min"):
        raise ValueError(f"measure_us: reduce={reduce!r} invalid; "
                         "allowed: median, min")
    ts = measure_samples(fn, *args, repeats=repeats, warmup=warmup, **kwargs)
    red = statistics.median if reduce == "median" else min
    return red(ts)


def slot_signature(family: str, H: int, G: int, B: int, chunk_len: int,
                   dtype: str, directions: Sequence[str] = ("fwd",),
                   chained: bool = False, precision: str = "fp32") -> str:
    """The canonical slot-signature string every layer tags launches with
    (and the launch-cost table keys on): family, G-batch width, padded B,
    H, T-stripe, dtype, direction mix, precision, chained flag.  The
    precision token (``|pint8`` / ``|pbf16``) is emitted only for
    non-fp32, so pre-existing persisted signatures stay valid — and an
    int8 measurement can never key an fp32 lookup."""
    dirs = "+".join(sorted(set(directions)))
    sig = f"{family}|H{H}|G{G}|B{B}|bt{chunk_len}|{dtype}|{dirs}"
    if precision != "fp32":
        sig += f"|p{precision}"
    return sig + "|chained" if chained else sig


__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "as_tracer", "Span",
           "Counter", "Histogram", "MetricsRegistry", "LaunchCostTable",
           "LAUNCH_COSTS_PATH", "measure_us", "measure_samples",
           "monotonic_s", "fence", "slot_signature"]
