"""Tracing for the planned execution path (the port of
``repro.runtime.obs``), and the one timer of the port's measurements.

``Tracer``
    Records nested host-clock spans (``plan``, ``plan_miss``, ``verify``,
    ``execute``, ``hoist``, ``slot_launch``, ``decode_tick``,
    ``serve.step`` ...) tagged with the slot signature, launch counts
    and request uids.  A span measures the host's own time: the call sites
    never wait on the device for the tracer's sake, so a traced program
    issues the same work in the same order as an untraced one, and a
    span holds a wait on the device only where the program itself makes
    one (a ``.cpu()``, a ``.tolist()``).  The device's time is the
    profiler's to measure: while ``torch.profiler`` records, every span
    also opens a profiler range named ``repro_torch.<span name>``, and
    the tracer stamps its spans on the profiler's clock (µs since the
    epoch), so its own trace and a profiler trace of the same run line
    up.

    Each span records its parent.  ``totals()`` gives, per span name,
    the count, the wall µs and the self µs (the wall less the time its
    children cover), summed over every span the tracer closed; like
    ``CompiledStack.stats`` the totals only grow, so a caller diffs two
    readings.  Raw spans are kept for ``export_chrome_trace`` (chrome://
    tracing / Perfetto trace-event JSON), the newest ``MAX_EVENTS`` only,
    so a long-running traced server holds bounded memory; ``describe()``
    prints the totals (merged into ``CompiledStack.describe()``).

The tracer is opt-in via ``ExecutionPolicy(trace=True)``.  Off (the
default), every instrumented call site holds the module-level
``NULL_TRACER``, whose ``span()`` returns one reused no-op context
manager (or, while ``torch.profiler`` records, a bare profiler range of
the same name): no events, no totals, and outputs bit-identical to the
traced path.

``measure_us`` is the one timer (warmup exclusion + CUDA-event timing of
device work + median/min reduction); ``fence`` waits for the device work
behind a value, for the callers that time a whole step on the host.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.autograd.profiler as _autograd_profiler

try:  # a range for ~1 µs, where record_function takes ~10
    from torch._C._profiler import _RecordFunctionFast as _ProfilerRange
except ImportError:  # older torch
    from torch.autograd.profiler import record_function as _ProfilerRange

#: the prefix of every profiler range a span opens
RANGE_PREFIX = "repro_torch."

#: raw spans and instants a tracer keeps, the newest: a flight recorder
#: for ``export_chrome_trace`` (a longer timeline is the profiler's, where
#: every span is a range).  Kept spans cost host time: serving RLDRADSPR
#: streams on an H100, a traced engine ran 1.7% below an untraced one
#: keeping none, 3.0% keeping 4,096, 3.3% keeping 65,536.  The totals
#: count every span whatever this holds.
MAX_EVENTS = 1024

#: the spans' clock: monotonic ns, shifted onto the epoch by each tracer
_now_ns = time.perf_counter_ns


# ---------------------------------------------------------------------------
# spans + tracer
# ---------------------------------------------------------------------------


class Span:
    """One completed (or in-flight) traced region.  Context manager:
    entering notes the enclosing span as ``parent`` and stamps the start
    (``start_us``: µs since the epoch, the profiler's clock); exiting
    stamps ``dur_us``, adds the wall to the parent's children and files
    the span with its tracer."""

    __slots__ = ("name", "track", "tags", "start_ns", "dur_us", "parent",
                 "_child_us", "_range", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, track: str, tags: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.tags = tags
        self.dur_us: Optional[float] = None

    def tag(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    @property
    def start_us(self) -> float:
        return (self.start_ns + self._tracer._epoch_ns) / 1e3

    @property
    def depth(self) -> int:
        """The nesting level: 0 for a span opened outside any other."""
        d, p = 0, self.parent
        while p is not None:
            d, p = d + 1, p.parent
        return d

    @property
    def self_us(self) -> float:
        """The wall less the walls of the spans nested in this one."""
        return (self.dur_us or 0.0) - self._child_us

    def __enter__(self) -> "Span":
        tracer = self._tracer
        self.parent = tracer._open
        tracer._open = self
        self._child_us = 0.0
        if _autograd_profiler._is_profiler_enabled:
            self._range = _ProfilerRange(RANGE_PREFIX + self.name)
            self._range.__enter__()
        else:
            self._range = None
        self.start_ns = _now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = self.dur_us = (_now_ns() - self.start_ns) / 1e3
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        tracer = self._tracer
        parent = tracer._open = self.parent
        if parent is not None:
            parent._child_us += dur
        t = tracer._totals.get(self.name)
        if t is None:
            t = tracer._totals[self.name] = [0, 0.0, 0.0]
        t[0] += 1
        t[1] += dur
        t[2] += dur - self._child_us
        tracer.events.append(self)


class _NullSpan:
    """The reused no-op span NULL_TRACER hands out."""

    __slots__ = ()
    name = track = ""
    tags: dict = {}
    start_us = 0.0
    dur_us = None
    depth = 0
    parent = None

    def tag(self, **tags) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _RangeSpan(_NullSpan):
    """What NULL_TRACER hands out while the profiler records: a bare
    profiler range under the span's name, recording nothing else."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = _ProfilerRange(RANGE_PREFIX + name)

    def __enter__(self) -> "_RangeSpan":
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)


class Tracer:
    """Nested host-clock span recorder with running per-name totals.

    Spans nest per the call stack (single-threaded, like the executor);
    retroactive spans (``span_at``) and instants land on named *tracks*
    (chrome://tracing rows), so per-request admit→retire spans live on a
    "requests" track beside the "exec" track's launches."""

    enabled = True

    def __init__(self):
        # the profiler's clock is the epoch's; time spans on the monotonic
        # counter and shift it there once, so a span never runs backwards
        self._epoch_ns = time.time_ns() - _now_ns()
        self.events = collections.deque(maxlen=MAX_EVENTS)
        self._open: Optional[Span] = None  # the innermost open span
        self._totals: Dict[str, List[float]] = {}

    # -- time ----------------------------------------------------------
    def now_us(self) -> float:
        """µs since the epoch, as the profiler's trace counts them (its
        ``ts`` + ``baseTimeNanoseconds`` / 1e3)."""
        return (_now_ns() + self._epoch_ns) / 1e3

    # -- recording -----------------------------------------------------
    def span(self, name: str, track: str = "exec", **tags) -> Span:
        return Span(self, name, track, tags)

    def span_at(self, name: str, start_us: float, end_us: float,
                track: str = "exec", **tags) -> Span:
        """File an already-elapsed span (e.g. a request's admit→retire
        lifetime, closed at retirement)."""
        sp = self._closed(name, track, tags,
                          round(start_us * 1e3) - self._epoch_ns)
        sp.dur_us = dur = max(0.0, end_us - start_us)
        t = self._totals.setdefault(name, [0, 0.0, 0.0])
        t[0] += 1
        t[1] += dur
        t[2] += dur
        self.events.append(sp)
        return sp

    def instant(self, name: str, track: str = "exec", **tags) -> Span:
        """A zero-duration marker (fault, straggler, candidate scores)."""
        sp = self._closed(name, track, tags, _now_ns())
        self.events.append(sp)
        return sp

    def _closed(self, name, track, tags, start_ns) -> Span:
        sp = Span(self, name, track, tags)
        sp.start_ns = start_ns
        sp.parent = None
        sp._child_us = 0.0
        sp._range = None
        return sp

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Per span name: ``count``, ``wall_us`` and ``self_us`` summed
        over every span closed so far (instants excluded)."""
        return {k: {"count": int(c), "wall_us": w, "self_us": s}
                for k, (c, w, s) in self._totals.items()}

    # -- export --------------------------------------------------------
    def export_chrome_trace(self, path: str) -> str:
        """Write chrome://tracing (about:tracing / Perfetto) trace-event
        JSON of the kept spans: complete ("X") events for spans, instant
        ("i") events for markers, metadata thread names for tracks."""
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

    def describe(self) -> str:
        closed = sum(int(t[0]) for t in self._totals.values())
        lines = [f"trace: {closed} spans ({len(self.events)} events kept)"]
        for name, t in sorted(self.totals().items(),
                              key=lambda kv: -kv[1]["self_us"]):
            lines.append(f"  {name}: n={t['count']} wall="
                         f"{t['wall_us'] / 1e3:.3f}ms self="
                         f"{t['self_us'] / 1e3:.3f}ms")
        return "\n".join(lines)


class NullTracer:
    """The disabled tracer: every hook is a no-op and ``enabled`` is False,
    so instrumented sites skip their tag work.  One shared instance
    (``NULL_TRACER``) serves every untraced stack."""

    enabled = False
    events = ()  # immutable: nothing ever records

    def now_us(self) -> float:
        return 0.0

    def span(self, name: str, track: str = "exec", **tags) -> _NullSpan:
        if _autograd_profiler._is_profiler_enabled:
            return _RangeSpan(name)
        return _NULL_SPAN

    def span_at(self, name, start_us, end_us, track="exec",
                **tags) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name, track="exec", **tags) -> _NullSpan:
        return _NULL_SPAN

    def totals(self) -> Dict[str, Dict[str, float]]:
        return {}

    def describe(self) -> str:
        return "trace: disabled"


NULL_TRACER = NullTracer()


def as_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Normalize an optional tracer kwarg: None -> the shared no-op."""
    return NULL_TRACER if tracer is None else tracer


#: the tracer of the call in progress, for functional model code that
#: takes none (``models.layers.mamba2``'s prefill span); NULL_TRACER
#: outside ``activate``
_ACTIVE = [NULL_TRACER]


def active_tracer():
    """The tracer ``activate`` made current (NULL_TRACER outside it)."""
    return _ACTIVE[-1]


@contextlib.contextmanager
def activate(tracer):
    """Make ``tracer`` the one ``active_tracer`` returns while the block
    runs (the serving engine wraps its prefill in it)."""
    _ACTIVE.append(tracer)
    try:
        yield tracer
    finally:
        _ACTIVE.pop()


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
    (and the calibration table keys on): family, G-batch width, padded B,
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
           "RANGE_PREFIX", "MAX_EVENTS", "measure_us", "measure_samples",
           "monotonic_s", "fence", "slot_signature"]
