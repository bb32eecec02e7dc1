"""The traced run: the benchmark's own spans around its calls into the
program's layers, and the device timeline from ``torch.profiler``.

``Spans.wrap(obj, "prefill", kind)`` replaces a method on one instance
(never on the class, never in the program's files) by one that runs the
original inside ``record_function("sharpbench.<kind>#<n>")`` and notes
its host wall and the work of its arguments.  Only a traced run
(``--trace 1``) wraps, and there the wrapper synchronises at the call's
end, so the wall covers the device work.  A traced run has two windows:
the first runs without the profiler, for the metrics read on the host's
clock and from the program's counters, and there only a call wrapped
``timed`` is noted (one after which the program synchronises anyway, so
that window runs as an untraced run does); the second runs under the
profiler (``profiling``), for the device's readings, and notes every
wrapped call.

``Spans.stop()`` reads the profiler's Chrome trace: every device
operation (kernels, copies, fills) and the host call that launched it
(joined by CUPTI's correlation id), so a kernel counts for the span in
which it was launched.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from sharpbench import families, roofline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
PREFIX = "sharpbench."
TOP = 10


def call_work(cfg: dict, kind: str, args):
    """(FLOPs, bytes) of one call from its arguments: a prefill's list of
    (B, T, X) requests (or one), or a decode tick's (B, 1, X) input.  A
    family other than the LSTM stacks counts its own calls
    (``families/<family>.py``)."""
    if cfg["family"] != "lstm":
        return families.module(cfg["family"]).call_work(cfg, kind, args)
    if kind == "prefill":
        seqs = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
        items = sum(int(s.shape[-3] if s.ndim == 3 else 1) * int(s.shape[-2])
                    for s in seqs)
        rows = sum(int(s.shape[0]) if s.ndim == 3 else 1 for s in seqs)
        return roofline.call_work(cfg, items, rows, reads_state=False)
    rows = int(args[0].shape[0])
    return roofline.call_work(cfg, rows, rows, reads_state=True)


class Spans:
    """The harness's spans of one run, and the profiler in a traced one."""

    def __init__(self, cfg: dict, traced: bool, device):
        self.cfg = cfg
        self.traced = traced     # the run wraps its calls into the program
        self.profiling = False   # this window runs under torch.profiler
        self.on_card = torch.device(device).type == "cuda"
        self.calls = []  # (kind, wall_s, flops, bytes, bound_s)
        self._prof = None

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    def wrap(self, obj, name: str, kind: str, work: bool = True,
             timed: bool = False):
        orig = getattr(obj, name)
        calls = self.calls
        sync = self._sync if self.traced else (lambda: None)
        cfg = self.cfg

        def traced(*args, **kwargs):
            if not (self.profiling or timed):
                return orig(*args, **kwargs)
            n = len(calls)
            with torch.profiler.record_function(f"{PREFIX}{kind}#{n}"):
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                sync()
                wall = time.perf_counter() - t0
            fl, nb = call_work(cfg, kind, args) if work else (0, 0)
            calls.append((kind, wall, fl, nb,
                          roofline.bound_s(cfg, fl, nb) if work else 0.0))
            return out

        setattr(obj, name, traced)

    def start(self):
        """Start a window: the profiler in a profiling one."""
        if self.profiling:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        self.calls.clear()

    def window(self):
        return torch.profiler.record_function(f"{PREFIX}window")

    def stop(self):
        """Stop the profiler and reduce its trace; None when untraced."""
        if self._prof is None:
            return None
        self._sync()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return reduce(events, self.calls)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, calls):
    """The traced window's device time, busy time, each span kind's
    device time and bound, and the breakdown the result line carries.
    Times in the trace are microseconds."""
    launch_ts, device, host, spans = {}, [], [], []
    win = None
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
        if cat in DEVICE_CATS:
            device.append((ts, dur, e.get("name", ""),
                           (e.get("args") or {}).get("correlation")))
        elif cat in HOST_CATS:
            name = e.get("name", "")
            if cat == "user_annotation" and name == PREFIX + "window":
                win = (ts, ts + dur)
            elif cat == "user_annotation" and name.startswith(PREFIX):
                spans.append((ts, ts + dur, name[len(PREFIX):]))
            host.append((ts, ts + dur, name))
    if win is None:
        return None
    w0, w1 = win
    device = [d for d in device if d[0] < w1 and d[0] + d[1] > w0]
    busy = _merge([(max(a, w0), min(a + d, w1)) for a, d, _, _ in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6

    # each kernel to the innermost benchmark span that launched it
    spans.sort()
    starts = [s[0] for s in spans]
    kinds = defaultdict(lambda: {"device_s": 0.0, "bound_s": 0.0,
                                 "calls": 0})
    seen = set()
    for ts, dur, _, corr in device:
        # a traced call synchronises at its end, so a kernel whose launch
        # the trace did not record ran inside the span that launched it
        t = launch_ts.get(corr, ts)
        k = bisect.bisect_right(starts, t) - 1
        stop, best = k - 64, None
        while k >= 0 and k > stop:
            a, b, name = spans[k]
            if a <= t <= b and not name.startswith("step"):
                best = name
                break
            k -= 1
        if best is None:
            continue
        kind, idx = best.split("#")
        kinds[kind]["device_s"] += dur * 1e-6
        if (best not in seen and int(idx) < len(calls)
                and calls[int(idx)][0] == kind):
            seen.add(best)
            kinds[kind]["bound_s"] += calls[int(idx)][4]
            kinds[kind]["calls"] += 1

    by_name = defaultdict(float)
    for _, dur, name, _ in device:
        by_name[name] += dur * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kinds": dict(kinds),
            "device_ops": [[n[:160], s] for n, s in device_ops],
            "idle_gaps": _idle(busy, w0, w1, host, spans)}


def _innermost(events, starts, t, depth):
    """The latest-starting of ``events`` (sorted by start) that holds
    ``t``, looking back ``depth`` events at most."""
    k = bisect.bisect_right(starts, t) - 1
    for j in range(k, max(k - depth, -1), -1):
        if events[j][0] <= t <= events[j][1]:
            return events[j][2]
    return None


def _idle(busy, w0, w1, host, spans):
    """The device's idle gaps inside the window, summed by what the host
    was doing at each gap's middle: the innermost host operation (or
    Python, where none runs), under the innermost benchmark span."""
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    ops = sorted(h for h in host if not h[2].startswith(PREFIX))
    op_starts = [h[0] for h in ops]
    span_starts = [s[0] for s in spans]
    total = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        op = _innermost(ops, op_starts, mid, 256)
        span = _innermost(spans, span_starts, mid, 64)
        label = (f"{span.split('#')[0] if span else 'harness'}: "
                 f"{op or 'host python'}")
        total[label] += (b - a) * 1e-6
    return [[n, s] for n, s in
            sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
