"""The port's tracer (``repro_torch.runtime.obs``) on the CPU.

A traced engine run: one ``serve.step`` span a step, with the tick's
pieces (gather, decode tick, check, scatter, readback, deliver, retire)
and the admission wave's (admit, splice, prefill, plan miss, verify,
execute) nested under it; self times and the children's walls adding up
to each parent's wall; ``totals()`` agreeing with the spans; outputs bit
for bit those of an untraced run; no span waiting on the device; and
every span a ``repro_torch.<name>`` range in a ``torch.profiler`` trace,
on the profiler's clock.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from repro_torch import rnn
from repro_torch.configs.sharp_lstm import lstm_config
from repro_torch.models.layers.lstm import init_lstm_stack
from repro_torch.runtime import obs
from repro_torch.runtime.obs import NULL_TRACER, RANGE_PREFIX, Tracer
from repro_torch.serving import RecurrentRequest, RecurrentServingEngine

H = 16
CFG = lstm_config(H, layers=2)
#: (prompt length, frames to generate) of each request; four requests on
#: three slots, so the last is admitted in a second wave mid-run
REQUESTS = ((5, 4), (3, 6), (7, 2), (4, 3))
#: the spans of one decoding step, each a child of its ``serve.step``
TICK = ("serve.gather", "decode_tick", "serve.check", "serve.scatter",
        "serve.readback", "serve.deliver")
PARENTS = {
    "serve.gather": {"serve.step"}, "decode_tick": {"serve.step"},
    "serve.check": {"serve.step"}, "serve.scatter": {"serve.step"},
    "serve.readback": {"serve.step"}, "serve.deliver": {"serve.step"},
    "serve.retire": {"serve.step"}, "admit": {"serve.step"},
    "prefill": {"admit"}, "serve.splice": {"admit"},
    "plan_miss": {"prefill", "decode_tick"}, "plan": {"plan_miss"},
    "verify": {"plan_miss"}, "prepare": {"decode_tick"},
    "execute": {"prefill", "decode_tick", "forward"},
    "hoist": {"execute"}, "slot_launch": {"execute"},
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return init_lstm_stack(torch.Generator().manual_seed(0), CFG,
                           "float32")


def _serve(params, trace: bool):
    """Serve REQUESTS to the end; returns the engine, its completions by
    uid and the number of steps taken."""
    eng = RecurrentServingEngine(CFG, params, max_batch=3, device="cpu",
                                 trace=trace)
    rng = np.random.default_rng(0)
    for uid, (T, new) in enumerate(REQUESTS):
        eng.submit(RecurrentRequest(
            uid=uid, frames=rng.standard_normal((T, H)).astype(np.float32),
            max_new_frames=new))
    steps = 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        steps += 1
    return eng, {c.uid: c for c in eng.done}, steps


def _timed(events):
    return [e for e in events if e.dur_us is not None and e.track == "exec"]


def test_engine_step_spans_nest_the_tick_and_the_wave(params):
    eng, done, steps = _serve(params, trace=True)
    assert all(c.status == "ok" for c in done.values())
    tr = eng.tracer
    totals = tr.totals()
    assert totals["serve.step"]["count"] == steps
    assert eng.decode_ticks > 0
    for name in TICK:
        assert totals[name]["count"] == eng.decode_ticks, name
    assert totals["admit"]["count"] == eng.prefill_waves == 2
    assert totals["serve.splice"]["count"] == len(REQUESTS)
    assert totals["prepare"]["count"] == 1
    assert totals["plan_miss"]["count"] == eng.compiled.stats.plans_built
    # every span under the parent its layer gives it; steps at the top
    for sp in _timed(tr.events):
        if sp.name == "serve.step":
            assert sp.parent is None and sp.depth == 0
        else:
            assert sp.parent is not None, sp.name
            assert sp.parent.name in PARENTS[sp.name], (sp.name,
                                                        sp.parent.name)
            assert sp.depth == sp.parent.depth + 1
            assert sp.parent.start_us <= sp.start_us
    # a decoding step holds each piece of the tick once, in order
    kids = defaultdict(list)
    for sp in _timed(tr.events):
        if sp.parent is not None:
            kids[id(sp.parent)].append(sp.name)
    ticks = [kids[id(sp)] for sp in _timed(tr.events)
             if sp.name == "serve.step" and "decode_tick" in kids[id(sp)]]
    assert len(ticks) == eng.decode_ticks
    for names in ticks:
        assert [n for n in names if n in TICK] == list(TICK)
    uids = sorted(sp.tags["uid"] for sp in tr.events
                  if sp.name == "serve.splice")
    assert uids == list(range(len(REQUESTS)))
    assert "serve.step: n=" in eng.compiled.describe()


def test_self_and_children_add_up_to_the_wall(params):
    eng, _, _ = _serve(params, trace=True)
    spans = _timed(eng.tracer.events)
    child_wall = defaultdict(float)
    for sp in spans:
        if sp.parent is not None:
            child_wall[id(sp.parent)] += sp.dur_us
    for sp in spans:
        assert sp.self_us >= -1e-6, sp.name
        assert sp.self_us + child_wall[id(sp)] == pytest.approx(
            sp.dur_us, rel=0.01, abs=1e-6), sp.name
    for name, t in eng.tracer.totals().items():
        assert t["self_us"] <= t["wall_us"] * (1 + 1e-9), name


def test_totals_diff_matches_the_spans_between(params):
    eng = RecurrentServingEngine(CFG, params, max_batch=3, device="cpu",
                                 trace=True)
    rng = np.random.default_rng(1)
    for uid, (T, new) in enumerate(REQUESTS):
        eng.submit(RecurrentRequest(
            uid=uid, frames=rng.standard_normal((T, H)).astype(np.float32),
            max_new_frames=new))
    eng.step()
    eng.step()
    tr = eng.tracer
    before, seen = tr.totals(), len(tr.events)
    for _ in range(3):
        eng.step()
    after = tr.totals()
    window = list(tr.events)[seen:]
    want = defaultdict(lambda: [0, 0.0, 0.0])
    for sp in window:
        if sp.dur_us is None:
            continue
        w = want[sp.name]
        w[0] += 1
        w[1] += sp.dur_us
        w[2] += sp.self_us
    assert want["serve.step"][0] == 3
    zero = {"count": 0, "wall_us": 0.0, "self_us": 0.0}
    for name in set(after) | set(want):
        a, b = after.get(name, zero), before.get(name, zero)
        c, w, s = want[name]
        assert a["count"] - b["count"] == c, name
        assert a["wall_us"] - b["wall_us"] == pytest.approx(w, abs=1e-3)
        assert a["self_us"] - b["self_us"] == pytest.approx(s, abs=1e-3)


def test_engine_outputs_bit_identical_with_tracing_on_and_off(params):
    _, off, _ = _serve(params, trace=False)
    eng, on, _ = _serve(params, trace=True)
    assert eng.tracer.enabled and len(eng.tracer.events) > 0
    assert sorted(on) == sorted(off)
    for uid in off:
        np.testing.assert_array_equal(on[uid].outputs, off[uid].outputs)
        np.testing.assert_array_equal(on[uid].generated,
                                      off[uid].generated)


def test_no_span_waits_on_the_device(params, monkeypatch):
    calls = []

    def counting_fence(value):
        calls.append("fence")
        return value

    monkeypatch.setattr(obs, "fence", counting_fence)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("synchronize"))
    eng, _, _ = _serve(params, trace=True)
    assert eng.tracer.totals()["serve.step"]["count"] > 0
    cs = rnn.compile(params, rnn.ExecutionPolicy(trace=True), device="cpu")
    rng = np.random.default_rng(2)
    seqs = [torch.from_numpy(rng.standard_normal((1, T, H))
                             .astype(np.float32)) for T in (4, 9)]
    cs.prefill(seqs)
    assert cs.tracer.totals()["execute"]["count"] == 1
    assert calls == []


def _profiled(fn):
    """Run ``fn`` under a CPU ``torch.profiler``; returns its result, the
    trace's complete events and its base time in µs since the epoch."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    return out, events, trace.get("baseTimeNanoseconds", 0) / 1e3


def test_spans_are_profiler_ranges_on_the_profilers_clock(params):
    _serve(params, trace=True)  # the first profiled ranges cost more
    (eng, _, _), events, base_us = _profiled(lambda: _serve(params, True))
    ranges = defaultdict(list)
    for e in events:
        if e["name"].startswith(RANGE_PREFIX):
            assert e.get("cat") in ("cpu_op", "user_annotation"), e
            ranges[e["name"][len(RANGE_PREFIX):]].append(
                float(e["ts"]) + base_us)
    spans = defaultdict(list)
    for sp in _timed(eng.tracer.events):
        spans[sp.name].append(sp.start_us)
    assert set(spans) >= set(TICK) | {"serve.step", "admit", "serve.splice",
                                      "plan_miss", "execute"}
    assert set(ranges) == set(spans)
    for name, starts in spans.items():
        got = sorted(ranges[name])
        assert len(got) == len(starts), name
        gaps = np.abs(np.array(got) - np.array(sorted(starts)))
        assert gaps.max() < 50.0, (name, gaps.max())


def test_untraced_program_opens_ranges_only_under_the_profiler(params):
    assert NULL_TRACER.span("serve.step") is NULL_TRACER.span("x")
    (eng, done, _), events, _ = _profiled(lambda: _serve(params, False))
    assert eng.tracer is NULL_TRACER and NULL_TRACER.events == ()
    assert NULL_TRACER.totals() == {}
    names = {e["name"] for e in events}
    for name in TICK + ("serve.step", "admit", "execute", "slot_launch"):
        assert RANGE_PREFIX + name in names, name
    assert all(c.status == "ok" for c in done.values())


def test_events_are_bounded_and_totals_are_not(monkeypatch):
    monkeypatch.setattr(obs, "MAX_EVENTS", 8)
    tr = Tracer()
    for i in range(20):
        with tr.span("outer", i=i):
            with tr.span("inner"):
                pass
    assert len(tr.events) == 8
    assert tr.describe().startswith("trace: 40 spans (8 events kept)")
    t = tr.totals()
    assert t["outer"]["count"] == t["inner"]["count"] == 20
    assert t["outer"]["wall_us"] >= t["inner"]["wall_us"]
    assert [sp.name for sp in tr.events][-2:] == ["inner", "outer"]


def test_chrome_trace_is_stamped_on_the_epoch(tmp_path, params):
    now_us = time.time_ns() / 1e3
    eng, _, _ = _serve(params, trace=True)
    path = eng.tracer.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    names = {e["name"] for e in xs}
    assert {"serve.step", "request", "slot_launch"} <= names
    assert all(abs(e["ts"] - now_us) < 60e6 for e in xs)


def test_hoist_spans_tag_the_cells_and_products_they_assemble(params):
    """Every ``hoist`` span carries ``cells`` (the cells whose operands it
    assembled) and ``gemms`` (the input products it issued): one span for
    layer 0's products, one GEMM for the stack, before the slots; a
    slot's, one batched product when it holds a deeper layer's cells and
    none otherwise; a decode tick's, the tick's layer-0 product."""
    cs = rnn.compile(params, rnn.ExecutionPolicy(trace=True, block_t=2),
                     device="cpu")
    rng = np.random.default_rng(3)
    seqs = [torch.from_numpy(rng.standard_normal((1, T, H))
                             .astype(np.float32)) for T in (4, 9, 5)]
    res = cs.prefill(seqs)
    p = cs.plan
    hoists = [sp for sp in _timed(cs.tracer.events) if sp.name == "hoist"]
    first = [sp for sp in hoists if sp.tags.get("layer") == 0]
    assert len(first) == 1 and first[0].tags["gemms"] == 1
    assert first[0].tags["cells"] == sum(
        1 for s in p.slots for c in s.cells if c.layer == 0)
    by_slot = {sp.tags["slot"]: sp for sp in hoists if "slot" in sp.tags}
    assert sorted(by_slot) == [s.index for s in p.slots]
    packed = 0
    for s in p.slots:
        tags = by_slot[s.index].tags
        assert tags["cells"] == len(s.cells)
        assert tags["gemms"] == int(any(c.layer > 0 for c in s.cells))
        packed = max(packed, tags["cells"])
    assert packed > 1            # a slot assembled several cells at once
    assert cs.tracer.totals()["hoist"]["count"] == len(p.slots) + 1
    state = {k: torch.cat([st[k] for _, st in res], dim=1)
             for k in ("h", "c")}
    cs.decode(torch.zeros(3, 1, H), state)
    tick = [sp for sp in cs.tracer.events if sp.name == "hoist"][-1]
    assert tick.tags["cells"] == CFG.n_layers * 1
    assert tick.tags["gemms"] == 1
