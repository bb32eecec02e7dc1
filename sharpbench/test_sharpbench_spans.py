"""The reduction of a profiler trace, on a hand-made one: kernels go to
the span that launched them, busy time is the union of device
intervals, idle gaps go to what the host was doing."""
from __future__ import annotations

import pytest

from sharpbench.spans import reduce


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_sharpbench_trace_reduction_by_hand():
    events = [
        _x("user_annotation", "sharpbench.window", 0, 1000),
        _x("user_annotation", "sharpbench.step#0", 10, 500),
        _x("user_annotation", "sharpbench.prefill#1", 20, 200),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=1),
        _x("kernel", "seq", 100, 80, corr=1),
        _x("user_annotation", "sharpbench.decode#2", 300, 150),
        _x("cuda_driver", "cuLaunchKernelEx", 310, 5, corr=2),
        _x("kernel", "dec", 320, 100, corr=2),
        _x("cpu_op", "aten::mm", 600, 300),
        _x("kernel", "outside", 1500, 10, corr=3),
    ]
    calls = [("step", 0, 0, 0, 0.0), ("prefill", 0, 0, 0, 40e-6),
             ("decode", 0, 0, 0, 10e-6)]
    r = reduce(events, calls)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(180e-6)
    assert r["kinds"]["prefill"] == {"device_s": pytest.approx(80e-6),
                                     "bound_s": 40e-6, "calls": 1}
    assert r["kinds"]["decode"]["device_s"] == pytest.approx(100e-6)
    assert r["device_ops"][0] == ["dec", pytest.approx(100e-6)]
    gaps = dict(r["idle_gaps"])
    # the gap 420..1000 has its middle in aten::mm, outside every span
    assert gaps["harness: aten::mm"] == pytest.approx(580e-6)
    assert gaps["prefill: host python"] == pytest.approx(100e-6)
    assert gaps["step: host python"] == pytest.approx(140e-6)  # 180..320
