"""The harness end to end on the CPU at a reduced size: the result line,
the modules a run loads, and the runs it must refuse."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from sharpbench.conftest import ROOT, run_tiny, workloads


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("trace", [False, True])
def test_sharpbench_cell_runs_on_cpu_and_is_correct(workload, trace):
    res = run_tiny(workload, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    section = bench["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in section
            if workload in m.get("workloads", [workload])}
    # on the CPU no kernel runs: the device's readings are absent there
    device_only = {m["name"] for m in section
                   if m["source"] == "device_trace"}
    assert want - device_only <= set(res["metrics"]) <= want
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_sharpbench_run_loads_no_jax_and_no_jax_package():
    """A CPU run of every cell in a fresh process: afterwards no module's
    top-level name is jax, jaxlib, flax or repro (compared whole: the
    program is repro_torch)."""
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
            "from sharpbench.conftest import run_tiny, workloads\n"
            "from sharpbench.run import forbidden_modules\n"
            "for w in workloads():\n"
            "    assert run_tiny(w, seconds=0.2)['correct']\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            "{{'repro_torch', 'jax', 'repro'}}), forbidden_modules())\n"
            ).format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "['repro_torch'] []"


def test_sharpbench_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "sharpbench/run.py", "--workload",
         "rldradspr.stream", "--seed", str(2**32 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=_env(),
        cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_sharpbench_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    the run fails and prints no result."""
    shutil.copytree(ROOT / "sharpbench", tmp_path / "sharpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; from pathlib import Path; sys.path.insert(0, '.')\n"
            "from sharpbench.conftest import tiny_parts\n"
            "from sharpbench import run\n"
            "run.run_cell(Path('.'), 'eesen.offline', 1, 0.2, False, "
            "device='cpu', parts=tiny_parts('eesen.offline', Path('.')))\n"
            "print('RESULT')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and "RESULT" not in out.stdout
    assert "repro_torch" in out.stderr


def test_sharpbench_traced_run_profiles_only_its_second_window(
        monkeypatch):
    """A traced run measures a window without the profiler, which the
    host-clock and counter readers (``mfu`` among them) read, then a
    profiled one of at most ``TRACE_SECONDS``, which the device's
    readers read; both windows' outputs are checked."""
    from sharpbench import run, spans

    seen = []
    orig = spans.Spans.start

    def start(self):
        seen.append(self.profiling)
        return orig(self)

    monkeypatch.setattr(spans.Spans, "start", start)
    monkeypatch.setattr(run, "TRACE_SECONDS", 0.2)
    res = run_tiny("rldradspr.stream", trace=True, seconds=0.5)
    assert seen == [False, True]
    assert res["correct"] and res["metrics"]["mfu"]["value"] > 0
    assert res["metrics"]["serve.admit_ms"]["value"] > 0
    assert 0 < res["device"]["window_s"] < 0.45


def test_sharpbench_worst_reading_keeps_nan():
    from sharpbench.run import _worst

    assert _worst([1e-6, 3e-6]) == 3e-6
    assert _worst([0, 0]) == 0
    assert _worst([1e-6, float("nan")]) != _worst([1e-6, float("nan")])
