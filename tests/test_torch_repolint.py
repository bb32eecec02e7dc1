"""analysis.repolint of the port: the AST lint over the port's contracts.

The reference's lint tests (``tests/analysis/test_repolint.py``) run here
against ``repro_torch.analysis.repolint``, with paths keyed by their
suffix after the last ``repro_torch`` component; RL003 also bans the
port's fence and device clock (``torch.cuda.synchronize``,
``torch.cuda.Event``) outside ``runtime/obs.py``.  The real
``src/repro_torch`` tree must lint clean, and the bare ``RuntimeError``
that ``rnn/compiled.resolve_device`` once raised must be flagged.
"""
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.repolint import collect, lint_source, main

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"


def _rules(src, relpath):
    return [v.rule for v in lint_source(src, relpath)]


# ---------------------------------------------------------------------------
# RL001: deprecated shims
# ---------------------------------------------------------------------------


def test_rl001_flags_deprecated_shim_calls_anywhere():
    src = ("from repro_torch.core import schedules\n"
           "schedules.run_stack(p, x)\n")
    assert _rules(src, "src/repro_torch/models/foo.py") == ["RL001"]
    assert _rules("run_layer(p, x)\n", "src/repro_torch/serving/bar.py") \
        == ["RL001"]


def test_rl001_allows_suffixed_entry_points_and_defining_modules():
    ok = ("from repro_torch.core import schedules\n"
          "schedules.run_layer_fused(p, x)\n")
    assert "RL001" not in _rules(ok, "src/repro_torch/dispatch/executor.py")
    # the defining modules may reference their own shims
    assert "RL001" not in _rules("run_layer(p, x)\n",
                                 "src/repro_torch/core/schedules.py")
    assert "RL001" not in _rules("run_layer(p, x)\n",
                                 "src/repro_torch/core/gru.py")


# ---------------------------------------------------------------------------
# RL002: bare assert / RuntimeError on the serving path
# ---------------------------------------------------------------------------


def test_rl002_flags_assert_and_runtime_error_on_serving_path():
    assert _rules("assert x > 0\n",
                  "src/repro_torch/serving/x.py") == ["RL002"]
    assert _rules("raise RuntimeError('boom')\n",
                  "src/repro_torch/dispatch/x.py") == ["RL002"]
    assert _rules("raise AssertionError('unreachable')\n",
                  "src/repro_torch/rnn/x.py") == ["RL002"]


def test_rl002_allows_taxonomy_and_out_of_scope_asserts():
    ok = ("from repro_torch.runtime.errors import LaunchError\n"
          "raise LaunchError('x', uids=(1,), slot=0)\n")
    assert _rules(ok, "src/repro_torch/serving/x.py") == []
    assert _rules("raise ValueError('bad input')\n",
                  "src/repro_torch/rnn/x.py") == []
    # tests and non-serving layers keep their asserts
    assert _rules("assert x\n", "src/repro_torch/core/lstm.py") == []
    assert _rules("assert x\n", "tests/test_foo.py") == []


def test_rl002_flags_resolve_devices_old_bare_raise():
    """``rnn/compiled.resolve_device`` with the bare ``RuntimeError`` it
    raised before it took ``runtime.errors.DeviceUnavailable``."""
    path = SRC / "rnn" / "compiled.py"
    src = path.read_text()
    assert "raise DeviceUnavailable(" in src
    planted = src.replace("raise DeviceUnavailable(", "raise RuntimeError(")
    found = lint_source(planted, str(path))
    assert [v.rule for v in found] == ["RL002"]
    assert "raise RuntimeError" in found[0].msg
    assert lint_source(src, str(path)) == []


# ---------------------------------------------------------------------------
# RL003: timing / fencing outside runtime/obs.py
# ---------------------------------------------------------------------------


def test_rl003_flags_timing_and_fencing_in_scope():
    assert _rules("import time\nt0 = time.perf_counter()\n",
                  "src/repro_torch/serving/x.py") == ["RL003"]
    assert _rules("import time\ntime.time()\n",
                  "src/repro_torch/runtime/ft.py") == ["RL003"]


@pytest.mark.parametrize("src", [
    "import torch\ntorch.cuda.synchronize()\n",
    "import torch\ne = torch.cuda.Event(enable_timing=True)\n",
    "from torch import cuda\ncuda.synchronize()\n",
    "from torch.cuda import synchronize\nsynchronize()\n",
], ids=["synchronize", "event", "cuda_synchronize", "bare_synchronize"])
def test_rl003_flags_the_ports_fence_and_device_clock(src):
    assert _rules(src, "src/repro_torch/dispatch/x.py") == ["RL003"]
    assert _rules(src, "src/repro_torch/calib/replay.py") == ["RL003"]
    assert _rules(src, "src/repro_torch/runtime/obs.py") == []


def test_rl003_exempts_obs_and_non_runtime_layers():
    assert _rules("import time\ntime.perf_counter()\n",
                  "src/repro_torch/runtime/obs.py") == []
    # launch/ legitimately stamps wall-clock metadata and fences a batch
    assert _rules("import time\ntime.time()\n",
                  "src/repro_torch/launch/serve.py") == []
    assert _rules("import torch\ntorch.cuda.synchronize()\n",
                  "src/repro_torch/launch/serve.py") == []
    ok = ("from repro_torch.runtime import obs\n"
          "t0 = obs.monotonic_s()\nobs.fence(y)\n")
    assert _rules(ok, "src/repro_torch/serving/x.py") == []


# ---------------------------------------------------------------------------
# RL004: Slot packing-field reads outside planner/executor/analysis
# ---------------------------------------------------------------------------


def test_rl004_flags_slot_internals_outside_owners():
    assert _rules("w = slot.wave\n",
                  "src/repro_torch/serving/x.py") == ["RL004"]
    assert _rules("bs = [s.group_b for s in p.slots]\n",
                  "src/repro_torch/models/x.py") == ["RL004"]


def test_rl004_exempts_owners_and_self_access():
    assert _rules("w = slot.wave\n",
                  "src/repro_torch/dispatch/planner.py") == []
    assert _rules("w = slot.tile_k\n",
                  "src/repro_torch/dispatch/executor.py") == []
    assert _rules("w = slot.chained\n",
                  "src/repro_torch/analysis/plancheck.py") == []
    assert _rules("w = slot.chunk_len\n",
                  "src/repro_torch/calib/replay.py") == []
    # a dataclass using a same-named field on itself is not a read of
    # someone else's Slot
    assert _rules("class A:\n  def f(self):\n    return self.wave\n",
                  "src/repro_torch/serving/x.py") == []


def test_scopes_key_on_the_ports_package_directory():
    """Keys are the suffix after the last ``repro_torch`` component: a
    file of the JAX package (or an unkeyed path) is out of the serving
    scopes, and the last component wins over an outer one."""
    assert _rules("assert x\n", "src/repro/serving/x.py") == []
    assert _rules("assert x\n", "/tmp/x/serving/a.py") == []
    assert _rules("assert x\n",
                  "/a/repro_torch/b/repro_torch/serving/x.py") == ["RL002"]


# ---------------------------------------------------------------------------
# the acceptance criterion: the real tree is clean, and the CLI agrees
# ---------------------------------------------------------------------------


def test_src_repro_torch_is_lint_clean():
    violations = collect(SRC)
    assert violations == [], "\n".join(str(v) for v in violations)


@pytest.mark.parametrize("rule,rel,src", [
    ("RL001", "models/x.py", "run_stack(p, x)\n"),
    ("RL002", "serving/x.py", "assert broken\n"),
    ("RL003", "rnn/x.py", "import torch\ntorch.cuda.synchronize()\n"),
    ("RL004", "serving/x.py", "w = slot.wave\n"),
])
def test_cli_exit_codes(tmp_path, capsys, rule, rel, src):
    assert main([str(SRC)]) == 0
    assert "repolint: clean" in capsys.readouterr().out
    bad = tmp_path / "repro_torch" / rel
    bad.parent.mkdir(parents=True)
    bad.write_text(src)
    assert main([str(tmp_path)]) == 1
    assert f" {rule} " in capsys.readouterr().out
    assert main([str(tmp_path / "nope")]) == 2


def test_module_entry_point_runs():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.repolint", str(SRC)],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "repolint: clean" in out.stdout
