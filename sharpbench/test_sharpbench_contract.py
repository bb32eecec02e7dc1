"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a new configuration, mix, metric and family by name."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

from sharpbench import roofline
from sharpbench.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "sharpbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
#: widths, which a configuration may never cut
WIDTHS = ("hidden", "input")


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_sharpbench_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for section, keys in KEYS.items():
        for entry in BENCH[section]:
            extra = set(entry) - keys - ({"workloads"} if section in (
                "end_to_end", "per_layer") else set())
            assert keys <= set(entry) and not extra, entry
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in entry and section != "end_to_end" and k != "source":
                    assert _line(entry[k]), entry[k]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_sharpbench_every_file_is_found_by_name():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert not set(c["reduced"]) & set(WIDTHS)
        assert NAME.match(c["name"]) and _line(c["source"])
        assert cfg["control"]  # the precision of the cell's control
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "cells" / f"{w['name']}.json").exists()
        # each cell has a CPU-sized twin
        assert (HERE / "tiny" / f"{w['name']}.json").exists()
    assert configs == {w["config"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_sharpbench_each_moves_target_is_reported_where_its_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for w in cells:
        reported = [m for m in e2e.values()
                    if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(
            reported) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])
    layers = {}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in cells and w in target.get("workloads", cells), (
                m["name"], w)
        layers.setdefault(m["layer"], []).append(m["name"])
    # a kernel's roofline has the whole step's share beside it, moving
    # the same end-to-end metric
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       for o in BENCH["per_layer"])


def test_sharpbench_new_config_mix_and_metric_need_no_edit(tmp_path):
    """A configuration, a mix and a metric added as files of their own,
    with entries in BENCHMARK.json, run with no other change."""
    from sharpbench import run

    shutil.copytree(HERE, tmp_path / "sharpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((HERE / "configs" / "rldradspr.json").read_text())
    new_cfg = {**base, "name": "tiny", "n_layers": 1, "hidden": 8,
               "input": 8}
    (tmp_path / "sharpbench" / "configs" / "tiny.json").write_text(
        json.dumps(new_cfg))
    # a mix that draws the generated count apart from the prompt
    mix = {**json.loads((HERE / "traffic" / "stream.json").read_text()),
           **json.loads((HERE / "tiny" / "rldradspr.stream.json")
                        .read_text())["mix"], "clients": 2, "max_batch": 2,
           "new": {"dist": "uniform", "min": 8, "max": 24}}
    del mix["utterance"]
    (tmp_path / "sharpbench" / "traffic" / "tinymix.json").write_text(
        json.dumps(mix))
    (tmp_path / "sharpbench" / "cells" / "tiny.tinymix.json").write_text(
        json.dumps({"checks": {"out_err": 1e-4, "degraded_launches": 0}}))
    (tmp_path / "sharpbench" / "metrics" / "tiny.ticks.py").write_text(
        "def read(run):\n    return run.record['counters']['decode_ticks']\n")
    bench["configs"].append({"name": "tiny", "source": "https://example.org",
                             "file": "sharpbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.tinymix", "config": "tiny",
                               "traffic": "tinymix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "tiny.ticks", "unit": "ticks",
                               "better": "higher", "source":
                               "program_counter", "layer": "a test",
                               "moves": "items_per_s",
                               "workloads": ["tiny.tinymix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "src").symlink_to(ROOT / "src")
    res = run.run_cell(tmp_path, "tiny.tinymix", 5, 0.3, True,
                       device="cpu")
    assert res["correct"] and res["metrics"]["tiny.ticks"]["value"] > 0


#: a family the program does not know by that name: a one-direction
#: stack in the LSTM layout, drawn and counted by rules of its own (its
#: configuration has no ``bidirectional``, which the LSTM counts read)
TOY_FAMILY = '''"""A toy family: a one-direction stack in the LSTM layout."""
import math

import torch

FLOPS, BYTES = 1000, 3  # an item's work, by this family's own rule


def flops_per_item(cfg):
    return FLOPS


def call_work(cfg, kind, args):
    seqs = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
    items = sum(int(s.shape[0]) * int(s.shape[1]) for s in seqs)
    return items * FLOPS, items * BYTES


def draw(cfg, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed % 2**62)
    H, X = cfg["hidden"], cfg["input"]
    layers = []
    for n in range(cfg["n_layers"]):
        x = X if n == 0 else H
        layers.append({k: (torch.randn(shape, generator=gen, device=device)
                           * 2 / math.sqrt(shape[0])).to(torch.bfloat16)
                       for k, shape in (("W", (x, 4 * H)), ("U", (H, 4 * H)),
                                        ("b", (4 * H,)))})
    return {"layers": layers}
'''

#: run in the copy: the contract's checks on its BENCHMARK.json, then a
#: traced run of the toy's cell, the profiler's CPU operations standing in
#: for the card's kernels so that the trace's reduction has work to give
#: each span
TOY_RUN = '''import json, sys
from pathlib import Path
root = Path.cwd()
sys.path[:0] = [str(root), str(root / "src")]
from sharpbench import spans, test_sharpbench_contract as contract
from sharpbench import run
from sharpbench.conftest import tiny_parts
contract.test_sharpbench_names_units_and_keys()
contract.test_sharpbench_every_file_is_found_by_name()
contract.test_sharpbench_each_moves_target_is_reported_where_its_metric_is()
spans.DEVICE_CATS = spans.DEVICE_CATS + ("cpu_op",)
seen = []
reduce = spans.reduce
def keep(events, calls):
    out = reduce(events, calls)
    seen.append((out, [c for c in calls if c[0] == "prefill"]))
    return out
spans.reduce = keep
res = run.run_cell(root, "toy.batch", 2**41 + 7, 0.3, True, device="cpu",
                   parts=tiny_parts("toy.batch", root))
kinds, calls = seen[-1][0]["kinds"], seen[-1][1]
print(json.dumps({"correct": res["correct"], "metrics": res["metrics"],
                  "prefill": kinds["prefill"],
                  "calls": [c[2:] for c in calls]}))
'''


def test_sharpbench_new_family_needs_no_edit(tmp_path):
    """A configuration of a new family, with its family module, a mix, a
    cell, its CPU twin and a metric, each a new file with its entry in
    BENCHMARK.json: the contract's checks pass in that copy, and a traced
    run of the cell is correct, prices its calls by the family's own
    counts and reads ``mfu`` from the family's FLOPs."""
    copy = tmp_path / "sharpbench"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (copy / "families" / "toy.py").write_text(TOY_FAMILY)
    cfg = {"name": "toy", "family": "toy", "n_layers": 2, "hidden": 8,
           "input": 8, "weight_dtype": "bfloat16", "control": "int8",
           "frame_scale": 0.5, "reduced": []}
    (copy / "configs" / "toy.json").write_text(json.dumps(cfg))
    mix = {"driver": "prefill_batches", "batch": 3, "pool": 64,
           "tape_frames": 128, "warmup_batches": 1, "sample_batches": 1,
           "length": {"dist": "uniform", "min": 4, "max": 12}}
    (copy / "traffic" / "toybatch.json").write_text(json.dumps(mix))
    (copy / "cells" / "toy.batch.json").write_text(
        json.dumps({"checks": {"out_err": 1e-4, "degraded_launches": 0}}))
    (copy / "tiny" / "toy.batch.json").write_text(
        json.dumps({"config": {}, "mix": {"batch": 2}}))
    (copy / "metrics" / "toy.batches.py").write_text(
        "def read(run):\n    return run.record['counters']['batches']\n")
    bench["configs"].append({"name": "toy", "source": "https://example.org",
                             "file": "sharpbench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.batch", "config": "toy",
                               "traffic": "toybatch", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "toy.batches", "unit": "batches",
                               "better": "higher", "source":
                               "program_counter", "layer": "a test",
                               "moves": "items_per_s",
                               "workloads": ["toy.batch"]})
    for m in bench["per_layer"]:
        if m["name"] in ("mfu", "prefill_roofline"):
            m["workloads"].append("toy.batch")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "src").symlink_to(ROOT / "src")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["metrics"]["toy.batches"]["value"] > 0
    assert got["metrics"]["mfu"]["value"] > 0
    # every call priced by the toy's counts (3 bytes to 1,000 FLOPs an
    # item, which no LSTM count gives), and their bounds in the trace
    calls = got["calls"]
    assert calls and all(fl * 3 == nb * 1000 for fl, nb, _ in calls)
    for fl, nb, bound in calls:
        assert bound == roofline.bound_s(cfg, fl, nb)
    assert got["prefill"]["calls"] == len(calls)
    assert abs(got["prefill"]["bound_s"] - sum(c[2] for c in calls)) <= (
        1e-12 * sum(c[2] for c in calls))
