"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a new configuration, mix and metric by name."""
from __future__ import annotations

import json
import re
import shutil

from sharpbench.conftest import ROOT, TINY

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
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "cells" / f"{w['name']}.json").exists()
        assert w["name"] in TINY  # each cell has a CPU-sized twin
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
           **TINY["rldradspr.stream"][1], "clients": 2, "max_batch": 2,
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
