"""Fixtures of the benchmark's CPU tests: its cells at a size a test run
holds (the widths cut, the traffic shortened), run through the harness
on the CPU, where the program runs its kernels' plain versions.

Each cell's CPU-sized twin is ``tiny/<workload>.json``: ``{"config":
{...}, "mix": {...}}``, the keys of the configuration and of the mix
changed for the CPU.  The tests take their cells from ``BENCHMARK.json``,
so a cell added there with its files is run here with no edit."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def workloads(family: str | None = None) -> list:
    """The cells of ``BENCHMARK.json``, those whose configuration is of
    ``family`` where one is given."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    families = {c["name"]: json.loads((ROOT / c["file"]).read_text())[
        "family"] for c in bench["configs"]}
    return [w["name"] for w in bench["workloads"]
            if family is None or families[w["config"]] == family]


def tiny_parts(workload: str, root: Path = ROOT):
    from sharpbench import run

    bench, cell, cfg, mix, limits = run.cell_parts(root, workload)
    twin = json.loads((root / "sharpbench" / "tiny" / f"{workload}.json")
                      .read_text())
    return (bench, cell, {**cfg, **twin["config"]}, {**mix, **twin["mix"]},
            limits)


def run_tiny(workload: str, seed: int = 2**40 + 3, trace: bool = False,
             precision: str = "fp32", seconds: float = 0.4):
    from sharpbench import run

    return run.run_cell(ROOT, workload, seed, seconds, trace, device="cpu",
                        precision=precision, parts=tiny_parts(workload))
