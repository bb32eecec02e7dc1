"""Fixtures of the benchmark's CPU tests: its cells at a size a test run
holds (the widths cut, the traffic shortened), run through the harness
on the CPU, where the program runs its kernels' plain versions."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: per cell: the configuration's and the mix's keys changed for the CPU
TINY = {
    "rldradspr.stream": (
        {"n_layers": 2, "hidden": 32, "input": 32},
        {"clients": 4, "max_batch": 4, "tape_frames": 256, "block": 8,
         "prompt": {"dist": "loguniform", "min": 4, "max": 12},
         "utterance": {"dist": "uniform", "min": 16, "max": 32},
         "warmup_ticks": 20}),
    "eesen.offline": (
        {"n_layers": 2, "hidden": 16, "input": 12},
        {"batch": 4, "tape_frames": 512, "warmup_batches": 1,
         "length": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                    "min": 4, "max": 40}}),
}


def tiny_parts(workload: str, root: Path = ROOT):
    from sharpbench import run

    bench, cell, cfg, mix, limits = run.cell_parts(root, workload)
    cfg_over, mix_over = TINY[workload]
    return bench, cell, {**cfg, **cfg_over}, {**mix, **mix_over}, limits


def run_tiny(workload: str, seed: int = 2**40 + 3, trace: bool = False,
             precision: str = "fp32", seconds: float = 0.4):
    from sharpbench import run

    return run.run_cell(ROOT, workload, seed, seconds, trace, device="cpu",
                        precision=precision, parts=tiny_parts(workload))


@pytest.fixture
def cells():
    return sorted(TINY)
