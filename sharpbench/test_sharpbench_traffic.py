"""The traffic generator: every mix's lengths stay in their spec, repeat
by seed, and bring every seed the same multiset of work."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sharpbench import generate

HERE = Path(__file__).resolve().parent
MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))
SEEDS = (0, 2**31 + 11, 2**40 + 5)


def _specs(mix):
    return [v for v in mix.values() if isinstance(v, dict) and "dist" in v]


@pytest.mark.parametrize("name", MIXES)
def test_sharpbench_mix_lengths_repeat_by_seed(name):
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    assert (HERE / "drivers" / f"{mix['driver']}.py").exists()
    for spec in _specs(mix):
        pool = generate.quantiles(spec, mix["pool"])
        assert pool.min() >= spec["min"] and pool.max() <= spec["max"]
        for seed in SEEDS:
            a = generate.Lengths(spec, mix["pool"], seed, 1).take(
                2 * mix["pool"] + 3)
            b = generate.Lengths(spec, mix["pool"], seed, 1).take(
                2 * mix["pool"] + 3)
            assert a == b
            # each pass is the same multiset, in the seed's order
            assert sorted(a[:mix["pool"]]) == sorted(pool.tolist())
        if len(set(pool.tolist())) > 1:  # a fixed length has one order
            other = generate.Lengths(spec, mix["pool"], SEEDS[1], 1).take(64)
            assert other != generate.Lengths(spec, mix["pool"], SEEDS[2],
                                             1).take(64)


def test_sharpbench_quantiles_follow_their_distribution():
    ln = generate.quantiles({"dist": "lognormal", "median": 300,
                             "sigma": 0.5, "min": 100, "max": 1000}, 1024)
    assert abs(np.median(ln) - 300) <= 1
    lu = generate.quantiles({"dist": "loguniform", "min": 32, "max": 128},
                            1024)
    assert abs(np.median(lu) - 64) <= 1 and lu.min() == 32
    un = generate.quantiles({"dist": "uniform", "min": 256, "max": 512},
                            1024)
    assert un.min() == 256 and un.max() == 512
    with pytest.raises(ValueError):
        generate.quantiles({"dist": "zipf", "min": 1, "max": 2}, 4)


def test_sharpbench_tape_repeats_by_seed():
    a = generate.Tape(64, 8, 0.5, 2**35 + 1, 3, "cpu")
    b = generate.Tape(64, 8, 0.5, 2**35 + 1, 3, "cpu")
    c = generate.Tape(64, 8, 0.5, 2**35 + 2, 3, "cpu")
    assert torch.equal(a.data, b.data) and not torch.equal(a.data, c.data)
    offs = [a.offset(10) for _ in range(20)]
    assert offs == [b.offset(10) for _ in range(20)]
    assert all(0 <= o <= 54 for o in offs)
    with pytest.raises(ValueError):
        a.offset(65)
