"""The work counts against hand-computed FLOPs and bytes."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from sharpbench import roofline

HERE = Path(__file__).resolve().parent


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_sharpbench_rldradspr_wave_work_by_hand():
    cfg = _cfg("rldradspr")
    # 2 (X + H) 4H a layer, 10 layers: 2 * 2048 * 4096 * 10
    assert roofline.flops_per_item(cfg) == 167_772_160
    # a wave of two prompts, 100 and 50 frames, from zero state
    fl, nb = roofline.call_work(cfg, items=150, rows=2, reads_state=False)
    assert fl == 150 * 167_772_160
    weights = 10 * (1024 * 4096 + 1024 * 4096 + 4096) * 2      # bf16
    frames = 150 * (1024 + 1024) * 4                           # in, out
    states = 10 * 2 * 2 * 1024 * 4                             # h, c out
    assert weights == 167_854_080
    assert nb == weights + frames + states == 169_246_720
    assert roofline.bound_s(cfg, fl, nb) == pytest.approx(
        169_246_720 / 3.35e12)
    # a decode tick of 32 rows reads and writes the state
    fl, nb = roofline.call_work(cfg, items=32, rows=32, reads_state=True)
    assert fl == 32 * 167_772_160
    assert nb == weights + 32 * 2048 * 4 + 2 * 10 * 2 * 32 * 1024 * 4


def test_sharpbench_eesen_work_by_hand():
    cfg = _cfg("eesen")
    # layer 0: 2 (340 + 340) 1360; layers 1-4 read both directions (680)
    per_dir = 2 * 680 * 1360 + 4 * 2 * 1020 * 1360
    assert roofline.flops_per_item(cfg) == 2 * per_dir == 25_894_400
    w = 2 * ((340 + 340) * 1360 + 1360 + 4 * ((680 + 340) * 1360 + 1360))
    assert roofline.weight_bytes(cfg) == w * 2


def test_sharpbench_peaks_are_the_data_sheet():
    assert roofline.PEAK_FLOPS["bfloat16"] == 989e12
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
