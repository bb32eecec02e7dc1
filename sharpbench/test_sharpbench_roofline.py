"""The work counts against hand-computed FLOPs and bytes, and the
harness's calls and weights against them."""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

from sharpbench import generate, roofline, spans, weights
from sharpbench.conftest import tiny_parts, workloads

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


@pytest.mark.parametrize("workload", workloads("lstm"))
def test_sharpbench_lstm_calls_and_weights_keep_their_formulas(workload):
    """At each LSTM cell's CPU twin: ``spans.call_work`` prices a call by
    ``roofline.call_work``, and ``weights.draw`` gives every layer the
    shapes of ``roofline.layer_inputs``, the bytes of
    ``roofline.weight_bytes`` and the values its docstring states, so
    that the family lookup in front of both changes nothing for them."""
    cfg = tiny_parts(workload)[2]
    X, H, G = cfg["input"], cfg["hidden"], roofline.GATES
    prompts = [torch.zeros((1, T, X)) for T in (5, 3)]
    assert spans.call_work(cfg, "prefill", (prompts,)) == roofline.call_work(
        cfg, 8, 2, reads_state=False)
    assert spans.call_work(cfg, "prefill", (torch.zeros((2, 6, X)),)) == (
        roofline.call_work(cfg, 12, 2, reads_state=False))
    assert spans.call_work(cfg, "decode", (torch.zeros((4, 1, X)),)) == (
        roofline.call_work(cfg, 4, 4, reads_state=True))

    seed = 2**40 + 17
    layers = weights.draw(cfg, seed, "cpu")["layers"]
    halves = [(n, layer[d]) for n, layer in enumerate(layers)
              for d in (("fwd", "bwd") if cfg["bidirectional"] else ())
              ] or list(enumerate(layers))
    assert len(halves) == cfg["n_layers"] * roofline.dirs(cfg)
    inputs = roofline.layer_inputs(cfg)
    for n, half in halves:
        assert half["W"].shape == (inputs[n], G * H)
        assert half["U"].shape == (H, G * H) and half["b"].shape == (G * H,)
    assert sum(t.numel() * t.element_size() for _, half in halves
               for t in half.values()) == roofline.weight_bytes(cfg)
    # the first W: the head of one truncated normal over every weight,
    # drawn from the seed, times weight_gain / sqrt(fan_in), bound as bf16
    gen = torch.Generator().manual_seed(generate.torch_seed(seed, 7))
    flat = torch.empty(roofline.weight_bytes(cfg)
                       // roofline.DTYPE_BYTES[cfg["weight_dtype"]])
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    n = inputs[0] * G * H
    want = (flat[:n] * (cfg["weight_gain"] / math.sqrt(inputs[0]))).to(
        weights.DTYPES[cfg["weight_dtype"]]).view(inputs[0], G * H)
    assert torch.equal(halves[0][1]["W"], want)
    again = weights.draw(cfg, seed, "cpu")["layers"][-1]
    last = layers[-1]
    if cfg["bidirectional"]:
        again, last = again["bwd"], last["bwd"]
    assert torch.equal(again["U"], last["U"])
