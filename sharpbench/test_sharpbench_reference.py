"""The plain reference against the program's CPU path at a reduced size,
and against itself: its free-running decode equals its stack run over
the frames it fed back."""
from __future__ import annotations

import pytest
import torch

from sharpbench import reference, weights


def _cfg(L, H, X, bi):
    return {"family": "lstm", "n_layers": L, "hidden": H, "input": X,
            "bidirectional": bi, "weight_dtype": "bfloat16",
            "weight_gain": 2.0, "bias_scale": 0.1}


@pytest.mark.parametrize("bi", [False, True])
def test_sharpbench_reference_matches_program_cpu_path(bi):
    from repro_torch import rnn

    cfg = _cfg(3, 24, 20 if bi else 24, bi)
    params = weights.draw(cfg, 2**33 + 1, "cpu")
    lens = [17, 5, 11]
    xs = torch.randn((3, 17, cfg["input"]),
                     generator=torch.Generator().manual_seed(1)) * 0.5
    got = rnn.compile(params, device="cpu").prefill(
        [xs[b:b + 1, :T] for b, T in enumerate(lens)])
    ref = reference.stack(params["layers"], xs, lens)
    assert ref.shape == (3, 17, cfg["hidden"] * (2 if bi else 1))
    for b, T in enumerate(lens):
        ys = got[b][0][0]
        assert float((ys.float() - ref[b, :T]).abs().max()) < 2e-6
        assert float(ref[b, :T].abs().max()) > 0.1


def test_sharpbench_reference_feedback_is_its_stack_teacher_forced():
    cfg = _cfg(2, 16, 16, False)
    params = weights.draw(cfg, 7, "cpu")
    prompt = torch.randn((2, 9, 16),
                         generator=torch.Generator().manual_seed(2)) * 0.5
    out, gen = reference.feedback(params["layers"], prompt, 12)
    xs = torch.cat([prompt, out[:, -1:], gen[:, :-1]], dim=1)
    ys = reference.stack(params["layers"], xs)
    assert torch.allclose(ys, torch.cat([out, gen], dim=1), atol=1e-6)


def test_sharpbench_reference_reverses_each_row_within_its_length():
    xs = torch.arange(2 * 5, dtype=torch.float32).reshape(2, 5, 1)
    r = reference._reverse(xs, [5, 3])
    assert r[0, :, 0].tolist() == [4, 3, 2, 1, 0]
    assert r[1, :, 0].tolist() == [7, 6, 5, 8, 9]
    assert torch.equal(reference._reverse(r, [5, 3]), xs)
