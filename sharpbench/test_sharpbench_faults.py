"""The comparison that decides ``correct`` fails what it must: each fault
a cell can have, planted in the timed path underneath the harness (the
kernels' plain versions, which the program runs on the CPU), and the
control, the program's own int8 path.  The exchange between chips is a
fault no cell here can have: every cell runs on one chip."""
from __future__ import annotations

import pytest
import torch

from sharpbench.conftest import run_tiny

OPS = "repro_torch.kernels.lstm_cell.ops"


def _decode_unchanged(xw0, Ws, bs, Us, h0, c0):
    return h0.clone(), c0.clone()


def _seq_unchanged(U4, xw, h0, c0, *rest):
    T = xw.shape[2]
    return (h0[:, :, None].expand(-1, -1, T, -1).clone(), h0.clone(),
            c0.clone())


def _half_decode(plain):
    """The tick's kernel run on the first half of its rows; the rest keep
    their state (left out of the step)."""
    def fn(xw0, Ws, bs, Us, h0, c0):
        h, c = (o.clone() for o in plain(xw0, Ws, bs, Us, h0, c0))
        k = h0.shape[1] - h0.shape[1] // 2
        h[:, k:], c[:, k:] = h0[:, k:], c0[:, k:]
        return h, c
    return fn


def _half_prefill(orig):
    """A wave that computes the first half of its requests; the rest
    come back as zeros (left out of the batch)."""
    def prefill(self, xs, priorities=None):
        k = len(xs) - len(xs) // 2
        got = orig(self, xs[:k])
        zeros = [(torch.zeros_like(got[0][0][:, :1]).expand(
            1, x.shape[1], -1).clone(), got[0][1]) for x in xs[k:]]
        return got + zeros
    return prefill


def _altered(plain):
    """One value of row 0 changed where the kernel produces it."""
    def fn(*args):
        out = [o.clone() for o in plain(*args)]
        out[0][..., 0, :1] += 1e-2  # (.., B, H): row 0's first unit
        return tuple(out)
    return fn


@pytest.mark.parametrize("workload", ["rldradspr.stream", "eesen.offline"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_sharpbench_planted_fault_reads_incorrect(monkeypatch, workload,
                                                  fault):
    import importlib

    from repro_torch.rnn.compiled import CompiledStack

    stream = workload.endswith("stream")
    ops = importlib.import_module(OPS)
    name = "lstm_decode_plain" if stream else "lstm_seq_plain"
    if fault == "half_batch" and not stream:
        # the rows of a wave's launches are its requests' cells, one
        # request a row group: leave half the requests out above them
        monkeypatch.setattr(CompiledStack, "prefill",
                            _half_prefill(CompiledStack.prefill))
    elif fault == "half_batch":
        monkeypatch.setattr(ops, name, _half_decode(getattr(ops, name)))
    elif fault == "state_unchanged":
        monkeypatch.setattr(ops, name, _decode_unchanged if stream
                            else _seq_unchanged)
    else:
        monkeypatch.setattr(ops, name, _altered(getattr(ops, name)))
    res = run_tiny(workload, seconds=0.3)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["rldradspr.stream", "eesen.offline"])
def test_sharpbench_int8_control_reads_incorrect(workload):
    """The control: the program's own next-lower precision (int8
    recurrent weights) fails the limit that the bf16 program passes."""
    res = run_tiny(workload, precision="int8", seconds=0.3)
    assert not res["correct"], res["checks"]
    assert torch.isfinite(torch.tensor(res["checks"]["out_err"]["value"]))


def test_sharpbench_degraded_launches_read_incorrect(monkeypatch):
    """A tick whose fused launch fails and is re-run by the program's
    per-step fallback serves right frames off the timed path: the
    degraded launches alone make the run incorrect."""
    from repro_torch.rnn.compiled import CompiledStack

    orig = CompiledStack.decode

    def decode(self, *args, **kwargs):
        self.fault.arm([0], through_level=0, once=False)
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(CompiledStack, "decode", decode)
    res = run_tiny("rldradspr.stream", seconds=0.3)
    checks = res["checks"]
    assert not res["correct"] and res["failed"] == 0
    assert checks["degraded_launches"]["value"] > 0
    assert checks["out_err"]["value"] <= checks["out_err"]["limit"]
