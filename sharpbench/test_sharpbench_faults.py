"""The comparison that decides ``correct`` fails what it must: each fault
a cell can have, planted in the timed path underneath the harness (the
kernels' plain versions, which the program runs on the CPU), and the
control, the program's own next-lower precision.  The exchange between
chips is a fault no cell here can have: every cell runs on one chip.

The cells come from ``BENCHMARK.json``; the planted faults patch LSTM
kernels, so they take the cells whose configuration is of the LSTM
family.  A stand-in takes effect on every request the window can finish,
whatever slot it holds, so that the outcome does not hang on how many
requests a short window finishes on a loaded machine."""
from __future__ import annotations

import importlib

import pytest
import torch

from sharpbench import run
from sharpbench.conftest import ROOT, run_tiny, workloads

OPS = "repro_torch.kernels.lstm_cell.ops"
LSTM = workloads("lstm")


def _served_by_engine(workload: str) -> bool:
    """A cell whose loop is the serving engine: prefill waves, then
    decode ticks."""
    return run.cell_parts(ROOT, workload)[3]["driver"] == "engine_closed_loop"


ENGINE = [w for w in LSTM if _served_by_engine(w)]


def _decode_unchanged(xw0, Ws, bs, Us, h0, c0):
    return h0.clone(), c0.clone()


def _seq_unchanged(U4, xw, h0, c0, *rest):
    T = xw.shape[2]
    return (h0[:, :, None].expand(-1, -1, T, -1).clone(), h0.clone(),
            c0.clone())


def _half_decode(plain, bites):
    """The tick's kernel run on half of its rows; the other half keep
    their state (left out of the step).  The half left out alternates
    from tick to tick (rows of one parity, then of the other), so every
    stream is left out of one of any two ticks it shares with another.
    ``bites`` counts the ticks that left rows out."""
    ticks = [0]

    def fn(xw0, Ws, bs, Us, h0, c0):
        h, c = (o.clone() for o in plain(xw0, Ws, bs, Us, h0, c0))
        B = h0.shape[1]
        if B >= 2:
            out = torch.arange(B) % 2 == ticks[0] % 2
            h[:, out], c[:, out] = h0[:, out], c0[:, out]
            bites.append(int(out.sum()))
        ticks[0] += 1
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
    """One value changed where the sequence kernel produces it: the
    first unit of every row at the first step."""
    def fn(*args):
        out = [o.clone() for o in plain(*args)]
        out[0][..., 0, :1] += 1e-2  # (G, B, T, H): t = 0
        return tuple(out)
    return fn


def _altered_decode(plain):
    """One value of one row changed where the tick's kernel produces it,
    the row moving on by one each tick, so that every stream that stays
    as many ticks as the tick has rows is altered once."""
    ticks = [0]

    def fn(*args):
        out = [o.clone() for o in plain(*args)]
        h = out[0]  # (L, B, H)
        h[:, ticks[0] % h.shape[1], :1] += 1e-2
        ticks[0] += 1
        return tuple(out)
    return fn


@pytest.mark.parametrize("workload", LSTM)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_sharpbench_planted_fault_reads_incorrect(monkeypatch, workload,
                                                  fault):
    """The fault in the kernel that produces the cell's frames: the decode
    tick where the engine serves the cell, the sequence kernel where an
    offline batch is one prefill."""
    from repro_torch.rnn.compiled import CompiledStack

    engine = _served_by_engine(workload)
    ops = importlib.import_module(OPS)
    name = "lstm_decode_plain" if engine else "lstm_seq_plain"
    bites = []
    if fault == "half_batch" and not engine:
        # the rows of a wave's launches are its requests' cells, one
        # request a row group: leave half the requests out above them
        monkeypatch.setattr(CompiledStack, "prefill",
                            _half_prefill(CompiledStack.prefill))
    elif fault == "half_batch":
        monkeypatch.setattr(ops, name, _half_decode(getattr(ops, name),
                                                    bites))
    elif fault == "state_unchanged":
        monkeypatch.setattr(ops, name, _decode_unchanged if engine
                            else _seq_unchanged)
    else:
        monkeypatch.setattr(ops, name, (_altered_decode if engine
                                        else _altered)(getattr(ops, name)))
    res = run_tiny(workload, seconds=0.3)
    assert not res["correct"], res["checks"]
    if fault == "half_batch" and engine:
        assert bites, "no tick had two rows for the fault to leave one out"


@pytest.mark.parametrize("workload", ENGINE)
@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_sharpbench_planted_prefill_fault_reads_incorrect(monkeypatch,
                                                          workload, fault):
    """Where the engine serves a cell, the same faults in the sequence
    kernel of its admission waves, whose prompt outputs are compared as
    its generated frames are."""
    ops = importlib.import_module(OPS)
    monkeypatch.setattr(ops, "lstm_seq_plain", _seq_unchanged
                        if fault == "state_unchanged"
                        else _altered(ops.lstm_seq_plain))
    res = run_tiny(workload, seconds=0.3)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", workloads())
def test_sharpbench_int8_control_reads_incorrect(workload):
    """The control: the program's own next-lower precision, which the
    configuration names (int8 recurrent weights for the LSTM stacks),
    fails the limit that the bf16 program passes."""
    control = run.cell_parts(ROOT, workload)[2]["control"]
    res = run_tiny(workload, precision=control, seconds=0.3)
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
