"""The token engine's spans and counters (``ServingEngine(trace=True)``,
``repro_torch.runtime.obs``) on the CPU, serving the reduced
granite-4.0-h hybrid: one ``lm.step`` a step holding ``lm.admit``,
``lm.decode`` and ``lm.retire``; per admitted request ``lm.prefill``
(tags ``prompt``, ``bucket``), ``lm.remainder`` (tag ``steps``) and
``lm.splice`` inside ``lm.admit``; each Mamba-2 block's
``mamba2.prefill`` (tags ``chunks``, ``tokens``) inside ``lm.prefill``;
the counters ``steps`` and ``remainder_steps``; tokens bit for bit those
of an untraced engine; an untraced engine holding the no-op tracer."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import granite_4_0_h_micro
from repro_torch.models import transformer as tf
from repro_torch.runtime.obs import NULL_TRACER, active_tracer
from repro_torch.serving import Request, ServingEngine

CFG = granite_4_0_h_micro.reduced()
#: (prompt length, new tokens): four requests on three slots, so the last
#: is admitted in a second wave; 5, 12 and 9 leave remainders past their
#: buckets (4, 8, 8), 16 none
REQUESTS = ((5, 4), (12, 6), (9, 3), (16, 2))
PARENTS = {"lm.admit": "lm.step", "lm.decode": "lm.step",
           "lm.retire": "lm.step", "lm.prefill": "lm.admit",
           "lm.remainder": "lm.admit", "lm.splice": "lm.admit",
           "mamba2.prefill": "lm.prefill"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return tf.init_params(CFG, torch.Generator().manual_seed(0))


def _serve(params, trace: bool):
    eng = ServingEngine(CFG, params, max_batch=3, max_seq=32, device="cpu",
                        trace=trace)
    rng = np.random.default_rng(0)
    for uid, (n, new) in enumerate(REQUESTS):
        eng.submit(Request(uid=uid, tokens=rng.integers(
            0, CFG.vocab_size, size=n), max_new_tokens=new))
    done = eng.run_to_completion()
    return eng, {c.uid: c.tokens for c in done}


def test_lm_spans_nest_and_carry_their_tags(params):
    eng, _ = _serve(params, trace=True)
    spans = [e for e in eng.tracer.events if e.dur_us is not None]
    by_name = {}
    for sp in spans:
        by_name.setdefault(sp.name, []).append(sp)
    assert set(by_name) == set(PARENTS) | {"lm.step"}
    for sp in spans:
        want = PARENTS.get(sp.name)
        assert (sp.parent.name if sp.parent else None) == want, sp.name
    assert len(by_name["lm.step"]) == len(by_name["lm.decode"]) == eng.steps
    prefills = by_name["lm.prefill"]
    assert sorted((s.tags["prompt"], s.tags["bucket"]) for s in prefills) \
        == sorted((n, 1 << (n.bit_length() - 1)) for n, _ in REQUESTS)
    rem = by_name["lm.remainder"]
    assert sorted(s.tags["steps"] for s in rem) == [1, 1, 4]
    assert sum(s.tags["steps"] for s in rem) == eng.remainder_steps == 6
    mamba = CFG.layer_kinds().count("mamba2")
    assert len(by_name["mamba2.prefill"]) == mamba * len(REQUESTS)
    for sp in by_name["mamba2.prefill"]:
        n = sp.parent.tags["bucket"]
        assert sp.tags["tokens"] == n
        assert sp.tags["chunks"] == -(-n // CFG.mamba_chunk_size)
    assert sorted(s.tags["uid"] for s in by_name["lm.splice"]) == [0, 1, 2, 3]
    totals = eng.tracer.totals()
    assert totals["lm.remainder"]["count"] == 3
    assert totals["lm.step"]["count"] == eng.steps


def test_tokens_bit_identical_with_tracing_on_and_off(params):
    on, got_on = _serve(params, trace=True)
    off, got_off = _serve(params, trace=False)
    assert got_on == got_off
    assert (on.steps, on.remainder_steps) == (off.steps, off.remainder_steps)
    assert off.tracer is NULL_TRACER and off.tracer.totals() == {}
    assert active_tracer() is NULL_TRACER  # restored after each prefill
