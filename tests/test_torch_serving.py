"""The port's RecurrentServingEngine against the JAX package's, on the CPU.

The same requests, made with numpy from a seed, go through both engines
with the same weights (converted with repro_torch.convert).  The weights
are bfloat16, as in the paper configs; the engines feed fp32 frames and
keep fp32 state, so the arithmetic is fp32 over bf16 weights in both:
tolerance 1e-4 (summation order differs; the difference compounds over the
prompt recurrence and the fed-back decode ticks).  Fault, deadline and
backpressure paths must give the same statuses and counters as the
reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.sharp_lstm import lstm_config
from repro.models.layers.lstm import init_lstm_stack
from repro.serving import recurrent as jserving

from repro_torch.convert import from_jax
from repro_torch.kernels.common import reset_counts
from repro_torch.kernels.lstm_cell import ops
from repro_torch.runtime.errors import (NonFiniteStateError, QueueFull,
                                        RequestTimeout)
from repro_torch.serving import recurrent as serving

TOL = 1e-4
CFG = lstm_config(48, layers=3)  # dtype bfloat16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = init_lstm_stack(jax.random.PRNGKey(0), CFG, jnp.bfloat16)
    return jp, from_jax(jp)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((t, 48)) * 0.5).astype(np.float32)
            for t in lengths]


def _engines(params, **kw):
    jp, tp = params
    jeng = jserving.RecurrentServingEngine(CFG, jp, interpret=True, **kw)
    eng = serving.RecurrentServingEngine(CFG, tp, device="cpu", **kw)
    return jeng, eng


def _submit(engines, prompts, **req_kw):
    for mod, eng in zip((jserving, serving), engines):
        for uid, p in enumerate(prompts):
            eng.submit(mod.RecurrentRequest(uid=uid, frames=p, **req_kw))


def _summary(eng, done):
    return ([(c.uid, c.status, c.outputs.shape, c.generated.shape)
             for c in done],
            eng.prefill_waves, eng.packed_launches, eng.naive_launches,
            eng.decode_ticks, eng.decode_launches, eng.quarantined,
            eng.prefill_retries, eng.dropped)


def test_engine_matches_reference_engine(params):
    """Two ragged admission waves (max_batch=4, six requests), then decode
    ticks with fed-back frames: same completions, same launch accounting,
    outputs and generated frames within tolerance."""
    jeng, eng = _engines(params, max_batch=4)
    prompts = _prompts((30, 30, 17, 45, 8, 30), seed=1)
    _submit((jeng, eng), prompts, max_new_frames=8)
    jdone = jeng.run_to_completion()
    reset_counts(ops.lstm_seq, ops.lstm_decode)
    done = eng.run_to_completion()
    assert _summary(eng, done) == _summary(jeng, jdone)
    assert eng.prefill_waves == 2
    assert ops.lstm_seq.calls == eng.packed_launches
    assert ops.lstm_decode.calls == eng.decode_launches == eng.decode_ticks
    assert eng.decode_plans_built == jeng.decode_plans_built
    for c, jc in zip(done, jdone):
        assert c.status == "ok"
        np.testing.assert_allclose(c.outputs, np.asarray(jc.outputs),
                                   atol=TOL)
        np.testing.assert_allclose(c.generated, np.asarray(jc.generated),
                                   atol=TOL)
    st = eng.compiled.stats
    assert (st.degraded_launches, st.fallback_level) == (0, 0)


def test_wave_fault_bisects_like_reference(params):
    jeng, eng = _engines(params, max_batch=3)
    _submit((jeng, eng), _prompts((6, 6, 4), seed=2), max_new_frames=2)
    jeng.fail_prefill_of = eng.fail_prefill_of = {1}
    jdone, done = jeng.run_to_completion(), eng.run_to_completion()
    assert _summary(eng, done) == _summary(jeng, jdone)
    assert [c.status for c in sorted(done, key=lambda c: c.uid)] == \
        ["ok", "failed", "ok"]


def test_poison_timeout_and_deadlines_like_reference(params):
    jeng, eng = _engines(params, max_batch=3)
    _submit((jeng, eng), _prompts((5, 7, 6), seed=3), max_new_frames=4,
            max_ticks=3)
    jeng.poison_slot_at = eng.poison_slot_at = {0: 1, 2: -1}
    jdone, done = jeng.run_to_completion(), eng.run_to_completion()
    assert _summary(eng, done) == _summary(jeng, jdone)
    by_uid = {c.uid: c for c in done}
    assert (by_uid[0].status, by_uid[1].status, by_uid[2].status) == \
        ("failed", "timeout", "failed")
    assert by_uid[0].generated.shape == (1, 48)


@pytest.mark.parametrize("backpressure", ["reject", "drop_oldest"])
def test_backpressure_like_reference(params, backpressure):
    jeng, eng = _engines(params, max_batch=1, max_queue=1,
                         backpressure=backpressure)
    prompts = _prompts((4, 4), seed=4)
    outcome = []
    for mod, e in ((jserving, jeng), (serving, eng)):
        e.submit(mod.RecurrentRequest(uid=0, frames=prompts[0],
                                      max_new_frames=1))
        try:
            e.submit(mod.RecurrentRequest(uid=1, frames=prompts[1],
                                          max_new_frames=1))
            outcome.append("accepted")
        except Exception as err:  # noqa: BLE001 — compared by type name
            outcome.append(type(err).__name__)
        outcome.append(_summary(e, e.run_to_completion()))
    assert outcome[:2] == outcome[2:]
    if backpressure == "reject":
        assert outcome[2] == QueueFull.__name__


def test_rejects_and_engine_timeout(params):
    _, eng = _engines(params, max_batch=1)
    bad = _prompts((3,))[0]
    bad[1, 2] = np.nan
    with pytest.raises(NonFiniteStateError):
        eng.submit(serving.RecurrentRequest(uid=0, frames=bad))
    with pytest.raises(ValueError):
        eng.submit(serving.RecurrentRequest(uid=1, frames=bad[:, :7]))
    for uid, p in enumerate(_prompts((4, 4), seed=5)):
        eng.submit(serving.RecurrentRequest(uid=uid, frames=p,
                                            max_new_frames=3))
    with pytest.raises(RequestTimeout) as err:
        eng.run_to_completion(max_ticks=2)
    assert err.value.uids and isinstance(err.value.done, list)
