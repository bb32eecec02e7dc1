"""The fault-injection (chaos) suite against the port, on the CPU.

Each test of ``tests/dispatch/test_faults.py`` runs here on the port with
``device="cpu"`` and the reference's own assertions: the guarded ladder's
recovery and its record in ``CompiledStack.stats``, fail-fast under
``on_fault="raise"``, poisoned-slot quarantine, deadlines, backpressure and
the watchdog.  The weights are the reference suite's (``init_lstm_stack``
at PRNGKey(0), fp32), carried over with ``convert.from_jax``.

Isolation: with one failed or poisoned request in a packed wave, every
co-batched request completes as in the fault-free run.  Where the faulted
run gives a co-batched row's launches the same row count as the clean run,
the port holds it bit for bit, as the reference does.  Where a wave
bisects or a decode slot empties, the plain versions' ``h @ U`` runs in
BLAS calls of another row count, which sum in another order: those rows
are held at the standing packed-vs-solo tolerance (ROADMAP.md, Queue 3,
Standing, "packed vs solo at 1e-6 on the CPU"), ``ISOLATION_TOL``.  Run
alone with ``pytest -m chaos``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.sharp_lstm import lstm_config as jlstm_config
from repro.core import schedules as jsch
from repro.models.layers.lstm import init_lstm_stack

from repro_torch import rnn
from repro_torch.configs.sharp_lstm import lstm_config
from repro_torch.convert import from_jax
from repro_torch.core import schedules as sch
from repro_torch.models.layers.lstm import init_lstm_stack as init_stack
from repro_torch.rnn import (ExecutionPolicy, LaunchError,
                             NonFiniteStateError, PlanRejected, QueueFull,
                             RequestTimeout)
from repro_torch.serving import RecurrentRequest, RecurrentServingEngine

pytestmark = pytest.mark.chaos

CFG = lstm_config(32, layers=2)

#: ROADMAP.md, Queue 3, Standing, "packed vs solo at 1e-6 on the CPU":
#: fp32 rows of a packed call against the same rows in a call of another
#: row count
ISOLATION_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return init_lstm_stack(jax.random.PRNGKey(0),
                           jlstm_config(32, layers=2), jnp.float32)


@pytest.fixture
def params(jparams):
    return from_jax(jparams)


def _compile(params, **kw):
    return rnn.compile(params, ExecutionPolicy(**kw), device="cpu")


def _xs(B=2, T=6, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal((B, T, 32)).astype(np.float32)) * 0.5


def _engine(params, max_batch=3, **kw):
    return RecurrentServingEngine(CFG, params, max_batch=max_batch,
                                  device="cpu", **kw)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, 32)).astype(np.float32) * 0.5
            for t in lengths]


def _isolated(clean, faulted, exact):
    """A co-batched request's frames against the fault-free run's: bit for
    bit where ``exact``, else within the standing packed-vs-solo
    tolerance (named in the module doc)."""
    if exact:
        np.testing.assert_array_equal(clean, faulted)
    else:
        np.testing.assert_allclose(clean, faulted, rtol=0,
                                   atol=ISOLATION_TOL)


# ---------------------------------------------------------------------------
# guarded execution ladder (CompiledStack / executor)
# ---------------------------------------------------------------------------


def test_injected_fault_recovers_per_step_and_is_recorded(params):
    xs = _xs()
    healthy = _compile(params)
    base = healthy.forward(xs).numpy()

    cs = _compile(params, on_fault="fallback")
    cs.fault.arm([0])  # fused attempt of slot 0 raises; per-step recovers
    out = cs.forward(xs).numpy()
    np.testing.assert_allclose(base, out, atol=1e-5)
    assert cs.stats.degraded_launches == 1
    assert cs.stats.fallback_level == 1  # per_step
    assert cs.fault.fired == [(0, 0)]
    assert "fell back" in cs.stats.faults[0]
    assert "DEGRADED" in cs.describe()

    # healthy stacks report zero degradation
    assert healthy.stats.degraded_launches == 0
    assert healthy.stats.fallback_level == 0 and not healthy.stats.faults


def test_forced_reference_fallback_is_oracle_equal(params, jparams):
    """Both rungs fail; the plain reference rung serves the launch.  The
    result equals the port's oracle and the JAX package's, fed the same
    weights."""
    xs = _xs()
    cs = _compile(params, on_fault="fallback")
    cs.fault.arm([0], through_level=1)  # fused AND per-step fail
    out = cs.forward(xs).numpy()
    oracle = sch.reference_stack(params, xs).numpy()
    np.testing.assert_allclose(out, oracle, atol=1e-4)
    joracle = np.asarray(jsch.reference_stack(jparams, jnp.asarray(xs)))
    np.testing.assert_allclose(out, joracle, atol=1e-4)
    assert cs.stats.fallback_level == 2  # reference rung


def test_on_fault_raise_preserves_fail_fast(params):
    cs = _compile(params)
    assert cs.policy.on_fault == "raise"
    cs.fault.arm([0])
    with pytest.raises(LaunchError) as e:
        cs.forward(_xs())
    assert e.value.slot == 0 and e.value.injected
    assert e.value.level == "fused" and e.value.uids == (0,)
    assert cs.stats.degraded_launches == 0  # the call died, nothing folded
    # the injector fired once and disarmed: the retry succeeds
    cs.forward(_xs())
    assert cs.stats.forward_calls == 1


def test_exhausted_ladder_escapes_even_under_fallback(params):
    cs = _compile(params, on_fault="fallback")
    cs.fault.arm([0], through_level=2)  # every rung fails
    with pytest.raises(LaunchError, match="reference"):
        cs.forward(_xs())
    assert cs.fault.fired == [(0, 0), (0, 1), (0, 2)]


def test_decode_tick_ladder_recovers_chained_slot(params):
    xs = _xs(B=2, T=5)
    healthy = _compile(params)
    cs = _compile(params, on_fault="fallback")
    _, st_h = healthy.prefill(xs)
    _, st = cs.prefill(xs)
    y_h, st2_h = healthy.decode(xs[:, :1], st_h)
    for through in (0, 1):  # per-layer rung, then the plain reference rung
        cs.fault.arm([0], through_level=through)
        y, st2 = cs.decode(xs[:, :1], st)
        np.testing.assert_allclose(y_h.numpy(), y.numpy(), atol=1e-5)
        np.testing.assert_allclose(st2_h["h"].numpy(), st2["h"].numpy(),
                                   atol=1e-5)
    assert cs.stats.degraded_launches == 2
    assert cs.stats.fallback_level == 2


def test_check_finite_raises_structured_error(params):
    cs = _compile(params, check_finite=True)
    L, B, H = 2, 2, 32
    bad = {"h": torch.full((L, B, H), float("nan")),
           "c": torch.zeros((L, B, H))}
    with pytest.raises(NonFiniteStateError) as e:
        cs.decode(torch.zeros((B, 1, 32)), bad)
    assert e.value.uids == (0,) and e.value.where == "decode tick"


# ---------------------------------------------------------------------------
# poisoned-slot quarantine (serving engine)
# ---------------------------------------------------------------------------


def _run(eng, prompts, max_new=3, **req_kw):
    for uid, p in enumerate(prompts):
        eng.submit(RecurrentRequest(uid=uid, frames=p, max_new_frames=max_new,
                                    **req_kw))
    return {c.uid: c for c in eng.run_to_completion()}


def test_prefill_launch_fault_fails_only_target(params):
    """An injected launch failure in the packed admission wave fails only
    the targeted request; the wave bisects and co-batched requests
    complete as in the fault-free run.  The bisected halves run uid 0 and
    uid 2 in prefill launches of other row counts than the clean wave's
    three rows: held at the standing tolerance."""
    prompts = _prompts((8, 8, 6))
    clean = _run(_engine(params), prompts)

    eng = _engine(params)
    eng.fail_prefill_of = {1}
    done = _run(eng, prompts)
    assert sorted(done) == [0, 1, 2]
    assert done[1].status == "failed"
    assert "launch fault" in done[1].error
    assert done[1].outputs.shape == (0, 32)  # prefill never finished
    assert eng.prefill_retries == 3 and eng.quarantined == 1
    for uid in (0, 2):
        assert done[uid].status == "ok" and done[uid].error is None
        _isolated(clean[uid].outputs, done[uid].outputs, exact=False)
        _isolated(clean[uid].generated, done[uid].generated, exact=False)


def test_prefill_fault_on_the_card_ladder_fails_only_target(params,
                                                             monkeypatch):
    """The same wave fault where the ladder ends at per_step, as on the
    card (claimed by patching the executor's device test).  The arm that
    fails the wave is spent at the ladder's last rung, so the bisection's
    solo re-admissions of uid 0 and uid 2 run unfaulted."""
    from repro_torch.dispatch import executor

    prompts = _prompts((8, 8, 6))
    clean = _run(_engine(params), prompts)
    monkeypatch.setattr(executor, "_on_card", lambda t: True)
    eng = _engine(params)
    eng.fail_prefill_of = {1}
    done = _run(eng, prompts)
    assert [done[u].status for u in (0, 1, 2)] == ["ok", "failed", "ok"]
    assert "launch fault" in done[1].error
    assert eng.prefill_retries == 3 and eng.quarantined == 1
    assert eng.compiled.fault.fired == [(0, 0), (0, 1), (0, 0), (0, 1)]
    for uid in (0, 2):
        _isolated(clean[uid].outputs, done[uid].outputs, exact=False)
        _isolated(clean[uid].generated, done[uid].generated, exact=False)


def test_once_arm_is_spent_at_the_last_rung_of_a_shorter_ladder(
        params, monkeypatch):
    """An arm through level 2 on the card's two-rung ladder fires at both
    rungs, escapes as a per_step LaunchError and is spent: the retry
    succeeds, as on the CPU's three rungs."""
    from repro_torch.dispatch import executor

    monkeypatch.setattr(executor, "_on_card", lambda t: True)
    cs = _compile(params, on_fault="fallback")
    cs.fault.arm([0], through_level=2)
    with pytest.raises(LaunchError) as e:
        cs.forward(_xs())
    assert e.value.level == "per_step" and e.value.injected
    assert cs.fault.fired == [(0, 0), (0, 1)] and not cs.fault.armed
    np.testing.assert_array_equal(cs.forward(_xs()).numpy(),
                                  _compile(params).forward(_xs()).numpy())


def test_prefill_fault_under_raise_mode_fails_fast(params):
    eng = _engine(params, on_fault="raise")
    eng.fail_prefill_of = {0}
    eng.submit(RecurrentRequest(uid=0, frames=_prompts((6,))[0],
                                max_new_frames=1))
    with pytest.raises(LaunchError):
        eng.step()


def test_poisoned_prefill_state_quarantines_only_target(params):
    """The poisoned state is caught after the packed wave ran at its full
    row count, and the survivors decode in the same slots: bit for bit."""
    prompts = _prompts((7, 7, 5), seed=3)
    clean = _run(_engine(params), prompts)

    eng = _engine(params)
    eng.poison_slot_at = {2: -1}  # poison uid 2's spliced prefill state
    done = _run(eng, prompts)
    assert done[2].status == "failed"
    assert "prefill state" in done[2].error
    for uid in (0, 1):
        assert done[uid].status == "ok"
        _isolated(clean[uid].outputs, done[uid].outputs, exact=True)
        _isolated(clean[uid].generated, done[uid].generated, exact=True)


def test_decode_poison_quarantines_mid_flight(params):
    """A NaN appearing in one request's recurrent state mid-decode fails
    only that request (partial frames preserved); the co-batched request
    finishes as in its fault-free run.  Its prompt outputs and its first
    three ticks share the clean run's launches (bit for bit: the poisoned
    row rides tick 2 and is caught after it); from tick 3 it decodes
    alone, one row where the clean run had two (standing tolerance)."""
    prompts = _prompts((6, 9), seed=5)
    clean = _run(_engine(params, max_batch=2), prompts, max_new=4)

    eng = _engine(params, max_batch=2)
    eng.poison_slot_at = {0: 2}  # uid 0's state goes NaN before tick 2
    done = _run(eng, prompts, max_new=4)
    assert done[0].status == "failed"
    assert "decode" in done[0].error
    assert done[0].generated.shape == (2, 32)  # ticks 0 and 1 preserved
    np.testing.assert_array_equal(clean[0].generated[:2], done[0].generated)
    assert done[1].status == "ok"
    assert done[1].generated.shape == (4, 32)
    _isolated(clean[1].outputs, done[1].outputs, exact=True)
    _isolated(clean[1].generated[:3], done[1].generated[:3], exact=True)
    _isolated(clean[1].generated, done[1].generated, exact=False)
    assert eng.quarantined == 1


def test_submit_rejects_nonfinite_prompt(params):
    eng = _engine(params)
    bad = _prompts((5,))[0]
    bad[2, 7] = np.nan
    with pytest.raises(NonFiniteStateError) as e:
        eng.submit(RecurrentRequest(uid=42, frames=bad))
    assert e.value.uids == (42,) and e.value.where == "prompt"
    assert "42" in str(e.value)
    assert not eng.queue  # nothing admitted


# ---------------------------------------------------------------------------
# deadlines, backpressure, watchdog
# ---------------------------------------------------------------------------


def test_max_ticks_deadline_retires_with_timeout_status(params):
    eng = _engine(params, max_batch=2)
    eng.submit(RecurrentRequest(uid=0, frames=_prompts((6,))[0],
                                max_new_frames=100, max_ticks=3))
    eng.submit(RecurrentRequest(uid=1, frames=_prompts((6,))[0],
                                max_new_frames=2))
    done = {c.uid: c for c in eng.run_to_completion()}
    assert done[0].status == "timeout"
    assert "max_ticks=3" in done[0].error
    assert done[0].generated.shape == (3, 32)  # partial work preserved
    assert done[1].status == "ok"


def test_wall_time_deadline_retires_with_timeout_status(params):
    eng = _engine(params, max_batch=1)
    eng.submit(RecurrentRequest(uid=0, frames=_prompts((6,))[0],
                                max_new_frames=10_000, deadline_s=0.0))
    done = eng.run_to_completion()
    assert done[0].status == "timeout"
    assert "deadline" in done[0].error


def test_run_to_completion_overrun_carries_done(params):
    """An engine-level overrun raises RequestTimeout carrying the
    completions already finished — and the budget is per call, so a
    drained engine can be reused with a fresh budget."""
    eng = _engine(params, max_batch=1)
    eng.submit(RecurrentRequest(uid=0, frames=_prompts((6,))[0],
                                max_new_frames=1))
    eng.submit(RecurrentRequest(uid=1, frames=_prompts((6,))[0],
                                max_new_frames=50))
    with pytest.raises(RequestTimeout) as e:
        eng.run_to_completion(max_ticks=5)
    assert [c.uid for c in e.value.done] == [0]  # finished work preserved
    assert e.value.uids == (1,)
    # the engine is still drainable — and the tick budget resets per call
    done = eng.run_to_completion(max_ticks=60)
    assert sorted(c.uid for c in done) == [0, 1]

    eng.submit(RecurrentRequest(uid=2, frames=_prompts((6,))[0],
                                max_new_frames=50))
    done = eng.run_to_completion(max_ticks=60)  # would overrun cumulatively
    assert sorted(c.uid for c in done) == [0, 1, 2]


def test_bounded_queue_reject_backpressure(params):
    eng = _engine(params, max_batch=1, max_queue=2)
    for uid in (0, 1):
        eng.submit(RecurrentRequest(uid=uid, frames=_prompts((5,))[0],
                                    max_new_frames=1))
    with pytest.raises(QueueFull) as e:
        eng.submit(RecurrentRequest(uid=2, frames=_prompts((5,))[0],
                                    max_new_frames=1))
    assert e.value.uids == (2,)
    assert sorted(c.uid for c in eng.run_to_completion()) == [0, 1]


def test_bounded_queue_drop_oldest_backpressure(params):
    eng = _engine(params, max_batch=1, max_queue=2,
                  backpressure="drop_oldest")
    for uid in (0, 1, 2):
        eng.submit(RecurrentRequest(uid=uid, frames=_prompts((5,))[0],
                                    max_new_frames=1))
    assert eng.dropped == 1
    done = {c.uid: c for c in eng.run_to_completion()}
    assert done[0].status == "failed"  # evicted head surfaces, never lost
    assert "evicted" in done[0].error
    assert done[1].status == "ok" and done[2].status == "ok"


def test_straggler_watchdog_observes_decode_ticks(params):
    eng = _engine(params, max_batch=2, watchdog_factor=1e6)  # never flags
    _run(eng, _prompts((6, 6)), max_new=3)
    assert eng.watchdog.ewma is not None  # ticks were observed
    assert eng.straggler_ticks == []


def test_engine_constructor_rejections_are_structured(params):
    with pytest.raises(PlanRejected, match="rnn_family"):
        RecurrentServingEngine(CFG, params, rnn_family="tcn", device="cpu")
    bidir = dataclasses.replace(CFG, bidirectional=True)
    with pytest.raises(PlanRejected, match="streaming decode"):
        RecurrentServingEngine(bidir, params, device="cpu")


# ---------------------------------------------------------------------------
# rows independent of the row count on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("on_card,rows", [(False, [1, 3]), (True, [2, 3])])
def test_one_row_hoist_runs_as_two_rows_on_the_card(params, monkeypatch,
                                                    on_card, rows):
    """On the card a one-row input product runs as two rows, the product
    every larger row count takes (cuBLAS takes another kernel for one
    row); on the CPU it runs as it is.  The card is claimed by patching
    the executor's device test; the product's row counts are recorded."""
    from repro_torch.dispatch import executor

    monkeypatch.setattr(executor, "_on_card", lambda t: on_card)
    seen = []
    matmul = torch.matmul

    def recording(a, b):
        seen.append(a.shape[0] * a.shape[1])
        return matmul(a, b)

    monkeypatch.setattr(executor.torch, "matmul", recording)
    layer = params["layers"][0]
    x = _xs(B=3, T=1)
    one = executor._hoist(layer, x[1:2], 4)
    three = executor._hoist(layer, x, 4)
    assert seen == rows
    assert one.shape == (1, 1, 4, 32) and three.shape == (3, 1, 4, 32)
    np.testing.assert_allclose(one[0].numpy(), three[1].numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
def test_cuda_hoist_rows_equal_across_row_counts(cuda, params):
    """Every row of the input product is bit-equal across row counts 1 to
    16 on the card, so a co-batched request's decode tick does not depend
    on how many slots share it."""
    from repro_torch.dispatch import executor

    layer = {k: v.to(cuda) for k, v in params["layers"][0].items()}
    x = _xs(B=16, T=1).to(cuda)
    full = executor._hoist(layer, x, 4)
    for m in range(1, 17):
        assert torch.equal(executor._hoist(layer, x[:m], 4), full[:m]), m
        assert torch.equal(executor._hoist(layer, x[m - 1:m], 4),
                           full[m - 1:m]), m


@pytest.mark.cuda
def test_cuda_decode_poison_isolates_bit_for_bit(cuda):
    """The decode-poison scenario served on the card: the co-batched
    request decodes alone after the quarantine and stays bit for bit
    equal to its fault-free run."""
    tp = init_stack(torch.Generator().manual_seed(0), CFG, torch.float32)
    prompts = _prompts((6, 9), seed=5)
    engine = dict(max_batch=2, device="cuda")
    clean = _run(RecurrentServingEngine(CFG, tp, **engine), prompts,
                 max_new=4)
    eng = RecurrentServingEngine(CFG, tp, **engine)
    eng.poison_slot_at = {0: 2}
    done = _run(eng, prompts, max_new=4)
    assert done[0].status == "failed" and done[1].status == "ok"
    np.testing.assert_array_equal(clean[1].outputs, done[1].outputs)
    np.testing.assert_array_equal(clean[1].generated, done[1].generated)
