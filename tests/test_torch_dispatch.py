"""The port's planner, plan verifier and rnn front-end against the JAX
package on the CPU.

Plans are pure Python in both packages, so the port's
``DispatchPlan.describe()`` must equal the reference's string exactly.
Execution is compared at fp32 tolerance 1e-5 (the two packages sum the
GEMMs in different orders); the JAX side runs its Pallas kernels in
interpret mode, as its own tests do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dispatch as jdispatch
from repro import rnn as jrnn
from repro.analysis.plancheck import check_plan as jcheck_plan
from repro.configs.sharp_lstm import lstm_config as jlstm_config
from repro.models.layers.lstm import init_lstm_stack as jinit_lstm_stack

import repro_torch.dispatch as dispatch
from repro_torch import rnn
from repro_torch.analysis.plancheck import check_plan
from repro_torch.convert import from_jax
from repro_torch.kernels.common import (KernelBuildError,
                                        KernelLaunchRefused, reset_counts)
from repro_torch.kernels.lstm_cell import ops

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _items(mod, specs):
    return [mod.WorkItem(**s) for s in specs]


PLAN_MIXES = {
    # the BYSDNE serving admission wave of chip_smoke.py
    "uni-wave": [dict(uid=i, family="lstm", B=1, T=t, H=340, L=5,
                      dtype="float32", share=0)
                 for i, t in enumerate((30, 30, 17, 45))],
    "bidir": [dict(uid=0, family="lstm", B=4, T=37, H=64, L=3,
                   bidirectional=True, share=0)],
    "bidir+uni": [dict(uid=0, family="lstm", B=2, T=20, H=32, L=2,
                       bidirectional=True),
                  dict(uid=1, family="lstm", B=2, T=20, H=32, L=3)],
    "cross-B": [dict(uid=i, family="lstm", B=b, T=t, H=32, L=2,
                     dtype="bfloat16", share=0, priority=p)
                for i, (b, t, p) in enumerate(((1, 9, 0), (3, 9, 1),
                                               (2, 5, 0), (1, 1, 0)))],
    "unshared": [dict(uid=0, family="lstm", B=2, T=64, H=256, L=4),
                 dict(uid=1, family="lstm", B=8, T=13, H=96, L=2, X=40)],
}


@pytest.mark.parametrize("mix", sorted(PLAN_MIXES))
@pytest.mark.parametrize("schedule,block_t", [
    (None, 0), (None, 4), ("wavefront", 0), ("fused", 0), ("per_step", 0),
    ("sequential", 0)])
def test_plan_describe_equals_reference(mix, schedule, block_t):
    specs = PLAN_MIXES[mix]
    ref = jdispatch.plan(_items(jdispatch, specs), schedule=schedule,
                         block_t=block_t)
    out = dispatch.plan(_items(dispatch, specs), schedule=schedule,
                        block_t=block_t)
    assert out.describe() == ref.describe()
    assert out.launches == ref.launches
    if not out.external:
        assert check_plan(out).describe() == jcheck_plan(ref).describe()


@pytest.mark.parametrize("k", [1, 4])
def test_decode_plan_describe_equals_reference(k):
    specs = [dict(uid=i, family="lstm", B=1, T=1, H=48, L=3, share=0)
             for i in range(k)]
    ref = jdispatch.plan_decode(_items(jdispatch, specs))
    out = dispatch.plan_decode(_items(dispatch, specs))
    assert out.describe() == ref.describe()
    assert out.launches == 1
    assert check_plan(out).describe() == jcheck_plan(ref).describe()


# ---------------------------------------------------------------------------
# rnn.compile against repro.rnn
# ---------------------------------------------------------------------------


def _stacks(bidirectional, dtype="float32", H=24, L=2, seed=0):
    import dataclasses

    cfg = dataclasses.replace(jlstm_config(H, layers=L), dtype=dtype,
                              bidirectional=bidirectional)
    jparams = jinit_lstm_stack(jax.random.PRNGKey(seed), cfg,
                               jnp.dtype(dtype))
    return jparams, from_jax(jparams)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_tree_close(a, b, tol=TOL):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_close(a[k], b[k], tol)
        return
    np.testing.assert_allclose(_np(a), _np(b), atol=tol)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_forward_and_prefill_match_reference(bidirectional):
    jparams, params = _stacks(bidirectional)
    xs = (np.random.default_rng(1).standard_normal((2, 13, 24)) * 0.5
          ).astype(np.float32)
    jcs = jrnn.compile(jparams, jrnn.ExecutionPolicy(interpret=True))
    cs = rnn.compile(params, device="cpu")
    reset_counts(ops.lstm_seq, ops.lstm_decode)
    ys = cs.forward(xs)
    assert ops.lstm_seq.calls == cs.plan.launches  # one call per slot
    np.testing.assert_allclose(_np(ys), _np(jcs.forward(xs)), atol=TOL)
    assert cs.plan.describe() == jcs.plan.describe()

    (ys, st), (jys, jst) = cs.prefill(xs), jcs.prefill(xs)
    np.testing.assert_allclose(_np(ys), _np(jys), atol=TOL)
    _assert_tree_close(st, jst)
    assert list(st) == (["fwd", "bwd"] if bidirectional else ["h", "c"])


def test_prefill_wave_then_decode_resume_matches_reference():
    """An admission wave of three ragged requests (one DispatchPlan), then
    two decode ticks resumed from the spliced state."""
    jparams, params = _stacks(False, H=32, L=3, seed=2)
    rng = np.random.default_rng(3)
    seqs = [(rng.standard_normal((1, t, 32)) * 0.5).astype(np.float32)
            for t in (9, 4, 9)]
    jcs = jrnn.compile(jparams, jrnn.ExecutionPolicy(interpret=True))
    cs = rnn.compile(params, device="cpu")
    reset_counts(ops.lstm_seq, ops.lstm_decode)
    res, jres = cs.prefill(seqs), jcs.prefill(seqs)
    assert ops.lstm_seq.calls == cs.plan.launches
    assert cs.plan.describe() == jcs.plan.describe()
    for (ys, st), (jys, jst) in zip(res, jres):
        np.testing.assert_allclose(_np(ys), _np(jys), atol=TOL)
        _assert_tree_close(st, jst)
    state = {k: torch.cat([st[k] for _, st in res], dim=1) for k in "hc"}
    jstate = {k: jnp.concatenate([st[k] for _, st in jres], axis=1)
              for k in "hc"}
    y = torch.cat([ys[:, -1:] for ys, _ in res])
    jy = jnp.concatenate([ys[:, -1:] for ys, _ in jres])
    for _ in range(2):
        reset_counts(ops.lstm_seq, ops.lstm_decode)
        y, state = cs.decode(y, state)
        jy, jstate = jcs.decode(jy, jstate)
        assert (ops.lstm_decode.calls, ops.lstm_seq.calls) == (1, 0)
        assert cs.last_decode_plan.launches == 1
        np.testing.assert_allclose(_np(y), _np(jy), atol=TOL)
        _assert_tree_close(state, jstate)


def test_trace_on_equals_trace_off():
    _, params = _stacks(True, seed=4)
    xs = torch.randn(2, 11, 24, generator=torch.Generator().manual_seed(0))
    off = rnn.compile(params, device="cpu").forward(xs)
    traced = rnn.compile(params, rnn.ExecutionPolicy(trace=True),
                         device="cpu")
    on = traced.forward(xs)
    torch.testing.assert_close(on, off, rtol=0, atol=0)
    names = {sp.name for sp in traced.tracer.events}
    assert {"forward", "plan", "verify", "hoist", "slot_launch"} <= names
    assert "observability:" in traced.describe()


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        rnn.compile(jlstm_config(16))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        rnn.resolve_device("cuda")


@pytest.mark.parametrize("policy_kw,item", [
    ({"precision": "bf16"}, "P1"), ({"sparsity": "block"}, "P1"),
    ({"cost_model": "measured"}, "P2")])
def test_unported_policy_values_raise(policy_kw, item):
    """Only the measured cost model (P2) is still unported, and it raises
    naming P2 whatever it is combined with.  The P1 values (reduced
    recurrent-weight precision, block sparsity) are ported: they construct
    on their own (tests/test_torch_precision.py runs them)."""
    with pytest.raises(NotImplementedError, match="P2"):
        rnn.ExecutionPolicy(**{**policy_kw, "cost_model": "measured"})
    if item == "P1":
        pol = rnn.ExecutionPolicy(**policy_kw)
        assert {k: getattr(pol, k) for k in policy_kw} == policy_kw


def test_policy_validation_messages_match_reference():
    for kw in ({"schedule": "vibes"}, {"block_t": -1}, {"macs": 0},
               {"on_fault": "pray"}, {"verify": "maybe"}):
        with pytest.raises(ValueError) as ours:
            rnn.ExecutionPolicy(**kw)
        with pytest.raises(ValueError) as ref:
            jrnn.ExecutionPolicy(**kw)
        assert str(ours.value) == str(ref.value)


def test_unported_families_and_schedules_raise():
    """What the port cannot execute raises before any work: a multi-layer
    rglru item is plan-only in the reference too (its layers are joined by
    block mixing that lives in the model), and execute() refuses it with
    the reference's message.  Single-layer rglru items and quantized
    recurrent weights run (tests/test_torch_rglru.py,
    tests/test_torch_precision.py), as do the GRU family and the
    off-timeline schedules (tests/test_torch_gru.py,
    tests/test_torch_offpath.py)."""
    multi = dispatch.plan([dispatch.WorkItem(uid=0, family="rglru", B=1,
                                             T=4, H=8, L=2)])
    with pytest.raises(NotImplementedError, match="plan-only items"):
        dispatch.execute(multi, {}, {})
    rglru = dispatch.plan([dispatch.WorkItem(uid=0, family="rglru", B=1,
                                             T=4, H=8, L=1)])
    assert dispatch.execute(rglru, {}, {0: (torch.zeros(1, 4, 8),
                                            torch.ones(1, 4, 8))})[0].shape \
        == (1, 4, 8)
    quant = dispatch.plan([dispatch.WorkItem(uid=0, family="lstm", B=1,
                                             T=4, H=8, L=1,
                                             precision="int8")])
    stack = {"layers": [{"W": torch.ones(8, 32) * 0.1,
                         "U": torch.ones(8, 32) * 0.1,
                         "b": torch.zeros(32)}]}
    assert dispatch.execute(quant, {0: stack}, {0: torch.ones(1, 4, 8)}
                            )[0].shape == (1, 4, 8)
    gru = {"layers": [{"W": torch.zeros(8, 24), "U": torch.zeros(8, 24),
                       "b": torch.zeros(24)}]}
    assert rnn.compile(gru, device="cpu").forward(
        torch.zeros(1, 5, 8)).shape == (1, 5, 8)
    _, params = _stacks(False)
    cs = rnn.compile(params, rnn.ExecutionPolicy(schedule="sequential"),
                     device="cpu")
    assert cs.forward(torch.zeros(1, 5, 24)).shape == (1, 5, 24)


def test_guarded_ladder_recovers_and_build_errors_pass_through(
        monkeypatch):
    _, params = _stacks(False, seed=5)
    xs = torch.randn(2, 9, 24, generator=torch.Generator().manual_seed(1))
    healthy = rnn.compile(params, device="cpu").forward(xs)

    cs = rnn.compile(params, rnn.ExecutionPolicy(on_fault="fallback"),
                     device="cpu")
    cs.fault.arm([0], through_level=0)
    torch.testing.assert_close(cs.forward(xs), healthy, rtol=0, atol=TOL)
    assert (cs.stats.degraded_launches, cs.stats.fallback_level) == (1, 1)
    assert "DEGRADED" in cs.describe()

    def broken(*a, **k):
        raise KernelBuildError("nvcc: error")

    import repro_torch.dispatch.executor as executor
    monkeypatch.setattr(executor, "lstm_seq", broken)
    with pytest.raises(KernelBuildError):
        cs.forward(xs)


def _shape_stack(gates, H, X=8):
    """A stack of meta tensors, one layer per entry of ``gates`` (4: lstm,
    3: gru): ``executor.kernel_refusal`` reads shapes only."""
    return {"layers": [
        {"W": torch.empty((X if i == 0 else H, g * H), device="meta"),
         "U": torch.empty((H, g * H), device="meta"),
         "b": torch.empty((g * H,), device="meta")}
        for i, g in enumerate(gates)]}


@pytest.mark.parametrize("H", [2048, 4096])
@pytest.mark.parametrize("schedule", rnn.policy.SCHEDULES)
@pytest.mark.parametrize("family,gates", [
    ("lstm", (4, 4)), ("gru", (3, 3)), ("mixed", (4, 3))])
def test_compile_refuses_a_stack_past_its_kernels_limit(monkeypatch, family,
                                                        gates, schedule, H):
    """F5: on the card, a stack whose forward would launch a kernel past
    its limit on H is refused at compile with one KernelLaunchRefused
    naming the kernel and the limit.  The planned schedules launch the
    sequence kernels (H <= 2048); per_step launches only lstm_cell (GRU
    layers run plain PyTorch there), whose limit lies far above; the
    research schedules launch nothing."""
    from repro_torch.dispatch.executor import kernel_refusal
    from repro_torch.kernels.common import CELL_MAX_H, SEQ_MAX_H
    from repro_torch.rnn import compiled

    params = _shape_stack(gates, H)
    pol = rnn.ExecutionPolicy(schedule=schedule)
    why = kernel_refusal(params, pol)
    if H <= SEQ_MAX_H or schedule not in ("auto", "wavefront", "fused"):
        assert why is None
    else:
        name = "lstm_seq" if family == "lstm" else "gru_seq"
        assert why == (f"{name} takes H <= 2048 on the card, and this "
                       f"stack's forward under schedule={schedule!r} "
                       f"launches it at H={H}")
        monkeypatch.setattr(compiled, "resolve_device",
                            lambda d: torch.device("cuda"))
        with pytest.raises(KernelLaunchRefused,
                           match=f"rnn.compile: {name} takes H"):
            rnn.compile(params, pol)
    wide = _shape_stack(gates, CELL_MAX_H + 8)
    per_step = rnn.ExecutionPolicy(schedule="per_step")
    assert kernel_refusal(wide, per_step) == (
        None if family == "gru" else
        f"lstm_cell takes H <= {CELL_MAX_H} on the card, and this stack's "
        f"forward under schedule='per_step' launches it at "
        f"H={CELL_MAX_H + 8}")


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_ladder_reraises_a_sequence_launch_past_the_limit(monkeypatch,
                                                          family):
    """F5: past H = 2048 the sequence wrappers raise KernelLaunchRefused
    before any other check, and the guarded ladder (on_fault="fallback",
    kernel rungs only, as on the card) re-raises it instead of retrying
    the slot per step: one call of the entry point, no launch, no
    degraded slot.  The card is claimed by patching the executor's and
    the entry point's device tests, so the real wrapper runs up to its
    refusal."""
    import repro_torch.dispatch.executor as executor
    from repro_torch.kernels.gru_cell import ops as gru_ops

    H, g = 2049, 4 if family == "lstm" else 3
    bf16 = torch.bfloat16
    params = {"layers": [{"W": torch.zeros((8, g * H), dtype=bf16),
                          "U": torch.zeros((H, g * H), dtype=bf16),
                          "b": torch.zeros((g * H,), dtype=bf16)}]}
    cs = rnn.compile(params, rnn.ExecutionPolicy(schedule="fused",
                                                 on_fault="fallback"),
                     device="cpu")
    mod = ops if family == "lstm" else gru_ops
    entry = mod.lstm_seq if family == "lstm" else mod.gru_seq
    monkeypatch.setattr(executor, "_on_card", lambda t: True)
    monkeypatch.setattr(mod, "on_cuda", lambda name, device: True)
    reset_counts(entry)
    with pytest.raises(KernelLaunchRefused,
                       match=f"{family}_seq: the sequence kernels take H "
                             "<= 2048, got H=2049"):
        cs.forward(torch.zeros((1, 3, 8), dtype=bf16))
    assert (entry.calls, entry.kernel_launches) == (1, 0)
    assert cs.stats.degraded_launches == 0


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
def test_refused_decode_launch_passes_through_the_ladder(monkeypatch,
                                                         on_card):
    """A decode kernel whose launch configuration the card refuses (its
    thread-block cluster) raises KernelLaunchRefused through the ladder
    under on_fault="fallback": no rung serves the tick and no degraded
    launch is recorded."""
    import repro_torch.dispatch.executor as executor

    def refused(*a, **k):
        raise KernelLaunchRefused("lstm_decode: CUDA kernel launch failed "
                                  "with cudaError 912")

    monkeypatch.setattr(executor, "_on_card", lambda t: on_card)
    monkeypatch.setattr(executor, "lstm_decode", refused)
    _, params = _stacks(False, seed=5)
    xs = torch.randn(2, 1, 24, generator=torch.Generator().manual_seed(1))
    cs = rnn.compile(params, rnn.ExecutionPolicy(on_fault="fallback"),
                     device="cpu")
    state = {"h": torch.zeros(2, 2, 24), "c": torch.zeros(2, 2, 24)}
    with pytest.raises(KernelLaunchRefused, match="912"):
        cs.decode(xs, state)
    assert cs.stats.degraded_launches == 0


@pytest.mark.parametrize("on_card,through,expect", [
    (False, 0, (1, 1)), (False, 1, (1, 2)), (True, 0, (1, 1)),
    (True, 1, None)],
    ids=["cpu-per_step", "cpu-reference", "card-per_step", "card-raises"])
@pytest.mark.parametrize("path", ["forward", "decode"])
def test_ladder_ends_at_the_last_kernel_rung_on_the_card(
        monkeypatch, path, on_card, through, expect):
    """On CUDA tensors the ladder holds only kernel rungs, so a fault that
    the per-step (per-layer) rung cannot absorb is raised instead of being
    served by plain PyTorch; on the CPU the reference rung absorbs it.
    The card is claimed by patching the executor's device test; injected
    faults fire before a rung runs, so no rung launches here."""
    import repro_torch.dispatch.executor as executor

    monkeypatch.setattr(executor, "_on_card", lambda t: on_card)
    _, params = _stacks(False, seed=5)
    xs = torch.randn(2, 9, 24, generator=torch.Generator().manual_seed(1))
    healthy = rnn.compile(params, device="cpu")
    cs = rnn.compile(params, rnn.ExecutionPolicy(on_fault="fallback"),
                     device="cpu")
    if path == "forward":
        want = healthy.forward(xs)
        run = lambda: cs.forward(xs)  # noqa: E731
    else:
        state = {"h": torch.zeros(2, 2, 24), "c": torch.zeros(2, 2, 24)}
        want = healthy.decode(xs[:, :1], state)[0]
        run = lambda: cs.decode(xs[:, :1], state)[0]  # noqa: E731
    cs.fault.arm([0], through_level=through)
    if expect is None:
        with pytest.raises(executor.LaunchError) as err:
            run()
        assert err.value.level == "per_step"
        assert cs.stats.degraded_launches == 0
        return
    torch.testing.assert_close(run(), want, rtol=0, atol=TOL)
    assert (cs.stats.degraded_launches, cs.stats.fallback_level) == expect
