"""Off the packed timeline: the port's ``lstm_cell`` kernel entry point and
its adapters, ``core.unfolded.unfold``, the research half of
``core.schedules``, and the executor's external branch (reference
schedules, per_step, T=0 items) against the JAX package on the CPU.

The same numpy-seeded inputs go through both packages; JAX runs its
Pallas kernels in interpret mode.  Tolerances: fp32 parity is 1e-5
absolute (the two packages sum the products in a different order);
anything with bfloat16 activations is 2e-2 (one bf16 rounding of |h| < 1
is up to 2^-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dispatch as jdispatch
from repro import rnn as jrnn
from repro.configs.sharp_lstm import lstm_config
from repro.core import schedules as jsch
from repro.core.gru import init_gru_layer as jinit_gru_layer
from repro.core.gru import init_gru_stack as jinit_gru_stack
from repro.kernels.lstm_cell import ops as jops
from repro.models.layers.lstm import init_lstm_layer as jinit_lstm_layer
from repro.models.layers.lstm import init_lstm_stack as jinit_lstm_stack

import repro_torch.dispatch as dispatch
from repro_torch import rnn
from repro_torch.convert import from_jax
from repro_torch.core import schedules as sch
from repro_torch.core.unfolded import unfold
from repro_torch.kernels.common import reset_counts
from repro_torch.kernels.gru_cell import ops as gru_ops
from repro_torch.kernels.lstm_cell import ops

FP32_TOL = 1e-5
BF16_TOL = 2e-2

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype):
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _xs(B, T, X, seed):
    return (np.random.default_rng(seed).standard_normal((B, T, X)) * 0.5
            ).astype(np.float32)


def _assert_tree_close(a, b, tol=FP32_TOL):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_close(a[k], b[k], tol)
        return
    np.testing.assert_allclose(_np(a), _np(b), atol=tol)


# ---------------------------------------------------------------------------
# lstm_cell and the adapters
# ---------------------------------------------------------------------------


def _cell_inputs(B, H, u_dtype, act_dtype, c_dtype, seed):
    rng = np.random.default_rng(seed)
    return (_both(_rand(rng, (H, 4, H), 0.2), u_dtype),
            _both(_rand(rng, (B, 4, H), 1.0), act_dtype),
            _both(_rand(rng, (B, H), 0.5), act_dtype),
            _both(_rand(rng, (B, H), 0.5), c_dtype))


@pytest.mark.parametrize("block_h,block_k", [
    (0, 0),      # the autotune table's default
    (8, 5),      # block_k does not divide H=24: the masked reduction tail
])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("u_dtype,act_dtype,c_dtype", [
    ("float32", "float32", "float32"),
    ("bfloat16", "float32", "float32"),   # the per_step BYSDNE step
    ("bfloat16", "bfloat16", "bfloat16"),  # c_prev read as fp32
])
def test_lstm_cell_matches_reference(block_h, block_k, B, u_dtype,
                                     act_dtype, c_dtype):
    args = _cell_inputs(B, 24, u_dtype, act_dtype, c_dtype, seed=B)
    ref = jops.lstm_cell(*(j for j, _ in args), block_h=block_h,
                         block_k=block_k, interpret=True)
    out = ops.lstm_cell(*(t for _, t in args), block_h=block_h,
                        block_k=block_k)
    tol = FP32_TOL if act_dtype == "float32" else BF16_TOL
    for r, o, name in zip(ref, out, ("h", "c")):
        assert o.shape == tuple(r.shape), name
        np.testing.assert_allclose(_np(o), _np(r), atol=tol, err_msg=name)
    assert out[0].dtype == TDT[act_dtype] and out[1].dtype == torch.float32


def test_adapters_match_reference_adapters():
    """as_cell_kernel / as_seq_kernel take the schedules' (H, 4H) U and
    (…, 4H) input half, as the reference's do."""
    rng = np.random.default_rng(7)
    U = _both(_rand(rng, (16, 64), 0.2), "float32")
    xw = _both(_rand(rng, (2, 5, 64), 1.0), "float32")
    h = _both(_rand(rng, (2, 16), 0.5), "float32")
    c = _both(_rand(rng, (2, 16), 0.5), "float32")
    reset_counts(ops.lstm_cell, ops.lstm_seq)
    ref = jops.as_cell_kernel(interpret=True)(U[0], xw[0][:, 0], h[0], c[0])
    out = ops.as_cell_kernel()(U[1], xw[1][:, 0], h[1], c[1])
    for r, o in zip(ref, out):
        np.testing.assert_allclose(_np(o), _np(r), atol=FP32_TOL)
    ref = jops.as_seq_kernel(interpret=True, block_t=2)(U[0], xw[0], h[0],
                                                        c[0])
    out = ops.as_seq_kernel(block_t=2)(U[1], xw[1], h[1], c[1])
    for r, o in zip(ref, out):
        np.testing.assert_allclose(_np(o), _np(r), atol=FP32_TOL)
    assert (ops.lstm_cell.calls, ops.lstm_seq.calls) == (1, 1)


def test_unfold_seq_fn_equals_recurrent_walk():
    """unfold's two forms agree: a per-step recur_fn walk and a seq_fn
    that consumes the whole precomputed input half at once."""
    xs = torch.randn(2, 6, 3, generator=torch.Generator().manual_seed(0))

    def recur(state, pre_t):
        state = 0.5 * state + pre_t
        return state, state

    def seq(state, pre):
        outs = []
        for t in range(pre.shape[1]):
            state, o = recur(state, pre[:, t])
            outs.append(o)
        return state, torch.stack(outs, dim=1)

    zero = torch.zeros(2, 3)
    a = unfold(lambda x: 2 * x, recur, xs, zero)
    b = unfold(lambda x: 2 * x, None, xs, zero, seq_fn=seq)
    for p, q in zip(a, b):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_cuda_cell_wrapper_refuses_cpu_tensors():
    args = [t for _, t in _cell_inputs(1, 8, "float32", "float32",
                                       "float32", seed=0)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lstm_cell_cuda(*args, block_h=8, block_k=8)


# ---------------------------------------------------------------------------
# stacks: research schedules, per_step, the oracle
# ---------------------------------------------------------------------------


def _lstm_stacks(H=24, L=2, seed=0, bidirectional=False):
    import dataclasses

    cfg = dataclasses.replace(lstm_config(H, layers=L), dtype="float32",
                              bidirectional=bidirectional)
    jp = jinit_lstm_stack(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return jp, from_jax(jp)


def _gru_stacks(H=24, L=2, seed=1):
    jp = jinit_gru_stack(jax.random.PRNGKey(seed), H, H, L, jnp.float32)
    return jp, from_jax(jp)


def _mixed_stacks(H=24, seed=2):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    jp = {"layers": [jinit_lstm_layer(keys[0], H, H, jnp.float32),
                     jinit_gru_layer(keys[1], H, H, jnp.float32),
                     jinit_lstm_layer(keys[2], H, H, jnp.float32)]}
    return jp, from_jax(jp)


STACKS = {"lstm": _lstm_stacks, "gru": _gru_stacks, "mixed": _mixed_stacks}
SCHEDULES = {
    "lstm": ("sequential", "batch", "intergate", "unfolded", "fused",
             "per_step"),
    "gru": ("sequential", "intergate", "unfolded", "fused", "per_step"),
    "mixed": ("unfolded", "per_step"),
}


@pytest.mark.parametrize("stack,schedule", [
    (s, sched) for s in SCHEDULES for sched in SCHEDULES[s]])
def test_forced_schedule_forward_matches_reference(stack, schedule):
    """compile(schedule=...) routes the item off the packed timeline: the
    plan equals the reference's, the output matches it, and per_step
    calls lstm_cell once per (lstm layer, step) — plan.launches — while a
    gru layer under per_step and every research schedule call no kernel."""
    jparams, params = STACKS[stack]()
    xs = _xs(2, 7, 24, seed=3)
    jcs = jrnn.compile(jparams, jrnn.ExecutionPolicy(schedule=schedule,
                                                     interpret=True))
    cs = rnn.compile(params, rnn.ExecutionPolicy(schedule=schedule),
                     device="cpu")
    entries = (ops.lstm_cell, ops.lstm_seq, gru_ops.gru_seq)
    reset_counts(*entries)
    ys = cs.forward(xs)
    np.testing.assert_allclose(_np(ys), _np(jcs.forward(xs)), atol=FP32_TOL)
    assert cs.plan.describe() == jcs.plan.describe()
    assert cs.plan.external == (0,)
    calls = sum(f.calls for f in entries)
    if schedule == "per_step":
        n_lstm = cs.families.count("lstm")
        assert ops.lstm_cell.calls == cs.plan.launches == n_lstm * 7
        assert calls == ops.lstm_cell.calls
    elif schedule == "fused":
        assert calls == cs.plan.launches == len(cs.families)
    else:
        assert calls == cs.plan.launches == 0


@pytest.mark.parametrize("stack", ["lstm", "gru", "mixed", "bidir"])
@pytest.mark.parametrize("schedule", list(sch.SCHEDULES))
def test_reference_stack_matches_reference(stack, schedule):
    if stack == "bidir":
        jparams, params = _lstm_stacks(H=16, bidirectional=True, seed=4)
        X = 16
    else:
        jparams, params = STACKS[stack]()
        X = 24
    xs = _xs(2, 6, X, seed=5)
    try:
        ref = jsch.reference_stack(jparams, jnp.asarray(xs), schedule)
    except ValueError as err:  # gru has no "batch" implementation
        with pytest.raises(ValueError) as ours:
            sch.reference_stack(params, torch.from_numpy(xs), schedule)
        assert str(ours.value) == str(err)
        return
    out = sch.reference_stack(params, torch.from_numpy(xs), schedule)
    np.testing.assert_allclose(_np(out), _np(ref), atol=FP32_TOL)


def test_layer_schedules_match_reference_unroll_in_bf16():
    """bf16 activations over bf16 weights: every LSTM layer schedule stays
    within bf16 tolerance of the reference's reference_unroll."""
    from repro.models.layers.lstm import reference_unroll as jref
    from repro_torch.models.layers.lstm import reference_unroll

    rng = np.random.default_rng(6)
    layer = {"W": _rand(rng, (16, 64), 0.25), "U": _rand(rng, (16, 64), 0.25),
             "b": _rand(rng, (64,), 0.1)}
    jl = {k: jnp.asarray(v, jnp.bfloat16) for k, v in layer.items()}
    tl = from_jax(jl)
    xs = _both(_rand(rng, (2, 5, 16), 0.5), "bfloat16")
    ref = jref(jl, xs[0])
    np.testing.assert_allclose(_np(reference_unroll(tl, xs[1])), _np(ref),
                               atol=BF16_TOL)
    for name, fn in sch.LAYER_FNS.items():
        np.testing.assert_allclose(_np(fn(tl, xs[1])), _np(ref),
                                   atol=BF16_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# the executor's external branch
# ---------------------------------------------------------------------------


def _items(mod, specs):
    return [mod.WorkItem(**s) for s in specs]


EXTERNAL_MIXES = {
    "t0+packed": [dict(uid=0, family="lstm", B=2, T=0, H=24, L=2),
                  dict(uid=1, family="lstm", B=2, T=5, H=24, L=2)],
    "t0-gru": [dict(uid=0, family="gru", B=1, T=0, H=24, L=2),
               dict(uid=1, family="gru", B=1, T=3, H=24, L=2)],
}


@pytest.mark.parametrize("schedule", [None, "per_step"])
@pytest.mark.parametrize("mix", sorted(EXTERNAL_MIXES))
def test_t0_and_per_step_items_execute_like_reference(mix, schedule):
    """T=0 items (always external, fused) and per_step items run through
    the schedule library; with collect_state they take the per-layer fused
    path and surface exact state, as in the reference."""
    specs = EXTERNAL_MIXES[mix]
    fam = specs[0]["family"]
    jparams, params = (_lstm_stacks if fam == "lstm" else _gru_stacks)()
    jplan = jdispatch.plan(_items(jdispatch, specs), schedule=schedule)
    plan = dispatch.plan(_items(dispatch, specs), schedule=schedule)
    assert plan.describe() == jplan.describe()
    assert 0 in plan.external
    xs = {s["uid"]: _xs(s["B"], s["T"], 24, seed=s["uid"]) for s in specs}
    jout, jst = jdispatch.execute(jplan, {u: jparams for u in xs},
                                  {u: jnp.asarray(x) for u, x in xs.items()},
                                  interpret=True, collect_state=True)
    out, st = dispatch.execute(plan, {u: params for u in xs},
                               {u: torch.from_numpy(x)
                                for u, x in xs.items()},
                               collect_state=True)
    for u in xs:
        assert tuple(out[u].shape) == tuple(jout[u].shape)
        np.testing.assert_allclose(_np(out[u]), _np(jout[u]), atol=FP32_TOL)
        _assert_tree_close(st[u], jst[u])


def test_external_items_reject_init_state_and_prefill():
    _, params = _lstm_stacks()
    plan = dispatch.plan(_items(dispatch, [dict(uid=0, family="lstm", B=1,
                                                 T=4, H=24, L=2)]),
                         schedule="per_step")
    state = {"h": torch.zeros(2, 1, 24), "c": torch.zeros(2, 1, 24)}
    with pytest.raises(ValueError, match="external-fallback"):
        dispatch.execute(plan, {0: params}, {0: torch.zeros(1, 4, 24)},
                         init_state={0: state})
    cs = rnn.compile(params, rnn.ExecutionPolicy(schedule="per_step"),
                     device="cpu")
    with pytest.raises(ValueError, match="no t=T state surface"):
        cs.prefill(torch.zeros(1, 4, 24))


def test_bidirectional_per_step_is_stateless_like_reference():
    jparams, params = _lstm_stacks(H=16, bidirectional=True, seed=8)
    specs = [dict(uid=0, family="lstm", B=2, T=5, H=16, L=2,
                  bidirectional=True)]
    jplan = jdispatch.plan(_items(jdispatch, specs), schedule="per_step")
    plan = dispatch.plan(_items(dispatch, specs), schedule="per_step")
    assert plan.describe() == jplan.describe()
    xs = _xs(2, 5, 16, seed=9)
    jout, jst = jdispatch.execute(jplan, {0: jparams}, {0: jnp.asarray(xs)},
                                  interpret=True, collect_state=True)
    reset_counts(ops.lstm_cell)
    out, st = dispatch.execute(plan, {0: params}, {0: torch.from_numpy(xs)},
                               collect_state=True)
    assert st[0] is None and jst[0] is None
    assert ops.lstm_cell.calls == plan.launches == 2 * 2 * 5
    np.testing.assert_allclose(_np(out[0]), _np(jout[0]), atol=FP32_TOL)


# ---------------------------------------------------------------------------
# on the card: the cell kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("block_k", [0, 24])
@pytest.mark.parametrize("u_dtype,act_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_cuda_lstm_cell_matches_plain(cuda, B, block_k, u_dtype, act_dtype):
    args = [t.to(cuda) for _, t in _cell_inputs(B, 340, u_dtype, act_dtype,
                                                "float32", seed=B)]
    ref = ops.lstm_cell_plain(*args)
    out = ops.lstm_cell(*args, block_k=block_k)
    tol = 1e-4 if act_dtype == "float32" else BF16_TOL
    for r, o in zip(ref, out):
        torch.testing.assert_close(o.float(), r.float(), rtol=0, atol=tol)
