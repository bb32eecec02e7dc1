"""The port's GRU family (repro_torch.kernels.gru_cell, core.gru, the GRU
half of the dispatcher, rnn.compile(rnn_family="gru"), mixed lstm/gru
stacks and the GRU serving engine) against the JAX package on the CPU,
plus the port's own bit-identities.

The same numpy-seeded inputs go through both packages; JAX runs its
Pallas kernels in interpret mode, as its own tests do, and the port's
entry points run their plain PyTorch versions on the CPU.  The CUDA
kernels themselves are held against those plain versions on the card by
the ``cuda``-marked tests here and by chip_smoke.py.

Tolerances: fp32 parity is 1e-5 absolute (the two packages sum the h·U
products in a different order); anything with bfloat16 activations is
2e-2 (one bf16 rounding of |h| < 1 is up to 2^-8); the serving engines
run fp32 state over bf16 weights through prompt recurrences and fed-back
decode ticks, 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dispatch as jdispatch
from repro import rnn as jrnn
from repro.configs.sharp_lstm import lstm_config
from repro.core.gru import init_gru_layer as jinit_gru_layer
from repro.core.gru import init_gru_stack as jinit_gru_stack
from repro.kernels.gru_cell import ops as jops
from repro.models.layers.lstm import init_lstm_layer as jinit_lstm_layer
from repro.serving import recurrent as jserving

import repro_torch.dispatch as dispatch
from repro_torch import rnn
from repro_torch.configs.sharp_lstm import lstm_config as tlstm_config
from repro_torch.convert import from_jax
from repro_torch.core import gru as gru_mod
from repro_torch.kernels import build
from repro_torch.kernels import common
from repro_torch.kernels.common import reset_counts
from repro_torch.kernels.gru_cell import ops
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.serving import recurrent as serving
from tests.test_torch_kernels import _seq_inputs as _lstm_seq_inputs
from tests.test_torch_kernels import (_torch, assert_seq_bits,
                                      cuda_seq_scale, decode_slices)

FP32_TOL = 1e-5
BF16_TOL = 2e-2
SERVE_TOL = 1e-4

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
    """One numpy array as a JAX array and a torch tensor of ``dtype`` (the
    bf16 rounding happens once, in JAX, and carries over exactly)."""
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_tree_close(a, b, tol=FP32_TOL):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_close(a[k], b[k], tol)
        return
    np.testing.assert_allclose(_np(a), _np(b), atol=tol)


def _seq_inputs(G, B, T, H, u_dtype, act_dtype, seed):
    rng = np.random.default_rng(seed)
    lead = (G,) if G else ()
    return (_both(_rand(rng, lead + (H, 3, H), 0.2), u_dtype),
            _both(_rand(rng, lead + (B, T, 3, H), 1.0), act_dtype),
            _both(_rand(rng, lead + (B, H), 0.5), act_dtype))


# ---------------------------------------------------------------------------
# kernel entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G,B,T,H,block_t,b_valid", [
    (0, 1, 1, 24, 0, None),        # unstacked, one step
    (0, 3, 7, 24, 3, None),        # unstacked, remainder chunk (3+3+1)
    (2, 4, 9, 24, 4, (4, 2)),      # stacked, ragged b_valid, remainder
    (3, 2, 5, 10, 0, None),        # H % 4 != 0, autotuned stripe
])
@pytest.mark.parametrize("u_dtype,act_dtype", [
    ("float32", "float32"),
    ("bfloat16", "float32"),       # the serving path: bf16 U, fp32 xw/h
    ("float32", "bfloat16"),
    ("bfloat16", "bfloat16"),
])
def test_gru_seq_matches_reference(G, B, T, H, block_t, b_valid, u_dtype,
                                   act_dtype):
    (Uj, Ut), (xj, xt), (hj, ht) = _seq_inputs(
        G, B, T, H, u_dtype, act_dtype, seed=G * 100 + B * 10 + T)
    ref = jops.gru_seq(Uj, xj, hj, block_t=block_t, interpret=True,
                       **({} if b_valid is None else
                          {"b_valid": jnp.asarray(b_valid)}))
    out = ops.gru_seq(Ut, xt, ht, block_t=block_t,
                      **({} if b_valid is None else {"b_valid": b_valid}))
    tol = FP32_TOL if act_dtype == "float32" else BF16_TOL
    for r, o, name in zip(ref, out, ("hs", "h_T")):
        assert o.shape == tuple(r.shape), name
        np.testing.assert_allclose(_np(o), _np(r), atol=tol, err_msg=name)
    assert out[0].dtype == out[1].dtype == TDT[act_dtype]


@pytest.mark.parametrize("G", [0, 2])
def test_gru_seq_t0_and_zero_state_default(G):
    (Uj, Ut), (xj, xt), (hj, ht) = _seq_inputs(
        G, 3, 0, 8, "float32", "bfloat16", seed=1)
    ref = jops.gru_seq(Uj, xj, hj, interpret=True)
    hs, h_n = ops.gru_seq(Ut, xt, ht)
    assert hs.shape == tuple(ref[0].shape) and hs.dtype == torch.bfloat16
    assert torch.equal(h_n, ht)
    (Uj, Ut), (xj, xt), _ = _seq_inputs(G, 2, 5, 8, "float32", "float32",
                                        seed=2)
    ref = jops.gru_seq(Uj, xj, interpret=True)   # h0 omitted: zeros
    for r, o in zip(ref, ops.gru_seq(Ut, xt)):
        np.testing.assert_allclose(_np(o), _np(r), atol=FP32_TOL)
    with pytest.raises(ValueError, match="stacked"):
        ops.gru_seq(Ut if G == 0 else Ut[0], xt if G == 0 else xt[0],
                    b_valid=[1])


def _decode_inputs(L, B, H, w_dtype, act_dtype, seed):
    rng = np.random.default_rng(seed)
    W0 = _rand(rng, (H, 3, H), 0.2)
    W0[:] = np.nan  # Ws[0] is never read by either package
    Ws = np.concatenate([W0[None], _rand(rng, (L - 1, H, 3, H), 0.2)])
    return (_both(_rand(rng, (B, 3, H), 1.0), act_dtype),
            _both(Ws, w_dtype),
            _both(_rand(rng, (L, 3, H), 0.1), w_dtype),
            _both(_rand(rng, (L, H, 3, H), 0.2), w_dtype),
            _both(_rand(rng, (L, B, H), 0.5), act_dtype))


@pytest.mark.parametrize("B,H", [(1, 24), (3, 24), (2, 10)])
@pytest.mark.parametrize("w_dtype,act_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("float32", "bfloat16"), ("bfloat16", "bfloat16")])
def test_gru_decode_matches_reference(B, H, w_dtype, act_dtype):
    args = _decode_inputs(3, B, H, w_dtype, act_dtype, seed=B + H)
    ref = jops.gru_decode(*(j for j, _ in args), interpret=True)
    out = ops.gru_decode(*(t for _, t in args))
    tol = FP32_TOL if act_dtype == "float32" else BF16_TOL
    assert out.shape == tuple(ref.shape) and out.dtype == TDT[act_dtype]
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol)


@pytest.mark.parametrize("H,B", [(72, 1), (72, 5), (50, 3)])
@pytest.mark.parametrize("w_dtype,act_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_gru_decode_matches_reference_at_cluster_widths(H, B, w_dtype,
                                                        act_dtype):
    """The plain version against the JAX kernel at widths the card splits
    over several CTAs (H = 72: 8 slices) and at one whose slices take
    plain loads (H = 50)."""
    assert ops.decode_splits(H, 3) > 1
    args = _decode_inputs(3, B, H, w_dtype, act_dtype, seed=H + B)
    ref = jops.gru_decode(*(j for j, _ in args), interpret=True)
    out = ops.gru_decode(*(t for _, t in args))
    tol = FP32_TOL if act_dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol)


def test_gru_decode_splits_are_the_shared_rule():
    """gru_decode's cluster split is the shared rule at three gates: a
    function of (H, 3) only, 16 CTAs at H = 340 and 1024, slices that
    cover every unit once on the unit alignment."""
    assert ops.decode_splits is common.decode_splits
    for H in (50, 72, 340, 1024):
        S = ops.decode_splits(H, 3)
        slices = decode_slices(H, 3)
        A = common.decode_unit_align(H)
        assert len(slices) == S
        assert [u for lo, hi in slices for u in range(lo, hi)] == list(
            range(H))
        assert all(lo % A == 0 for lo, _ in slices)
    assert ops.decode_splits(340, 3) == ops.decode_splits(1024, 3) == 16


def test_chunked_walk_equals_single_launch_fp32():
    """fp32: chaining chunks through h_T is bit-identical to one launch
    over the whole sequence (h never leaves fp32)."""
    (_, U3), (_, xw), (_, h0) = _seq_inputs(2, 3, 11, 20, "bfloat16",
                                            "float32", seed=9)
    hs, h_n = ops.gru_seq(U3, xw, h0, block_t=11)
    outs, h = [], h0
    for t0, t1 in ((0, 4), (4, 8), (8, 11)):
        o, h = ops.gru_seq(U3, xw[:, :, t0:t1], h, block_t=t1 - t0)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, dim=2), hs, rtol=0, atol=0)
    torch.testing.assert_close(h, h_n, rtol=0, atol=0)


def test_padded_rows_are_exact_noops():
    """Ragged-B: rows >= b_valid[g] pass their state through (and hs
    repeats it), and valid rows are bit-identical to a launch without the
    padding."""
    (_, U3), (_, xw), (_, h0) = _seq_inputs(2, 4, 6, 16, "bfloat16",
                                            "float32", seed=3)
    hs, h_n = ops.gru_seq(U3, xw, h0, b_valid=[4, 2])
    torch.testing.assert_close(h_n[1, 2:], h0[1, 2:], rtol=0, atol=0)
    torch.testing.assert_close(hs[1, 2:], h0[1, 2:, None].expand(2, 6, 16),
                               rtol=0, atol=0)
    solo = ops.gru_seq(U3[1], xw[1, :2], h0[1, :2])
    for full, s in zip((hs, h_n), solo):
        torch.testing.assert_close(full[1, :2], s, rtol=0, atol=0)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_chained_decode_equals_per_layer_loop(w_dtype):
    """fp32 activations (the serving path): one chained GRU tick equals L
    per-layer T=1 sequence calls with the input GEMM chained between
    them, bit for bit."""
    xw0, Ws, bs, Us, h0 = [t for _, t in _decode_inputs(
        4, 3, 16, w_dtype, "float32", seed=11)]
    h_n = ops.gru_decode(xw0, Ws, bs, Us, h0)
    xw, hs = xw0, []
    for l in range(4):
        if l:
            xw = (hs[-1].float() @ Ws[l].reshape(16, 48).float()
                  + bs[l].reshape(48).float()).reshape(3, 3, 16)
        _, h = ops.gru_seq(Us[l], xw[:, None], h0[l], block_t=1)
        hs.append(h)
    torch.testing.assert_close(torch.stack(hs), h_n, rtol=0, atol=0)


def test_counters_and_registered_kernels():
    reset_counts(ops.gru_seq, ops.gru_decode)
    (_, U3), (_, xw), (_, h0) = _seq_inputs(0, 1, 3, 8, "float32",
                                            "float32", seed=0)
    for _ in range(3):
        ops.gru_seq(U3, xw, h0)
    ops.gru_decode(*[t for _, t in _decode_inputs(2, 1, 8, "float32",
                                                   "float32", seed=0)])
    assert (ops.gru_seq.calls, ops.gru_seq.kernel_launches) == (3, 0)
    assert (ops.gru_decode.calls, ops.gru_decode.kernel_launches) == (1, 0)
    assert {"gru_seq", "gru_decode", "lstm_seq", "lstm_decode",
            "lstm_cell", "rglru_scan"} <= set(build.all_kernels())
    # the int8 branch counts like any call (and on the CPU launches nothing)
    ops.gru_seq(U3.to(torch.int8), xw, u_scales=torch.ones(3))
    assert (ops.gru_seq.calls, ops.gru_seq.kernel_launches) == (4, 0)


def test_cuda_wrappers_refuse_cpu_tensors():
    (_, U3), (_, xw), (_, h0) = _seq_inputs(1, 1, 2, 8, "float32",
                                            "float32", seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gru_seq_cuda(U3, xw, h0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gru_decode_cuda(*[t for _, t in _decode_inputs(
            2, 1, 8, "float32", "float32", seed=0)])


# ---------------------------------------------------------------------------
# planning: describe() parity
# ---------------------------------------------------------------------------

PLAN_MIXES = {
    "gru-wave": [dict(uid=i, family="gru", B=1, T=t, H=340, L=5,
                      dtype="float32", share=0)
                 for i, t in enumerate((30, 30, 17, 45))],
    "gru-cross-B": [dict(uid=i, family="gru", B=b, T=t, H=32, L=2,
                         dtype="bfloat16", share=0)
                    for i, (b, t) in enumerate(((1, 9), (3, 9), (2, 5)))],
    "mixed": [dict(uid=0, family="lstm", B=2, T=21, H=32, L=4,
                   families=("lstm", "gru", "lstm", "gru"))],
    "gru+lstm": [dict(uid=0, family="gru", B=2, T=12, H=24, L=2),
                 dict(uid=1, family="lstm", B=2, T=12, H=24, L=3)],
}


def _items(mod, specs):
    return [mod.WorkItem(**s) for s in specs]


@pytest.mark.parametrize("mix", sorted(PLAN_MIXES))
@pytest.mark.parametrize("schedule,block_t", [
    (None, 0), (None, 4), ("wavefront", 0), ("fused", 0)])
def test_gru_plan_describe_equals_reference(mix, schedule, block_t):
    specs = PLAN_MIXES[mix]
    ref = jdispatch.plan(_items(jdispatch, specs), schedule=schedule,
                         block_t=block_t)
    out = dispatch.plan(_items(dispatch, specs), schedule=schedule,
                        block_t=block_t)
    assert out.describe() == ref.describe()
    assert out.launches == ref.launches


@pytest.mark.parametrize("k", [1, 3])
def test_gru_decode_plan_describe_equals_reference(k):
    specs = [dict(uid=i, family="gru", B=1, T=1, H=48, L=3, share=0)
             for i in range(k)]
    ref = jdispatch.plan_decode(_items(jdispatch, specs))
    out = dispatch.plan_decode(_items(dispatch, specs))
    assert out.describe() == ref.describe()
    assert out.launches == 1


# ---------------------------------------------------------------------------
# rnn.compile: GRU stacks and mixed stacks
# ---------------------------------------------------------------------------


def _gru_stacks(H=24, L=3, dtype="float32", seed=0):
    jparams = jinit_gru_stack(jax.random.PRNGKey(seed), H, H, L,
                              jnp.dtype(dtype))
    return jparams, from_jax(jparams)


def _mixed_stacks(H=24, seed=3):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    inits = (jinit_lstm_layer, jinit_gru_layer, jinit_lstm_layer,
             jinit_gru_layer)
    jparams = {"layers": [init(k, H, H, jnp.float32)
                          for init, k in zip(inits, keys)]}
    return jparams, from_jax(jparams)


def _xs(B, T, X, seed):
    return (np.random.default_rng(seed).standard_normal((B, T, X)) * 0.5
            ).astype(np.float32)


def test_gru_config_compiles_with_the_gru_initializer():
    cfg = dataclasses.replace(tlstm_config(16, layers=2), dtype="float32")
    cs = rnn.compile(cfg, rnn_family="gru", device="cpu", seed=0)
    assert cs.families == ("gru", "gru")
    assert cs.params["layers"][0]["U"].shape == (16, 48)
    ys = cs.forward(_xs(2, 5, 16, seed=0))
    assert ys.shape == (2, 5, 16) and bool(torch.isfinite(ys).all())
    with pytest.raises(ValueError, match="bidirectional GRU"):
        rnn.compile(dataclasses.replace(cfg, bidirectional=True),
                    rnn_family="gru", device="cpu")


def test_gru_forward_prefill_and_decode_resume_match_reference():
    jparams, params = _gru_stacks()
    xs = _xs(2, 13, 24, seed=1)
    jcs = jrnn.compile(jparams, jrnn.ExecutionPolicy(interpret=True))
    cs = rnn.compile(params, device="cpu")
    reset_counts(ops.gru_seq, ops.gru_decode, lstm_ops.lstm_seq)
    ys = cs.forward(xs)
    assert ops.gru_seq.calls == cs.plan.launches and \
        lstm_ops.lstm_seq.calls == 0
    np.testing.assert_allclose(_np(ys), _np(jcs.forward(xs)), atol=FP32_TOL)
    assert cs.plan.describe() == jcs.plan.describe()

    (ys, st), (jys, jst) = cs.prefill(xs), jcs.prefill(xs)
    np.testing.assert_allclose(_np(ys), _np(jys), atol=FP32_TOL)
    assert list(st) == ["h"]
    _assert_tree_close(st, jst)
    y, jy = ys[:, -1:], jys[:, -1:]
    for _ in range(2):
        reset_counts(ops.gru_seq, ops.gru_decode)
        y, st = cs.decode(y, st)
        jy, jst = jcs.decode(jy, jst)
        assert (ops.gru_decode.calls, ops.gru_seq.calls) == (1, 0)
        assert cs.last_decode_plan.launches == 1
        np.testing.assert_allclose(_np(y), _np(jy), atol=FP32_TOL)
        _assert_tree_close(st, jst)


def test_bidirectional_gru_forward_matches_reference():
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    jparams = {"layers": [
        {"fwd": jinit_gru_layer(keys[0], 16, 16, jnp.float32),
         "bwd": jinit_gru_layer(keys[1], 16, 16, jnp.float32)},
        {"fwd": jinit_gru_layer(keys[2], 32, 16, jnp.float32),
         "bwd": jinit_gru_layer(keys[3], 32, 16, jnp.float32)}]}
    xs = _xs(2, 11, 16, seed=2)
    jcs = jrnn.compile(jparams, jrnn.ExecutionPolicy(interpret=True))
    cs = rnn.compile(from_jax(jparams), device="cpu")
    ys = cs.forward(xs)
    assert ys.shape == (2, 11, 32)
    np.testing.assert_allclose(_np(ys), _np(jcs.forward(xs)), atol=FP32_TOL)
    assert cs.plan.describe() == jcs.plan.describe()


def test_mixed_stack_forward_and_decode_match_reference():
    jparams, params = _mixed_stacks()
    xs = _xs(2, 9, 24, seed=3)
    jcs = jrnn.compile(jparams, jrnn.ExecutionPolicy(interpret=True))
    cs = rnn.compile(params, device="cpu")
    reset_counts(ops.gru_seq, lstm_ops.lstm_seq)
    ys = cs.forward(xs)
    assert ops.gru_seq.calls + lstm_ops.lstm_seq.calls == cs.plan.launches
    np.testing.assert_allclose(_np(ys), _np(jcs.forward(xs)), atol=FP32_TOL)
    assert cs.plan.describe() == jcs.plan.describe()
    assert "lstm/gru/lstm/gru" in cs.describe()

    (ys, st), (jys, jst) = cs.prefill(xs), jcs.prefill(xs)
    _assert_tree_close(st, jst)
    assert not st["c"][1].any() and not st["c"][3].any()  # gru rows
    reset_counts(ops.gru_seq, ops.gru_decode, lstm_ops.lstm_seq,
                 lstm_ops.lstm_decode)
    y, st = cs.decode(ys[:, -1:], st)
    jy, jst = jcs.decode(jys[:, -1:], jst)
    # the forced per-layer wavefront bt=1 plan: L launches per tick
    assert cs.last_decode_plan.launches == 4
    assert (ops.gru_seq.calls, lstm_ops.lstm_seq.calls) == (2, 2)
    assert ops.gru_decode.calls + lstm_ops.lstm_decode.calls == 0
    assert cs.last_decode_plan.describe() == jcs.last_decode_plan.describe()
    np.testing.assert_allclose(_np(y), _np(jy), atol=FP32_TOL)
    _assert_tree_close(st, jst)


def test_mixed_stacks_cannot_be_bidirectional():
    _, params = _mixed_stacks(H=8)
    bidir = {"layers": [{"fwd": l, "bwd": l} for l in params["layers"]]}
    with pytest.raises(ValueError, match="mixed-family"):
        rnn.compile(bidir, device="cpu")


def test_trace_on_equals_trace_off():
    _, params = _gru_stacks(seed=5)
    xs = torch.randn(2, 11, 24, generator=torch.Generator().manual_seed(0))
    off = rnn.compile(params, device="cpu").forward(xs)
    traced = rnn.compile(params, rnn.ExecutionPolicy(trace=True),
                         device="cpu")
    on = traced.forward(xs)
    torch.testing.assert_close(on, off, rtol=0, atol=0)
    assert {"forward", "hoist", "slot_launch"} <= {
        sp.name for sp in traced.tracer.events}


@pytest.mark.parametrize("on_card,through,expect", [
    (False, 0, (1, 1)), (False, 1, (1, 2)), (True, 0, (1, 1)),
    (True, 1, None)],
    ids=["cpu-per_step", "cpu-reference", "card-per_step", "card-raises"])
@pytest.mark.parametrize("path", ["forward", "decode"])
def test_gru_ladder_ends_at_the_last_kernel_rung_on_the_card(
        monkeypatch, path, on_card, through, expect):
    """The GRU ladders hold only kernel rungs on CUDA tensors: a fault the
    per-step (per-layer) rung cannot absorb is raised there, while on the
    CPU the reference rung absorbs it.  The card is claimed by patching
    the executor's device test; injected faults fire before a rung runs,
    so no rung launches here."""
    import repro_torch.dispatch.executor as executor

    monkeypatch.setattr(executor, "_on_card", lambda t: on_card)
    _, params = _gru_stacks(L=2, seed=5)
    xs = torch.randn(2, 9, 24, generator=torch.Generator().manual_seed(1))
    healthy = rnn.compile(params, device="cpu")
    cs = rnn.compile(params, rnn.ExecutionPolicy(on_fault="fallback"),
                     device="cpu")
    if path == "forward":
        want = healthy.forward(xs)
        run = lambda: cs.forward(xs)  # noqa: E731
    else:
        state = {"h": torch.zeros(2, 2, 24)}
        want = healthy.decode(xs[:, :1], state)[0]
        run = lambda: cs.decode(xs[:, :1], state)[0]  # noqa: E731
    cs.fault.arm([0], through_level=through)
    if expect is None:
        with pytest.raises(executor.LaunchError) as err:
            run()
        assert err.value.level == "per_step"
        assert cs.stats.degraded_launches == 0
        return
    torch.testing.assert_close(run(), want, rtol=0, atol=FP32_TOL)
    assert (cs.stats.degraded_launches, cs.stats.fallback_level) == expect


# ---------------------------------------------------------------------------
# the schedule library and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", list(gru_mod.SCHEDULES))
def test_gru_layer_schedules_match_reference_unroll(schedule):
    """core.gru's four schedules against the JAX package's
    reference_unroll on one layer."""
    from repro.core import gru as jgru

    jparams, params = _gru_stacks(L=1, seed=6)
    xs = _xs(2, 7, 24, seed=4)
    ref = jgru.reference_unroll(jparams["layers"][0], jnp.asarray(xs))
    out = gru_mod.LAYER_FNS[schedule](params["layers"][0],
                                      torch.from_numpy(xs))
    np.testing.assert_allclose(_np(out), _np(ref), atol=FP32_TOL)
    np.testing.assert_allclose(
        _np(gru_mod.reference_unroll(params["layers"][0],
                                     torch.from_numpy(xs))),
        _np(ref), atol=FP32_TOL)


def test_gru_serving_engine_matches_reference_engine():
    """lstm_config(48, layers=3) as a GRU with bf16 weights: two ragged
    admission waves (max_batch=4, six requests), then decode ticks with
    fed-back frames — same completions and launch accounting as the JAX
    engine, outputs within tolerance, one gru_decode call per tick."""
    cfg = lstm_config(48, layers=3)  # dtype bfloat16
    jparams = jinit_gru_stack(jax.random.PRNGKey(0), 48, 48, 3,
                              jnp.bfloat16)
    jeng = jserving.RecurrentServingEngine(cfg, jparams, max_batch=4,
                                           rnn_family="gru", interpret=True)
    eng = serving.RecurrentServingEngine(cfg, from_jax(jparams),
                                         max_batch=4, rnn_family="gru",
                                         device="cpu")
    assert eng.c is None
    rng = np.random.default_rng(1)
    prompts = [_rand(rng, (t, 48), 0.5) for t in (12, 12, 7, 18, 3, 12)]
    for mod, e in ((jserving, jeng), (serving, eng)):
        for uid, p in enumerate(prompts):
            e.submit(mod.RecurrentRequest(uid=uid, frames=p,
                                          max_new_frames=4))
    jdone = sorted(jeng.run_to_completion(), key=lambda c: c.uid)
    reset_counts(ops.gru_seq, ops.gru_decode)
    done = sorted(eng.run_to_completion(), key=lambda c: c.uid)
    summary = [(e.prefill_waves, e.packed_launches, e.naive_launches,
                e.decode_ticks, e.decode_launches) for e in (eng, jeng)]
    assert summary[0] == summary[1]
    assert ops.gru_seq.calls == eng.packed_launches
    assert ops.gru_decode.calls == eng.decode_launches == eng.decode_ticks
    for c, jc in zip(done, jdone):
        assert (c.uid, c.status) == (jc.uid, "ok")
        np.testing.assert_allclose(c.outputs, np.asarray(jc.outputs),
                                   atol=SERVE_TOL)
        np.testing.assert_allclose(c.generated, np.asarray(jc.generated),
                                   atol=SERVE_TOL)
    st = eng.compiled.stats
    assert (st.degraded_launches, st.fallback_level) == (0, 0)


def test_gru_engine_quarantines_a_poisoned_slot_like_reference():
    cfg = lstm_config(16, layers=2)
    jparams = jinit_gru_stack(jax.random.PRNGKey(2), 16, 16, 2,
                              jnp.bfloat16)
    jeng = jserving.RecurrentServingEngine(cfg, jparams, max_batch=3,
                                           rnn_family="gru", interpret=True)
    eng = serving.RecurrentServingEngine(cfg, from_jax(jparams),
                                         max_batch=3, rnn_family="gru",
                                         device="cpu")
    rng = np.random.default_rng(3)
    prompts = [_rand(rng, (t, 16), 0.5) for t in (5, 7, 6)]
    for mod, e in ((jserving, jeng), (serving, eng)):
        for uid, p in enumerate(prompts):
            e.submit(mod.RecurrentRequest(uid=uid, frames=p,
                                          max_new_frames=3))
        e.poison_slot_at = {0: 1, 2: -1}
    statuses = [sorted((c.uid, c.status, c.generated.shape[0])
                       for c in e.run_to_completion()) for e in (eng, jeng)]
    assert statuses[0] == statuses[1]
    assert [s for _, s, _ in statuses[0]] == ["failed", "ok", "failed"]


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H", [340, 1024, 50])
@pytest.mark.parametrize("u_dtype,act_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_cuda_gru_seq_matches_plain(cuda, H, u_dtype, act_dtype):
    """Within 1e-4 (fp32 activations) or 2e-2 (bf16) of the plain version
    at H = 340 (U resident), 1024 (U streamed) and 50 (plain loads); rows
    bit-equal to their B=1 calls; with fp32 h, a chunked walk bit-equal
    to one launch.  U is scaled by ``cuda_seq_scale``: at 0.2 a weight,
    H = 1024's recurrence carries the plain version's own fp32 rounding
    to 1e-4 of an fp64 walk (test_seq_plain_fp32_walk_against_fp64)."""
    (_, U3), (_, xw), (_, h0) = _seq_inputs(3, 5, 9, H, u_dtype, act_dtype,
                                            seed=2)
    U3, xw, h0 = (t.to(cuda) for t in (U3, xw, h0))
    U3 = (U3.float() * cuda_seq_scale(H)).to(U3.dtype)
    mask = torch.tensor([[1] * 5, [1, 1, 0, 0, 0], [1] * 5],
                        dtype=torch.int32, device=cuda)
    ref = ops.gru_seq_plain(U3, xw, h0, mask)
    out = ops.gru_seq(U3, xw, h0, b_valid=[5, 2, 5])
    tol = 1e-4 if act_dtype == "float32" else BF16_TOL
    for r, o in zip(ref, out):
        torch.testing.assert_close(o.float(), r.float(), rtol=0, atol=tol)
    assert_seq_bits(ops.gru_seq, U3, xw, (h0,), out, [5, 2, 5],
                    act_dtype == "float32")


def _seq_walk_fp64(family, U, xw, state, keep):
    """The sequence kernels' recurrence in fp64 throughout: (hs, h_T) of
    the GRU, (hs, h_T, c_T) of the LSTM; rows where ``keep`` is False
    freeze their state."""
    G, B, T, gates, H = xw.shape
    U = U.double().reshape(G, H, gates * H)
    st = [t.double() for t in state]
    ys = []
    for t in range(T):
        a = xw[:, :, t].double()
        hu = torch.bmm(st[0], U).reshape(G, B, gates, H)
        if family == "gru":
            z = torch.sigmoid(a[:, :, 0] + hu[:, :, 0])
            r = torch.sigmoid(a[:, :, 1] + hu[:, :, 1])
            n = torch.tanh(a[:, :, 2] + r * hu[:, :, 2])
            new = [(1 - z) * n + z * st[0]]
        else:
            g = a + hu
            c = (torch.sigmoid(g[:, :, 1]) * st[1]
                 + torch.sigmoid(g[:, :, 0]) * torch.tanh(g[:, :, 2]))
            new = [torch.sigmoid(g[:, :, 3]) * torch.tanh(c), c]
        st = [torch.where(keep, n_, o_) for n_, o_ in zip(new, st)]
        ys.append(st[0])
    return [torch.stack(ys, dim=2)] + st


@pytest.mark.parametrize("family", ["gru", "lstm"])
@pytest.mark.parametrize("H", [340, 1024])
def test_seq_plain_fp32_walk_against_fp64(family, H):
    """The reference of the card tests of lstm_seq / gru_seq: on their
    inputs, with U scaled by ``cuda_seq_scale``, the fp32 plain version
    stays within 1e-5 of an fp64 walk, a tenth of the 1e-4 the kernels
    are held to.  Unscaled, at 0.2 a weight and H = 1024, the plain
    version's own fp32 rounding reaches past 2e-5 of the fp64 walk (GRU
    1.02e-4, LSTM 3.38e-5 on this data), so it could not tell a kernel's
    1e-4 from its own."""
    mask = torch.tensor([[1] * 5, [1, 1, 0, 0, 0], [1] * 5],
                        dtype=torch.int32)
    if family == "gru":
        (_, U), (_, xw), (_, h0) = _seq_inputs(3, 5, 9, H, "float32",
                                               "float32", seed=2)
        state, plain = (h0,), ops.gru_seq_plain
    else:
        U, xw, h0, c0 = _torch(_lstm_seq_inputs(3, 5, 9, H, "float32",
                                                "float32", seed=2))
        state, plain = (h0, c0), lstm_ops.lstm_seq_plain

    def drift(scale):
        Us = U * scale
        ref = _seq_walk_fp64(family, Us, xw, state, (mask != 0)[..., None])
        return max((o.double() - r).abs().max().item()
                   for o, r in zip(plain(Us, xw, *state, mask), ref))

    assert drift(cuda_seq_scale(H)) <= 1e-5
    if H > 340:
        assert drift(1.0) > 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("H", [340, 1024, 50])
@pytest.mark.parametrize("B", [1, 4, 5])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_cuda_gru_decode_matches_plain(cuda, H, B, w_dtype):
    args = [t.to(cuda) for _, t in _decode_inputs(5, B, H, w_dtype,
                                                  "float32", seed=4)]
    torch.testing.assert_close(ops.gru_decode(*args),
                               ops.gru_decode_plain(*args), rtol=0,
                               atol=1e-4)


def _cuda_decode_args(cuda, H, B=4, u_dtype=None, act_dtype="float32"):
    args = [t.to(cuda) for _, t in _decode_inputs(3, B, H, "bfloat16",
                                                  act_dtype, seed=H)]
    if u_dtype:
        args[3] = args[3].to(TDT[u_dtype])
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("H", [340, 1024, 50])
def test_cuda_gru_decode_rows_are_batch_and_run_invariant(cuda, H):
    """A row of a B = 4 call equals its B = 1 call bit for bit, and two
    runs agree (each output's order of summation is set by (H, 3))."""
    args = _cuda_decode_args(cuda, H)
    out = ops.gru_decode(*args)
    for r in range(4):
        row = ops.gru_decode(args[0][r:r + 1], *args[1:4],
                             args[4][:, r:r + 1].contiguous())
        assert torch.equal(out[:, r], row[:, 0])
    assert torch.equal(out, ops.gru_decode(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("u_dtype,act_dtype", [
    ("float32", "float32"), (None, "bfloat16")])
def test_cuda_gru_decode_operand_forms(cuda, u_dtype, act_dtype):
    """fp32 U under bf16 W and bf16 state, against the plain version."""
    args = _cuda_decode_args(cuda, 340, B=5, u_dtype=u_dtype,
                             act_dtype=act_dtype)
    tol = 1e-4 if act_dtype == "float32" else BF16_TOL
    torch.testing.assert_close(ops.gru_decode(*args).float(),
                               ops.gru_decode_plain(*args).float(), rtol=0,
                               atol=tol)


@pytest.mark.cuda
def test_cuda_gru_decode_graph_replay_equals_eager_and_one_launch(cuda):
    """A call is one cluster launch, a CUDA graph's replay of it is the
    eager call bit for bit, and the kernel's own split is decode_splits'."""
    args = _cuda_decode_args(cuda, 340)
    reset_counts(ops.gru_decode)
    eager = ops.gru_decode(*args)
    torch.cuda.synchronize()
    assert ops.gru_decode.kernel_launches == ops.gru_decode.calls == 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.gru_decode(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    for H in (340, 1024, 50):
        S, clusters = common.decode_clusters("gru", 4, H)
        assert S == ops.decode_splits(H, 3) and clusters > 0
