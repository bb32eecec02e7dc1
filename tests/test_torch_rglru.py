"""The port's RG-LRU path (repro_torch.kernels.rglru, models.layers.rglru,
configs.recurrentgemma_2b and rglru items through the dispatcher) against
the JAX package on the CPU.

The same numpy-seeded inputs go through both packages; JAX runs its Pallas
scan kernel in interpret mode, as its own tests do, and the port's entry
point runs its plain PyTorch version on the CPU.  The CUDA kernel itself is
held against that plain version on the card by the ``cuda``-marked test
here and by chip_smoke.py.

Tolerance: 1e-6 absolute everywhere, as in tests/kernels/test_rglru.py.
The port evaluates the scan with the operations XLA emits for the
reference (``kernels.rglru.ref``), so what is left is the gate GEMMs'
summation order and the transcendental functions of the gates.  The lstm
item of a mixed plan is held at 1e-5, the fp32 tolerance of the port's
other recurrent parity tests (the two packages sum h·U in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dispatch as jdispatch
from repro.configs import recurrentgemma_2b as jcfg
from repro.configs.sharp_lstm import lstm_config
from repro.kernels.rglru.ops import rglru_scan as jrglru_scan
from repro.models.layers import rglru as jrglru
from repro.models.layers.lstm import init_lstm_stack as jinit_lstm_stack

import repro_torch.dispatch as dispatch
from repro_torch.configs import recurrentgemma_2b
from repro_torch.convert import from_jax
from repro_torch.kernels import build
from repro_torch.kernels.common import reset_counts
from repro_torch.kernels.rglru import ops
from repro_torch.models.layers import rglru

TOL = 1e-6
LSTM_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(B, T, W, seed):
    """log_a = -|N|·0.3 (decays up to a = 1), gx and h0 ~ N(0, 1), fp32."""
    rng = np.random.default_rng(seed)
    return ((-np.abs(rng.standard_normal((B, T, W))) * 0.3).astype(np.float32),
            rng.standard_normal((B, T, W)).astype(np.float32),
            rng.standard_normal((B, W)).astype(np.float32))


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(ours, dtype=np.float32),
                               np.asarray(ref, dtype=np.float32), atol=tol,
                               rtol=0)


# ---------------------------------------------------------------------------
# the scan kernel's entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,T,W", [(1, 4, 32), (2, 16, 64), (3, 13, 100),
                                   (1, 64, 513), (2, 7, 2560)])
@pytest.mark.parametrize("seed", [0, 1])
def test_rglru_scan_matches_reference(B, T, W, seed):
    """The reference's test shapes, ragged widths included (atol 1e-6)."""
    la, gx, h0 = _scan_inputs(B, T, W, seed=seed * 1000 + W)
    ref = jrglru_scan(jnp.asarray(la), jnp.asarray(gx), jnp.asarray(h0),
                      interpret=True)
    out = ops.rglru_scan(*map(torch.from_numpy, (la, gx, h0)))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape) and o.dtype == torch.float32
        _close(o, r)


def test_rglru_scan_block_w_changes_no_number():
    """``block_w`` is the TPU kernel's channel tile: accepted, ignored."""
    la, gx, h0 = map(torch.from_numpy, _scan_inputs(2, 9, 200, seed=3))
    base = ops.rglru_scan(la, gx, h0)
    for bw in (32, 64, 128, 256):
        for a, b in zip(ops.rglru_scan(la, gx, h0, block_w=bw), base):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="block_w"):
        ops.rglru_scan(la, gx, h0, block_w=-1)


@pytest.mark.parametrize("B,T,W", [(1, 1, 4), (2, 20, 37), (3, 8, 150)])
def test_last_output_is_the_final_state_exactly(B, T, W):
    """hs[:, -1] == h_T bit for bit."""
    hs, h_T = ops.rglru_scan(*map(torch.from_numpy,
                                  _scan_inputs(B, T, W, seed=T * 77 + W)))
    assert torch.equal(hs[:, -1], h_T)


@pytest.mark.parametrize("B,T,W,cut", [(2, 70, 40, 37), (1, 130, 33, 65),
                                       (3, 9, 100, 1)])
def test_scan_split_over_two_calls_is_one_call_bit_for_bit(B, T, W, cut):
    """A scan of T split into two calls, the second started from the
    first's h_T, equals one call bit for bit (a cut that is no multiple of
    the kernel's tiles of 32, 64 or 128 steps): the property the CUDA
    kernel keeps, shown on the plain version it is held against."""
    la, gx, h0 = map(torch.from_numpy, _scan_inputs(B, T, W, seed=cut + T))
    hs, h_T = ops.rglru_scan(la, gx, h0)
    hs1, h1 = ops.rglru_scan(la[:, :cut], gx[:, :cut], h0)
    hs2, h2 = ops.rglru_scan(la[:, cut:], gx[:, cut:], h1)
    assert torch.equal(torch.cat([hs1, hs2], 1), hs)
    assert torch.equal(h2, h_T)


@pytest.mark.parametrize("B,T,W", [(4, 33, 40), (3, 20, 513)])
def test_scan_rows_do_not_depend_on_the_batch(B, T, W):
    """Each row of a batched scan equals the scan of that row alone, bit
    for bit: the property the CUDA kernel keeps (its strips change with B),
    shown on the plain version."""
    la, gx, h0 = map(torch.from_numpy, _scan_inputs(B, T, W, seed=B * W))
    hs, h_T = ops.rglru_scan(la, gx, h0)
    for b in range(B):
        one = ops.rglru_scan(la[b:b + 1], gx[b:b + 1], h0[b:b + 1])
        assert torch.equal(one[0], hs[b:b + 1])
        assert torch.equal(one[1], h_T[b:b + 1])


def test_scan_tile_mirrors_the_kernels_strip_rule():
    """scan_tile: the widest strip of 32, 16, 8 channels that still gives
    two CTAs an SM, and a tile of SCAN_TILE_ELEMS elements."""
    assert ops.scan_tile(4, 2560) == (32, 32)   # the rglru phase
    assert ops.scan_tile(2, 2560) == (16, 64)
    assert ops.scan_tile(1, 2560) == (8, 128)   # serve_lm's prefills
    assert ops.scan_tile(4, 513) == (8, 128)
    assert ops.scan_tile(1, 2560, sms=40) == (32, 32)
    for B, W in ((1, 33), (4, 2560), (2, 2560)):
        C, steps = ops.scan_tile(B, W)
        assert C * steps == ops.SCAN_TILE_ELEMS


def test_decay_contract():
    """With log_a = 0 (a = 1) the input contribution vanishes: h stays h0
    (exactly: 1 − exp(0) is 0, and so is its square root)."""
    _, gx, h0 = map(torch.from_numpy, _scan_inputs(2, 5, 32, seed=4))
    hs, h_T = ops.rglru_scan(torch.zeros(2, 5, 32), gx, h0)
    assert torch.equal(h_T, h0)
    assert torch.equal(hs, h0[:, None].expand(2, 5, 32))


def test_counters_registration_and_empty_sequence():
    """calls count every invocation, kernel launches only CUDA ones; T=0
    passes the state through; the CUDA wrapper refuses CPU tensors."""
    reset_counts(ops.rglru_scan)
    la, gx, h0 = map(torch.from_numpy, _scan_inputs(1, 3, 8, seed=5))
    ops.rglru_scan(la, gx, h0)
    hs, h_T = ops.rglru_scan(la[:, :0], gx[:, :0], h0)
    assert hs.shape == (1, 0, 8) and torch.equal(h_T, h0)
    assert (ops.rglru_scan.calls, ops.rglru_scan.kernel_launches) == (2, 0)
    assert "rglru_scan" in build.all_kernels()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rglru_scan_cuda(la, gx, h0)


def test_xla_exp_matches_jax_exp_bitwise():
    """The plain version's exp is XLA's on the CPU, bit for bit, over the
    range the scan sees (and beyond)."""
    from repro_torch.kernels.rglru.ref import xla_exp

    x = (np.random.default_rng(6).standard_normal(50_000) * 3.0
         ).astype(np.float32)
    x = np.concatenate([x, -np.abs(x[:20_000]) * 0.01, [0.0, -1e-8, 80.0]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(
        xla_exp(torch.from_numpy(x)).numpy(), np.asarray(jnp.exp(x)))


# ---------------------------------------------------------------------------
# the model layer and its config
# ---------------------------------------------------------------------------


def _layer(W, seed):
    """A JAX init_rglru tree and its conversion."""
    p = jrglru.init_rglru(jax.random.PRNGKey(seed), W, jnp.float32)
    return p, from_jax({k: np.asarray(v) for k, v in p.items()})


def test_converted_params_carry_every_leaf_and_dtype():
    """convert.from_jax carries an init_rglru tree exactly, dtypes kept
    (bf16 weights, the fp32 Lambda)."""
    p, tp = _layer(48, seed=0)
    assert sorted(p) == sorted(tp)
    for k in p:
        assert tuple(tp[k].shape) == p[k].shape
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(p[k]))
    bf = jrglru.init_rglru(jax.random.PRNGKey(1), 16, jnp.bfloat16)
    tbf = from_jax(bf)
    assert tbf["w_a"].dtype == torch.bfloat16
    assert tbf["Lambda"].dtype == torch.float32   # Lambda stays fp32
    np.testing.assert_array_equal(tbf["w_x"].float().numpy(),
                                  np.asarray(bf["w_x"], np.float32))


def test_init_rglru_shapes_dtypes_and_decay_range():
    """The port's seeded init has the reference's shapes and dtypes (the
    values come from another generator) and Griffin's decay range."""
    ours = rglru.init_rglru(torch.Generator().manual_seed(0), 64, "bfloat16")
    ref = jrglru.init_rglru(jax.random.PRNGKey(0), 64, jnp.bfloat16)
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape
        assert str(ours[k].dtype).removeprefix("torch.") == ref[k].dtype.name
    # a^c = sigmoid(Lambda)^8 lies in (0.9, 0.999), as in Griffin
    ac = torch.sigmoid(ours["Lambda"]) ** rglru.C_EXP
    assert bool(((ac > 0.9 - 1e-5) & (ac < 0.999 + 1e-5)).all())


@pytest.mark.parametrize("B,T,W", [(2, 12, 64), (1, 5, 100)])
def test_gate_inputs_and_apply_rglru_match_reference(B, T, W):
    """gate_inputs and apply_rglru (from zero and from a given state) on
    converted params, atol 1e-6."""
    p, tp = _layer(W, seed=B + T)
    x = (np.random.default_rng(W).standard_normal((B, T, W)) * 0.8
         ).astype(np.float32)
    for ours, ref in zip(rglru.gate_inputs(tp, torch.from_numpy(x)),
                         jrglru.gate_inputs(p, jnp.asarray(x))):
        _close(ours, ref)
    h0 = np.random.default_rng(1).standard_normal((B, W)).astype(np.float32)
    for h in (None, h0):
        ours = rglru.apply_rglru(tp, torch.from_numpy(x),
                                 None if h is None else torch.from_numpy(h))
        ref = jrglru.apply_rglru(p, jnp.asarray(x),
                                 None if h is None else jnp.asarray(h))
        for o, r in zip(ours, ref):
            _close(o, r)


def test_decode_step_matches_reference_and_chains_like_apply():
    """decode_step against the reference (atol 1e-6), and T decode steps
    from zero state against apply_rglru (atol 1e-6: the step writes a·a
    as the reference does, the scan exp(2·la) as XLA compiles it)."""
    B, T, W = 3, 6, 64
    p, tp = _layer(W, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, T, W)).astype(np.float32)
    h = rng.standard_normal((B, W)).astype(np.float32)
    for ours, ref in zip(rglru.decode_step(tp, torch.from_numpy(x[:, 0]),
                                           torch.from_numpy(h)),
                         jrglru.decode_step(p, jnp.asarray(x[:, 0]),
                                            jnp.asarray(h))):
        _close(ours, ref)
    # T decode steps from zero state walk the same recurrence as apply
    ht = torch.zeros(B, W)
    ys = []
    for t in range(T):
        y, ht = rglru.decode_step(tp, torch.from_numpy(x[:, t]), ht)
        ys.append(y)
    y_all, h_T = rglru.apply_rglru(tp, torch.from_numpy(x))
    torch.testing.assert_close(torch.stack(ys, 1), y_all, rtol=0, atol=TOL)
    torch.testing.assert_close(ht, h_T, rtol=0, atol=TOL)


@pytest.mark.parametrize("k", [2, 4])
def test_conv1d_matches_reference(k):
    """init_conv1d shapes, apply_conv1d over a prompt and one decode frame
    against its carried state, atol 1e-6."""
    B, T, W = 2, 9, 32
    pj = jrglru.init_conv1d(jax.random.PRNGKey(k), W, k, jnp.float32)
    pt = from_jax(pj)
    x = np.random.default_rng(k).standard_normal((B, T, W)).astype(np.float32)
    ours_y, ours_st = rglru.apply_conv1d(pt, torch.from_numpy(x))
    ref_y, ref_st = jrglru.apply_conv1d(pj, jnp.asarray(x))
    _close(ours_y, ref_y)
    _close(ours_st, ref_st)
    # decode: one frame against the carried state
    y1, st1 = rglru.apply_conv1d(pt, torch.from_numpy(x[:, :1]), ours_st)
    r1, rs1 = jrglru.apply_conv1d(pj, jnp.asarray(x[:, :1]), ref_st)
    _close(y1, r1)
    _close(st1, rs1)
    init = rglru.init_conv1d(torch.Generator().manual_seed(0), W, k,
                             "float32")
    assert tuple(init["w"].shape) == (k, W) and not init["b"].any()


def test_recurrentgemma_2b_config_is_a_copy():
    """config() and reduced() equal the reference's field for field; the
    full model's recurrent core is an L=18 rglru item of width 2560."""
    for fn in ("config", "reduced"):
        ours = dataclasses.asdict(getattr(recurrentgemma_2b, fn)())
        ref = dataclasses.asdict(getattr(jcfg, fn)())
        assert ours == ref
    cfg = recurrentgemma_2b.config()
    assert (cfg.rglru_width, cfg.d_model, cfg.window) == (2560, 2560, 2048)
    item = dispatch.WorkItem.from_config(cfg, 2048)
    assert (item.family, item.L, item.H) == ("rglru", 18, 2560)


# ---------------------------------------------------------------------------
# rglru items through the dispatcher
# ---------------------------------------------------------------------------


def _rglru_item_inputs(B, T, W, seed):
    p, tp = _layer(W, seed=seed)
    x = (np.random.default_rng(seed).standard_normal((B, T, W)) * 0.5
         ).astype(np.float32)
    return (jrglru.gate_inputs(p, jnp.asarray(x)),
            rglru.gate_inputs(tp, torch.from_numpy(x)))


def test_execute_rglru_item_matches_reference_in_one_launch():
    """One rglru item: the reference's plan string, one launch, no state
    (collect_state gives None), output within 1e-6 of the reference's."""
    B, T, W = 2, 10, 48
    jin, tin = _rglru_item_inputs(B, T, W, seed=9)
    item = dict(uid=0, family="rglru", B=B, T=T, H=W, X=W, L=1)
    jp = jdispatch.plan([jdispatch.WorkItem(**item)])
    p = dispatch.plan([dispatch.WorkItem(**item)])
    assert p.describe() == jp.describe() and p.launches == 1
    reset_counts(ops.rglru_scan)
    outs, states = dispatch.execute(p, {}, {0: tin}, collect_state=True)
    assert ops.rglru_scan.calls == p.launches
    assert states == {0: None}     # rglru exposes no (h, c) state
    ref, ref_states = jdispatch.execute(jp, {}, {0: jin}, interpret=True,
                                        collect_state=True)
    assert ref_states == {0: None}
    _close(outs[0], ref[0])
    # the item's output is the scan from zero state
    assert torch.equal(outs[0], ops.rglru_scan(*tin, torch.zeros(B, W))[0])


def test_mixed_lstm_and_rglru_plan_matches_reference():
    """An lstm item and an rglru item in one plan and one execute: the
    reference's plan string, launches == plan.launches, the rglru output
    within 1e-6 and the lstm output within 1e-5 of the reference's."""
    B, T = 2, 8
    jin, tin = _rglru_item_inputs(B, T, 32, seed=10)
    stack = jinit_lstm_stack(jax.random.PRNGKey(11), lstm_config(16, layers=2),
                             jnp.float32)
    xs = (np.random.default_rng(12).standard_normal((B, T, 16)) * 0.5
          ).astype(np.float32)
    items = [dict(uid=0, family="lstm", B=B, T=T, H=16, L=2),
             dict(uid=1, family="rglru", B=B, T=T, H=32, X=32, L=1)]
    jp = jdispatch.plan([jdispatch.WorkItem(**i) for i in items])
    p = dispatch.plan([dispatch.WorkItem(**i) for i in items])
    assert p.describe() == jp.describe()
    from repro_torch.kernels.lstm_cell.ops import lstm_seq
    reset_counts(lstm_seq, ops.rglru_scan)
    outs = dispatch.execute(p, {0: from_jax(stack)},
                            {0: torch.from_numpy(xs), 1: tin})
    assert lstm_seq.calls + ops.rglru_scan.calls == p.launches
    assert ops.rglru_scan.calls == 1
    ref = jdispatch.execute(jp, {0: stack}, {0: jnp.asarray(xs), 1: jin},
                            interpret=True)
    _close(outs[0], ref[0], tol=LSTM_TOL)
    _close(outs[1], ref[1])


def test_multi_layer_rglru_stays_plan_only_with_the_reference_error():
    """A multi-layer rglru item is refused before any work, with the
    reference's message word for word."""
    item = dict(uid=3, family="rglru", B=1, T=4, H=8, L=2)
    with pytest.raises(NotImplementedError) as ours:
        dispatch.execute(dispatch.plan([dispatch.WorkItem(**item)]), {}, {})
    with pytest.raises(NotImplementedError) as ref:
        jdispatch.execute(jdispatch.plan([jdispatch.WorkItem(**item)]), {},
                          {}, interpret=True)
    assert str(ours.value) == str(ref.value)
    assert "plan-only" in str(ours.value)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,W", [(4, 300, 2560), (1, 64, 513),
                                   (3, 13, 100), (4, 33, 2560),
                                   (2, 63, 2560), (1, 129, 2560),
                                   (4, 127, 513), (2, 1, 33)])
def test_cuda_rglru_scan_matches_plain(cuda, B, T, W):
    """The kernel computes the plain version's operations (1e-6), one
    launch a call, and keeps the plain version's properties bit for bit:
    run to run, each row equal to that row's own (B = 1) call, and T split
    over two calls (the second from the first's h_T) equal to one call.
    The shapes reach the edges of the tiles of each strip width (32 steps
    at B = 4, W = 2560; 64 at B = 2; 128 at B = 1 and at W = 513)."""
    args = [torch.from_numpy(a).to(cuda)
            for a in _scan_inputs(B, T, W, seed=13)]
    reset_counts(ops.rglru_scan)
    out = ops.rglru_scan(*args)
    ref = ops.rglru_scan_plain(*args)
    torch.cuda.synchronize()
    assert ops.rglru_scan.kernel_launches == 1
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=TOL)
    assert torch.equal(out[0][:, -1], out[1])
    for a, b in zip(ops.rglru_scan(*args), out):
        assert torch.equal(a, b)
    la, gx, h0 = args
    for b in range(B):
        one = ops.rglru_scan(la[b:b + 1], gx[b:b + 1], h0[b:b + 1])
        assert torch.equal(one[0], out[0][b:b + 1])
        assert torch.equal(one[1], out[1][b:b + 1])
    if T > 1:
        cut = T // 2 + 1
        hs1, h1 = ops.rglru_scan(la[:, :cut], gx[:, :cut], h0)
        hs2, h2 = ops.rglru_scan(la[:, cut:], gx[:, cut:], h1)
        assert torch.equal(torch.cat([hs1, hs2], 1), out[0])
        assert torch.equal(h2, out[1])
