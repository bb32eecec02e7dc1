"""Reduced-precision and block-sparse recurrent weights in the port
(``ExecutionPolicy(precision="bf16"|"int8", sparsity="block")``,
``repro_torch.kernels.quant``, the int8 / row-compacted branches of
``lstm_seq`` / ``gru_seq``) against the JAX package and against the port's
own oracle, on the CPU.  Mirrors tests/rnn/test_precision.py and
tests/kernels/test_quant.py.

The same numpy-seeded inputs go through both packages; JAX runs its Pallas
kernels in interpret mode, as its own tests do.  Stated tolerances, as in
the reference's own precision contract:

* every ``quant`` function: bit-equal to the reference's;
* bf16: bit-identical to the port's fp32 pipeline on the fake-quant view;
* int8: relative error <= KERNEL_GAP + 1e-6·L against the dequantized
  oracle ``reference_stack(fake_quant_stack(params, "int8"), xs)`` and
  against the JAX pipeline (the kernels compute (h·Uq)·s where the oracle
  computes h·(Uq·s); KERNEL_GAP = 1e-6 is the reduction-order headroom);
* sparsity="block": within 1e-6 absolute of the dense pipeline;
* fp32 parity of whole pipelines with the JAX package: 1e-5 absolute (the
  port's other parity tests' fp32 tolerance).

The CUDA branches are held against their plain versions on the card by the
``cuda``-marked tests here and by chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rnn as jrnn
from repro.configs.sharp_lstm import lstm_config
from repro.core import gru as jgru
from repro.dispatch.executor import prepare_decode_stack as jprepare
from repro.kernels import quant as jq
from repro.kernels.gru_cell import ops as jgops
from repro.kernels.lstm_cell import ops as jlops
from repro.models.layers.lstm import init_lstm_stack as jinit_lstm_stack

from repro_torch import rnn
from repro_torch.convert import from_jax
from repro_torch.core import schedules as sch
from repro_torch.core.perfmodel import MXU_ROWS
from repro_torch.dispatch import executor
from repro_torch.kernels import quant as tq
from repro_torch.kernels.common import decode_u, reset_counts
from repro_torch.kernels.gru_cell import ops as gops
from repro_torch.kernels.lstm_cell import ops as lops

H = 48
KERNEL_GAP = 1e-6
FP32_TOL = 1e-5
SPARSE_TOL = 1e-6


def INT8_REL_BOUND(L):
    """The int8 contract: the per-step distributivity gap compounds at most
    linearly through the stack depth."""
    return 1e-6 * L


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_err(got, want):
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _jstack(family, L=3, bidir=False, seed=0, width=H, dtype=jnp.float32):
    if family == "gru":
        assert not bidir  # no bidirectional GRU stacks in either package
        return jgru.init_gru_stack(jax.random.PRNGKey(seed), width, width, L,
                                   dtype)
    cfg = lstm_config(width, layers=L)
    if bidir:
        cfg = dataclasses.replace(cfg, bidirectional=True)
    return jinit_lstm_stack(jax.random.PRNGKey(seed), cfg, dtype)


def _zero_tiles(stack, layer_tiles, half=None):
    """Zero whole 8-row tiles of each layer's U: {layer: (tiles,)}."""
    out = {"layers": [dict(lay) for lay in stack["layers"]]}
    for li, tiles in layer_tiles.items():
        lay = out["layers"][li]
        if half is not None:
            lay[half] = dict(lay[half])
            lay = lay[half]
        U = np.array(lay["U"])
        for t in tiles:
            U[t * MXU_ROWS:(t + 1) * MXU_ROWS] = 0.0
        lay["U"] = jnp.asarray(U, lay["U"].dtype)
    return out


def _xs(B=2, T=10, seed=1, width=H):
    return (np.random.default_rng(seed).standard_normal((B, T, width)) * 0.5
            ).astype(np.float32)


def _both(stack, policy_kw):
    """The same stack compiled in both packages under one policy."""
    j = jrnn.compile(stack, jrnn.ExecutionPolicy(interpret=True, **policy_kw))
    t = rnn.compile(from_jax(stack), rnn.ExecutionPolicy(**policy_kw),
                    device="cpu")
    return j, t


# ---------------------------------------------------------------------------
# kernels.quant: every function bit-equal to the reference's
# ---------------------------------------------------------------------------


def _u(seed, dtype="float32", shape=(H, 4, H)):
    a = (np.random.default_rng(seed).standard_normal(shape) * 0.3
         ).astype(np.float32)
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _zeroed(seed, dtype="float32", H_=50, gates=3, tiles=(0, 2, 6)):
    j, t = _u(seed, dtype, (H_, gates, H_))
    keep = np.ones(H_, bool)
    for tile in tiles:
        keep[tile * MXU_ROWS:(tile + 1) * MXU_ROWS] = False
    j = j * jnp.asarray(keep, j.dtype)[:, None, None]
    t = t * torch.from_numpy(keep).to(t.dtype)[:, None, None]
    return j, t


QUANT_CASES = {
    "absmax_scale": lambda m, j, t: (
        m.absmax_scale(j if m is jq else t),
        m.absmax_scale(j if m is jq else t, axis=(0, 2))),
    "quantize": lambda m, j, t: m.quantize(
        j if m is jq else t, m.absmax_scale(j if m is jq else t)),
    "int8_roundtrip": lambda m, j, t: m.int8_roundtrip(j if m is jq else t),
    "bf16_roundtrip": lambda m, j, t: m.bf16_roundtrip(j if m is jq else t),
    "quantize_per_gate": lambda m, j, t: m.quantize_per_gate(
        j if m is jq else t),
    "dequantize_per_gate": lambda m, j, t: m.dequantize_per_gate(
        *m.quantize_per_gate(j if m is jq else t)),
    "fake_quant_half": lambda m, j, t: tuple(
        m.fake_quant_half({"U": (j if m is jq else t).reshape(H, 4 * H),
                           "W": 1}, p)["U"] for p in ("fp32", "bf16",
                                                      "int8")),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(QUANT_CASES))
def test_quant_functions_bit_equal_to_reference(name, dtype):
    """Bit-equal, in value and dtype, for fp32 and bf16 inputs (division by
    the scale, round half to even, clip, int8 cast)."""
    j, t = _u(sorted(QUANT_CASES).index(name), dtype)
    ref, ours = QUANT_CASES[name](jq, j, t), QUANT_CASES[name](tq, j, t)
    ref = ref if isinstance(ref, tuple) else (ref,)
    ours = ours if isinstance(ours, tuple) else (ours,)
    for r, o in zip(ref, ours):
        assert str(o.dtype).removeprefix("torch.") == jnp.asarray(r).dtype.name
        np.testing.assert_array_equal(_np(o) if o.dtype != torch.int8
                                      else o.numpy(),
                                      np.asarray(r) if r.dtype == jnp.int8
                                      else _np(r))


@pytest.mark.parametrize("pad_to", [None, 44])
def test_tile_maps_and_row_compaction_equal_reference(pad_to):
    """tile_bitmap, active_row_indices, compact_rows (with and without
    padding), expand_rows, density — on H=50, whose last tile is 2 rows —
    bit-equal to the reference's; the compaction round-trip is exact."""
    j, t = _zeroed(7)
    bm = tq.tile_bitmap(t)
    assert bm == jq.tile_bitmap(j) == (0, 1, 0, 1, 1, 1, 0)
    assert tq.tile_bitmap(t.reshape(50, 150)) == bm
    assert tq.active_row_indices(bm, 50) == jq.active_row_indices(bm, 50)
    assert tq.active_row_indices(bm, 50)[-2:] == [46, 47]
    Uj, rj = jq.compact_rows(j, bm, pad_to=pad_to)
    Ut, rt = tq.compact_rows(t, bm, pad_to=pad_to)
    assert rt.dtype == torch.int32
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(_np(Ut), _np(Uj))
    np.testing.assert_array_equal(_np(tq.expand_rows(Ut, rt, 50)),
                                  _np(jq.expand_rows(Uj, rj, 50)))
    np.testing.assert_array_equal(_np(tq.expand_rows(Ut, rt, 50)), _np(t))
    assert tq.density(bm) == jq.density(bm) == 4 / 7
    assert tq.density(None) == tq.stack_density(None) == 1.0
    with pytest.raises(ValueError, match="pad_to"):
        tq.compact_rows(t, bm, pad_to=3)
    # an all-zero U still compacts to one (zero) row
    Uz, rz = tq.compact_rows(torch.zeros(16, 3, 16), (0, 0))
    assert tuple(Uz.shape) == (1, 3, 16) and rz.tolist() == [0]


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_stack_transforms_equal_reference(bidir, precision):
    """fake_quant_stack (U only; bf16 weights keep W/b, U comes back fp32),
    stack_tile_maps (bidirectional OR-union) and stack_density, each
    bit-equal (values and dtypes) to the reference's."""
    stack = _jstack("lstm", L=2, bidir=bidir, dtype=jnp.bfloat16)
    half = "fwd" if bidir else None
    stack = _zero_tiles(stack, {0: (0, 1), 1: (2,)}, half=half)
    if bidir:
        stack = _zero_tiles(stack, {0: (1, 3)}, half="bwd")
    ours = tq.fake_quant_stack(from_jax(stack), precision)
    ref = jq.fake_quant_stack(stack, precision)
    for lo, lr in zip(ours["layers"], ref["layers"]):
        for h in (("fwd", "bwd") if bidir else (None,)):
            po, pr = (lo[h], lr[h]) if h else (lo, lr)
            for k in ("W", "U", "b"):
                assert str(po[k].dtype).removeprefix("torch.") == \
                    pr[k].dtype.name
                np.testing.assert_array_equal(_np(po[k]), _np(pr[k]))
    tm = tq.stack_tile_maps(from_jax(stack))
    assert tm == jq.stack_tile_maps(stack)
    assert tq.stack_density(tm) == jq.stack_density(tm) < 1.0
    if bidir:
        assert tm[0][1] == 0 and tm[0][0] == 1  # only tile 1 is zero in both


def test_requantization_is_idempotent():
    """quantize(dequantize(q)) == q: the stack binds the fake-quant view
    once and the executor re-quantizes it exactly."""
    _, t = _u(3)
    q, s = tq.quantize_per_gate(t)
    q2, s2 = tq.quantize_per_gate(tq.dequantize_per_gate(q, s))
    assert torch.equal(q, q2) and torch.equal(s, s2)


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

MATRIX = [("lstm", False), ("lstm", True), ("gru", False)]


@pytest.mark.parametrize("family,bidir", MATRIX)
def test_bf16_is_bit_identical_to_fp32_on_fake_quant_view(family, bidir):
    """bf16 adds no kernel-side error: the pipeline consumes the round-
    tripped fp32 weights, so it equals the port's fp32 pipeline run on the
    fake-quant view bit for bit."""
    stack = from_jax(_jstack(family, bidir=bidir))
    xs = _xs()
    got = rnn.compile(stack, rnn.ExecutionPolicy(precision="bf16"),
                      device="cpu").forward(xs)
    want = rnn.compile(tq.fake_quant_stack(stack, "bf16"),
                       device="cpu").forward(xs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("family,bidir", MATRIX)
def test_int8_forward_within_oracle_bound(family, bidir):
    """int8: rel-err <= KERNEL_GAP + 1e-6·L against the port's dequantized
    oracle and against the JAX pipeline, at L = 1 and L = 3."""
    for L in (1, 3):
        jstack = _jstack(family, L=L, bidir=bidir)
        xs = _xs()
        jcs, cs = _both(jstack, {"precision": "int8"})
        got = cs.forward(xs)
        oracle = sch.reference_stack(
            tq.fake_quant_stack(from_jax(jstack), "int8"),
            torch.from_numpy(xs))
        bound = KERNEL_GAP + INT8_REL_BOUND(L)
        assert _rel_err(got, oracle) <= bound, (family, bidir, L)
        assert _rel_err(got, jcs.forward(jnp.asarray(xs))) <= bound


def test_int8_plan_carries_precision_like_the_reference():
    """The lowered plan's item and every slot carry precision="int8"; the
    plan string equals the reference's."""
    jcs, cs = _both(_jstack("lstm"), {"precision": "int8"})
    p = cs.lower(2, 10)
    assert p.describe() == jcs.lower(2, 10).describe()
    assert all(ip.item.precision == "int8" for ip in p.items)
    assert all(s.precision == "int8" for s in p.slots)
    assert "pint8" in p.slots[0].signature()


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_int8_block_prefill_decode_resume_within_bound(family):
    """Prefill under int8 + block sparsity, then decode ticks resumed from
    its state: each within the int8 bound of the oracle and of the JAX
    pipeline; the tick is still one chained decode launch, which runs the
    dense decode kernel on the fake-quantized U."""
    L = 3
    jstack = _zero_tiles(_jstack(family, L=L), {0: (0, 3), 1: (1,),
                                                2: (2, 5)})
    xs = _xs(T=8)
    pol = {"precision": "int8", "sparsity": "block"}
    jcs, cs = _both(jstack, pol)
    fq = tq.fake_quant_stack(from_jax(jstack), "int8")
    ys, st = cs.prefill(xs)
    jys, jst = jcs.prefill(jnp.asarray(xs))
    bound = KERNEL_GAP + INT8_REL_BOUND(L)
    assert _rel_err(ys, sch.reference_stack(fq, torch.from_numpy(xs))) \
        <= bound
    assert _rel_err(ys, jys) <= bound
    for k in st:
        assert _rel_err(st[k], jst[k]) <= bound
    reset_counts(lops.lstm_decode, gops.gru_decode, lops.lstm_seq,
                 gops.gru_seq)
    y1, st1 = cs.decode(ys[:, -1], st)
    jy1, jst1 = jcs.decode(jys[:, -1], jst)
    dec = lops.lstm_decode if family == "lstm" else gops.gru_decode
    assert dec.calls == cs.last_decode_plan.launches == 1
    assert lops.lstm_seq.calls == gops.gru_seq.calls == 0
    full = sch.reference_stack(fq, torch.cat(
        [torch.from_numpy(xs), ys[:, -1:]], dim=1))
    bound1 = KERNEL_GAP + INT8_REL_BOUND(L + 1)
    assert _rel_err(y1[:, 0], full[:, -1]) <= bound1
    assert _rel_err(y1, jy1) <= bound1
    for k in st1:
        assert _rel_err(st1[k], jst1[k]) <= bound1


def test_block_sparse_forward_value_exact():
    """Skipped tiles contribute exactly 0.0: within 1e-6 of dense, and the
    compiled item carries the reference's tile maps and plan."""
    jstack = _zero_tiles(_jstack("lstm", L=2), {0: (1, 3), 1: (0, 2, 4)})
    stack = from_jax(jstack)
    xs = _xs()
    jcs, cs = _both(jstack, {"sparsity": "block"})
    p = cs.lower(2, 10)
    assert p.describe() == jcs.lower(2, 10).describe()
    assert all(ip.item.tile_map == tq.stack_tile_maps(stack)
               for ip in p.items)
    assert p.items[0].item.density < 1.0
    dense = rnn.compile(stack, device="cpu").forward(xs)
    got = cs.forward(xs)
    torch.testing.assert_close(got, dense, rtol=0, atol=SPARSE_TOL)
    np.testing.assert_allclose(_np(got), _np(jcs.forward(jnp.asarray(xs))),
                               atol=FP32_TOL)


def test_block_sparse_dense_stack_is_identity():
    """No zero tile: all-ones bitmaps, the full width, the dense output
    within 1e-6."""
    stack = from_jax(_jstack("gru", L=2))
    xs = _xs()
    cs = rnn.compile(stack, rnn.ExecutionPolicy(sparsity="block"),
                     device="cpu")
    assert cs.lower(2, 10).items[0].item.density == 1.0
    torch.testing.assert_close(
        cs.forward(xs), rnn.compile(stack, device="cpu").forward(xs),
        rtol=0, atol=SPARSE_TOL)


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_ragged_last_tile_int8_block(family):
    """H=50: 7 tiles, the last one 2 rows — zeroed in one layer, kept in
    the other; int8 + block within the bound of the oracle and of JAX."""
    W = 50
    jstack = _zero_tiles(_jstack(family, L=2, width=W), {0: (0, 6),
                                                         1: (2, 3)})
    xs = _xs(width=W)
    jcs, cs = _both(jstack, {"precision": "int8", "sparsity": "block"})
    assert tq.stack_tile_maps(from_jax(jstack))[0][-1] == 0
    got = cs.forward(xs)
    bound = KERNEL_GAP + INT8_REL_BOUND(2)
    oracle = sch.reference_stack(
        tq.fake_quant_stack(from_jax(jstack), "int8"), torch.from_numpy(xs))
    assert _rel_err(got, oracle) <= bound
    assert _rel_err(got, jcs.forward(jnp.asarray(xs))) <= bound


def test_wavefront_slot_pads_layers_to_one_active_row_width():
    """Layers keep different numbers of active rows, so a wavefront slot
    that packs cells of two layers pads to one Ha: the padding rows are
    zero U rows at index 0 and change nothing."""
    L = 3
    jstack = _zero_tiles(_jstack("lstm", L=L), {0: (0, 1, 2), 1: (4,)})
    stack = from_jax(jstack)
    xs = _xs(T=12)
    pol = rnn.ExecutionPolicy(precision="int8", sparsity="block",
                              schedule="wavefront", block_t=4)
    cs = rnn.compile(stack, pol, device="cpu")
    got = cs.forward(xs)
    mixed = [s for s in cs.plan.slots
             if len({c.layer for g in s.groups for c in g}) > 1]
    assert mixed, "expected a slot that packs two layers"
    # the recurrent-weight banks are keyed by each slot's Ha: layer 0 (24
    # active rows) was compacted at a wider Ha too, padded with zero rows
    banks = {k: v[1] for k, v in cs._operand_cache.items() if k[0] == "u"}
    has = {(l, k[4]) for k, bank in banks.items() for l, _ in bank.pos}
    assert (0, 24) in has and any(l == 0 and ha > 24 for l, ha in has)
    rows = [bank.tensors[2][bank.pos[(0, 0)]] for k, bank in banks.items()
            if k[4] > 24 and (0, 0) in bank.pos]
    assert rows and all(int(r[24:].abs().sum()) == 0 for r in rows)
    oracle = sch.reference_stack(tq.fake_quant_stack(stack, "int8"),
                                 torch.from_numpy(xs))
    assert _rel_err(got, oracle) <= KERNEL_GAP + INT8_REL_BOUND(L)


@pytest.mark.parametrize("family,bidir", MATRIX)
def test_ragged_multirequest_prefill_matches_solo(family, bidir):
    """A serving admission wave under int8 + block: ragged prompts (B=1
    each, lengths 10/10/6) pack into one plan, and each request's output
    equals its solo compile within 1e-6 and the JAX pipeline within the
    int8 bound.  (The reference asserts bit-equality with the solo run;
    in the port a packed row's GEMMs — the hoist and h·U — run in CPU
    BLAS calls of another batch size, which changes their summation
    order: the fp32 pipeline, unquantized, differs by up to 3e-8.)"""
    jstack = _zero_tiles(_jstack(family, L=2, bidir=bidir), {0: (1,),
                                                             1: (0, 3)},
                         half="fwd" if bidir else None)
    stack = from_jax(jstack)
    pol = {"precision": "int8", "sparsity": "block"}
    cs = rnn.compile(stack, rnn.ExecutionPolicy(**pol), device="cpu")
    seqs = [_xs(B=1, T=t, seed=10 + t + i) for i, t in enumerate((10, 10,
                                                                   6))]
    res = cs.prefill(seqs)
    assert cs.plan.launches < cs.plan.naive_launches  # genuinely packed
    jcs = jrnn.compile(jstack, jrnn.ExecutionPolicy(interpret=True, **pol))
    jres = jcs.prefill([jnp.asarray(x) for x in seqs])
    for x, (ys, st), (jys, _) in zip(seqs, res, jres):
        solo_y, _ = rnn.compile(stack, rnn.ExecutionPolicy(**pol),
                                device="cpu").prefill(x)
        torch.testing.assert_close(ys, solo_y, rtol=0, atol=1e-6)
        assert _rel_err(ys, jys) <= KERNEL_GAP + INT8_REL_BOUND(2)


def test_quant_cache_transforms_each_layer_once():
    """One recurrent-weight bank per (stack, family, precision, Ha), each
    layer transformed in it once and kept for the stack's lifetime: a
    second forward adds no entry."""
    stack = from_jax(_zero_tiles(_jstack("lstm", L=3), {1: (2,)}))
    cs = rnn.compile(stack, rnn.ExecutionPolicy(precision="int8",
                                                sparsity="block"),
                     device="cpu")
    xs = _xs(T=12)
    cs.forward(xs)
    keys = set(cs._operand_cache)
    banks = {k: v[1] for k, v in cs._operand_cache.items() if k[0] == "u"}
    assert {l for bank in banks.values() for l, _ in bank.pos} == {0, 1, 2}
    assert banks and all(k[3] == "int8" for k in banks)
    for bank in banks.values():
        assert sorted(bank.pos.values()) == list(range(len(bank.pos)))
        assert bank.tensors[0].dtype == torch.int8
        assert bank.tensors[1].dtype == torch.float32
    cs.forward(xs)
    assert set(cs._operand_cache) == keys


@pytest.mark.parametrize("family", ["lstm", "gru"])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_prepare_decode_stack_fake_quantizes_like_reference(family,
                                                            precision):
    """The decode operands of a bf16 stack under a reduced precision equal
    the reference's bit for bit, dtypes included."""
    jstack = _jstack(family, L=2, dtype=jnp.bfloat16)
    ours = executor.prepare_decode_stack(from_jax(jstack), family,
                                         precision=precision)
    ref = jprepare(jstack, family, precision=precision)
    for k in ("Ws", "bs", "Us"):
        assert str(ours[k].dtype).removeprefix("torch.") == ref[k].dtype.name
        np.testing.assert_array_equal(_np(ours[k]), _np(ref[k]))
    # bf16 weights under a reduced precision: U comes back fp32
    assert ours["Ws"].dtype == torch.bfloat16
    assert ours["Us"].dtype == torch.float32


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_decode_with_bf16_w_and_fp32_u_matches_reference(family):
    """The decode kernels' (bf16 W, fp32 U) operand mix — what a bf16
    stack under int8 decodes with — against the reference's decode kernel
    (fp32 activations: 1e-5; bf16 activations: 2e-2)."""
    L, B, W = 3, 2, 24
    gates = 4 if family == "lstm" else 3
    rng = np.random.default_rng(20)

    def arr(shape, scale, dtype):
        j = jnp.asarray(rng.standard_normal(shape) * scale, dtype)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            getattr(torch, jnp.dtype(dtype).name))

    for act, tol in ((jnp.float32, FP32_TOL), (jnp.bfloat16, 2e-2)):
        xw0 = arr((B, gates, W), 1.0, act)
        Ws = arr((L, W, gates, W), W ** -0.5, jnp.bfloat16)
        bs = arr((L, gates, W), 0.1, jnp.bfloat16)
        Us = arr((L, W, gates, W), W ** -0.5, jnp.float32)
        h0 = arr((L, B, W), 0.5, act)
        if family == "lstm":
            c0 = arr((L, B, W), 0.5, jnp.float32)
            ref = jlops.lstm_decode(xw0[0], Ws[0], bs[0], Us[0], h0[0],
                                    c0[0], interpret=True)
            ours = lops.lstm_decode(xw0[1], Ws[1], bs[1], Us[1], h0[1],
                                    c0[1])
        else:
            ref = (jgops.gru_decode(xw0[0], Ws[0], bs[0], Us[0], h0[0],
                                    interpret=True),)
            ours = (gops.gru_decode(xw0[1], Ws[1], bs[1], Us[1], h0[1]),)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(_np(o), _np(r), atol=tol)
    # fp32 W with a bf16 U: the entry point upcasts U, exactly
    Ub = torch.randn(L, W, gates, W, dtype=torch.bfloat16)
    assert decode_u(Ub, torch.zeros(1)).dtype == torch.float32
    assert decode_u(Ub, Ub) is Ub


def test_reference_rung_dequantizes_and_expands():
    """Under on_fault="fallback", a fault through the per-step rung lands
    on the CPU reference rung, which rebuilds the dense dequantized U: the
    output stays within the int8 bound of the healthy run."""
    stack = from_jax(_zero_tiles(_jstack("gru", L=2), {0: (1, 2)}))
    xs = _xs()
    pol = dict(precision="int8", sparsity="block")
    healthy = rnn.compile(stack, rnn.ExecutionPolicy(**pol),
                          device="cpu").forward(xs)
    cs = rnn.compile(stack, rnn.ExecutionPolicy(on_fault="fallback", **pol),
                     device="cpu")
    cs.fault.arm([0], through_level=1)
    got = cs.forward(xs)
    assert cs.stats.fallback_level == 2
    assert _rel_err(got, healthy) <= KERNEL_GAP + INT8_REL_BOUND(2)


def test_measured_cost_model_still_raises():
    """The measured cost model (P2) is ported: it constructs with int8 and
    block sparsity, and ``describe()`` names all three."""
    pol = rnn.ExecutionPolicy(precision="int8", sparsity="block",
                              cost_model="measured")
    assert (pol.precision, pol.sparsity, pol.cost_model) == \
        ("int8", "block", "measured")
    for part in ("precision=int8", "sparsity=block", "cost_model=measured"):
        assert part in pol.describe()


# ---------------------------------------------------------------------------
# on the card: the int8 / compacted branches against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _branch(G, Hh, gates, variant, seed):
    """(U, u_scales, u_rows) of one weight branch, cells with different
    zero tiles (so a compacted launch pads to one Ha)."""
    g = torch.Generator().manual_seed(seed)
    U = torch.randn((G, Hh, gates, Hh), generator=g) * Hh ** -0.5
    maps = []
    for c in range(G):
        keep = tuple(int(t % (c + 2) != 0) for t in range(-(-Hh // 8)))
        for t, bit in enumerate(keep):
            if not bit:
                U[c, t * 8:(t + 1) * 8] = 0.0
        maps.append(keep)
    scales = rows = None
    if "int8" in variant:
        q = [tq.quantize_per_gate(U[c]) for c in range(G)]
        U, scales = torch.stack([a for a, _ in q]), torch.stack(
            [s for _, s in q])
    if "compact" in variant:
        Ha = max(len(tq.active_row_indices(m, Hh)) for m in maps)
        c = [tq.compact_rows(U[i], maps[i], pad_to=Ha) for i in range(G)]
        U, rows = torch.stack([a for a, _ in c]), torch.stack(
            [r for _, r in c])
    return U, scales, rows


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["lstm", "gru"])
@pytest.mark.parametrize("variant", ["int8", "compact", "int8+compact"])
@pytest.mark.parametrize("Hh", [340, 50])
def test_cuda_seq_weight_branches_match_plain(cuda, family, variant, Hh):
    """Each branch on the card against its plain version on the same
    operands (1e-4: the kernel sums h·U in another order)."""
    gates = 4 if family == "lstm" else 3
    G, B, T = 3, 4, 9
    U, sc, rows = (None if t is None else t.to(cuda)
                   for t in _branch(G, Hh, gates, variant, seed=Hh))
    g = torch.Generator().manual_seed(1)
    xw = torch.randn((G, B, T, gates, Hh), generator=g).to(cuda)
    h0 = (torch.randn((G, B, Hh), generator=g) * 0.5).to(cuda)
    c0 = (torch.randn((G, B, Hh), generator=g) * 0.5).to(cuda)
    seq, plain = ((lops.lstm_seq, lops.lstm_seq_plain) if family == "lstm"
                  else (gops.gru_seq, gops.gru_seq_plain))
    st = (h0, c0) if family == "lstm" else (h0,)
    reset_counts(seq)
    out = seq(U, xw, *st, b_valid=[4, 2, 1], u_scales=sc, u_rows=rows)
    mask = torch.tensor([[1] * 4, [1, 1, 0, 0], [1, 0, 0, 0]],
                        dtype=torch.int32, device=cuda)
    ref = plain(U, xw, *st, mask, sc, rows)
    torch.cuda.synchronize()
    assert seq.kernel_launches == 1
    assert seq.variant_launches == {variant: 1}
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_cuda_decode_with_bf16_w_and_fp32_u_matches_plain(cuda, family):
    """The decode kernels' (bf16 W, fp32 U) instance against the plain
    version at a BYSDNE tick (1e-4: another summation order)."""
    gates = 4 if family == "lstm" else 3
    L, B, Hh = 5, 4, 340
    g = torch.Generator().manual_seed(2)
    Ws = (torch.randn((L, Hh, gates, Hh), generator=g) * Hh ** -0.5).to(
        torch.bfloat16)
    bs = (torch.randn((L, gates, Hh), generator=g) * 0.1).to(torch.bfloat16)
    Us = torch.randn((L, Hh, gates, Hh), generator=g) * Hh ** -0.5
    xw0 = torch.randn((B, gates, Hh), generator=g)
    h0 = torch.randn((L, B, Hh), generator=g) * 0.5
    c0 = torch.randn((L, B, Hh), generator=g) * 0.5
    args = [t.to(cuda) for t in (xw0, Ws, bs, Us, h0)]
    if family == "lstm":
        args.append(c0.to(cuda))
        out, ref = lops.lstm_decode(*args), lops.lstm_decode_plain(*args)
    else:
        out, ref = (gops.gru_decode(*args),), (gops.gru_decode_plain(*args),)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-4)
