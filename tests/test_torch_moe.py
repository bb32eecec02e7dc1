"""The port's MoE FFN — models.layers.moe (routing, capacity, dispatch,
the experts, combine, the aux loss, the dense all-experts reference) and
the MoE decoders olmoe-1b-7b and arctic-480b (with its dense residual
branch) through models.transformer and serving.ServingEngine — against the
JAX package on the CPU, at their ``reduced()`` widths.

Weights come from the JAX initialisers through ``convert.from_jax``;
inputs from numpy seeds.

Tolerances: routing is compared exactly (expert, slot and valid equal on
the same logits, hand-built ties included; the renormalised weights
within 1e-7, one fp32 ulp of values <= 1: the two softmaxes round
differently).  fp32 logits and the aux loss within 1e-5 absolute (TOL;
the two packages sum products in other orders: a few fp32 ulps of values
of magnitude ~1-3).  The layer on unnormalised inputs within 1e-6 of its
largest |output| (REL_TOL, ~8 fp32 ulps): the experts' weights are drawn
at 1/sqrt(E) (the reference's fan-in quirk), so outputs reach ~30 and
sums of such terms cancel to values near 1, where an order-of-summation
difference of a few ulps of the terms shows.  bf16 logits within 0.1 (BF16_TOL,
as tests/test_torch_dense.py).  Incremental decode against the full
forward within 2e-3 at capacity_factor 64, the reference's own check
(tests/models/test_decode_equivalence.py).  Greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests._hyp import given, settings, st

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as jtf
from repro.models.layers import moe as jmoe
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax
from repro_torch.kernels.common import reset_counts
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.mvm_tile.ops import mvm
from repro_torch.models import transformer as tf
from repro_torch.models.layers import moe
from repro_torch.models.layers.mlp import apply_mlp
from repro_torch.serving import Request, ServingEngine

TOL = 1e-5
REL_TOL = 1e-6
W_TOL = 1e-7
BF16_TOL = 0.1
INC_TOL = 2e-3
MOE = ("olmoe-1b-7b", "arctic-480b")
B, S, TAIL = 2, 24, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(ours.float() if isinstance(ours, torch.Tensor) else ours,
                   dtype=np.float32),
        np.asarray(jnp.asarray(ref, jnp.float32)), atol=tol, rtol=0)


_MODELS = {}
# the reference jitted (one compile, not one per op): init_params draws the
# same values jitted or not
_jinit = jax.jit(jtf.init_params, static_argnums=0)
_japply = jax.jit(jmoe.apply_moe, static_argnames=(
    "k", "capacity_factor", "deterministic_capacity"))
_jdense = jax.jit(jmoe.moe_reference, static_argnames=("k",))


def _model(arch, dtype="float32", **change):
    """The reduced config of ``arch`` in both packages (in ``dtype``, with
    ``change``) and one weight set from the JAX initialiser, cached."""
    key = (arch, dtype, tuple(sorted(change.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jget_reduced(arch), dtype=dtype, **change)
        cfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype,
                                  **change)
        jp = _jinit(jcfg, jax.random.PRNGKey(0))
        _MODELS[key] = (jcfg, cfg, jp, from_jax(jax.tree.map(np.asarray, jp)))
    return _MODELS[key]


def _layer(arch, dtype="float32"):
    """Layer 0's MoE params of ``arch``'s reduced model, in both
    packages."""
    _, cfg, jp, tp = _model(arch, dtype)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    return cfg, jl, tf.layer_view(tp["layers"], 0)["moe"]


def _close_rel(ours, ref, rel=REL_TOL):
    _close(ours, ref, rel * float(jnp.abs(ref).max()))


def _x(d, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, n, d)).astype(dtype)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _route_pair(logits, k, C, E):
    ref = jmoe.route(jnp.asarray(logits), k, C, E)
    ours = moe.route(torch.from_numpy(logits), k, C, E)
    return ours, [np.asarray(r) for r in ref]


def _assert_same_route(ours, ref):
    e, s, w, v = ours
    assert e.tolist() == ref[0].tolist()
    assert s.tolist() == ref[1].tolist()
    assert v.tolist() == ref[3].tolist()
    _close(w, ref[2], W_TOL)


@pytest.mark.parametrize("T,E,k,C", [(16, 8, 2, 8), (48, 8, 4, 24),
                                     (64, 4, 1, 8), (40, 16, 3, 9)])
def test_route_matches_the_reference(T, E, k, C):
    """Experts, slots and valid equal pick for pick on the same random
    logits (capacities with drops), weights within 1e-7."""
    logits = np.random.default_rng(T + E).standard_normal(
        (T, E)).astype(np.float32)
    _assert_same_route(*_route_pair(logits, k, C, E))


def test_route_breaks_ties_as_the_reference():
    """Tied probabilities: jax.lax.top_k takes the lower expert index
    first ([.1, .3, .3, .2, .3, .1] at k = 3 gives experts 1, 2, 4 in
    that order), and a tie at the k-th boundary sends the pick to the
    lower index, which decides which tokens a full expert drops.  The
    port's stable sort picks the same (torch.topk promises no order)."""
    row = np.log(np.array([.1, .3, .3, .2, .3, .1], np.float32))
    ours, ref = _route_pair(row[None], 3, 8, 6)
    assert ref[0].tolist() == [[1, 2, 4]]
    _assert_same_route(ours, ref)
    # every row ties three experts for two picks: capacity 8 of 10 rows
    # overflows expert 0 and 1, so ties decide the drops
    tied = np.log(np.tile(np.array([.3, .3, .3, .1], np.float32), (10, 1)))
    tied[::3] = np.log(np.array([.1, .3, .3, .3], np.float32))
    ours, ref = _route_pair(tied, 2, 8, 4)
    assert not ref[3].all()
    _assert_same_route(ours, ref)


@pytest.mark.parametrize("T,k,E,factor", [(1, 8, 64, 1.25), (4, 8, 64, 4.0),
                                          (256, 8, 64, 1.25),
                                          (300, 2, 128, 1.25),
                                          (40, 4, 8, 64.0), (64, 1, 4, 1e-9)])
def test_capacity_matches_the_reference(T, k, E, factor):
    """ceil(T k factor / E) clamped to [8, T] (the lower clamp first, as
    the reference: T < 8 gives 8)."""
    assert moe._capacity(T, k, E, factor) == jmoe._capacity(T, k, E, factor)


def test_aux_loss_matches_the_reference():
    """The load-balance loss on random logits and their top-k picks
    (1e-6), and the reference's own invariant: skew is penalised, and
    perfect balance gives ~1 (tests/models/test_moe.py)."""
    logits = np.random.default_rng(3).standard_normal(
        (50, 8)).astype(np.float32)
    top = np.asarray(jax.lax.top_k(jnp.asarray(logits), 2)[1])
    ref = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(top), 8)
    ours = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(top.copy()).long(), 8)
    assert ours.dtype == torch.float32 and ours.shape == ()
    _close(ours, ref, 1e-6)
    E, T = 8, 256
    balanced = torch.eye(E).repeat(T // E, 1) * 4.0
    skewed = torch.zeros((T, E))
    skewed[:, 0] = 4.0
    lb = moe.aux_load_balance_loss(balanced, balanced.argmax(-1)[:, None], E)
    ls = moe.aux_load_balance_loss(skewed, skewed.argmax(-1)[:, None], E)
    assert float(ls) > float(lb)
    assert float(lb) == pytest.approx(1.0, abs=0.3)


@settings(max_examples=10, deadline=None)
@given(T=st.integers(4, 64), E=st.sampled_from([4, 8]), k=st.integers(1, 3),
       seed=st.integers(0, 3))
def test_route_invariants(T, E, k, seed):
    """The reference's routing invariants on the port's route: weights
    sum to 1, k distinct experts a token, each (expert, slot) held at
    most once, valid slots below capacity, each expert's load
    min(demand, C)."""
    logits = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (T, E)).astype(np.float32))
    C = max(1, T * k // E)
    e, s, w, v = (t.numpy() for t in moe.route(logits, k, C, E))
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)
    assert (e >= 0).all() and (e < E).all()
    assert all(len(set(row)) == k for row in e)
    pairs = [(int(e[t, j]), int(s[t, j]))
             for t in range(T) for j in range(k) if v[t, j]]
    assert len(pairs) == len(set(pairs))
    assert all(0 <= slot < C for _, slot in pairs)
    demand = np.bincount(e.reshape(-1), minlength=E)
    load = np.bincount([p[0] for p in pairs], minlength=E)
    np.testing.assert_array_equal(load, np.minimum(demand, C))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", ["drops", "drop-free"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_the_reference(arch, cap):
    """apply_moe at the arch's reduced width (olmoe 8 experts top-4,
    arctic 8 top-2 with its dense branch) on 48 tokens: at capacity
    factor 1.0 (capacities 24 / 12: drops) and at capacity T (none);
    y within REL_TOL, the aux loss within 1e-5."""
    cfg, jl, tl = _layer(arch)
    x = _x(cfg.d_model, 48, seed=11)
    kw = dict(k=cfg.experts_per_token, capacity_factor=1.0,
              deterministic_capacity=48 if cap == "drop-free" else 0)
    jy, jaux = _japply(jl, jnp.asarray(x), **kw)
    y, aux = moe.apply_moe(tl, torch.from_numpy(x), **kw)
    assert y.shape == (1, 48, cfg.d_model) and aux.dtype == torch.float32
    _close_rel(y, jy)
    _close(aux, jaux)
    if cap == "drops":
        _, _, _, valid = moe.route(
            torch.from_numpy(x[0]) @ tl["router"], cfg.experts_per_token,
            moe._capacity(48, cfg.experts_per_token, cfg.n_experts, 1.0),
            cfg.n_experts)
        assert not valid.all()


@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_the_reference_bf16(arch):
    """The same layer in bf16 (the experts' bf16 operands with an fp32
    result, then rounded), drop-free: within BF16_TOL."""
    cfg, jl, tl = _layer(arch, "bfloat16")
    x = _x(cfg.d_model, 16, seed=12)
    kw = dict(k=cfg.experts_per_token, capacity_factor=1.0,
              deterministic_capacity=16)
    jy, _ = _japply(jl, jnp.asarray(x, jnp.bfloat16), **kw)
    y, _ = moe.apply_moe(tl, torch.from_numpy(x).bfloat16(), **kw)
    assert y.dtype == torch.bfloat16
    _close(y, jy, BF16_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_reference_matches_the_reference(arch):
    """The dense all-experts reference (REL_TOL), and apply_moe without
    drops equals it (the reference's
    test_matches_dense_reference_when_no_drops, 1e-4)."""
    cfg, jl, tl = _layer(arch)
    x = _x(cfg.d_model, 16, seed=13)
    k = cfg.experts_per_token
    ours = moe.moe_reference(tl, torch.from_numpy(x), k=k)
    _close_rel(ours, _jdense(jl, jnp.asarray(x), k=k))
    y, _ = moe.apply_moe(tl, torch.from_numpy(x), k=k, capacity_factor=1.0,
                         deterministic_capacity=16)
    torch.testing.assert_close(y, ours, rtol=0, atol=1e-4)


def test_dropped_tokens_contribute_zero():
    """At the smallest capacity (8 of 64 tokens an expert, top-1) the
    output differs from the drop-free one, and each dropped token's
    output is exactly zero (the residual carries it)."""
    p = moe.init_moe(torch.Generator().manual_seed(0), 8, 16, 4,
                     torch.float32)
    x = torch.from_numpy(_x(8, 64, seed=2))
    y, _ = moe.apply_moe(p, x, k=1, capacity_factor=1e-9)
    y_full, _ = moe.apply_moe(p, x, k=1, capacity_factor=1.0,
                              deterministic_capacity=64)
    assert not torch.allclose(y, y_full)
    _, _, _, valid = moe.route(x[0] @ p["router"], 1, 8, 4)
    assert (~valid).any()
    assert torch.equal(y[0][~valid[:, 0]], torch.zeros_like(
        y[0][~valid[:, 0]]))


def test_arctic_dense_residual_branch():
    """init_moe with dense_ff builds the dense branch, which apply_moe
    adds (the reference's test)."""
    p = moe.init_moe(torch.Generator().manual_seed(0), 8, 16, 4,
                     torch.float32, dense_ff=16)
    assert "dense" in p
    x = torch.from_numpy(_x(8, 4, seed=1))
    y, _ = moe.apply_moe(p, x, k=2, capacity_factor=4.0)
    assert torch.isfinite(y).all()
    assert not torch.allclose(y, y - apply_mlp(p["dense"], x))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_stacked_moe_layout_equals_the_reference(arch):
    """The reference's stacked MoE tree crosses convert.from_jax one to
    one, every leaf exact; the port's own init_params (bf16, from a
    torch.Generator) has the reference's keys, shapes and dtypes, its
    expert leaves drawn at the reference's scale, 1/sqrt(E) (dense_init's
    fan-in is shape[0], E), truncated at two standard deviations."""
    jcfg, cfg, jp, tp = _model(arch)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for key in path:
            node = node[key.key]
        assert torch.equal(node, torch.from_numpy(np.array(leaf)))
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    ours = tf.init_params(bf, torch.Generator().manual_seed(0))
    ref = _jinit(dataclasses.replace(jcfg, dtype="bfloat16"),
                 jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref) == \
        jax.tree.map(lambda t: (tuple(t.shape),
                                str(t.dtype).removeprefix("torch.")), ours)
    bound = 2.0 / np.sqrt(cfg.n_experts)
    for name in ("w_gate", "w_up", "w_down"):
        for w in (ours["layers"]["moe"][name].float().numpy(),
                  np.asarray(ref["layers"]["moe"][name], np.float32)):
            assert np.abs(w).max() <= bound * (1 + 2 ** -7)
            assert np.abs(w).max() > 0.9 * bound
    if arch == "arctic-480b":
        assert set(ours["layers"]["moe"]) == {"router", "w_gate", "w_up",
                                              "w_down", "dense"}


def test_stacked_experts_are_drawn_in_place(monkeypatch):
    """init_params draws the stacked expert leaves expert by expert into
    one (L, E, ...) allocation: every draw_experts call writes into its
    layer's slice of the stacked leaf (no layer of experts is drawn whole
    and copied), and layer l of the stacked init equals layer l of the
    same config unrolled from the same seed (the same draws in the same
    order)."""
    cfg = configs.get_reduced("arctic-480b")
    drawn = []
    draw = moe.draw_experts

    def record(gen, out):
        drawn.append(out.data_ptr())
        return draw(gen, out)

    monkeypatch.setattr(moe, "draw_experts", record)
    stacked = tf.init_params(cfg, torch.Generator().manual_seed(3))
    leaves = stacked["layers"]["moe"]
    assert drawn == [leaves[name][i].data_ptr()
                     for i in range(cfg.n_layers)
                     for name in ("w_gate", "w_up", "w_down")]
    monkeypatch.undo()
    unrolled = tf.init_params(dataclasses.replace(cfg, scan_layers=False),
                              torch.Generator().manual_seed(3))
    for i in range(cfg.n_layers):
        view = tf.layer_view(stacked["layers"], i)
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                unrolled["layers"][i]):
            node = view
            for key in path:
                node = node[key.key]
            assert torch.equal(node, leaf)
    gen = torch.Generator().manual_seed(5)
    out = torch.empty((4, 3, 5))
    assert moe.draw_experts(gen, out) is out


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _tokens(cfg, seed, n=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE)
def test_forward_and_aux_loss_match_the_reference(arch):
    """The full-sequence forward's logits and its aux loss (summed over
    the layers) against the reference, fp32 at 1e-5."""
    jcfg, cfg, jp, tp = _model(arch)
    tok = _tokens(cfg, seed=1)
    jl, _, jaux = jax.jit(lambda p, t: jtf.forward(jcfg, p, tokens=t))(
        jp, jnp.asarray(tok))
    logits, _, aux = tf.forward(cfg, tp, tokens=torch.from_numpy(tok).long())
    _close(logits, jl)
    _close(aux, jaux)
    assert float(aux) > 0


def _prefill_decode(jcfg, cfg, jp, tp, tok):
    jpre = jax.jit(lambda p, b: jtf.prefill(jcfg, p, b, seq_len=S))
    jdec = jax.jit(lambda p, c, b: jtf.decode_step(jcfg, p, c, b))
    jl, jc = jpre(jp, {"tokens": jnp.asarray(tok[:, :S - TAIL])})
    lg, cache = tf.prefill(cfg, tp, {"tokens": torch.from_numpy(
        tok[:, :S - TAIL]).long()}, seq_len=S)
    ours, refs = [lg], [jl]
    for t in range(S - TAIL, S):
        jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok[:, t:t + 1])})
        lg, cache = tf.decode_step(cfg, tp, cache, {
            "tokens": torch.from_numpy(tok[:, t:t + 1]).long()})
        ours.append(lg)
        refs.append(jl)
    return torch.cat(ours, 1), jnp.concatenate(refs, 1)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_the_reference(arch, dtype, tol):
    """A prefill of 20 positions (capacity 25 / 13 at factor 1.25: drops)
    then 4 decode steps (the decode capacity, drop-free) against the
    jitted reference."""
    jcfg, cfg, jp, tp = _model(arch, dtype)
    ours, ref = _prefill_decode(jcfg, cfg, jp, tp, _tokens(cfg, seed=5))
    assert ours.shape == (B, S, cfg.vocab_size)
    _close(ours, ref, tol)


@pytest.mark.parametrize("arch", MOE)
def test_incremental_decode_matches_the_full_forward(arch):
    """At capacity_factor 64 (no drops; the reference's own setting for
    this check) prefill + token-by-token decode reproduces the full
    forward within 2e-3."""
    _, cfg, _, tp = _model(arch, capacity_factor=64.0)
    tok = torch.from_numpy(_tokens(cfg, seed=7)).long()
    full, _, _ = tf.forward(cfg, tp, tokens=tok)
    lg, cache = tf.prefill(cfg, tp, {"tokens": tok[:, :S - TAIL]},
                           seq_len=S)
    outs = [lg]
    for t in range(S - TAIL, S):
        lg, cache = tf.decode_step(cfg, tp, cache,
                                   {"tokens": tok[:, t:t + 1]})
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0,
                               atol=INC_TOL)


@pytest.mark.parametrize("arch,per_layer", [("olmoe-1b-7b", 3),
                                            ("arctic-480b", 6)])
def test_decode_step_calls_mvm_and_decode_attention(arch, per_layer):
    """A decode step calls mvm for the attention's three projections a
    layer (and arctic's dense branch three more) and decode_attention
    once a layer; the router and the experts call neither; a prefill
    calls neither."""
    _, cfg, _, tp = _model(arch)
    tok = torch.from_numpy(_tokens(cfg, seed=8, n=9)).long()
    reset_counts(mvm, decode_attention)
    _, cache = tf.prefill(cfg, tp, {"tokens": tok[:, :8]}, seq_len=32)
    assert (mvm.calls, decode_attention.calls) == (0, 0)
    tf.decode_step(cfg, tp, cache, {"tokens": tok[:, 8:9]})
    assert (mvm.calls, decode_attention.calls) == (per_layer * cfg.n_layers,
                                                   cfg.n_layers)
    assert (mvm.kernel_launches, decode_attention.kernel_launches) == (0, 0)


@pytest.mark.parametrize("arch", MOE)
def test_engine_matches_the_reference_engine(arch):
    """ServingEngine(device="cpu") gives the reference engine's greedy
    tokens (prompts of 5, 9, 3 and 21 tokens: buckets 2-16 with drops at
    factor 1.25 and remainder steps; max_batch 2, 6 new tokens)."""
    jcfg, cfg, jp, tp = _model(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 3, 21)]
    jeng = JServingEngine(jcfg, jp, max_batch=2, max_seq=64)
    for uid, p in enumerate(prompts):
        jeng.submit(JRequest(uid=uid, tokens=p, max_new_tokens=6))
    ref = {c.uid: c.tokens for c in jeng.run_to_completion()}
    eng = ServingEngine(cfg, tp, max_batch=2, max_seq=64, device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=6))
    assert {c.uid: c.tokens for c in eng.run_to_completion()} == ref
    assert eng.prefill_lengths == jeng.prefill_lengths == {2, 4, 8, 16}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE)
def test_cuda_moe_graph_replay_matches_the_eager_step(cuda, arch):
    """The MoE decode step (bf16, reduced width) captures into the
    engine's CUDA graph (nothing in routing or dispatch syncs with the
    host) and its replay equals the step run eagerly on a clone of the
    static cache, bit for bit; a replay counts 3 (olmoe) or 6 (arctic)
    mvm and one decode_attention launch a layer."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="bfloat16")
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=64)
    rng = np.random.default_rng(0)
    for uid, n in enumerate((5, 19)):
        eng.submit(Request(uid=uid, tokens=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=8))
    eng.step()
    eng.step()
    graph = eng.tick_graph
    assert graph.graph is not None and graph.replays == 1
    with torch.inference_mode():
        cache = {"layers": {k: t.clone()
                            for k, t in graph.cache["layers"].items()},
                 "idx": graph.cache["idx"].clone()}
        tokens = torch.as_tensor(eng.last_token, device=cuda)
        reset_counts(mvm, decode_attention)
        replayed = graph(tokens).clone()
        n = (mvm.kernel_launches, decode_attention.kernel_launches)
        eager = graph.eager(cache=cache, tokens=tokens)
        torch.cuda.synchronize()
    per_layer = 6 if cfg.moe_dense_ff else 3
    assert n == (per_layer * cfg.n_layers, cfg.n_layers)
    assert torch.equal(replayed, eager)
