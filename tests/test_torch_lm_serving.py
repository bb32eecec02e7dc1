"""The port's transformer side — models.layers (norm, rope, mlp,
attention), models.transformer, serving.ServingEngine, configs and
launch.serve — against the JAX package on the CPU, on RecurrentGemma-2B's
reduced config (3 layers: rglru, rglru, attn; d_model 64; window 16).

Weights come from the JAX initialisers through ``convert.from_jax``; inputs
from numpy seeds.  On the CPU the port's decode step runs the plain
versions of the ``mvm`` and ``decode_attention`` kernels and its prefill
the plain ``rglru_scan``; their call counters show the path.

Tolerances: fp32 logits and layer outputs within 1e-5 absolute (the two
packages sum products in other orders and use other exp/tanh/sin/cos
implementations: a few fp32 ulps of logits of magnitude ~3).  The RG-LRU
scan within 1e-6, as in tests/test_torch_rglru.py.  bf16 logits within
0.1 absolute (BF16_TOL): bf16 keeps 8 significant bits, and the two
packages round at different points (XLA fuses the elementwise code of
rope, conv1d and the residual adds; PyTorch rounds after each op), so the
hidden state differs by a few bf16 ulps (2^-8 relative) per layer, over
3 layers, on logits of magnitude ~3.  Greedy tokens are compared exactly
in fp32.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as jtf
from repro.models.layers import attention as jattn
from repro.models.layers import mlp as jmlp
from repro.models.layers import norm as jnorm
from repro.models.layers import rglru as jrglru
from repro.models.layers import rope as jrope
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from tests.conftest import SRC

from repro_torch import configs
from repro_torch.convert import from_jax
from repro_torch.kernels.common import reset_counts
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.mvm_tile.ops import mvm
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.models import transformer as tf
from repro_torch.models.layers import attention, mlp, norm, rglru, rope
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import DecodeGraph

TOL = 1e-5
SCAN_TOL = 1e-6
BF16_TOL = 0.1
ARCH = "recurrentgemma-2b"


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


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def model():
    """The reduced config in both packages and one weight set (fp32)."""
    jcfg = jget_reduced(ARCH)
    cfg = configs.get_reduced(ARCH)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, from_jax(jax.tree.map(np.asarray, jp))


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_and_rope_match_reference(dtype):
    """rms_norm, rope_angles and apply_rope (fp32 within 1e-5; bf16 outputs
    within one bf16 rounding, 2^-8 relative of |x| <= ~4: 2e-2)."""
    tol = TOL if dtype == torch.float32 else 2e-2
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (rng.standard_normal(64) * 0.1).astype(np.float32)
    _close(norm.rms_norm(_t(x, dtype), _t(scale, dtype)),
           jnorm.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt)), tol)
    pos = rng.integers(0, 3000, (2, 7)).astype(np.int32)
    cos, sin = rope.rope_angles(_t(pos), 32, 10_000.0)
    jcos, jsin = jrope.rope_angles(jnp.asarray(pos), 32, 10_000.0)
    _close(cos, jcos, 1e-5)
    _close(sin, jsin, 1e-5)
    q = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    out = rope.apply_rope(_t(q, dtype), cos, sin)
    assert out.dtype == dtype
    _close(out, jrope.apply_rope(jnp.asarray(q, jdt), jcos, jsin), tol)
    # (S, half) angles broadcast over the batch
    c1, s1 = rope.rope_angles(_t(pos[0]), 32, 10_000.0)
    jc1, js1 = jrope.rope_angles(jnp.asarray(pos[0]), 32, 10_000.0)
    _close(rope.apply_rope(_t(q, dtype), c1, s1),
           jrope.apply_rope(jnp.asarray(q, jdt), jc1, js1), tol)


def test_mlp_matches_reference_on_both_paths():
    """apply_mlp as prefill (torch.matmul) and as decode (three mvm calls)
    against the reference's apply_mlp."""
    p = jmlp.init_mlp(jax.random.PRNGKey(1), 64, 128, jnp.float32)
    tp = from_jax(p)
    x = np.random.default_rng(1).standard_normal((3, 1, 64)).astype(
        np.float32)
    ref = jmlp.apply_mlp(p, jnp.asarray(x))
    _close(mlp.apply_mlp(tp, _t(x)), ref)
    reset_counts(mvm)
    _close(mlp.apply_mlp(tp, _t(x), decode=True), ref)
    assert mvm.calls == 3
    init = mlp.init_mlp(torch.Generator().manual_seed(0), 64, 128,
                        torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == {
        k: (v.shape, torch.bfloat16) for k, v in p.items()}


def _qkv(B, S, Hq, Hk, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hk, D)).astype(np.float32),
            rng.standard_normal((B, S, Hk, D)).astype(np.float32))


@pytest.mark.parametrize("window", [0, 16])
def test_prefill_attention_paths_match_reference(window):
    """naive (with and without a window), blockwise (several q and kv
    chunks, causal chunks skipped) and local attention, GQA, fp32."""
    q, k, v = _qkv(2, 64, 4, 2, 16, seed=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(_t, (q, k, v))
    _close(attention.naive_attention(tq, tk, tv, window=window),
           jattn.naive_attention(jq, jk, jv, window=window))
    _close(attention.blockwise_attention(tq, tk, tv, q_chunk=16, kv_chunk=32),
           jattn.blockwise_attention(jq, jk, jv, q_chunk=16, kv_chunk=32))
    if window:
        # a ragged length: local attention pads to a multiple of the window
        q, k, v = _qkv(2, 40, 4, 2, 16, seed=5)
        _close(attention.local_attention(*map(_t, (q, k, v)), window=window),
               jattn.local_attention(*map(jnp.asarray, (q, k, v)),
                                     window=window))
    with pytest.raises(ValueError, match="multiples"):
        attention.blockwise_attention(tq[:, :48], tk, tv, q_chunk=32)


def test_model_decode_attention_over_a_wrapped_ring():
    """The model-level decode_attention on a ring cache whose rows are full
    (wrapped) or partly live, with window 0 and with a window longer than
    the ring; T = 8192 takes the reference's chunked branch; a window that
    would mask live slots raises."""
    rng = np.random.default_rng(7)
    B, T, Hq, Hk, D = 3, 16, 4, 2, 16
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((B, T, Hk, D)).astype(np.float32)
    vc = rng.standard_normal((B, T, Hk, D)).astype(np.float32)
    valid = np.array([16, 3, 16], np.int32)
    reset_counts(decode_attention)
    for window in (0, 32):
        ours = attention.decode_attention(_t(q), _t(kc), _t(vc), _t(valid),
                                          window=window)
        ref = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, valid)),
                                     window=window)
        assert ours.shape == (B, 1, Hq, D)
        _close(ours, ref)
    assert decode_attention.calls == 2
    with pytest.raises(ValueError, match="window"):
        attention.decode_attention(_t(q), _t(kc), _t(vc), _t(valid),
                                   window=8)
    T = 8192
    kc = rng.standard_normal((2, T, 1, 8)).astype(np.float32)
    vc = rng.standard_normal((2, T, 1, 8)).astype(np.float32)
    q = rng.standard_normal((2, 1, 2, 8)).astype(np.float32)
    valid = np.array([T, 5000], np.int32)
    _close(attention.decode_attention(*map(_t, (q, kc, vc, valid))),
           jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, valid)),
                                  prefer_chunked=True))


def test_apply_rglru_runs_the_scan_entry_point(model):
    """The model's RG-LRU prefill goes through ONE rglru_scan call (the
    kernel on the card, its plain version here) and equals the reference's
    apply_rglru within 1e-6, from zero and from a given state."""
    p = jrglru.init_rglru(jax.random.PRNGKey(3), 48, jnp.float32)
    tp = from_jax(p)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 48)).astype(np.float32)
    h0 = rng.standard_normal((2, 48)).astype(np.float32)
    for h in (None, h0):
        reset_counts(rglru_scan)
        ours = rglru.apply_rglru(tp, _t(x), None if h is None else _t(h))
        assert rglru_scan.calls == 1
        ref = jrglru.apply_rglru(p, jnp.asarray(x),
                                 None if h is None else jnp.asarray(h))
        for o, r in zip(ours, ref):
            _close(o, r, SCAN_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_param_tree_converts_and_matches_the_reference_layout(model):
    """convert.from_jax carries the transformer's whole tree (dicts in a
    list of layers), every leaf exact; the port's own init_params has the
    reference's keys, shapes and dtypes (values from another generator)."""
    jcfg, cfg, jp, tp = model
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in jleaves:
        node = tp
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    ours = tf.init_params(bf, torch.Generator().manual_seed(0))
    ref = jtf.init_params(dataclasses.replace(jcfg, dtype="bfloat16"),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref) == \
        jax.tree.map(lambda t: (tuple(t.shape),
                                str(t.dtype).removeprefix("torch.")), ours)
    assert tf.init_cache(cfg, 2, 64)["layers"][2]["k"].shape == (2, 16, 32)


def _prefill_decode(jcfg, cfg, jp, tp, tokens, S, TAIL):
    """Logits of a prefill of S - TAIL tokens and TAIL decode steps, from
    both packages (the reference jitted, as its engine runs it)."""
    jpre = jax.jit(lambda p, t: jtf.prefill(jcfg, p, {"tokens": t},
                                            seq_len=S))
    jdec = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c,
                                                   {"tokens": t}))
    jl, jc = jpre(jp, jnp.asarray(tokens[:, :S - TAIL]))
    lg, cache = tf.prefill(cfg, tp, {"tokens": _t(tokens[:, :S - TAIL])},
                           seq_len=S)
    ours, refs = [lg], [jl]
    for t in range(S - TAIL, S):
        jl, jc = jdec(jp, jc, jnp.asarray(tokens[:, t:t + 1]))
        lg, cache = tf.decode_step(cfg, tp, cache,
                                   {"tokens": _t(tokens[:, t:t + 1])})
        ours.append(lg)
        refs.append(jl)
    return torch.cat(ours, 1), jnp.concatenate(refs, 1), cache


def test_prefill_and_decode_match_reference_fp32(model):
    """Prefill past the ring (20 tokens into a 16-slot ring: the roll),
    then 4 decode steps that wrap it, against the jitted reference (1e-5);
    the caches agree too."""
    jcfg, cfg, jp, tp = model
    tokens = _tokens(2, 24, cfg.vocab_size, seed=1)
    ours, ref, cache = _prefill_decode(jcfg, cfg, jp, tp, tokens, 24, 4)
    assert ours.shape == (2, 24, cfg.vocab_size) and ours.dtype == torch.float32
    _close(ours, ref)
    assert cache["idx"].tolist() == [24, 24]


def test_prefill_and_decode_match_reference_bf16(model):
    """The same in a bf16 copy of the config (BF16_TOL)."""
    jcfg, cfg, _, _ = model
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jpb = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tpb = from_jax(jax.tree.map(np.asarray, jpb))
    tokens = _tokens(2, 24, cfg.vocab_size, seed=2)
    ours, ref, _ = _prefill_decode(jcfg, cfg, jpb, tpb, tokens, 24, 4)
    assert ours.dtype == torch.float32
    _close(ours, ref, BF16_TOL)


def test_incremental_decode_matches_full_forward(model):
    """Prefill + token-by-token decode reproduces the full forward (the
    reference's test_decode_equivalence, fp32 at 1e-5)."""
    _, cfg, _, tp = model
    B, S, TAIL = 2, 24, 4
    tokens = _t(_tokens(B, S, cfg.vocab_size, seed=3)).long()
    full, none, aux = tf.forward(cfg, tp, tokens=tokens)
    assert none is None and float(aux) == 0.0
    lg, cache = tf.prefill(cfg, tp, {"tokens": tokens[:, :S - TAIL]},
                           seq_len=S)
    outs = [lg]
    for t in range(S - TAIL, S):
        lg, cache = tf.decode_step(cfg, tp, cache,
                                   {"tokens": tokens[:, t:t + 1]})
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0, atol=TOL)


def test_decode_tick_and_prefill_kernel_calls(model):
    """A decode step calls mvm 6 times per layer and decode_attention once
    per attention layer (no scan); a prefill calls rglru_scan once per
    RG-LRU layer (no mvm, no decode_attention)."""
    _, cfg, _, tp = model
    kinds = cfg.layer_kinds()
    tokens = _t(_tokens(3, 9, cfg.vocab_size, seed=4)).long()
    reset_counts(mvm, decode_attention, rglru_scan)
    _, cache = tf.prefill(cfg, tp, {"tokens": tokens[:, :8]}, seq_len=32)
    assert (mvm.calls, decode_attention.calls, rglru_scan.calls) == (
        0, 0, kinds.count("rglru"))
    reset_counts(mvm, decode_attention, rglru_scan)
    tf.decode_step(cfg, tp, cache, {"tokens": tokens[:, 8:]})
    assert (mvm.calls, decode_attention.calls, rglru_scan.calls) == (
        6 * cfg.n_layers, kinds.count("attn"), 0)
    assert (mvm.kernel_launches, decode_attention.kernel_launches) == (0, 0)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def _serve(engine, prompts, max_new, eos=-1):
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid=uid, tokens=p, max_new_tokens=max_new,
                              eos_id=eos))
    return {c.uid: c for c in engine.run_to_completion()}


def _greedy(cfg, tp, prompt, max_new):
    """Single-request greedy loop through the port's raw prefill/decode."""
    lg, cache = tf.prefill(cfg, tp, {"tokens": _t(prompt).long()[None]},
                           seq_len=64)
    out = [int(torch.argmax(lg[0, -1]))]
    for _ in range(max_new - 1):
        lg, cache = tf.decode_step(cfg, tp, cache,
                                   {"tokens": torch.tensor([[out[-1]]])})
        out.append(int(torch.argmax(lg[0, 0])))
    return out


def _keep_sampled_logits(eng):
    """Wrap ``eng``'s sampler: every logits row it samples a token from is
    kept, by request uid, in the order of that request's tokens."""
    kept, admitting = {}, []
    sample, admit = eng._sample, eng._prefill_admitted

    def prefill_admitted(pairs):
        for slot, req in pairs:
            admitting[:] = [req.uid]
            admit([(slot, req)])
        admitting.clear()

    def sample_and_keep(logits):
        uids = admitting or [None if r is None else r.uid for r in eng.slots]
        for uid, row in zip(uids, logits):
            if uid is not None:
                kept.setdefault(uid, []).append(row.clone())
        return sample(logits)

    eng._prefill_admitted, eng._sample = prefill_admitted, sample_and_keep
    return kept


def test_engine_matches_the_reference_engine_and_greedy(model):
    """The prompts of tests/test_serving.py (5, 9, 3; max_batch 2,
    max_seq 64, 6 new tokens): the tokens equal the reference engine's
    (jitted), which tests/test_serving.py::test_engine_matches_reference
    holds equal to its unbucketed _reference_greedy on these same
    weights and prompts; the sampled logits are finite and give the
    tokens."""
    jcfg, cfg, jp, tp = model
    prompts = _prompts(cfg.vocab_size, (5, 9, 3), seed=0)
    jeng = JServingEngine(jcfg, jp, max_batch=2, max_seq=64)
    for uid, p in enumerate(prompts):
        jeng.submit(JRequest(uid=uid, tokens=p, max_new_tokens=6))
    ref = {c.uid: c.tokens for c in jeng.run_to_completion()}
    eng = ServingEngine(cfg, tp, max_batch=2, max_seq=64, device="cpu")
    sampled = _keep_sampled_logits(eng)
    done = _serve(eng, prompts, 6)
    assert sorted(done) == [0, 1, 2]
    for uid, c in done.items():
        assert c.tokens == ref[uid], (uid, c.tokens, ref[uid])
        assert c.prompt_len == len(prompts[uid])
        logits = torch.stack(sampled[uid])
        assert logits.shape == (6, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        assert logits.argmax(-1).tolist() == c.tokens
    assert eng.prefill_lengths == jeng.prefill_lengths == {2, 4, 8}


def test_engine_eos_buckets_zero_tokens_and_slot_reuse(model):
    """EOS stops a request; seven prompt lengths collapse to the prefill
    buckets {2, 4, 8} and stay exact against the raw greedy loop; a
    zero-token request completes without a slot; an idle step is a no-op;
    the tick budget raises RequestTimeout carrying the finished ones."""
    _, cfg, _, tp = model
    prompt = _prompts(cfg.vocab_size, (4,), seed=1)[0]
    ref = _greedy(cfg, tp, prompt, 8)
    done = _serve(ServingEngine(cfg, tp, max_batch=1, max_seq=64,
                                device="cpu"), [prompt], 8, eos=ref[2])
    assert done[0].tokens == ref[:3]

    lengths = [3, 5, 6, 7, 9, 11, 13]
    prompts = _prompts(cfg.vocab_size, lengths, seed=3)
    eng = ServingEngine(cfg, tp, max_batch=2, max_seq=64, device="cpu")
    done = _serve(eng, prompts, 4)
    assert eng.prefill_lengths == {2, 4, 8} and len(done) == len(lengths)
    for uid, c in done.items():
        assert c.tokens == _greedy(cfg, tp, prompts[uid], 4), uid

    eng = ServingEngine(cfg, tp, max_batch=1, max_seq=64, device="cpu")
    eng.step()  # nothing queued
    assert eng.steps == 0 and not eng.done and eng.prefill_lengths == set()
    p0, p1 = _prompts(cfg.vocab_size, (5, 5), seed=4)
    eng.submit(Request(uid=0, tokens=p0, max_new_tokens=0))
    eng.submit(Request(uid=1, tokens=p1, max_new_tokens=3))
    done = {c.uid: c for c in eng.run_to_completion()}
    assert done[0].tokens == [] and done[1].tokens == _greedy(cfg, tp, p1, 3)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(uid=2, tokens=np.zeros((0,), np.int32)))

    from repro_torch.runtime.errors import RequestTimeout
    eng = ServingEngine(cfg, tp, max_batch=1, max_seq=64, device="cpu")
    for uid, p in enumerate(_prompts(cfg.vocab_size, (3, 3), seed=5)):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=3))
    with pytest.raises(RequestTimeout) as err:
        eng.run_to_completion(max_ticks=2)
    assert [c.uid for c in err.value.done] == [0]


def test_serve_cli_on_the_cpu():
    """python -m repro_torch.launch.serve --reduced --device cpu serves its
    synthetic stream and reports it."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "3", "--max-new", "3",
         "--max-seq", "32", "--max-batch", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["requests"] == 3 and report["device"] == "cpu"
    assert report["generated_tokens"] == 9
    assert report["arch"] == "recurrentgemma-2b-reduced"


def _copy(cache):
    return {"layers": [{k: t.clone() for k, t in layer.items()}
                       for layer in cache["layers"]],
            "idx": cache["idx"].clone()}


def test_decode_graph_over_a_wrapped_ring_matches_decode_step(model):
    """The engine's step over static buffers (DecodeGraph, eager on the
    CPU) gives logits, tokens and cache bit-equal to tf.decode_step on a
    deep copy of the cache, step after step over a ring that wraps (a
    14-token prefill into the 16-slot ring, then 6 steps).  decode_step
    writes the new slot into the ring it is given and returns that ring;
    every other slot stays as it was, and the ring equals the one the
    reference's functional decode step returns (1e-5)."""
    jcfg, cfg, jp, tp = model
    P, STEPS = 14, 6
    tokens = _tokens(2, P + STEPS, cfg.vocab_size, seed=11)
    _, cache = tf.prefill(cfg, tp, {"tokens": _t(tokens[:, :P]).long()},
                          seq_len=64)
    _, jc = jax.jit(lambda p, t: jtf.prefill(jcfg, p, {"tokens": t},
                                             seq_len=64))(
        jp, jnp.asarray(tokens[:, :P]))
    jdec = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c,
                                                   {"tokens": t}))
    graph = DecodeGraph(cfg, tp, _copy(cache))
    attn = [i for i, k in enumerate(cfg.layer_kinds()) if k == "attn"]
    T = cache["layers"][attn[0]]["k"].shape[1]
    assert T == 16
    for s in range(STEPS):
        tok = _t(tokens[:, P + s:P + s + 1]).long()
        given, before = _copy(cache), _copy(cache)
        logits, new = tf.decode_step(cfg, tp, given, {"tokens": tok})
        ours = graph(tok)
        assert torch.equal(ours, logits)
        assert ours.argmax(-1).tolist() == logits.argmax(-1).tolist()
        for mine, ref in zip(graph.cache["layers"], new["layers"]):
            assert all(torch.equal(mine[k], ref[k]) for k in ref)
        assert torch.equal(graph.cache["idx"], new["idx"])
        _, jc = jdec(jp, jc, jnp.asarray(tokens[:, P + s:P + s + 1]))
        slot = (before["idx"] % T).tolist()
        for i in attn:
            for key in ("k", "v"):
                ring, old = new["layers"][i][key], before["layers"][i][key]
                assert ring is given["layers"][i][key]  # written in place
                for row, sl in enumerate(slot):
                    keep = torch.arange(T) != sl
                    assert torch.equal(ring[row, keep], old[row, keep])
                _close(ring, jc["layers"][i][key])
        cache = new
    assert [sl for sl in slot] == [(P + STEPS - 1) % T] * 2  # wrapped


def test_engine_remainder_steps_through_the_single_row_cache(model):
    """Prompts of 15 and 13 tokens (buckets 8: 7 and 5 remainder steps)
    through max_batch 2: every remainder step runs the batch-1 step on its
    static single-row cache (refilled from each prefill), every tick the
    batched one; the tokens equal the reference engine's (jitted), which
    tests/test_serving.py::test_engine_matches_reference holds equal to
    its unbucketed _reference_greedy."""
    jcfg, cfg, jp, tp = model
    prompts = _prompts(cfg.vocab_size, (15, 13), seed=12)
    jeng = JServingEngine(jcfg, jp, max_batch=2, max_seq=64)
    for uid, p in enumerate(prompts):
        jeng.submit(JRequest(uid=uid, tokens=p, max_new_tokens=5))
    jref = {c.uid: c.tokens for c in jeng.run_to_completion()}
    eng = ServingEngine(cfg, tp, max_batch=2, max_seq=64, device="cpu")
    ran, decode = [], eng._decode
    eng._decode = lambda g, t: ran.append(g) or decode(g, t)
    done = _serve(eng, prompts, 5)
    assert eng.prefill_lengths == {8}
    assert ran == [eng.single_graph] * 12 + [eng.tick_graph] * 4
    assert sorted(done) == [0, 1]
    for uid, c in done.items():
        assert c.tokens == jref[uid], (uid, c.tokens, jref[uid])


def test_decode_graph_replay_adds_the_captured_launches(model):
    """A capture counts launches that never ran, so DecodeGraph keeps
    them aside (``captured``) and each replay adds them once: the launch
    counts of a replayed step equal an eager step's.  (The capture itself
    needs a card: test_cuda_graph_replay_matches_the_eager_step.)"""
    _, cfg, _, tp = model
    graph = DecodeGraph(cfg, tp, tf.init_cache(cfg, 2, 64))
    graph.graph = type("Replayed", (), {"replay": lambda self: None})()
    graph.logits = torch.zeros(())
    graph.captured = {mvm: (18, 18), decode_attention: (1, 1)}
    reset_counts(mvm, decode_attention, rglru_scan)
    for _ in range(3):
        assert graph.replay() is graph.logits
    assert (mvm.calls, mvm.kernel_launches) == (54, 54)
    assert (decode_attention.calls, decode_attention.kernel_launches) == (3, 3)
    assert rglru_scan.calls == 0 and graph.replays == 3
    reset_counts(mvm, decode_attention)
    DecodeGraph(cfg, tp, tf.init_cache(cfg, 2, 64))(torch.zeros((2, 1)))
    assert (mvm.calls, decode_attention.calls) == (18, 1)


# ---------------------------------------------------------------------------
# on the card: the captured decode step and the unembed
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_graph_replay_matches_the_eager_step(cuda, model):
    """The engine's first tick at a batch size runs eagerly and captures
    the step; the next tick replays the graph.  The replay's logits equal
    the step run eagerly on a clone of the static cache with the same
    tokens, bit for bit (the same kernels on the same inputs), and a
    replay counts a step's launches: 6 mvm a layer, one decode_attention
    per attention layer."""
    _, cfg, _, _ = model
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=64)
    for uid, p in enumerate(_prompts(cfg.vocab_size, (5, 9), seed=0)):
        eng.submit(Request(uid=uid, tokens=p, max_new_tokens=8))
    eng.step()  # admission, then the first tick: eager, then captured
    eng.step()  # a replay
    graph = eng.tick_graph
    assert graph.graph is not None and graph.replays == 1
    assert eng.single_graph.replays == 1  # two 1-token remainders
    with torch.inference_mode():
        cache = _copy(graph.cache)
        tokens = torch.as_tensor(eng.last_token, device=cuda)
        reset_counts(mvm, decode_attention)
        replayed = graph(tokens).clone()
        n = (mvm.calls, mvm.kernel_launches, decode_attention.kernel_launches)
        eager = graph.eager(cache=cache, tokens=tokens)
        torch.cuda.synchronize()
    assert n == (6 * cfg.n_layers, 6 * cfg.n_layers,
                 cfg.layer_kinds().count("attn"))
    assert torch.equal(replayed, eager)
    assert all(torch.equal(a[k], b[k]) for a, b in
               zip(graph.cache["layers"], cache["layers"]) for k in a)


@pytest.mark.cuda
def test_cuda_unembed_without_the_fp32_table_copy(cuda):
    """On the card the unembed multiplies the bf16 operands as they are,
    into an fp32 result (aten::mm.dtype), untied and tied; it equals the
    CPU form, both operands upcast to fp32 and multiplied, up to the order
    of the fp32 sum of exact products: 1e-4 of the largest |logit|."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 256)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((256, 1000)).astype(
        np.float32) * 0.06).to(cuda, torch.bfloat16)
    from repro_torch.models.layers.embedding import unembed
    ref = torch.matmul(x.float(), w.float())
    for params in ({"unembed": w}, {"table": w.T.contiguous()}):
        ours = unembed(params, x)
        assert ours.dtype == torch.float32 and ours.shape == (2, 3, 1000)
        torch.testing.assert_close(ours, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# the registry and the options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b",
                                  "xlstm-125m"])
def test_moe_and_xlstm_archs_equal_the_reference(arch):
    """The MoE (P7) and xLSTM (P8) archs resolve, config() and reduced()
    equal to the reference's field by field (tests/test_torch_moe.py and
    tests/test_torch_xlstm.py hold the models against it)."""
    from repro.configs import get_config as jget_config
    for ours, ref in ((configs.get_config(arch), jget_config(arch)),
                      (configs.get_reduced(arch), jget_reduced(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_unported_options_raise_with_their_item(model):
    """Training (P11) runs: ``loss_fn`` gives a finite loss (the
    reference parity is tests/test_torch_train.py); the MoE FFN (P7) and the
    mLSTM/sLSTM blocks (P8) run on the hybrid's reduced widths (init,
    forward); stacked layers (P6) over the hybrid's mixed pattern raise a
    ValueError (a stacked stack takes one block kind); M-RoPE (P9) and
    the embed_stub frontend (P10) run (tests/test_torch_dense.py holds
    them against the reference); an unknown arch is a KeyError; the
    engine refuses a stub frontend and an rnn stack; the engine's default
    device needs a card."""
    _, cfg, _, tp = model
    gen = torch.Generator().manual_seed(0)
    for change in (dict(n_experts=4, experts_per_token=2),
                   dict(block_pattern=("mlstm", "slstm"))):
        opt = dataclasses.replace(cfg, **change)
        op = tf.init_params(opt, gen)
        logits, _, aux = tf.forward(opt, op, tokens=torch.zeros(
            (1, 2), dtype=torch.long))
        assert logits.shape == (1, 2, cfg.vocab_size)
        assert torch.isfinite(logits).all() and aux.shape == ()
        if "n_experts" in change:
            assert all("moe" in layer for layer in op["layers"]
                       if "norm2" in layer)
        else:
            assert [sorted(layer)[0] for layer in op["layers"]] == [
                "mlstm", "norm1", "mlstm"]
    with pytest.raises(ValueError, match="one block kind"):
        tf.init_params(dataclasses.replace(cfg, scan_layers=True), gen)
    mrope = dataclasses.replace(cfg, mrope_sections=(4, 6, 6))
    logits, _, _ = tf.forward(mrope, tp,
                              tokens=torch.zeros((1, 2), dtype=torch.long))
    assert logits.shape == (1, 2, cfg.vocab_size)
    stub = dataclasses.replace(cfg, embed_stub=True)
    sp = tf.init_params(stub, gen)
    assert list(sp["head"]) == ["unembed"]
    logits, _, _ = tf.forward(stub, sp, embeds=torch.zeros((1, 2, 64)))
    assert logits.shape == (1, 2, cfg.vocab_size)
    total, metrics = tf.loss_fn(
        cfg, tp, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert torch.isfinite(total) and float(metrics["loss"]) > 0
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("bogus")
    assert configs.list_archs() == [
        "arctic-480b", "olmoe-1b-7b", "starcoder2-3b", "deepseek-67b",
        "h2o-danube-3-4b", "stablelm-12b", "musicgen-large", "xlstm-125m",
        "qwen2-vl-72b", "recurrentgemma-2b"]
    assert configs.list_archs(include_paper=True)[-1] == "sharp-lstm"
    from repro_torch.runtime.errors import PlanRejected
    with pytest.raises(PlanRejected, match="embeds"):
        ServingEngine(dataclasses.replace(cfg, embed_stub=True), tp,
                      device="cpu")
    with pytest.raises(ValueError, match="rnn"):
        ServingEngine(configs.get_config("sharp-lstm"), {}, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("the default device's refusal needs a machine without "
                    "a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServingEngine(cfg, tp)
