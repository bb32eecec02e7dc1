"""The port's dense decoders — stacked layer params (``scan_layers=True``),
M-RoPE and the ``embed_stub`` frontends in models.transformer, their
configs, and serving.ServingEngine over stacked caches — against the JAX
package on the CPU, for the reference's six dense archs at their
``reduced()`` size: starcoder2-3b, deepseek-67b, h2o-danube-3-4b (window
16), stablelm-12b, musicgen-large (embeds) and qwen2-vl-72b (embeds,
M-RoPE).

Weights come from the JAX package's ``init_params`` through
``convert.from_jax``; tokens, embeddings and positions from numpy seeds.
On the CPU the decode step runs the plain versions of the ``mvm`` and
``decode_attention`` kernels; their call counters show the path.

Tolerances: fp32 logits within 1e-5 absolute (TOL; the two packages sum
products in other orders and use other exp/sin/cos implementations: a
few fp32 ulps of logits of magnitude ~1); bf16 logits within 0.1 absolute
(BF16_TOL, as tests/test_torch_lm_serving.py: the two packages round the
hidden state to bf16 at other points, a few bf16 ulps (2^-8 relative) a
layer); incremental decode against the full forward within 2e-3, the
reference's own tolerance for that check
(tests/models/test_decode_equivalence.py).  Greedy tokens are compared
exactly in fp32.
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

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import list_archs as jlist_archs
from repro.models import transformer as jtf
from repro.models.layers import rope as jrope
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from tests.conftest import SRC

from repro_torch import configs
from repro_torch.convert import from_jax
from repro_torch.kernels.common import reset_counts
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.mvm_tile.ops import mvm
from repro_torch.models import transformer as tf
from repro_torch.models.layers import rope
from repro_torch.runtime.errors import PlanRejected
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import DecodeGraph

TOL = 1e-5
BF16_TOL = 0.1
INC_TOL = 2e-3
DENSE = ("starcoder2-3b", "deepseek-67b", "h2o-danube-3-4b", "stablelm-12b",
         "musicgen-large", "qwen2-vl-72b")
STUB_ARCHS = tuple(a for a in DENSE if jget_reduced(a).embed_stub)
#: the prefill + decode checks: a prefill of S - TAIL positions (20, past
#: h2o-danube's 16-slot ring: the roll), then TAIL decode steps
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


def _model(arch, dtype="float32"):
    """The reduced config of ``arch`` in both packages (in ``dtype``) and
    one weight set from the JAX initialiser, cached for the module."""
    if (arch, dtype) not in _MODELS:
        jcfg = dataclasses.replace(jget_reduced(arch), dtype=dtype)
        cfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype)
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        _MODELS[arch, dtype] = (jcfg, cfg, jp,
                                from_jax(jax.tree.map(np.asarray, jp)))
    return _MODELS[arch, dtype]


def _inputs(cfg, seed, n=S):
    """{"tokens"} or, for a stub frontend, {"embeds"} of (B, n), numpy."""
    rng = np.random.default_rng(seed)
    if cfg.embed_stub:
        return {"embeds": rng.standard_normal((B, n, cfg.d_model)).astype(
            np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(
        np.int32)}


def _positions3(n, seed):
    """Three distinct (t, h, w) position streams (3, B, n): a time axis
    and a patch grid's rows and columns, as a VLM's image tokens take."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, 4 * n, (B, n)), axis=-1)
    return np.stack([t, t + rng.integers(0, 5, (B, n)),
                     t + rng.integers(0, 7, (B, n))]).astype(np.int32)


def _sl(batch, lo, hi):
    """Positions lo..hi of every input (the position axis last but one
    for embeds, last for tokens and positions)."""
    out = {}
    for k, v in batch.items():
        out[k] = v[..., lo:hi, :] if k == "embeds" else v[..., lo:hi]
    return out


def _torch(batch):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = t.long() if k == "tokens" else t
    return out


# ---------------------------------------------------------------------------
# configs and layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", DENSE + ("olmoe-1b-7b", "arctic-480b",
                                          "xlstm-125m"))
def test_config_equals_the_reference(arch, which):
    """The port's config() and reduced() equal the reference's field by
    field."""
    ours = (configs.get_config if which == "config"
            else configs.get_reduced)(arch)
    ref = (jget_config if which == "config" else jget_reduced)(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.num_params() == ref.num_params()


def test_registry_lists_the_reference_order_less_what_is_queued():
    """list_archs() is the reference's list in its order, every arch of
    it (nothing is queued since the MoE FFN, P7, and the mLSTM/sLSTM
    blocks, P8), and each resolves to a config of its own name."""
    assert configs.list_archs() == jlist_archs()
    assert configs.list_archs(include_paper=True) == jlist_archs(
        include_paper=True)
    for arch in jlist_archs(include_paper=True):
        assert configs.get_reduced(arch).name.startswith(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_stacked_layout_equals_the_reference(arch):
    """The reference's stacked tree (one dict of (L, ...) leaves; a stub
    frontend's head {"unembed"} alone) crosses convert.from_jax one to
    one, every leaf exact; the port's own init_params (bf16, drawn from a
    torch.Generator) has the reference's keys, shapes and dtypes."""
    jcfg, cfg, jp, tp = _model(arch)
    assert isinstance(tp["layers"], dict)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tp["layers"]["attn"]["w_q"].shape[0] == cfg.n_layers
    assert list(tp["head"]) == (["unembed"] if cfg.embed_stub
                                else ["table", "unembed"])
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    ours = tf.init_params(bf, torch.Generator().manual_seed(0))
    ref = jtf.init_params(dataclasses.replace(jcfg, dtype="bfloat16"),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref) == \
        jax.tree.map(lambda t: (tuple(t.shape),
                                str(t.dtype).removeprefix("torch.")), ours)


def test_stacked_init_draws_each_layer_into_its_slice():
    """init_params fills the stacked leaves layer by layer: layer l of a
    stacked init equals layer l of the same config unrolled from the same
    seed (the same draws in the same order)."""
    cfg = configs.get_reduced("deepseek-67b")
    stacked = tf.init_params(cfg, torch.Generator().manual_seed(3))
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
    assert torch.equal(stacked["head"]["table"], unrolled["head"]["table"])


@pytest.mark.parametrize("arch", DENSE)
def test_cache_layout_equals_the_reference(arch):
    """init_cache: (L, B, T, KV) rings, a window-sized ring for the SWA
    arch (the reference's test_ring_cache_bounds_memory) and the full
    length otherwise (test_full_attention_cache_is_full_length); the
    same shapes and dtypes as the reference's."""
    jcfg, cfg, _, _ = _model(arch)
    for seq in (64, 1024):
        ours = tf.init_cache(cfg, 3, seq)
        ref = jtf.init_cache(jcfg, 3, seq)
        assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref) == \
            jax.tree.map(lambda t: (tuple(t.shape),
                                    str(t.dtype).removeprefix("torch.")),
                         ours)
        T = cfg.window if cfg.window and cfg.window < seq else seq
        assert ours["layers"]["k"].shape == (cfg.n_layers, 3, T, cfg.kv_dim)
    if arch == "h2o-danube-3-4b":
        assert tf.init_cache(cfg, 1, 1024)["layers"]["k"].shape[2] == 16
    if arch == "deepseek-67b":
        assert tf.init_cache(cfg, 1, 64)["layers"]["k"].shape[2] == 64


def test_stacked_mixed_pattern_refused():
    """Stacked layers take one block kind (the reference's scan applies
    the first kind to every layer): a mixed pattern raises."""
    cfg = dataclasses.replace(configs.get_reduced("recurrentgemma-2b"),
                              scan_layers=True)
    with pytest.raises(ValueError, match="one block kind"):
        tf.init_params(cfg, torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,head_dim", [((2, 3, 3), 16),
                                               ((16, 24, 24), 128)])
def test_mrope_angles_match_the_reference(sections, head_dim):
    """mrope_angles against the reference's at distinct (t, h, w) streams
    (1e-5: fp32 sin/cos of angles up to ~100 rad); three equal streams
    give rope_angles' numbers exactly; sections that do not sum to
    head_dim // 2 raise."""
    pos = _positions3(9, seed=1)
    cos, sin = rope.mrope_angles(torch.from_numpy(pos), head_dim, 1e4,
                                 sections)
    jcos, jsin = jrope.mrope_angles(jnp.asarray(pos), head_dim, 1e4,
                                    sections)
    assert cos.shape == (B, 9, head_dim // 2) and cos.dtype == torch.float32
    _close(cos, jcos)
    _close(sin, jsin)
    same = torch.from_numpy(np.broadcast_to(pos[0], (3,) + pos[0].shape)
                            .copy())
    c3, s3 = rope.mrope_angles(same, head_dim, 1e4, sections)
    c1, s1 = rope.rope_angles(torch.from_numpy(pos[0]), head_dim, 1e4)
    assert torch.equal(c3, c1) and torch.equal(s3, s1)
    with pytest.raises(ValueError, match="sum"):
        rope.mrope_angles(same, head_dim, 1e4, (1, 1, 1))


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


def _forward_pair(jcfg, cfg, jp, tp, batch):
    jl, _, _ = jax.jit(lambda p, b: jtf.forward(jcfg, p, mode="train",
                                                **b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    ours, none, aux = tf.forward(cfg, tp, mode="train", **_torch(batch))
    assert none is None and float(aux) == 0.0
    return ours, jl


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_the_reference(arch):
    """The full-sequence forward (train mode) against the jitted
    reference, fp32 at 1e-5; qwen2-vl with three distinct position
    streams."""
    jcfg, cfg, jp, tp = _model(arch)
    batch = _inputs(cfg, seed=1)
    if cfg.mrope_sections:
        batch["positions"] = _positions3(S, seed=2)
    ours, ref = _forward_pair(jcfg, cfg, jp, tp, batch)
    assert ours.shape == (B, S, cfg.vocab_size) and ours.dtype == torch.float32
    _close(ours, ref)


def test_grouped_remat_forward_equals_the_plain_walk():
    """deepseek-67b's reduced 3 layers with remat_group=3: the
    reference's grouped branch (3 layers a checkpoint unit) against the
    port's plain walk over the stacked layers (which ignores the
    group), fp32 at 1e-5."""
    jcfg, cfg, jp, tp = _model("deepseek-67b")
    jcfg = dataclasses.replace(jcfg, remat_group=3, remat_policy="full")
    cfg = dataclasses.replace(cfg, remat_group=3, remat_policy="full")
    ours, ref = _forward_pair(jcfg, cfg, jp, tp, _inputs(cfg, seed=4))
    _close(ours, ref)


def _prefill_decode(jcfg, cfg, jp, tp, batch):
    """Logits of a prefill of S - TAIL positions and TAIL decode steps,
    from both packages (the reference jitted, as its engine runs it), and
    both final caches.  ``positions`` (qwen2-vl's three streams) drive
    the prefill only; decode takes each row's cursor, as in the
    reference."""
    pre = _sl(batch, 0, S - TAIL)
    jpre = jax.jit(lambda p, b: jtf.prefill(jcfg, p, b, seq_len=S))
    jdec = jax.jit(lambda p, c, b: jtf.decode_step(jcfg, p, c, b))
    jl, jc = jpre(jp, {k: jnp.asarray(v) for k, v in pre.items()})
    lg, cache = tf.prefill(cfg, tp, _torch(pre), seq_len=S)
    ours, refs = [lg], [jl]
    step = {k: v for k, v in batch.items() if k != "positions"}
    for t in range(S - TAIL, S):
        one = _sl(step, t, t + 1)
        jl, jc = jdec(jp, jc, {k: jnp.asarray(v) for k, v in one.items()})
        lg, cache = tf.decode_step(cfg, tp, cache, _torch(one))
        ours.append(lg)
        refs.append(jl)
    return torch.cat(ours, 1), jnp.concatenate(refs, 1), cache, jc


def _batch(cfg, seed):
    batch = _inputs(cfg, seed)
    if cfg.mrope_sections:
        batch["positions"] = _positions3(S, seed=seed + 100)
    return batch


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference_fp32(arch):
    """Prefill (h2o-danube's 20 positions past its 16-slot ring: the
    roll) then 4 decode steps against the jitted reference, 1e-5; the
    stacked caches agree too; the embeds frontends take embeddings, and
    qwen2-vl's prefill three distinct position streams."""
    jcfg, cfg, jp, tp = _model(arch)
    ours, ref, cache, jc = _prefill_decode(jcfg, cfg, jp, tp,
                                           _batch(cfg, seed=5))
    assert ours.shape == (B, S, cfg.vocab_size)
    _close(ours, ref)
    for key in ("k", "v"):
        assert cache["layers"][key].shape == jc["layers"][key].shape
        _close(cache["layers"][key], jc["layers"][key])
    assert cache["idx"].tolist() == [S, S]


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference_bf16(arch):
    """The same in a bf16 copy of the config (BF16_TOL)."""
    jcfg, cfg, jp, tp = _model(arch, "bfloat16")
    ours, ref, cache, _ = _prefill_decode(jcfg, cfg, jp, tp,
                                          _batch(cfg, seed=6))
    assert ours.dtype == torch.float32
    assert cache["layers"]["k"].dtype == torch.bfloat16
    _close(ours, ref, BF16_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_incremental_decode_matches_the_full_forward(arch):
    """Prefill + token-by-token decode reproduces the full forward (the
    reference's test_incremental_decode_matches_full, atol 2e-3)."""
    _, cfg, _, tp = _model(arch)
    batch = _torch(_inputs(cfg, seed=7))
    full, _, _ = tf.forward(cfg, tp, **batch)
    lg, cache = tf.prefill(cfg, tp, _sl(batch, 0, S - TAIL), seq_len=S)
    outs = [lg]
    for t in range(S - TAIL, S):
        lg, cache = tf.decode_step(cfg, tp, cache, _sl(batch, t, t + 1))
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0, atol=INC_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_calls_mvm_and_decode_attention(arch):
    """A decode step over a stacked cache calls mvm 6 times a layer and
    decode_attention once a layer; a prefill calls neither."""
    _, cfg, _, tp = _model(arch)
    batch = _torch(_inputs(cfg, seed=8, n=9))
    reset_counts(mvm, decode_attention)
    _, cache = tf.prefill(cfg, tp, _sl(batch, 0, 8), seq_len=32)
    assert (mvm.calls, decode_attention.calls) == (0, 0)
    tf.decode_step(cfg, tp, cache, _sl(batch, 8, 9))
    assert (mvm.calls, decode_attention.calls) == (6 * cfg.n_layers,
                                                   cfg.n_layers)
    assert (mvm.kernel_launches, decode_attention.kernel_launches) == (0, 0)


def test_decode_writes_the_stacked_rings_in_place():
    """A decode step over a stacked cache returns the very (L, B, T, KV)
    ring tensors it was given, each layer's new slot written through its
    view: every layer's ring stays a view of the one stacked tensor (same
    storage, no copy), every other slot keeps its value, and the rings
    equal the reference's functional step (1e-5) — over h2o-danube's
    16-slot ring as it wraps."""
    jcfg, cfg, jp, tp = _model("h2o-danube-3-4b")
    batch = _inputs(cfg, seed=9, n=22)
    pre = _sl(batch, 0, 14)
    _, cache = tf.prefill(cfg, tp, _torch(pre), seq_len=64)
    _, jc = jax.jit(lambda p, b: jtf.prefill(jcfg, p, b, seq_len=64))(
        jp, {k: jnp.asarray(v) for k, v in pre.items()})
    jdec = jax.jit(lambda p, c, b: jtf.decode_step(jcfg, p, c, b))
    rings = {key: cache["layers"][key] for key in ("k", "v")}
    ptrs = {key: t.untyped_storage().data_ptr() for key, t in rings.items()}
    T = rings["k"].shape[2]
    for t in range(14, 22):
        before = {key: r.clone() for key, r in rings.items()}
        slot = (cache["idx"] % T).tolist()
        one = _sl(batch, t, t + 1)
        _, new = tf.decode_step(cfg, tp, cache, _torch(one))
        _, jc = jdec(jp, jc, {k: jnp.asarray(v) for k, v in one.items()})
        for key, ring in rings.items():
            assert new["layers"][key] is ring
            assert ring.untyped_storage().data_ptr() == ptrs[key]
            for i in range(cfg.n_layers):
                view = tf.layer_view(new["layers"], i)[key]
                assert view.untyped_storage().data_ptr() == ptrs[key]
                assert view.data_ptr() == ring[i].data_ptr()
            for row, sl in enumerate(slot):
                keep = torch.arange(T) != sl
                assert torch.equal(ring[:, row, keep],
                                   before[key][:, row, keep])
            _close(ring, jc["layers"][key])
        cache = new
    assert slot == [(21) % T] * B  # wrapped


@pytest.mark.parametrize("n", [12, 20])
def test_prefill_writes_the_stacked_rings_in_place(n):
    """A prefill over a stacked cache writes each layer's keys and values
    into its slice of the given (L, B, T, KV) rings (padded below the
    16-slot ring, rolled past it) and returns those very tensors, with
    the reference's values (1e-5), whatever the rings held before."""
    jcfg, cfg, jp, tp = _model("h2o-danube-3-4b")
    pre = _sl(_inputs(cfg, seed=10, n=n), 0, n)
    cache = tf.init_cache(cfg, B, 64)
    rings = {key: cache["layers"][key] for key in ("k", "v")}
    for ring in rings.values():
        ring.fill_(7.0)
    _, new, _ = tf.forward(cfg, tp, tokens=torch.from_numpy(pre["tokens"]),
                           cache=cache, mode="prefill")
    _, jc = jax.jit(lambda p, b: jtf.prefill(jcfg, p, b, seq_len=64))(
        jp, {k: jnp.asarray(v) for k, v in pre.items()})
    for key, ring in rings.items():
        assert new["layers"][key] is ring
        _close(ring, jc["layers"][key])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _serve(engine, prompts, max_new):
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid=uid, tokens=p, max_new_tokens=max_new))
    return {c.uid: c.tokens for c in engine.run_to_completion()}


@pytest.mark.parametrize("arch", ["starcoder2-3b", "h2o-danube-3-4b"])
def test_engine_matches_the_reference_engine(arch):
    """ServingEngine(device="cpu") over stacked caches gives the reference
    engine's greedy tokens (jitted; tests/test_serving.py holds it equal
    to its unbucketed greedy loop on starcoder2): the prompts of
    tests/test_serving.py (5, 9, 3) and one of 21 tokens (a 16 bucket
    and 5 remainder steps, which wrap h2o-danube's 16-slot ring),
    max_batch 2, max_seq 64, 6 new tokens."""
    jcfg, cfg, jp, tp = _model(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 3, 21)]
    jeng = JServingEngine(jcfg, jp, max_batch=2, max_seq=64)
    for uid, p in enumerate(prompts):
        jeng.submit(JRequest(uid=uid, tokens=p, max_new_tokens=6))
    ref = {c.uid: c.tokens for c in jeng.run_to_completion()}
    eng = ServingEngine(cfg, tp, max_batch=2, max_seq=64, device="cpu")
    assert eng.cache["layers"]["k"].shape[:2] == (cfg.n_layers, 2)
    assert _serve(eng, prompts, 6) == ref
    assert eng.prefill_lengths == jeng.prefill_lengths == {2, 4, 8, 16}


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_engine_refuses_a_stub_frontend(arch):
    """The token engine refuses an embed_stub arch with PlanRejected, as
    the reference's does; such archs serve through prefill / decode_step
    with embeds (the tests above)."""
    _, cfg, _, tp = _model(arch)
    with pytest.raises(PlanRejected, match="embeds"):
        ServingEngine(cfg, tp, device="cpu")


def _copy(cache):
    return {"layers": {k: t.clone() for k, t in cache["layers"].items()},
            "idx": cache["idx"].clone()}


@pytest.mark.parametrize("arch", ["starcoder2-3b", "h2o-danube-3-4b"])
def test_decode_graph_over_stacked_caches_matches_decode_step(arch):
    """The engine's step over static buffers (DecodeGraph, eager on the
    CPU) over a stacked cache: logits and caches bit-equal to
    tf.decode_step on a copy, step after step (h2o-danube's ring wraps);
    the graph's ring tensors are the ones it was built with (written in
    place, never replaced), so a replay on the card sees every write."""
    _, cfg, _, tp = _model(arch)
    batch = _torch(_inputs(cfg, seed=10, n=20))
    _, cache = tf.prefill(cfg, tp, _sl(batch, 0, 14), seq_len=64)
    graph = DecodeGraph(cfg, tp, _copy(cache))
    rings = dict(graph.cache["layers"])
    for t in range(14, 20):
        tok = batch["tokens"][:, t:t + 1]
        logits, new = tf.decode_step(cfg, tp, _copy(cache), {"tokens": tok})
        assert torch.equal(graph(tok), logits)
        for key, ring in graph.cache["layers"].items():
            assert ring is rings[key]
            assert torch.equal(ring, new["layers"][key])
        assert torch.equal(graph.cache["idx"], new["idx"])
        cache = new


def test_serve_cli_takes_a_stacked_arch():
    """python -m repro_torch.launch.serve --arch starcoder2-3b --reduced
    --device cpu serves its synthetic stream and reports it."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "starcoder2-3b", "--reduced", "--device", "cpu", "--requests", "3",
         "--max-new", "3", "--max-seq", "32", "--max-batch", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["arch"] == "starcoder2-3b-reduced"
    assert report["requests"] == 3 and report["generated_tokens"] == 9


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
@pytest.mark.parametrize("arch", ["starcoder2-3b", "h2o-danube-3-4b"])
def test_cuda_stacked_graph_replay_matches_the_eager_step(cuda, arch):
    """A stacked decode step (bf16, reduced width) captured by the engine's
    first tick and replayed at the next: the replay's logits and rings
    equal the step run eagerly on a clone of the static cache with the
    same tokens, bit for bit (TOL_REPLAY 0), and a replay counts 6 mvm
    and one decode_attention launch a layer."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="bfloat16")
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=64)
    rng = np.random.default_rng(0)
    for uid, n in enumerate((5, 19)):
        eng.submit(Request(uid=uid, tokens=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=8))
    eng.step()  # admission, then the first tick: eager, then captured
    eng.step()  # a replay
    graph = eng.tick_graph
    assert graph.graph is not None and graph.replays == 1
    with torch.inference_mode():
        cache = _copy(graph.cache)
        tokens = torch.as_tensor(eng.last_token, device=cuda)
        reset_counts(mvm, decode_attention)
        replayed = graph(tokens).clone()
        n = (mvm.kernel_launches, decode_attention.kernel_launches)
        eager = graph.eager(cache=cache, tokens=tokens)
        torch.cuda.synchronize()
    assert n == (6 * cfg.n_layers, cfg.n_layers)
    assert torch.equal(replayed, eager)
    for key in ("k", "v"):
        assert torch.equal(graph.cache["layers"][key], cache["layers"][key])
