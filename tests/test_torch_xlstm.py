"""The port's xLSTM blocks — models.layers.xlstm (mLSTM recurrent and
chunkwise, sLSTM), models.layers.common.chunked_scan, and xlstm-125m
through models.transformer and serving.ServingEngine — against the JAX
package on the CPU, at small widths and xlstm-125m's ``reduced()`` size
(2 layers, mLSTM then sLSTM, d_model 64, 2 heads).

Weights come from the JAX initialisers through ``convert.from_jax``;
inputs from numpy seeds (scaled by 0.5, as the reference's own xLSTM
tests scale theirs).

Tolerances (fp32 throughout): one step of either cell within 1e-6
(CELL_TOL: elementwise exp / log-sigmoid / tanh, which the two packages
implement differently, a few fp32 ulps), and chunked_scan's linear walk
too (XLA contracts c * 0.9 + x into one fma, PyTorch rounds twice); a
layer's output and state over up to 128 steps within 1e-5 (TOL: those
ulps carried through the recurrence, plus other summation orders in the
projections), a state of magnitude above 1 within 1e-5 of its largest
|value| (sLSTM's n accumulates); the chunkwise form against the
recurrent one within the reference's own tolerances for that check, 1e-5
and 2e-5 over its chunk grid; logits of the 2-layer model within 1e-5
over 24 positions, and within 1e-4 (LONG_TOL) over 260: sLSTM's
recurrent weights are drawn at 1/sqrt(H) (dense_init's fan-in is
shape[0], the head count), so R h amplifies and each package's fp32
walk drifts ~2e-5 from an fp64 walk of the same layer over 256 steps,
in other directions (the reference's own jit and eager forms give logits
2.9e-5 apart there, its chunkwise and recurrent forms 6.8e-5); the raw
sLSTM c, n, m after those 256 steps are then ~1e-4 apart relative to
their size, and are held through the logits they produce, not
elementwise.  Greedy tokens exactly.
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
from repro.models.layers import common as jcommon
from repro.models.layers import xlstm as jxlstm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax
from repro_torch.kernels.common import reset_counts
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.mvm_tile.ops import mvm
from repro_torch.models import transformer as tf
from repro_torch.models.layers import xlstm
from repro_torch.models.layers.common import chunked_scan
from repro_torch.serving import Request, ServingEngine

CELL_TOL = 1e-6
TOL = 1e-5
GRID_TOL = 2e-5
LONG_TOL = 1e-4
ARCH = "xlstm-125m"
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


def _close_state(ours, ref, tol=TOL):
    """Each state tensor within ``tol`` of max(1, its largest |value|)."""
    assert set(ours) == set(ref)
    for k in ref:
        big = float(jnp.abs(jnp.where(jnp.isinf(ref[k]), 0, ref[k])).max())
        _close(ours[k], ref[k], tol * max(1.0, big))


# the reference's layers jitted (one compile, not one per op)
_jmlstm = jax.jit(jxlstm.apply_mlstm, static_argnums=2)
_jmlstm_chunked = jax.jit(jxlstm.apply_mlstm_chunked, static_argnums=2,
                          static_argnames=("chunk",))
_jslstm = jax.jit(jxlstm.apply_slstm, static_argnums=2)
_jmcell = jax.jit(jxlstm.mlstm_cell)
_jscell = jax.jit(jxlstm.slstm_cell, static_argnums=3)


def _t(tree):
    return from_jax(jax.tree.map(np.asarray, tree))


def _mlstm(B, T, d, H, seed=0):
    """The reference's _setup: mLSTM params and x (B, T, d) * 0.5, in both
    packages."""
    jp = jxlstm.init_mlstm(jax.random.PRNGKey(seed), d, H, jnp.float32)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, T, d)).astype(np.float32) * 0.5
    return jp, _t(jp), x


def _slstm(B, T, d, H, seed=0):
    jp = jxlstm.init_slstm(jax.random.PRNGKey(seed), d, H, jnp.float32)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, T, d)).astype(np.float32) * 0.5
    return jp, _t(jp), x


# ---------------------------------------------------------------------------
# the cells and layers against the reference
# ---------------------------------------------------------------------------


def test_mlstm_cell_matches_the_reference():
    """Two steps of the mLSTM cell from the m = -inf start (the first
    step's f-scale is exactly 0), then from that state."""
    rng = np.random.default_rng(0)
    Bc, H, dh = 3, 2, 8
    jst = jxlstm.mlstm_state_init(Bc, H, dh)
    st = xlstm.mlstm_state_init(Bc, H, dh)
    assert torch.isneginf(st["m"]).all()
    for _ in range(2):
        q, k, v = (rng.standard_normal((Bc, H, dh)).astype(np.float32)
                   for _ in range(3))
        i, f = (rng.standard_normal((Bc, H)).astype(np.float32) * 2
                for _ in range(2))
        jst, jh = _jmcell(jst, *map(jnp.asarray, (q, k, v, i, f)))
        st, h = xlstm.mlstm_cell(st, *map(torch.from_numpy, (q, k, v, i, f)))
        _close(h, jh, CELL_TOL)
        _close_state(st, jst, CELL_TOL)


def test_slstm_cell_matches_the_reference():
    """Two steps of the sLSTM cell (its recurrent product R h with an fp32
    result) from the zero state."""
    Bc, d, H = 3, 16, 2
    jp, tp, _ = _slstm(Bc, 1, d, H)
    rng = np.random.default_rng(1)
    jst, st = jxlstm.slstm_state_init(Bc, d), xlstm.slstm_state_init(Bc, d)
    for _ in range(2):
        xp = rng.standard_normal((Bc, 4 * d)).astype(np.float32)
        jst = _jscell(jst, jnp.asarray(xp), jp["R"], H)
        st = xlstm.slstm_cell(st, torch.from_numpy(xp), tp["R"], H)
        _close_state(st, jst, CELL_TOL)


@pytest.mark.parametrize("T", [1, 50])
def test_apply_mlstm_matches_the_reference(T):
    """The recurrent mLSTM layer from no state, then resumed from its
    state over 4 more steps (as a decode continues a prefill)."""
    jp, tp, x = _mlstm(2, T + 4, 32, 2)
    jy, jst = _jmlstm(jp, jnp.asarray(x[:, :T]), 2)
    y, st = xlstm.apply_mlstm(tp, torch.from_numpy(x[:, :T]), 2)
    _close(y, jy)
    _close_state(st, jst)
    jy, jst = _jmlstm(jp, jnp.asarray(x[:, T:]), 2, jst)
    y, st = xlstm.apply_mlstm(tp, torch.from_numpy(x[:, T:]), 2, st)
    _close(y, jy)
    _close_state(st, jst)


@pytest.mark.parametrize("T,chunk", [(64, 16), (128, 32), (256, 128)])
def test_apply_mlstm_chunked_matches_the_reference(T, chunk):
    """The chunkwise mLSTM against the reference's chunkwise form (and
    its default chunk of 128 at T = 256, the xlstm-125m prefill's)."""
    jp, tp, x = _mlstm(2, T, 32, 2)
    jy, jst = _jmlstm_chunked(jp, jnp.asarray(x), 2, chunk=chunk)
    y, st = xlstm.apply_mlstm_chunked(tp, torch.from_numpy(x), 2,
                                      chunk=chunk)
    _close(y, jy)
    _close_state(st, jst)


@pytest.mark.parametrize("T", [1, 40])
def test_apply_slstm_matches_the_reference(T):
    """The sLSTM layer from no state, then resumed over 4 more steps."""
    jp, tp, x = _slstm(2, T + 4, 32, 4)
    jy, jst = _jslstm(jp, jnp.asarray(x[:, :T]), 4)
    y, st = xlstm.apply_slstm(tp, torch.from_numpy(x[:, :T]), 4)
    _close(y, jy)
    _close_state(st, jst)
    jy, jst = _jslstm(jp, jnp.asarray(x[:, T:]), 4, jst)
    y, st = xlstm.apply_slstm(tp, torch.from_numpy(x[:, T:]), 4, st)
    _close(y, jy)
    _close_state(st, jst)


@pytest.mark.parametrize("r_scale,grows", [("drawn", True),
                                           ("1/sqrt(dh)", False)])
def test_slstm_at_a_full_head_width_amplifies_rounding(r_scale, grows):
    """xlstm-125m's heads are 192 wide.  At that width, with R as the
    reference's init draws it (1/sqrt(H): dense_init's fan-in is the head
    axis), one fp32 ulp on an sLSTM layer's unit-RMS inputs grows along the
    sequence to the size of h itself within 64 steps, in the reference as
    in the port: the recurrence is chaotic, so two computations of the
    model that round at other points part past a horizon of some tokens
    (which is why chip_smoke.py's serve_xlstm holds xlstm-125m's logits
    end to end with R at 1/sqrt(dh), and as drawn only layer by layer).
    With R at 1/sqrt(dh) the same nudge stays at a few ulps."""
    d, H = 192, 1  # one head of xlstm-125m's width (768 / 4)
    jp = jxlstm.init_slstm(jax.random.PRNGKey(0), d, H, jnp.float32)
    if r_scale != "drawn":
        jp = dict(jp, R=jp["R"] * (H / (d // H)) ** 0.5)
    x = np.random.default_rng(1).standard_normal((1, 96, d)).astype(
        np.float32)
    nudged = x * np.float32(1 + 2.0 ** -23)
    ours = [xlstm.apply_slstm(_t(jp), torch.from_numpy(a), H)[0]
            for a in (x, nudged)]
    theirs = [_jslstm(jp, jnp.asarray(a), H)[0] for a in (x, nudged)]
    for a, b in (ours, theirs):
        moved = np.abs(np.asarray(a, np.float32)
                       - np.asarray(b, np.float32)).max(-1)[0]
        assert moved[0] < 1e-6
        if grows:
            assert moved[64:].max() > 0.5
        else:
            assert moved.max() < 1e-5


@pytest.mark.parametrize("T,chunk", [(64, 16), (50, 16), (8, 128)])
def test_chunked_scan_matches_the_reference(T, chunk):
    """chunked_scan against the reference's (its chunked and plain
    branches alike) on the reference test's linear step, carry and the
    stacked outputs within CELL_TOL of max(1, their largest |value|); the
    port's walk is the same loop
    whatever the chunk (bit for bit against chunk=1); a tuple of inputs
    and outputs too."""
    def jstep(c, x):
        c = c * 0.9 + x
        return c, c * 2.0

    def step(c, x):
        c = c * 0.9 + x
        return c, c * 2.0

    xs = np.random.default_rng(0).standard_normal((T, 8)).astype(np.float32)
    jc, jys = jcommon.chunked_scan(jstep, jnp.zeros((8,)), jnp.asarray(xs),
                                   chunk=chunk)
    c, ys = chunked_scan(step, torch.zeros((8,)), torch.from_numpy(xs),
                         chunk=chunk)
    _close_state({"c": c, "ys": ys}, {"c": jc, "ys": jys}, CELL_TOL)
    c1, ys1 = chunked_scan(step, torch.zeros((8,)), torch.from_numpy(xs),
                           chunk=1, remat=False)
    assert torch.equal(c, c1) and torch.equal(ys, ys1)
    c, (a, b) = chunked_scan(lambda c, x: (c + x[0] * x[1], (c, x[0])),
                             torch.zeros(()), (torch.arange(4.0),
                                               torch.ones(4)))
    assert float(c) == 6.0 and a.tolist() == [0.0, 0.0, 1.0, 3.0]
    assert b.tolist() == [0.0, 1.0, 2.0, 3.0]


# ---------------------------------------------------------------------------
# the reference's invariants (tests/models/test_xlstm_chunked.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B_,T,d,H,chunk", [
    (2, 64, 32, 2, 16), (1, 128, 48, 4, 32), (3, 96, 24, 2, 48),
])
def test_chunked_equals_recurrent(B_, T, d, H, chunk):
    """The chunkwise form equals the recurrent scan, output and state."""
    _, tp, x = _mlstm(B_, T, d, H)
    y_ref, st_ref = xlstm.apply_mlstm(tp, torch.from_numpy(x), H)
    y, st = xlstm.apply_mlstm_chunked(tp, torch.from_numpy(x), H,
                                      chunk=chunk)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=TOL)
    for k in ("C", "n", "m"):
        torch.testing.assert_close(st[k], st_ref[k], rtol=0, atol=TOL)


def test_state_handoff_continuation():
    """Decoding from a chunked-prefill state matches decoding from the
    recurrent prefill's."""
    _, tp, x = _mlstm(2, 64, 32, 2)
    _, st_ref = xlstm.apply_mlstm(tp, torch.from_numpy(x), 2)
    _, st = xlstm.apply_mlstm_chunked(tp, torch.from_numpy(x), 2, chunk=16)
    x2 = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 4, 32)).astype(np.float32) * 0.5)
    y_ref, _ = xlstm.apply_mlstm(tp, x2, 2, st_ref)
    y, _ = xlstm.apply_mlstm(tp, x2, 2, st)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=TOL)


@settings(max_examples=8, deadline=None)
@given(nc=st.integers(2, 6), L=st.sampled_from([8, 16, 32]),
       H=st.sampled_from([1, 2, 4]), seed=st.integers(0, 3))
def test_property_chunk_grid(nc, L, H, seed):
    """Over the reference's grid of chunk counts, chunk lengths and head
    counts, chunked == recurrent within 2e-5."""
    T = nc * L
    _, tp, x = _mlstm(1, T, 8 * H, H, seed)
    y_ref, _ = xlstm.apply_mlstm(tp, torch.from_numpy(x), H)
    y, _ = xlstm.apply_mlstm_chunked(tp, torch.from_numpy(x), H, chunk=L)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=GRID_TOL)


@pytest.mark.parametrize("T,chunk", [(50, 128), (128, 128), (96, 64)])
def test_fallback_on_indivisible_T(T, chunk):
    """T % chunk != 0 or T <= chunk falls back to the recurrent scan: the
    same tensors as apply_mlstm, bit for bit."""
    _, tp, x = _mlstm(1, T, 16, 2)
    y, st = xlstm.apply_mlstm_chunked(tp, torch.from_numpy(x), 2,
                                      chunk=chunk)
    y_ref, st_ref = xlstm.apply_mlstm(tp, torch.from_numpy(x), 2)
    assert torch.equal(y, y_ref)
    assert all(torch.equal(st[k], st_ref[k]) for k in st)


# ---------------------------------------------------------------------------
# xlstm-125m
# ---------------------------------------------------------------------------


_MODEL = {}


def _model(dtype="float32"):
    if dtype not in _MODEL:
        jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=dtype)
        cfg = dataclasses.replace(configs.get_reduced(ARCH), dtype=dtype)
        jp = jax.jit(jtf.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        _MODEL[dtype] = (jcfg, cfg, jp, _t(jp))
    return _MODEL[dtype]


def _tokens(cfg, seed, n=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def test_layout_and_caches_equal_the_reference():
    """The reference's unrolled tree (a list of {norm1, mlstm} and
    {norm1, slstm} layers; no MLP, d_ff = 0) crosses convert.from_jax
    one to one; the port's own init_params and init_cache have the
    reference's keys, shapes and dtypes (mLSTM {C, n, m} with dh = 2 d /
    H, m at -inf; sLSTM {h, c, n, m})."""
    jcfg, cfg, jp, tp = _model()
    assert [sorted(layer) for layer in tp["layers"]] == [
        ["mlstm", "norm1"], ["norm1", "slstm"]]
    shapes = (lambda tree: jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
        tree))
    ours = tf.init_params(cfg, torch.Generator().manual_seed(0))
    assert shapes(ours) == shapes(jp)
    cache, jcache = tf.init_cache(cfg, 3, 32), jtf.init_cache(jcfg, 3, 32)
    assert shapes(cache) == shapes(jcache)
    assert torch.isneginf(cache["layers"][0]["m"]).all()
    assert cache["layers"][0]["C"].shape == (3, 2, 64, 64)


def test_forward_matches_the_reference():
    """The full-sequence forward (train mode: the chunkwise mLSTM's
    recurrent fallback at T = 24) against the reference, 1e-5; the aux
    loss is 0 (no MoE)."""
    jcfg, cfg, jp, tp = _model()
    tok = _tokens(cfg, seed=1)
    jl, _, _ = jax.jit(lambda p, t: jtf.forward(jcfg, p, tokens=t))(
        jp, jnp.asarray(tok))
    logits, _, aux = tf.forward(cfg, tp, tokens=torch.from_numpy(tok).long())
    _close(logits, jl)
    assert float(aux) == 0.0


@pytest.mark.parametrize("n", [20, 256])
def test_prefill_and_decode_match_the_reference(n):
    """A prefill of n positions (256: the chunkwise mLSTM, two chunks of
    128) then 4 decode steps against the jitted reference: logits within
    1e-5 at n = 20, LONG_TOL at 256; the final states within TOL, but
    sLSTM's after 260 steps (see the module doc)."""
    jcfg, cfg, jp, tp = _model()
    tok = _tokens(cfg, seed=5, n=n + 4)
    jpre = jax.jit(lambda p, b: jtf.prefill(jcfg, p, b, seq_len=n + 4))
    jdec = jax.jit(lambda p, c, b: jtf.decode_step(jcfg, p, c, b))
    jl, jc = jpre(jp, {"tokens": jnp.asarray(tok[:, :n])})
    lg, cache = tf.prefill(cfg, tp, {"tokens": torch.from_numpy(
        tok[:, :n]).long()}, seq_len=n + 4)
    ours, refs = [lg], [jl]
    for t in range(n, n + 4):
        jl, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok[:, t:t + 1])})
        lg, cache = tf.decode_step(cfg, tp, cache, {
            "tokens": torch.from_numpy(tok[:, t:t + 1]).long()})
        ours.append(lg)
        refs.append(jl)
    _close(torch.cat(ours, 1), jnp.concatenate(refs, 1),
           TOL if n < 128 else LONG_TOL)
    _close_state(cache["layers"][0], jc["layers"][0])
    if n < 128:
        _close_state(cache["layers"][1], jc["layers"][1])
    assert cache["idx"].tolist() == [n + 4] * B


def test_bf16_prefill_and_decode_track_fp32():
    """The bf16 model (20 positions, 4 decode steps) against the same
    model in fp32 on the bf16-rounded weights, within 0.1 (as
    tests/test_torch_dense.py's BF16_TOL: bf16 keeps 8 significant bits
    of the hidden state a layer).  The reference has no bf16 xLSTM on the
    CPU to compare with: XLA's CPU runtime refuses sLSTM's bf16 x bf16 ->
    f32 recurrent dot, jitted or not."""
    _, cfg, _, _ = _model()
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    tp = tf.init_params(bf, torch.Generator().manual_seed(0))
    tp32 = tf.map_layers(lambda t: t.float(), tp["layers"])
    p32 = {"final_norm": tp["final_norm"].float(),
           "head": {k: t.float() for k, t in tp["head"].items()},
           "layers": tp32}
    tok = torch.from_numpy(_tokens(cfg, seed=6)).long()
    runs = []
    for c, p in ((bf, tp), (cfg, p32)):
        lg, cache = tf.prefill(c, p, {"tokens": tok[:, :20]}, seq_len=S)
        outs = [lg]
        for t in range(20, S):
            lg, cache = tf.decode_step(c, p, cache,
                                       {"tokens": tok[:, t:t + 1]})
            outs.append(lg)
        runs.append(torch.cat(outs, 1))
    assert runs[0].dtype == torch.float32
    assert float(runs[1].abs().max()) > 1.0
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0.1)


def test_decode_step_calls_mvm_eight_times():
    """A decode step at 2 layers calls mvm 8 times (mLSTM's w_up_v,
    w_up_g, w_q, w_k, w_v, w_down; sLSTM's W, w_out) and no
    decode_attention; a prefill calls neither."""
    _, cfg, _, tp = _model()
    tok = torch.from_numpy(_tokens(cfg, seed=8, n=9)).long()
    reset_counts(mvm, decode_attention)
    _, cache = tf.prefill(cfg, tp, {"tokens": tok[:, :8]}, seq_len=32)
    assert (mvm.calls, decode_attention.calls) == (0, 0)
    tf.decode_step(cfg, tp, cache, {"tokens": tok[:, 8:9]})
    assert (mvm.calls, decode_attention.calls) == (8, 0)


def test_engine_matches_the_reference_engine():
    """ServingEngine(device="cpu") gives the reference engine's greedy
    tokens: prompts of 5, 9, 3 and 21 tokens (buckets 2-16, remainder
    steps through the batch-1 step), max_batch 2, 6 new tokens."""
    jcfg, cfg, jp, tp = _model()
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
def test_cuda_xlstm_graph_replay_matches_the_eager_step(cuda):
    """The xLSTM decode step (bf16, reduced width) captured by the
    engine's first tick and replayed: the replay's logits and states
    equal the step run eagerly on a clone of the static cache, bit for
    bit, and a replay counts 8 mvm launches."""
    cfg = dataclasses.replace(configs.get_reduced(ARCH), dtype="bfloat16")
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
        cache = {"layers": [{k: t.clone() for k, t in layer.items()}
                            for layer in graph.cache["layers"]],
                 "idx": graph.cache["idx"].clone()}
        tokens = torch.as_tensor(eng.last_token, device=cuda)
        reset_counts(mvm, decode_attention)
        replayed = graph(tokens).clone()
        n = (mvm.kernel_launches, decode_attention.kernel_launches)
        eager = graph.eager(cache=cache, tokens=tokens)
        torch.cuda.synchronize()
    assert n == (8, 0)
    assert torch.equal(replayed, eager)
    for a, b in zip(graph.cache["layers"], cache["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
