"""The Mamba-2 / attention hybrid (granite-4.0-h) on the CPU, against the
plain reference (``repro_torch.models.plain_hybrid``, torch only, the
per-step recurrence), at the reduced size with seeded random weights: the
chunked prefill, prefill then decode through the cache, the serving
engine teacher forced, the state update's plain twin, the cache's
Mamba-2 leaves written in place, and the other decoders untouched by the
new fields' defaults.  The ``cuda``-marked tests at the end hold the
``ssm_update`` kernel against its plain twin on the card.

Tolerances.  Everything here is fp32 (the reduced config's dtype), so the
program and the reference differ only in the order of their sums: the
chunked form sums a chunk's contributions as products of cumulative
decays where the reference multiplies step by step, and the matmuls and
einsums reduce in other orders.  Each is a few fp32 ulps an operation,
compounded over ten layers: relative 1e-5 of the largest output for one
block, 1e-4 of the largest logit for the whole model.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import granite_4_0_h_micro
from repro_torch.kernels import ssm_update, ssm_update_plain
from repro_torch.models import plain_hybrid
from repro_torch.models import transformer as tf
from repro_torch.models.layers import mamba2
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import DecodeGraph, decode_into

CFG = granite_4_0_h_micro.reduced()
#: one block, fp32 sums in another order (module doc)
TOL_BLOCK = 1e-5
#: the whole model's logits (module doc)
TOL_MODEL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _params(cfg=CFG, seed=0):
    """Seeded random weights, the norms' scales drawn too (so that the
    1 + s convention is exercised) and D off 1."""
    p = tf.init_params(cfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for layer in p["layers"]:
        for key in ("norm1", "norm2"):
            layer[key].copy_(0.1 * torch.randn(layer[key].shape,
                                               generator=gen))
        if "mamba" in layer:
            m = layer["mamba"]
            m["norm"].copy_(0.1 * torch.randn(m["norm"].shape,
                                              generator=gen))
            m["D"].copy_(torch.randn(m["D"].shape, generator=gen))
    return p


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def params():
    return _params()


def _tokens(B, S, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(B, S)))


# ---------------------------------------------------------------------------
# the chunked prefill against the per-step recurrence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [1, 5, 8, 13, 24])
def test_chunked_prefill_matches_the_per_step_recurrence(params, L):
    """A Mamba-2 block's full-sequence form (the SSD chunks of 8, at
    lengths that are and are not multiples of the chunk) against the
    reference's step-by-step recurrence; its final state against the
    state the per-step updates leave."""
    p = params["layers"][0]["mamba"]
    x = torch.randn((2, L, CFG.d_model), generator=torch.Generator()
                    .manual_seed(L))
    out, _ = mamba2.apply_mamba2(CFG, p, x, None, "train")
    ref = plain_hybrid.mamba2(CFG, p, x)
    assert _rel(out, ref) <= TOL_BLOCK
    cache = mamba2.init_cache(CFG, 2)
    mamba2.apply_mamba2(CFG, p, x, cache, "prefill")
    steps = mamba2.init_cache(CFG, 2)
    for t in range(L):
        mamba2.apply_mamba2(CFG, p, x[:, t:t + 1], steps, "decode")
    assert _rel(cache["ssm"], steps["ssm"]) <= TOL_BLOCK
    assert torch.equal(cache["conv"], steps["conv"])


def test_segsum_is_the_sum_over_each_segment():
    x = torch.arange(1.0, 6.0)
    s = mamba2.segsum(x)
    for i in range(5):
        for j in range(5):
            want = x[j + 1:i + 1].sum() if j <= i else float("-inf")
            assert s[i, j] == want


# ---------------------------------------------------------------------------
# the whole model: prefill then decode, and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,k", [(13, 8), (16, 5), (3, 4)])
def test_prefill_then_decode_matches_the_reference_forward(params, S, k):
    """A prefill of S tokens and k decode steps through its cache give the
    logits of the reference's full forward over the S + k tokens."""
    toks = _tokens(2, S + k)
    ref = plain_hybrid.forward(CFG, params, toks)
    logits, cache = tf.prefill(CFG, params, {"tokens": toks[:, :S]},
                               seq_len=S + k)
    assert _rel(logits, ref[:, :S]) <= TOL_MODEL
    for t in range(S, S + k):
        step, cache = tf.decode_step(CFG, params, cache,
                                     {"tokens": toks[:, t:t + 1]})
        assert _rel(step[:, 0], ref[:, t]) <= TOL_MODEL


def _keep_logits(eng):
    """Every logits row the engine samples a token from, by uid, in the
    order of that request's tokens."""
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


def test_engine_serves_the_hybrid_as_the_reference_teacher_forced(params):
    """``ServingEngine(device="cpu")`` on the hybrid (bucketed prefills
    with remainder steps, a second admission wave): every sampled logits
    row against the reference's forward over the prompt and the tokens
    the engine fed itself."""
    eng = ServingEngine(CFG, params, max_batch=3, max_seq=48, device="cpu")
    kept = _keep_logits(eng)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, tokens=rng.integers(0, CFG.vocab_size, size=n),
                    max_new_tokens=m)
            for i, (n, m) in enumerate([(5, 7), (12, 4), (9, 9), (3, 5)])]
    for r in reqs:
        eng.submit(r)
    done = eng.run_to_completion()
    assert sorted(c.uid for c in done) == [0, 1, 2, 3]
    assert eng.remainder_steps == sum(n - (1 << (n.bit_length() - 1))
                                      for n in (5, 12, 9, 3))
    for c in done:
        prompt = reqs[c.uid].tokens
        seq = torch.as_tensor(np.concatenate([prompt, c.tokens[:-1]]))[None]
        ref = plain_hybrid.forward(CFG, params, seq)[0, len(prompt) - 1:]
        got = torch.stack(kept[c.uid])
        assert got.shape == ref.shape
        assert _rel(got, ref) <= TOL_MODEL


# ---------------------------------------------------------------------------
# the state update's plain twin
# ---------------------------------------------------------------------------


def _step_inputs(B, H, P, N, G, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((B, H, P, N), generator=gen),
            0.5 * torch.randn((B, H * P + 2 * G * N), generator=gen),
            torch.randn((B, H), generator=gen),
            0.5 * torch.randn((H,), generator=gen) - 3.0,
            -(1.0 + 15.0 * torch.rand((H,), generator=gen)),
            torch.randn((H,), generator=gen))


def _reference_step(state, xbc, dt, dt_bias, A, D, H, P, N, G):
    """One step as the published equations write it, head by head."""
    B = state.shape[0]
    new, y = state.clone(), torch.empty((B, H, P))
    for b in range(B):
        for h in range(H):
            g = h // (H // G)
            x = xbc[b, h * P:(h + 1) * P]
            Bv = xbc[b, H * P + g * N:H * P + (g + 1) * N]
            Cv = xbc[b, H * P + G * N + g * N:H * P + G * N + (g + 1) * N]
            delta = torch.nn.functional.softplus(dt[b, h] + dt_bias[h])
            new[b, h] = (torch.exp(delta * A[h]) * state[b, h]
                         + delta * torch.outer(x, Bv))
            y[b, h] = new[b, h] @ Cv + D[h] * x
    return new, y


@pytest.mark.parametrize("B,H,P,N,G", [(2, 4, 8, 16, 1), (3, 8, 4, 32, 2),
                                       (1, 4, 6, 8, 4)])
def test_plain_twin_matches_the_reference_step(B, H, P, N, G):
    """``ssm_update_plain`` (the kernel's arithmetic in torch, what the CPU
    runs) against the step written head by head: y and the state it
    leaves in place."""
    args = _step_inputs(B, H, P, N, G, seed=B * 100 + N)
    dims = dict(heads=H, head_dim=P, groups=G, d_state=N)
    state = args[0].clone()
    y = ssm_update(state, *args[1:], **dims)
    want_s, want_y = _reference_step(*args, H, P, N, G)
    assert _rel(y, want_y) <= TOL_BLOCK
    assert _rel(state, want_s) <= TOL_BLOCK


def test_ssm_update_costs_its_state_twice():
    args = _step_inputs(2, 4, 8, 16, 1, seed=1)
    cost = ssm_update.cost(*args, heads=4, head_dim=8, groups=1, d_state=16)
    assert cost.bytes >= 2 * args[0].numel() * 4
    assert cost.flops == 2 * args[0].numel()


# ---------------------------------------------------------------------------
# the cache's Mamba-2 leaves, written in place
# ---------------------------------------------------------------------------


def test_mamba2_leaves_are_the_same_tensors_after_decode_into(params):
    """``decode_into`` (the static-buffer step the CUDA graph captures)
    leaves every Mamba-2 leaf of the cache the tensor it was, written in
    place, and equal to what ``decode_step`` on a clone gives."""
    with torch.inference_mode():
        _, cache = tf.prefill(CFG, params, {"tokens": _tokens(2, 6)},
                              seq_len=16)
        twin = tf.map_layers(torch.clone, cache["layers"])
        before = [(layer["ssm"], layer["conv"],
                   layer["ssm"].data_ptr(), layer["conv"].data_ptr())
                  for layer in cache["layers"] if "ssm" in layer]
        tok = _tokens(2, 1, seed=9)
        _, new = tf.decode_step(CFG, params, {"layers": twin,
                                              "idx": cache["idx"].clone()},
                                {"tokens": tok})
        decode_into(CFG, params, cache, tok)
        after = [layer for layer in cache["layers"] if "ssm" in layer]
        for (ssm, conv, p_ssm, p_conv), layer in zip(before, after):
            assert layer["ssm"] is ssm and layer["conv"] is conv
            assert layer["ssm"].data_ptr() == p_ssm
            assert layer["conv"].data_ptr() == p_conv
        ref = [layer for layer in new["layers"] if "ssm" in layer]
        for got, want in zip(after, ref):
            assert torch.equal(got["ssm"], want["ssm"])
            assert torch.equal(got["conv"], want["conv"])
        graph = DecodeGraph(CFG, params, cache)
        graph(tok)
        assert graph.logits is not None


# ---------------------------------------------------------------------------
# the other decoders: the new fields' defaults change nothing
# ---------------------------------------------------------------------------

NEW_FIELDS = {"mamba_n_heads": 0, "mamba_d_head": 0, "mamba_d_state": 0,
              "mamba_n_groups": 1, "mamba_d_conv": 4, "mamba_expand": 2,
              "mamba_chunk_size": 256, "mamba_conv_bias": True,
              "embedding_multiplier": 1.0,
              "residual_multiplier": 1.0, "attention_multiplier": 0.0,
              "logits_scaling": 1.0, "position_embedding": "rope"}


@pytest.mark.parametrize("arch", ["starcoder2-3b", "stablelm-12b",
                                  "recurrentgemma-2b", "olmoe-1b-7b",
                                  "xlstm-125m"])
def test_existing_decoders_unchanged_by_the_new_defaults(arch, monkeypatch):
    """Every other decoder holds the new fields at their defaults, and its
    logits are bit for bit those of the residual path without the
    multiplier (a plain ``x + o``): the scalars' branches are off."""
    cfg = configs.get_reduced(arch)
    assert {k: getattr(cfg, k) for k in NEW_FIELDS} == NEW_FIELDS
    p = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 7)))
    got, _, _ = tf.forward(cfg, p, tokens=toks)
    monkeypatch.setattr(tf, "_residual", lambda cfg, x, o: x + o)
    want, _, _ = tf.forward(cfg, p, tokens=toks)
    assert torch.equal(got, want)


def test_granite_config_is_the_published_one():
    """The published numbers (huggingface.co/ibm-granite/
    granite-4.0-h-micro, config.json), and its parameter count."""
    cfg = configs.get_config("granite-4.0-h-micro")
    kinds = cfg.layer_kinds()
    assert kinds.count("mamba2") == 36 and kinds.count("attn") == 4
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [5, 15, 25, 35]
    assert (cfg.d_model, cfg.d_ff, cfg.vocab_size) == (2048, 8192, 100352)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (32, 8, 64)
    assert (cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state,
            cfg.mamba_n_groups, cfg.mamba_d_conv) == (64, 64, 128, 1, 4)
    assert cfg.mamba_d_inner == cfg.mamba_expand * cfg.d_model
    assert cfg.mamba_conv_dim == 4352
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.attention_multiplier, cfg.logits_scaling) == (
        12.0, 0.22, 0.015625, 8.0)
    assert cfg.position_embedding == "nope" and cfg.tie_embeddings
    assert 3.18e9 < cfg.num_params() < 3.20e9
    assert "granite-4.0-h-micro" not in configs.list_archs()
    with pytest.raises(ValueError, match="position_embedding"):
        tf.check_supported(dataclasses.replace(cfg, position_embedding="x"))


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain twin
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,P,N,G", [
    (1, 64, 64, 128, 1), (32, 64, 64, 128, 1), (3, 8, 24, 64, 2),
    (5, 4, 16, 32, 4), (2, 4, 40, 256, 1)])
def test_cuda_ssm_update_matches_plain(cuda, B, H, P, N, G):
    """The kernel against its plain twin on the card (relative 1e-5: fp32
    sums in other orders, exp and log1p of other libraries), one launch a
    call, bit-equal run to run and each row equal to its own B = 1 call."""
    args = [t.to(cuda) for t in _step_inputs(B, H, P, N, G, seed=7)]
    dims = dict(heads=H, head_dim=P, groups=G, d_state=N)
    s_k, s_p = args[0].clone(), args[0].clone()
    n = ssm_update.kernel_launches
    y = ssm_update(s_k, *args[1:], **dims)
    assert ssm_update.kernel_launches == n + 1
    y_p = ssm_update_plain(s_p, *args[1:], **dims)
    assert _rel(y, y_p) <= TOL_BLOCK
    assert _rel(s_k, s_p) <= TOL_BLOCK
    s_2 = args[0].clone()
    assert torch.equal(ssm_update(s_2, *args[1:], **dims), y)
    assert torch.equal(s_2, s_k)
    for r in range(B):
        s_1 = args[0][r:r + 1].clone()
        y_1 = ssm_update(s_1, args[1][r:r + 1], args[2][r:r + 1], *args[3:],
                         **dims)
        assert torch.equal(y_1[0], y[r]) and torch.equal(s_1[0], s_k[r])


@pytest.mark.cuda
def test_cuda_engine_launches_one_ssm_update_a_mamba_layer(cuda):
    """The reduced hybrid served on the card (bf16): each decode step, the
    batched tick and every remainder step, launches ``ssm_update`` once a
    Mamba-2 layer, and the plain twin never runs."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16", mamba_d_state=32)
    p = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(cfg, p, max_batch=3, max_seq=48, device="cuda")
    rng = np.random.default_rng(2)
    for i, (n, m) in enumerate([(5, 7), (12, 4), (9, 9), (3, 5)]):
        eng.submit(Request(uid=i, tokens=rng.integers(0, cfg.vocab_size,
                                                      size=n),
                           max_new_tokens=m))
    n = ssm_update.kernel_launches
    eng.run_to_completion()
    layers = cfg.layer_kinds().count("mamba2")
    assert ssm_update.kernel_launches - n == layers * (
        eng.steps + eng.remainder_steps)
