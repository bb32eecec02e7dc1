"""The port's optimizer and gradient compression (repro_torch.optim): the
reference's seven tests (tests/test_optim.py) on the port, and parity with
``repro.optim`` on the same numpy inputs.

Tolerances: ``lr_at`` 2e-6 relative (fp32, the same operations, but torch's
cos and XLA's may round another way, and near the end of the schedule
1 + cos(pi·prog) cancels, which makes one ulp of cos up to ~1e-6 of lr;
read 2.8e-7); ``apply_updates`` on fp32 and bf16 leaves over three
steps: m and v within 2e-6 of each leaf's largest, the params within 1e-5
of lr (the step is ill-conditioned only where g is near 0: none here),
grad_norm 1e-6; ``compress`` int8 within 1e-6 of each leaf's largest
|x| (round(x / scale) is the same on both; the product with the scale
rounds once), top-k bit for bit (the same threshold and selection).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim

from repro_torch import tree as tr
from repro_torch.convert import from_jax
from repro_torch.optim import (AdamWConfig, CompressionConfig, apply_updates,
                               clip_by_global_norm, compress,
                               compressed_bytes, global_norm,
                               init_error_state, init_state, lr_at)
from repro_torch.optim.compression import _int8_roundtrip


def test_adamw_descends_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=100, clip_norm=1e9)
    params = {"w": torch.tensor([[3.0, -2.0]])}
    state = init_state(params)
    for _ in range(100):
        grads = tr.tree_map(lambda p: 2 * p, params)  # d/dp ||p||^2
        params, state, m = apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.1


def test_clipping():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    g2 = {"a": torch.full((4,), 0.01)}
    c2, _ = clip_by_global_norm(g2, 1.0)
    np.testing.assert_allclose(c2["a"].numpy(), 0.01, rtol=1e-6)


def test_lr_schedule():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                      min_lr_frac=0.1)
    assert float(lr_at(cfg, 0)) == pytest.approx(0.1)
    assert float(lr_at(cfg, 9)) == pytest.approx(1.0)
    assert float(lr_at(cfg, 110)) == pytest.approx(0.1, abs=1e-3)
    vals = [float(lr_at(cfg, s)) for s in range(10, 110, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


def test_weight_decay_only_on_matrices():
    cfg = AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=0,
                      clip_norm=1e9)
    params = {"mat": torch.ones((2, 2)), "bias": torch.ones((2,))}
    state = init_state(params)
    zero_g = tr.tree_map(torch.zeros_like, params)
    p2, _, _ = apply_updates(cfg, params, zero_g, state)
    assert float(p2["mat"][0, 0]) < 1.0   # decayed
    assert float(p2["bias"][0]) == 1.0    # exempt


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compression_error_feedback_preserves_signal(scheme):
    cfg = CompressionConfig(scheme=scheme, topk_frac=0.25)
    params = {"w": torch.zeros((64,))}
    err = init_error_state(params)
    rng = np.random.default_rng(0)
    total_raw = np.zeros(64)
    total_comp = np.zeros(64)
    for i in range(50):
        g = {"w": torch.from_numpy(rng.normal(size=64).astype(np.float32))}
        c, err = compress(cfg, g, err)
        total_raw += g["w"].numpy()
        total_comp += c["w"].numpy()
    resid = np.abs(total_raw - total_comp).max()
    assert resid < np.abs(total_raw).max() * 0.5 + 1.0


def test_compression_convergence_on_quadratic():
    acfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                       clip_norm=1e9)
    ccfg = CompressionConfig(scheme="topk", topk_frac=0.25)
    params = {"w": torch.linspace(-2, 2, 32)}
    state = init_state(params)
    err = init_error_state(params)
    for _ in range(300):
        grads = tr.tree_map(lambda p: 2 * p, params)
        grads, err = compress(ccfg, grads, err)
        params, state, _ = apply_updates(acfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.15


def test_int8_roundtrip_bounded_error():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=1000) * 5)
    r = _int8_roundtrip(g)
    scale = float(g.abs().max()) / 127.0
    assert float((r - g).abs().max()) <= scale * 0.5 + 1e-6


# ---------------------------------------------------------------------------
# parity with repro.optim
# ---------------------------------------------------------------------------


def test_lr_at_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=60, min_lr_frac=0.1)
    for step in range(0, 70, 3):
        want = float(joptim.lr_at(joptim.AdamWConfig(**cfg), step))
        got = float(lr_at(AdamWConfig(**cfg), torch.tensor(step,
                                                            dtype=torch.int32)))
        assert got == pytest.approx(want, rel=2e-6)


def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "layers": [{"u": rng.standard_normal((3, 4, 2)).astype(
                np.float32)}]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(dtype):
    rng = np.random.default_rng(1)
    jdt = jnp.dtype(dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(rng))
    params = from_jax(jax.tree.map(np.asarray, jparams))
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=0.5)
    jcfg, cfg = joptim.AdamWConfig(**kw), AdamWConfig(**kw)
    jstate, state = joptim.init_state(jparams), init_state(params)
    for step in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(rng))
        jparams, jstate, jm = joptim.apply_updates(jcfg, jparams, g, jstate)
        params, state, m = apply_updates(
            cfg, params, from_jax(jax.tree.map(np.asarray, g)), state)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=2e-6)
    assert int(state["count"]) == int(jstate["count"]) == 3
    assert state["count"].dtype == torch.int32
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(jstate[key]), tr.leaves(state[key])):
            a = np.asarray(a)
            assert b.dtype == torch.float32
            assert np.abs(b.numpy() - a).max() <= 2e-6 * np.abs(a).max()
    for a, b in zip(jax.tree.leaves(jparams), tr.leaves(params)):
        assert str(b.dtype) == f"torch.{dtype}"
        a = np.asarray(a, np.float32)
        tol = 1e-5 * kw["lr"] + (2.0 ** -8 * np.abs(a) if dtype ==
                                 "bfloat16" else 0.0)
        assert (np.abs(b.float().numpy() - a) <= tol).all()


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compress_matches_reference(scheme):
    rng = np.random.default_rng(2)
    kw = dict(scheme=scheme, topk_frac=0.1)
    g = _tree(rng)
    e = jax.tree.map(lambda a: (a * 0.01).astype(np.float32), _tree(rng))
    jc, je = joptim.compress(joptim.CompressionConfig(**kw),
                             jax.tree.map(jnp.asarray, g),
                             jax.tree.map(jnp.asarray, e))
    c, ne = compress(CompressionConfig(**kw), from_jax(g), from_jax(e))
    for want, got in ((jc, c), (je, ne)):
        for a, b in zip(jax.tree.leaves(want), tr.leaves(got)):
            a = np.asarray(a)
            if scheme == "topk":
                np.testing.assert_array_equal(b.numpy(), a)
            else:
                assert np.abs(b.numpy() - a).max() <= 1e-6 * np.abs(a).max()
    p = from_jax(g)
    jbytes = joptim.compression.compressed_bytes(
        joptim.CompressionConfig(**kw), jax.tree.map(jnp.asarray, g))
    assert compressed_bytes(CompressionConfig(**kw), p) == jbytes
