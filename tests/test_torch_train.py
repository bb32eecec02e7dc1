"""Training in the port (P11) against the JAX package on the CPU: the
gradient of ``kernels.rglru.rglru_scan`` (its ``RglruScan`` backward,
``rglru_scan_bwd``) against ``jax.grad`` of the reference's
``scan_recurrence``; the backward of ``common.matmul_f32`` (the card's
bf16-operand, fp32-result products) against ``jax.grad`` of the
reference's einsums; ``transformer.loss_fn`` for every architecture; and
microbatched steps against single ones with the reference's own
assertions.  The same numpy-seeded inputs and ``convert.from_jax``'d
parameters go through both packages.

Tolerances:
  * rglru_scan's gradient: max |port − jax| ≤ 2e-6 x max |jax| of each of
    dlog_a, dgx, dh0 (read: ≤ 4.6e-7; the two evaluate the derivative of
    the same fp32 step in other orders — the port takes a² as exp(2·la),
    as its forward does); where a rounds to 1, the same inf at the same
    places (``rglru_scan_bwd_plain``'s doc).
  * matmul_f32's cotangents: bf16, each within one bf16 ulp of the
    element (at most 2^-7 of its magnitude), plus 1e-6 of the largest
    (the fp32 sums differ in order before the one rounding to bf16, and
    may round to neighbouring bf16 values).
  * loss_fn: total, loss and aux within 2e-6 relative (fp32 forward; read
    ≤ 1.7e-7).
  * microbatches: the reference's own, rtol 1e-4 on the loss and atol 1e-4
    on the params (dense); finiteness only with MoE.
The CUDA kernel ``rglru_scan_bwd`` is held against its plain version by
the ``cuda``-marked test here (and by chip_smoke.py's train phase).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.configs import list_archs
from repro.models import transformer as jtf
from repro.models.layers import rglru as jrglru

from repro_torch import configs
from repro_torch import tree as tr
from repro_torch.convert import from_jax
from repro_torch.kernels.common import reset_counts
from repro_torch.kernels.rglru import ops
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.models.layers import common

ARCHS = list_archs()
GRAD_TOL = 2e-6
LOSS_RTOL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# rglru_scan's gradient
# ---------------------------------------------------------------------------


def _rglru_case(kind, B=2, T=37, W=70, seed=0):
    """(log_a, gx, h0, dhs weights, dhT weights), fp32.  "gate_inputs":
    la and gx from the reference's ``gate_inputs`` on a random x;
    "near_zero": la within 1e-6 of 0, where 1 − a² cancels (some a round
    to 1)."""
    rng = np.random.default_rng(seed)
    p = jrglru.init_rglru(jax.random.PRNGKey(seed), W, jnp.float32)
    x = jnp.asarray(rng.standard_normal((B, T, W)).astype(np.float32))
    la, gx = (np.array(a) for a in jrglru.gate_inputs(p, x))
    if kind == "near_zero":
        la = (-np.abs(rng.standard_normal((B, T, W))) * 1e-6).astype(
            np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    ws = rng.standard_normal((B, T, W)).astype(np.float32)
    wT = rng.standard_normal((B, W)).astype(np.float32)
    return la, gx, h0, ws, wT


@pytest.mark.parametrize("kind", ["gate_inputs", "near_zero"])
def test_rglru_scan_grad_matches_jax_grad(kind):
    la, gx, h0, ws, wT = _rglru_case(kind)

    def f(la, gx, h0):
        hT, hs = jrglru.scan_recurrence(la, gx, h0)
        return jnp.sum(hs * ws) + jnp.sum(hT * wT)

    want = [np.asarray(g) for g in
            jax.jit(jax.grad(f, argnums=(0, 1, 2)))(la, gx, h0)]
    args = [torch.from_numpy(a).requires_grad_() for a in (la, gx, h0)]
    reset_counts(ops.rglru_scan, ops.rglru_scan_bwd)
    hs, hT = ops.rglru_scan(*args)
    loss = (hs * torch.from_numpy(ws)).sum() + (hT * torch.from_numpy(wT)).sum()
    got = [g.numpy() for g in torch.autograd.grad(loss, args)]
    assert ops.rglru_scan.calls == 1 and ops.rglru_scan_bwd.calls == 1
    assert ops.rglru_scan_bwd.kernel_launches == 0  # the plain version
    for name, w, g in zip(("dlog_a", "dgx", "dh0"), want, got):
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
        np.testing.assert_array_equal(g[~fin], w[~fin], err_msg=name)
        err = np.abs(g[fin] - w[fin]).max()
        assert err <= GRAD_TOL * np.abs(w[fin]).max(), (name, err)
    if kind == "near_zero":
        assert not np.isfinite(want[0]).all()  # the case reaches a = 1


def test_rglru_layer_grad_matches_jax_grad():
    """``apply_rglru``'s parameter gradient (gate GEMMs, Lambda, the scan)
    against ``jax.grad`` of the reference's, fp32, within GRAD_TOL of each
    leaf's largest."""
    B, T, W = 2, 37, 70
    rng = np.random.default_rng(5)
    jp = jrglru.init_rglru(jax.random.PRNGKey(5), W, jnp.float32)
    x = rng.standard_normal((B, T, W)).astype(np.float32)
    wy = rng.standard_normal((B, T, W)).astype(np.float32)

    def f(p):
        y, hT = jrglru.apply_rglru(p, jnp.asarray(x))
        return jnp.sum(y * wy) + jnp.sum(hT)

    want = jax.grad(f)(jp)
    tp = from_jax(jax.tree.map(np.asarray, jp))
    views = {k: v.requires_grad_() for k, v in tp.items()}
    from repro_torch.models.layers import rglru

    y, hT = rglru.apply_rglru(views, torch.from_numpy(x))
    loss = (y * torch.from_numpy(wy)).sum() + hT.sum()
    got = dict(zip(views, torch.autograd.grad(loss, list(views.values()))))
    for k in views:
        w = np.asarray(want[k])
        err = np.abs(got[k].numpy() - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (k, err)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,W", [(1, 1024, 2560), (4, 300, 2560),
                                   (1, 129, 513), (3, 33, 100),
                                   (2, 65, 2560), (2, 1, 33)])
def test_cuda_rglru_scan_bwd_matches_plain(cuda, B, T, W):
    """The kernel computes the plain version's operations: finite values
    within 1e-6 of the largest |plain|, the same inf and nan; one launch a
    call; bit-equal run to run and each row equal to its own (B = 1)
    call."""
    la, gx, h0, ws, wT = (torch.from_numpy(a).to(cuda) for a in
                          _rglru_case("gate_inputs", B, T, W, seed=7))
    la[0, : min(T, 3)] = 0.0  # a = 1 exactly: the inf / nan branch
    hs, _ = ops.rglru_scan(la, gx, h0)
    reset_counts(ops.rglru_scan_bwd)
    out = ops.rglru_scan_bwd(la, gx, h0, hs, ws, wT)
    ref = ops.rglru_scan_bwd_plain(la, gx, h0, hs, ws, wT)
    torch.cuda.synchronize()
    assert ops.rglru_scan_bwd.kernel_launches == 1
    for o, r in zip(out, ref):
        fin = torch.isfinite(r)
        assert torch.equal(torch.isfinite(o), fin)
        assert torch.equal(o[~fin].nan_to_num(7.0), r[~fin].nan_to_num(7.0))
        assert (o[fin] - r[fin]).abs().max() <= 1e-6 * r[fin].abs().max()
    for a, b in zip(ops.rglru_scan_bwd(la, gx, h0, hs, ws, wT), out):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    for b in range(B):
        one = ops.rglru_scan_bwd(la[b:b + 1], gx[b:b + 1], h0[b:b + 1],
                                 hs[b:b + 1], ws[b:b + 1], wT[b:b + 1])
        for o, w in zip(one, out):
            assert torch.equal(o.nan_to_num(7.0), w[b:b + 1].nan_to_num(7.0))


# ---------------------------------------------------------------------------
# matmul_f32's backward (the card's bf16 x bf16 -> fp32 products)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["bmm", "mm"])
def test_matmul_f32_grad_matches_reference_einsum(form, monkeypatch):
    """``_MatmulF32`` (what ``matmul_f32`` and the unembed run on the card)
    against ``jax.grad`` of the reference's einsum with
    ``preferred_element_type=float32`` on bf16 operands.  The CPU has no
    ``aten::bmm.dtype``, so its product is replaced here by the fp32
    product of the upcast operands, which it equals: the backward's
    algebra (three bf16 parts of the fp32 cotangent, one rounding to bf16)
    is what is held."""
    monkeypatch.setattr(common, "_mm_f32",
                        lambda a, b: torch.matmul(a.float(), b.float()))
    rng = np.random.default_rng(11)
    shapes = {"bmm": ((3, 5, 24), (3, 24, 7), "eik,ekj->eij"),
              "mm": ((6, 24), (24, 9), "ik,kj->ij")}
    sa, sb, eq = shapes[form]
    a = jnp.asarray(rng.standard_normal(sa), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(sb), jnp.bfloat16)
    w = rng.standard_normal(sa[:-1] + sb[-1:]).astype(np.float32)

    def f(a, b):
        return jnp.sum(jnp.einsum(eq, a, b, preferred_element_type=jnp.float32)
                       * w)

    want = [np.asarray(g, np.float32) for g in jax.grad(f, (0, 1))(a, b)]
    ta, tb = (from_jax(np.asarray(x)).requires_grad_() for x in (a, b))
    y = common._MatmulF32.apply(ta, tb)
    assert y.dtype == torch.float32
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), (ta, tb))
    for g, wv in zip(got, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        tol = 2.0 ** -7 * np.abs(wv) + 1e-6 * np.abs(wv).max()
        assert (np.abs(g - wv) <= tol).all()


def test_matmul_f32_grad_on_the_cpu_upcasts():
    """On the CPU ``matmul_f32`` upcasts and autograd differentiates that: a
    bf16 operand's cotangent is the fp32 product rounded to bf16 once, as
    the reference's."""
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.standard_normal((2, 4, 16))).to(
        torch.bfloat16).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((2, 16, 5))).to(
        torch.bfloat16).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((2, 4, 5)).astype(np.float32))
    da, db = torch.autograd.grad((common.matmul_f32(a, b) * w).sum(), (a, b))
    assert torch.equal(da, torch.bmm(w, b.detach().float().transpose(1, 2))
                       .to(torch.bfloat16))
    assert torch.equal(db, torch.bmm(a.detach().float().transpose(1, 2), w)
                       .to(torch.bfloat16))


# ---------------------------------------------------------------------------
# loss_fn, microbatches
# ---------------------------------------------------------------------------


def arch_batch(cfg, B=2, S=16, seed=0):
    """A numpy batch: tokens, or embeds and labels for ``embed_stub``."""
    rng = np.random.default_rng(seed)
    if cfg.embed_stub:
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                    np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}


def jax_model(arch, seed=0):
    jcfg = jget_reduced(arch)
    return jcfg, jtf.init_params(jcfg, jax.random.PRNGKey(seed))


def port_params(jparams):
    return from_jax(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    jcfg, jparams = jax_model(arch)
    batch = arch_batch(jcfg)
    jtotal, jm = jax.jit(lambda p, b: jtf.loss_fn(jcfg, p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = configs.get_reduced(arch)
    total, m = tf.loss_fn(cfg, port_params(jparams),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert total.dtype == torch.float32
    for got, want in ((total, jtotal), (m["loss"], jm["loss"]),
                      (m["aux_loss"], jm["aux_loss"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                                   atol=1e-7)
    if cfg.n_experts:
        assert float(m["aux_loss"]) > 0


@pytest.mark.parametrize("arch", ["deepseek-67b", "arctic-480b"])
def test_microbatched_matches_single(arch):
    """The reference's own test (tests/models/test_archs_smoke.py) on the
    port: gradient accumulation over 2 microbatches equals the full-batch
    step (loss rtol 1e-4, params atol 1e-4); with MoE only finiteness
    holds (microbatching changes the capacity groups)."""
    cfg = configs.get_reduced(arch)
    _, jparams = jax_model(arch)
    batch = {k: torch.from_numpy(v)
             for k, v in arch_batch(cfg, B=4, S=8).items()}
    out = {}
    for n in (1, 2):
        s = steps.TrainSettings(microbatches=n)
        params = port_params(jparams)
        p, o, m = steps.make_train_step(cfg, s)(
            params, steps.init_opt_state(cfg, params, s), batch)
        out[n] = (p, m)
        assert int(o["adam"]["count"]) == 1
    (p1, m1), (p2, m2) = out[1], out[2]
    assert float(m2["aux_loss"]) == 0.0  # as the reference reports it
    if cfg.n_experts:
        assert np.isfinite(float(m2["loss"]))
    else:
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                                   rtol=1e-4)
        for a, b in zip(tr.leaves(p1), tr.leaves(p2)):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       atol=1e-4)


def test_loss_fn_no_longer_raises_and_nothing_is_queued_as_p11():
    """Training is ported: no ``not_ported(..., "P11")`` is left in the
    port's sources."""
    import pathlib

    import repro_torch

    root = pathlib.Path(repro_torch.__file__).parent
    for path in root.rglob("*.py"):
        assert '"P11"' not in path.read_text(), path
