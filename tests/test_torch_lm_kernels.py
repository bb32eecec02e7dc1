"""The port's transformer decode kernels — ``mvm`` (repro_torch.kernels.
mvm_tile) and ``decode_attention`` (repro_torch.kernels.decode_attention)
— against the JAX package on the CPU.

The same numpy-seeded inputs go through both packages: JAX runs its Pallas
kernels in interpret mode, as its own tests do, and its pure-jnp oracles;
the port's entry points run their plain PyTorch versions on the CPU.  The
CUDA kernels themselves are held against those plain versions on the card
by the ``cuda``-marked tests at the end and by chip_smoke.py.

Tolerances are those of tests/kernels/test_mvm_tile.py and
tests/kernels/test_decode_attention.py: fp32 mvm within atol 2e-5 / rtol
1e-5 (3e-5 / 1e-4 over the edge sweep) — the two sides sum X products in
other orders; bf16 mvm within atol 5e-2 / rtol 1e-2, one bf16 rounding of
outputs up to ~|y| ≈ 10; decode attention within atol 2e-5 (fp32 scores,
softmax and p·v, summed in other orders).  Against the oracle that rounds
p to the cache dtype (``decode_attention_ref``) bf16 caches are held at
2e-2: one bf16 rounding of p in [0, 1] is up to 2^-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import (
    decode_attention as jdecode_attention)
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jdecode_attention_ref)
from repro.kernels.mvm_tile.ops import mvm as jmvm
from repro.kernels.mvm_tile.ref import mvm_ref as jmvm_ref

from repro_torch.kernels import build
from repro_torch.kernels.common import reset_counts
from repro_torch.kernels.decode_attention import ops as dattn
from repro_torch.kernels.mvm_tile import ops as mvm_ops

MVM_TOL = dict(atol=2e-5, rtol=1e-5)
MVM_EDGE_TOL = dict(atol=3e-5, rtol=1e-4)
MVM_BF16_TOL = dict(atol=5e-2, rtol=1e-2)
ATTN_TOL = dict(atol=2e-5, rtol=0)
ATTN_BF16_REF_TOL = dict(atol=2e-2, rtol=0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _mvm_inputs(B, X, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, X)).astype(np.float32)
    W = (rng.standard_normal((X, N)) * 0.1).astype(np.float32)
    b = rng.standard_normal((N,)).astype(np.float32)
    return x, W, b


def _pair(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    (bf16 rounds the same fp32 values on both sides)."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(dtype)


# ---------------------------------------------------------------------------
# mvm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,X,N", [(1, 64, 128), (4, 100, 300),
                                   (2, 340, 1360), (8, 513, 129), (1, 32, 32)])
@pytest.mark.parametrize("bn,bk", [(128, 64), (256, 128)])
def test_mvm_matches_reference_fp32(B, X, N, bn, bk):
    """The reference's shapes and blocks (Pallas interpret and jnp oracle)."""
    x, W, b = _mvm_inputs(B, X, N, seed=X * 7 + N)
    ours = mvm_ops.mvm(*map(torch.from_numpy, (x, W, b)), block_n=min(bn, N),
                       block_k=min(bk, X))
    ref = jmvm(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b),
               block_n=min(bn, N), block_k=min(bk, X), interpret=True)
    oracle = jmvm_ref(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b))
    assert ours.shape == (B, N) and ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **MVM_TOL)
    np.testing.assert_allclose(_np(ours), np.asarray(oracle), **MVM_TOL)


def test_mvm_no_bias_and_vector_input():
    """x of shape (X,) comes back (N,); no bias."""
    x, W, _ = _mvm_inputs(1, 96, 160, seed=1)
    ours = mvm_ops.mvm(torch.from_numpy(x[0]), torch.from_numpy(W))
    ref = jmvm(jnp.asarray(x[0]), jnp.asarray(W), interpret=True)
    assert ours.shape == (160,) and ref.shape == (160,)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **MVM_TOL)
    np.testing.assert_allclose(
        _np(ours), np.asarray(jmvm_ref(jnp.asarray(x), jnp.asarray(W))[0]),
        **MVM_TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, MVM_BF16_TOL),
                                       (torch.float32, MVM_TOL)])
def test_mvm_dtypes(dtype, tol):
    """bf16 and fp32 x and W: the output keeps x's dtype."""
    x, W, b = _mvm_inputs(2, 128, 256, seed=2)
    (jx, tx), (jW, tW) = _pair(x, dtype), _pair(W, dtype)
    ours = mvm_ops.mvm(tx, tW, torch.from_numpy(b))
    ref = jmvm(jx, jW, jnp.asarray(b), interpret=True)
    assert ours.dtype == dtype
    np.testing.assert_allclose(_np(ours), _np(ref), **tol)
    np.testing.assert_allclose(_np(ours), _np(jmvm_ref(jx, jW,
                                                       jnp.asarray(b))),
                               **tol)


@pytest.mark.parametrize("B,X,N,bn,bk", [(1, 8, 8, 32, 32),
                                         (3, 200, 17, 64, 32),
                                         (2, 57, 200, 128, 64),
                                         (3, 129, 131, 32, 64)])
def test_mvm_edges(B, X, N, bn, bk):
    """Ragged X and N against blocks that do not divide them (the masked
    edges of the Pallas kernel)."""
    x, W, b = _mvm_inputs(B, X, N, seed=X * 211 + N)
    ours = mvm_ops.mvm(*map(torch.from_numpy, (x, W, b)), block_n=min(bn, N),
                       block_k=min(bk, X))
    ref = jmvm(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b),
               block_n=min(bn, N), block_k=min(bk, X), interpret=True)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **MVM_EDGE_TOL)


def test_mvm_blocks_change_no_number_and_counters():
    """block_n / block_k are the TPU tile: accepted, checked, ignored.
    calls count every invocation,
    kernel launches only CUDA ones; the CUDA wrapper refuses CPU tensors."""
    x, W, b = map(torch.from_numpy, _mvm_inputs(3, 300, 200, seed=3))
    reset_counts(mvm_ops.mvm)
    base = mvm_ops.mvm(x, W, b)
    for bn, bk in ((32, 32), (64, 128), (200, 300)):
        assert torch.equal(mvm_ops.mvm(x, W, b, block_n=bn, block_k=bk), base)
    assert (mvm_ops.mvm.calls, mvm_ops.mvm.kernel_launches) == (4, 0)
    with pytest.raises(ValueError, match="block_n"):
        mvm_ops.mvm(x, W, block_n=-1)
    with pytest.raises(ValueError, match="expected"):
        mvm_ops.mvm(x[:, :10], W)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mvm_ops.mvm_cuda(x, W, b)
    assert "mvm_tile" in build.all_kernels()


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------


def _attn_inputs(B, T, Hq, Hk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((B, T, Hk, D)).astype(np.float32)
    vc = rng.standard_normal((B, T, Hk, D)).astype(np.float32)
    valid = rng.integers(1, T + 1, size=(B,)).astype(np.int32)
    return q, kc, vc, valid


def _both(q, kc, vc, valid, dtype=torch.float32, **kw):
    """(port, Pallas interpret, jnp oracle) on the same inputs."""
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kc, dtype)
    jv, tv = _pair(vc, dtype)
    ours = dattn.decode_attention(tq, tk, tv, torch.from_numpy(valid), **kw)
    ref = jdecode_attention(jq, jk, jv, jnp.asarray(valid), interpret=True,
                            **kw)
    oracle = jdecode_attention_ref(jq, jk, jv, jnp.asarray(valid))
    return ours, ref, oracle


@pytest.mark.parametrize("B,T,Hq,Hk,D", [(1, 64, 4, 4, 32),     # MHA
                                         (2, 128, 8, 2, 64),    # GQA
                                         (1, 512, 16, 1, 128),  # MQA
                                         (3, 256, 8, 8, 64),
                                         (2, 256, 10, 1, 256)])  # RG-2B heads
def test_decode_attention_matches_reference(B, T, Hq, Hk, D):
    ours, ref, oracle = _both(*_attn_inputs(B, T, Hq, Hk, D, seed=T + Hq))
    assert ours.shape == (B, Hq, D) and ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **ATTN_TOL)
    np.testing.assert_allclose(_np(ours), np.asarray(oracle), **ATTN_TOL)


def test_decode_attention_block_sweep():
    """Every block_t gives the reference's output (and its oracle's)."""
    args = _attn_inputs(2, 256, 8, 2, 32, seed=5)
    for bt in (32, 64, 128, 256):
        ours, ref, oracle = _both(*args, block_t=bt)
        np.testing.assert_allclose(_np(ours), np.asarray(ref), **ATTN_TOL)
        np.testing.assert_allclose(_np(ours), np.asarray(oracle), **ATTN_TOL)


def test_decode_attention_valid_one_equals_first_value():
    """With a single live slot, the output is v[0] of each head group."""
    B, T, Hq, Hk, D = 1, 64, 4, 2, 16
    q, kc, vc, _ = _attn_inputs(B, T, Hq, Hk, D, seed=6)
    valid = np.ones((B,), np.int32)
    ours, ref, _ = _both(q, kc, vc, valid)
    expect = np.repeat(vc[:, 0], Hq // Hk, axis=1)  # (B, Hk*G, D)
    np.testing.assert_allclose(_np(ours), expect, atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **ATTN_TOL)


def test_decode_attention_4d_query_and_bf16():
    """q as (B, 1, Hq, D) comes back (B, 1, Hq, D); bf16 q and caches
    against the Pallas kernel (fp32 p, atol 2e-2 for the bf16 output) and
    the oracle (p rounded to bf16, ATTN_BF16_REF_TOL)."""
    q, kc, vc, valid = _attn_inputs(2, 128, 8, 2, 64, seed=7)
    jq, tq = _pair(q[:, None], torch.bfloat16)
    jk, tk = _pair(kc, torch.bfloat16)
    jv, tv = _pair(vc, torch.bfloat16)
    ours = dattn.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    ref = jdecode_attention(jq, jk, jv, jnp.asarray(valid), interpret=True)
    oracle = jdecode_attention_ref(jq[:, 0], jk, jv, jnp.asarray(valid))
    assert ours.shape == (2, 1, 8, 64) and ours.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ours), _np(ref), atol=2e-2, rtol=0)
    np.testing.assert_allclose(_np(ours[:, 0]), _np(oracle),
                               **ATTN_BF16_REF_TOL)
    # the port's own oracle is the reference's
    np.testing.assert_allclose(
        _np(dattn.decode_attention_ref(tq[:, 0], tk, tv,
                                       torch.from_numpy(valid))),
        _np(oracle), atol=1e-2, rtol=0)


def test_decode_attention_tile_divisibility_and_counters():
    """T % block_t != 0 is refused, as the reference asserts it; the default
    block_t is the reference's; calls count, kernel launches stay 0 on the
    CPU; the CUDA wrapper refuses CPU tensors."""
    q, kc, vc, valid = map(torch.from_numpy, _attn_inputs(1, 96, 4, 2, 16, 8))
    with pytest.raises(ValueError, match="multiple of block_t"):
        dattn.decode_attention(q, kc, vc, valid, block_t=64)
    jargs = [jnp.asarray(a.numpy()) for a in (q, kc, vc, valid)]
    with pytest.raises(AssertionError):
        jdecode_attention(*jargs, block_t=64, interpret=True)
    assert [dattn.default_block_t(T) for T in (96, 2048, 600, 7)] == \
        [96, 512, 8, 7]
    reset_counts(dattn.decode_attention)
    dattn.decode_attention(q, kc, vc, valid)
    assert (dattn.decode_attention.calls,
            dattn.decode_attention.kernel_launches) == (1, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dattn.decode_attention_cuda(q, kc, vc, valid.int())
    assert "decode_attention" in build.all_kernels()


def test_decode_attention_dead_tiles_change_no_number():
    """Slots at or past valid hold garbage: the output does not move, and
    valid < 1 (every slot masked) gives the reference's uniform average."""
    q, kc, vc, _ = _attn_inputs(2, 128, 4, 1, 32, seed=9)
    valid = np.array([5, 70], np.int32)
    base = dattn.decode_attention(*map(torch.from_numpy, (q, kc, vc, valid)),
                                  block_t=32)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[0, 5:], vc2[0, 5:] = 1e3, -7.0
    kc2[1, 70:], vc2[1, 70:] = -1e3, 3.0
    moved = dattn.decode_attention(*map(torch.from_numpy,
                                        (q, kc2, vc2, valid)), block_t=32)
    assert torch.equal(moved, base)
    zero = np.zeros((2,), np.int32)
    ours, ref, _ = _both(q, kc, vc, zero, block_t=32)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **ATTN_TOL)


def test_decode_attention_splits_depend_on_the_shape_only():
    """The kernel's split of a ring across the CTAs of one cluster is a
    function of T: one of the cluster sizes the kernel takes, the largest
    that leaves each CTA two tiles of a full ring; 16 CTAs at the
    RecurrentGemma-2B ring (T = 2048).  It takes no batch, valid or head
    count, so a row is summed in the same order at every B."""
    got = {T: dattn.splits(T) for T in (2048, 4096, 1000, 256, 200, 128,
                                         96, 64, 7, 1)}
    for T, S in got.items():
        assert S in dattn.SPLITS
        assert T >= 2 * S * dattn.TILE or S == 1
        bigger = [s for s in dattn.SPLITS if s > S]
        assert all(T < 2 * s * dattn.TILE for s in bigger)
    assert list(got.values()) == [16, 16, 8, 4, 2, 2, 1, 1, 1, 1]


def _edge_valid(T):
    """valid at 0 (every slot masked), 1, 2, the first tile boundary of the
    kernel and one either side, the end of its first round of tiles (S
    tiles) and one either side, T - 1, T and past T: twelve rows."""
    R = dattn.splits(T) * dattn.TILE
    tile = dattn.TILE
    return np.array([0, 1, 2, tile - 1, tile, tile + 1, R - 1, R, R + 1,
                     T - 1, T, T + 5], np.int32)


@pytest.mark.parametrize("block_t", [0, 64])
def test_decode_attention_edge_valid_counts(block_t):
    """The plain version against the Pallas kernel (interpret) and its
    oracle at the valid counts that reach the kernel's tile and skip
    logic, one row each (T = 256: 4 CTAs of tiles of 32 slots)."""
    valid = _edge_valid(256)
    q, kc, vc, _ = _attn_inputs(len(valid), 256, 8, 2, 32, seed=15)
    ours, ref, oracle = _both(q, kc, vc, valid, block_t=block_t)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **ATTN_TOL)
    np.testing.assert_allclose(_np(ours), np.asarray(oracle), **ATTN_TOL)
    # valid = 0 is the average of v over every slot (p = 1 everywhere)
    avg = np.repeat(vc[0].mean(0), 4, axis=0)
    np.testing.assert_allclose(_np(ours[0]), avg, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,X,N,dtype", [
    (4, 2560, 7680, torch.bfloat16), (4, 7680, 2560, torch.bfloat16),
    (1, 2560, 512, torch.bfloat16), (3, 513, 129, torch.float32),
    (6, 100, 300, torch.float32)])
def test_cuda_mvm_matches_plain(cuda, B, X, N, dtype):
    """The kernel against its plain version on the card: fp32 within
    MVM_TOL; bf16 within one bf16 ulp of the largest output (2^-7
    relative: an fp32 sum near a rounding midpoint may round either
    way)."""
    x, W, b = _mvm_inputs(B, X, N, seed=11)
    x, W = torch.from_numpy(x).to(cuda, dtype), torch.from_numpy(W).to(
        cuda, dtype)
    b = torch.from_numpy(b).to(cuda)
    reset_counts(mvm_ops.mvm)
    out = mvm_ops.mvm(x, W, b)
    ref = mvm_ops.mvm_plain(x, W, b)
    torch.cuda.synchronize()
    assert mvm_ops.mvm.kernel_launches == 1 and out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, **MVM_TOL)
    else:
        ulp = 2 ** -7 * float(ref.float().abs().max())
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=ulp)


@pytest.mark.cuda
@pytest.mark.parametrize("X,N,dtype", [
    (2560, 7680, torch.bfloat16), (7680, 2560, torch.bfloat16),
    (2560, 2560, torch.bfloat16), (2560, 512, torch.bfloat16),
    (5, 129, torch.float32), (2561, 520, torch.bfloat16),
    (2561, 129, torch.float32), (5, 520, torch.bfloat16)])
def test_cuda_mvm_cluster_split_is_batch_invariant(cuda, X, N, dtype):
    """The cluster-split kernel at the decode step's projections and at
    the split's edges (X < S, ragged slices and stripes), B = 1..4: within
    its tolerance of the plain version (as above), two runs bit-equal, and
    each row bit-equal to the same row computed alone, since the order of
    summation depends on (X, N) only (``splits``)."""
    x, W, b = _mvm_inputs(4, X, N, seed=13)
    x, W = torch.from_numpy(x).to(cuda, dtype), torch.from_numpy(W).to(
        cuda, dtype)
    b = torch.from_numpy(b).to(cuda)
    alone = [mvm_ops.mvm(x[r:r + 1], W, b) for r in range(4)]
    for B in (1, 2, 3, 4):
        out = mvm_ops.mvm(x[:B], W, b)
        again = mvm_ops.mvm(x[:B], W, b)
        ref = mvm_ops.mvm_plain(x[:B], W, b)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert all(torch.equal(out[r], alone[r][0]) for r in range(B))
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, **MVM_TOL)
        else:
            ulp = 2 ** -7 * float(ref.float().abs().max())
            torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                       atol=ulp)


def test_mvm_splits_depend_on_the_shape_only():
    """The cluster size of the kernel's X-split is a function of (X, N):
    one of the sizes the kernel takes (each divides the stripe), the
    largest whose grid fits in one wave, and at the decode step's
    projections 2 (2560 x 7680: 240 CTAs), 8 (N = 2560: 320 CTAs) and 16
    (2560 x 512: 128 CTAs); X = 5 < S leaves CTAs with empty slices."""
    got = {}
    for X, N in ((2560, 7680), (7680, 2560), (2560, 2560), (2560, 512),
                 (5, 129), (2561, 520)):
        S = got[(X, N)] = mvm_ops.splits(X, N)
        stripes = -(-N // mvm_ops.STRIPE)
        assert S in mvm_ops.SPLITS and mvm_ops.STRIPE % S == 0
        assert stripes * S <= mvm_ops.ONE_WAVE or S == 1
        assert S == 16 or stripes * 2 * S > mvm_ops.ONE_WAVE
    assert list(got.values()) == [2, 8, 8, 16, 16, 16]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Hq,Hk,D,dtype", [
    (4, 2048, 10, 1, 256, torch.bfloat16), (2, 256, 8, 2, 64, torch.float32),
    (3, 64, 4, 4, 32, torch.float32), (2, 128, 6, 3, 20, torch.bfloat16)])
def test_cuda_decode_attention_matches_plain(cuda, B, T, Hq, Hk, D, dtype):
    """The kernel against its plain version on the card (fp32 ATTN_TOL;
    bf16: each (row, query head) within one bf16 ulp of that head's
    largest output, so a row of small outputs is held to its own scale)."""
    q, kc, vc, valid = _attn_inputs(B, T, Hq, Hk, D, seed=12)
    args = [torch.from_numpy(a).to(cuda, dtype) for a in (q, kc, vc)]
    valid = torch.from_numpy(valid).to(cuda)
    reset_counts(dattn.decode_attention)
    out = dattn.decode_attention(*args, valid)
    ref = dattn.decode_attention_plain(*args, valid,
                                       block_t=dattn.default_block_t(T))
    torch.cuda.synchronize()
    assert dattn.decode_attention.kernel_launches == 1
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, **ATTN_TOL)
    else:
        err = (out.float() - ref.float()).abs().amax(-1)
        limit = 2 ** -7 * ref.float().abs().amax(-1)
        assert bool((err <= limit).all()), (err / limit).max()


def _bf16_within_ulp(out, ref):
    """bf16: each (row, query head) within one bf16 ulp of that head's
    largest output."""
    err = (out.float() - ref.float()).abs().amax(-1)
    limit = 2 ** -7 * ref.float().abs().amax(-1)
    assert bool((err <= limit).all()), (err / limit).max()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Hq,Hk,D,dtype", [
    (4, 2048, 10, 1, 256, torch.bfloat16), (4, 256, 8, 2, 64, torch.float32),
    (4, 128, 6, 3, 20, torch.bfloat16)])
def test_cuda_decode_attention_edge_valid_counts(cuda, B, T, Hq, Hk, D,
                                                 dtype):
    """The kernel against its plain version at the edge valid counts
    (``_edge_valid``: 0, 1, 2, tile and round boundaries +- 1, T - 1, T,
    T + 5), as three calls of B = 4 rows and as one call per row (B = 1);
    one launch a call; each row bit-equal between its B = 4 and its B = 1
    call, and two runs bit-equal."""
    valid = torch.from_numpy(_edge_valid(T)).to(cuda)
    q, kc, vc, _ = _attn_inputs(len(valid), T, Hq, Hk, D, seed=16)
    q, kc, vc = (torch.from_numpy(a).to(cuda, dtype) for a in (q, kc, vc))
    bt = dattn.default_block_t(T)
    for lo in range(0, len(valid), B):
        rows = slice(lo, lo + B)
        args = (q[rows], kc[rows], vc[rows], valid[rows])
        reset_counts(dattn.decode_attention)
        out = dattn.decode_attention(*args)
        assert dattn.decode_attention.kernel_launches == 1
        again = dattn.decode_attention(*args)
        ref = dattn.decode_attention_plain(*args, block_t=bt)
        alone = [dattn.decode_attention(*(a[r:r + 1] for a in args))
                 for r in range(B)]
        torch.cuda.synchronize()
        assert dattn.decode_attention.kernel_launches == 2 + B
        assert torch.equal(out, again)
        assert all(torch.equal(out[r], alone[r][0]) for r in range(B))
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, **ATTN_TOL)
        else:
            _bf16_within_ulp(out, ref)


@pytest.mark.cuda
def test_cuda_decode_attention_graph_replay_is_the_eager_call(cuda):
    """A CUDA graph's replay of the kernel (as the decode step runs it)
    gives the eager call's output bit for bit, and counts one launch at
    capture."""
    B, T, Hq, Hk, D = 4, 2048, 10, 1, 256
    q, kc, vc, _ = _attn_inputs(B, T, Hq, Hk, D, seed=17)
    q, kc, vc = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                 for a in (q, kc, vc))
    valid = torch.tensor([70, 129, 1, 2048], dtype=torch.int32, device=cuda)
    eager = dattn.decode_attention(q, kc, vc, valid)
    torch.cuda.synchronize()
    reset_counts(dattn.decode_attention)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dattn.decode_attention(q, kc, vc, valid)
    assert dattn.decode_attention.kernel_launches == 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
