"""The port's LSTM kernel entry points (repro_torch.kernels.lstm_cell)
against the JAX package's (repro.kernels.lstm_cell, Pallas interpret mode)
on the CPU, plus the port's own bit-identities.

On the CPU the entry points run the kernels' plain PyTorch versions; the
CUDA kernels themselves are held against those on the card by the
``cuda``-marked tests here and by chip_smoke.py.

Tolerances: fp32 parity is 1e-5 absolute (the two packages sum the h·U
products in a different order); anything with bfloat16 activations is
2e-2 (one bf16 rounding of h, |h| < 1, is up to 2^-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell import ops as jops
from repro_torch.kernels import build as kernel
from repro_torch.kernels import common
from repro_torch.kernels.common import KernelBuildError, reset_counts
from repro_torch.kernels.lstm_cell import ops

FP32_TOL = 1e-5
BF16_TOL = 2e-2

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype`` (the
    bf16 rounding happens once, in JAX, and carries over exactly)."""
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _torch(pairs):
    return [t for _, t in pairs]


def _seq_inputs(G, B, T, H, u_dtype, act_dtype, seed):
    rng = np.random.default_rng(seed)
    lead = (G,) if G else ()
    U4 = _both(_rand(rng, lead + (H, 4, H), 0.2), u_dtype)
    xw = _both(_rand(rng, lead + (B, T, 4, H), 1.0), act_dtype)
    h0 = _both(_rand(rng, lead + (B, H), 0.5), act_dtype)
    c0 = _both(_rand(rng, lead + (B, H), 0.5), "float32")
    return U4, xw, h0, c0


@pytest.mark.parametrize("G,B,T,block_t,b_valid", [
    (0, 1, 1, 0, None),          # unstacked, one step
    (0, 3, 7, 3, None),          # unstacked, remainder chunk (7 = 3+3+1)
    (2, 4, 9, 4, (4, 2)),        # stacked, ragged b_valid, remainder
    (3, 2, 5, 0, None),          # stacked, autotuned stripe
])
@pytest.mark.parametrize("u_dtype,act_dtype", [
    ("float32", "float32"),
    ("bfloat16", "float32"),     # the serving path: bf16 U, fp32 xw and h
    ("float32", "bfloat16"),
    ("bfloat16", "bfloat16"),
])
def test_lstm_seq_matches_reference(G, B, T, block_t, b_valid, u_dtype,
                                    act_dtype):
    H = 24
    (Uj, Ut), (xj, xt), (hj, ht), (cj, ct) = _seq_inputs(
        G, B, T, H, u_dtype, act_dtype, seed=G * 100 + B * 10 + T)
    kw = {} if b_valid is None else {"b_valid": b_valid}
    ref = jops.lstm_seq(Uj, xj, hj, cj, block_t=block_t, interpret=True,
                        **({} if b_valid is None else
                           {"b_valid": jnp.asarray(b_valid)}))
    out = ops.lstm_seq(Ut, xt, ht, ct, block_t=block_t, **kw)
    tol = FP32_TOL if act_dtype == "float32" else BF16_TOL
    for r, o, name in zip(ref, out, ("hs", "h_T", "c_T")):
        assert o.shape == tuple(r.shape), name
        np.testing.assert_allclose(_np(o), _np(r), atol=tol, err_msg=name)
    assert out[0].dtype == out[1].dtype == TDT[act_dtype]
    assert out[2].dtype == torch.float32


@pytest.mark.parametrize("give", ["h0", "c0", "none"])
def test_lstm_seq_zero_state_defaults_are_independent(give):
    (Uj, Ut), (xj, xt), (hj, ht), (cj, ct) = _seq_inputs(
        0, 2, 6, 16, "float32", "float32", seed=5)
    jkw = {"h0": hj} if give == "h0" else {"c0": cj} if give == "c0" else {}
    tkw = {"h0": ht} if give == "h0" else {"c0": ct} if give == "c0" else {}
    ref = jops.lstm_seq(Uj, xj, interpret=True, **jkw)
    out = ops.lstm_seq(Ut, xt, **tkw)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(_np(o), _np(r), atol=FP32_TOL)


@pytest.mark.parametrize("G", [0, 2])
def test_lstm_seq_t0_passes_state_through(G):
    (Uj, Ut), (xj, xt), (hj, ht), (cj, ct) = _seq_inputs(
        G, 3, 0, 8, "float32", "bfloat16", seed=1)
    ref = jops.lstm_seq(Uj, xj, hj, cj, interpret=True)
    hs, h_n, c_n = ops.lstm_seq(Ut, xt, ht, ct)
    assert hs.shape == tuple(ref[0].shape) and hs.dtype == torch.bfloat16
    assert torch.equal(h_n, ht)
    assert torch.equal(c_n, ct) and c_n.dtype == torch.float32


def test_b_valid_requires_stacked_form():
    U4, xw, _, _ = _torch(_seq_inputs(0, 2, 3, 8, "float32", "float32", 0))
    with pytest.raises(ValueError, match="stacked"):
        ops.lstm_seq(U4, xw, b_valid=[1])


def test_chunked_walk_equals_single_launch_fp32():
    """fp32: chaining chunks through h_T/c_T is bit-identical to one
    launch over the whole sequence (h never leaves fp32)."""
    U4, xw, h0, c0 = _torch(_seq_inputs(
        2, 3, 11, 20, "float32", "float32", seed=9))
    hs, h_n, c_n = ops.lstm_seq(U4, xw, h0, c0, block_t=11)
    outs, h, c = [], h0, c0
    for t0, t1 in ((0, 4), (4, 8), (8, 11)):
        o, h, c = ops.lstm_seq(U4, xw[:, :, t0:t1], h, c, block_t=t1 - t0)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, dim=2), hs, rtol=0, atol=0)
    torch.testing.assert_close(h, h_n, rtol=0, atol=0)
    torch.testing.assert_close(c, c_n, rtol=0, atol=0)


def test_padded_rows_are_exact_noops():
    """Ragged-B: rows >= b_valid[g] pass their state through, and valid
    rows are bit-identical to a launch without the padding."""
    U4, xw, h0, c0 = _torch(_seq_inputs(
        2, 4, 6, 16, "bfloat16", "float32", seed=3))
    hs, h_n, c_n = ops.lstm_seq(U4, xw, h0, c0, b_valid=[4, 2])
    torch.testing.assert_close(h_n[1, 2:], h0[1, 2:], rtol=0, atol=0)
    torch.testing.assert_close(c_n[1, 2:], c0[1, 2:], rtol=0, atol=0)
    torch.testing.assert_close(hs[1, 2:],
                               h0[1, 2:, None].expand(2, 6, 16),
                               rtol=0, atol=0)
    solo = ops.lstm_seq(U4[1], xw[1, :2], h0[1, :2], c0[1, :2])
    for full, s in zip((hs, h_n, c_n), solo):
        torch.testing.assert_close(full[1, :2], s, rtol=0, atol=0)


def _decode_inputs(L, B, H, w_dtype, act_dtype, seed):
    rng = np.random.default_rng(seed)
    W0 = _rand(rng, (H, 4, H), 0.2)
    W0[:] = np.nan  # Ws[0] is never read by either package
    Ws = np.concatenate([W0[None], _rand(rng, (L - 1, H, 4, H), 0.2)])
    return (_both(_rand(rng, (B, 4, H), 1.0), act_dtype),
            _both(Ws, w_dtype),
            _both(_rand(rng, (L, 4, H), 0.1), w_dtype),
            _both(_rand(rng, (L, H, 4, H), 0.2), w_dtype),
            _both(_rand(rng, (L, B, H), 0.5), act_dtype),
            _both(_rand(rng, (L, B, H), 0.5), "float32"))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("w_dtype,act_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("float32", "bfloat16"), ("bfloat16", "bfloat16")])
def test_lstm_decode_matches_reference(B, w_dtype, act_dtype):
    args = _decode_inputs(3, B, 24, w_dtype, act_dtype, seed=B)
    ref = jops.lstm_decode(*(j for j, _ in args), interpret=True)
    out = ops.lstm_decode(*(t for _, t in args))
    tol = FP32_TOL if act_dtype == "float32" else BF16_TOL
    for r, o, name in zip(ref, out, ("h_n", "c_n")):
        assert o.shape == tuple(r.shape)
        np.testing.assert_allclose(_np(o), _np(r), atol=tol, err_msg=name)
    assert out[0].dtype == TDT[act_dtype] and out[1].dtype == torch.float32


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_chained_decode_equals_per_layer_loop(w_dtype):
    """fp32 activations (the serving path): one chained tick equals L
    per-layer T=1 sequence calls with the input GEMM chained between
    them, bit for bit."""
    args = [t for _, t in _decode_inputs(4, 3, 16, w_dtype, "float32",
                                         seed=11)]
    xw0, Ws, bs, Us, h0, c0 = args
    h_n, c_n = ops.lstm_decode(*args)
    xw, hs, cs = xw0, [], []
    for l in range(4):
        if l:
            y = hs[-1].float()
            xw = (y @ Ws[l].reshape(16, 64).float()
                  + bs[l].reshape(64).float()).reshape(3, 4, 16)
        _, h, c = ops.lstm_seq(Us[l], xw[:, None], h0[l], c0[l], block_t=1)
        hs.append(h)
        cs.append(c)
    torch.testing.assert_close(torch.stack(hs), h_n, rtol=0, atol=0)
    torch.testing.assert_close(torch.stack(cs), c_n, rtol=0, atol=0)


def decode_slices(H: int, gates: int):
    """The hidden units [lo, hi) each CTA of a decode kernel's cluster
    owns, by rank: the decode_unit_align(H) unit groups split as evenly
    as integer division does it (``slice`` in csrc/decode_cluster.cuh)."""
    A = common.decode_unit_align(H)
    n, S = H // A, ops.decode_splits(H, gates)
    return tuple((r * n // S * A, (r + 1) * n // S * A) for r in range(S))


@pytest.mark.parametrize("gates", [4, 3])
def test_decode_splits_depend_on_the_shape_only(gates):
    """The decode kernels' cluster split is a function of (H, gates): a
    cluster size the kernel takes, the fewest whose slices hold at most
    DECODE_SLICE_COLS gate columns (16 at the paper's H = 340 and 1024);
    the slices cover every hidden unit exactly once, in rank order, each
    starting and ending on a multiple of the unit alignment the kernel's
    vector loads need (8 units when H % 8 == 0, 4 when H % 4 == 0).  It
    takes no batch size."""
    import inspect

    assert list(inspect.signature(ops.decode_splits).parameters) == [
        "H", "gates"]
    for H in (1, 5, 10, 24, 50, 72, 100, 256, 340, 1000, 1024, 1536, 2048):
        S = ops.decode_splits(H, gates)
        A = common.decode_unit_align(H)
        assert S & (S - 1) == 0 and S <= common.DECODE_MAX_SPLITS
        assert S <= H // A
        slices = decode_slices(H, gates)
        assert len(slices) == S and slices[0][0] == 0 and slices[-1][1] == H
        for (lo, hi), (nxt, _) in zip(slices, slices[1:] + ((H, H),)):
            assert lo < hi == nxt and lo % A == 0 and hi % A == 0
        widest = max(hi - lo for lo, hi in slices)
        cap = min(common.DECODE_MAX_SPLITS, H // A)
        assert gates * widest <= common.DECODE_SLICE_COLS or S == cap
        groups = H // A
        assert S == 1 or (gates * -(-groups // (S // 2)) * A
                          > common.DECODE_SLICE_COLS)
        assert widest <= 128  # one cell a thread at 4 rows
    assert ops.decode_splits(340, gates) == ops.decode_splits(1024, gates) \
        == 16
    assert common.decode_unit_align(340) == 4
    for H in (0, common.DECODE_MAX_H + 1):
        with pytest.raises(ValueError, match="2048"):
            ops.decode_splits(H, gates)


SEQ_WIDTHS = (1, 5, 8, 10, 24, 50, 72, 100, 256, 340, 1000, 1024, 1536,
              2047, 2048)


def seq_slices(H: int, gates: int, u_bytes: int, Hr: int):
    """The hidden units [lo, hi) each CTA of a sequence kernel's cluster
    owns, by rank (``slice`` in csrc/cluster.cuh, as ``decode_slices``)."""
    A = common.decode_unit_align(H)
    n, S = H // A, common.seq_splits(H, gates, u_bytes, Hr)
    return tuple((r * n // S * A, (r + 1) * n // S * A) for r in range(S))


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("u_bytes", [4, 2, 1])
def test_seq_splits_cover_the_units_in_aligned_disjoint_slices(gates,
                                                               u_bytes):
    """The sequence kernels' clusters: S CTAs (a power of two, at most 16)
    whose slices cover every hidden unit exactly once, in rank order,
    each on a multiple of the unit alignment (8, 4 or 1 units), and each
    narrow enough that its 4 rows' cells take one of a CTA's 512 threads
    each."""
    for H in SEQ_WIDTHS:
        for Hr in sorted({H, max(1, H * 3 // 4), 1}):
            S = common.seq_splits(H, gates, u_bytes, Hr)
            A = common.decode_unit_align(H)
            assert S & (S - 1) == 0 and 1 <= S <= common.DECODE_MAX_SPLITS
            slices = seq_slices(H, gates, u_bytes, Hr)
            assert len(slices) == S and slices[0][0] == 0
            assert slices[-1][1] == H
            for (lo, hi), (nxt, _) in zip(slices, slices[1:] + ((H, H),)):
                assert lo < hi == nxt and lo % A == 0 and hi % A == 0
                assert 4 * (hi - lo) <= 512


def test_seq_splits_depend_on_the_shape_only():
    """S and the shared memory a CTA takes are functions of (H, gates, U's
    element size, Hr) alone -- no batch, recurrence count or T -- so each
    output's fp32 sum order and the copy of U are the same at every B; S
    is the decode kernels' split of (H, gates), 16 at the paper's H = 340
    and 1024 and at the sweep's 2048."""
    import inspect

    for fn in (common.seq_splits, common.seq_smem):
        assert list(inspect.signature(fn).parameters) == [
            "H", "gates", "u_bytes", "Hr"]
    for gates in (4, 3):
        for H in SEQ_WIDTHS:
            for u_bytes in (4, 2, 1):
                assert common.seq_splits(H, gates, u_bytes, H) \
                    == ops.decode_splits(H, gates)
        for H in (340, 1024, 2048):
            assert common.seq_splits(H, gates, 4, H) == 16


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("u_bytes", [4, 2, 1])
def test_seq_plan_stays_within_the_cards_shared_memory(gates, u_bytes):
    """Every plan fits the 232,448 bytes of shared memory a CTA may opt in
    to: the rows index, the two h buffers and the partials at 4 rows, the
    rings when U streams, and its resident U.  At the paper's H = 340 the
    widest slice of U is resident whole in every type; at H = 1024 and
    2048 it cannot be, so part of it streams."""
    for H in SEQ_WIDTHS:
        for Hr in sorted({H, max(1, H * 3 // 4)}):
            assert 0 < common.seq_smem(H, gates, u_bytes, Hr) \
                <= common.SEQ_MAX_SMEM

    def whole(H):
        """The widest slice of U, the two fp32 h buffers of 4 rows and at
        least one fp32 partial a thread and row."""
        nu = max(hi - lo for lo, hi in seq_slices(H, gates, u_bytes, H))
        return gates * nu * H * u_bytes + 4 * (2 * 4 * H + 512 * 4)

    assert common.seq_smem(340, gates, u_bytes, 340) >= whole(340)
    for H in (1024, 2048):
        assert whole(H) > common.SEQ_MAX_SMEM


def test_seq_splits_raise_past_the_kernels_limit():
    """The sequence kernels take 1 <= H <= 2048 (the paper's sweep
    maximum) and 0 <= Hr <= H; beyond, seq_splits (which the CUDA wrappers
    call before launching) raises a ValueError naming the limit."""
    for H in (0, 2049, 4096):
        with pytest.raises(ValueError, match="2048"):
            common.seq_splits(H, 4, 4, max(H, 1))
    with pytest.raises(ValueError, match="Hr"):
        common.seq_smem(64, 3, 2, 65)


@pytest.mark.parametrize("H,B", [(72, 1), (72, 5), (50, 3)])
@pytest.mark.parametrize("w_dtype,act_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_lstm_decode_matches_reference_at_cluster_widths(H, B, w_dtype,
                                                         act_dtype):
    """The plain version against the JAX kernel at widths the card splits
    over several CTAs (H = 72: 8 slices of 8 or 16 units) and at one whose
    slices take plain loads (H = 50)."""
    assert ops.decode_splits(H, 4) > 1
    args = _decode_inputs(3, B, H, w_dtype, act_dtype, seed=H + B)
    ref = jops.lstm_decode(*(j for j, _ in args), interpret=True)
    out = ops.lstm_decode(*(t for _, t in args))
    tol = FP32_TOL if act_dtype == "float32" else BF16_TOL
    for r, o, name in zip(ref, out, ("h_n", "c_n")):
        np.testing.assert_allclose(_np(o), _np(r), atol=tol, err_msg=name)


def test_counters_count_calls_not_launches_on_cpu():
    reset_counts(ops.lstm_seq, ops.lstm_decode)
    U4, xw, h0, c0 = _torch(_seq_inputs(
        0, 1, 3, 8, "float32", "float32", seed=0))
    for _ in range(3):
        ops.lstm_seq(U4, xw, h0, c0)
    args = [t for _, t in _decode_inputs(2, 1, 8, "float32", "float32",
                                         seed=0)]
    ops.lstm_decode(*args)
    assert (ops.lstm_seq.calls, ops.lstm_seq.kernel_launches) == (3, 0)
    assert (ops.lstm_decode.calls, ops.lstm_decode.kernel_launches) == (1, 0)


def test_quantized_and_sparse_weights_are_not_ported():
    """int8 (u_scales) and row-compacted (u_rows) U through lstm_seq equal
    the dense plain version on the dequantized, re-expanded weights, to
    fp32 reduction order (1e-6)."""
    from repro_torch.kernels import quant

    U4, xw, _, _ = _torch(_seq_inputs(
        0, 2, 5, 16, "float32", "float32", seed=0))
    q, s = quant.quantize_per_gate(U4)
    Uc, rows = quant.compact_rows(q, (1, 0))
    got = ops.lstm_seq(Uc, xw, u_scales=s, u_rows=rows)
    dense = quant.expand_rows(quant.dequantize_per_gate(Uc, s), rows, 16)
    for a, b in zip(got, ops.lstm_seq(dense, xw)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_build_without_nvcc_raises_build_error(monkeypatch, tmp_path):
    """A kernel build that cannot run raises KernelBuildError (never a
    silent fallback); the sources are hashed into the library's name."""
    monkeypatch.setattr(kernel, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel.shutil, "which", lambda _: None)
    monkeypatch.setattr(kernel.os.path, "exists", lambda _: False)
    with pytest.raises(KernelBuildError, match="nvcc"):
        kernel.build("lstm_seq")
    assert kernel.library_path("lstm_seq").name.startswith("lstm_seq-")


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def assert_seq_bits(seq, U, xw, state, out, b_valid, fp32_h):
    """A sequence kernel's fixed sum order, bit for bit: each valid row of
    ``out`` (a b_valid call) equals that row's B=1 call; with fp32 h, a
    walk chunked 4+4+1 through the state equals the whole launch."""
    for g, n in enumerate(b_valid):
        for b in range(n):
            solo = seq(U[g], xw[g, b:b + 1], *(t[g, b:b + 1] for t in state))
            for o, s in zip(out, solo):
                torch.testing.assert_close(o[g, b:b + 1], s, rtol=0, atol=0)
    if fp32_h:
        full = seq(U, xw, *state)
        outs, cur = [], list(state)
        for t0 in (0, 4, 8):
            o, *cur = seq(U, xw[:, :, t0:t0 + 4], *cur, block_t=4)
            outs.append(o)
        for a, b in zip([torch.cat(outs, 2)] + cur, full):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def cuda_seq_scale(H: int) -> float:
    """What the card tests of the sequence kernels scale U by at H: past
    H = 340, to H = 340's recurrent gain, where the fp32 plain version is
    a reference to 1e-5 of an fp64 walk; at 0.2 a weight and H = 1024 it
    is not (test_torch_gru's test_seq_plain_fp32_walk_against_fp64)."""
    return min(1.0, (340 / H) ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [340, 1024])
@pytest.mark.parametrize("u_dtype,act_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_cuda_lstm_seq_matches_plain(cuda, H, u_dtype, act_dtype):
    """Within 1e-4 (fp32 activations) or 2e-2 (bf16) of the plain version
    at H = 340 (U resident in the cluster's shared memory) and 1024 (U
    streamed); rows bit-equal to their B=1 calls; with fp32 h, a chunked
    walk bit-equal to one launch.  U is scaled by ``cuda_seq_scale``."""
    U4, xw, h0, c0 = _torch(_seq_inputs(
        3, 5, 9, H, u_dtype, act_dtype, seed=2))
    U4, xw, h0, c0 = (t.to(cuda) for t in (U4, xw, h0, c0))
    U4 = (U4.float() * cuda_seq_scale(H)).to(U4.dtype)
    mask = torch.tensor([[1] * 5, [1, 1, 0, 0, 0], [1] * 5],
                        dtype=torch.int32, device=cuda)
    ref = ops.lstm_seq_plain(U4, xw, h0, c0, mask)
    out = ops.lstm_seq(U4, xw, h0, c0, b_valid=[5, 2, 5])
    tol = 1e-4 if act_dtype == "float32" else BF16_TOL
    for r, o in zip(ref, out):
        torch.testing.assert_close(o.float(), r.float(), rtol=0, atol=tol)
    assert_seq_bits(ops.lstm_seq, U4, xw, (h0, c0), out, [5, 2, 5],
                    act_dtype == "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("H", [340, 1024, 50])
@pytest.mark.parametrize("B", [1, 4, 5])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_cuda_lstm_decode_matches_plain(cuda, H, B, w_dtype):
    args = [t.to(cuda) for _, t in _decode_inputs(5, B, H, w_dtype,
                                                  "float32", seed=4)]
    ref = ops.lstm_decode_plain(*args)
    out = ops.lstm_decode(*args)
    for r, o in zip(ref, out):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-4)


def _cuda_decode_args(cuda, H, B=4, u_dtype=None, act_dtype="float32"):
    args = [t.to(cuda) for _, t in _decode_inputs(3, B, H, "bfloat16",
                                                  act_dtype, seed=H)]
    if u_dtype:
        args[3] = args[3].to(TDT[u_dtype])
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("H", [340, 1024, 50])
def test_cuda_lstm_decode_rows_are_batch_and_run_invariant(cuda, H):
    """Each output is summed in an order set by (H, gates) alone: a row of
    a B = 4 call equals its B = 1 call bit for bit, and two runs agree."""
    args = _cuda_decode_args(cuda, H)
    out = ops.lstm_decode(*args)
    again = ops.lstm_decode(*args)
    for r in range(4):
        row = [args[0][r:r + 1], *args[1:4]] + [t[:, r:r + 1].contiguous()
                                               for t in args[4:]]
        for o, x in zip(out, ops.lstm_decode(*row)):
            assert torch.equal(o[:, r], x[:, 0])
    for o, x in zip(out, again):
        assert torch.equal(o, x)


@pytest.mark.cuda
@pytest.mark.parametrize("u_dtype,act_dtype", [
    ("float32", "float32"), (None, "bfloat16")])
def test_cuda_lstm_decode_operand_forms(cuda, u_dtype, act_dtype):
    """fp32 U under bf16 W (the fake-quantized recurrent weights) and bf16
    state, against the plain version."""
    args = _cuda_decode_args(cuda, 340, B=5, u_dtype=u_dtype,
                             act_dtype=act_dtype)
    tol = 1e-4 if act_dtype == "float32" else BF16_TOL
    for r, o in zip(ops.lstm_decode_plain(*args), ops.lstm_decode(*args)):
        torch.testing.assert_close(o.float(), r.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_lstm_decode_graph_replay_equals_eager_and_one_launch(cuda):
    """A call is one cluster launch, and a CUDA graph's replay of it is
    the eager call bit for bit; the kernel's own split is decode_splits'."""
    args = _cuda_decode_args(cuda, 340)
    reset_counts(ops.lstm_decode)
    eager = ops.lstm_decode(*args)
    torch.cuda.synchronize()
    assert ops.lstm_decode.kernel_launches == ops.lstm_decode.calls == 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.lstm_decode(*args)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b)
    for H in (340, 1024, 50):
        S, clusters = common.decode_clusters("lstm", 4, H)
        assert S == ops.decode_splits(H, 4) and clusters > 0


def test_launched_raises_the_error_it_is_given():
    """A C entry point's nonzero return raises: a RuntimeError by default,
    the decode kernels' refused configuration as KernelLaunchRefused,
    which the guarded execution ladder re-raises."""
    common.launched("k", 0, common.KernelLaunchRefused)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        common.launched("k", 1)
    with pytest.raises(common.KernelLaunchRefused, match="cudaError 912"):
        common.launched("k", 912, common.KernelLaunchRefused)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The launch wrappers check their operands before touching a
    pointer: CPU tensors never reach the kernel."""
    U4, xw, h0, c0 = _torch(_seq_inputs(1, 1, 2, 8, "float32", "float32",
                                        seed=0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lstm_seq_cuda(U4, xw, h0, c0)
    args = _torch(_decode_inputs(2, 1, 8, "float32", "float32", seed=0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lstm_decode_cuda(*args)
