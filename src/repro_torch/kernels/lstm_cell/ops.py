"""Public entry points of the fused LSTM kernels: ``lstm_seq`` (a whole
sequence, G recurrences, one launch), ``lstm_decode`` (one T=1 tick
through an L-layer stack, one launch) and ``lstm_cell`` (one recurrent
step, one launch — the per_step schedule's kernel), plus the
``as_cell_kernel`` / ``as_seq_kernel`` adapters the reference schedules
plug them in with.

The device of the tensors decides how an entry point runs: on the CPU it
runs the kernel's plain PyTorch version beside it in this module
(``lstm_seq_plain`` / ``lstm_decode_plain`` / ``lstm_cell_plain``, which
repeat the kernel's arithmetic and rounding points); on a CUDA device it
launches the hand-written kernel (``csrc/lstm_seq.cu`` /
``csrc/lstm_decode.cu`` / ``csrc/lstm_cell.cu``) or raises.  There is no
fallback from one to the other.

Each entry point carries two counters (``kernels.common.counted``):
``calls`` (every invocation, any device) and ``kernel_launches`` (real
CUDA launches only).
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import table
from repro_torch.kernels.common import (KernelLaunchRefused,
                                        check_operands, check_shape,
                                        count_launch, counted, decode_splits,
                                        decode_u, dtype_flag, gather_index,
                                        launched, on_cuda, operand, ptr,
                                        ragged_b_mask, recurrent_product,
                                        seq_limit, seq_splits, seq_variant,
                                        weight_operands)
from repro_torch.kernels.lstm_cell import kernel
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref, lstm_seq_ref


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; held against the kernels on the card)
# ---------------------------------------------------------------------------


def lstm_seq_plain(U4, xw, h0, c0, b_mask=None, u_scales=None,
                   u_rows=None):
    """The sequence kernel's arithmetic in plain PyTorch (stacked form).

    U4 (G,Hr,4,H); xw (G,B,T,4,H); h0 (G,B,H); c0 (G,B,H); b_mask (G,B)
    int32 or None.  U is upcast to fp32 before the product; h and c are
    carried in fp32 across all T steps and h is rounded to h0's dtype only
    in ``hs`` and ``h_T``; a row with b_mask == 0 freezes h and c.
    ``u_scales`` (G,4): U4 is int8 and the per-gate scale multiplies the
    fp32 accumulate before xw is added; ``u_rows`` (G,Ha) int32: U4 holds
    Hr = Ha compacted rows and h is gathered to them."""
    G, B, T, _, H = xw.shape
    U = U4.reshape(G, U4.shape[1], 4 * H).float()
    h, c = h0.float(), c0.float()
    rows = gather_index(u_rows, B)
    keep = None if b_mask is None else (b_mask != 0)[..., None]
    ys = []
    for t in range(T):
        gates = xw[:, :, t].float() + recurrent_product(h, U, 4, u_scales,
                                                        rows)
        i = torch.sigmoid(gates[:, :, 0])
        f = torch.sigmoid(gates[:, :, 1])
        g = torch.tanh(gates[:, :, 2])
        o = torch.sigmoid(gates[:, :, 3])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if keep is None:
            h, c = h_new, c_new
        else:
            h = torch.where(keep, h_new, h)
            c = torch.where(keep, c_new, c)
        ys.append(h)
    return torch.stack(ys, dim=2).to(h0.dtype), h.to(h0.dtype), c


def lstm_decode_plain(xw0, Ws, bs, Us, h0, c0):
    """The decode kernel's arithmetic in plain PyTorch, with its two
    rounding points: a deeper layer's input GEMM y·W_l is accumulated in
    fp32 and rounded to xw_dtype = promote(h0.dtype, Ws.dtype), then b_l
    (cast to xw_dtype) is added in xw_dtype; the inter-layer value y is h
    rounded through h0's dtype.  Ws[0] is never read."""
    L, B, H = h0.shape
    xw_dtype = torch.promote_types(h0.dtype, Ws.dtype)
    hn, cn = [], []
    y = None
    for l in range(L):
        if l == 0:
            xw = xw0.float()
        else:
            xw = (y @ Ws[l].reshape(H, 4 * H).float()).to(xw_dtype)
            xw = (xw + bs[l].reshape(4 * H).to(xw_dtype)).float()
            xw = xw.reshape(B, 4, H)
        gates = xw + (h0[l].float() @ Us[l].reshape(H, 4 * H).float()
                      ).reshape(B, 4, H)
        i = torch.sigmoid(gates[:, 0])
        f = torch.sigmoid(gates[:, 1])
        g = torch.tanh(gates[:, 2])
        o = torch.sigmoid(gates[:, 3])
        c = f * c0[l].float() + i * g
        h = (o * torch.tanh(c)).to(h0.dtype)
        y = h.float()
        hn.append(h)
        cn.append(c)
    return torch.stack(hn), torch.stack(cn)


#: The cell kernel's arithmetic in plain PyTorch is the oracle's: one fp32
#: product h·U (the kernel's split of the rows only reorders its fp32
#: sum), the gate and cell epilogue in fp32, h out in h_prev's dtype and c
#: in fp32.
lstm_cell_plain = lstm_cell_ref


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------


def lstm_seq_cuda(U4, xw, h0, c0, b_mask=None, u_scales=None,
                  u_rows=None):
    """Launch ``csrc/lstm_seq.cu`` (stacked form, T >= 1) on the current
    stream; shapes and dtypes as ``lstm_seq_plain``, c0 fp32, U4 fp32,
    bf16 or (with u_scales) int8, u_rows int32."""
    G, B, T, _, H = xw.shape
    seq_limit("lstm_seq", H)  # before any other check: a refusal
    dev = xw.device
    check_operands("lstm_seq", dev, U4=U4, xw=xw, h0=h0, c0=c0,
                   b_mask=b_mask, u_scales=u_scales, u_rows=u_rows)
    Hr, u_type = weight_operands("lstm_seq", U4, u_scales, u_rows, G, H, 4)
    seq_splits(H, 4, U4.element_size(), Hr)
    check_shape("lstm_seq", "h0", h0, (G, B, H))
    check_shape("lstm_seq", "c0", c0, (G, B, H))
    if c0.dtype != torch.float32:
        raise TypeError("lstm_seq: c0 must be float32")
    if b_mask is not None:
        check_shape("lstm_seq", "b_mask", b_mask, (G, B))
        if b_mask.dtype != torch.int32:
            raise TypeError("lstm_seq: b_mask must be int32")
    flags = (u_type, dtype_flag("lstm_seq", "xw", xw),
             dtype_flag("lstm_seq", "h0", h0))
    hs = torch.empty((G, B, T, H), dtype=h0.dtype, device=dev)
    h_n = torch.empty((G, B, H), dtype=h0.dtype, device=dev)
    c_n = torch.empty((G, B, H), dtype=torch.float32, device=dev)
    launch = kernel.entry("lstm_seq")
    with torch.cuda.device(dev):
        rc = launch(U4.data_ptr(), ptr(u_scales), ptr(u_rows),
                    xw.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                    ptr(b_mask), hs.data_ptr(), h_n.data_ptr(),
                    c_n.data_ptr(), G, B, T, H, Hr, *flags,
                    torch.cuda.current_stream(dev).cuda_stream)
    launched("lstm_seq", rc, KernelLaunchRefused)
    count_launch(lstm_seq, seq_variant(u_scales, u_rows))
    return hs, h_n, c_n


def lstm_decode_cuda(xw0, Ws, bs, Us, h0, c0):
    """Launch ``csrc/lstm_decode.cu`` on the current stream; shapes and
    dtypes as ``lstm_decode_plain``, Ws/bs in one dtype, Us in Ws's or
    (under bf16 Ws) fp32, c0 fp32."""
    L, B, H = h0.shape
    dev = h0.device
    check_operands("lstm_decode", dev, xw0=xw0, Ws=Ws, bs=bs, Us=Us, h0=h0,
                   c0=c0)
    check_shape("lstm_decode", "xw0", xw0, (B, 4, H))
    check_shape("lstm_decode", "Ws", Ws, (L, H, 4, H))
    check_shape("lstm_decode", "bs", bs, (L, 4, H))
    check_shape("lstm_decode", "Us", Us, (L, H, 4, H))
    check_shape("lstm_decode", "c0", c0, (L, B, H))
    if c0.dtype != torch.float32:
        raise TypeError("lstm_decode: c0 must be float32")
    if Ws.dtype != bs.dtype:
        raise TypeError(f"lstm_decode: Ws and bs must share one dtype, "
                        f"got {Ws.dtype}, {bs.dtype}")
    flags = (dtype_flag("lstm_decode", "Ws", Ws),
             dtype_flag("lstm_decode", "Us", Us),
             dtype_flag("lstm_decode", "xw0", xw0),
             dtype_flag("lstm_decode", "h0", h0))
    if flags[1] and not flags[0]:
        raise TypeError(f"lstm_decode: bfloat16 Us under float32 Ws; the "
                        "entry point upcasts such a U")
    h_n = torch.empty((L, B, H), dtype=h0.dtype, device=dev)
    c_n = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    launch = kernel.entry("lstm_decode")
    with torch.cuda.device(dev):
        rc = launch(xw0.data_ptr(), Ws.data_ptr(), bs.data_ptr(),
                    Us.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                    h_n.data_ptr(), c_n.data_ptr(), L, B, H, *flags,
                    torch.cuda.current_stream(dev).cuda_stream)
    launched("lstm_decode", rc, KernelLaunchRefused)
    count_launch(lstm_decode)
    return h_n, c_n


def lstm_cell_cuda(U4, xw_t, h_prev, c_prev, block_h: int, block_k: int):
    """Launch ``csrc/lstm_cell.cu`` on the current stream; shapes and
    dtypes as ``lstm_cell_plain``, c_prev fp32.  ``block_h`` and
    ``block_k`` are the TPU kernel's tile: checked (>= 1) and not passed,
    since the card's kernel takes its split from (H, U's dtype) alone
    (``kernels.common.cell_split``).  A width whose h rows do not fit a
    CTA's shared memory raises ``KernelLaunchRefused``."""
    B, H = h_prev.shape
    dev = h_prev.device
    check_operands("lstm_cell", dev, U4=U4, xw_t=xw_t, h_prev=h_prev,
                   c_prev=c_prev)
    check_shape("lstm_cell", "U4", U4, (H, 4, H))
    check_shape("lstm_cell", "xw_t", xw_t, (B, 4, H))
    check_shape("lstm_cell", "c_prev", c_prev, (B, H))
    if c_prev.dtype != torch.float32:
        raise TypeError("lstm_cell: c_prev must be float32")
    if block_h < 1 or block_k < 1:
        raise ValueError(f"lstm_cell: block_h={block_h} and "
                         f"block_k={block_k} must be >= 1")
    flags = (dtype_flag("lstm_cell", "U4", U4),
             dtype_flag("lstm_cell", "xw_t", xw_t),
             dtype_flag("lstm_cell", "h_prev", h_prev))
    h = torch.empty((B, H), dtype=h_prev.dtype, device=dev)
    c = torch.empty((B, H), dtype=torch.float32, device=dev)
    launch = kernel.entry("lstm_cell")
    with torch.cuda.device(dev):
        rc = launch(U4.data_ptr(), xw_t.data_ptr(), h_prev.data_ptr(),
                    c_prev.data_ptr(), h.data_ptr(), c.data_ptr(), B, H,
                    *flags, torch.cuda.current_stream(dev).cuda_stream)
    launched("lstm_cell", rc, KernelLaunchRefused)
    count_launch(lstm_cell)
    return h, c


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@counted
def lstm_cell(U4, xw_t, h_prev, c_prev, *, block_h: int = 0,
              block_k: int = 0):
    """Fused recurrent LSTM step, ONE launch.  U4 (H,4,H); xw_t (B,4,H)
    precomputed input half; h_prev (B,H); c_prev (B,H) in any float dtype,
    read as fp32 -> (h in h_prev's dtype, c fp32).

    ``block_h`` (hidden units per block) and ``block_k`` (reduction
    stripe) are the TPU kernel's tile and default to the autotune table's
    choice under a 2 MiB budget, as in the reference.  They change no
    number: the plain version takes one fp32 product, and the card's
    kernel takes its split from (H, U's dtype) alone
    (``kernels.common.cell_split``: a CTA per 8 hidden units)."""
    lstm_cell.calls += 1
    H = U4.shape[0]
    if not block_h or not block_k:
        bk, bh = table().block(H, H, vmem_budget=2 * 2**20)
        block_h = block_h or min(bh, H)
        block_k = block_k or min(bk, H)
    if on_cuda("lstm_cell", h_prev.device):
        return lstm_cell_cuda(operand(U4), operand(xw_t), operand(h_prev),
                              operand(c_prev.float()), block_h, block_k)
    return lstm_cell_plain(U4, xw_t, h_prev, c_prev)


def as_cell_kernel():
    """Adapter for ``core.schedules.run_layer_unfolded(cell_kernel=...)``.

    Schedules store U as (H, 4H) gate-major; the kernel wants (H, 4, H)."""

    def cell(U, xw_t, h, c):
        H = U.shape[0]
        return lstm_cell(U.reshape(H, 4, H),
                         xw_t.reshape(xw_t.shape[0], 4, H), h, c)

    return cell


def as_seq_kernel(block_t: int = 0):
    """Adapter for ``core.schedules.run_layer_fused`` /
    ``core.unfolded.unfold``.

    Schedules store U as (H, 4H) gate-major and the hoisted input half as
    (B, T, 4H); the kernel wants the gate axis unpacked to (4, H)."""

    def seq(U, xw, h0=None, c0=None):
        H = U.shape[0]
        B, T = xw.shape[0], xw.shape[1]
        return lstm_seq(U.reshape(H, 4, H), xw.reshape(B, T, 4, H), h0, c0,
                        block_t=block_t)

    return seq


@counted
def lstm_seq(U4, xw, h0=None, c0=None, *, b_valid=None, u_scales=None,
             u_rows=None, block_t: int = 0):
    """Sequence-fused recurrence: ONE kernel launch for the whole T walk.

    U4 (H,4,H) or, for a batch of G independent cells, (G,H,4,H); xw
    (B,T,4,H) / (G,B,T,4,H) precomputed input half; h0/c0 optional (…B,H)
    initial state (each defaults to zeros when omitted, independently).
    Returns (hs, h_T, c_T); ``hs`` is (…B,T,H) and ``h_T`` in h0's dtype,
    ``c_T`` fp32.  U4 and xw/h0 may be float32 or bfloat16 independently.

    ``u_scales`` (…4) fp32 marks U4 as the int8 per-gate quantized payload:
    h·Uq accumulates in fp32 and the scale multiplies the accumulate after
    the dot.  ``u_rows`` (…Ha) int32 marks U4 as row-compacted to
    (…Ha,4,H): h is gathered to the surviving rows before the dot.  The
    two combine (see ``kernels.quant`` for both transforms).

    ``b_valid`` (stacked form only): (G,) valid batch rows per cell when
    ragged-B cells were padded to a common B — rows >= b_valid[g] are
    exact no-ops (state passes through).

    ``block_t`` is the planner's T-stripe.  It does not change the numbers
    (h stays fp32 across the whole launch), so a chunked walk differs from
    a single launch exactly as it does in the reference: not at all in
    fp32, by the rounding of h to h0's dtype at each chunk edge otherwise.
    The kernel walks the launch's whole T in one cluster, so the wrapper has
    no use for a default stripe; the planner's choice
    (``core.tiling.select_time_block``, which weighs the precision and the
    density) sets the T of each launch it plans.

    Time-reversed walks (the bwd half of a bidirectional layer) feed the
    time-flipped xw and flip ``hs`` back (see ``dispatch.executor``)."""
    lstm_seq.calls += 1
    if block_t < 0:
        raise ValueError(f"lstm_seq: block_t={block_t} must be >= 0")
    stacked = xw.ndim == 5
    if not stacked:
        if b_valid is not None:
            raise ValueError("b_valid requires the stacked (G, ...) form")
        U4, xw = U4[None], xw[None]
        h0 = None if h0 is None else h0[None]
        c0 = None if c0 is None else c0[None]
        u_scales = None if u_scales is None else u_scales[None]
        u_rows = None if u_rows is None else u_rows[None]
    G, B, T, _, H = xw.shape
    if h0 is None:
        h0 = xw.new_zeros((G, B, H))
    if c0 is None:
        c0 = torch.zeros((G, B, H), dtype=torch.float32, device=xw.device)
    c0 = c0.float()
    if T == 0:  # degenerate empty sequence: state passes through
        hs = h0.new_zeros((G, B, 0, H))
        out = (hs, h0, c0)
    else:
        b_mask = (None if b_valid is None
                  else ragged_b_mask(G, B, b_valid, device=xw.device))
        if on_cuda("lstm_seq", xw.device):
            out = lstm_seq_cuda(
                operand(U4), operand(xw), operand(h0), operand(c0), b_mask,
                None if u_scales is None else operand(u_scales.float()),
                None if u_rows is None else operand(u_rows.int()))
        else:
            out = lstm_seq_plain(U4, xw, h0, c0, b_mask, u_scales, u_rows)
    return out if stacked else tuple(o[0] for o in out)


@counted
def lstm_decode(xw0, Ws, bs, Us, h0, c0):
    """One T=1 decode tick through a whole L-layer stack in ONE launch.

    xw0 (B,4,H) hoisted layer-0 input half; Ws (L,H,4,H) (entry 0 unused,
    so layer 0's input width may differ from H); bs (L,4,H); Us (L,H,4,H);
    h0/c0 (L,B,H).  Returns (h_n (L,B,H), c_n (L,B,H) fp32); the top-layer
    feedback frame is ``h_n[-1]`` and each layer's new h IS its T=1 output.
    Equal to L per-layer ``lstm_seq(..., T=1)`` calls with the input GEMM
    rounded through promote(h0.dtype, Ws.dtype) between them."""
    lstm_decode.calls += 1
    if on_cuda("lstm_decode", h0.device):
        return lstm_decode_cuda(operand(xw0), operand(Ws), operand(bs),
                                operand(decode_u(Us, Ws)), operand(h0),
                                operand(c0.float()))
    return lstm_decode_plain(xw0, Ws, bs, Us, h0, c0)


__all__ = ["lstm_seq", "lstm_decode", "lstm_cell", "lstm_seq_plain",
           "lstm_decode_plain", "lstm_cell_plain", "lstm_seq_cuda",
           "lstm_decode_cuda", "lstm_cell_cuda", "decode_splits",
           "as_cell_kernel", "as_seq_kernel", "lstm_cell_ref", "lstm_seq_ref"]
