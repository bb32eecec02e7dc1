"""Public entry points of the fused GRU kernels: ``gru_seq`` (a whole
sequence, G recurrences, one launch) and ``gru_decode`` (one T=1 tick
through an L-layer stack, one launch).  Gate order along the 3-axis:
(z, r, n); the reset gate scales the n gate's recurrent product only,
``n = tanh(xw_n + r·(h·U_n))``.

The device of the tensors decides how an entry point runs: on the CPU it
runs the kernel's plain PyTorch version beside it in this module
(``gru_seq_plain`` / ``gru_decode_plain``, which repeat the kernel's
arithmetic and rounding points); on a CUDA device it launches the
hand-written kernel (``csrc/gru_seq.cu`` / ``csrc/gru_decode.cu``) or
raises.  There is no fallback from one to the other.

Each entry point carries two counters (``kernels.common.counted``):
``calls`` (every invocation, any device) and ``kernel_launches`` (real
CUDA launches only).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (KernelLaunchRefused,
                                        check_operands, check_shape,
                                        count_launch, counted, decode_splits,
                                        decode_u, dtype_flag, gather_index,
                                        launched, on_cuda, operand, ptr,
                                        ragged_b_mask, recurrent_product,
                                        seq_limit, seq_splits, seq_variant,
                                        weight_operands)
from repro_torch.kernels.gru_cell import kernel
from repro_torch.kernels.gru_cell.ref import gru_seq_ref, gru_step_ref


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; held against the kernels on the card)
# ---------------------------------------------------------------------------


def _gru_update(xw, hu, h):
    """z, r, n and the new h, all fp32; xw and hu are (..., 3, H)."""
    z = torch.sigmoid(xw[..., 0, :] + hu[..., 0, :])
    r = torch.sigmoid(xw[..., 1, :] + hu[..., 1, :])
    n = torch.tanh(xw[..., 2, :] + r * hu[..., 2, :])
    return (1 - z) * n + z * h


def gru_seq_plain(U3, xw, h0, b_mask=None, u_scales=None, u_rows=None):
    """The sequence kernel's arithmetic in plain PyTorch (stacked form).

    U3 (G,Hr,3,H); xw (G,B,T,3,H); h0 (G,B,H); b_mask (G,B) int32 or None.
    U is upcast to fp32 before the product; h is seeded from h0 in fp32,
    carried in fp32 across all T steps and rounded to h0's dtype only in
    ``hs`` and ``h_T``; a row with b_mask == 0 freezes h.  ``u_scales``
    (G,3): U3 is int8 and the per-gate scale multiplies the whole raw h·U
    before the reset gate couples r·hu_n; ``u_rows`` (G,Ha) int32: U3
    holds Hr = Ha compacted rows and h is gathered to them."""
    G, B, T, _, H = xw.shape
    U = U3.reshape(G, U3.shape[1], 3 * H).float()
    h = h0.float()
    rows = gather_index(u_rows, B)
    keep = None if b_mask is None else (b_mask != 0)[..., None]
    ys = []
    for t in range(T):
        hu = recurrent_product(h, U, 3, u_scales, rows)
        h_new = _gru_update(xw[:, :, t].float(), hu, h)
        h = h_new if keep is None else torch.where(keep, h_new, h)
        ys.append(h)
    return torch.stack(ys, dim=2).to(h0.dtype), h.to(h0.dtype)


def gru_decode_plain(xw0, Ws, bs, Us, h0):
    """The decode kernel's arithmetic in plain PyTorch, with its rounding
    points: a deeper layer's input GEMM y·W_l is accumulated in fp32 and
    rounded to xw_dtype = promote(h0.dtype, Ws.dtype), then b_l (cast to
    xw_dtype) is added in xw_dtype; h = (1-z)·n + z·h0[l] with h0[l] read
    in its stored dtype; the inter-layer value y is h rounded through h0's
    dtype.  Ws[0] is never read."""
    L, B, H = h0.shape
    xw_dtype = torch.promote_types(h0.dtype, Ws.dtype)
    hn = []
    y = None
    for l in range(L):
        if l == 0:
            xw = xw0.float()
        else:
            xw = (y @ Ws[l].reshape(H, 3 * H).float()).to(xw_dtype)
            xw = (xw + bs[l].reshape(3 * H).to(xw_dtype)).float()
            xw = xw.reshape(B, 3, H)
        h_prev = h0[l].float()
        hu = (h_prev @ Us[l].reshape(H, 3 * H).float()).reshape(B, 3, H)
        h = _gru_update(xw, hu, h_prev).to(h0.dtype)
        y = h.float()
        hn.append(h)
    return torch.stack(hn)


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------


def gru_seq_cuda(U3, xw, h0, b_mask=None, u_scales=None, u_rows=None):
    """Launch ``csrc/gru_seq.cu`` (stacked form, T >= 1) on the current
    stream; shapes and dtypes as ``gru_seq_plain``, U3 fp32, bf16 or (with
    u_scales) int8, u_rows int32."""
    G, B, T, _, H = xw.shape
    seq_limit("gru_seq", H)  # before any other check: a refusal
    dev = xw.device
    check_operands("gru_seq", dev, U3=U3, xw=xw, h0=h0, b_mask=b_mask,
                   u_scales=u_scales, u_rows=u_rows)
    Hr, u_type = weight_operands("gru_seq", U3, u_scales, u_rows, G, H, 3)
    seq_splits(H, 3, U3.element_size(), Hr)
    check_shape("gru_seq", "h0", h0, (G, B, H))
    if b_mask is not None:
        check_shape("gru_seq", "b_mask", b_mask, (G, B))
        if b_mask.dtype != torch.int32:
            raise TypeError("gru_seq: b_mask must be int32")
    flags = (u_type, dtype_flag("gru_seq", "xw", xw),
             dtype_flag("gru_seq", "h0", h0))
    hs = torch.empty((G, B, T, H), dtype=h0.dtype, device=dev)
    h_n = torch.empty((G, B, H), dtype=h0.dtype, device=dev)
    launch = kernel.entry("gru_seq")
    with torch.cuda.device(dev):
        rc = launch(U3.data_ptr(), ptr(u_scales), ptr(u_rows), xw.data_ptr(),
                    h0.data_ptr(), ptr(b_mask), hs.data_ptr(),
                    h_n.data_ptr(), G, B, T, H, Hr, *flags,
                    torch.cuda.current_stream(dev).cuda_stream)
    launched("gru_seq", rc, KernelLaunchRefused)
    count_launch(gru_seq, seq_variant(u_scales, u_rows))
    return hs, h_n


def gru_decode_cuda(xw0, Ws, bs, Us, h0):
    """Launch ``csrc/gru_decode.cu`` on the current stream; shapes and
    dtypes as ``gru_decode_plain``, Ws/bs in one dtype, Us in Ws's or
    (under bf16 Ws) fp32."""
    L, B, H = h0.shape
    dev = h0.device
    check_operands("gru_decode", dev, xw0=xw0, Ws=Ws, bs=bs, Us=Us, h0=h0)
    check_shape("gru_decode", "xw0", xw0, (B, 3, H))
    check_shape("gru_decode", "Ws", Ws, (L, H, 3, H))
    check_shape("gru_decode", "bs", bs, (L, 3, H))
    check_shape("gru_decode", "Us", Us, (L, H, 3, H))
    if Ws.dtype != bs.dtype:
        raise TypeError(f"gru_decode: Ws and bs must share one dtype, "
                        f"got {Ws.dtype}, {bs.dtype}")
    flags = (dtype_flag("gru_decode", "Ws", Ws),
             dtype_flag("gru_decode", "Us", Us),
             dtype_flag("gru_decode", "xw0", xw0),
             dtype_flag("gru_decode", "h0", h0))
    if flags[1] and not flags[0]:
        raise TypeError(f"gru_decode: bfloat16 Us under float32 Ws; the "
                        "entry point upcasts such a U")
    h_n = torch.empty((L, B, H), dtype=h0.dtype, device=dev)
    launch = kernel.entry("gru_decode")
    with torch.cuda.device(dev):
        rc = launch(xw0.data_ptr(), Ws.data_ptr(), bs.data_ptr(),
                    Us.data_ptr(), h0.data_ptr(), h_n.data_ptr(), L, B, H,
                    *flags, torch.cuda.current_stream(dev).cuda_stream)
    launched("gru_decode", rc, KernelLaunchRefused)
    count_launch(gru_decode)
    return h_n


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@counted
def gru_seq(U3, xw, h0=None, *, b_valid=None, u_scales=None, u_rows=None,
            block_t: int = 0):
    """Sequence-fused GRU recurrence: ONE kernel launch for the whole T
    walk.

    U3 (H,3,H) or, for a batch of G independent cells, (G,H,3,H); xw
    (B,T,3,H) / (G,B,T,3,H) precomputed input half; h0 optional (…B,H)
    initial state (zeros in xw's dtype when omitted).  Returns (hs, h_T)
    in h0's dtype; ``hs`` is (…B,T,H).  U3 and xw/h0 may be float32 or
    bfloat16 independently.

    ``u_scales`` (…3) fp32 marks U3 as the int8 per-gate quantized payload
    (the scale multiplies the fp32 accumulate of all three gates before
    the reset gate couples into the candidate); ``u_rows`` (…Ha) int32
    marks U3 as row-compacted to (…Ha,3,H), with h gathered to the
    surviving rows.  The two combine (see ``kernels.quant``).

    ``b_valid`` (stacked form only): (G,) valid batch rows per cell when
    ragged-B cells were padded to a common B — rows >= b_valid[g] are
    exact no-ops (state passes through).

    ``block_t`` is the planner's T-stripe.  It does not change the numbers
    (h stays fp32 across the whole launch), and the kernel walks the
    launch's whole T, so the wrapper picks no default (see ``lstm_seq``).
    Time-reversed walks feed the time-flipped xw and flip ``hs`` back (see
    ``dispatch.executor``)."""
    gru_seq.calls += 1
    if block_t < 0:
        raise ValueError(f"gru_seq: block_t={block_t} must be >= 0")
    stacked = xw.ndim == 5
    if not stacked:
        if b_valid is not None:
            raise ValueError("b_valid requires the stacked (G, ...) form")
        U3, xw = U3[None], xw[None]
        h0 = None if h0 is None else h0[None]
        u_scales = None if u_scales is None else u_scales[None]
        u_rows = None if u_rows is None else u_rows[None]
    G, B, T, _, H = xw.shape
    if h0 is None:
        h0 = xw.new_zeros((G, B, H))
    if T == 0:  # degenerate empty sequence: state passes through
        out = (h0.new_zeros((G, B, 0, H)), h0)
    else:
        b_mask = (None if b_valid is None
                  else ragged_b_mask(G, B, b_valid, device=xw.device))
        if on_cuda("gru_seq", xw.device):
            out = gru_seq_cuda(
                operand(U3), operand(xw), operand(h0), b_mask,
                None if u_scales is None else operand(u_scales.float()),
                None if u_rows is None else operand(u_rows.int()))
        else:
            out = gru_seq_plain(U3, xw, h0, b_mask, u_scales, u_rows)
    return out if stacked else tuple(o[0] for o in out)


@counted
def gru_decode(xw0, Ws, bs, Us, h0):
    """One T=1 decode tick through a whole L-layer GRU stack in ONE
    launch.

    xw0 (B,3,H) hoisted layer-0 input half; Ws (L,H,3,H) (entry 0 unused,
    so layer 0's input width may differ from H); bs (L,3,H); Us (L,H,3,H);
    h0 (L,B,H).  Returns h_n (L,B,H) in h0's dtype; the top-layer feedback
    frame is ``h_n[-1]``.  Equal to L per-layer ``gru_seq(..., T=1)``
    calls with the input GEMM rounded through promote(h0.dtype, Ws.dtype)
    between them."""
    gru_decode.calls += 1
    if on_cuda("gru_decode", h0.device):
        return gru_decode_cuda(operand(xw0), operand(Ws), operand(bs),
                               operand(decode_u(Us, Ws)), operand(h0))
    return gru_decode_plain(xw0, Ws, bs, Us, h0)


__all__ = ["gru_seq", "gru_decode", "gru_seq_plain", "gru_decode_plain",
           "gru_seq_cuda", "gru_decode_cuda", "decode_splits", "gru_seq_ref",
           "gru_step_ref"]
