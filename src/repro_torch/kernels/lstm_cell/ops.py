"""Public entry points of the fused LSTM kernels: ``lstm_seq`` (a whole
sequence, G recurrences, one launch) and ``lstm_decode`` (one T=1 tick
through an L-layer stack, one launch).

The device of the tensors decides how an entry point runs: on the CPU it
runs the kernel's plain PyTorch version beside it in this module
(``lstm_seq_plain`` / ``lstm_decode_plain``, which repeat the kernel's
arithmetic and rounding points); on a CUDA device it launches the
hand-written kernel (``csrc/lstm_seq.cu`` / ``csrc/lstm_decode.cu``) or
raises.  There is no fallback from one to the other.

Each entry point carries two counters (``kernels.common.counted``):
``calls`` (every invocation, any device) and ``kernel_launches`` (real
CUDA launches only).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import counted, ragged_b_mask
from repro_torch.kernels.lstm_cell import kernel
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref, lstm_seq_ref
from repro_torch.runtime.errors import not_ported

_FLOATS = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; held against the kernels on the card)
# ---------------------------------------------------------------------------


def lstm_seq_plain(U4, xw, h0, c0, b_mask=None):
    """The sequence kernel's arithmetic in plain PyTorch (stacked form).

    U4 (G,H,4,H); xw (G,B,T,4,H); h0 (G,B,H); c0 (G,B,H); b_mask (G,B)
    int32 or None.  U is upcast to fp32 before the product; h and c are
    carried in fp32 across all T steps and h is rounded to h0's dtype only
    in ``hs`` and ``h_T``; a row with b_mask == 0 freezes h and c."""
    G, B, T, _, H = xw.shape
    U = U4.reshape(G, H, 4 * H).float()
    h, c = h0.float(), c0.float()
    keep = None if b_mask is None else (b_mask != 0)[..., None]
    ys = []
    for t in range(T):
        gates = xw[:, :, t].float() + torch.bmm(h, U).reshape(G, B, 4, H)
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


# ---------------------------------------------------------------------------
# CUDA launch wrappers
# ---------------------------------------------------------------------------


def _check(name: str, device, **tensors) -> None:
    """Device, contiguity and 16-byte alignment of every kernel operand."""
    if device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{device}")
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device} like the other operands")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _dtype_flag(name: str, arg: str, t) -> int:
    if t.dtype not in _FLOATS:
        raise TypeError(f"{name}: {arg} must be float32 or bfloat16, got "
                        f"{t.dtype}")
    return int(t.dtype == torch.bfloat16)


def _shape(name: str, arg: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launched(name: str, rc: int) -> None:
    if rc:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def lstm_seq_cuda(U4, xw, h0, c0, b_mask=None):
    """Launch ``csrc/lstm_seq.cu`` (stacked form, T >= 1) on the current
    stream; shapes and dtypes as ``lstm_seq_plain``, c0 fp32."""
    G, B, T, _, H = xw.shape
    dev = xw.device
    _check("lstm_seq", dev, U4=U4, xw=xw, h0=h0, c0=c0, b_mask=b_mask)
    _shape("lstm_seq", "U4", U4, (G, H, 4, H))
    _shape("lstm_seq", "h0", h0, (G, B, H))
    _shape("lstm_seq", "c0", c0, (G, B, H))
    if c0.dtype != torch.float32:
        raise TypeError("lstm_seq: c0 must be float32")
    if b_mask is not None:
        _shape("lstm_seq", "b_mask", b_mask, (G, B))
        if b_mask.dtype != torch.int32:
            raise TypeError("lstm_seq: b_mask must be int32")
    flags = (_dtype_flag("lstm_seq", "U4", U4),
             _dtype_flag("lstm_seq", "xw", xw),
             _dtype_flag("lstm_seq", "h0", h0))
    hs = torch.empty((G, B, T, H), dtype=h0.dtype, device=dev)
    h_n = torch.empty((G, B, H), dtype=h0.dtype, device=dev)
    c_n = torch.empty((G, B, H), dtype=torch.float32, device=dev)
    launch = kernel.entry("lstm_seq")
    with torch.cuda.device(dev):
        rc = launch(U4.data_ptr(), xw.data_ptr(), h0.data_ptr(),
                    c0.data_ptr(), _ptr(b_mask), hs.data_ptr(),
                    h_n.data_ptr(), c_n.data_ptr(), G, B, T, H, *flags,
                    torch.cuda.current_stream(dev).cuda_stream)
    _launched("lstm_seq", rc)
    lstm_seq.kernel_launches += 1
    return hs, h_n, c_n


def lstm_decode_cuda(xw0, Ws, bs, Us, h0, c0):
    """Launch ``csrc/lstm_decode.cu`` on the current stream; shapes and
    dtypes as ``lstm_decode_plain``, Ws/bs/Us in one dtype, c0 fp32."""
    L, B, H = h0.shape
    dev = h0.device
    _check("lstm_decode", dev, xw0=xw0, Ws=Ws, bs=bs, Us=Us, h0=h0, c0=c0)
    _shape("lstm_decode", "xw0", xw0, (B, 4, H))
    _shape("lstm_decode", "Ws", Ws, (L, H, 4, H))
    _shape("lstm_decode", "bs", bs, (L, 4, H))
    _shape("lstm_decode", "Us", Us, (L, H, 4, H))
    _shape("lstm_decode", "c0", c0, (L, B, H))
    if c0.dtype != torch.float32:
        raise TypeError("lstm_decode: c0 must be float32")
    if not Ws.dtype == bs.dtype == Us.dtype:
        raise TypeError(f"lstm_decode: Ws, bs and Us must share one dtype, "
                        f"got {Ws.dtype}, {bs.dtype}, {Us.dtype}")
    flags = (_dtype_flag("lstm_decode", "Ws", Ws),
             _dtype_flag("lstm_decode", "xw0", xw0),
             _dtype_flag("lstm_decode", "h0", h0))
    h_n = torch.empty((L, B, H), dtype=h0.dtype, device=dev)
    c_n = torch.empty((L, B, H), dtype=torch.float32, device=dev)
    launch = kernel.entry("lstm_decode")
    with torch.cuda.device(dev):
        rc = launch(xw0.data_ptr(), Ws.data_ptr(), bs.data_ptr(),
                    Us.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                    h_n.data_ptr(), c_n.data_ptr(), L, B, H, *flags,
                    torch.cuda.current_stream(dev).cuda_stream)
    _launched("lstm_decode", rc)
    lstm_decode.kernel_launches += 1
    return h_n, c_n


def _operand(t):
    """Contiguous and 16-byte aligned (a view at an odd offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _route(name: str, device) -> bool:
    """True for the CUDA kernel, False for the plain CPU version."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{name}: tensors on {device}; the port runs on cuda "
                     "(kernel) or cpu (plain version)")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@counted
def lstm_seq(U4, xw, h0=None, c0=None, *, b_valid=None, u_scales=None,
             u_rows=None, block_t: int = 0):
    """Sequence-fused recurrence: ONE kernel launch for the whole T walk.

    U4 (H,4,H) or, for a batch of G independent cells, (G,H,4,H); xw
    (B,T,4,H) / (G,B,T,4,H) precomputed input half; h0/c0 optional (…B,H)
    initial state (each defaults to zeros when omitted, independently).
    Returns (hs, h_T, c_T); ``hs`` is (…B,T,H) and ``h_T`` in h0's dtype,
    ``c_T`` fp32.  U4 and xw/h0 may be float32 or bfloat16 independently.

    ``b_valid`` (stacked form only): (G,) valid batch rows per cell when
    ragged-B cells were padded to a common B — rows >= b_valid[g] are
    exact no-ops (state passes through).

    ``block_t`` is the planner's T-stripe.  It does not change the numbers
    (h stays fp32 across the whole launch), so a chunked walk differs from
    a single launch exactly as it does in the reference: not at all in
    fp32, by the rounding of h to h0's dtype at each chunk edge otherwise.

    Time-reversed walks (the bwd half of a bidirectional layer) feed the
    time-flipped xw and flip ``hs`` back (see ``dispatch.executor``).

    ``u_scales`` / ``u_rows`` (int8 / block-sparse U) are not ported yet."""
    lstm_seq.calls += 1
    if u_scales is not None or u_rows is not None:
        raise not_ported("lstm_seq with int8 (u_scales) or block-sparse "
                         "(u_rows) recurrent weights", "P1")
    if block_t < 0:
        raise ValueError(f"lstm_seq: block_t={block_t} must be >= 0")
    stacked = xw.ndim == 5
    if not stacked:
        if b_valid is not None:
            raise ValueError("b_valid requires the stacked (G, ...) form")
        U4, xw = U4[None], xw[None]
        h0 = None if h0 is None else h0[None]
        c0 = None if c0 is None else c0[None]
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
        if _route("lstm_seq", xw.device):
            out = lstm_seq_cuda(_operand(U4), _operand(xw), _operand(h0),
                                _operand(c0), b_mask)
        else:
            out = lstm_seq_plain(U4, xw, h0, c0, b_mask)
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
    if _route("lstm_decode", h0.device):
        return lstm_decode_cuda(_operand(xw0), _operand(Ws), _operand(bs),
                                _operand(Us), _operand(h0),
                                _operand(c0.float()))
    return lstm_decode_plain(xw0, Ws, bs, Us, h0, c0)


__all__ = ["lstm_seq", "lstm_decode", "lstm_seq_plain", "lstm_decode_plain",
           "lstm_seq_cuda", "lstm_decode_cuda", "lstm_cell_ref",
           "lstm_seq_ref"]
