"""Public entry points of the RG-LRU scan kernels: ``rglru_scan`` (the
whole T-step gated linear recurrence of every (batch row, channel), one
launch) and its backward, ``rglru_scan_bwd`` (the reverse recurrence of
the cotangents, one launch).

The device of the tensors decides how each runs: on the CPU the plain
PyTorch version (``rglru_scan_plain``, the oracle's Python loop over T;
``rglru_scan_bwd_plain``); on a CUDA device the hand-written kernel
(``csrc/rglru_scan.cu``, ``csrc/rglru_scan_bwd.cu``) or an error.  There
is no fallback from one to the other.  Like every kernel entry point each
carries the ``calls`` and ``kernel_launches`` counters and its cost
(``kernels.common.counted``; ``rglru_scan_cost``, ``rglru_scan_bwd_cost``).

``rglru_scan`` is differentiable: it runs as a ``torch.autograd.Function``
(``RglruScan``) whose forward is the dispatch above and whose backward
calls ``rglru_scan_bwd`` on the saved ``log_a``, ``gx``, ``h0`` and
``hs``.  Autograd never looks inside the plain forward: its ``xla_exp``
is built from floor and exponent bits, whose derivative is not exp's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (Cost, check_operands, check_shape,
                                        count_launch, counted, launched,
                                        nbytes, on_cuda, operand, tracing)
from repro_torch.kernels.rglru import kernel
from repro_torch.kernels.rglru.ref import (rglru_scan_bwd_plain,
                                          rglru_scan_ref)

#: The kernel's arithmetic in plain PyTorch is the oracle's: each step's
#: products and sums rounded on their own in fp32, as the kernel does.
rglru_scan_plain = rglru_scan_ref

#: csrc/rglru_scan.cu's tile: steps x channels of log_a (and of gx) that
#: stream through its shared-memory ring together
SCAN_TILE_ELEMS = 1024

#: the scan's fp32 operations an element (an fma counted as two): two of
#: XLA's exps of 26 each (clamp 2, range reduction 5, polynomial 14, the
#: final add, 2^n 2, product 1), 2 la, 1 - a2, max, sqrt, s g and the
#: step's fma
SCAN_OPS = 59
#: the backward's fp32 operations an element: the forward's two exps
#: (52), 2 la, 1 - a2, max, sqrt, the selector (2), a2 sel, the division,
#: its sign, g times it, q's fma (2), the chain's fma (2), s delta and
#: delta q
SCAN_BWD_OPS = 67


def rglru_scan_cost(log_a, gx, h0, **_) -> Cost:
    """The recurrence over (B, T, W): no product; log_a, gx and h0 read
    and hs and h_T written once (fp32: 12 bytes an element and 8 a state
    channel); a = exp(log_a), a² = exp(2·log_a) and sqrt(1 − a²), three
    transcendentals an element; SCAN_OPS operations an element."""
    n = log_a.numel()
    return Cost(flops=0, bytes=nbytes(log_a, gx, h0) + 4 * (n + h0.numel()),
                transcendentals=3 * n, pointwise=SCAN_OPS * n)


def rglru_scan_bwd_cost(log_a, gx, h0, hs, dhs, dhT) -> Cost:
    """The backward over (B, T, W): log_a, gx, hs, dhs, h0 and dhT read,
    dlog_a, dgx and dh0 written once (24 bytes an element, 12 a state
    channel); the forward's three transcendentals an element; SCAN_BWD_OPS
    operations an element."""
    n = log_a.numel()
    return Cost(flops=0,
                bytes=nbytes(log_a, gx, h0, hs, dhs, dhT)
                + 4 * (2 * n + h0.numel()),
                transcendentals=3 * n, pointwise=SCAN_BWD_OPS * n)


def _scan_outs(log_a, h0):
    """(hs, h_n), as ``rglru_scan_cuda`` allocates them."""
    f32, dev = torch.float32, log_a.device
    return (torch.empty(log_a.shape, dtype=f32, device=dev),
            torch.empty(h0.shape, dtype=f32, device=dev))


def _bwd_outs(log_a, h0):
    """(dlog_a, dgx, dh0), as ``rglru_scan_bwd_cuda`` allocates them."""
    f32, dev = torch.float32, log_a.device
    return (torch.empty(log_a.shape, dtype=f32, device=dev),
            torch.empty(log_a.shape, dtype=f32, device=dev),
            torch.empty(h0.shape, dtype=f32, device=dev))


def scan_tile(B: int, W: int, sms: int = 132):
    """(C, steps): the channels of one CTA's strip and the steps of one
    tile that the kernel takes at (B, W) on a card with ``sms`` SMs —
    its C side's rule (``by_strip``), mirrored here so that tests and
    chip_smoke.py can aim at the tiles' edges: the widest of 32, 16, 8
    that still gives at least two CTAs an SM.  No number depends on it."""
    for C in (32, 16):
        if B * -(-W // C) >= 2 * sms:
            return C, SCAN_TILE_ELEMS // C
    return 8, SCAN_TILE_ELEMS // 8


def rglru_scan_cuda(log_a, gx, h0):
    """Launch ``csrc/rglru_scan.cu`` (T >= 1) on the current stream;
    shapes as ``rglru_scan_plain``, every operand fp32."""
    B, T, W = log_a.shape
    dev = log_a.device
    check_operands("rglru_scan", dev, log_a=log_a, gx=gx, h0=h0)
    check_shape("rglru_scan", "gx", gx, (B, T, W))
    check_shape("rglru_scan", "h0", h0, (B, W))
    for arg, t in (("log_a", log_a), ("gx", gx), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: {arg} must be float32, got "
                            f"{t.dtype}")
    hs, h_n = _scan_outs(log_a, h0)
    launch = kernel.entry("rglru_scan")
    with torch.cuda.device(dev):
        rc = launch(log_a.data_ptr(), gx.data_ptr(), h0.data_ptr(),
                    hs.data_ptr(), h_n.data_ptr(), B, T, W,
                    torch.cuda.current_stream(dev).cuda_stream)
    launched("rglru_scan", rc)
    count_launch(rglru_scan)
    return hs, h_n


def _scan(log_a, gx, h0):
    if tracing():
        return _scan_outs(log_a, h0)
    if on_cuda("rglru_scan", log_a.device):
        return rglru_scan_cuda(operand(log_a), operand(gx), operand(h0))
    return rglru_scan_plain(log_a, gx, h0)


class RglruScan(torch.autograd.Function):
    """``rglru_scan`` with its backward: forward (log_a, gx, h0) ->
    (hs, h_T); backward (dhs, dhT) -> (dlog_a, dgx, dh0) through
    ``rglru_scan_bwd``."""

    @staticmethod
    def forward(ctx, log_a, gx, h0):
        hs, hT = _scan(log_a, gx, h0)
        ctx.save_for_backward(log_a, gx, h0, hs)
        return hs, hT

    @staticmethod
    def backward(ctx, dhs, dhT):
        log_a, gx, h0, hs = ctx.saved_tensors
        return rglru_scan_bwd(log_a, gx, h0, hs, dhs, dhT)


@counted(cost=rglru_scan_cost)
def rglru_scan(log_a, gx, h0, *, block_w: int = 0):
    """The RG-LRU recurrence h = a·h + sqrt(max(1 − a², 0))·gx with
    a = exp(log_a), ONE kernel launch for all T steps.

    log_a, gx (B, T, W) fp32; h0 (B, W) fp32 -> (hs (B, T, W), h_T (B, W)),
    fp32.  ``block_w`` is the TPU kernel's channel tile; it changes no
    number, and this kernel, whose CTAs take strips of 8 to 32 channels
    (``scan_tile``) and walk all of T in tiles, has no use for it: it is
    accepted and ignored."""
    rglru_scan.calls += 1
    if block_w < 0:
        raise ValueError(f"rglru_scan: block_w={block_w} must be >= 0")
    if log_a.shape[1] == 0:  # degenerate empty sequence: state passes through
        return log_a.new_zeros(log_a.shape), h0
    return RglruScan.apply(log_a, gx, h0)


def rglru_scan_bwd_cuda(log_a, gx, h0, hs, dhs, dhT):
    """Launch ``csrc/rglru_scan_bwd.cu`` (T >= 1) on the current stream;
    shapes as ``rglru_scan_bwd_plain``, every operand fp32."""
    B, T, W = log_a.shape
    dev = log_a.device
    ops = dict(log_a=log_a, gx=gx, h0=h0, hs=hs, dhs=dhs, dhT=dhT)
    check_operands("rglru_scan_bwd", dev, **ops)
    for arg, t in ops.items():
        check_shape("rglru_scan_bwd", arg, t,
                    (B, W) if arg in ("h0", "dhT") else (B, T, W))
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan_bwd: {arg} must be float32, got "
                            f"{t.dtype}")
    dla, dgx, dh0 = _bwd_outs(log_a, h0)
    launch = kernel.entry("rglru_scan_bwd")
    with torch.cuda.device(dev):
        rc = launch(log_a.data_ptr(), gx.data_ptr(), h0.data_ptr(),
                    hs.data_ptr(), dhs.data_ptr(), dhT.data_ptr(),
                    dla.data_ptr(), dgx.data_ptr(), dh0.data_ptr(), B, T, W,
                    torch.cuda.current_stream(dev).cuda_stream)
    launched("rglru_scan_bwd", rc)
    count_launch(rglru_scan_bwd)
    return dla, dgx, dh0


@counted(cost=rglru_scan_bwd_cost)
def rglru_scan_bwd(log_a, gx, h0, hs, dhs, dhT):
    """The backward of ``rglru_scan``, ONE kernel launch for all T steps:
    from the forward's inputs log_a, gx (B, T, W) and h0 (B, W), its
    output hs (B, T, W) and the cotangents dhs (B, T, W) of hs and dhT
    (B, W) of h_T, the cotangents (dlog_a, dgx, dh0) of its inputs; all
    fp32, T >= 1.  The math and its inf / nan where a rounds to 1:
    ``kernels.rglru.ref.rglru_scan_bwd_plain``."""
    rglru_scan_bwd.calls += 1
    if tracing():
        return _bwd_outs(log_a, h0)
    if on_cuda("rglru_scan_bwd", log_a.device):
        return rglru_scan_bwd_cuda(*(operand(t) for t in (
            log_a, gx, h0, hs, dhs, dhT)))
    return rglru_scan_bwd_plain(log_a, gx, h0, hs, dhs, dhT)


__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_scan_cuda",
           "rglru_scan_ref", "rglru_scan_bwd", "rglru_scan_bwd_plain",
           "rglru_scan_bwd_cuda", "RglruScan", "scan_tile",
           "SCAN_TILE_ELEMS", "SCAN_OPS", "SCAN_BWD_OPS", "rglru_scan_cost",
           "rglru_scan_bwd_cost"]
