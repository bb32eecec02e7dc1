"""Public entry point of the RG-LRU scan kernel: ``rglru_scan`` (the whole
T-step gated linear recurrence of every (batch row, channel), one launch).

The device of the tensors decides how it runs: on the CPU it runs the
plain PyTorch version (``rglru_scan_plain``, the oracle's Python loop over
T); on a CUDA device it launches the hand-written kernel
(``csrc/rglru_scan.cu``) or raises.  There is no fallback from one to the
other.  Like every kernel entry point it carries the ``calls`` and
``kernel_launches`` counters (``kernels.common.counted``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (check_operands, check_shape,
                                        count_launch, counted, launched,
                                        on_cuda, operand)
from repro_torch.kernels.rglru import kernel
from repro_torch.kernels.rglru.ref import rglru_scan_ref

#: The kernel's arithmetic in plain PyTorch is the oracle's: each step's
#: products and sums rounded on their own in fp32, as the kernel does.
rglru_scan_plain = rglru_scan_ref

#: csrc/rglru_scan.cu's tile: steps x channels of log_a (and of gx) that
#: stream through its shared-memory ring together
SCAN_TILE_ELEMS = 1024


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
    hs = torch.empty((B, T, W), dtype=torch.float32, device=dev)
    h_n = torch.empty((B, W), dtype=torch.float32, device=dev)
    launch = kernel.entry("rglru_scan")
    with torch.cuda.device(dev):
        rc = launch(log_a.data_ptr(), gx.data_ptr(), h0.data_ptr(),
                    hs.data_ptr(), h_n.data_ptr(), B, T, W,
                    torch.cuda.current_stream(dev).cuda_stream)
    launched("rglru_scan", rc)
    count_launch(rglru_scan)
    return hs, h_n


@counted
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
    if on_cuda("rglru_scan", log_a.device):
        return rglru_scan_cuda(operand(log_a), operand(gx), operand(h0))
    return rglru_scan_plain(log_a, gx, h0)


__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_scan_cuda",
           "rglru_scan_ref", "scan_tile", "SCAN_TILE_ELEMS"]
