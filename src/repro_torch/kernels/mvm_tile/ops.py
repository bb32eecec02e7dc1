"""Public entry point of the tiled MVM kernel: ``mvm`` (y = x·W + b with
fp32 accumulation, output in x's dtype, ONE launch).

The device of the tensors decides how it runs: on the CPU it runs the
plain PyTorch version (``mvm_plain``, the oracle's fp32 product); on a
CUDA device it launches the hand-written kernel (``csrc/mvm_tile.cu``) or
raises.  There is no fallback from one to the other.  Like every kernel
entry point it carries the ``calls`` and ``kernel_launches`` counters and
its cost (``kernels.common.counted``, ``mvm_cost``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (Cost, cdiv, check_operands,
                                        check_shape, count_launch, counted,
                                        dtype_flag, launched, nbytes,
                                        on_cuda, operand, tracing)
from repro_torch.kernels.mvm_tile import kernel
from repro_torch.kernels.mvm_tile.ref import mvm_ref

#: The kernel's function in plain PyTorch is the oracle's: an fp32 product,
#: the bias added in fp32, one rounding to x's dtype.
mvm_plain = mvm_ref

#: output columns per cluster (kCols in csrc/mvm_tile.cu) and the cluster
#: sizes the kernel takes (each divides the stripe's columns)
STRIPE = 64
SPLITS = (1, 2, 4, 8, 16)
#: CTAs the card holds at once for the kernel's 4-row instance: 3 per SM
#: (its 72.5 KB of shared memory) on the 132 SMs of an H100 SXM
ONE_WAVE = 3 * 132


def splits(X: int, N: int) -> int:
    """S, the CTAs of one cluster (each sums X/S rows of W into the same
    STRIPE output columns), from the shape alone — never from B or a
    timing, so each output is summed in the same order in every run and
    at every B.  The largest S in SPLITS whose grid, stripes × S CTAs,
    still fits in one wave (ONE_WAVE): more CTAs would leave a second,
    partial wave.  (X only bounds what a split holds: a CTA whose slice
    lies past X adds zeros.)"""
    stripes = cdiv(N, STRIPE)
    S = SPLITS[0]
    for s in SPLITS[1:]:
        if stripes * s <= ONE_WAVE:
            S = s
    return S


def mvm_cuda(x, W, b=None):
    """Launch ``csrc/mvm_tile.cu`` on the current stream: x (B, X) and W
    (X, N) fp32 or bf16, b (N,) fp32 or None -> y (B, N) in x's dtype,
    over clusters of ``splits(X, N)`` CTAs."""
    B, X = x.shape
    N = W.shape[1]
    dev = x.device
    check_operands("mvm", dev, x=x, W=W, b=b)
    check_shape("mvm", "W", W, (X, N))
    if b is not None:
        check_shape("mvm", "b", b, (N,))
        if b.dtype != torch.float32:
            raise TypeError(f"mvm: b must be float32, got {b.dtype}")
    S = splits(X, N)
    x_type = dtype_flag("mvm", "x", x)
    w_type = dtype_flag("mvm", "W", W)
    y = _out(x, N)
    launch = kernel.entry("mvm_tile")
    with torch.cuda.device(dev):
        rc = launch(x.data_ptr(), W.data_ptr(),
                    None if b is None else b.data_ptr(), y.data_ptr(), B, X,
                    N, S, x_type, w_type,
                    torch.cuda.current_stream(dev).cuda_stream)
    launched("mvm", rc)
    count_launch(mvm)
    return y


def max_clusters(B: int, X: int, N: int, dtype=torch.bfloat16) -> int:
    """How many of a launch's clusters (at ``splits(X, N)``) can be
    resident on the current card at once: cudaOccupancyMaxActiveClusters
    for the kernel instance that x and W of ``dtype`` at (B, N) take."""
    query = kernel.bind("mvm_tile", "mvm_max_clusters",
                        [ctypes.c_int] * 5 + [ctypes.c_void_p])
    flag = int(dtype == torch.bfloat16)
    out = ctypes.c_int(0)
    launched("mvm (cluster occupancy)",
             query(B, N, splits(X, N), flag, flag, ctypes.addressof(out)))
    return out.value


def _out(x, N):
    """y, as ``mvm_cuda`` allocates it."""
    return torch.empty((x.shape[0], N), dtype=x.dtype, device=x.device)


def mvm_cost(x, W, b=None, **_) -> Cost:
    """y = x·W (+ b) at (B, X, N): 2·B·X·N FLOPs; x, W and b read and y
    written once; the bias add B·N operations."""
    B = x.shape[0] if x.dim() == 2 else 1
    X, N = W.shape
    return Cost(flops=2 * B * X * N,
                bytes=nbytes(x, W, b) + B * N * x.element_size(),
                pointwise=0 if b is None else B * N)


@counted(cost=mvm_cost)
def mvm(x, W, b=None, *, block_n: int = 0, block_k: int = 0):
    """Tiled y = x @ W (+ b).  x (B, X) or (X,); W (X, N); b (N,) or None.

    fp32 accumulation, the bias added in fp32, output in x's dtype.
    ``block_n`` / ``block_k`` are the TPU kernel's tile shape (the
    reference takes a default from its autotune table); they change no
    number, and this kernel, whose clusters each own STRIPE output
    columns over all of X (``splits``), has no use for them: they are
    checked, then ignored."""
    mvm.calls += 1
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    X, N = W.shape
    if x.dim() != 2 or x.shape[1] != X:
        raise ValueError(f"mvm: x has shape {tuple(x.shape)}, expected "
                         f"(B, {X}) or ({X},) for W of shape {(X, N)}")
    if block_n < 0 or block_k < 0:
        raise ValueError(f"mvm: block_n={block_n}, block_k={block_k} must "
                         "be >= 0")
    if tracing():
        y = _out(x, N)
    elif on_cuda("mvm", x.device):
        y = mvm_cuda(operand(x), operand(W),
                     None if b is None else operand(b.float()))
    else:
        y = mvm_plain(x, W, b)
    return y[0] if squeeze else y


__all__ = ["mvm", "mvm_plain", "mvm_cuda", "mvm_ref", "mvm_cost", "splits",
           "max_clusters"]
