"""Public entry point of the tiled MVM kernel: ``mvm`` (y = x·W + b with
fp32 accumulation, output in x's dtype, ONE launch).

The device of the tensors decides how it runs: on the CPU it runs the
plain PyTorch version (``mvm_plain``, the oracle's fp32 product); on a
CUDA device it launches the hand-written kernel (``csrc/mvm_tile.cu``) or
raises.  There is no fallback from one to the other.  Like every kernel
entry point it carries the ``calls`` and ``kernel_launches`` counters
(``kernels.common.counted``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (check_operands, check_shape,
                                        count_launch, counted, dtype_flag,
                                        launched, on_cuda, operand)
from repro_torch.kernels.mvm_tile import kernel
from repro_torch.kernels.mvm_tile.ref import mvm_ref

#: The kernel's function in plain PyTorch is the oracle's: an fp32 product,
#: the bias added in fp32, one rounding to x's dtype.
mvm_plain = mvm_ref


def mvm_cuda(x, W, b=None):
    """Launch ``csrc/mvm_tile.cu`` on the current stream: x (B, X) and W
    (X, N) fp32 or bf16, b (N,) fp32 or None -> y (B, N) in x's dtype."""
    B, X = x.shape
    N = W.shape[1]
    dev = x.device
    check_operands("mvm", dev, x=x, W=W, b=b)
    check_shape("mvm", "W", W, (X, N))
    if b is not None:
        check_shape("mvm", "b", b, (N,))
        if b.dtype != torch.float32:
            raise TypeError(f"mvm: b must be float32, got {b.dtype}")
    x_type = dtype_flag("mvm", "x", x)
    w_type = dtype_flag("mvm", "W", W)
    y = torch.empty((B, N), dtype=x.dtype, device=dev)
    launch = kernel.entry("mvm_tile")
    with torch.cuda.device(dev):
        rc = launch(x.data_ptr(), W.data_ptr(),
                    None if b is None else b.data_ptr(), y.data_ptr(), B, X,
                    N, x_type, w_type,
                    torch.cuda.current_stream(dev).cuda_stream)
    launched("mvm", rc)
    count_launch(mvm)
    return y


@counted
def mvm(x, W, b=None, *, block_n: int = 0, block_k: int = 0):
    """Tiled y = x @ W (+ b).  x (B, X) or (X,); W (X, N); b (N,) or None.

    fp32 accumulation, the bias added in fp32, output in x's dtype.
    ``block_n`` / ``block_k`` are the TPU kernel's tile shape (the
    reference takes a default from its autotune table); they change no
    number, and this kernel, whose blocks each own 32 output columns over
    all of X, has no use for them: they are checked, then ignored."""
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
    if on_cuda("mvm", x.device):
        y = mvm_cuda(operand(x), operand(W),
                     None if b is None else operand(b.float()))
    else:
        y = mvm_plain(x, W, b)
    return y[0] if squeeze else y


__all__ = ["mvm", "mvm_plain", "mvm_cuda", "mvm_ref"]
