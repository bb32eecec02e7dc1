"""Plain PyTorch oracle for the tiled MVM engine (the port of
``repro.kernels.mvm_tile.ref``)."""
from __future__ import annotations

import torch


def mvm_ref(x, W, b=None):
    """x (B, X) @ W (X, N) (+ b) with fp32 accumulation, the bias added in
    fp32, the result rounded once to x's dtype."""
    y = torch.matmul(x.float(), W.float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)
