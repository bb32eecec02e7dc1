"""The tiled MVM CUDA kernel (``csrc/mvm_tile.cu``), registered with the
shared build (``kernels.build``: nvcc for ``sm_90a`` at first use, ctypes
binding).

The Python wrapper that checks tensors and launches lives in
``kernels.mvm_tile.ops``.
"""
from __future__ import annotations

from repro_torch.kernels.build import I, P, bind, entry, register

register("mvm_tile", "mvm_launch", [P] * 4 + [I] * 6 + [P])

__all__ = ["bind", "entry"]
