"""The flash-decode attention CUDA kernel (``csrc/decode_attention.cu``),
registered with the shared build (``kernels.build``: nvcc for ``sm_90a``
at first use, ctypes binding).

The Python wrapper that checks tensors and launches lives in
``kernels.decode_attention.ops``.
"""
from __future__ import annotations

from repro_torch.kernels.build import I, P, bind, entry, register

register("decode_attention", "decode_attention_launch",
         [P] * 6 + [I] * 8 + [P])

__all__ = ["bind", "entry"]
