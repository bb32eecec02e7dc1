"""The GRU CUDA kernels (``csrc/gru_seq.cu``, ``csrc/gru_decode.cu``),
registered with the shared build (``kernels.build``: nvcc for ``sm_90a``
at first use, ctypes binding).

The Python wrappers that check tensors and launch live in
``kernels.gru_cell.ops``.
"""
from __future__ import annotations

from repro_torch.kernels.build import I, P, entry, register

register("gru_seq", "gru_seq_launch", [P] * 8 + [I] * 8 + [P])
register("gru_decode", "gru_decode_launch", [P] * 6 + [I] * 7 + [P])

__all__ = ["entry"]
