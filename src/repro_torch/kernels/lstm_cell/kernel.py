"""The LSTM CUDA kernels (``csrc/lstm_seq.cu``, ``csrc/lstm_decode.cu``,
``csrc/lstm_cell.cu``), registered with the shared build
(``kernels.build``: nvcc for ``sm_90a`` at first use, ctypes binding).

The Python wrappers that check tensors and launch live in
``kernels.lstm_cell.ops``.
"""
from __future__ import annotations

from repro_torch.kernels.build import I, P, entry, register

register("lstm_seq", "lstm_seq_launch", [P] * 10 + [I] * 8 + [P])
register("lstm_decode", "lstm_decode_launch", [P] * 8 + [I] * 7 + [P])
register("lstm_cell", "lstm_cell_launch", [P] * 6 + [I] * 5 + [P])

__all__ = ["entry"]
