"""The RG-LRU scan CUDA kernels (``csrc/rglru_scan.cu`` and its backward,
``csrc/rglru_scan_bwd.cu``), registered with
the shared build (``kernels.build``: nvcc for ``sm_90a`` at first use,
ctypes binding).

The Python wrapper that checks tensors and launches lives in
``kernels.rglru.ops``.
"""
from __future__ import annotations

from repro_torch.kernels.build import I, P, entry, register

register("rglru_scan", "rglru_scan_launch", [P] * 5 + [I] * 3 + [P])
register("rglru_scan_bwd", "rglru_scan_bwd_launch", [P] * 9 + [I] * 3 + [P])

__all__ = ["entry"]
