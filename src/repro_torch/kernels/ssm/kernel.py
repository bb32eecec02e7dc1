"""The Mamba-2 state-update CUDA kernel (``csrc/ssm_update.cu``),
registered with the shared build (``kernels.build``: nvcc for ``sm_90a``
at first use, ctypes binding).

The Python wrapper that checks tensors and launches lives in
``kernels.ssm.ops``.
"""
from __future__ import annotations

from repro_torch.kernels.build import I, P, entry, register

register("ssm_update", "ssm_update_launch", [P] * 7 + [I] * 6 + [P])

__all__ = ["entry"]
