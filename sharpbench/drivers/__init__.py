"""Loop kinds: each traffic mix names the driver that serves it
(``"driver"``), a module here with a ``Driver`` class."""
from __future__ import annotations


def kernel_launches() -> int:
    """Every CUDA launch the program's kernel entry points have counted
    (``kernels.common.counted``; 0 on the CPU, where they run plain)."""
    from repro_torch import kernels

    entries = {id(f): f for f in vars(kernels).values()
               if hasattr(f, "kernel_launches")}
    return sum(f.kernel_launches for f in entries.values())
