"""Shared kernel utilities: integer helpers, the ragged-B mask, dtype
names, and the launch counters every kernel entry point carries."""
from __future__ import annotations

import torch

#: the dtype names plans, slot signatures and configs key on (the JAX
#: package's spelling, so the two packages' plans compare as strings)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a torch dtype passes through)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"allowed: {', '.join(DTYPES)}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def itemsize(name: str) -> int:
    return torch.empty((), dtype=torch_dtype(name)).element_size()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def ragged_b_mask(G: int, B: int, b_valid, device=None) -> torch.Tensor:
    """(G, B) int32 validity mask from per-cell valid row counts (ragged-B
    packing): mask[g, b] = 1 iff b < b_valid[g]."""
    b_valid = torch.as_tensor(b_valid, dtype=torch.int32, device=device)
    rows = torch.arange(B, dtype=torch.int32, device=b_valid.device)
    return (rows[None, :] < b_valid.reshape(G, 1)).to(torch.int32)


class KernelBuildError(RuntimeError):
    """A kernel's CUDA source did not compile.  Not a launch fault: the
    guarded execution ladder re-raises it instead of degrading past it."""


def counted(fn):
    """Give a kernel entry point its two launch counters:

    ``fn.calls`` counts every invocation on any device — structural, so CPU
    tests can hold it equal to ``DispatchPlan.launches``; and
    ``fn.kernel_launches`` counts only real CUDA launches (the entry point
    adds one right after its kernel launched)."""
    fn.calls = 0
    fn.kernel_launches = 0
    return fn


def reset_counts(*entries) -> None:
    for fn in entries:
        fn.calls = 0
        fn.kernel_launches = 0
