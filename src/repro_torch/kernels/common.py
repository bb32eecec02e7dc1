"""Shared kernel utilities: integer helpers, the ragged-B mask, dtype
names, the launch counters every kernel entry point carries, and the
operand checks every CUDA launch wrapper makes."""
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


# ---------------------------------------------------------------------------
# CUDA launch wrappers: operand checks, routing, launch status
# ---------------------------------------------------------------------------

FLOATS = (torch.float32, torch.bfloat16)


def check_operands(name: str, device, **tensors) -> None:
    """Device, contiguity and 16-byte alignment of every kernel operand."""
    if device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{device}")
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device} like the other operands")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def dtype_flag(name: str, arg: str, t) -> int:
    """1 for a bfloat16 operand, 0 for float32; anything else raises."""
    if t.dtype not in FLOATS:
        raise TypeError(f"{name}: {arg} must be float32 or bfloat16, got "
                        f"{t.dtype}")
    return int(t.dtype == torch.bfloat16)


def check_shape(name: str, arg: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def ptr(t):
    """A tensor's device pointer, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()


def launched(name: str, rc: int) -> None:
    """Raise when a C entry point reports a refused launch."""
    if rc:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def operand(t):
    """Contiguous and 16-byte aligned (a view at an odd offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def on_cuda(name: str, device) -> bool:
    """True for the CUDA kernel, False for the plain CPU version."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{name}: tensors on {device}; the port runs on cuda "
                     "(kernel) or cpu (plain version)")
