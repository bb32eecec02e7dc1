"""Shared kernel utilities: integer helpers, the ragged-B mask, dtype
names, the launch counters every kernel entry point carries, the operand
checks every CUDA launch wrapper makes, and the pieces the LSTM and GRU
families share: the recurrent product of their plain sequence versions,
the decode kernels' U operand, and the cluster plans of their decode and
sequence kernels."""
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


class KernelLaunchRefused(RuntimeError):
    """The card refused a kernel's launch configuration: a thread-block
    cluster it cannot form or schedule, shared memory past its limit, a
    shape past the kernel's.  Like ``KernelBuildError`` it is a property
    of the checkout and the card, not a fault of one launch: the guarded
    execution ladder re-raises it instead of serving the slot through
    another rung."""


#: every kernel entry point that carries counters (``counted``), in the
#: order their modules were imported
COUNTED: list = []


def counted(fn):
    """Give a kernel entry point its launch counters:

    ``fn.calls`` counts every invocation on any device — structural, so CPU
    tests can hold it equal to ``DispatchPlan.launches``;
    ``fn.kernel_launches`` counts only real CUDA launches (the entry point
    adds one right after its kernel launched, a CUDA graph's replay those
    its capture counted: ``count_launch``); and
    ``fn.variant_launches`` splits those launches by the weight branch the
    sequence kernels took (``seq_variant``), where the entry point has
    branches."""
    fn.calls = 0
    fn.kernel_launches = 0
    fn.variant_launches = {}
    COUNTED.append(fn)
    return fn


def reset_counts(*entries) -> None:
    for fn in entries:
        fn.calls = 0
        fn.kernel_launches = 0
        fn.variant_launches = {}


def seq_variant(u_scales, u_rows) -> str:
    """The weight branch a sequence-kernel launch takes: "dense" (fp32 or
    bf16 U), "int8", "compact" (row-compacted U) or "int8+compact"."""
    parts = [name for name, t in (("int8", u_scales), ("compact", u_rows))
             if t is not None]
    return "+".join(parts) or "dense"


def count_launch(fn, variant: str = "") -> None:
    """Add one real CUDA launch to ``fn``'s counters.  The launch wrappers
    call this right after their kernel launched; the one other place that
    adds launches is ``serving.engine.DecodeGraph.replay``, which adds the
    launches its capture counted (a replay runs them without calling the
    wrappers)."""
    fn.kernel_launches += 1
    if variant:
        fn.variant_launches[variant] = fn.variant_launches.get(variant, 0) + 1


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


def weight_operands(name: str, U, u_scales, u_rows, G: int, H: int,
                    gates: int):
    """Check a sequence kernel's recurrent-weight operands and return
    (Hr, u_type): U (G, Hr, gates, H) is dense (Hr = H) or, with u_rows
    (G, Ha) int32, row-compacted (Hr = Ha); it is fp32 (u_type 0), bf16 (1)
    or, exactly when u_scales (G, gates) fp32 is given, int8 (2)."""
    Hr = H if u_rows is None else u_rows.shape[-1]
    check_shape(name, "U", U, (G, Hr, gates, H))
    if u_rows is not None:
        check_shape(name, "u_rows", u_rows, (G, Hr))
        if u_rows.dtype != torch.int32:
            raise TypeError(f"{name}: u_rows must be int32")
    if u_scales is None:
        if U.dtype == torch.int8:
            raise TypeError(f"{name}: an int8 U needs its u_scales")
        return Hr, dtype_flag(name, "U", U)
    check_shape(name, "u_scales", u_scales, (G, gates))
    if u_scales.dtype != torch.float32:
        raise TypeError(f"{name}: u_scales must be float32")
    if U.dtype != torch.int8:
        raise TypeError(f"{name}: u_scales marks U as int8, got {U.dtype}")
    return Hr, 2


def ptr(t):
    """A tensor's device pointer, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()


def launched(name: str, rc: int, error=RuntimeError) -> None:
    """Raise ``error`` when a C entry point reports a refused launch."""
    if rc:
        raise error(f"{name}: CUDA kernel launch failed with cudaError {rc}")


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


# ---------------------------------------------------------------------------
# shared by the LSTM and GRU entry points
# ---------------------------------------------------------------------------


def recurrent_product(h, U, gates: int, u_scales=None, rows=None):
    """h·U of the sequence kernels in plain PyTorch, (G,B,gates,H) fp32.

    h (G,B,H) fp32; U (G,Hr,gates·H) fp32.  ``rows`` (G,B,Ha) int64
    gathers h to the rows of a row-compacted U; ``u_scales`` (G,gates)
    multiplies the accumulate of an int8 U's upcast payload after the dot,
    as (h·Uq)·s."""
    G, B, H = h.shape
    h_in = h if rows is None else torch.gather(h, 2, rows)
    acc = torch.bmm(h_in, U).reshape(G, B, gates, H)
    if u_scales is not None:
        acc = acc * u_scales.float()[:, None, :, None]
    return acc


def gather_index(u_rows, B: int):
    """u_rows (G,Ha) -> the (G,B,Ha) int64 index ``recurrent_product``
    gathers h with, or None for a dense U."""
    if u_rows is None:
        return None
    G, Ha = u_rows.shape
    return u_rows.long()[:, None, :].expand(G, B, Ha)


def decode_u(Us, Ws):
    """The Us operand of a decode kernel: a bf16 U under fp32 W is upcast
    (exact — the kernel reads U only through an fp32 upcast), so the
    kernels need no (fp32 W, bf16 U) instance.  Every other mix is taken
    as it is: U's type never sets a rounding point, W's does."""
    if Us.dtype == torch.bfloat16 and Ws.dtype == torch.float32:
        return Us.float()
    return Us


#: The decode kernels' cluster split (csrc/decode_cluster.cuh): the
#: largest cluster, the most gate columns a CTA's slice should hold, the
#: widest H (a CTA's slice of at most 128 units then keeps one cell per
#: thread).
DECODE_MAX_SPLITS = 16
DECODE_SLICE_COLS = 64
DECODE_MAX_H = 2048


def decode_unit_align(H: int) -> int:
    """The decode kernels' slices start on multiples of this many hidden
    units: 8 when H % 8 == 0 (16-byte loads of 8 bf16), 4 when H % 4 ==
    0, else 1 (plain loads)."""
    return 8 if H % 8 == 0 else 4 if H % 4 == 0 else 1


def decode_splits(H: int, gates: int) -> int:
    """S, the CTAs of a decode kernel's cluster, from (H, gates) alone —
    never from B or a timing, so each output is summed in the same order
    at every B: the fewest, a power of two up to DECODE_MAX_SPLITS (and
    at most H / decode_unit_align(H)), whose widest slice holds at most
    DECODE_SLICE_COLS gate columns.  16 at H = 340 and 1024 for both
    families."""
    if not 1 <= H <= DECODE_MAX_H:
        raise ValueError(f"decode kernels take 1 <= H <= {DECODE_MAX_H}, "
                         f"got H={H}")
    A = decode_unit_align(H)
    groups = H // A
    cap = min(DECODE_MAX_SPLITS, groups)
    S = 1
    while 2 * S <= cap and gates * cdiv(groups, S) * A > DECODE_SLICE_COLS:
        S *= 2
    return S


def decode_clusters(family: str, B: int, H: int, w_dtype=torch.bfloat16,
                    u_dtype=None):
    """(S, clusters) of the ``family`` ("lstm" or "gru") decode kernel: the
    cluster size it takes at H (its C side's rule, which
    ``decode_splits`` mirrors) and how many of a launch's clusters at
    (B, H, the weights' types; U in W's type by default) can be resident
    on the current card at once (cudaOccupancyMaxActiveClusters)."""
    import ctypes

    from repro_torch.kernels.build import bind

    name = f"{family}_decode"
    query = bind(name, f"{name}_clusters",
                 [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    w_flag = int(w_dtype == torch.bfloat16)
    u_flag = int((u_dtype or w_dtype) == torch.bfloat16)
    S, n = ctypes.c_int(0), ctypes.c_int(0)
    launched(f"{name} (cluster occupancy)",
             query(B, H, w_flag, u_flag, ctypes.addressof(S),
                   ctypes.addressof(n)), KernelLaunchRefused)
    return S.value, n.value


#: The sequence kernels' plan (csrc/seq_cluster.cuh): the shared memory a
#: CTA may opt in to, the widest H, and what a CTA's shared memory holds
#: besides U: its threads' partials for up to _SEQ_ROWS batch rows, and
#: the per-thread rings of a CTA that streams part of U.
SEQ_MAX_SMEM = 232448
SEQ_MAX_H = DECODE_MAX_H
_SEQ_THREADS = 512
_SEQ_ROWS = 4
_SEQ_RING_BYTES = 64 * 1024


def seq_limit(name: str, H: int) -> None:
    """Refuse a sequence-kernel launch past the widest H its cluster takes
    (SEQ_MAX_H): ``KernelLaunchRefused``, which the guarded execution
    ladder re-raises instead of retrying the slot per step, as the decode
    kernels' refusals are.  The CUDA wrappers call it before any other
    check."""
    if H > SEQ_MAX_H:
        raise KernelLaunchRefused(
            f"{name}: the sequence kernels take H <= {SEQ_MAX_H}, got H={H}")


def seq_splits(H: int, gates: int, u_bytes: int, Hr: int) -> int:
    """S, the CTAs of a sequence kernel's cluster, from (H, gates, U's
    element size, Hr) alone -- never from B, G or T, so each output's fp32
    sum order is the same at every batch: the decode kernels' split of
    (H, gates).  Raises ValueError past H <= SEQ_MAX_H or 0 <= Hr <= H."""
    if not 1 <= H <= SEQ_MAX_H:
        raise ValueError(f"lstm_seq / gru_seq take 1 <= H <= {SEQ_MAX_H}, "
                         f"got H={H}")
    if not 0 <= Hr <= H:
        raise ValueError(f"lstm_seq / gru_seq take 0 <= Hr <= H, got "
                         f"Hr={Hr}, H={H}")
    return decode_splits(H, gates)


def seq_smem(H: int, gates: int, u_bytes: int, Hr: int) -> int:
    """Bytes of shared memory a sequence-kernel CTA takes (``plan`` in
    csrc/seq_cluster.cuh): two mbarriers, the rows index, two h buffers
    and the partials, plus the whole of its slice of U where every CTA's
    fits in SEQ_MAX_SMEM, else a ring (where H % 4 == 0) and as many
    leading rows of each thread's share of U as the rest holds."""
    S = seq_splits(H, gates, u_bytes, Hr)
    A = decode_unit_align(H)
    V = 8 if A == 8 and u_bytes <= 2 else 4 if A >= 4 else 1
    fixed = (16 + round_up(4 * Hr, 16)
             + 4 * (2 * _SEQ_ROWS * H + _SEQ_THREADS * _SEQ_ROWS * V))
    rows = []  # (rows of U a thread holds, bytes of one such row) a rank
    n = H // A
    for rank in range(S):
        Q = gates * ((rank + 1) * n // S - rank * n // S) * A // V
        KG = _SEQ_THREADS // Q
        rows.append((cdiv(Hr, KG), KG * Q * V * u_bytes))
    full = max(KR * rb for KR, rb in rows)
    if fixed + full <= SEQ_MAX_SMEM:
        return fixed + full
    ring = _SEQ_RING_BYTES if V > 1 else 0
    room = SEQ_MAX_SMEM - min(SEQ_MAX_SMEM, fixed + ring)
    return fixed + ring + max(min(KR, room // rb) * rb for KR, rb in rows)


def seq_shape(family: str, B: int, H: int, Hr: int, u_dtype) -> dict:
    """What the ``family`` ("lstm" or "gru") sequence kernel's C side
    takes for a launch at (B, H, Hr, U's dtype), without launching: S,
    rows a cluster (R), ring bytes (0: U resident), shared memory a CTA,
    and how many such clusters the current card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    import ctypes

    from repro_torch.kernels.build import bind

    name = f"{family}_seq"
    query = bind(name, f"{name}_shape",
                 [ctypes.c_int] * 4 + [ctypes.c_void_p])
    u_type = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[u_dtype]
    out = (ctypes.c_int * 5)()
    launched(f"{name} (shape query)",
             query(B, H, Hr, u_type, ctypes.addressof(out)),
             KernelLaunchRefused)
    return dict(zip(("S", "R", "ring", "smem", "clusters"), out))


#: The cell kernel's split (csrc/lstm_cell.cu): hidden units a CTA, its
#: threads, the most rows a CTA takes, and the widest H whose h rows (4 of
#: them, in fp32) fit a CTA's shared memory at every B -- the limit of the
#: design before it as well.
CELL_UNITS = 8
CELL_THREADS = 256
CELL_ROWS = 4
CELL_MAX_H = SEQ_MAX_SMEM // (4 * CELL_ROWS)


def cell_split(H: int, u_bytes: int) -> dict:
    """The cell kernel's split of one step, from (H, U's element size)
    alone -- never from B or a timing, so each output is summed in the same
    order at every batch: ``ctas`` slices of CELL_UNITS hidden units (the
    last may be narrower), each slice's 4 · CELL_UNITS gate columns as
    ``Q`` vectors of ``V`` units (16-byte loads of 8 bf16 values where H %
    8 == 0, 4 values where H % 4 == 0, else 1), the H rows as ``KG``
    contiguous groups of ``KR`` rows, one thread per (group, vector)."""
    if H < 1:
        raise ValueError(f"lstm_cell takes H >= 1, got H={H}")
    A = decode_unit_align(H)
    V = 8 if A == 8 and u_bytes == 2 else 4 if A >= 4 else 1
    Q = 4 * CELL_UNITS // V
    KG = CELL_THREADS // Q
    return dict(ctas=cdiv(H, CELL_UNITS), V=V, Q=Q, KG=KG, KR=cdiv(H, KG))


def cell_smem(H: int, u_bytes: int, B: int) -> int:
    """Bytes of shared memory a cell-kernel CTA takes at batch B: its rows'
    h in fp32, whose bytes then take the KG partials of its 4 · CELL_UNITS
    columns and rows (the rows a CTA holds: 4 from B = 3 on, else B)."""
    rows = CELL_ROWS if B >= 3 else B
    KG = cell_split(H, u_bytes)["KG"]
    return 4 * rows * max(H, KG * 4 * CELL_UNITS)


def cell_shape(B: int, H: int, u_dtype) -> dict:
    """What the C side of the cell kernel takes for a launch at (B, H, U's
    dtype), without launching: CTAs along x (unit slices) and y (groups of
    rows), V, KG and shared memory a CTA."""
    import ctypes

    from repro_torch.kernels.build import bind

    query = bind("lstm_cell", "lstm_cell_shape",
                 [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = (ctypes.c_int * 5)()
    launched("lstm_cell (shape query)",
             query(B, H, int(u_dtype == torch.bfloat16),
                   ctypes.addressof(out)), KernelLaunchRefused)
    return dict(zip(("ctas_x", "ctas_y", "V", "KG", "smem"), out))
