"""Quantization and structured-sparsity utilities for the recurrent
weights (a copy of ``repro.kernels.quant``).

One int8 convention for the whole port: ``scale = absmax / 127``,
symmetric, clipped to [-127, 127].  Two transforms ride on it, both
applied to the *recurrent* matrix U only (the hoisted input GEMM keeps
full-precision W):

* **per-gate int8** (``quantize_per_gate`` / ``dequantize_per_gate``): one
  scale per gate slab of U (H, gates, H); the sequence kernels read the
  int8 payload, accumulate h·Uq in fp32 and multiply the accumulate by the
  (gates,) scale after the dot.
* **block-sparse row tiles** (``tile_bitmap`` / ``compact_rows``): U's
  input-row axis is cut into MXU_ROWS-row tiles; all-zero tiles are
  dropped and the kernels gather only the surviving rows of h.  Padding
  rows (one Ha for all G cells of a launch) carry zero U rows and index 0,
  so they add exactly 0.0.

``fake_quant_stack`` maps a parameter stack to the dequantized fp32 stack
the kernels effectively compute with, so
``core.schedules.reference_stack(fake_quant_stack(params, p), xs)`` is the
oracle for any precision.

Rounding follows the reference exactly: ``x / scale`` is a division (a
multiplication by ``1/scale`` can move a value across a .5 boundary), and
``torch.round`` rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.perfmodel import MXU_ROWS
from repro_torch.kernels.common import cdiv


def absmax_scale(x, axis=None):
    """Symmetric int8 scale(s): absmax / 127, floored away from zero."""
    a = x.abs()
    m = a.amax() if axis is None else a.amax(dim=axis)
    return torch.clamp_min(m, 1e-12) / 127.0


def quantize(x, scale):
    """Round x/scale to int8, clipped to the symmetric [-127, 127] range."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def int8_roundtrip(g):
    """Per-tensor absmax int8 round-trip (quantize then dequantize)."""
    scale = absmax_scale(g)
    return quantize(g, scale).float() * scale


def bf16_roundtrip(x):
    """bf16 fake-quant: values rounded through bfloat16, stored as fp32.
    bf16 -> fp32 is exact, so kernels consuming the round-tripped weights
    match the dequantized oracle bit for bit."""
    return torch.as_tensor(x).to(torch.bfloat16).float()


def quantize_per_gate(U):
    """Per-gate absmax int8 quantization of a recurrent matrix.

    U (H, gates, H) -> (q int8 (H, gates, H), scales (gates,) fp32)."""
    scales = absmax_scale(U, axis=(0, 2))
    return quantize(U, scales[None, :, None]), scales.float()


def dequantize_per_gate(q, scales):
    """Inverse of quantize_per_gate: int8 (H, gates, H) x (gates,) -> fp32."""
    return q.float() * scales[None, :, None]


# ---------------------------------------------------------------------------
# structured block sparsity over U's input-row axis (tile = MXU_ROWS)
# ---------------------------------------------------------------------------


def tile_bitmap(U, tile: int = MXU_ROWS):
    """Occupancy bitmap of U's input-row tiles: a length-cdiv(H, tile)
    tuple of 0/1, 1 iff any element in rows [t*tile, (t+1)*tile) is
    nonzero.  U is (H, gates*H) or (H, gates, H)."""
    U = torch.as_tensor(U)
    H = U.shape[0]
    flat = U.reshape(H, -1)
    return tuple(int(bool((flat[t * tile:(t + 1) * tile] != 0).any()))
                 for t in range(cdiv(H, tile)))


def stack_tile_maps(stack_params, tile: int = MXU_ROWS):
    """Per-layer tile bitmaps for a whole parameter stack (the WorkItem
    ``tile_map`` payload).  Bidirectional layers take the OR-union of the
    fwd/bwd halves: both directions share one slot launch, so a tile is
    skippable only if BOTH halves zero it."""
    maps = []
    for layer in stack_params["layers"]:
        if "fwd" in layer:
            f = tile_bitmap(layer["fwd"]["U"], tile)
            b = tile_bitmap(layer["bwd"]["U"], tile)
            maps.append(tuple(int(x or y) for x, y in zip(f, b)))
        else:
            maps.append(tile_bitmap(layer["U"], tile))
    return tuple(maps)


def active_row_indices(bitmap, H: int, tile: int = MXU_ROWS) -> List[int]:
    """The dense row indices covered by the bitmap's occupied tiles
    (partial last tile clipped to H)."""
    return [r for t, bit in enumerate(bitmap) if bit
            for r in range(t * tile, min((t + 1) * tile, H))]


def compact_rows(U, bitmap, tile: int = MXU_ROWS,
                 pad_to: Optional[int] = None):
    """Drop U's zero row-tiles.  U (H, gates, H) + bitmap ->
    (Uc (Ha, gates, H), rows (Ha,) int32) where Ha = pad_to (one width
    for all G cells of a launch) or the active-row count.  Padding rows are
    zero U rows pointing at index 0 — the gather reads a live h value
    there, but the zero weight row annihilates it exactly."""
    U = torch.as_tensor(U)
    H = U.shape[0]
    idx = active_row_indices(bitmap, H, tile)
    n_active = len(idx)
    Ha = n_active if pad_to is None else pad_to
    Ha = max(Ha, 1)  # an all-zero U still needs a non-empty dot operand
    if Ha < n_active:
        raise ValueError(f"pad_to={pad_to} < active rows {n_active}")
    rows = torch.tensor(idx + [0] * (Ha - n_active), dtype=torch.int32,
                        device=U.device)
    Uc = U.new_zeros((Ha,) + tuple(U.shape[1:]))
    if n_active:
        Uc[:n_active] = U[torch.tensor(idx, device=U.device)]
    return Uc, rows


def expand_rows(Uc, rows, H: int):
    """Inverse of compact_rows for the ladder's dense rungs: scatter-ADD
    the compacted rows back to (H, ...) — padding rows add 0.0 to row 0,
    so duplicates are harmless and the round-trip is exact."""
    dense = Uc.new_zeros((H,) + tuple(Uc.shape[1:]))
    return dense.index_add_(0, rows.long(), Uc)


def density(bitmap) -> float:
    """Occupied-tile fraction of a bitmap (1.0 for None/empty — dense)."""
    if not bitmap:
        return 1.0
    return sum(bitmap) / len(bitmap)


def stack_density(tile_map) -> float:
    """Mean per-layer density of a stack tile_map (None -> dense 1.0)."""
    if not tile_map:
        return 1.0
    return sum(density(m) for m in tile_map) / len(tile_map)


# ---------------------------------------------------------------------------
# the oracle-side transform
# ---------------------------------------------------------------------------


def fake_quant_half(half, precision: str):
    """One layer half with U round-tripped through ``precision`` (W and b
    untouched — the input GEMM stays full precision by design).  As in the
    reference, a bf16 U comes back as the fp32 dequantized values."""
    if precision == "fp32":
        return half
    U = torch.as_tensor(half["U"])
    H = U.shape[0]
    if precision == "bf16":
        Uq = bf16_roundtrip(U)
    elif precision == "int8":
        gates = U.shape[-1] // H if U.ndim == 2 else U.shape[1]
        q, s = quantize_per_gate(U.reshape(H, gates, H))
        Uq = dequantize_per_gate(q, s).reshape(U.shape)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    out = dict(half)
    out["U"] = Uq.to(U.dtype) if U.dtype == torch.float32 else Uq
    return out


def fake_quant_stack(stack_params, precision: str):
    """Dequantized-fp32 view of a parameter stack: each layer's recurrent
    matrix round-tripped through ``precision`` exactly as the executor's
    hoist does it (bidirectional halves independently)."""
    if precision == "fp32":
        return stack_params
    layers = []
    for layer in stack_params["layers"]:
        if "fwd" in layer:
            out = dict(layer)
            out["fwd"] = fake_quant_half(layer["fwd"], precision)
            out["bwd"] = fake_quant_half(layer["bwd"], precision)
            layers.append(out)
        else:
            layers.append(fake_quant_half(layer, precision))
    out = dict(stack_params)
    out["layers"] = layers
    return out


__all__ = [
    "absmax_scale", "quantize", "int8_roundtrip", "bf16_roundtrip",
    "quantize_per_gate", "dequantize_per_gate",
    "tile_bitmap", "stack_tile_maps", "active_row_indices", "compact_rows",
    "expand_rows", "density", "stack_density",
    "fake_quant_half", "fake_quant_stack",
]
