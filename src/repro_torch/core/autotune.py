"""Offline configuration table (paper §6.2.2).

The paper explores configurations offline and preloads a table mapping each
LSTM dimension to its optimal tile configuration; runtime reconfiguration is
a table lookup + mux select.  Here the table maps (rows, cols, macs) -> K
for the cycle model and (m, n) -> Pallas block shape for the kernels, and is
persisted as JSON next to the artifacts.

A copy of ``repro.core.autotune``: the table stays in memory unless
``save()`` writes it (and reads a saved one from the same path).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

from repro_torch.core.tiling import (REFERENCE, DeviceModel, TileConfig,
                                     select_block_shape, select_time_block,
                                     select_tile)

DEFAULT_PATH = os.path.join("artifacts", "autotune_table.json")


class ConfigTable:
    def __init__(self, path: str = DEFAULT_PATH):
        self.path = path
        self._tiles: Dict[str, int] = {}
        self._blocks: Dict[str, Tuple[int, int]] = {}
        self._seq_blocks: Dict[str, int] = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            self._tiles = data.get("tiles", {})
            self._blocks = {k: tuple(v) for k, v in data.get("blocks", {}).items()}
            self._seq_blocks = data.get("seq_blocks", {})

    # -- paper tile engine ------------------------------------------------
    def tile(self, rows: int, cols: int, macs: int) -> TileConfig:
        key = f"{rows}x{cols}@{macs}"
        if key not in self._tiles:
            self._tiles[key] = select_tile(rows, cols, macs).k
        return TileConfig(k=self._tiles[key], macs=macs)

    # -- Pallas blocks ----------------------------------------------------
    def block(self, m: int, n: int, **kw) -> Tuple[int, int]:
        key = f"{m}x{n}"
        if key not in self._blocks:
            self._blocks[key] = select_block_shape(m, n, **kw)
        return self._blocks[key]

    def seq_block(self, T: int, B: int, H: int, *, gates: int = 4,
                  precision: str = "fp32", density: float = 1.0,
                  device_model: DeviceModel = REFERENCE, **kw) -> int:
        """T-block for the sequence-fused recurrent kernels (LSTM: gates=4,
        GRU: gates=3).  Keys for gates=4 / fp32 / dense stay unsuffixed so
        older persisted tables remain valid; quantized (``p{precision}``)
        and block-sparse (``d{density}``) variants key separately — the
        narrowed resident-U footprint re-tunes them to larger stripes — and
        so does a device model other than the reference's
        (``@{model name}``), which admits other stripes."""
        key = f"{T}x{B}x{H}" if gates == 4 else f"{T}x{B}x{H}g{gates}"
        if precision != "fp32":
            key += f"p{precision}"
        if density != 1.0:
            key += f"d{round(density, 4):g}"
        if device_model != REFERENCE:
            key += f"@{device_model.name}"
        if key not in self._seq_blocks:
            self._seq_blocks[key] = select_time_block(
                T, B, H, gates=gates, precision=precision, density=density,
                device_model=device_model, **kw)
        return self._seq_blocks[key]

    def save(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"tiles": self._tiles, "blocks": self._blocks,
                       "seq_blocks": self._seq_blocks}, f, indent=1)


_GLOBAL: Optional[ConfigTable] = None


def table() -> ConfigTable:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = ConfigTable()
    return _GLOBAL
