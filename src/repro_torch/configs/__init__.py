"""Architecture registry: ``--arch <id>`` resolution (the port of
``repro.configs``).

Every architecture of the reference: the decoders are served by the
transformer side (``models.transformer``, ``serving.ServingEngine``; the
``embed_stub`` archs musicgen-large and qwen2-vl-72b through
``transformer.prefill`` / ``decode_step`` with ``embeds``);
``sharp-lstm`` is the paper's own LSTM family (``rnn.compile``,
``serving.RecurrentServingEngine``).  An unknown name raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    H100, SHAPES, HardwareConfig, ModelConfig, ShapeConfig, supports_shape)

#: the reference's order (``repro.configs._ARCH_MODULES``)
_ARCH_MODULES: Dict[str, str] = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "sharp-lstm": "repro_torch.configs.sharp_lstm",
}


def list_archs(include_paper: bool = False) -> List[str]:
    """The architectures (the paper's LSTM family only with
    ``include_paper``)."""
    names = [n for n in _ARCH_MODULES if n != "sharp-lstm"]
    if include_paper:
        names.append("sharp-lstm")
    return names


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
