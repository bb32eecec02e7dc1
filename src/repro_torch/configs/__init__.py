"""Architecture registry: ``--arch <id>`` resolution (the port of
``repro.configs``, for the architectures the port carries).

``recurrentgemma-2b`` is served by the transformer side
(``models.transformer``, ``serving.ServingEngine``); ``sharp-lstm`` is the
paper's own LSTM family (``rnn.compile``, ``serving.RecurrentServingEngine``).
The reference's other architectures raise ``NotImplementedError`` naming
what they need from ROADMAP.md's 'Queued in the port' list; an unknown
name raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig  # noqa: F401 (re-export)
from repro_torch.runtime.errors import not_ported

_ARCH_MODULES: Dict[str, str] = {
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "sharp-lstm": "repro_torch.configs.sharp_lstm",
}

#: the reference's architectures the port does not carry yet -> (what they
#: need, their items in ROADMAP.md's 'Queued in the port' list)
_NOT_PORTED: Dict[str, tuple] = {
    "arctic-480b": ("stacked layers and the MoE FFN", "P6, P7"),
    "olmoe-1b-7b": ("stacked layers and the MoE FFN", "P6, P7"),
    "starcoder2-3b": ("stacked layers", "P6"),
    "deepseek-67b": ("stacked layers", "P6"),
    "h2o-danube-3-4b": ("stacked layers", "P6"),
    "stablelm-12b": ("stacked layers", "P6"),
    "musicgen-large": ("stacked layers and a stub frontend", "P6, P10"),
    "xlstm-125m": ("mLSTM/sLSTM blocks", "P8"),
    "qwen2-vl-72b": ("stacked layers, M-RoPE and a stub frontend",
                     "P6, P9, P10"),
}


def list_archs(include_paper: bool = False) -> List[str]:
    """The architectures the port carries (the paper's LSTM family only
    with ``include_paper``)."""
    names = [n for n in _ARCH_MODULES if n != "sharp-lstm"]
    if include_paper:
        names.append("sharp-lstm")
    return names


def _module(name: str):
    if name in _NOT_PORTED:
        needs, items = _NOT_PORTED[name]
        raise not_ported(f"arch {name!r} ({needs})", items)
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
