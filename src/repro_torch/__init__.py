"""repro_torch: the PyTorch / CUDA port of ``repro`` (SHARP, arXiv:1911.01258)
for an NVIDIA H100.

The recurrent main path — ``rnn.compile`` and
``serving.RecurrentServingEngine`` over the tile dispatcher, for LSTM,
GRU and mixed lstm/gru stacks with fp32, bf16 or int8 and dense or
block-sparse recurrent weights, the off-timeline schedules, and rglru
items — and RecurrentGemma token serving (``models.transformer``,
``serving.ServingEngine``) run on the card through the hand-written
``lstm_seq``, ``lstm_decode``, ``lstm_cell``, ``gru_seq``, ``gru_decode``,
``rglru_scan``, ``mvm`` and ``decode_attention`` CUDA kernels, and on the
CPU through their plain PyTorch versions:

    from repro_torch import rnn
    compiled = rnn.compile(stack_or_config, rnn.ExecutionPolicy(...),
                           device="cuda")

Submodules load lazily, so ``import repro_torch`` stays cheap.  The
package imports neither ``jax`` nor ``repro``.
"""
from importlib import import_module

_SUBMODULES = ("analysis", "configs", "convert", "core", "dispatch",
               "kernels", "launch", "models", "rnn", "runtime", "serving")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        mod = import_module(f"repro_torch.{name}")
        globals()[name] = mod  # cache: next access skips __getattr__
        return mod
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_SUBMODULES)))
