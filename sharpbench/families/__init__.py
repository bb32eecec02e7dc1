"""Model families other than the LSTM stacks that ``roofline.py``,
``weights.py`` and ``reference.py`` cover: a configuration's ``family``
names ``families/<family>.py``, the benchmark's yardstick for that
family, kept here and imported from nowhere in the program.  It holds

- ``call_work(cfg, kind, args)``: (FLOPs, bytes) of one call of ``kind``
  that ``Spans.wrap(..., work=True)`` wraps, from its arguments;
- ``draw(cfg, seed, device)``: the weights, drawn from the seed on the
  device in a few large calls;
- ``flops_per_item(cfg)``: model FLOPs of one item (``mfu``).

The H100's peaks stay in ``roofline.py``, for every family.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
_LOADED: dict = {}


def module(family: str):
    """``families/<family>.py``, loaded once a process."""
    if family not in _LOADED:
        path = HERE / f"{family}.py"
        if not path.is_file():
            raise ValueError(f"family {family!r}: no {path.name} in "
                             f"{HERE}; the LSTM stacks need none")
        spec = importlib.util.spec_from_file_location(
            "sharpbench_family_" + family.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[family] = mod
    return _LOADED[family]
