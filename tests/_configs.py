"""The port's ``ModelConfig`` held to the reference's field by field: the
fields the reference has, as they are; the fields only the port has (the
Mamba-2 hybrid's sizes and the granite-4.0-h scalars), each at its
default, which leaves every reference architecture as it was."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def reference_fields(ours, ref) -> dict:
    """``dataclasses.asdict(ours)`` without the port's own fields, after
    asserting that each of those holds its default."""
    mine = dataclasses.asdict(ours)
    theirs = set(dataclasses.asdict(ref))
    own = {k: mine.pop(k) for k in set(mine) - theirs}
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)
                if f.name in own}
    assert own == defaults, own
    return mine
