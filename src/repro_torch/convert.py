"""Parameter trees of the JAX package -> the port's tensors.

``from_jax(tree, device)`` walks a ``{"layers": [...]}`` stack (or any
nest of dicts, lists and tuples) and turns every array leaf into a torch
tensor on ``device`` with the same dtype and values.  Bidirectional
layers ({"fwd": ..., "bwd": ...}) carry across with both halves.

The leaves arrive as NumPy-convertible arrays (``numpy.asarray`` of a JAX
array).  A bfloat16 leaf is an ``ml_dtypes.bfloat16`` array, which
``torch.from_numpy`` refuses: it goes through float32 and then
``.to(torch.bfloat16)``, which is exact because every value is
bfloat16-representable.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def from_jax(tree, device="cpu"):
    """Convert a parameter tree of the JAX package (as NumPy-convertible
    leaves) into the same tree of torch tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax(v, device) for v in tree)
    return _leaf(tree, device)
