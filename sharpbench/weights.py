"""A configuration's weights, drawn from the seed on the device that
serves them, in a few large calls, and bound in the configuration's
weight type.

Every W and U is a truncated normal (within two standard deviations)
times ``weight_gain / sqrt(fan_in)``, every b one times ``bias_scale``;
all are drawn in fp32 in ONE call into one buffer, scaled in place, and
cast in one more.  The stack is the program's layout: ``{"layers":
[{"W": (X_l, G*H), "U": (H, G*H), "b": (G*H,)}, ...]}``, a bidirectional
layer ``{"fwd": {...}, "bwd": {...}}``, each tensor a view of the buffer.
"""
from __future__ import annotations

import math

import torch

from sharpbench import families, generate, roofline

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def draw(cfg: dict, seed: int, device) -> dict:
    """The LSTM stack's weights; a family other than the LSTM stacks
    draws its own (``families/<family>.py``)."""
    if cfg["family"] != "lstm":
        return families.module(cfg["family"]).draw(cfg, seed, device)
    H, G = cfg["hidden"], roofline.GATES
    shapes = []  # (layer, direction, name, shape, scale)
    for l, X in enumerate(roofline.layer_inputs(cfg)):
        for d in range(roofline.dirs(cfg)):
            shapes += [(l, d, "W", (X, G * H),
                        cfg["weight_gain"] / math.sqrt(X)),
                       (l, d, "U", (H, G * H),
                        cfg["weight_gain"] / math.sqrt(H)),
                       (l, d, "b", (G * H,), cfg["bias_scale"])]
    total = sum(math.prod(s) for _, _, _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(
        generate.torch_seed(seed, 7))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    off, views = 0, []
    for _, _, _, shape, scale in shapes:
        n = math.prod(shape)
        flat[off:off + n].mul_(scale)
        views.append((off, n, shape))
        off += n
    flat = flat.to(DTYPES[cfg["weight_dtype"]])
    layers = [{} for _ in range(cfg["n_layers"])]
    for (l, d, name, _, _), (o, n, shape) in zip(shapes, views):
        half = layers[l] if not cfg["bidirectional"] else layers[l].setdefault(
            ("fwd", "bwd")[d], {})
        half[name] = flat[o:o + n].view(shape)
    return {"layers": layers}
