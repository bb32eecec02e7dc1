"""AdamW with global-norm clipping and a warmup-cosine schedule (the port
of ``repro.optim.optimizer``).

Moments are fp32 whatever the parameters' dtype.  ``apply_updates`` gives
the reference's numbers: the gradient clipped as ``clip_by_global_norm``
clips it (g in fp32 times one scale), then per leaf the same fp32
operations in the same order, decay on leaves with ndim >= 2 only.  Two
things differ from the reference's functional code, neither a number:

* the clipped fp32 gradient is made leaf by leaf inside the update, not as
  a whole tree first (the reference's tree would hold 14.2 GB at once for
  RecurrentGemma-2B), so one leaf's fp32 temporaries are alive at a time;
* the new parameters, m and v are written into the given tensors, in
  place, and returned — as the reference's jitted step, which donates its
  params and optimizer state (``donate_argnums=(0, 1)``), leaves its
  inputs no longer usable.  A caller that needs the old values clones
  them first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch import tree as tr


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The fp32 learning rate at ``step`` (an int or a tensor; a tensor's
    device is kept, so a step on the card never waits for the host)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> Dict[str, Any]:
    """{"m", "v": fp32 zeros like each leaf, "count": int32 0} on the
    parameters' device."""
    flat = tr.leaves(params)
    dev = flat[0].device if flat else "cpu"
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {
        "m": tr.tree_map(zeros, params),
        "v": tr.tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in flatten order) of each leaf's
    sum of squares in fp32."""
    sums = [torch.sum(torch.square(x.float())) for x in tr.leaves(tree)]
    return torch.sqrt(sum(sums))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(the fp32 gradient times min(1, max_norm / norm), norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tr.tree_map(lambda g: g.float() * scale, grads), norm


def apply_updates(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}).  The
    new params and moments are the given tensors, updated in place (module
    doc); ``count`` is a new tensor."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.clip_norm)
    count = state["count"] + 1
    cf = count.to(torch.float32)
    lr = lr_at(cfg, state["count"])
    bc1 = 1 - cfg.b1 ** cf
    bc2 = 1 - cfg.b2 ** cf

    flat_p = tr.leaves(params)
    flat_g = tr.leaves(grads)
    flat_m = tr.leaves(state["m"])
    flat_v = tr.leaves(state["v"])
    if not (len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v)):
        raise ValueError("apply_updates: params, grads and state differ in "
                         "structure")
    with torch.no_grad():
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g = g.float() * scale                      # the clipped leaf
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g.square_())
            del g
            step = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
            pf = p.float()
            if p.ndim >= 2:  # decay matrices only (norms/bias exempt)
                step.add_(cfg.weight_decay * pf)
            p.copy_(pf - step.mul_(lr))
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    return params, new_state, {"grad_norm": norm, "lr": lr}


__all__ = ["AdamWConfig", "lr_at", "init_state", "global_norm",
           "clip_by_global_norm", "apply_updates"]
