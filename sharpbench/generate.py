"""The one traffic generator: every mix under ``traffic/`` is a file of
parameters that this module reads.

Lengths.  A length spec is ``{"dist": "uniform" | "loguniform" |
"lognormal", "min", "max"[, "median", "sigma"]}``.  A run does not draw
lengths independently: the spec's ``pool`` quantiles (the lengths at
probabilities (k + 0.5) / pool) form one fixed multiset, and the seed
only orders it, a fresh permutation each time the pool is used up.  Every
seed therefore brings the same work in another order, so two seeds differ
no more than two runs of one seed do.

Frames.  A request's input frames are a window of a tape of standard
normal frames times the configuration's ``frame_scale``, drawn from the
seed in one call on the device that serves them; the window's offset is
drawn from the seed too.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The ``n`` lengths of ``spec`` at probabilities (k + 0.5) / n."""
    lo, hi = int(spec["min"]), int(spec["max"])
    u = (np.arange(n) + 0.5) / n
    dist = spec["dist"]
    if dist == "uniform":
        x = lo + np.floor(u * (hi - lo + 1))
    elif dist == "loguniform":
        x = np.rint(np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo))))
    elif dist == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        x = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    else:
        raise ValueError(f"length dist {dist!r} unknown; allowed: uniform, "
                         "loguniform, lognormal")
    return np.clip(x, lo, hi).astype(np.int64)


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for one purpose of one run (``tags`` name it)."""
    return np.random.default_rng([int(seed) % 2**63, *tags])


def torch_seed(seed: int, *tags: int) -> int:
    return int(rng(seed, *tags).integers(0, 2**62))


class Lengths:
    """An endless stream of lengths: the spec's fixed pool, in an order
    the seed draws anew on every pass."""

    def __init__(self, spec: dict, pool: int, seed: int, tag: int):
        self.pool = quantiles(spec, pool)
        self.seed, self.tag = seed, tag
        self.passes = 0
        self.order: list = []

    def next(self) -> int:
        if not self.order:
            perm = rng(self.seed, self.tag, self.passes).permutation(
                len(self.pool))
            self.order = list(self.pool[perm][::-1])
            self.passes += 1
        return int(self.order.pop())

    def take(self, n: int) -> list:
        return [self.next() for _ in range(n)]


class Tape:
    """``frames`` standard-normal frames of width ``width`` times
    ``scale``, drawn in one call on ``device``; ``window(T)`` hands out
    windows at offsets drawn from the seed."""

    def __init__(self, frames: int, width: int, scale: float, seed: int,
                 tag: int, device):
        gen = torch.Generator(device=device).manual_seed(
            torch_seed(seed, tag))
        self.data = torch.randn((frames, width), generator=gen,
                                device=device) * scale
        self.offsets = rng(seed, tag, 1)

    def offset(self, T: int) -> int:
        if T > self.data.shape[0]:
            raise ValueError(f"a request of {T} frames is longer than the "
                             f"tape of {self.data.shape[0]}")
        return int(self.offsets.integers(0, self.data.shape[0] - T + 1))

    def window(self, off: int, T: int):
        return self.data[off:off + T]
