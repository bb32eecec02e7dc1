"""Straggler detection for the serving loop (the ``StragglerWatchdog`` of
``repro.runtime.ft``; the training loop around it is not ported)."""
from __future__ import annotations

import logging
from typing import List, Optional

log = logging.getLogger("repro_torch.runtime")


class StragglerWatchdog:
    """Per-step wall-time EWMA detector: a step slower than ``factor`` x
    the EWMA is flagged (and kept out of the EWMA)."""

    def __init__(self, factor: float, alpha: float):
        self.factor = factor
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.flagged.append(step)
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                        step, dt, self.ewma)
        # EWMA excludes flagged outliers so one straggler doesn't mask the next
        if not slow:
            self.ewma = dt if self.ewma is None else (
                self.alpha * dt + (1 - self.alpha) * self.ewma)
        return slow
