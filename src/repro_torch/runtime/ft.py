"""Fault-tolerant training runtime (the port of ``repro.runtime.ft``).

  * checkpoint/restart — async checkpoints every N steps; on ANY step
    failure the loop restores the last committed checkpoint and replays
    (the data pipeline is a pure function of the step index, so replay is
    exact).
  * restore — into the structure, dtypes and devices of the running state
    (``Checkpointer.restore``); with ``shardings`` (params, opt) — trees
    of ``sharding.NamedSharding`` — each leaf is laid out on the restarted
    job's mesh (elastic re-sharding).
  * straggler mitigation — per-step wall-time EWMA watchdog; steps slower
    than ``straggler_factor``x the EWMA are logged and counted (also used
    by the serving loop).
  * fault injection — ``failure_at_steps`` raises inside the loop to let
    tests prove the recovery path end-to-end.

Each step is fenced (``obs.fence``: the card's work done) and timed by
``obs.monotonic_s`` before the next one starts.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import Checkpointer
from repro_torch.runtime import obs

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 20
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2


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


class TrainLoop:
    """Drives (params, opt_state) through ``train_step`` with FT semantics."""

    def __init__(self, train_step: Callable, batch_fn: Callable[[int], Any],
                 cfg: FTConfig, shardings: Any = None):
        self.train_step = train_step
        self.batch_fn = batch_fn  # step -> device-ready batch (pure)
        self.cfg = cfg
        self.shardings = shardings  # (params, opt) NamedSharding trees
        self.ckpt = Checkpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.watchdog = StragglerWatchdog(cfg.straggler_factor, cfg.ewma_alpha)
        self.restarts = 0
        self.metrics_history: List[Dict] = []
        self.failure_at_steps: set = set()  # fault injection (tests)

    # ------------------------------------------------------------------
    def run(self, params, opt_state, start_step: int, num_steps: int):
        state = {"params": params, "opt": opt_state}
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                state, step = self._run_span(state, step, end)
            except Exception as e:  # noqa: BLE001 — any step failure
                self.restarts += 1
                log.error("step %d failed (%s); restart %d/%d",
                          getattr(self, "_current_step", step), e,
                          self.restarts, self.cfg.max_restarts)
                if self.restarts > self.cfg.max_restarts:
                    raise
                state, step = self._restore(state)
        self.ckpt.save(step, self._saveable(state), blocking=True)
        return state["params"], state["opt"], step

    def _run_span(self, state, step, end):
        while step < end:
            self._current_step = step
            if step in self.failure_at_steps:
                self.failure_at_steps.discard(step)
                raise RuntimeError(f"injected fault at step {step}")
            t0 = obs.monotonic_s()
            batch = self.batch_fn(step)
            params, opt, metrics = self.train_step(state["params"],
                                                   state["opt"], batch)
            obs.fence(params)
            state = {"params": params, "opt": opt}
            dt = obs.monotonic_s() - t0
            self.watchdog.observe(step, dt)
            self.metrics_history.append(
                {"step": step, "time_s": dt,
                 **{k: float(v) for k, v in metrics.items()}})
            step += 1
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save(step, self._saveable(state))
        return state, step

    def _saveable(self, state):
        return {"params": state["params"], "opt": state["opt"]}

    def _restore(self, like_state):
        self.ckpt.wait()
        last = self.ckpt.latest_step()
        if last is None:
            raise RuntimeError("no checkpoint to restore from")
        sh = None
        if self.shardings is not None and self.shardings[0] is not None:
            sh = {"params": self.shardings[0], "opt": self.shardings[1]}
        tree = self.ckpt.restore(last, self._saveable(like_state), sh)
        log.info("restored step %d", last)
        return {"params": tree["params"], "opt": tree["opt"]}, last


__all__ = ["FTConfig", "StragglerWatchdog", "TrainLoop"]
