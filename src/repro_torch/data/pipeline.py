"""Deterministic synthetic token pipeline (sharded, checkpointable) — a
copy of ``repro.data.pipeline`` (numpy only; the port keeps its own copy,
and its batches equal the reference's bit for bit).

Two sources:
  * ``random``  — uniform tokens; for dry-runs and throughput benches.
  * ``markov``  — a fixed random bigram chain; has learnable structure so the
    end-to-end training examples show a real loss drop.  Its table is
    V x V float64: 20 GB at xlstm-125m's V = 50,304 and 524 GB at
    RecurrentGemma-2B's 256,000, so a full-vocabulary run takes
    ``random``.

Determinism: batch ``i`` is a pure function of (seed, i) — restarting from a
checkpoint at step ``i`` reproduces the exact stream (no hidden iterator
state), which is what makes the fault-tolerance story exact.  Per-host
sharding: each data-parallel host materializes only its slice
[host_id * per_host : (host_id+1) * per_host) of the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "markov"  # markov | random
    embed_dim: int = 0      # >0: emit precomputed embeddings (stub frontends)
    num_hosts: int = 1
    host_id: int = 0


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.per_host = cfg.global_batch // cfg.num_hosts
        if cfg.source == "markov":
            rng = np.random.default_rng(cfg.seed)
            # peaked bigram transition table -> learnable next-token structure
            logits = rng.normal(size=(cfg.vocab_size, cfg.vocab_size)) * 2.0
            self._trans = _softmax(logits)
        self._embed_rng_seed = cfg.seed + 17

    # ------------------------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The (host-local) batch for global step ``step`` — pure function."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id, 0xB10C))
        if cfg.source == "random":
            tokens = rng.integers(0, cfg.vocab_size,
                                  size=(self.per_host, cfg.seq_len),
                                  dtype=np.int32)
        else:
            tokens = np.empty((self.per_host, cfg.seq_len), np.int32)
            tokens[:, 0] = rng.integers(0, cfg.vocab_size, size=self.per_host)
            for t in range(1, cfg.seq_len):
                u = rng.random((self.per_host, 1))
                cdf = np.cumsum(self._trans[tokens[:, t - 1]], axis=-1)
                tokens[:, t] = (u > cdf).sum(axis=-1)
        out: Dict[str, np.ndarray] = {"tokens": tokens}
        if cfg.embed_dim:
            erng = np.random.default_rng((self._embed_rng_seed, step, cfg.host_id))
            out = {
                "embeds": erng.normal(size=(self.per_host, cfg.seq_len,
                                            cfg.embed_dim)).astype(np.float32),
                "labels": tokens,
            }
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
