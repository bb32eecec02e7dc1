"""Batched token serving: continuous batching over a fixed slot pool — the
port of ``repro.serving.engine``.

Mechanics (as in the reference):
  * ``max_batch`` slots share one batched cache (allocated once).
  * Admission: a free slot gets the next queued request; its prompt runs as
    a single-request prefill whose cache rows are spliced into the batch
    cache (slot-local positions via the per-slot ``idx`` cursor; the
    per-layer caches keep the slot on axis 0).
  * Prefill is *bucketed*: the prefill only ever sees power-of-two prompt
    lengths (the largest bucket <= the prompt); the remainder tokens run
    through batch-1 decode steps.  Chunked prefill + decode is positionally
    identical to a full prefill (causal attention, per-step recurrent
    updates), so results are exact in exact arithmetic.
  * Every engine tick decodes ALL active slots in one batched decode step;
    finished slots (EOS or max_new_tokens) free immediately.
Greedy sampling by default; temperature optional (an explicit
``torch.Generator`` seeded from ``seed``).

The engine runs on ``device`` ("cuda" by default: the decode step's
projections through the ``mvm`` kernel, its attention through the
``decode_attention`` kernel, each prefill's RG-LRU scans through
``rglru_scan``); without a card it raises, naming ``device="cpu"``, which
runs their plain versions.  Every step runs under
``torch.inference_mode()``.  The reference jits its prefill and decode;
PyTorch runs eagerly, so there is no compile per bucket here — the
buckets are kept because they set which prompt tokens go through the
decode step, and with it the numbers.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.rnn.compiled import _to_device, resolve_device
from repro_torch.runtime.errors import PlanRejected, RequestTimeout


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray  # (prompt_len,)
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    prompt_len: int


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 max_seq: int = 256, temperature: float = 0.0, seed: int = 0,
                 *, device="cuda"):
        if cfg.embed_stub:
            raise PlanRejected(
                "stub-frontend archs serve via the embeds API, not the "
                "token engine")
        tf.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.temperature = temperature
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        with torch.inference_mode():
            self.params = _to_device(params, self.device)
            self.cache = tf.init_cache(cfg, max_batch, max_seq,
                                       device=self.device)
        self._decode = lambda p, c, t: tf.decode_step(cfg, p, c,
                                                      {"tokens": t})
        self._prefill = lambda p, t: tf.prefill(cfg, p, {"tokens": t},
                                                seq_len=max_seq)

        self.prefill_lengths: set = set()  # distinct prefill bucket lengths

        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.generated: List[List[int]] = [[] for _ in range(max_batch)]
        self.last_token = np.zeros((max_batch, 1), np.int64)
        self.done: List[Completion] = []
        self.steps = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        if len(req.tokens) == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        self.queue.append(req)

    def _splice_cache(self, slot: int, req_cache):
        # per-layer caches are (B, ...): the slot lives on axis 0 (the
        # reference's scan-stacked (L, B, ...) caches are not ported, P6)
        for big, small in zip(self.cache["layers"], req_cache["layers"]):
            for key, t in big.items():
                t[slot:slot + 1] = small[key].to(t.dtype)
        self.cache["idx"][slot] = req_cache["idx"][0]

    def _prefill_bucketed(self, tokens):
        """Prefill a (1, L) prompt through the largest power-of-two prefix
        b <= L; the L - b remainder tokens advance through batch-1 decode
        steps.  Returns (last_token_logits (1, V), cache)."""
        L = tokens.shape[1]
        bucket = 1 << (L.bit_length() - 1)  # largest power of two <= L
        self.prefill_lengths.add(bucket)
        logits, cache = self._prefill(self.params, tokens[:, :bucket])
        last = logits[:, -1]
        for t in range(bucket, L):
            step_logits, cache = self._decode(
                self.params, cache, tokens[:, t:t + 1])
            last = step_logits[:, -1]
        return last, cache

    def _admit(self):
        """Admission wave: claim every free slot for the queue's head, then
        prefill the wave."""
        pairs = []
        for slot in range(self.max_batch):
            while self.slots[slot] is None and self.queue:
                req = self.queue.pop(0)
                if req.max_new_tokens <= 0:
                    # zero-token request: complete immediately — never
                    # occupies a slot, never reaches prefill/decode
                    self.done.append(Completion(req.uid, [], len(req.tokens)))
                    continue
                pairs.append((slot, req))
                self.slots[slot] = req
                break
        if not pairs:  # queue drained mid-tick (or only zero-token reqs)
            return
        self._prefill_admitted(pairs)

    def _prefill_admitted(self, pairs):
        """Per-request bucketed prefill spliced into the batch cache."""
        for slot, req in pairs:
            tokens = torch.as_tensor(np.asarray(req.tokens), dtype=torch.long,
                                     device=self.device)[None]
            logits, req_cache = self._prefill_bucketed(tokens)
            self._splice_cache(slot, req_cache)
            nxt = self._sample(logits)
            self.generated[slot] = [int(nxt[0])]
            self.last_token[slot, 0] = int(nxt[0])

    def _sample(self, logits) -> np.ndarray:
        """logits (B, V) -> (B,) token ids on the host."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0] \
            .cpu().numpy()

    def _retire(self):
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            gen = self.generated[slot]
            if len(gen) >= req.max_new_tokens or (gen and gen[-1] == req.eos_id):
                self.done.append(Completion(req.uid, gen, len(req.tokens)))
                self.slots[slot] = None

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self):
        """One engine tick: admit -> batched decode -> retire."""
        self._admit()
        if not any(s is not None for s in self.slots):
            return
        tokens = torch.as_tensor(self.last_token, device=self.device)
        logits, self.cache = self._decode(self.params, self.cache, tokens)
        nxt = self._sample(logits[:, 0])
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self.generated[slot].append(int(nxt[slot]))
            self.last_token[slot, 0] = int(nxt[slot])
        self.steps += 1
        self._retire()

    def run_to_completion(self, max_ticks: int = 10_000) -> List[Completion]:
        while (self.queue or any(s is not None for s in self.slots)):
            self.step()
            if self.steps > max_ticks:
                in_flight = [s.uid for s in self.slots if s is not None]
                raise RequestTimeout(
                    f"engine did not drain within {max_ticks} ticks "
                    f"({len(self.queue)} queued, uids {in_flight} in "
                    "flight)", uids=in_flight, done=self.done)
        return self.done
