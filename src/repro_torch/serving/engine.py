"""Batched token serving: continuous batching over a fixed slot pool — the
port of ``repro.serving.engine``.

Mechanics (as in the reference):
  * ``max_batch`` slots share one batched cache (allocated once).
  * Admission: a free slot gets the next queued request; its prompt runs as
    a single-request prefill whose cache rows are spliced into the batch
    cache (slot-local positions via the per-slot ``idx`` cursor; per-layer
    caches keep the slot on axis 0, stacked (L, B, ...) caches on axis 1).
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
``torch.inference_mode()``.

The reference jits its decode step; the port's counterpart is a captured
CUDA graph (``DecodeGraph``): one for the batched tick over the engine's
own cache, one for the batch-1 remainder steps over a static single-row
cache, each captured after its first (eager) step and replayed from then
on.  The decode step writes the attention rings in place
(``transformer.decode_step``) and ``decode_into`` copies the rest of the
new cache into the static one, so a replay runs on fixed buffers.  On the
CPU the same step runs eagerly.  Prefill stays eager: PyTorch has no
compile per bucket, and the buckets are kept because they set which
prompt tokens go through the decode step, and with it the numbers.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import COUNTED
from repro_torch.models import transformer as tf
from repro_torch.rnn.compiled import _to_device, resolve_device
from repro_torch.runtime.errors import PlanRejected, RequestTimeout


def _copy_new(old, t):
    if t is not old:
        old.copy_(t)


def decode_into(cfg: ModelConfig, params, cache, tokens):
    """One decode step over static buffers: ``transformer.decode_step`` on
    ``cache`` with ``tokens`` (B, 1), then every tensor of the new cache
    that is not already ``cache``'s own (the RG-LRU ``state``, the ``conv``
    state, ``idx``) copied into ``cache``'s.  Stacked caches' rings are
    ``cache``'s own, so only ``idx`` is copied.  Returns the fp32 logits
    (B, 1, vocab).  ``cache`` holds the advanced state afterwards."""
    logits, new = tf.decode_step(cfg, params, cache, {"tokens": tokens})
    tf.map_layers(_copy_new, cache["layers"], new["layers"])
    cache["idx"].copy_(new["idx"])
    return logits


class DecodeGraph:
    """The decode step at one batch size, over a static cache and a static
    (B, 1) token buffer: the port's counterpart of the reference's jitted
    ``decode_step``.

    Called with the step's tokens, it returns the step's logits.  On the
    CPU every call runs ``decode_into`` eagerly.  On the card the first
    call runs it eagerly on a side stream (which loads the kernels'
    libraries and creates cuBLAS's handle and workspace), then captures
    it into a ``torch.cuda.CUDAGraph``; every later call replays the graph
    (``replay``).  A capture runs no kernel, so capturing on the live
    buffers leaves the state as the eager step left it.  A failed capture
    raises.

    The kernel entry points count on the host, so a capture would count
    launches that never ran and a replay none that did: the capture's
    counts (``captured``) are taken back out, and each replay adds them
    once.  ``logits`` is the graph's static output, overwritten by the
    next replay."""

    def __init__(self, cfg: ModelConfig, params, cache):
        self.cfg, self.params, self.cache = cfg, params, cache
        self.tokens = torch.zeros((cache["idx"].shape[0], 1),
                                  dtype=torch.long,
                                  device=cache["idx"].device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits = None
        self.captured: dict = {}  # entry point -> (calls, launches)
        self.replays = 0

    def eager(self, cache=None, tokens=None):
        """The step run eagerly, on this graph's buffers by default."""
        return decode_into(self.cfg, self.params,
                           self.cache if cache is None else cache,
                           self.tokens if tokens is None else tokens)

    def __call__(self, tokens):
        self.tokens.copy_(tokens)
        if self.tokens.device.type != "cuda":
            return self.eager()
        if self.graph is None:
            return self._warm_and_capture()
        return self.replay()

    def replay(self):
        self.graph.replay()
        for fn, (calls, launches) in self.captured.items():
            fn.calls += calls
            fn.kernel_launches += launches
        self.replays += 1
        return self.logits

    def _warm_and_capture(self):
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(main.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits = self.eager()
        main.wait_stream(side)
        logits.record_stream(main)
        before = {fn: (fn.calls, fn.kernel_launches) for fn in COUNTED}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.logits = self.eager()
        for fn, (calls, launches) in before.items():
            got = (fn.calls - calls, fn.kernel_launches - launches)
            fn.calls, fn.kernel_launches = calls, launches
            if any(got):
                self.captured[fn] = got
        self.graph = graph
        return logits


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
            single = tf.init_cache(cfg, 1, max_seq, device=self.device)
        # the batched tick and the batch-1 remainder step (module doc)
        self.tick_graph = DecodeGraph(cfg, self.params, self.cache)
        self.single_graph = DecodeGraph(cfg, self.params, single)
        self._decode = lambda graph, tokens: graph(tokens)
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
        # per-layer caches are (B, ...): the slot lives on axis 0; stacked
        # caches are (L, B, ...): axis 1, as in the reference
        rows = slice(slot, slot + 1)
        tf.map_layers(lambda big, small: (big[:, rows] if self.cfg.scan_layers
                                          else big[rows]).copy_(small),
                      self.cache["layers"], req_cache["layers"])
        self.cache["idx"][slot] = req_cache["idx"][0]

    def _prefill_bucketed(self, tokens):
        """Prefill a (1, L) prompt through the largest power-of-two prefix
        b <= L; the L - b remainder tokens advance through batch-1 decode
        steps.  Returns (last_token_logits (1, V), cache)."""
        L = tokens.shape[1]
        bucket = 1 << (L.bit_length() - 1)  # largest power of two <= L
        self.prefill_lengths.add(bucket)
        logits, cache = self._prefill(self.params, tokens[:, :bucket])
        if bucket == L:
            return logits[:, -1], cache
        # the remainder through the batch-1 step, on its static cache; the
        # logits are the graph's static output, sampled before its next run
        single = self.single_graph.cache
        tf.map_layers(torch.Tensor.copy_, single["layers"], cache["layers"])
        single["idx"].copy_(cache["idx"])
        for t in range(bucket, L):
            last = self._decode(self.single_graph, tokens[:, t:t + 1])[:, -1]
        return last, single

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
        logits = self._decode(self.tick_graph,
                              torch.from_numpy(self.last_token))
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
