"""Whole utterances transcribed offline: one worker in a closed loop
sends a batch of ``batch`` utterances as ONE ``CompiledStack.prefill``
call (the program packs them into one plan), waits until the outputs
are on the device, and sends the next.

A batch's lengths come from the ``length`` spec (``generate.quantiles``,
``pool`` quantiles a pass, in the seed's order); each utterance is a
window of a tape of frames drawn on the device.  ``warmup_batches``
batches of the same traffic, from a stream of their own, run before the
window; ``sample_batches`` batches finished in the window, drawn from
the seed, and the one holding its longest utterance are compared with
the reference, every utterance in both directions.
"""
from __future__ import annotations

import time

import torch

from sharpbench import generate, reference, weights
from sharpbench.drivers import kernel_launches

TAG_LEN, TAG_WARM, TAG_TAPE, TAG_SAMPLE = 1, 2, 3, 4


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans,
                 precision: str = "fp32"):
        from repro_torch import rnn

        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = device
        self.params = weights.draw(cfg, seed, device)
        self.stack = rnn.compile(
            self.params, rnn.ExecutionPolicy(precision=precision),
            device=device)
        if spans.traced:
            # the loop synchronises after every batch
            spans.wrap(self.stack, "prefill", "prefill", timed=True)
        self.tape = generate.Tape(mix["tape_frames"], cfg["input"],
                                  cfg["frame_scale"], seed, TAG_TAPE, device)
        self.lengths = generate.Lengths(mix["length"], mix["pool"], seed,
                                        TAG_LEN)
        warm = generate.Lengths(mix["length"], mix["pool"], seed, TAG_WARM)
        for _ in range(mix["warmup_batches"]):
            self._batch(warm)

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _batch(self, lengths):
        lens = lengths.take(self.mix["batch"])
        offs = [self.tape.offset(T) for T in lens]
        outs = self.stack.prefill([self.tape.window(o, T)[None]
                                   for o, T in zip(offs, lens)])
        self._sync()
        return offs, lens, [ys[0] for ys, _ in outs]

    def run(self, seconds: float, spans) -> dict:
        stats = self.stack.stats
        rng = generate.rng(self.seed, TAG_SAMPLE)
        k = self.mix["sample_batches"]
        sample, longest, n = [], None, 0
        items = 0
        before = (stats.plans_built, kernel_launches(),
                  stats.degraded_launches)
        spans.start()
        with spans.window():
            t0 = time.perf_counter()
            now = t0
            while now < t0 + seconds:
                offs, lens, outs = self._batch(self.lengths)
                now = time.perf_counter()
                items += sum(lens)
                n += 1
                batch = (offs, lens, outs)
                if longest is None or max(lens) > max(longest[1]):
                    longest = batch
                if len(sample) < k:
                    sample.append(batch)
                else:
                    j = int(rng.integers(0, n))
                    if j < k:
                        sample[j] = batch
        trace = spans.stop()
        after = (stats.plans_built, kernel_launches(),
                 stats.degraded_launches)
        if all(b is not longest for b in sample):
            sample.append(longest)
        return {"window_s": now - t0, "items": items, "prompt_items": items,
                "gen_items": 0, "attempted": n * self.mix["batch"],
                "failed": 0, "sample": sample, "trace": trace,
                "counters": {"plans_built": after[0] - before[0],
                             "kernel_launches": after[1] - before[1],
                             "degraded_launches": after[2] - before[2],
                             "batches": n},
                "calls": list(spans.calls)}

    def release(self):
        """Free the program's state before the reference runs."""
        self.stack = None

    def check(self, record, device) -> dict:
        """Every utterance of the sampled batches through the reference:
        the widest gap between an output and the reference's, and the
        launches degraded to the per-step fallback in the window."""
        errs = []
        for offs, lens, outs in record["sample"]:
            xs = torch.zeros((len(lens), max(lens), self.cfg["input"]),
                             dtype=torch.float32, device=device)
            for b, (o, T) in enumerate(zip(offs, lens)):
                xs[b, :T] = self.tape.window(o, T)
            ref = reference.stack(self.params["layers"], xs, lens)
            for b, T in enumerate(lens):
                errs.append((outs[b].float() - ref[b, :T]).abs().max())
        # a NaN anywhere reads NaN, which no limit passes
        return {"out_err": float(torch.stack(errs).max()) if errs
                else float("inf"),
                "degraded_launches": record["counters"]["degraded_launches"]}
