"""Streams served by the program's session layer,
``repro_torch.serving.RecurrentServingEngine``, in a closed loop.

``clients`` clients each send a request (a prompt of frames, and a count
of frames to generate by feeding back the top layer's output), wait for
it to finish, and send the next at once, with no think time.  The loop
drives the engine through its public calls: ``submit``, ``step``, the
completions in ``done``, and the frames it has produced so far in
``prefill_out`` and ``generated``, which a client sees when ``step``
returns.

The order of work depends on the seed alone: requests finish after a
count of ticks, not of seconds, so every run of a seed sends the same
requests in the same order and a faster program only gets further.

The mix's parameters: ``clients``, ``max_batch`` (the engine's slots),
``prompt`` (a length spec, ``generate.quantiles``) and either
``utterance`` (a request's whole length: the frames after its prompt
are generated) or ``new`` (the count generated, drawn apart), ``pool``
(quantiles a pass), ``tape_frames`` (the frames prompts are cut from),
``warmup_ticks`` (ticks run before the window, so it opens in steady
state: every shape the window uses, built and cached), ``block`` (rows
of one reference call in the check, which compares every request the
window finished).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from sharpbench import generate, reference, weights
from sharpbench.drivers import kernel_launches

TAG_PROMPT, TAG_NEW, TAG_TAPE = 1, 2, 3


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans,
                 precision: str = "fp32"):
        from repro_torch import rnn
        from repro_torch.configs.base import ModelConfig
        from repro_torch.serving import RecurrentServingEngine

        if cfg["input"] != cfg["hidden"] or cfg["bidirectional"]:
            raise ValueError("a fed-back stream needs a unidirectional stack "
                             "whose input and hidden widths agree")
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.params = weights.draw(cfg, seed, device)
        model = ModelConfig(
            name=cfg["name"], family="rnn", n_layers=cfg["n_layers"],
            d_model=cfg["input"], n_heads=1, n_kv_heads=1, d_ff=0,
            vocab_size=0, lstm_hidden=cfg["hidden"],
            lstm_input=cfg["input"], scan_layers=False,
            dtype=cfg["weight_dtype"])
        eng = RecurrentServingEngine(model, self.params,
                                     max_batch=mix["max_batch"],
                                     rnn_family=cfg["family"], device=device)
        if precision != "fp32":
            # the control: the same engine on the program's own
            # lower-precision path (a policy the engine takes no argument
            # for)
            eng.compiled = rnn.compile(
                self.params, rnn.ExecutionPolicy(precision=precision,
                                                 on_fault=eng.on_fault),
                device=device)
            eng.tracer = eng.compiled.tracer
        self.engine = eng
        if spans.traced:
            spans.wrap(eng, "step", "step", work=False)
            # the engine reads the wave's outputs back at once
            spans.wrap(eng.compiled, "prefill", "prefill", timed=True)
            spans.wrap(eng.compiled, "decode", "decode")
        self.prompts = generate.Lengths(mix["prompt"], mix["pool"], seed,
                                        TAG_PROMPT)
        self.whole = "utterance" in mix
        self.news = generate.Lengths(mix["utterance" if self.whole
                                         else "new"], mix["pool"], seed,
                                     TAG_NEW)
        tape = generate.Tape(mix["tape_frames"], cfg["input"],
                             cfg["frame_scale"], seed, TAG_TAPE, device)
        self.tape = tape
        self.host_tape = tape.data.cpu().numpy()
        self.live = {}     # uid -> [offset, T, new, submitted, last, seen]
        self.next_uid = 0
        for _ in range(mix["clients"]):
            self._submit(time.perf_counter())
        for _ in range(mix["warmup_ticks"]):
            self._tick(record=None)

    def _submit(self, now: float):
        from repro_torch.serving import RecurrentRequest

        T, new = self.prompts.next(), self.news.next()
        if self.whole:
            if new < T:
                raise ValueError(f"an utterance of {new} frames is shorter "
                                 f"than its prompt of {T}")
            new -= T
        off = self.tape.offset(T)
        uid = self.next_uid
        self.next_uid += 1
        self.live[uid] = [off, T, new, now, None, 0]
        self.engine.submit(RecurrentRequest(
            uid=uid, frames=self.host_tape[off:off + T], max_new_frames=new))

    def _tick(self, record):
        """One engine step, then what each client sees: prompt outputs,
        new frames, finished requests; each finished client sends its
        next request.  ``record`` (the window's tallies) or None."""
        eng = self.engine
        eng.step()
        now = time.perf_counter()
        finished, eng.done = eng.done, []
        seen = [(req.uid, len(eng.generated[s]))
                for s, req in enumerate(eng.slots) if req is not None]
        seen += [(c.uid, len(c.generated)) for c in finished]
        for uid, n in seen:
            st = self.live[uid]
            if st[4] is None:  # its prompt's outputs came back
                st[4] = now
                if record is not None:
                    record["firsts_ms"].append((now - st[3]) * 1e3)
                    record["prompt_items"] += st[1]
                    record["uids"].add(uid)
            if n > st[5]:      # one new frame (a tick makes one a stream)
                if record is not None:
                    record["gaps_ms"].append((now - st[4]) * 1e3)
                    record["gen_items"] += n - st[5]
                    record["uids"].add(uid)
                st[4], st[5] = now, n
        for c in finished:
            off = self.live.pop(c.uid)[0]
            if record is not None:
                record["uids"].add(c.uid)
                if c.status != "ok":
                    record["failed"] += 1
                else:
                    record["done"].append((off, c.outputs, c.generated))
            self._submit(now)
        return now

    def run(self, seconds: float, spans) -> dict:
        eng, stats = self.engine, self.engine.compiled.stats
        record = {"firsts_ms": [], "gaps_ms": [], "prompt_items": 0,
                  "gen_items": 0, "uids": set(), "failed": 0, "done": []}
        before = (stats.plans_built, stats.decode_plans_built,
                  kernel_launches(), eng.decode_ticks, eng.prefill_waves,
                  stats.degraded_launches)
        spans.start()
        with spans.window():
            t0 = time.perf_counter()
            record["end"] = t0 + seconds
            now = t0
            while now < record["end"]:
                now = self._tick(record)
        record["trace"] = spans.stop()
        after = (stats.plans_built, stats.decode_plans_built,
                 kernel_launches(), eng.decode_ticks, eng.prefill_waves,
                 stats.degraded_launches)
        record["counters"] = dict(zip(
            ("plans_built", "decode_plans_built", "kernel_launches",
             "decode_ticks", "prefill_waves", "degraded_launches"),
            (a - b for a, b in zip(after, before))))
        record["window_s"] = now - t0
        record["items"] = record["prompt_items"] + record["gen_items"]
        record["attempted"] = len(record.pop("uids"))
        record["calls"] = list(spans.calls)
        return record

    def release(self):
        """Free the program's state before the reference runs."""
        self.engine = None

    def check(self, record, device) -> dict:
        """Every request the window finished, prompt and served frames,
        through the reference: the prompt, then the frames the engine fed
        back (its last prompt output, then each generated frame but the
        last).  Returns the widest gap between a served frame and the
        reference's, in blocks of rows of like length, and the launches
        the program's guarded ladder degraded to its per-step fallback in
        the window (the timed path left)."""
        degraded = record["counters"]["degraded_launches"]
        done = sorted(record["done"], key=lambda d: len(d[1]) + len(d[2]))
        if not done:
            return {"out_err": float("inf"), "degraded_launches": degraded}
        errs = []
        for i in range(0, len(done), self.mix["block"]):
            errs.append(self._block(done[i:i + self.mix["block"]], device))
        # a NaN anywhere reads NaN, which no limit passes
        return {"out_err": float(torch.stack(errs).max()),
                "degraded_launches": degraded}

    def _block(self, rows, device):
        lens = [len(o) + len(g) for _, o, g in rows]
        xs = torch.zeros((len(rows), max(lens), self.cfg["input"]),
                         dtype=torch.float32, device=device)
        served = torch.zeros((len(rows), max(lens), self.cfg["hidden"]),
                             dtype=torch.float32, device=device)
        for b, (off, out, gen) in enumerate(rows):
            T, n = len(out), len(gen)
            xs[b, :T] = self.tape.data[off:off + T]
            both = torch.as_tensor(np.concatenate([out, gen]), device=device)
            xs[b, T:T + n] = both[T - 1:T + n - 1]
            served[b, :T + n] = both
        ref = reference.stack(self.params["layers"], xs, lens)
        valid = (torch.arange(max(lens), device=device)[None, :]
                 < torch.as_tensor(lens, device=device)[:, None])
        return ((served - ref).abs() * valid[..., None]).max()
