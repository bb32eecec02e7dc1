"""Token sessions served by the program's token engine,
``repro_torch.serving.ServingEngine``, in a closed loop.

``clients`` clients each send a request (a prompt of token ids and a count
of tokens to generate), wait for it to finish, and send the next at once,
with no think time.  Decoding is greedy with no end-of-sequence token, so
a request runs to its drawn count.  The loop drives the engine through
``submit``, ``step``, the completions in ``done`` and the tokens of
``generated``, which a client sees when ``step`` returns.  The order of
work depends on the seed alone: a request finishes after a count of
ticks, not of seconds.

An item is a prompt token whose prefill came back or a generated token.

The mix's parameters: ``clients``, ``max_batch`` (the engine's slots),
``max_seq`` (its cache's positions), ``prompt`` and ``new`` (length specs,
``generate.quantiles``), ``pool`` (quantiles a pass), ``warmup_ticks``
(ticks before the window: both decode graphs captured, every slot busy).
Prompt ids are uniform over the vocabulary, drawn from the seed.

The check compares logits, never sampled tokens.  In each window the
driver watches two requests from their admission: one drawn from the
seed (the first or the second admitted in the window) and the first
long one admitted (its ``new`` in the top quarter of the mix's range).
Of each it keeps the logits row its first token was sampled from (the
prompt's last position) and the row of every decode tick that served it,
copied on the card out of the tick graph's static logits, until it
finishes or the window closes; a window closes at its seconds, or later
at the first tick after a watched request was admitted.  ``check`` runs
the family's reference teacher forced on the prompt and the tokens the
engine fed itself, and reads ``out_err``: the largest, over the
kept positions, of the RMS over the vocabulary of served - reference,
over the RMS of the reference's kept logits.  A position's RMS over
100,352 logits is a steady estimate, so the program's bf16 rounding
reads about the same at every position, while an error that grows along
a sequence (a state held in a lower precision, a state lost) or sits at
a few positions shows at its worst; the largest single logit would be
the tail of the rounding instead.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from sharpbench import families, generate
from sharpbench.families import mamba_hybrid_reference as reference

TAG_PROMPT, TAG_NEW, TAG_TOKENS, TAG_WATCH = 1, 2, 3, 4
KINDS = {"mamba": "mamba2", "attention": "attn"}
#: ``precision``: the program as the configuration states it, and the
#: control, its weights one precision lower (``fp8_weights``)
PRECISIONS = ("fp32", "fp8_weights")
#: the largest finite float8 e4m3 value
FP8_MAX = 448.0
#: the engine's methods the driver wraps on the instance
WRAPPED = ("_prefill_bucketed", "_splice_cache", "_decode")


def fp8_weights(cfg: dict, params: dict) -> dict:
    """A copy of ``params`` with every projection and the tied table
    rounded through float8 e4m3, each output column of a projection (each
    row of the table) scaled so that its largest |value| maps to 448, then
    held in the weight type again; the other weights are shared."""
    def rounded(w, dim):
        scale = w.float().abs().amax(dim, keepdim=True).clamp_min(1e-30)
        scale = scale / FP8_MAX
        q = (w.float() / scale).to(torch.float8_e4m3fn).float() * scale
        return q.to(w.dtype)

    out = {**params, "head": dict(params["head"]),
           "layers": [{k: dict(v) if isinstance(v, dict) else v
                       for k, v in layer.items()}
                      for layer in params["layers"]]}
    for (_, l, block, name), _ in families.module(cfg["family"]).matrices(
            cfg):
        w = params["layers"][l][block][name]
        out["layers"][l][block][name] = rounded(w, 0)
    out["head"]["table"] = rounded(params["head"]["table"], 1)
    return out


def model_config(cfg: dict, precision: str = "fp32"):
    """The program's ``ModelConfig`` of a configuration in the Hugging Face
    keys."""
    from repro_torch.configs.base import ModelConfig

    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; allowed: "
                         f"{', '.join(PRECISIONS)}")
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    L = cfg["num_hidden_layers"]
    return ModelConfig(
        name=cfg["name"], family="hybrid", n_layers=L, d_model=d,
        n_heads=heads, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or d // heads,
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        block_pattern=tuple(KINDS[t] for t in cfg["layer_types"][:L]),
        mamba_n_heads=cfg["mamba_n_heads"], mamba_d_head=cfg["mamba_d_head"],
        mamba_d_state=cfg["mamba_d_state"],
        mamba_n_groups=cfg["mamba_n_groups"],
        mamba_d_conv=cfg["mamba_d_conv"], mamba_expand=cfg["mamba_expand"],
        mamba_chunk_size=cfg["mamba_chunk_size"],
        mamba_conv_bias=cfg["mamba_conv_bias"],
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        residual_multiplier=float(cfg["residual_multiplier"]),
        attention_multiplier=float(cfg["attention_multiplier"]),
        logits_scaling=float(cfg["logits_scaling"]),
        position_embedding=cfg["position_embedding_type"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], scan_layers=False,
        dtype=cfg["weight_dtype"])


class _Calls:
    """The decode calls the harness's spans wrap: the batched tick and a
    remainder step, each ``(graph, tokens)``."""

    @staticmethod
    def decode(graph, tokens):
        return graph(tokens)

    @staticmethod
    def remainder(graph, tokens):
        return graph(tokens)


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans,
                 precision: str = "fp32"):
        from repro_torch.serving import ServingEngine

        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.params = families.module(cfg["family"]).draw(cfg, seed, device)
        served = (fp8_weights(cfg, self.params) if precision == "fp8_weights"
                  else self.params)
        eng = ServingEngine(model_config(cfg, precision), served,
                            max_batch=mix["max_batch"],
                            max_seq=mix["max_seq"], device=device,
                            trace=spans.traced)
        self.engine = eng
        # the prompt's last logits row of each admitted request, and its
        # slot (the engine samples its first token from that row)
        prefill, splice = eng._prefill_bucketed, eng._splice_cache

        def prefill_kept(tokens):
            out = prefill(tokens)
            self._prompt_row = out[0]
            return out

        def splice_seen(slot, req_cache):
            splice(slot, req_cache)
            self._admitted(slot)

        eng._prefill_bucketed, eng._splice_cache = prefill_kept, splice_seen
        if spans.traced:
            calls = _Calls()
            spans.wrap(calls, "decode", "decode")
            spans.wrap(calls, "remainder", "remainder")
            eng._decode = lambda graph, tokens: (
                calls.decode if graph is eng.tick_graph
                else calls.remainder)(graph, tokens)
        self.prompts = generate.Lengths(mix["prompt"], mix["pool"], seed,
                                        TAG_PROMPT)
        self.news = generate.Lengths(mix["new"], mix["pool"], seed, TAG_NEW)
        lo, hi = mix["new"]["min"], mix["new"]["max"]
        self.long_new = lo + 0.75 * (hi - lo)
        self.live = {}     # uid -> [prompt, new, seen tokens]
        self.next_uid = 0
        self.lanes = None  # the watched requests of the open window
        self.windows = 0
        for _ in range(mix["clients"]):
            self._submit()
        for _ in range(mix["warmup_ticks"]):
            self._tick(record=None)

    # -- requests ------------------------------------------------------
    def _submit(self):
        from repro_torch.serving import Request

        T, new = self.prompts.next(), self.news.next()
        uid = self.next_uid
        self.next_uid += 1
        prompt = generate.rng(self.seed, TAG_TOKENS, uid).integers(
            0, self.cfg["vocab_size"], size=T)
        self.live[uid] = [prompt, new, 0]
        self.engine.submit(Request(uid=uid, tokens=prompt,
                                   max_new_tokens=new))

    def _admitted(self, slot):
        """A request's prefill came back into ``slot``: in a window, a free
        lane whose rule it meets watches it from here, keeping its first
        logits row."""
        if self.lanes is None:
            return
        uid = self.engine.slots[slot].uid
        prompt, new, _ = self.live[uid]
        drawn, long = self.lanes
        if drawn["uid"] is None:
            if drawn["skip"] == 0:
                lane = drawn
            else:
                drawn["skip"] -= 1
                lane = None
        else:
            lane = None
        if lane is None and long["uid"] is None and new >= self.long_new:
            lane = long
        if lane is None:
            return
        lane.update(uid=uid, prompt=prompt, slot=slot, n=1)
        lane["rows"] = torch.empty((new, self.cfg["vocab_size"]),
                                   dtype=torch.float32,
                                   device=self._prompt_row.device)
        lane["rows"][0].copy_(self._prompt_row[0])

    # -- the loop ------------------------------------------------------
    def _tick(self, record):
        """One engine step, then what each client sees; each finished
        client sends its next request.  ``record`` or None (warm-up)."""
        eng = self.engine
        eng.step()
        finished, eng.done = eng.done, []
        with torch.inference_mode():  # the rows are the engine's kind
            for lane in self.lanes or ():
                if lane["slot"] is not None and not lane["done"]:
                    lane["rows"][lane["n"]].copy_(
                        eng.tick_graph.logits[lane["slot"], 0])
                    lane["n"] += 1
        seen = [(req.uid, eng.generated[s])
                for s, req in enumerate(eng.slots) if req is not None]
        seen += [(c.uid, c.tokens) for c in finished]
        for uid, gen in seen:
            st = self.live[uid]
            if record is not None:
                if st[2] == 0:  # its prompt's prefill came back
                    record["prompt_items"] += len(st[0])
                record["gen_items"] += len(gen) - st[2]
                record["uids"].add(uid)
            st[2] = len(gen)
        for c in finished:
            for lane in self.lanes or ():
                if lane["uid"] == c.uid:
                    lane["done"], lane["tokens"] = True, c.tokens
            del self.live[c.uid]
            self._submit()

    def _lanes(self):
        skip = int(generate.rng(self.seed, TAG_WATCH, self.windows)
                   .integers(0, 2))
        blank = dict(uid=None, slot=None, rows=None, n=0, done=False,
                     tokens=None, prompt=None)
        return [dict(blank, skip=skip), dict(blank, skip=0)]

    def _kept(self):
        """What the window's watched requests produced: (prompt, the
        tokens fed after it, the logits rows kept)."""
        out = []
        for lane in self.lanes:
            if lane["rows"] is None:
                continue
            gen = (lane["tokens"] if lane["done"]
                   else self.engine.generated[lane["slot"]])
            n = lane["n"]
            out.append((lane["prompt"], list(gen[:n - 1]),
                        lane["rows"][:n]))
        return out

    def run(self, seconds: float, spans) -> dict:
        eng = self.engine
        record = {"prompt_items": 0, "gen_items": 0, "uids": set()}
        self.lanes = self._lanes()
        self.windows += 1
        before = (eng.steps, eng.remainder_steps, _launches(),
                  eng.tracer.totals())
        spans.start()
        with spans.window():
            t0 = time.perf_counter()
            end = t0 + seconds
            now = t0
            # the window closes at its seconds, but not before a watched
            # request has been admitted (a window has something to check)
            while now < end or not any(lane["n"] for lane in self.lanes):
                self._tick(record)
                now = time.perf_counter()
        record["trace"] = spans.stop()
        after = (eng.steps, eng.remainder_steps, _launches(),
                 eng.tracer.totals())
        record["counters"] = {
            "decode_ticks": after[0] - before[0],
            "remainder_steps": after[1] - before[1],
            "kernel_launches": after[2] - before[2]}
        record["spans_s"] = {
            name: (t["wall_us"] - before[3].get(name, {}).get("wall_us", 0.0))
            * 1e-6 for name, t in after[3].items()}
        record["window_s"] = now - t0
        record["items"] = record["prompt_items"] + record["gen_items"]
        record["attempted"] = len(record.pop("uids"))
        record["failed"] = 0  # the token engine fails no request alone
        record["calls"] = list(spans.calls)
        record["kept"] = self._kept()
        self.lanes = None
        return record

    def release(self):
        """Free the program's state before the reference runs.  The
        wrappers set on the engine refer to it and to this driver: a
        cycle, which the window's ``gc.freeze`` keeps from the collector,
        so they are taken off here and the engine's memory goes with its
        last reference."""
        for name in WRAPPED:
            self.engine.__dict__.pop(name, None)
        self.engine = self._prompt_row = None

    def check(self, record, device) -> dict:
        """The kept logits against the reference, teacher forced (module
        doc); inf where the window kept none."""
        row_worst, rsq, n = 0.0, 0.0, 0
        for prompt, fed, rows in record["kept"]:
            tokens = torch.as_tensor(np.concatenate([prompt, fed]),
                                     dtype=torch.long, device=device)
            ref = reference.logits(self.cfg, self.params, tokens,
                                   first=len(prompt) - 1)
            row_sq = (rows - ref).pow(2).mean(-1, dtype=torch.float64)
            row_worst = max(row_worst, float(row_sq.max()))
            rsq += float(ref.pow(2).sum(dtype=torch.float64))
            n += ref.numel()
        if not n:
            return {"out_err": math.inf}
        return {"out_err": math.sqrt(row_worst / (rsq / n))}


def _launches() -> int:
    from sharpbench.drivers import kernel_launches

    return kernel_launches()
