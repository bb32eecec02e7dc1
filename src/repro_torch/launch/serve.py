"""Batched serving from the command line: a synthetic request stream through
the token engine (the port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --reduced --requests 12 --max-new 24 [--device cpu]

``--arch`` takes each token arch of ``repro_torch.configs.list_archs()``
(arctic-480b, olmoe-1b-7b, starcoder2-3b, deepseek-67b, h2o-danube-3-4b,
stablelm-12b, xlstm-125m, recurrentgemma-2b); the ``embed_stub`` archs (musicgen-large,
qwen2-vl-72b) take embeddings, not tokens, and serve through
``transformer.prefill`` / ``decode_step`` (the engine refuses them with
``PlanRejected``).  Runs on the card by default (``--device cuda``); the
weights are drawn from a ``torch.Generator`` on that device, seeded with
``--seed``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import transformer as tf
from repro_torch.rnn.compiled import resolve_device
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b",
                    help="a token arch of repro_torch.configs.list_archs()")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu (their plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed))
    engine = ServingEngine(cfg, params, max_batch=args.max_batch,
                           max_seq=args.max_seq, temperature=args.temperature,
                           seed=args.seed, device=dev)

    rng = np.random.default_rng(args.seed)
    total_prompt = 0
    for uid in range(args.requests):
        plen = int(rng.integers(4, args.max_seq // 4))
        total_prompt += plen
        engine.submit(Request(
            uid=uid,
            tokens=rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=args.max_new))

    t0 = time.time()
    done = engine.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    gen_tokens = sum(len(c.tokens) for c in done)
    print(json.dumps({
        "arch": cfg.name,
        "device": str(dev),
        "requests": len(done),
        "engine_ticks": engine.steps,
        "prompt_tokens": total_prompt,
        "generated_tokens": gen_tokens,
        "wall_s": round(wall, 2),
        "decode_tok_per_s": round(gen_tokens / wall, 1),
    }, indent=1))
    if len(done) != args.requests:
        raise RuntimeError(f"{len(done)} of {args.requests} requests "
                           "completed")
    return done


if __name__ == "__main__":
    main()
