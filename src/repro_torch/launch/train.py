"""End-to-end training driver (the port of ``repro.launch.train``).

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --reduced --steps 50 --batch 8 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --reduced --steps 100 --compression int8 --fail-at 30   # FT demo

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch starcoder2-3b --reduced --mesh-model 2   # a 2x2 mesh

Runs on the card by default (``--device cuda``, through
``rnn.resolve_device``, which also keeps fp32 products out of TF32); the
weights are drawn from a ``torch.Generator`` on that device, seeded with
``--seed``.  Prints the reference's JSON summary (rank 0).

Under ``torchrun`` (``WORLD_SIZE`` > 1) the ranks form a process group
from torchrun's environment (NCCL on the card, gloo on the CPU), and
``host_mesh(model=--mesh-model)`` lays them out as a (data, model) mesh:
the params and optimizer state are sharded by ``param_specs`` and each
batch by ``batch_spec``, and a restart restores onto that mesh.  In a
single process ``--mesh-model`` > 1 raises.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch import tree as tr
from repro_torch.launch.mesh import host_mesh
from repro_torch.launch.steps import (TrainSettings, init_opt_state,
                                      make_train_step)
from repro_torch.models.layers.common import sharding_ctx
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, CompressionConfig
from repro_torch.rnn.compiled import resolve_device
from repro_torch.runtime import FTConfig, TrainLoop
from repro_torch.sharding.partition import (NamedSharding, batch_spec,
                                            distribute, param_shardings)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a fault at this step (FT demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu (their plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and args.mesh_model > 1:
        raise ValueError(
            f"--mesh-model {args.mesh_model} needs a process group of a "
            f"multiple of {args.mesh_model} ranks; this process has world "
            f"size 1: launch with torchrun --nproc-per-node "
            f"{args.mesh_model} -m repro_torch.launch.train ...")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    mesh = None
    if world > 1:
        mesh = _mesh(dev, args.mesh_model)

    settings = TrainSettings(
        adamw=AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5)),
        compression=CompressionConfig(scheme=args.compression),
        microbatches=args.microbatches,
    )

    data = SyntheticPipeline(DataConfig(
        vocab_size=max(cfg.vocab_size, 2), seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        embed_dim=cfg.d_model if cfg.embed_stub else 0))

    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed))
    opt_state = init_opt_state(cfg, params, settings)
    train_step = make_train_step(cfg, settings)
    p_sh = o_sh = None
    if mesh is not None:  # every rank drew the same tree: each keeps its shards
        p_sh = param_shardings(params, mesh)
        o_sh = param_shardings(opt_state, mesh)
        params = distribute(params, p_sh)
        opt_state = distribute(opt_state, o_sh)

    def batch_fn(step):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        if mesh is None:
            return batch
        return distribute(batch, tr.tree_map(
            lambda s: NamedSharding(mesh, s), batch_spec(mesh, batch)))

    loop = TrainLoop(train_step, batch_fn,
                     FTConfig(ckpt_dir=f"{args.ckpt_dir}/{cfg.name}",
                              ckpt_every=args.ckpt_every),
                     shardings=(p_sh, o_sh))
    if args.fail_at >= 0:
        loop.failure_at_steps.add(args.fail_at)

    t0 = time.time()
    with sharding_ctx(mesh):
        params, opt_state, step = loop.run(params, opt_state, 0, args.steps)
    wall = time.time() - t0

    hist = loop.metrics_history
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    tok_s = args.batch * args.seq * len(hist) / wall
    if mesh is not None and torch.distributed.get_rank() != 0:
        return loop
    print(json.dumps({
        "arch": cfg.name, "device": str(dev), "steps": step,
        "wall_s": round(wall, 1),
        "tokens_per_s": round(tok_s, 1),
        "loss_first5": round(float(first), 4),
        "loss_last5": round(float(last), 4),
        "restarts": loop.restarts,
        "stragglers": loop.watchdog.flagged,
    }, indent=1))
    if args.steps >= 20 and not last < first:
        raise AssertionError("training did not reduce loss")
    return loop


def _mesh(dev, model: int):
    """The (data, model) mesh over torchrun's ranks, the process group
    formed from its environment; each rank on its own card."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    torch.distributed.init_process_group(backend)
    return host_mesh(model=model, device_type=dev.type)


if __name__ == "__main__":
    main()
