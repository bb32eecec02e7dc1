"""Step functions (train / prefill / serve) — the port of
``repro.launch.steps``.

``make_train_step`` takes the gradient of ``models.transformer.loss_fn``
by autograd (the reference's ``jax.value_and_grad``), accumulates
microbatches in fp32, compresses the gradient when asked and applies
AdamW.  Like the reference's jitted step, which donates its params and
optimizer state, it updates them in place and returns them
(``optim.optimizer``).  On CUDA tensors the RecurrentGemma blocks run the
``rglru_scan`` kernel forward and the ``rglru_scan_bwd`` kernel backward.

Under a mesh (``models.layers.common.sharding_ctx`` and DTensor params,
``sharding.partition``) the same step runs on DTensors: each gradient is
reduced to its parameter's placements (``_as_param``) before the update.
The abstract inputs of a step (``batch_struct``, ``input_specs``) are
tensors on the ``meta`` device: shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.common import trips
from repro_torch.models import transformer as tf
from repro_torch.optim import (AdamWConfig, CompressionConfig, apply_updates,
                               compress, init_error_state, init_state)
from repro_torch.sharding.partition import is_dtensor


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    adamw: AdamWConfig = AdamWConfig()
    compression: CompressionConfig = CompressionConfig()
    microbatches: int = 1


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _as_param(g, p):
    """A gradient laid out as its parameter: under a mesh a DTensor
    gradient comes out of autograd as the backward left it (a sum over
    the batch's shards is ``Partial``), and is reduced or resharded to
    the parameter's placements, as GSPMD gives a gradient its
    parameter's sharding."""
    if is_dtensor(p) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _whole(t):
    """A scalar metric as a plain tensor (a DTensor's reduced value)."""
    return t.full_tensor() if is_dtensor(t) else t


def value_and_grad(cfg: ModelConfig, params, batch):
    """((total, metrics), grads): ``loss_fn`` and its gradient in each
    leaf's dtype (zeros for a leaf the loss does not reach, as
    ``jax.grad`` gives).  The parameters themselves are left as they are:
    the gradient is taken through detached views of them."""
    flat = tr.leaves(params)
    views = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        total, metrics = tf.loss_fn(cfg, tr.unflatten(params, views), batch)
        grads = torch.autograd.grad(total, views, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _as_param(g, p)
             for p, g in zip(flat, grads)]
    metrics = {k: _whole(v.detach()) for k, v in metrics.items()}
    return (_whole(total.detach()), metrics), tr.unflatten(params, grads)


def make_train_step(cfg: ModelConfig, settings: TrainSettings = TrainSettings()):
    n_micro = settings.microbatches

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            (loss, metrics), grads = value_and_grad(cfg, params, batch)
        else:
            # gradient accumulation over microbatches, in fp32
            def micro(x, i):
                x = x.reshape((n_micro, x.shape[0] // n_micro)
                              + tuple(x.shape[1:]))
                return x[i]

            g_acc = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tr.leaves(params)]
            loss_sum = None
            for i in trips(n_micro, closed=True):
                mb = {k: micro(v, i) for k, v in batch.items()}
                (loss, _), g = value_and_grad(cfg, params, mb)
                for a, b in zip(g_acc, tr.leaves(g)):
                    a.add_(b.float())
                loss_sum = loss if loss_sum is None else loss_sum + loss
                del g
            grads = tr.unflatten(params, [a / n_micro for a in g_acc])
            del g_acc
            loss = loss_sum / n_micro
            metrics = {"loss": loss,
                       "aux_loss": torch.zeros((), dtype=torch.float32,
                                               device=loss.device)}

        if settings.compression.scheme != "none":
            grads, new_err = compress(settings.compression, grads,
                                      opt_state["err"])
        new_params, new_opt, om = apply_updates(
            settings.adamw, params, grads, opt_state["adam"])
        out_state: Dict[str, Any] = {"adam": new_opt}
        if settings.compression.scheme != "none":
            out_state["err"] = new_err
        elif "err" in opt_state:
            out_state["err"] = opt_state["err"]
        om = {k: _whole(v) for k, v in om.items()}
        return new_params, out_state, {**metrics, **om}

    return train_step


def init_opt_state(cfg: ModelConfig, params,
                   settings: TrainSettings = TrainSettings()):
    state: Dict[str, Any] = {"adam": init_state(params)}
    if settings.compression.scheme != "none":
        state["err"] = init_error_state(params)
    return state


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, seq_len: int):
    def prefill_step(params, batch):
        logits, cache = tf.prefill(cfg, params, batch, seq_len=seq_len)
        return logits[:, -1:], cache  # serving returns next-token logits only

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, batch):
        logits, new_cache = tf.decode_step(cfg, params, cache, batch)
        return logits, new_cache

    return serve_step


# ---------------------------------------------------------------------------
# abstract inputs (meta-device stand-ins; no allocation)
# ---------------------------------------------------------------------------


def batch_struct(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    meta = torch.device("meta")
    if cfg.embed_stub:
        return {
            "embeds": torch.empty((batch, seq, cfg.d_model),
                                  dtype=torch.bfloat16, device=meta),
            "labels": torch.empty((batch, seq), dtype=torch.int32,
                                  device=meta),
        }
    return {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                  device=meta)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                settings: TrainSettings = TrainSettings(), seed: int = 0
                ) -> Dict[str, Any]:
    """Abstract (``meta``-device) arguments for the step of ``shape.mode``:
    the params (drawn from no generator: a meta tensor has no values), the
    optimizer state, the batch and, for decode, the cache."""
    meta = torch.device("meta")
    gen = torch.Generator().manual_seed(seed)
    params = tf.init_params(cfg, gen, device=meta)
    if shape.mode == "train":
        opt = init_opt_state(cfg, params, settings)
        batch = batch_struct(cfg, shape.global_batch, shape.seq_len)
        return {"params": params, "opt_state": opt, "batch": batch}
    if shape.mode == "prefill":
        batch = batch_struct(cfg, shape.global_batch, shape.seq_len)
        return {"params": params, "batch": batch}
    if shape.mode == "decode":
        cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                              device=meta)
        if cfg.embed_stub:
            batch = {"embeds": torch.empty(
                (shape.global_batch, 1, cfg.d_model), dtype=torch.bfloat16,
                device=meta)}
        else:
            batch = {"tokens": torch.empty((shape.global_batch, 1),
                                           dtype=torch.int32, device=meta)}
        return {"params": params, "cache": cache, "batch": batch}
    raise ValueError(shape.mode)


__all__ = ["TrainSettings", "value_and_grad", "make_train_step",
           "init_opt_state", "make_prefill_step", "make_serve_step",
           "batch_struct", "input_specs"]
