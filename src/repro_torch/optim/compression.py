"""Gradient compression with error feedback (the port of
``repro.optim.compression``).

Two schemes:
  * int8: per-tensor absmax scaling; the all-reduce across the slow axis
    would then move 4x fewer bytes.
  * topk: keep the largest-|g| fraction per tensor, zero the rest.

Both carry an error-feedback residual e_t (Karimireddy et al., 2019):
    c_t = C(g_t + e_{t-1});  e_t = (g_t + e_{t-1}) - c_t
which restores convergence despite the lossy operator.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as tr
# the one absmax int8 round-trip of the port (shared with the recurrent
# weights' per-gate quantizer)
from repro_torch.kernels.quant import int8_roundtrip as _int8_roundtrip


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"  # none | int8 | topk
    topk_frac: float = 0.01


def init_error_state(params):
    return tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def _topk_roundtrip(g, frac: float):
    """Keep the entries with |g| at least the k-th largest |g| (k = frac of
    the entries, at least 1): the threshold ``jax.lax.top_k(|g|, k)[0][-1]``
    takes, which ties do not move."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat, 0.0)
    return kept.reshape(g.shape)


def compress(cfg: CompressionConfig, grads, err_state):
    """Lossy-compress grads (fp32) with error feedback.

    Returns (decompressed_grads, new_err_state): the decompressed value is
    what every replica would reconstruct after the compressed
    all-reduce."""
    if cfg.scheme == "none":
        return grads, err_state
    if cfg.scheme not in ("int8", "topk"):
        raise ValueError(cfg.scheme)

    def one(g, e):
        x = g.float() + e
        if cfg.scheme == "int8":
            c = _int8_roundtrip(x)
        else:
            c = _topk_roundtrip(x, cfg.topk_frac)
        return c, x - c

    out = [one(g, e) for g, e in zip(tr.leaves(grads), tr.leaves(err_state))]
    return (tr.unflatten(grads, [o[0] for o in out]),
            tr.unflatten(grads, [o[1] for o in out]))


def compressed_bytes(cfg: CompressionConfig, params) -> int:
    """Bytes crossing the slow axis per step under the scheme."""
    n = sum(p.numel() for p in tr.leaves(params))
    if cfg.scheme == "int8":
        return n  # 1 byte/param (+ negligible scales)
    if cfg.scheme == "topk":
        return int(n * cfg.topk_frac) * 8  # value + index
    return n * 4


__all__ = ["CompressionConfig", "init_error_state", "compress",
           "compressed_bytes"]
