"""Token embedding and output head — the port of
``repro.models.layers.embedding``."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import card_path
from repro_torch.models.layers.common import (dense_init, matmul_f32,
                                              shard_act)
from repro_torch.sharding.partition import is_dtensor


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype,
                   tie: bool, device="cpu"):
    p = {"table": dense_init(gen, (vocab, d), dtype, scale=1.0,
                             device=device)}
    if not tie:
        p["unembed"] = dense_init(gen, (d, vocab), dtype, device=device)
    return p


def embed(params, tokens, dtype):
    """The table's rows of ``tokens``.  Under a mesh every rank looks up
    the whole batch's tokens (they are gathered if sharded; the caller
    shards the rows it gets, ``shard_act``), so that the lookup's
    backward scatters replicated rows: PyTorch's sharding rule for that
    scatter-add mis-places its output when the rows are sharded over the
    batch."""
    if is_dtensor(tokens):
        from torch.distributed.tensor import Replicate

        mesh = tokens.device_mesh
        tokens = tokens.redistribute(mesh, [Replicate()] * mesh.ndim)
    return params["table"].to(dtype)[tokens]


def unembed(params, x):
    """x (B, S, d) -> fp32 logits (B, S, vocab): the model-dtype operands
    multiplied with fp32 accumulation and an fp32 result, as the
    reference's einsum with an fp32 result does.  Not a projection in
    ``common.project``'s sense: it never goes through mvm.

    Two forms of one function.  On CUDA tensors, one product of the
    operands as they are, summed in fp32 into an fp32 result
    (``torch.mm(..., out_dtype=torch.float32)``, ``aten::mm.dtype``): a
    product of two bf16 values is exact in fp32, so this is the
    reference's einsum up to the order of summation, and no fp32 copy of
    the (d, vocab) table is made (RecurrentGemma-2B's untied unembed is
    2560 x 256000); its backward takes the reference's cotangents with
    bf16 products too (``common.matmul_f32``).  On the CPU, where
    ``aten::mm.dtype`` has no kernel, both operands are upcast to fp32 and
    multiplied (TF32 stays off on the card, ``rnn.resolve_device``).  A
    cost trace of the card's path (``calib.hlo``) takes the CUDA form on
    any device."""
    w = params["unembed"] if "unembed" in params else params["table"].T
    if not card_path(x):
        y = torch.matmul(x.float(), w.float())
    else:
        lead = x.shape[:-1]
        y = matmul_f32(x.reshape(-1, x.shape[-1]), w).reshape(*lead,
                                                              w.shape[1])
    return shard_act(y, "batch", "seq", "vocab")
