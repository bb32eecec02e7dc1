"""FLOP parity of the port's static cost walker (``repro_torch.calib.hlo``)
with the reference's (``repro.calib.hlo``) on the reduced prefill and
train steps of starcoder2-3b, recurrentgemma-2b and olmoe-1b-7b: the
walker's FLOPs of the port's step equal the reference's walker on the
jitted step exactly, less what the port does not compute, in closed form:
its blockwise prefill attention skips the blocks wholly above the
diagonal (``models.layers.attention.blockwise_attention``), which the
reference's computes and masks.  Transcendentals are printed beside the
reference's, each difference named."""
import inspect

import pytest
import torch

from tests.test_torch_hlo import port_walk, reference_walk

from repro_torch.configs import get_reduced
from repro_torch.models.layers import attention

#: where the two walkers' transcendental counts differ, why
TRANSCENDENTAL_DIFFERENCES = {
    "starcoder2-3b": "autograd's softmax and GELU backward re-evaluate their "
                     "exp / tanh where XLA reuses the forward's; in the "
                     "prefill a runtime sqrt of the head scale",
    "olmoe-1b-7b": "the router's softmax twice a layer (moe.route and the aux "
                   "loss); in the train step the backward's exps as above",
    "recurrentgemma-2b": "the RG-LRU's exp(log_a) as XLA's polynomial in "
                         "arithmetic (kernels.rglru.ref.xla_exp) on the "
                         "port, a softplus on the reference; the train "
                         "step's backward as above",
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def skipped_block_flops(arch, B, S):
    """FLOPs of the (query block, key block) pairs wholly above the
    diagonal, which the port's blockwise attention skips: each pair is
    q·K and p·V over a q_chunk x kv_chunk tile, 4·B·Hq·q·k·D."""
    cfg = get_reduced(arch)
    if cfg.window:  # local attention: the reference walks the same blocks
        return 0
    sig = inspect.signature(attention.blockwise_attention).parameters
    qc = min(sig["q_chunk"].default, S)
    kc = min(sig["kv_chunk"].default, S)
    pairs = sum(1 for i in range(S // qc) for j in range(S // kc)
                if j * kc > (i + 1) * qc - 1)
    n_attn = cfg.layer_kinds().count("attn")
    return pairs * 4 * B * cfg.n_heads * qc * kc * cfg.head_dim * n_attn


@pytest.mark.parametrize("arch", ["starcoder2-3b", "recurrentgemma-2b",
                                  "olmoe-1b-7b"])
@pytest.mark.parametrize("mode,B,T", [("prefill", 2, 256),
                                      ("prefill", 1, 2048),
                                      ("train", 2, 64)])
def test_step_flops_equal_the_references(arch, mode, B, T):
    ref = reference_walk(arch, mode, B, T)
    got, t = port_walk(arch, mode, B, T)
    skipped = skipped_block_flops(arch, B, T) if mode == "prefill" else 0
    print(f"{arch} {mode} B={B} T={T}: FLOPs {got['flops']:.0f} (reference "
          f"{ref['flops']:.0f}, skipped blocks {skipped}); transcendentals "
          f"{got['transcendental_elems']:.0f} (reference "
          f"{ref['transcendental_elems']:.0f}); kernel ops "
          f"{dict(t.kernels)}")
    assert got["flops"] == ref["flops"] - skipped
    assert skipped > 0 or T <= 1024 or get_reduced(arch).window
    if got["transcendental_elems"] != ref["transcendental_elems"]:
        print(f"  difference: {TRANSCENDENTAL_DIFFERENCES[arch]}")
