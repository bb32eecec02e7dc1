"""The port's device models (repro_torch.core.tiling.DeviceModel): which
sequence stripes and chained decode slots a device admits.

Under ``REFERENCE`` (the CPU's model) the port plans and verifies as the
JAX package (repro.dispatch.planner, repro.analysis.plancheck): the paper's
H=1024 networks are refused with the reference's rule and message.  Under
a card's model, built on the CPU from NVIDIA's H100 figures (132 SMs,
232,448 B of opt-in shared memory a block), the paper's four Table 5
networks plan at full width with the planner alone (no parameters) and
pass the verifier; a plan that departs from the reference's computes the
same outputs bit for bit on the CPU (a chunked walk equals a single
launch).  The ``cuda``-marked tests read the real card's model and hold a
sequence launch whose element offsets pass 2^31 against the same walk in
launches whose offsets stay below it, bit for bit.
"""
import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.dispatch.planner as jplanner
from repro.analysis.plancheck import check_plan as jcheck_plan
from repro.configs import sharp_lstm as jsharp
from repro.dispatch.workitem import WorkItem as JWorkItem
from repro.runtime.errors import PlanInvariantError as JPlanInvariantError
from repro_torch import rnn
from repro_torch.analysis.plancheck import check_decode_tick, check_plan
from repro_torch.configs import sharp_lstm
from repro_torch.core import tiling
from repro_torch.core.autotune import ConfigTable
from repro_torch.core.tiling import REFERENCE, card_model, device_model
from repro_torch.dispatch import planner
from repro_torch.dispatch.workitem import WorkItem
from repro_torch.kernels import common
from repro_torch.kernels.common import KernelLaunchRefused
from repro_torch.runtime.errors import PlanInvariantError

H100 = SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                       multi_processor_count=132,
                       shared_memory_per_block_optin=232448)
CARD = card_model(H100)

#: (network, B, T) -> the card model's plan: (schedule, block_t, launches)
PAPER = {
    "GMAT": (4, 75, ("wavefront", 37, 35)),
    "RLDRADSPR": (4, 400, ("wavefront", 8, 59)),
    "EESEN": (4, 300, ("fused", 300, 5)),
    "BYSDNE": (4, 30, ("wavefront", 15, 6)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _fp32(module, name):
    return dataclasses.replace(getattr(module, name), dtype="float32")


def _items(B, T, n=1, **kw):
    return ([WorkItem.from_config(_fp32(sharp_lstm, "GMAT"), T=T, uid=i,
                                  B=B, **kw) for i in range(n)],
            [JWorkItem.from_config(_fp32(jsharp, "GMAT"), T=T, uid=i, B=B,
                                   **kw) for i in range(n)])


@pytest.mark.parametrize("kind", ["forward", "decode"])
def test_reference_refuses_gmat_as_the_reference_does(kind):
    """GMAT (L=17, H=1024, fp32) under the reference's model: the same plan
    as the reference's, refused by ``vmem-budget`` with the same message
    (fp32 U alone is 16 MiB against the TPU's 8 MiB)."""
    if kind == "forward":
        items, jitems = _items(1, 75)
        p, jp = planner.plan(items), jplanner.plan(jitems)
    else:
        items, jitems = _items(4, 1, n=4, share=0)
        p, jp = planner.plan_decode(items), jplanner.plan_decode(jitems)
    assert p.describe() == jp.describe()
    with pytest.raises(JPlanInvariantError) as jerr:
        jcheck_plan(jp)
    with pytest.raises(PlanInvariantError) as err:
        check_plan(p)
    assert err.value.rule == jerr.value.rule == "vmem-budget"
    assert str(err.value) == str(jerr.value)
    assert "exceeds budget 8388608B" in str(err.value)


@pytest.mark.parametrize("name,family", [
    (name, family) for name in sorted(PAPER) for family in ("lstm", "gru")
    if (name, family) != ("EESEN", "gru")])
def test_card_model_plans_the_paper_networks(name, family):
    """Full width, the planner alone: each Table 5 network plans under the
    card's model and passes the verifier, as its chained decode tick does
    (EESEN is a bidirectional LSTM: a forward only)."""
    cfg = _fp32(sharp_lstm, name)
    B, T, want = PAPER[name]
    it = WorkItem.from_config(cfg, T=T, B=B, share=0, rnn_family=family)
    p = planner.plan([it], device_model=CARD)
    (ip,) = p.items
    assert (ip.schedule, ip.block_t, p.launches) == want
    rep = check_plan(p, device_model=CARD)
    assert rep.cells == (1 + cfg.bidirectional) * cfg.n_layers * ip.nk
    if not cfg.bidirectional:
        tick = planner.plan_decode(
            [dataclasses.replace(it, T=1, B=1, uid=u) for u in range(B)],
            device_model=CARD)
        assert tick.launches == 1 and tick.slots[0].chained
        assert check_plan(tick, device_model=CARD).chained == 1
        check_decode_tick(tick, B, device_model=CARD)


def test_card_model_refuses_past_the_kernels_limits():
    """A chained decode slot past DECODE_MAX_H and a sequence slot past
    SEQ_MAX_H are refused by ``vmem-budget``, naming the card's limit —
    never dropped to the reference's model."""
    wide = common.SEQ_MAX_H + 8
    it = WorkItem(uid=0, family="lstm", B=1, T=4, H=wide, L=2, X=wide,
                  dtype="float32", share=0)
    p = planner.plan([it], device_model=CARD)
    with pytest.raises(PlanInvariantError, match=re.escape(
            f"H={wide} is past the sequence kernels' H <= "
            f"{common.SEQ_MAX_H} on {CARD.name}")) as err:
        check_plan(p, device_model=CARD)
    assert err.value.rule == "vmem-budget"
    tick = planner.plan_decode([dataclasses.replace(it, T=1)],
                               device_model=CARD)
    for check in (lambda: check_plan(tick, device_model=CARD),
                  lambda: check_decode_tick(tick, 1, device_model=CARD)):
        with pytest.raises(PlanInvariantError, match=(
                f"past the decode kernels' H <= {common.DECODE_MAX_H}")):
            check()


def test_stripe_past_the_int32_limit_is_halved_or_refused():
    """The kernel's element offsets are size_t; what holds a stripe to 32
    bits is the launch's C int T.  The planner halves a pinned stripe past
    SEQ_MAX_T; the verifier refuses a slot that claims one; the launch's
    other ints (G, B) stop at their limits too."""
    assert common.seq_launch_refusal(common.SEQ_MAX_G, common.SEQ_MAX_B,
                                     common.SEQ_MAX_T) is None
    for G, B, T, name in ((1, 1, common.SEQ_MAX_T + 1, "T"),
                          (common.SEQ_MAX_G + 1, 1, 1, "G"),
                          (1, common.SEQ_MAX_B + 1, 1, "B")):
        assert common.seq_launch_refusal(G, B, T).startswith(
            f"a sequence launch takes {name} <= ")
    T = 2 ** 32
    bt = planner._fit_stripe(T, 4, 340, 4, device_model=CARD)
    assert bt == 2 ** 30 and bt <= common.SEQ_MAX_T
    assert planner._fit_stripe(common.SEQ_MAX_T, 4, 340, 4,
                               device_model=CARD) == common.SEQ_MAX_T
    it = WorkItem(uid=0, family="lstm", B=4, T=T, H=340, L=1, X=340,
                  dtype="float32")
    p = planner.plan([it], schedule="wavefront", block_t=T,
                     device_model=CARD)
    assert p.items[0].block_t == 2 ** 30 and p.launches == 4
    check_plan(p, device_model=CARD)
    s0 = p.slots[0]
    bad = dataclasses.replace(p, slots=(dataclasses.replace(
        s0, chunk_len=common.SEQ_MAX_T + 1),) + p.slots[1:])
    with pytest.raises(PlanInvariantError,
                       match=f"T <= {common.SEQ_MAX_T}") as err:
        check_plan(bad, device_model=CARD)
    assert err.value.rule == "vmem-budget"


def test_device_model_cpu_is_reference():
    assert device_model("cpu") is REFERENCE
    assert device_model(torch.device("cpu")) is REFERENCE
    assert (REFERENCE.budget, REFERENCE.on_card) == (
        tiling.SEQ_VMEM_BUDGET, False)
    with pytest.raises(ValueError, match="allowed: cpu, cuda"):
        device_model("meta")


def test_device_model_on_faked_properties(monkeypatch):
    """On CUDA the model is built from torch.cuda.get_device_properties;
    a card whose blocks cannot opt in to the sequence kernels' shared
    memory is refused."""
    seen = []

    def props(device):
        seen.append(device)
        return H100

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    m = device_model("cuda")
    assert seen == [torch.device("cuda")]
    assert m == CARD and m.on_card
    assert (m.name, m.sms, m.budget) == (
        "cuda(NVIDIA H100 80GB HBM3)", 132, 232448)
    assert (m.seq_max_h, m.decode_max_h) == (
        common.MAX_H["lstm_seq"], common.MAX_H["lstm_decode"])
    assert "132 SMs, 232448 B" in m.describe()
    small = SimpleNamespace(name="small card", multi_processor_count=84,
                            shared_memory_per_block_optin=101376)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: small)
    with pytest.raises(KernelLaunchRefused, match=(
            f"offers 101376 B .* up to {common.SEQ_MAX_SMEM} B")):
        device_model("cuda")


def test_autotune_keys_a_card_models_stripes_apart():
    """One table serves both models in one process: EESEN's stripe is 4
    under the reference's budget at B=4 and 4 on the card too (its
    T-waste rule), but at GMAT's width the two part (1 vs 75)."""
    t = ConfigTable(path="/nonexistent/autotune.json")
    assert t.seq_block(75, 1, 1024) == 1
    assert t.seq_block(75, 1, 1024, device_model=CARD) == 75
    assert t.seq_block(75, 1, 1024) == 1
    assert sorted(t._seq_blocks) == ["75x1x1024", f"75x1x1024@{CARD.name}"]


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_card_plan_departs_with_bit_equal_outputs(family):
    """At reduced width (L=3, H=48, T=40) and B=320 rows, where the TPU's
    VMEM budget halves the stripe, the card's model plans fewer launches;
    forward and prefill (outputs and state) are bit-equal on the CPU."""
    cfg = dataclasses.replace(sharp_lstm.lstm_config(48, layers=3),
                              dtype="float32")
    xs = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (320, 40, 48)) * 0.5).astype(np.float32))
    ref = rnn.compile(cfg, rnn_family=family, device="cpu", seed=0)
    card = rnn.compile(cfg, rnn_family=family, device="cpu", seed=0)
    assert ref.device_model is REFERENCE
    card.device_model = CARD
    y_ref, y_card = ref.forward(xs), card.forward(xs)
    plans = [[(ip.schedule, ip.block_t) for ip in cs.plan.items]
             + [cs.plan.launches] for cs in (ref, card)]
    assert plans == [[("wavefront", 16), 7], [("wavefront", 20), 4]]
    torch.testing.assert_close(y_card, y_ref, rtol=0, atol=0)
    (ys_ref, st_ref), (ys_card, st_card) = ref.prefill(xs), card.prefill(xs)
    torch.testing.assert_close(ys_card, ys_ref, rtol=0, atol=0)
    for k in st_ref:
        torch.testing.assert_close(st_card[k], st_ref[k], rtol=0, atol=0)
    assert "device model" not in ref.describe()
    assert f"device model: {CARD.name}: 132 SMs" in card.describe()


@pytest.mark.cuda
def test_cuda_device_model_reads_the_card(cuda):
    props = torch.cuda.get_device_properties(cuda)
    m = device_model(cuda)
    assert m.name == f"cuda({torch.cuda.get_device_name(cuda)})"
    assert m.sms == props.multi_processor_count
    assert m.budget == props.shared_memory_per_block_optin \
        >= common.SEQ_MAX_SMEM
    assert rnn.compile(sharp_lstm.lstm_config(64), device="cuda") \
        .device_model == m


@pytest.mark.cuda
def test_cuda_seq_offsets_past_int32_bit_equal_to_launches_below_it(cuda):
    """One lstm_seq launch of 16 rows at H=1024 over 132,096 steps, whose
    xw and hs element offsets pass 2^31, equals the same walk in eight
    launches, in each of which every xw and hs offset is below 2^31, bit
    for bit: the offsets are size_t."""
    from repro_torch.kernels.lstm_cell import ops

    B, T, H, parts = 16, 132096, 1024, 8
    step = T // parts
    assert (B * T * 4 - 1) * H >= 2 ** 31 and (B * T - 1) * H >= 2 ** 31
    assert B * step * 4 * H <= 2 ** 31
    gen = torch.Generator(device=cuda).manual_seed(0)
    U = (torch.randn((1, H, 4, H), generator=gen, device=cuda) * 0.02
         ).to(torch.bfloat16)
    xw = torch.randn((1, B, T, 4, H), generator=gen, device=cuda,
                     dtype=torch.bfloat16)
    h = torch.zeros((1, B, H), device=cuda)
    c = torch.zeros((1, B, H), device=cuda)
    hs, hT, cT = ops.lstm_seq(U, xw, h, c)
    for k in range(parts):
        part = slice(k * step, (k + 1) * step)
        hs_k, h, c = ops.lstm_seq(U, xw[:, :, part].contiguous(), h, c)
        assert torch.equal(hs[:, :, part], hs_k)
        del hs_k
    assert torch.equal(hT, h) and torch.equal(cT, c)
    assert bool(torch.isfinite(hT).all())
