"""The port's static plan verifier (repro_torch.analysis.plancheck) against
the JAX package's (repro.analysis.plancheck): the reference's plancheck
suite (tests/analysis/test_plancheck.py) run against the port, under the
reference's device model (``core.tiling.REFERENCE``, the CPU's).

Two halves, as in the reference.  **Pristine plans pass**: every planner
output the port produces verifies clean, with the reference's report for
the reference's plan of the same shape.  **Seeded corruptions are
rejected with the right rule**: one mutation per invariant class, applied
with ``dataclasses.replace`` to a pristine plan of each package, each
raising ``PlanInvariantError`` naming the rule the mutation breaks, the
same rule in both.  The ``vmem-budget`` mutation also runs under a card's
model built on the CPU (132 SMs, 232,448 B of opt-in shared memory a
block, NVIDIA's H100 figures), whose messages name the card's limits.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dispatch.planner as jplanner_mod
import repro_torch.dispatch.planner as planner_mod
from repro import rnn as jrnn
from repro.analysis import plancheck as jplancheck
from repro.configs.sharp_lstm import lstm_config as jlstm_config
from repro.core import gru as jgru
from repro.dispatch.workitem import WorkItem as JWorkItem
from repro.models.layers.lstm import init_lstm_layer as jinit_lstm_layer
from repro.models.layers.lstm import init_lstm_stack as jinit_lstm_stack
from repro.runtime import errors as jerrors
from repro_torch import rnn
from repro_torch.analysis import plancheck
from repro_torch.configs.sharp_lstm import lstm_config
from repro_torch.core import gru
from repro_torch.core.tiling import card_model
from repro_torch.dispatch.workitem import WorkItem
from repro_torch.kernels.common import SEQ_MAX_B
from repro_torch.models.layers.lstm import init_lstm_layer, init_lstm_stack
from repro_torch.runtime import errors

H = 48
POL = rnn.ExecutionPolicy(block_t=8)
JPOL = jrnn.ExecutionPolicy(interpret=True, block_t=8)
r = dataclasses.replace

#: the two packages' planner and verifier, side by side
PORT = SimpleNamespace(
    name="port", plan=planner_mod.plan, plan_decode=planner_mod.plan_decode,
    Cell=planner_mod.Cell, WorkItem=WorkItem, lstm_config=lstm_config,
    check_plan=plancheck.check_plan,
    check_decode_tick=plancheck.check_decode_tick, errors=errors,
    planner=planner_mod)
REF = SimpleNamespace(
    name="reference", plan=jplanner_mod.plan,
    plan_decode=jplanner_mod.plan_decode, Cell=jplanner_mod.Cell,
    WorkItem=JWorkItem, lstm_config=jlstm_config,
    check_plan=jplancheck.check_plan,
    check_decode_tick=jplancheck.check_decode_tick, errors=jerrors,
    planner=jplanner_mod)
BOTH = (PORT, REF)

#: a card's model built on the CPU from NVIDIA's H100 figures
CARD = card_model(SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                                  multi_processor_count=132,
                                  shared_memory_per_block_optin=232448))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, L=2, **kw):
    cfg = pkg.lstm_config(H, layers=L)
    return r(cfg, **kw) if kw else cfg


def _share_plan(pkg, L=2, T=24, n=3, **kw):
    """Cross-B packed plan: n parameter-sharing ragged-B items."""
    items = [pkg.WorkItem.from_config(_cfg(pkg, L), T=T, uid=i, B=1 + i,
                                      share=7) for i in range(n)]
    return pkg.plan(items, block_t=8, **kw)


def _decode_plan(pkg, n=2):
    items = [pkg.WorkItem.from_config(_cfg(pkg, 3), T=1, uid=i, share=7)
             for i in range(n)]
    return pkg.plan_decode(items)


def _expect(pkg, rule, mutant, **kw):
    with pytest.raises(pkg.errors.PlanInvariantError) as ei:
        pkg.check_plan(mutant, **kw)
    assert ei.value.rule == rule, \
        f"{pkg.name}: expected rule {rule!r}, got {ei.value.rule!r}: " \
        f"{ei.value}"
    return ei.value


def _port_stack(L, bidirectional=False):
    cfg = lstm_config(H, layers=L)
    if bidirectional:
        cfg = r(cfg, bidirectional=True, dtype="float32")
    return init_lstm_stack(torch.Generator().manual_seed(0), cfg,
                           torch.float32)


def _ref_stack(L, bidirectional=False):
    cfg = jlstm_config(H, layers=L)
    if bidirectional:
        cfg = r(cfg, bidirectional=True, dtype="float32")
    return jinit_lstm_stack(jax.random.PRNGKey(0), cfg, jnp.float32)


# ---------------------------------------------------------------------------
# pristine plans pass — every planner output the port produces
# ---------------------------------------------------------------------------


def test_uni_bidir_hetero_plans_verify_clean():
    """Each report equals the reference's for the same stack shape."""
    def both(port_stack, ref_stack):
        rep = plancheck.check_plan(
            rnn.compile(port_stack, POL, device="cpu").lower(2, 24))
        jrep = jplancheck.check_plan(
            jrnn.compile(ref_stack, JPOL).lower(2, 24))
        assert rep.describe() == jrep.describe()
        return rep

    rep = both(_port_stack(3), _ref_stack(3))
    assert rep.items == 1 and rep.cells == 3 * 3  # L=3 · nk=3
    rep = both(_port_stack(3, True), _ref_stack(3, True))
    assert rep.cells == 2 * 3 * 3  # both directions

    gen = torch.Generator().manual_seed(3)
    mixed = {"layers": [init_lstm_layer(gen, H, H, torch.float32),
                        gru.init_gru_layer(gen, H, H, torch.float32),
                        init_lstm_layer(gen, H, H, torch.float32)]}
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    jmixed = {"layers": [jinit_lstm_layer(k1, H, H, jnp.float32),
                         jgru.init_gru_layer(k2, H, H, jnp.float32),
                         jinit_lstm_layer(k3, H, H, jnp.float32)]}
    rep = both(mixed, jmixed)
    assert rep.items == 1 and rep.cells == 9
    assert "OK" in rep.describe() and rep.rules == plancheck.RULES
    assert plancheck.RULES == jplancheck.RULES


def test_cross_b_and_decode_and_external_plans_verify_clean():
    for pkg in BOTH:
        rep = pkg.check_plan(_share_plan(pkg))
        assert rep.items == 3
        rep = pkg.check_plan(_decode_plan(pkg))
        assert rep.chained == 1 and rep.cells == 2 * 3  # rows x layers

    # forced research schedules route items external: nothing on the
    # packed timeline, still a clean (empty) proof
    cs = rnn.compile(_port_stack(2), rnn.ExecutionPolicy(
        schedule="sequential"), device="cpu")
    p = cs.lower(2, 12)
    assert 0 in p.external
    assert plancheck.check_plan(p).cells == 0


def test_remainder_chunks_verify_clean():
    """T=20 at bt=8 -> chunks 8/8/4: the ragged tail is part of the
    tiling proof, not an exception to it."""
    for pkg in BOTH:
        p = pkg.plan([pkg.WorkItem.from_config(_cfg(pkg, 2), T=20, uid=0)],
                     block_t=8)
        assert pkg.check_plan(p).cells == 2 * 3


# ---------------------------------------------------------------------------
# seeded corruptions: one per invariant class, each caught by ITS rule in
# both packages
# ---------------------------------------------------------------------------


def test_mutation_dropped_slot_is_coverage_missing():
    for pkg in BOTH:
        p = _share_plan(pkg)
        err = _expect(pkg, "coverage-missing", r(p, slots=p.slots[:-1]))
        assert err.cell is not None and err.uids  # names the lost cell


def test_mutation_duplicated_row_is_coverage_duplicate():
    for pkg in BOTH:
        p = _share_plan(pkg)
        s0, s1 = p.slots[0], p.slots[1]
        dup = r(s1, groups=s1.groups + s0.groups[:1],
                group_b=s1.group_b + s0.group_b[:1])
        _expect(pkg, "coverage-duplicate",
                r(p, slots=(s0, dup) + p.slots[2:]))


def test_mutation_foreign_cell_is_coverage_unknown():
    for pkg in BOTH:
        p = _share_plan(pkg)
        s0 = p.slots[0]
        alien = r(s0, groups=s0.groups + ((pkg.Cell(99, 0, 0, "fwd"),),),
                  group_b=s0.group_b + (1,))
        err = _expect(pkg, "coverage-unknown",
                      r(p, slots=(alien,) + p.slots[1:]))
        assert err.uids == (99,)


def test_mutation_swapped_waves_are_readiness_violations():
    for pkg in BOTH:
        # nk=1, L=2: the only dependency is the layer walk
        p = pkg.plan([pkg.WorkItem.from_config(_cfg(pkg, 2), T=8, uid=0)],
                     block_t=8)
        assert len(p.slots) == 2
        s0, s1 = p.slots
        swapped = (r(s0, wave=s1.wave), r(s1, wave=s0.wave))
        _expect(pkg, "readiness-layer", r(p, slots=swapped))

        # L=1, nk=2: the only dependency is the chunk walk
        p = pkg.plan([pkg.WorkItem.from_config(_cfg(pkg, 1), T=16, uid=0)],
                     block_t=8)
        assert len(p.slots) == 2
        s0, s1 = p.slots
        swapped = (r(s0, wave=s1.wave), r(s1, wave=s0.wave))
        _expect(pkg, "readiness-chunk", r(p, slots=swapped))


def test_mutation_reordered_tuple_is_wave_monotone():
    # waves stay correct; only the executor's tuple order is corrupted
    for pkg in BOTH:
        p = pkg.plan([pkg.WorkItem.from_config(_cfg(pkg, 1), T=16, uid=0)],
                     block_t=8)
        _expect(pkg, "wave-monotone", r(p, slots=tuple(reversed(p.slots))))


def test_mutation_merged_mixed_dtype_row_is_pack_row_mix():
    """Two same-share items in different dtypes never merge on B; force
    the merge and the verifier rejects the row."""
    for pkg in BOTH:
        i32 = pkg.WorkItem.from_config(_cfg(pkg, 1, dtype="float32"), T=8,
                                       uid=0, share=7)
        i16 = pkg.WorkItem.from_config(_cfg(pkg, 1, dtype="bfloat16"), T=8,
                                       uid=1, share=7)
        p = pkg.plan([i32, i16], block_t=8)
        by_dtype = {s.dtype: s for s in p.slots}
        assert len(by_dtype) == 2  # pristine planner keeps them apart
        host = by_dtype["float32"]
        guest_cell = by_dtype["bfloat16"].groups[0][0]
        merged = r(host, groups=((host.groups[0] + (guest_cell,)),),
                   group_b=(host.group_b[0] + 1,), B=host.B + 1)
        slots = tuple(merged if s is host else s for s in p.slots)
        _expect(pkg, "pack-row-mix", r(p, slots=slots))


def test_mutation_wrong_group_width_is_pack_width():
    for pkg in BOTH:
        p = _share_plan(pkg)
        s0 = p.slots[0]
        lied = r(s0, group_b=tuple(b + 1 for b in s0.group_b))
        _expect(pkg, "pack-width", r(p, slots=(lied,) + p.slots[1:]))


def test_mutation_wrong_slot_dtype_is_pack_signature():
    for pkg in BOTH:
        p = pkg.plan([pkg.WorkItem.from_config(
            _cfg(pkg, 2, dtype="float32"), T=8, uid=0)], block_t=8)
        s0 = p.slots[0]
        assert s0.dtype == "float32"
        _expect(pkg, "pack-signature",
                r(p, slots=(r(s0, dtype="bfloat16"),) + p.slots[1:]))


def test_mutation_offtable_tile_config_is_stripe_align():
    for pkg in BOTH:
        p = _share_plan(pkg)
        s0 = p.slots[0]
        _expect(pkg, "stripe-align",
                r(p, slots=(r(s0, tile_k=s0.tile_k * 2),) + p.slots[1:]))


def test_mutation_wrong_chunk_len_is_chunk_tiling():
    for pkg in BOTH:
        p = pkg.plan([pkg.WorkItem.from_config(_cfg(pkg, 1), T=16, uid=0)],
                     block_t=8)
        s0 = p.slots[0]
        _expect(pkg, "chunk-tiling",
                r(p, slots=(r(s0, chunk_len=4),) + p.slots[1:]))


def test_mutation_vmem_overflow_is_vmem_budget():
    """Under the reference's model, as in the reference (same message);
    under a card's model, a slot wider than the sequence launch's rows
    (SEQ_MAX_B, a C int of its grid), its message naming the card's
    limit.  A card holds slots to no footprint, so a budget override is
    refused there rather than read."""
    msgs = []
    for pkg in BOTH:
        p = _share_plan(pkg)
        s0 = p.slots[0]
        huge = r(s0, B=1 << 16, group_b=tuple(1 << 16 for _ in s0.group_b))
        err = _expect(pkg, "vmem-budget", r(p, slots=(huge,) + p.slots[1:]))
        assert err.slot == s0.index
        msgs.append(str(err))
        # ... and the budget is configurable: the pristine plan fails a
        # deliberately tiny one
        _expect(pkg, "vmem-budget", _share_plan(pkg), vmem_budget=1024)
    assert msgs[0] == msgs[1]

    p = _share_plan(PORT, device_model=CARD)
    plancheck.check_plan(p, device_model=CARD)
    s0 = p.slots[0]
    wide = SEQ_MAX_B + 1
    huge = r(s0, B=wide, group_b=tuple(wide for _ in s0.group_b))
    err = _expect(PORT, "vmem-budget", r(p, slots=(huge,) + p.slots[1:]),
                  device_model=CARD)
    assert err.slot == s0.index
    assert f"B <= {SEQ_MAX_B}" in str(err) and CARD.name in str(err)
    with pytest.raises(ValueError, match="applies to the reference's "
                                         "model only"):
        plancheck.check_plan(p, vmem_budget=1024, device_model=CARD)


def test_mutation_scrambled_chain_is_decode_chain():
    for pkg in BOTH:
        p = _decode_plan(pkg)
        (slot,) = p.slots
        scrambled = r(slot, groups=(slot.groups[1], slot.groups[0])
                      + slot.groups[2:])
        _expect(pkg, "decode-chain", r(p, slots=(scrambled,)))


# ---------------------------------------------------------------------------
# structured error + facade/serving wiring
# ---------------------------------------------------------------------------


def test_plan_invariant_error_names_rule_slot_cell():
    p = _share_plan(PORT)
    err = _expect(PORT, "coverage-missing", r(p, slots=p.slots[:-1]))
    assert isinstance(err, rnn.ServingFault)
    assert err.rule in plancheck.RULES
    assert err.cell is not None and len(err.cell) == 4
    assert "coverage-missing" in str(err)


def test_decode_cost_model_inversion_raises_structured(monkeypatch):
    """A broken perfmodel surfaces as PlanInvariantError(rule=
    'decode-cost-model'), in both packages."""
    for pkg in BOTH:
        monkeypatch.setattr(pkg.planner, "decode_plan_cycles",
                            lambda *a, **kw: 10 ** 12)
        with pytest.raises(pkg.errors.PlanInvariantError) as ei:
            _decode_plan(pkg)
        assert ei.value.rule == "decode-cost-model"


def test_duplicate_uids_shared_helper_raises_plan_rejected():
    for pkg in BOTH:
        items = [pkg.WorkItem.from_config(_cfg(pkg, 1), T=8, uid=0),
                 pkg.WorkItem.from_config(_cfg(pkg, 1), T=8, uid=0, B=2)]
        with pytest.raises(pkg.errors.PlanRejected) as ei:
            pkg.plan(items)
        assert ei.value.uids == (0,)
        dec = [pkg.WorkItem.from_config(_cfg(pkg, 1), T=1, uid=3,
                                        share=7)] * 2
        with pytest.raises(pkg.errors.PlanRejected):
            pkg.plan_decode(dec)


def test_check_decode_tick_rejects_wrong_row_count():
    for pkg in BOTH:
        p = _decode_plan(pkg, n=2)
        pkg.check_decode_tick(p, 2)
        with pytest.raises(pkg.errors.PlanInvariantError) as ei:
            pkg.check_decode_tick(p, 3)
        assert ei.value.rule == "decode-active-rows"


def test_policy_verify_wiring_counts_and_is_bit_identical():
    """verify='plan' (the default) proves each plan once per cache miss;
    verify='off' skips; outputs are bit-identical either way."""
    stack = _port_stack(2)
    xs = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (2, 12, H)) * 0.5).astype(np.float32))

    on = rnn.compile(stack, POL, device="cpu")
    assert on.policy.verify == "plan"
    y_on = on.forward(xs)
    assert on.stats.plans_verified == on.stats.plans_built == 1
    on.forward(xs)  # cache hit: no re-verification
    assert on.stats.plans_verified == 1
    assert "1 verified" in on.describe()

    off = rnn.compile(stack, r(POL, verify="off"), device="cpu")
    y_off = off.forward(xs)
    assert off.stats.plans_verified == 0
    torch.testing.assert_close(y_on, y_off, rtol=0, atol=0)
