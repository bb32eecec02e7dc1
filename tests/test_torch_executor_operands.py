"""The executor's operand path (``dispatch/executor.py``) on the CPU.

A sequence slot gathers, multiplies and scatters its operands through
per-call buffers with index tensors built once per plan, so the tensor
operations it issues outside the kernel entry points do not grow with
the cells it packs; a chained decode tick launches on the caller's state
as it is.  Held here: those operation counts (a ``TorchDispatchMode``
counting every aten operation outside ``lstm_seq`` / ``lstm_decode`` /
``gru_seq`` / ``gru_decode``), outputs and states against a plain
step-by-step reference at the dispatch tests' ``TOL`` and packed rows
against solo calls at the standing ``ISOLATION_TOL`` (ROADMAP, "packed vs
solo at 1e-6 on the CPU"), for ragged bidirectional utterances,
unidirectional waves resumed from ``init_state``, GRU, mixed lstm/gru,
int8, row-compacted and B > 1 items; and the fault paths: the
finiteness check names exactly the poisoned items, an injected fault
recovers on the per-step rung.
"""
from __future__ import annotations

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import rnn
from repro_torch.dispatch import WorkItem, execute, executor, plan
from repro_torch.dispatch.workitem import GATES
from repro_torch.kernels.gru_cell.ref import gru_step_ref
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.kernels.quant import fake_quant_stack
from repro_torch.runtime.errors import NonFiniteStateError

#: the dispatch tests' fp32 tolerance against a reference
TOL = 1e-5
#: ROADMAP.md, "packed vs solo at 1e-6 on the CPU": a packed row's GEMMs
#: run at another row count than a solo call's
ISOLATION_TOL = 1e-6
KERNELS = ("lstm_seq", "lstm_decode", "gru_seq", "gru_decode")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _half(gen, X, H, family):
    g = GATES[family]
    return {"W": torch.randn(X, g * H, generator=gen) / X ** 0.5,
            "U": torch.randn(H, g * H, generator=gen) / H ** 0.5,
            "b": 0.1 * torch.randn(g * H, generator=gen)}


def _stack(families, H, bidirectional=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    layers, X = [], H
    for fam in families:
        if bidirectional:
            layers.append({"fwd": _half(gen, X, H, fam),
                           "bwd": _half(gen, X, H, fam)})
            X = 2 * H
        else:
            layers.append(_half(gen, X, H, fam))
    return {"layers": layers}


def _xs(B, T, X, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, T, X)).astype(np.float32))


def _walk(half, family, xs, h, c):
    """One direction of one layer, one step at a time."""
    H = half["U"].shape[0]
    U = half["U"].reshape(H, GATES[family], H)
    ys = []
    for t in range(xs.shape[1]):
        xw = (xs[:, t] @ half["W"] + half["b"]).reshape(
            xs.shape[0], GATES[family], H)
        if family == "lstm":
            h, c = lstm_cell_ref(U, xw, h, c)
        else:
            h = gru_step_ref(U, xw, h)
        ys.append(h)
    return torch.stack(ys, 1), h, c


def _reference(stack, families, xs, init=None):
    """(ys, state) as ``execute`` documents them, from ``_walk``."""
    B = xs.shape[0]
    y, state = xs, {}
    for l, (fam, layer) in enumerate(zip(families, stack["layers"])):
        halves = ((("fwd", layer["fwd"]), ("bwd", layer["bwd"]))
                  if "fwd" in layer else (("fwd", layer),))
        outs = []
        for d, half in halves:
            H = half["U"].shape[0]
            h = init["h"][l] if init else torch.zeros(B, H)
            c = (init["c"][l] if init and "c" in init
                 else torch.zeros(B, H))
            src = y if d == "fwd" else y.flip(1)
            ys, h, c = _walk(half, fam, src, h, c)
            outs.append(ys if d == "fwd" else ys.flip(1))
            st = state.setdefault(d, {"h": [], "c": []})
            st["h"].append(h)
            st["c"].append(c if fam == "lstm" else torch.zeros(B, H))
        y = torch.cat(outs, -1)
    for st in state.values():
        st["h"] = torch.stack(st["h"])
        st["c"] = torch.stack(st["c"])
        if "lstm" not in families:
            del st["c"]
    return y, (state if len(state) == 2 else state["fwd"])


def _close(a, b, tol):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k], tol)
        return
    torch.testing.assert_close(a, b, rtol=0, atol=tol)


class _Count(TorchDispatchMode):
    """Aten operations by name, outside the kernel entry points."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.inside:
            self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))

    def outside(self, fn):
        def entry(*a, **k):
            self.inside += 1
            try:
                return fn(*a, **k)
            finally:
                self.inside -= 1
        return entry


@pytest.fixture
def count(monkeypatch):
    """count(fn) -> the aten operations fn issues outside the kernels."""
    mode = _Count()
    for name in KERNELS:
        monkeypatch.setattr(executor, name, mode.outside(getattr(executor,
                                                                 name)))

    def run(fn):
        mode.ops.clear()
        with mode:
            fn()
        return sum(mode.ops.values())

    return run


# ---------------------------------------------------------------------------
# operations a slot and a tick take
# ---------------------------------------------------------------------------


def test_slot_operations_do_not_grow_with_the_cells_packed(count):
    """Bidirectional L=5 at block_t=8: 1, 8 and 32 ragged utterances of
    20-60 frames.  More utterances pack more cells into each slot, and a
    slot's operations stay within 1.5x of the lone utterance's, on a
    plan-cache hit and on a miss (a new plan on the same stack)."""
    params = _stack(("lstm",) * 5, 16, bidirectional=True)
    cs = rnn.compile(params, rnn.ExecutionPolicy(block_t=8), device="cpu")
    rng = np.random.default_rng(0)
    per_slot, per_cell = {}, {}
    for n in (1, 8, 32):
        lens = [40] if n == 1 else rng.integers(20, 61, size=n).tolist()
        xs = [_xs(1, T, 16, seed=i) for i, T in enumerate(lens)]
        cs.prefill(xs)                          # a miss: plan, banks
        hit = count(lambda: cs.prefill(xs))     # a plan-cache hit
        slots = len(cs.plan.slots)
        per_slot[n] = hit / slots
        per_cell[n] = sum(len(s.cells) for s in cs.plan.slots) / slots
        # a miss on a warm stack adds the plan's build, not a slot's worth
        xs = [x[:, 1:] for x in xs]
        miss = count(lambda: cs.prefill(xs))
        assert miss / len(cs.plan.slots) <= 1.5 * per_slot[1], (n, miss)
    assert per_cell[32] > 3 * per_cell[1]
    assert per_slot[8] <= 1.5 * per_slot[1], per_slot
    assert per_slot[32] <= 1.5 * per_slot[1], per_slot


@pytest.mark.parametrize("family", ["lstm", "gru"])
def test_decode_tick_takes_at_most_15_operations(count, family):
    """One chained tick of a 10-layer stack for 32 rows, resumed from the
    caller's (L, B, H) state: at most 15 operations outside the decode
    kernel."""
    params = _stack((family,) * 10, 16)
    cs = rnn.compile(params, rnn.ExecutionPolicy(), device="cpu")
    x = _xs(32, 1, 16, seed=1)
    st = {"h": torch.randn(10, 32, 16)}
    if family == "lstm":
        st["c"] = torch.randn(10, 32, 16)
    cs.decode(x, st)
    assert count(lambda: cs.decode(x, st)) <= 15
    assert cs.last_decode_plan.slots[0].chained


# ---------------------------------------------------------------------------
# parity: against the reference, and packed against solo
# ---------------------------------------------------------------------------


#: (families, bidirectional, requests as (B, T), policy): ragged lengths
#: with remainder chunks at block_t=4
CASES = {
    "bidir-ragged": (("lstm",) * 3, True, ((1, 13), (1, 6), (1, 9)),
                     dict(block_t=4)),
    "gru": (("gru",) * 3, False, ((1, 11), (1, 5), (1, 8)),
            dict(block_t=4)),
    "mixed": (("lstm", "gru", "lstm", "gru"), False, ((1, 9), (1, 14)),
              dict(block_t=4)),
    "batch": (("lstm",) * 2, True, ((3, 10), (2, 7), (1, 10)),
              dict(block_t=4)),
    "compact": (("lstm",) * 3, False, ((1, 12), (2, 7)),
                dict(block_t=4, sparsity="block")),
}


def _zero_tiles(stack, tiles):
    """Zero 8-row tiles of U (layer -> tiles) for block sparsity."""
    for l, ts in tiles.items():
        for half in (stack["layers"][l].get("fwd", stack["layers"][l]),):
            for t in ts:
                half["U"][t * 8:(t + 1) * 8] = 0.0
    return stack


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_matches_reference_and_solo(case):
    families, bidir, reqs, pol = CASES[case]
    params = _stack(families, 24, bidirectional=bidir, seed=len(case))
    if pol.get("sparsity") == "block":
        params = _zero_tiles(params, {0: (0, 2), 1: (1,)})
    xs = [_xs(B, T, 24, seed=10 + i) for i, (B, T) in enumerate(reqs)]
    cs = rnn.compile(params, rnn.ExecutionPolicy(**pol), device="cpu")
    packed = cs.prefill(xs)
    assert cs.plan.launches < cs.plan.naive_launches     # cells did pack
    for x, (ys, st) in zip(xs, packed):
        ref_y, ref_st = _reference(params, families, x)
        _close(ys, ref_y, TOL)
        _close(st, ref_st, TOL)
        solo = rnn.compile(params, rnn.ExecutionPolicy(**pol),
                           device="cpu").prefill(x)
        _close(ys, solo[0], ISOLATION_TOL)
        _close(st, solo[1], ISOLATION_TOL)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_reduced_precision_matches_its_oracle_and_solo(precision):
    """U under bf16 / int8: the kernels' operands are the transform of the
    stack's banks; the oracle is the same stack's dequantized view."""
    params = _stack(("lstm",) * 3, 24, bidirectional=True, seed=5)
    pol = rnn.ExecutionPolicy(precision=precision, block_t=4)
    xs = [_xs(1, T, 24, seed=20 + T) for T in (11, 6, 9)]
    cs = rnn.compile(params, pol, device="cpu")
    oracle = fake_quant_stack(params, precision)
    for x, (ys, st) in zip(xs, cs.prefill(xs)):
        ref_y, ref_st = _reference(oracle, ("lstm",) * 3, x)
        _close(ys, ref_y, TOL)
        _close(st, ref_st, TOL)
        solo = rnn.compile(params, pol, device="cpu").prefill(x)
        _close(ys, solo[0], ISOLATION_TOL)
        _close(st, solo[1], ISOLATION_TOL)


@pytest.mark.parametrize("families", [("lstm",) * 3, ("gru", "lstm")])
def test_waves_resume_from_init_state(families):
    """Unidirectional items of different B and T resumed from their own
    (L, B, H) state in one packed plan, against the reference walked from
    the same state and against each item executed alone."""
    H, L = 16, len(families)
    params = _stack(families, H, seed=7)
    reqs = ((2, 9), (1, 5), (3, 9))
    items = [WorkItem(uid=i, family=families[0], B=B, T=T, H=H, L=L,
                      share=0, families=families)
             for i, (B, T) in enumerate(reqs)]
    gen = torch.Generator().manual_seed(3)
    inputs = {i: _xs(B, T, H, seed=30 + i)
              for i, (B, T) in enumerate(reqs)}
    init = {i: {"h": torch.randn(L, B, H, generator=gen),
                "c": torch.randn(L, B, H, generator=gen)}
            for i, (B, T) in enumerate(reqs)}
    p = plan(items, schedule="wavefront", block_t=4)
    assert any(len(s.groups[0]) > 1 for s in p.slots)   # cross-B rows
    outs, states = execute(p, {i: params for i in inputs}, inputs,
                           collect_state=True, init_state=init)
    for i in inputs:
        ref_y, ref_st = _reference(params, families, inputs[i], init[i])
        _close(outs[i], ref_y, TOL)
        _close(states[i], ref_st, TOL)
        solo = plan([items[i]], schedule="wavefront", block_t=4)
        s_out, s_st = execute(solo, {i: params}, {i: inputs[i]},
                              collect_state=True, init_state={i: init[i]})
        _close(outs[i], s_out[i], ISOLATION_TOL)
        _close(states[i], s_st[i], ISOLATION_TOL)


def test_slots_of_two_stacks_match_reference_and_solo():
    """Items binding two parameter stacks (no share key) share launches as
    rows of their own: each stack's layer-0 products are a GEMM of their
    own, and a slot's U, W and b come from both stacks' banks."""
    H, L = 16, 3
    stacks = {0: _stack(("lstm",) * L, H, seed=21),
              1: _stack(("lstm",) * L, H, seed=22)}
    reqs = {0: (1, 9), 1: (2, 9)}
    items = [WorkItem(uid=u, family="lstm", B=B, T=T, H=H, L=L)
             for u, (B, T) in reqs.items()]
    inputs = {u: _xs(B, T, H, seed=70 + u) for u, (B, T) in reqs.items()}
    p = plan(items, schedule="wavefront", block_t=4)
    mixed = [s for s in p.slots
             if len({c.uid for c in s.cells}) == 2]
    assert mixed                      # a launch holds rows of both stacks
    outs, states = execute(p, stacks, inputs, collect_state=True)
    for u in reqs:
        ref_y, ref_st = _reference(stacks[u], ("lstm",) * L, inputs[u])
        _close(outs[u], ref_y, TOL)
        _close(states[u], ref_st, TOL)
        solo = plan([items[u]], schedule="wavefront", block_t=4)
        s_out, s_st = execute(solo, {u: stacks[u]}, {u: inputs[u]},
                              collect_state=True)
        _close(outs[u], s_out[u], ISOLATION_TOL)
        _close(states[u], s_st[u], ISOLATION_TOL)


def test_plan_cache_hit_reuses_the_plan_operands():
    """A second call on the same plan takes its operands from the
    stack's cache and gives the same numbers."""
    params = _stack(("lstm",) * 2, 16, bidirectional=True, seed=2)
    cs = rnn.compile(params, rnn.ExecutionPolicy(block_t=4), device="cpu")
    xs = [_xs(1, T, 16, seed=T) for T in (7, 12)]
    first = cs.prefill(xs)
    plans = cs._operand_cache[executor._PLANS]
    assert len(plans) == 1
    ops = next(iter(plans.values()))
    again = cs.prefill(xs)
    assert next(iter(plans.values())) is ops and len(plans) == 1
    for (a, sa), (b, sb) in zip(first, again):
        assert torch.equal(a, b)
        _close(sa, sb, 0.0)


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lens,poison,slot", [
    ((9, 9, 6, 9), {1: 1, 3: 1}, 0),    # a slot of one unpadded row
    ((8, 4, 8), {0: 5, 2: 5}, 1),       # a row padded to the slot's B
])
def test_check_finite_names_exactly_the_poisoned_uids(lens, poison, slot):
    """A packed wave with NaN frames in some prompts: the finiteness
    check raises after the slot where their state turns, naming those
    prompts and no other."""
    params = _stack(("lstm",) * 2, 16, seed=4)
    cs = rnn.compile(params, rnn.ExecutionPolicy(block_t=4,
                                                 check_finite=True),
                     device="cpu")
    xs = [_xs(1, T, 16, seed=40 + T) for T in lens]
    for i, t in poison.items():
        xs[i][0, t, 3] = float("nan")
    with pytest.raises(NonFiniteStateError) as err:
        cs.prefill(xs)
    assert sorted(err.value.uids) == sorted(poison)
    assert err.value.slot == slot and err.value.where == "slot state"
    failed = next(iter(cs._operand_cache[executor._PLANS].values()))
    s = failed.plan.slots[slot]
    assert (s.group_b != (s.B,) * s.g) == (slot == 1)   # padded rows
    clean = [x for i, x in enumerate(xs) if i not in poison]
    for ys, _ in cs.prefill(clean):
        assert bool(torch.isfinite(ys).all())


def test_check_finite_names_the_poisoned_decode_row():
    params = _stack(("lstm",) * 3, 16, seed=6)
    cs = rnn.compile(params, rnn.ExecutionPolicy(check_finite=True),
                     device="cpu")
    st = {"h": torch.zeros(3, 4, 16), "c": torch.zeros(3, 4, 16)}
    x = _xs(4, 1, 16, seed=8)
    x[2, 0, 0] = float("nan")
    with pytest.raises(NonFiniteStateError) as err:
        cs.decode(x, st)
    assert list(err.value.uids) == [0] and err.value.where == "decode tick"


@pytest.mark.parametrize("bidir", [False, True])
def test_injected_fault_recovers_on_the_per_step_rung(bidir):
    """Slot 2's fused launch raises; its per-step rung serves it from the
    same gathered operands, and every output and state equals the
    fault-free run's."""
    params = _stack(("lstm",) * 3, 16, bidirectional=bidir, seed=9)
    pol = dict(block_t=4, on_fault="fallback")
    xs = [_xs(1, T, 16, seed=50 + T) for T in (10, 7)]
    clean = rnn.compile(params, rnn.ExecutionPolicy(**pol),
                        device="cpu").prefill(xs)
    cs = rnn.compile(params, rnn.ExecutionPolicy(**pol), device="cpu")
    cs.fault.arm([2])
    got = cs.prefill(xs)
    assert cs.fault.fired == [(2, 0)]
    assert cs.stats.degraded_launches == 1 and cs.stats.fallback_level == 1
    for (a, sa), (b, sb) in zip(got, clean):
        _close(a, b, ISOLATION_TOL)
        _close(sa, sb, ISOLATION_TOL)


# ---------------------------------------------------------------------------
# lanes: independent slots on streams of their own (the card)
# ---------------------------------------------------------------------------


def _ragged_plan(n=12, seed=0):
    rng = np.random.default_rng(seed)
    items = [WorkItem(uid=i, family="lstm", B=1, T=int(T), H=24, L=3,
                      bidirectional=True, share=0)
             for i, T in enumerate(rng.integers(5, 30, size=n))]
    return plan(items), _stack(("lstm",) * 3, 24, bidirectional=True)


def test_lanes_order_every_slot_after_what_it_reads(monkeypatch):
    """With four lanes, every slot issues after each slot that wrote its
    cells' previous chunks and the layer below: earlier on its own lane,
    or on another lane it waits for, which signals."""
    monkeypatch.setattr(executor, "_lane_count", lambda device, seq: 4)
    p, params = _ragged_plan()
    ops = executor._PlanOperands(p, {ip.uid: params for ip in p.items},
                                 torch.device("cpu"), {})
    seq = [s for s in p.slots if not s.chained]
    where = {(c.uid, c.layer, c.chunk, c.direction): i
             for i, s in enumerate(seq) for c in s.cells}
    lanes = [ops.slots[s.index].lane for s in seq]
    assert len(set(lanes)) == 4
    for i, s in enumerate(seq):
        so = ops.slots[s.index]
        for c in s.cells:
            step = 1 if c.direction == "bwd" else -1
            deps = [(c.uid, c.layer, c.chunk + step, c.direction)]
            if c.layer:
                deps += [(c.uid, c.layer - 1, c.chunk, d)
                         for d in ("fwd", "bwd")]
            for k in deps:
                j = where.get(k)
                if j is None or j == i:
                    continue
                assert j < i
                assert lanes[j] == lanes[i] or seq[j].index in so.waits
        assert all(ops.slots[j].signal for j in so.waits)


def test_one_lane_off_the_card():
    p, params = _ragged_plan(n=4)
    ops = executor._PlanOperands(p, {ip.uid: params for ip in p.items},
                                 torch.device("cpu"), {})
    assert ops.n_lanes == 1
    assert all(so.lane == 0 and not so.waits and not so.signal
               for so in ops.slots.values())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_lanes_equal_one_stream_bit_for_bit(cuda, monkeypatch):
    """Ragged bidirectional utterances on the card: the slots issued on
    several streams give every output and state bit for bit what one
    stream gives."""
    params = _stack(("lstm",) * 3, 64, bidirectional=True, seed=11)
    params = {"layers": [{d: {k: v.to(cuda) for k, v in half.items()}
                          for d, half in layer.items()}
                         for layer in params["layers"]]}
    xs = [_xs(1, T, 64, seed=60 + T).to(cuda)
          for T in (37, 120, 64, 9, 201, 88, 150, 45)]
    cs = rnn.compile(params, rnn.ExecutionPolicy(), device="cuda")
    many = cs.prefill(xs)
    ops = next(iter(cs._operand_cache[executor._PLANS].values()))
    assert ops.n_lanes > 1
    monkeypatch.setattr(executor, "_lane_count", lambda device, seq: 1)
    one = rnn.compile(params, rnn.ExecutionPolicy(),
                      device="cuda").prefill(xs)
    for (a, sa), (b, sb) in zip(many, one):
        assert torch.equal(a, b)
        _close(sa, sb, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [False, True])
def test_cuda_packed_rows_equal_solo_bit_for_bit(cuda, bidirectional):
    """At BYSDNE's width (H = X = 340) on the card, each request of a
    packed wave gives bit for bit what it gives alone: its input products
    run at a shape the packing does not change (``PRODUCT_ROWS``,
    ``PRODUCT_ENTRIES``), and the kernels split by shape alone."""
    params = _stack(("lstm",) * 2, 340, bidirectional=bidirectional,
                    seed=12)
    params = {"layers": [
        {d: {k: v.to(cuda) for k, v in half.items()}
         for d, half in layer.items()} if bidirectional
        else {k: v.to(cuda) for k, v in layer.items()}
        for layer in params["layers"]]}
    xs = [_xs(1, T, 340, seed=80 + T).to(cuda) for T in (30, 30, 17, 45)]
    packed = rnn.compile(params, rnn.ExecutionPolicy(),
                         device="cuda").prefill(xs)
    for x, (ys, st) in zip(xs, packed):
        solo = rnn.compile(params, rnn.ExecutionPolicy(),
                           device="cuda").prefill(x)
        assert torch.equal(ys, solo[0])
        _close(st, solo[1], 0.0)
