"""The port's measured cost model (``repro_torch.calib``) against the JAX
package's (``repro.calib``) on the CPU.

Signatures, ``slot_us`` resolutions, table files and the planner's
decisions under one hand-built table must be the same in both packages.
The port tags its entries ``torch(cpu)`` on the CPU and the reference
``interpret(cpu)``, so a table meant for both carries every entry under
both tags.  The JAX side runs its Pallas kernels in interpret mode, as
its own tests do; execution is compared at the dispatch parity tests'
fp32 tolerance.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.calib as jcalib
from repro import rnn as jrnn
from repro.calib.replay import _operands as j_operands
from repro.configs.sharp_lstm import BYSDNE as J_BYSDNE
from repro.configs.sharp_lstm import eesen_demo as j_eesen_demo
from repro.configs.sharp_lstm import lstm_config as jlstm_config
from repro.core.gru import init_gru_stack as jinit_gru_stack
from repro.core.perfmodel import Design as JDesign
from repro.models.layers.lstm import init_lstm_stack as jinit_lstm_stack

from repro_torch import calib, rnn
from repro_torch.calib.__main__ import SMALL_GRID
from repro_torch.calib.replay import _operands
from repro_torch.configs.sharp_lstm import BYSDNE, eesen_demo, lstm_config
from repro_torch.convert import from_jax
from repro_torch.core.perfmodel import Design
from repro_torch.kernels.gru_cell import ops as gru_ops
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.kernels.common import reset_counts
from repro_torch.runtime.obs import slot_signature

TOL = 1e-5
H, L, B = 64, 3, 2
DESIGN = Design(macs=16384, schedule="unfolded")
JDESIGN = JDesign(macs=16384, schedule="unfolded")
#: the two packages' CPU tags: a hand-built table for both carries each
#: entry under both
J_CPU = jcalib.current_backend(True)
CPU = calib.CPU_BACKEND
SEQ_ENTRIES = (lstm_ops.lstm_seq, gru_ops.gru_seq,
               lstm_ops.lstm_decode, gru_ops.gru_decode)


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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _leaves(x)]
    return [tree]


# ---------------------------------------------------------------------------
# backend tags
# ---------------------------------------------------------------------------


def test_backend_tags_never_equal_a_reference_tag():
    assert calib.current_backend("cpu") == CPU == "torch(cpu)"
    ref_tags = {jcalib.current_backend(True), jcalib.current_backend(False),
                "interpret(cpu)", "cpu", "tpu", "gpu"}
    assert CPU not in ref_tags
    with pytest.raises(ValueError, match="cuda, cpu"):
        calib.current_backend("meta")


def test_cuda_tag_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the cuda tag is answerable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calib.current_backend("cuda")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calib.current_backend()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calib.calibrate([calib.Candidate("lstm", 16, 1, 1, 1)])


# ---------------------------------------------------------------------------
# signatures and the table's scorer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sig", [
    "lstm|H64|G3|B1|bt1|float32|fwd",
    "lstm|H64|G3|B1|bt1|float32|fwd|chained",
    "gru|H340|G2|B4|bt8|bfloat16|bwd+fwd|pint8",
    "lstm|H64|G1|B3|bt1|float32|fwd|pbf16|chained",
    "lstm|H64|G1|B3|bt1|float32",           # too few fields
    "lstm|Hx|G1|B3|bt1|float32|fwd",        # not a number
    "lstm|H64|G1|B3|bt1|float32|fwd|bogus",  # unknown trailing token
])
def test_parse_signature_matches_reference(sig):
    assert calib.parse_signature(sig) == jcalib.parse_signature(sig)


#: hand-built entries: (family, H, G, B, bt, dtype, dirs, chained,
#: precision, med_us)
ENTRIES = (
    ("lstm", 64, 3, 1, 1, "float32", ("fwd",), False, "fp32", 100.0),
    ("lstm", 64, 1, 1, 1, "float32", ("fwd",), False, "fp32", 40.0),
    ("lstm", 64, 3, 2, 1, "float32", ("fwd",), True, "fp32", 250.0),
    ("gru", 64, 2, 4, 8, "float32", ("bwd", "fwd"), False, "int8", 75.0),
)


def _fill(table, design, analytic):
    for fam, h, g, b, bt, dt, dirs, ch, prec, med in ENTRIES:
        table.record(slot_signature(fam, h, g, b, bt, dt, dirs, ch, prec),
                     med, med * 1.2, 5,
                     analytic(fam, h, g, b, bt, design, chained=ch,
                              precision=prec))
    return table


def _models():
    port = calib.MeasuredCostModel(_fill(calib.MeasuredCostTable(CPU),
                                         DESIGN,
                                         calib.analytic_shape_cycles))
    ref = jcalib.MeasuredCostModel(_fill(jcalib.MeasuredCostTable(J_CPU),
                                         JDESIGN,
                                         jcalib.analytic_shape_cycles))
    return port, ref


@pytest.mark.parametrize("query,resolution", [
    (("lstm", 64, 3, 1, 1, "float32", ("fwd",), False, "fp32"), "hits"),
    (("lstm", 64, 3, 2, 1, "float32", ("fwd",), True, "fp32"), "hits"),
    (("lstm", 96, 2, 2, 4, "float32", ("fwd",), False, "fp32"),
     "interpolated"),
    (("lstm", 64, 3, 4, 1, "float32", ("fwd",), True, "fp32"),
     "interpolated"),
    (("gru", 64, 2, 2, 16, "float32", ("fwd", "bwd"), False, "int8"),
     "interpolated"),
    (("lstm", 1024, 1, 1, 1, "float32", ("fwd",), False, "fp32"),
     "fallbacks"),
    (("gru", 64, 2, 4, 8, "float32", ("bwd", "fwd"), False, "fp32"),
     "fallbacks"),   # precision is categorical: no int8 neighbour
    (("lstm", 64, 3, 1, 1, "bfloat16", ("fwd",), False, "fp32"),
     "fallbacks"),
])
def test_slot_us_matches_reference(query, resolution):
    port, ref = _models()
    fam, h, g, b, bt, dt, dirs, ch, prec = query
    ours = port.slot_us(fam, h, g, b, bt, dt, dirs, ch, prec)
    theirs = ref.slot_us(fam, h, g, b, bt, dt, dirs, ch, prec)
    assert ours == pytest.approx(theirs, rel=1e-9) and ours > 0
    assert getattr(port, resolution) == getattr(ref, resolution) == 1
    assert port.hits + port.interpolated + port.fallbacks == 1
    assert port.describe().replace(CPU, J_CPU) == ref.describe()


# ---------------------------------------------------------------------------
# one table file for both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first", ["reference", "port"])
def test_table_file_shared_between_packages(tmp_path, first):
    """A table saved by one package loads in the other; each side's
    backend entries survive the other's save; repeated signatures merge
    by the same rule."""
    path = str(tmp_path / "measured_costs.json")
    port = _fill(calib.MeasuredCostTable(CPU), DESIGN,
                 calib.analytic_shape_cycles)
    ref = _fill(jcalib.MeasuredCostTable(J_CPU), JDESIGN,
                jcalib.analytic_shape_cycles)
    one, two = (ref, port) if first == "reference" else (port, ref)
    one.save(path)
    two.save(path)
    with open(path) as f:
        raw = json.load(f)
    assert raw["version"] == calib.TABLE_VERSION == jcalib.TABLE_VERSION
    assert sorted(raw["backends"]) == sorted([CPU, J_CPU])
    assert raw["stamp"] == 2
    for load, tag in ((calib.MeasuredCostTable.load, CPU),
                      (jcalib.MeasuredCostTable.load, J_CPU),
                      (calib.MeasuredCostTable.load, J_CPU),
                      (jcalib.MeasuredCostTable.load, CPU)):
        t = load(path, backend=tag)
        assert len(t) == len(ENTRIES) and t.stamp == 2
        sig = t.signatures()[0]
        assert t.lookup(sig)["runs"] == 1
    # a later run of the other package on the same file: newer wins,
    # counts accumulate, and the first package's tag passes through
    again = jcalib.MeasuredCostTable(CPU) if first == "reference" \
        else calib.MeasuredCostTable(J_CPU)
    sig = slot_signature(*ENTRIES[0][:8])
    again.record(sig, 7.0, 8.0, 3, 123.0)
    again.save(path)
    mine = calib.MeasuredCostTable.load(path, backend=again.backend)
    theirs = jcalib.MeasuredCostTable.load(path, backend=again.backend)
    for t in (mine, theirs):
        e = t.lookup(sig)
        assert (e["med_us"], e["n"], e["runs"], e["stamp"]) == \
            (7.0, 8, 2, 3)
    other = CPU if again.backend == J_CPU else J_CPU
    assert len(calib.MeasuredCostTable.load(path, backend=other)) == \
        len(ENTRIES)


@pytest.mark.parametrize("version", [0, calib.TABLE_VERSION + 1])
def test_stale_version_loads_empty_in_both(tmp_path, version):
    path = str(tmp_path / "stale.json")
    _fill(calib.MeasuredCostTable(CPU), DESIGN,
          calib.analytic_shape_cycles).save(path)
    with open(path) as f:
        raw = json.load(f)
    raw["version"] = version
    with open(path, "w") as f:
        json.dump(raw, f)
    assert len(calib.MeasuredCostTable.load(path, backend=CPU)) == 0
    assert len(jcalib.MeasuredCostTable.load(path, backend=CPU)) == 0
    assert not calib.MeasuredCostModel(
        calib.MeasuredCostTable.load(path, backend=CPU)).active


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


class _Shape:
    """The CompiledStack shape surface ``candidates_for`` reads."""

    def __init__(self, families, H, X, bidirectional=False):
        self.families, self.H, self.X = tuple(families), H, X
        self.L, self.bidirectional = len(families), bidirectional


#: name -> (the model from a package's (lstm_config, BYSDNE, eesen_demo),
#: candidates_for's keywords)
CANDIDATE_MODELS = {
    "lstm-cfg": (lambda c: c[0](64, layers=3), dict(shapes=((2, 8),))),
    "bysdne": (lambda c: c[1], dict(shapes=((4, 30), (1, 30)))),
    "eesen": (lambda c: c[2](), dict(shapes=((4, 300),))),
    "gru-stack": (lambda c: _Shape(("gru",) * 3, 48, 24),
                  dict(shapes=((3, 17), (1, 5)))),
    "mixed-stack": (lambda c: _Shape(("lstm", "gru", "lstm"), 32, 32),
                    dict(shapes=((2, 9),))),
    "lstm-int8": (lambda c: c[0](64, layers=2),
                  dict(shapes=((4, 12),), precision="int8",
                       dtype="bfloat16")),
}
PORT_CONFIGS = (lstm_config, BYSDNE, eesen_demo)
REF_CONFIGS = (jlstm_config, J_BYSDNE, j_eesen_demo)


@pytest.mark.parametrize("name", sorted(CANDIDATE_MODELS))
def test_candidates_for_matches_reference(name):
    make, kw = CANDIDATE_MODELS[name]
    ours = calib.candidates_for(make(PORT_CONFIGS), **kw)
    theirs = jcalib.candidates_for(make(REF_CONFIGS), **kw)
    assert [c.signature() for c in ours] == [c.signature() for c in theirs]
    assert [dataclasses.astuple(c) for c in ours] == \
        [dataclasses.astuple(c) for c in theirs]


@pytest.mark.parametrize("grid", ["smoke", "small"])
def test_sweep_grid_matches_reference(grid):
    from repro.calib.__main__ import SMALL_GRID as J_SMALL_GRID

    ours = calib.sweep_grid(**(calib.SMOKE_GRID if grid == "smoke"
                               else SMALL_GRID))
    theirs = jcalib.sweep_grid(**(jcalib.SMOKE_GRID if grid == "smoke"
                                  else J_SMALL_GRID))
    assert [c.signature() for c in ours] == [c.signature() for c in theirs]
    assert calib.dedupe(ours + ours) == ours


# ---------------------------------------------------------------------------
# replay: the executor's kernel call, on the caller's device
# ---------------------------------------------------------------------------

REPLAYED = {
    "lstm-seq": calib.Candidate("lstm", 16, 2, 3, 4),
    "gru-seq": calib.Candidate("gru", 24, 1, 2, 3),
    "lstm-seq-int8": calib.Candidate("lstm", 16, 2, 1, 2, precision="int8"),
    "gru-seq-bf16": calib.Candidate("gru", 16, 2, 2, 2, precision="bf16"),
    "lstm-chained": calib.Candidate("lstm", 16, 3, 2, 1, chained=True),
    "gru-chained": calib.Candidate("gru", 16, 2, 1, 1, chained=True),
}


@pytest.mark.parametrize("name", sorted(REPLAYED))
def test_replay_lowering_matches_reference(name):
    """The replayed call computes what the reference's replayed call
    computes on the same deterministic operands, and goes through the
    entry point the executor calls (one call, no other entry point)."""
    cand = REPLAYED[name]
    jcand = jcalib.Candidate(**dataclasses.asdict(cand))
    assert cand.signature() == jcand.signature()
    reset_counts(*SEQ_ENTRIES)
    ours = _operands(cand, torch.device("cpu"))()
    theirs = j_operands(jcand, True)()
    fam = "lstm" if cand.family == "lstm" else "gru"
    kind = "decode" if cand.chained else "seq"
    entry = getattr(lstm_ops if fam == "lstm" else gru_ops,
                    f"{fam}_{kind}")
    assert entry.calls == 1
    assert sum(f.calls for f in SEQ_ENTRIES) == 1
    a, b = _leaves(ours), _leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(x), _np(y), atol=TOL)


def test_calibrate_on_the_cpu_tags_torch_cpu(tmp_path):
    cands = [calib.Candidate("lstm", 16, 1, 1, 1),
             calib.Candidate("gru", 16, 2, 1, 2, precision="int8"),
             calib.Candidate("lstm", 16, 2, 1, 1, chained=True)]
    lines = []
    table = calib.calibrate(cands + cands[:1], device="cpu", repeats=2,
                            warmup=1, progress=lines.append)
    assert table.backend == CPU and not table.backend.startswith("cuda(")
    assert len(table) == 3 and len(lines) == 3
    for sig in table.signatures():
        e = table.lookup(sig)
        assert e["med_us"] > 0 and e["p90_us"] >= e["med_us"]
        assert e["n"] == 2 and e["est_cycles"] > 0
    assert list(table.entries) == [CPU]
    assert calib.check_table(table, device="cpu", tolerance=1e6,
                             repeats=1) == []
    path = table.save(str(tmp_path / "t.json"))
    with open(path) as f:
        assert list(json.load(f)["backends"]) == [CPU]
    with pytest.raises(ValueError, match="bound to"):
        calib.check_table(calib.MeasuredCostTable("cuda(some card)"),
                          device="cpu")
    with pytest.raises(ValueError, match="bound to"):
        calib.calibrate(cands, table=calib.MeasuredCostTable(J_CPU),
                        device="cpu")


def test_cli_on_the_cpu_writes_a_torch_cpu_table(tmp_path, capsys):
    from repro_torch.calib.__main__ import main

    out = str(tmp_path / "costs.json")
    assert main(["--device", "cpu", "--repeats", "1", "--warmup", "0",
                 "--check", "1e6", "--out", out]) == 0
    text = capsys.readouterr().out
    assert "[torch(cpu)]" in text and "ok: replay and table agree" in text
    t = calib.MeasuredCostTable.load(out, backend=CPU)
    assert len(t) == len(calib.sweep_grid(**calib.SMOKE_GRID))
    with pytest.raises(SystemExit):
        main(["--grid", "bogus"])


# ---------------------------------------------------------------------------
# the planner and the front end under one hand-built table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stacks():
    jparams = jinit_lstm_stack(jax.random.PRNGKey(0),
                               jlstm_config(H, layers=L), jnp.float32)
    return jparams, from_jax(jparams)


@pytest.fixture(scope="module")
def xs():
    return (np.random.default_rng(1).standard_normal((B, 8, H)) * 0.5
            ).astype(np.float32)


def _flip_table_path(tmp_path, chained_us=12000.0, layer_us=100.0,
                     family="lstm"):
    """One table for both packages (each entry under both CPU tags):
    one chained decode launch costs ``chained_us``, one per-layer launch
    ``layer_us``."""
    path = str(tmp_path / "measured_costs.json")
    for tag in (J_CPU, CPU):
        t = jcalib.MeasuredCostTable(tag)
        t.record(slot_signature(family, H, L, B, 1, "float32", ("fwd",),
                                True),
                 chained_us, chained_us * 1.1, 5,
                 jcalib.analytic_shape_cycles(family, H, L, B, 1, JDESIGN,
                                              chained=True))
        t.record(slot_signature(family, H, 1, B, 1, "float32"),
                 layer_us, layer_us * 1.2, 5,
                 jcalib.analytic_shape_cycles(family, H, 1, B, 1, JDESIGN))
        t.save(path)
    return path


def test_policy_measured_constructs_with_reference_messages():
    pol = rnn.ExecutionPolicy(cost_model="measured", cost_table="x.json")
    assert "cost_model=measured" in pol.describe()
    for kw in ({"cost_model": "vibes"}, {"cost_table": 7}):
        with pytest.raises(ValueError) as ours:
            rnn.ExecutionPolicy(**kw)
        with pytest.raises(ValueError) as ref:
            jrnn.ExecutionPolicy(**kw)
        assert str(ours.value) == str(ref.value)
    assert rnn.COST_MODELS == jrnn.COST_MODELS == ("analytic", "measured")


def test_cold_start_measured_plans_as_analytic(stacks, xs):
    jparams, params = stacks
    analytic = rnn.compile(params, device="cpu")
    cold = rnn.compile(params, rnn.ExecutionPolicy(
        cost_model="measured",
        cost_table=os.path.join("definitely", "missing.json")),
        device="cpu")
    jcold = jrnn.compile(jparams, jrnn.ExecutionPolicy(
        interpret=True, cost_model="measured",
        cost_table=os.path.join("definitely", "missing.json")))
    assert cold.cost_model is not None and not cold.cost_model.active
    assert cold.cost_model.table.backend == CPU
    assert analytic.lower(B, 8).describe() == cold.lower(B, 8).describe() \
        == jcold.lower(B, 8).describe()
    torch.testing.assert_close(cold.forward(xs), analytic.forward(xs),
                               rtol=0, atol=0)
    _, st = cold.prefill(xs)
    _, st_a = analytic.prefill(xs)
    y, _ = cold.decode(xs[:, :1], st)
    y_a, _ = analytic.decode(xs[:, :1], st_a)
    assert cold.last_decode_plan.launches == 1
    torch.testing.assert_close(y, y_a, rtol=0, atol=0)
    assert cold.stats.measured_hits == cold.stats.analytic_fallbacks == 0
    assert "cold start" in cold.describe()


@pytest.mark.parametrize("case", ["flip", "confirm"])
def test_decode_decision_matches_reference(tmp_path, stacks, xs, case):
    """The same table JSON flips the decode tick to the per-layer plan
    (a dear chain) or keeps the chain (a cheap one) in both packages, with
    equal slot signatures and launches and outputs within TOL."""
    jparams, params = stacks
    us = dict(chained_us=12000.0, layer_us=100.0) if case == "flip" \
        else dict(chained_us=10.0, layer_us=1000.0)
    path = _flip_table_path(tmp_path, **us)
    cs = rnn.compile(params, rnn.ExecutionPolicy(
        cost_model="measured", cost_table=path), device="cpu")
    jcs = jrnn.compile(jparams, jrnn.ExecutionPolicy(
        interpret=True, cost_model="measured", cost_table=path))
    analytic = rnn.compile(params, device="cpu")
    _, st = cs.prefill(xs)
    _, jst = jcs.prefill(xs)
    _, st_a = analytic.prefill(xs)
    reset_counts(*SEQ_ENTRIES)
    y, new = cs.decode(xs[:, :1], st)
    launched = (lstm_ops.lstm_seq.calls,
                lstm_ops.lstm_decode.calls)
    jy, jnew = jcs.decode(xs[:, :1], jst)
    y_a, new_a = analytic.decode(xs[:, :1], st_a)

    p, jp = cs.last_decode_plan, jcs.last_decode_plan
    assert [s.signature() for s in p.slots] == \
        [s.signature() for s in jp.slots]
    assert p.launches == jp.launches == (L if case == "flip" else 1)
    assert p.describe() == jp.describe()
    if case == "flip":
        assert all(ip.schedule != "decode" for ip in p.items)
        assert launched == (L, 0)
    else:
        assert p.items[0].schedule == "decode" and launched == (0, 1)
    assert cs.stats.measured_hits == jcs.stats.measured_hits > 0
    assert cs.stats.analytic_fallbacks == jcs.stats.analytic_fallbacks
    np.testing.assert_allclose(_np(y), _np(jy), atol=TOL)
    for k in ("h", "c"):
        np.testing.assert_allclose(_np(new[k]), _np(jnew[k]), atol=TOL)
        # the flipped plan computes the chained tick
        np.testing.assert_allclose(_np(new[k]), _np(new_a[k]), atol=TOL)
    np.testing.assert_allclose(_np(y), _np(y_a), atol=TOL)


def test_gru_decode_flips_to_per_layer(tmp_path):
    """The flip on a GRU stack: L gru_seq launches, no gru_decode, the
    chained tick's numbers, as the reference plans it."""
    jparams = jinit_gru_stack(jax.random.PRNGKey(3), H, H, L, jnp.float32)
    params = from_jax(jparams)
    path = _flip_table_path(tmp_path, family="gru")
    x = (np.random.default_rng(4).standard_normal((B, 5, H)) * 0.5
         ).astype(np.float32)
    cs = rnn.compile(params, rnn.ExecutionPolicy(
        cost_model="measured", cost_table=path), device="cpu")
    jcs = jrnn.compile(jparams, jrnn.ExecutionPolicy(
        interpret=True, cost_model="measured", cost_table=path))
    analytic = rnn.compile(params, device="cpu")
    _, st = cs.prefill(x)
    _, jst = jcs.prefill(x)
    reset_counts(*SEQ_ENTRIES)
    y, new = cs.decode(x[:, :1], st)
    assert (gru_ops.gru_seq.calls, gru_ops.gru_decode.calls) == \
        (L, 0)
    jy, _ = jcs.decode(x[:, :1], jst)
    assert cs.last_decode_plan.describe() == jcs.last_decode_plan.describe()
    np.testing.assert_allclose(_np(y), _np(jy), atol=TOL)
    y_a, _ = analytic.decode(x[:, :1], analytic.prefill(x)[1])
    np.testing.assert_allclose(_np(y), _np(y_a), atol=TOL)


def test_describe_and_stats_surface_cost_model(tmp_path, stacks, xs):
    jparams, params = stacks
    analytic = rnn.compile(params, device="cpu")
    assert "cost model: analytic" in analytic.describe()
    path = _flip_table_path(tmp_path)
    measured = rnn.compile(params, rnn.ExecutionPolicy(
        cost_model="measured", cost_table=path), device="cpu")
    jmeasured = jrnn.compile(jparams, jrnn.ExecutionPolicy(
        interpret=True, cost_model="measured", cost_table=path))
    measured.forward(xs)
    jmeasured.forward(xs)
    d = measured.describe()
    assert "cost model: measured" in d and "table entries" in d
    assert f"[{CPU}]" in d
    cm = measured.cost_model
    assert measured.stats.measured_hits == cm.hits + cm.interpolated
    assert measured.stats.analytic_fallbacks == cm.fallbacks
    assert (measured.stats.measured_hits,
            measured.stats.analytic_fallbacks) == \
        (jmeasured.stats.measured_hits, jmeasured.stats.analytic_fallbacks)
    assert measured.stats.measured_hits + \
        measured.stats.analytic_fallbacks > 0
    assert measured.plan.describe() == jmeasured.plan.describe()


@pytest.mark.parametrize("cost_model", ["measured", "analytic"])
def test_plan_candidates_trace(tmp_path, stacks, xs, cost_model):
    """``plan_candidates`` instants carry ``est_us`` beside ``est_cycles``
    under the measured model and no ``est_us`` under the analytic one, as
    the reference's do."""
    jparams, params = stacks
    kw = dict(cost_model=cost_model, trace=True)
    if cost_model == "measured":
        kw["cost_table"] = _flip_table_path(tmp_path)
    cs = rnn.compile(params, rnn.ExecutionPolicy(**kw), device="cpu")
    jcs = jrnn.compile(jparams, jrnn.ExecutionPolicy(interpret=True, **kw))
    for s in (cs, jcs):
        _, st = s.prefill(xs)
        s.decode(xs[:, :1], st)

    def decode_instants(tracer):
        return [e for e in tracer.events if e.name == "plan_candidates"
                and {c["schedule"] for c in e.tags.get("candidates", ())}
                == {"chained", "per_layer"}]

    ours, theirs = decode_instants(cs.tracer), decode_instants(jcs.tracer)
    assert ours and len(ours) == len(theirs)
    tags, jtags = ours[0].tags, theirs[0].tags
    assert tags["cost_model"] == jtags["cost_model"] == cost_model
    assert tags["chosen"] == jtags["chosen"] == (
        "per_layer" if cost_model == "measured" else "chained")
    for c, jc in zip(tags["candidates"], jtags["candidates"]):
        assert c["est_cycles"] > 0
        assert c["est_cycles"] == pytest.approx(jc["est_cycles"], rel=1e-9)
        if cost_model == "measured":
            assert c["est_us"] > 0
            assert c["est_us"] == pytest.approx(jc["est_us"], rel=1e-9)
        else:
            assert "est_us" not in c and "est_us" not in jc


def _card_like_table(table_cls, backend, analytic, design):
    """Entries shaped as the card's eager times are: a fixed host cost
    per call plus a few µs a step, one chained tick about one launch."""
    t = table_cls(backend)
    for fam in ("lstm", "gru"):
        for g, b, bt in ((1, 1, 8), (2, 1, 8), (1, 1, 1), (1, 1, 4),
                         (2, 1, 4), (1, 2, 8), (2, 2, 8)):
            t.record(slot_signature(fam, 340, g, b, bt, "float32"),
                     15.0 + 3.5 * bt, 20.0 + 3.5 * bt, 5,
                     analytic(fam, 340, g, b, bt, design))
    return t


@pytest.mark.parametrize("family", ["gru", "lstm"])
def test_card_table_keeps_gru_items_on_kernel_roads(family):
    """The reference prices a gru layer's per_step as launch-free
    compute, so a table of card-like µs picks it for every gru item.  The
    port plans as the reference under a CPU-tagged table, and under a
    card-tagged one drops that road (plain PyTorch on the card); lstm
    items plan the same under either tag."""
    from repro.dispatch import plan as jplan
    from repro.dispatch.workitem import WorkItem as JWorkItem

    from repro_torch.dispatch import plan
    from repro_torch.dispatch.workitem import WorkItem

    spec = [dict(uid=i, family=family, B=1, T=t, H=340, L=5, X=340,
                 dtype="float32", share=0) for i, t in enumerate((30, 17))]
    ref = jplan([JWorkItem(**d) for d in spec], cost_model=(
        jcalib.MeasuredCostModel(_card_like_table(
            jcalib.MeasuredCostTable, J_CPU, jcalib.analytic_shape_cycles,
            JDESIGN))))
    plans = {tag: plan([WorkItem(**d) for d in spec],
                       cost_model=calib.MeasuredCostModel(_card_like_table(
                           calib.MeasuredCostTable, tag,
                           calib.analytic_shape_cycles, DESIGN)))
             for tag in (CPU, "cuda(test card)")}
    assert plans[CPU].describe() == ref.describe()
    scheds = {ip.schedule for ip in plans["cuda(test card)"].items}
    if family == "gru":
        assert {ip.schedule for ip in ref.items} == {"per_step"}
        assert "per_step" not in scheds and \
            plans["cuda(test card)"].launches > 0
    else:
        assert plans["cuda(test card)"].describe() == ref.describe()
        assert "per_step" not in scheds


def test_serving_engine_takes_the_measured_policy(tmp_path):
    """RecurrentServingEngine passes cost_model/cost_table to its stack:
    under a table pricing the chain dear, every decode tick runs per
    layer, with the analytic engine's outputs."""
    from repro_torch.serving import RecurrentRequest, RecurrentServingEngine

    cfg = dataclasses.replace(lstm_config(H, layers=L), dtype="float32")
    params = from_jax(jinit_lstm_stack(jax.random.PRNGKey(5),
                                       jlstm_config(H, layers=L),
                                       jnp.float32))
    path = _flip_table_path(tmp_path)
    rng = np.random.default_rng(6)
    frames = [(rng.standard_normal((t, H)) * 0.5).astype(np.float32)
              for t in (6, 6)]

    def serve(**kw):
        eng = RecurrentServingEngine(cfg, params, max_batch=B, device="cpu",
                                     **kw)
        for uid, fr in enumerate(frames):
            eng.submit(RecurrentRequest(uid=uid, frames=fr,
                                        max_new_frames=3))
        return eng, sorted(eng.run_to_completion(), key=lambda c: c.uid)

    reset_counts(*SEQ_ENTRIES)
    eng, done = serve(cost_model="measured", cost_table=path)
    assert eng.compiled.policy.cost_model == "measured"
    assert eng.decode_ticks == 3 and eng.decode_launches == 3 * L
    assert lstm_ops.lstm_decode.calls == 0
    _, ref = serve()
    for g, r in zip(done, ref):
        assert g.status == r.status == "ok"
        np.testing.assert_allclose(g.generated, r.generated, atol=TOL)
        np.testing.assert_allclose(g.outputs, r.outputs, atol=TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REPLAYED))
def test_cuda_replay_launches_the_kernel(cuda, name):
    cand = REPLAYED[name]
    reset_counts(*SEQ_ENTRIES)
    r = calib.replay_candidate(cand, device="cuda", repeats=2, warmup=1)
    assert r["med_us"] > 0 and r["n"] == 2
    launched = [f for f in SEQ_ENTRIES if f.calls]
    assert len(launched) == 1
    assert launched[0].calls == launched[0].kernel_launches == 3


@pytest.mark.cuda
def test_cuda_calibrate_tags_the_card(cuda, tmp_path):
    table = calib.calibrate(list(REPLAYED.values()), device="cuda",
                            repeats=2, warmup=1)
    assert table.backend == f"cuda({torch.cuda.get_device_name(0)})"
    assert table.backend.startswith("cuda(") and len(table) == len(REPLAYED)
    assert calib.check_table(table, device="cuda", tolerance=25) == []
    path = table.save(str(tmp_path / "t.json"))
    cs = rnn.compile(lstm_config(16, layers=3), rnn.ExecutionPolicy(
        cost_model="measured", cost_table=path), device="cuda")
    assert cs.cost_model.table.backend == table.backend
    assert len(calib.MeasuredCostTable.load(path, backend=CPU)) == 0
