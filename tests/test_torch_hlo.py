"""The port's static cost walker (``repro_torch.calib.hlo``) against hand
counts, the reference's walker (``repro.calib.hlo``) and the kernels'
bounds.

* hand-counted programs: products, views, in-place writes, broadcast
  operands, transcendentals, the memory high-water mark;
* each collective kind's bytes on a 4-rank fake process group, held equal
  to the reference's walker on the same program lowered by JAX on 4 CPU
  devices (a subprocess);
* FLOP parity: the walker's FLOPs of the port's reduced decode step equal
  the reference's walker on the jitted step, exactly, for all ten archs
  (prefill and train: ``test_torch_hlo_steps.py``); transcendentals equal
  on the dense decoders and printed beside the reference's elsewhere, each
  difference named;
* each kernel's ``Cost`` reproduces PERF.md's Bound column at its shapes.
"""
import gzip
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from tests.conftest import REPO_ROOT, SRC, subprocess_env

from repro.calib import hlo as jhlo
from repro.configs import get_reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.launch import steps as jsteps

from repro_torch.calib import hlo
from repro_torch.configs import get_reduced, list_archs
from repro_torch.configs.base import H100, ShapeConfig
from repro_torch.launch import steps

F32 = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(step, *args):
    t, out = hlo.run(step, *(torch.empty(a) if isinstance(a, tuple) else a
                             for a in args))
    return hlo.analyze(t.text()), t


# ---------------------------------------------------------------------------
# hand-counted programs
# ---------------------------------------------------------------------------


def test_analyze_returns_the_reference_keys():
    r, _ = _walk(lambda x: x + 1, (4,))
    assert set(r) == set(jhlo.analyze("")) == {
        "flops", "bytes", "transcendental_elems", "collective_bytes",
        "collectives"}


@pytest.mark.parametrize("name,step,shapes,flops,nbytes", [
    ("mm", torch.mm, [(4, 64), (64, 32)], 2 * 4 * 64 * 32,
     F32 * (4 * 64 + 64 * 32 + 4 * 32)),
    ("bmm", torch.bmm, [(3, 4, 8), (3, 8, 5)], 2 * 3 * 4 * 8 * 5,
     F32 * (3 * 4 * 8 + 3 * 8 * 5 + 3 * 4 * 5)),
    ("addmm", torch.addmm, [(32,), (4, 64), (64, 32)], 2 * 4 * 64 * 32,
     F32 * (32 + 4 * 64 + 64 * 32 + 4 * 32)),
])
def test_products(name, step, shapes, flops, nbytes):
    r, _ = _walk(step, *shapes)
    assert r["flops"] == flops
    assert r["bytes"] == nbytes
    assert r["transcendental_elems"] == 0 and r["collectives"] == {}


def test_views_are_free():
    def step(x):
        v = x.view(8, 8).t()[1:].unsqueeze(0).transpose(1, 2)
        return v.sum()

    r, t = _walk(step, (64,))
    text = t.text()
    assert "aten.view.default" in text and "free" in text
    assert r["bytes"] == F32 * (8 * 7 + 1)  # the sum reads the 7 x 8 view


def test_a_broadcast_operand_counts_its_distinct_elements():
    r, t = _walk(lambda x, y: x.expand(64, 32) + y, (1, 32), (64, 32))
    assert "f32[64,32]{1,32}" in t.text()
    assert r["bytes"] == F32 * (32 + 64 * 32 + 64 * 32)


def test_an_in_place_ring_write_counts_the_region_written():
    def step(ring, rows, slot, val):
        ring.index_put_((rows, slot), val)  # one slot a row, the decode step
        ring[:, 3].copy_(val)  # a slice, copied over
        return ring

    ring = torch.empty(4, 16, 32)
    rows = torch.empty(4, dtype=torch.long)
    r, t = _walk(step, ring, rows, rows.clone(), (4, 32))
    # index_put_: the two index vectors and the values read, 4 x 32
    # written; copy_: 4 x 32 read and written; the ring is not re-read
    assert r["bytes"] == 2 * 4 * 8 + F32 * (3 * 4 * 32) + F32 * 4 * 32
    assert "f32[4,16,32]{4,32}!" in t.text()
    assert t.memory.alias_bytes == t.memory.output_bytes == F32 * 4 * 16 * 32
    assert t.memory.high_water == 0  # nothing new was made


def test_an_add_in_place_reads_and_writes():
    def step(acc, g):
        acc.add_(g)
        return acc

    r, t = _walk(step, (64,), (64,))
    assert "rmw" in t.text()
    assert r["bytes"] == F32 * (64 + 2 * 64)


@pytest.mark.parametrize("name,step,per_elem", [
    ("exp", torch.exp, 1), ("tanh", torch.tanh, 1),
    ("sigmoid", torch.sigmoid, 1), ("rsqrt", torch.rsqrt, 1),
    ("silu", torch.nn.functional.silu, 1),
    ("softmax", lambda x: torch.softmax(x, -1), 1),
    ("gelu_tanh", lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
     1),
    ("pow_half", lambda x: x ** 0.5, 1), ("pow_two", lambda x: x ** 2, 0),
    ("logsigmoid", torch.nn.functional.logsigmoid, 2),
    ("relu", torch.relu, 0),
])
def test_transcendentals(name, step, per_elem):
    r, _ = _walk(step, (4, 8))
    assert r["transcendental_elems"] == per_elem * 32


def test_log_softmax_counts_exp_per_element_and_log_per_row():
    r, _ = _walk(lambda x: torch.log_softmax(x, -1), (4, 8))
    assert r["transcendental_elems"] == 32 + 4


def test_high_water_mark_follows_frees():
    def step(x):
        a = x * 2  # 512 B (rounded) live
        b = a * 2  # 1024
        del a
        c = b + 1  # 1024 again: a was freed
        return c

    _, t = _walk(step, (16,))
    m = t.memory
    assert m.high_water == 2 * hlo.ALLOC_ROUND
    assert m.output_bytes == F32 * 16 and m.alias_bytes == 0
    assert m.temp_bytes == hlo.ALLOC_ROUND
    assert m.peak_bytes == (m.argument_bytes + m.output_bytes + m.temp_bytes)
    assert f"high_water={m.high_water}" in t.text()


@pytest.mark.parametrize("grad", [False, True])
def test_a_weighted_loop_counts_every_trip(grad):
    """``kernels.common.trips``: under the trace one trip runs, weighted by
    the trip count, where autograd records nothing; its counts equal the
    unrolled loop's.  Under autograd every trip runs (a trip's backward
    would come after the loop, unweighted), unless each trip is closed."""
    from repro_torch.kernels.common import trips

    def step(loop):
        def run(h, w):
            w = w.requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                for _ in loop(5):
                    h = torch.tanh(h @ w)
                if grad:
                    return torch.autograd.grad(h.sum(), w)
            return h
        return run

    r1, t1 = _walk(step(trips), (4, 32), (32, 32))
    r5, t5 = _walk(step(range), (4, 32), (32, 32))
    assert ("weight=5" in t1.text()) != grad
    assert "weight" not in t5.text()
    assert r1 == r5
    assert r1["transcendental_elems"] == 5 * 4 * 32
    if not grad:
        assert r1["flops"] == 5 * 2 * 4 * 32 * 32
        # the unrolled loop holds the last trip's h and product beside the
        # new h; the one traced trip starts from the argument
        one = hlo.alloc_bytes(F32 * 4 * 32)
        assert (t1.memory.high_water, t5.memory.high_water) == (2 * one,
                                                                3 * one)


def test_a_closed_trip_is_weighted_under_autograd():
    """A trip that runs its own backward (a microbatch) is weighted."""
    from repro_torch.kernels.common import trips

    def step(closed):
        def run(x, w):
            w = w.requires_grad_()
            g = torch.zeros_like(w)
            with torch.enable_grad():
                for _ in (trips(4, closed=True) if closed else range(4)):
                    g.add_(torch.autograd.grad((x @ w).sum(), w)[0])
            return g
        return run

    r1, t1 = _walk(step(True), (8, 16), (16, 16))
    r4, _ = _walk(step(False), (8, 16), (16, 16))
    assert "weight=4" in t1.text() and r1 == r4


def test_analyze_file_and_cli(tmp_path):
    text = hlo.trace(torch.mm, torch.empty(4, 8), torch.empty(8, 2))
    path = tmp_path / "t.hlo.gz"
    with gzip.open(path, "wt") as f:
        f.write(text)
    assert hlo.analyze_file(str(path)) == hlo.analyze(text)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.calib.hlo", str(path)],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == hlo.analyze(text)


def test_a_kernel_is_one_op_with_its_cost():
    from repro_torch.kernels import mvm
    from repro_torch.kernels.mvm_tile.ops import mvm_cost

    x, W = torch.empty(4, 64), torch.empty(64, 32)
    calls = mvm.calls
    r, t = _walk(lambda x, W: mvm(x, W) * 2, x, W)
    lines = [ln for ln in t.text().splitlines() if "kernel.mvm" in ln]
    assert len(lines) == 1 and dict(t.kernels) == {"mvm": 1}
    assert mvm.calls == calls + 1  # counted as a call, launched nothing
    c = mvm_cost(x, W)
    assert r["flops"] == c.flops
    assert r["bytes"] == c.bytes + F32 * 2 * 4 * 32  # and the product by 2
    assert t.memory.high_water == 2 * hlo.ALLOC_ROUND


def test_the_kernel_hook_fires_in_the_scans_backward():
    from repro_torch.kernels.rglru.ops import rglru_scan

    def step(la, gx, h0):
        la, gx = la.requires_grad_(), gx.requires_grad_()
        with torch.enable_grad():
            hs, _ = rglru_scan(la, gx, h0)
            return torch.autograd.grad(hs.sum(), (la, gx))

    _, t = _walk(step, (2, 16, 8), (2, 16, 8), (2, 8))
    assert dict(t.kernels) == {"rglru_scan": 1, "rglru_scan_bwd": 1}


# ---------------------------------------------------------------------------
# collectives on a 4-rank fake process group, against the reference
# ---------------------------------------------------------------------------

_JAX_COLLECTIVES = textwrap.dedent("""
    import json
    from functools import partial
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.calib import hlo
    mesh = Mesh(np.array(jax.devices()[:4]), ("i",))
    x = jnp.zeros((32, 16), jnp.float32)
    progs = {
        "all-reduce": lambda a: jax.lax.psum(a, "i"),
        "all-gather": lambda a: jax.lax.all_gather(a, "i", tiled=True),
        "reduce-scatter": lambda a: jax.lax.psum_scatter(
            a, "i", scatter_dimension=0, tiled=True),
        "all-to-all": lambda a: jax.lax.all_to_all(a, "i", 0, 1,
                                                   tiled=True),
    }
    out = {}
    for kind, f in progs.items():
        g = shard_map(f, mesh=mesh, in_specs=P("i"), out_specs=P("i"),
                      check_rep=False)
        out[kind] = hlo.analyze(jax.jit(g).lower(x).compile().as_text()
                                )["collectives"]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_collective_bytes_match_the_reference(fake_group):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    g = fake_group
    progs = {
        "all-reduce": lambda a: funcol.all_reduce(a, "sum", g),
        "all-gather": lambda a: funcol.all_gather_tensor(a, 0, g),
        "reduce-scatter": lambda a: funcol.reduce_scatter_tensor(
            a, "sum", 0, g),
        "all-to-all": lambda a: funcol.all_to_all_single(a, None, None, g),
    }

    def c10d_all_reduce(a):
        dist.all_reduce(a, group=g)
        return a

    def c10d_all_gather(a):
        out = a.new_empty((4 * a.shape[0],) + tuple(a.shape[1:]))
        dist.all_gather_into_tensor(out, a, group=g)
        return out

    def c10d_reduce_scatter(a):
        out = a.new_empty((a.shape[0] // 4,) + tuple(a.shape[1:]))
        dist.reduce_scatter_tensor(out, a, group=g)
        return out

    c10d = {"all-reduce": c10d_all_reduce, "all-gather": c10d_all_gather,
            "reduce-scatter": c10d_reduce_scatter}
    got = {k: _walk(f, (8, 16))[0]["collectives"] for k, f in progs.items()}
    got_c10d = {k: _walk(f, (8, 16))[0]["collectives"]
                for k, f in c10d.items()}
    env = subprocess_env(4)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _JAX_COLLECTIVES],
                         capture_output=True, text=True, env=env,
                         cwd=REPO_ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    local = F32 * 8 * 16
    # the reference's conventions on a local (8, 16) f32 shard
    assert ref == {"all-reduce": {"all-reduce": 2.0 * local},
                   "all-gather": {"all-gather": 4.0 * local},
                   "reduce-scatter": {"reduce-scatter": 1.0 * local},
                   "all-to-all": {"all-to-all": 1.0 * local}}
    assert got == ref
    assert got_c10d == {k: ref[k] for k in c10d}


# ---------------------------------------------------------------------------
# FLOP parity with the reference's walker on the jitted reduced decode step
# ---------------------------------------------------------------------------

DENSE = ("starcoder2-3b", "h2o-danube-3-4b", "stablelm-12b", "deepseek-67b",
         "musicgen-large", "qwen2-vl-72b")

#: where the two walkers' transcendental counts differ, why
TRANSCENDENTAL_DIFFERENCES = {
    "olmoe-1b-7b": "the port's MoE takes the router's softmax twice a layer "
                   "(moe.route and the aux loss); XLA keeps one",
    "arctic-480b": "as olmoe-1b-7b: the router's softmax twice a layer",
    "xlstm-125m": "the port computes RoPE's cos / sin and their frequencies' "
                  "power, which no xLSTM block reads (XLA drops the dead "
                  "values), and a runtime sqrt of the head scale (folded by "
                  "XLA); XLA counts the sLSTM / mLSTM gates' exp as its own",
    "recurrentgemma-2b": "the RG-LRU decode step's a = exp(log_a) is "
                         "XLA's polynomial in arithmetic on the port "
                         "(kernels.rglru.ref.xla_exp: no transcendental op); "
                         "the reference's scan lowers it, a² and the gates' "
                         "softplus to exp / log1p ops",
}


def reference_walk(arch, mode, B, T):
    cfg = jreduced(arch)
    sp = jsteps.input_specs(cfg, JShape("parity", T, B, mode))
    if mode == "decode":
        step, args = jsteps.make_serve_step(cfg), (sp["params"], sp["cache"],
                                                   sp["batch"])
    elif mode == "prefill":
        step, args = jsteps.make_prefill_step(cfg, T), (sp["params"],
                                                        sp["batch"])
    else:
        step, args = jsteps.make_train_step(cfg), (sp["params"],
                                                   sp["opt_state"],
                                                   sp["batch"])
    return jhlo.analyze(jax.jit(step).lower(*args).compile().as_text())


def port_walk(arch, mode, B, T):
    cfg = get_reduced(arch)
    sp = steps.input_specs(cfg, ShapeConfig("parity", T, B, mode))
    if mode == "decode":
        step, args = steps.make_serve_step(cfg), (sp["params"], sp["cache"],
                                                  sp["batch"])
    elif mode == "prefill":
        step, args = steps.make_prefill_step(cfg, T), (sp["params"],
                                                       sp["batch"])
    else:
        step, args = steps.make_train_step(cfg), (sp["params"],
                                                  sp["opt_state"],
                                                  sp["batch"])
    with torch.set_grad_enabled(mode == "train"):
        t, _ = hlo.run(step, *args)
    return hlo.analyze(t.text()), t


@pytest.mark.parametrize("arch", list_archs())
def test_decode_flops_equal_the_references(arch):
    ref = reference_walk(arch, "decode", 4, 64)
    got, t = port_walk(arch, "decode", 4, 64)
    print(f"{arch} decode: FLOPs {got['flops']:.0f} (reference "
          f"{ref['flops']:.0f}); transcendentals "
          f"{got['transcendental_elems']:.0f} (reference "
          f"{ref['transcendental_elems']:.0f}); kernel ops "
          f"{dict(t.kernels)}")
    assert got["flops"] == ref["flops"]
    assert t.kernels["mvm"] > 0
    if arch in DENSE:
        assert got["transcendental_elems"] == ref["transcendental_elems"]
    elif got["transcendental_elems"] != ref["transcendental_elems"]:
        print(f"  difference: {TRANSCENDENTAL_DIFFERENCES[arch]}")


# ---------------------------------------------------------------------------
# each kernel's Cost against PERF.md's Bound column
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _bound_ms(cost, rate):
    peak = {"fp32": H100.peak_flops_fp32, "bf16": H100.peak_flops_bf16}
    return max(cost.bytes / H100.hbm_bw, cost.ops / peak[rate]) * 1e3


def _bound_cases():
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_cost
    from repro_torch.kernels.gru_cell.ops import gru_decode_cost, \
        gru_seq_cost
    from repro_torch.kernels.lstm_cell.ops import (lstm_cell_cost,
                                                   lstm_decode_cost,
                                                   lstm_seq_cost)
    from repro_torch.kernels.mvm_tile.ops import mvm_cost
    from repro_torch.kernels.rglru.ops import (rglru_scan_bwd_cost,
                                               rglru_scan_cost)

    bf16, i8 = torch.bfloat16, torch.int8
    m = _meta
    H = 340

    def lstm_decode(L, B, H):
        return lstm_decode_cost(m(B, 4, H), m(L, H, 4, H, dtype=bf16),
                                m(L, 4, H, dtype=bf16),
                                m(L, H, 4, H, dtype=bf16), m(L, B, H),
                                m(L, B, H))

    def gru_decode(L, B, H):
        return gru_decode_cost(m(B, 3, H), m(L, H, 3, H, dtype=bf16),
                               m(L, 3, H, dtype=bf16),
                               m(L, H, 3, H, dtype=bf16), m(L, B, H))

    def scan(B, T, W):
        return rglru_scan_cost(m(B, T, W), m(B, T, W), m(B, W))

    def scan_bwd(B, T, W):
        s, h = m(B, T, W), m(B, W)
        return rglru_scan_bwd_cost(s, s, h, s, s, h)

    def attn(B, T, Hk, G, D):
        return decode_attention_cost(m(B, Hk * G, D, dtype=bf16),
                                     m(B, T, Hk, D, dtype=bf16),
                                     m(B, T, Hk, D, dtype=bf16),
                                     m(B, dtype=torch.int32))

    # (label, Cost, rate, PERF.md's Bound column, ms)
    return [
        ("mvm 2560x7680 B=4", mvm_cost(m(4, 2560, dtype=bf16),
                                       m(2560, 7680, dtype=bf16)),
         "bf16", 0.011762),
        ("mvm 2560x512 B=4", mvm_cost(m(4, 2560, dtype=bf16),
                                      m(2560, 512, dtype=bf16)),
         "bf16", 0.000790),
        ("mvm 8192x29568 B=4", mvm_cost(m(4, 8192, dtype=bf16),
                                        m(8192, 29568, dtype=bf16)),
         "bf16", 0.144700),
        ("decode_attention full B=4 ring", attn(4, 2048, 1, 10, 256), "bf16",
         0.002516),
        ("decode_attention starcoder2 4096 B=4", attn(4, 4096, 2, 12, 128),
         "bf16", 0.005023),
        ("rglru_scan B=1 T=1024", scan(1, 1024, 2560), "fp32", 0.009396),
        ("rglru_scan B=4 T=2048", scan(4, 2048, 2560), "fp32", 0.075146),
        ("rglru_scan_bwd B=1 T=1024", scan_bwd(1, 1024, 2560), "fp32",
         0.018790),
        ("lstm_decode L=5 H=340 B=4", lstm_decode(5, 4, 340), "fp32",
         0.002527),
        ("lstm_decode L=10 H=1024 B=1", lstm_decode(10, 1, 1024), "fp32",
         0.047653),
        ("gru_decode L=5 H=340 B=4", gru_decode(5, 4, 340), "fp32",
         0.001887),
        ("lstm_cell H=340 B=4 bf16 U", lstm_cell_cost(
            m(H, 4, H, dtype=bf16), m(4, 4, H), m(4, H), m(4, H)), "fp32",
         0.000289),
        ("lstm_cell H=1024 B=4 bf16 U", lstm_cell_cost(
            m(1024, 4, 1024, dtype=bf16), m(4, 4, 1024), m(4, 1024),
            m(4, 1024)), "fp32", 0.002543),
        ("lstm_seq G=2 B=4 T=8 fp32", lstm_seq_cost(
            m(2, H, 4, H), m(2, 4, 8, 4, H), m(2, 4, H), m(2, 4, H)),
         "fp32", 0.001247),
        ("lstm_seq int8 G=2 B=4 T=15", lstm_seq_cost(
            m(2, H, 4, H, dtype=i8), m(2, 4, 15, 4, H), m(2, 4, H),
            m(2, 4, H), u_scales=m(2, 4)), "fp32", 0.001667),
        ("gru_seq G=2 B=4 T=8 bf16 U", gru_seq_cost(
            m(2, H, 3, H, dtype=bf16), m(2, 4, 8, 3, H), m(2, 4, H)),
         "fp32", 0.000666),
    ]


@pytest.mark.parametrize("case", range(16))
def test_kernel_cost_reproduces_the_bound_column(case):
    cases = _bound_cases()
    assert len(cases) == 16
    label, cost, rate, want = cases[case]
    assert round(_bound_ms(cost, rate), 6) == want, label
