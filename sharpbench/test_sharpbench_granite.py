"""The granite-4.0-h-micro cell on the CPU: its twin run through the
harness, the family's reference (the block form against the recurrence
step by step, and against the program's own plain reference), the family's
work counts against the program's shapes, the driver freeing the program
after a run, and the comparison that decides ``correct`` failing what it
must: each fault planted in the program underneath the harness (the state
not decayed, one head's state dropped, a conv tap lost, the residual
multiplier left out).

The faults are read on a twin with longer prompts and requests than the
cell's CPU twin (``LONG``), whose heads hold memory: A drawn from the slow
end of the published range (``SLOW``).  A fault of the state shows where
the state carries something, and the twin's 4 heads a layer drawn over
the whole range seldom hold one that does.

The control, the weights rounded through float8 e4m3, reads incorrect on
the cell's own twin (``test_sharpbench_faults``, every cell); here its
rounding is held to e4m3's.  The SSM state held in bf16 reads incorrect
only at the published widths over thousands of steps: on a twin its
rounding stays under the program's own bf16 rounding, so the test here
holds it to its path alone."""
from __future__ import annotations

import gc
import json
import math
import weakref

import numpy as np
import pytest
import torch

from sharpbench import families, run
from sharpbench.conftest import ROOT, run_tiny, tiny_parts

CELL = "granite-4.0-h-micro.decode"
FAMILY = families.module("mamba_hybrid")
#: the faults' twin: the cell's CPU twin with prompts of 130 to 200 tokens
#: (a bucket of 128 and up to 72 remainder steps) and 24 to 48 new tokens
LONG = {"prompt": {"dist": "uniform", "min": 130, "max": 200},
        "new": {"dist": "uniform", "min": 24, "max": 48}, "max_seq": 256}
#: ... and its heads' A from 1 to 2, the slow end of the published 1 to 16
#: (the step size keeps its published range), so that a head's state
#: carries tens to hundreds of steps
SLOW = {"a_range": [1.0, 2.0]}
#: the block form against the step-by-step recurrence, relative to the
#: largest output: fp32 sums in another order (a block's steps through
#: products of cumulative decays), a few ulps
TOL_BLOCKS = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _cfg():
    return tiny_parts(CELL)[2]


def _run(seed, precision="fp32", seconds=1.5):
    bench, cell, cfg, mix, limits = tiny_parts(CELL)
    cfg = {**cfg, "init": {**cfg["init"], **SLOW}}
    return run.run_cell(ROOT, CELL, seed, seconds, False, device="cpu",
                        precision=precision,
                        parts=(bench, cell, cfg, {**mix, **LONG}, limits))


def test_cell_twin_runs_through_the_harness():
    res = run_tiny(CELL)
    assert res["correct"] and res["attempted"] > 0
    assert set(res["checks"]) == {"out_err"}
    assert res["metrics"]["items_per_s"]["value"] > 0


@pytest.mark.parametrize("S,block", [(37, 8), (64, 16), (5, 128)])
def test_block_form_equals_the_recurrence_step_by_step(S, block):
    """``ssm_blocks`` against ``ssm_steps`` at lengths that are and are not
    multiples of the block, with decays from near 1 to near 0."""
    from sharpbench.families import mamba_hybrid_reference as ref

    gen = torch.Generator().manual_seed(S)
    H, P, N = 4, 8, 16
    xs = torch.randn((S, H, P), generator=gen)
    delta = torch.exp(torch.empty((S, H)).uniform_(-7.0, 0.0, generator=gen))
    A = -torch.empty((H,)).uniform_(1.0, 16.0, generator=gen)
    bh, ch = (torch.randn((S, H, N), generator=gen) for _ in range(2))
    steps = ref.ssm_steps(xs, delta, A, bh, ch)
    blocks = ref.ssm_blocks(xs, delta, A, bh, ch, block)
    assert float((blocks - steps).abs().max()
                 / steps.abs().max()) <= TOL_BLOCKS


def test_reference_equals_the_programs_plain_reference():
    """The family's reference and the program's (``models.plain_hybrid``),
    written apart, give the same logits on the twin's weights."""
    from repro_torch.models import plain_hybrid
    from sharpbench.drivers import lm_closed_loop
    from sharpbench.families import mamba_hybrid_reference as ref

    cfg = _cfg()
    params = FAMILY.draw(cfg, 11, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg["vocab_size"], size=29))
    ours = ref.logits(cfg, params, toks, first=3, block=8)
    theirs = plain_hybrid.forward(lm_closed_loop.model_config(cfg), params,
                                  toks[None])[0, 3:]
    assert float((ours - theirs).abs().max()
                 / theirs.abs().max()) <= TOL_BLOCKS


def test_work_counts_match_the_program_shapes():
    """The drawn weights' bytes equal ``weight_bytes``; one state update's
    bytes equal the program's ``ssm_update`` cost at the same shapes; an
    item's FLOPs are twice the projections' and the unembedding's weights
    plus the SSM's, counted by hand."""
    from repro_torch.kernels.ssm.ops import ssm_update

    cfg = _cfg()
    params = FAMILY.draw(cfg, 3, "cpu")
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            leaves.append(t)

    walk(params)
    assert sum(t.numel() * t.element_size() for t in leaves) == \
        FAMILY.weight_bytes(cfg)
    m = FAMILY.dims(cfg)
    for rows in (1, 3):
        state = torch.zeros((rows, m["H"], m["P"], m["N"]))
        cost = ssm_update.cost(state, torch.zeros((rows, m["conv"])),
                               torch.zeros((rows, m["H"])),
                               *(torch.zeros(m["H"]) for _ in range(3)),
                               heads=m["H"], head_dim=m["P"],
                               groups=m["G"], d_state=m["N"])
        assert cost.bytes == FAMILY.ssm_update_bytes(cfg, rows)
    d, ff, V = m["d"], m["ff"], m["V"]
    kinds = FAMILY.kinds(cfg)
    per_mamba = d * (m["di"] + m["conv"] + m["H"]) + m["di"] * d
    per_attn = d * (m["Hq"] + 2 * m["Hk"]) * m["D"] + m["Hq"] * m["D"] * d
    weights = (sum(per_mamba if k == "mamba2" else per_attn for k in kinds)
               + len(kinds) * 3 * d * ff + V * d)
    ssm = kinds.count("mamba2") * 4 * m["H"] * m["P"] * m["N"]
    assert FAMILY.flops_per_item(cfg) == 2 * weights + ssm


def test_full_size_counts():
    """At the published widths: 3.19B weights, 36 Mamba-2 layers, and a
    32-row state update of 134 MB (the kernel's bytes bound, 40 us)."""
    cfg = json.loads((ROOT / "sharpbench" / "configs"
                      / "granite-4.0-h-micro.json").read_text())
    assert FAMILY.mamba_layers(cfg) == 36
    n = FAMILY.weight_bytes(cfg) / 2
    assert 3.18e9 < n < 3.20e9
    assert math.isclose(FAMILY.ssm_update_bytes(cfg, 32) / 1e6, 135.3,
                        abs_tol=0.1)


def _plain_with(fn):
    """A stand-in for the kernel's plain version (what the CPU runs)."""
    from repro_torch.kernels.ssm import ops

    orig = ops.ssm_update_plain

    def wrapped(state, xbc, dt, dt_bias, A, D, **dims):
        return fn(orig, state, xbc, dt, dt_bias, A, D, **dims)
    return wrapped


def _no_decay(orig, state, xbc, dt, dt_bias, A, D, **dims):
    return orig(state, xbc, dt, dt_bias, torch.zeros_like(A), D, **dims)


def _head_dropped(orig, state, xbc, dt, dt_bias, A, D, **dims):
    """The head with the longest memory (its decay exp(delta A) nearest 1,
    over the batch) carries no state into the next step."""
    y = orig(state, xbc, dt, dt_bias, A, D, **dims)
    rate = (torch.nn.functional.softplus(dt.float() + dt_bias.float())
            * A.float()).mean(0)
    state[:, int(rate.argmax())] = 0
    return y


def _tap_lost(orig):
    def conv(params, xbc, conv_state):
        w = params["conv_w"].clone()
        w[0] = 0
        return orig({**params, "conv_w": w}, xbc, conv_state)
    return conv


FAULTS = ("no_decay", "head_dropped", "tap_lost", "no_residual_multiplier")


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_reads_incorrect(fault, monkeypatch):
    from repro_torch.kernels.ssm import ops
    from repro_torch.models import transformer
    from repro_torch.models.layers import mamba2

    if fault == "no_decay":
        monkeypatch.setattr(ops, "ssm_update_plain", _plain_with(_no_decay))
    elif fault == "head_dropped":
        monkeypatch.setattr(ops, "ssm_update_plain",
                            _plain_with(_head_dropped))
    elif fault == "tap_lost":
        monkeypatch.setattr(mamba2, "causal_conv",
                            _tap_lost(mamba2.causal_conv))
    else:
        monkeypatch.setattr(transformer, "_residual",
                            lambda cfg, x, o: x + o)
    for seed in (2**40 + 1, 2**41 + 5):
        res = _run(seed)
        assert not res["correct"], (fault, res["checks"])


def test_the_program_reads_correct_on_the_long_twin():
    for seed in (2**40 + 1, 2**41 + 5):
        res = _run(seed)
        assert res["correct"], res["checks"]


def _node(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_lower_precision_paths():
    """The configuration's control (``fp8_weights``) rounds every
    projection and the tied table through float8 e4m3 and leaves the other
    weights as they are; the SSM state stays fp32, and no other precision
    is taken."""
    from repro_torch.models.layers import mamba2
    from sharpbench.drivers.lm_closed_loop import (FP8_MAX, fp8_weights,
                                                   model_config)

    cfg = _cfg()
    assert cfg["control"] == "fp8_weights"
    params = FAMILY.draw(cfg, 5, "cpu")
    served = fp8_weights(cfg, params)
    for path in [p for p, _ in FAMILY.matrices(cfg)] + [("head", "table")]:
        w, q = _node(params, path).float(), _node(served, path)
        assert q.dtype == _node(params, path).dtype
        scale = w.abs().amax(1 if path[-1] == "table" else 0,
                             keepdim=True) / FP8_MAX
        # e4m3 keeps 3 bits after the leading one (half a step: 2^-4 of
        # the value), down to subnormals 2^-9 of the scale apart; the bf16
        # copy rounds once more (2^-9 of the value)
        bound = w.abs() * (2.0**-4 + 2.0**-8) + scale * 2.0**-10
        err = (q.float() - w).abs()
        assert bool((err <= bound * (1 + 1e-6)).all()) and err.max() > 0
    for layer, mine in zip(params["layers"], served["layers"]):
        for key in ("norm1", "norm2"):
            assert mine[key] is layer[key]
        if "mamba" in layer:
            for key in ("conv_w", "A_log", "dt_bias", "D", "norm"):
                assert mine["mamba"][key] is layer["mamba"][key]
    state = mamba2.init_cache(model_config(cfg, "fp8_weights"), 1)["ssm"]
    assert state.dtype == torch.float32
    with pytest.raises(ValueError, match="precision"):
        model_config(cfg, "bf16_state")


def test_driver_frees_the_program_after_a_run(monkeypatch):
    """Once ``run_cell`` returns, nothing holds the driver, its engine or
    its weights: ``control.py`` runs a cell many times in one process, and
    ``run_cell`` freezes what set-up made (``gc.freeze``), so a cycle
    through the engine would keep every run's weights and caches."""
    seen = []
    load = run.load_module

    def spy(path):
        mod = load(path)
        if hasattr(mod, "Driver"):
            base = mod.Driver

            class Driver(base):
                def __init__(self, *args, **kwargs):
                    super().__init__(*args, **kwargs)
                    seen.extend(weakref.ref(o) for o in (
                        self, self.engine, self.params["head"]["table"]))
            mod.Driver = Driver
        return mod

    monkeypatch.setattr(run, "load_module", spy)
    try:
        run_tiny(CELL, seconds=0.2)
        alive = [ref() is not None for ref in seen]
    finally:
        gc.unfreeze()
    assert alive == [False] * 3
