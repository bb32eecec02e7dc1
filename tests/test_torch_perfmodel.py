"""The port's paper-figure cycle model against the JAX package's.

``repro_torch.core.perfmodel`` is a copy of ``repro.core.perfmodel``:
plain Python arithmetic over the paper's ASIC, with no tensors and no
device.  Each paper function's output must equal the reference's exactly
(``==``, every key and value), and the reference's trend tests
(``tests/core/test_perfmodel.py``: each names the paper artifact it
gates) run here on the port.
"""
import statistics
import types

import pytest

from repro.core import perfmodel as ref

from repro_torch.configs.sharp_lstm import MAC_BUDGETS, SWEEP_HIDDEN_DIMS
from repro_torch.core import perfmodel as pm

#: (function name, positional arguments) of every paper generator
PAPER_CALLS = [
    ("fig9_kwidth_sweep", ()),
    *[("fig9_best_k", (m,)) for m in MAC_BUDGETS],
    ("fig10_padding_speedup", ()),
    ("fig11_schedule_speedups", ()),
    ("fig12_latency_utilization", ()),
    ("table4_vs_brainwave", ()),
    ("table6_vs_epur", ()),
    ("fig14_energy", ()),
    ("fit_brainwave", ()),
    ("gflops_per_watt", ()),
]


@pytest.mark.parametrize("name,args", PAPER_CALLS,
                         ids=[f"{n}{''.join(map(str, a))}"
                              for n, a in PAPER_CALLS])
def test_paper_function_equals_reference(name, args):
    got = getattr(pm, name)(*args)
    want = getattr(ref, name)(*args)
    assert type(got) is type(want)
    assert got == want


def test_public_names_match_reference():
    """Every public name the reference defines (its own functions,
    classes and constants; not what it imports from typing or
    dataclasses) exists in the port."""
    def own(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_")
                and not isinstance(v, types.ModuleType)
                and getattr(v, "__module__", None) not in ("typing",
                                                           "dataclasses")}
    assert own(ref) - set(vars(pm)) == set()


# ---------------------------------------------------------------------------
# the reference's trend tests, on the port
# ---------------------------------------------------------------------------


def test_fig11_unfolded_always_best():
    sp = pm.fig11_schedule_speedups()
    for m in MAC_BUDGETS:
        for h in SWEEP_HIDDEN_DIMS:
            assert sp[(m, h, "unfolded")] >= sp[(m, h, "intergate")] - 1e-9
            assert sp[(m, h, "intergate")] >= sp[(m, h, "sequential")] - 1e-9


def test_fig11_benefit_diminishes_with_dim_and_fewer_macs():
    """§8: 'the benefit diminishes by increasing the LSTM dimension or
    reducing the number of MACs'."""
    sp = pm.fig11_schedule_speedups()
    for m in MAC_BUDGETS:
        assert sp[(m, 256, "unfolded")] >= sp[(m, 2048, "unfolded")]
    for h in SWEEP_HIDDEN_DIMS:
        assert sp[(65536, h, "unfolded")] >= sp[(1024, h, "unfolded")]


def test_fig10_padding_claims():
    """Fig. 10: <=~1.22x, >=1 everywhere, exactly 1.0 at hidden=512."""
    pad = pm.fig10_padding_speedup()
    vals = list(pad.values())
    assert max(vals) <= 1.30
    assert max(vals) >= 1.10  # 'up to 1.22x' — material gain exists
    assert all(v >= 1.0 - 1e-9 for v in vals)
    for m in MAC_BUDGETS:
        assert pad[(m, 512)] == pytest.approx(1.0)


def test_fig9_no_single_best_k():
    """Fig. 9: 'there is not just one best configuration'."""
    for m in (4096, 16384, 65536):
        best = pm.fig9_best_k(m)
        assert len(set(best.values())) > 1, (m, best)


def test_fig12_utilization_trends():
    """Fig. 12: SHARP util decreases 1K->64K but stays >= 50%-ish; SHARP
    beats E-PUR everywhere; the E-PUR gap widens with MACs (1.3x-2x)."""
    f12 = pm.fig12_latency_utilization()

    def avg(m, k):
        return statistics.mean(f12[(m, h)][k] for h in SWEEP_HIDDEN_DIMS)

    prev = 1.1
    for m in MAC_BUDGETS:
        u = avg(m, "utilization")
        assert u <= prev + 1e-9
        prev = u
        assert u >= 0.45
        assert u >= avg(m, "epur_utilization")
    assert (avg(65536, "utilization") / avg(65536, "epur_utilization")
            >= 1.3)


def test_fig12_latency_scales_with_macs():
    """§8: 'linearly reduces the execution time (AVG) by increasing MACs'."""
    f12 = pm.fig12_latency_utilization()

    def avg(m):
        return statistics.mean(f12[(m, h)]["latency_us"]
                               for h in SWEEP_HIDDEN_DIMS)

    lat = [avg(m) for m in MAC_BUDGETS]
    assert lat[0] > lat[1] > lat[2] > lat[3]
    assert lat[0] / lat[3] > 20  # near-linear over the 64x resource range


def test_table6_epur_trends():
    """Table 6: speedup in [1.0, ~3.3], growing with the MAC budget."""
    t6 = pm.table6_vs_epur()
    for name in ("EESEN", "GMAT", "BYSDNE", "RLDRADSPR"):
        row = [t6[(name, m)] for m in MAC_BUDGETS]
        assert all(r >= 0.99 for r in row)
        assert row[-1] > row[0]          # scales with resources
        assert 1.2 <= row[-1] <= 3.5     # paper: 1.66..2.3 at 64K


def test_table4_brainwave():
    """Table 4: >1.65x everywhere, larger for smaller dims; fitted model
    within 35% relative error of every paper entry."""
    t4 = pm.table4_vs_brainwave()
    paper = pm.TABLE4_PAPER
    vals = [t4[k] for k in sorted(t4)]
    assert all(v > 1.5 for v in vals)
    assert t4[(256, 150)] > t4[(1536, 50)]  # adaptability claim
    for k, v in t4.items():
        assert abs(v - paper[k]) / paper[k] < 0.35, (k, v, paper[k])


def test_energy_and_gflops_per_watt():
    """Fig. 14 energy reduction grows with MACs; §10: ~0.32 TFLOPS/W at the
    paper's 50% utilization point."""
    e = pm.fig14_energy()
    avg_red = {m: statistics.mean(e[(m, h)]["reduction"]
                                  for h in SWEEP_HIDDEN_DIMS)
               for m in MAC_BUDGETS}
    assert avg_red[65536] > avg_red[1024]
    assert avg_red[65536] > 0.15
    # at the paper's stated 50% avg utilization the arithmetic is fixed:
    gfw_at_half = pm.PEAK_TFLOPS[65536] * 0.5 / pm.POWER_W[65536] / 1e9
    assert abs(gfw_at_half - 321) / 321 < 0.05
    # the model's own avg utilization lands in the same regime
    assert 250 <= pm.gflops_per_watt() <= 550
