"""One training step of the port (``launch.steps.make_train_step``) against
the JAX package's for every architecture at its reduced config, and the
port's training driver end to end (``launch.train``, ``--device cpu``).

The same ``convert.from_jax``'d parameters and numpy batch go through
both steps (AdamW at lr 1e-2 without warmup, so that one step moves every
parameter visibly).  Tolerances, fp32:
  * loss: 2e-6 relative (read ≤ 1.7e-7); grad_norm 5e-6 relative;
  * m and v (the gradient, through AdamW's moments): each leaf within
    2e-5 of its largest |value| (read ≤ 5.8e-6);
  * params: one AdamW step moves a parameter by lr·m̂/(sqrt(v̂)+eps) ≈
    lr·sign(g) (+ decay), which is ill-conditioned where g is near 0.  So
    where |m| > 1e-3 x the leaf's largest |m| the new parameters agree
    within 1e-4·lr (read ≤ 1.2e-5·lr), and elsewhere within 0.1·lr (read
    ≤ 0.064·lr);
  * count: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.optim import AdamWConfig as JAdamW

from repro_torch import configs
from repro_torch import tree as tr
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.optim import AdamWConfig
from tests.test_torch_train import ARCHS, arch_batch, jax_model, port_params

LR = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf_pairs(jtree, ttree):
    jl = [np.asarray(x, np.float32) for x in jax.tree.leaves(jtree)]
    tl = [x.float().numpy() for x in tr.leaves(ttree)]
    assert len(jl) == len(tl)
    return zip(jl, tl)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch):
    jcfg, jparams = jax_model(arch)
    batch = arch_batch(jcfg)
    js = jsteps.TrainSettings(adamw=JAdamW(lr=LR, warmup_steps=0))
    jp, jo, jm = jax.jit(jsteps.make_train_step(jcfg, js))(
        jparams, jsteps.init_opt_state(jcfg, jparams, js),
        {k: jnp.asarray(v) for k, v in batch.items()})

    cfg = configs.get_reduced(arch)
    s = steps.TrainSettings(adamw=AdamWConfig(lr=LR, warmup_steps=0))
    params = port_params(jparams)
    p, o, m = steps.make_train_step(cfg, s)(
        params, steps.init_opt_state(cfg, params, s),
        {k: torch.from_numpy(v) for k, v in batch.items()})

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=2e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=5e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(o["adam"]["count"]) == int(jo["adam"]["count"]) == 1
    for key in ("m", "v"):
        for want, got in _leaf_pairs(jo["adam"][key], o["adam"][key]):
            assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    moved = 0.0
    for (want, got), (mom, _) in zip(_leaf_pairs(jp, p),
                                     _leaf_pairs(jo["adam"]["m"],
                                                 o["adam"]["m"])):
        well = np.abs(mom) > 1e-3 * np.abs(mom).max()
        d = np.abs(got - want)
        assert (d[well] <= 1e-4 * LR).all()
        assert (d <= 0.1 * LR).all()
    for a, b in _leaf_pairs(jparams, p):
        moved = max(moved, float(np.abs(a - b).max()))
    assert moved > 0


def test_train_driver_end_to_end(tmp_path):
    """The reference's driver test on the port: xlstm-125m's loss falls
    over 25 steps on the markov stream."""
    loop = train_mod.main([
        "--arch", "xlstm-125m", "--reduced", "--steps", "25", "--batch", "8",
        "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
        "--device", "cpu"])
    hist = loop.metrics_history
    assert len(hist) == 25
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first


def test_train_driver_with_fault_and_compression(tmp_path):
    loop = train_mod.main([
        "--arch", "starcoder2-3b", "--reduced", "--steps", "14", "--batch",
        "4", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
        "--fail-at", "8", "--compression", "int8", "--device", "cpu"])
    assert loop.restarts == 1
    assert [h["step"] for h in loop.metrics_history][-6:] == list(
        range(8, 14))


def test_train_driver_refuses_a_model_mesh(tmp_path, monkeypatch):
    """In one process (no torchrun) a model axis has no ranks to span:
    the driver names the world size it needs."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="world size 1.*torchrun"):
        train_mod.main(["--reduced", "--mesh-model", "2", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path)])
