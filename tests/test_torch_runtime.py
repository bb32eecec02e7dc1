"""The port's fault-tolerant training loop (repro_torch.runtime.TrainLoop):
the reference's tests (tests/test_runtime.py) on the port — exact
recovery from a checkpoint, giving up after max restarts, no checkpoint
yet, the straggler watchdog, the metrics history — plus a real train
step of a reduced model recovered bit for bit."""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import tree as tr
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.optim import CompressionConfig
from repro_torch.runtime import FTConfig, StragglerWatchdog, TrainLoop


def _toy_setup(tmp_path, ckpt_every=5):
    def train_step(params, opt, batch):
        new_p = {"w": params["w"] + batch.sum()}
        new_o = {"count": opt["count"] + 1}
        return new_p, new_o, {"loss": -params["w"]}

    def batch_fn(step):
        return torch.tensor([step], dtype=torch.float32)

    cfg = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every,
                   max_restarts=3)
    return train_step, batch_fn, cfg


def _start():
    return ({"w": torch.zeros(())},
            {"count": torch.zeros((), dtype=torch.int32)})


def test_recovery_produces_exact_result(tmp_path):
    train_step, batch_fn, cfg = _toy_setup(tmp_path)
    loop = TrainLoop(train_step, batch_fn, cfg)
    loop.failure_at_steps = {12}
    p, o, step = loop.run(*_start(), 0, 20)
    assert loop.restarts == 1
    assert step == 20
    assert float(p["w"]) == sum(range(20))
    assert int(o["count"]) == 20


def test_gives_up_after_max_restarts(tmp_path):
    train_step, batch_fn, cfg = _toy_setup(tmp_path)
    loop = TrainLoop(train_step, batch_fn, cfg)
    loop.failure_at_steps = {6, 7, 8, 9}
    with pytest.raises(RuntimeError):
        loop.run(*_start(), 0, 20)


def test_no_checkpoint_yet_raises_cleanly(tmp_path):
    train_step, batch_fn, cfg = _toy_setup(tmp_path, ckpt_every=100)
    loop = TrainLoop(train_step, batch_fn, cfg)
    loop.failure_at_steps = {2}
    with pytest.raises(RuntimeError, match="no checkpoint"):
        loop.run(*_start(), 0, 10)


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=3.0, alpha=0.5)
    for s in range(10):
        assert not wd.observe(s, 0.1)
    assert wd.observe(10, 1.0)
    assert wd.flagged == [10]
    assert not wd.observe(11, 0.12)


def test_metrics_history_records_all_steps(tmp_path):
    train_step, batch_fn, cfg = _toy_setup(tmp_path)
    loop = TrainLoop(train_step, batch_fn, cfg)
    loop.run(*_start(), 0, 7)
    assert [m["step"] for m in loop.metrics_history] == list(range(7))


def _model_run(tmp_path, fail_at):
    """recurrentgemma-2b reduced, 9 steps of make_train_step with int8
    compression through TrainLoop (checkpoints every 3), from one seed."""
    torch.set_num_threads(1)
    cfg = configs.get_reduced("recurrentgemma-2b")
    s = steps.TrainSettings(compression=CompressionConfig(scheme="int8"))
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    data = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=12, global_batch=2))
    loop = TrainLoop(steps.make_train_step(cfg, s),
                     lambda i: {k: torch.from_numpy(v)
                                for k, v in data.batch_at(i).items()},
                     FTConfig(ckpt_dir=str(tmp_path), ckpt_every=3))
    if fail_at is not None:
        loop.failure_at_steps.add(fail_at)
    p, o, step = loop.run(params, steps.init_opt_state(cfg, params, s), 0, 9)
    return loop, p, o


def test_model_recovery_is_exact(tmp_path):
    """A fault at step 7 restores step 6 and replays: the final params,
    moments, error feedback and count equal the fault-free run's bit for
    bit."""
    clean, p0, o0 = _model_run(tmp_path / "a", None)
    faulted, p1, o1 = _model_run(tmp_path / "b", 7)
    assert (clean.restarts, faulted.restarts) == (0, 1)
    for a, b in zip(tr.leaves((p0, o0)), tr.leaves((p1, o1))):
        assert torch.equal(a, b)
    assert int(o1["adam"]["count"]) == 9
    assert np.isfinite([h["loss"] for h in faulted.metrics_history]).all()
