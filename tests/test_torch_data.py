"""The port's synthetic data pipeline (repro_torch.data, a numpy copy of
repro.data): its batches equal the reference's bit for bit for both
sources, with embeddings, and per host; plus the reference's tests
(tests/test_data.py) on the port."""
import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticPipeline as JPipeline

from repro_torch.data import DataConfig, SyntheticPipeline

CASES = [dict(vocab_size=64, seq_len=16, global_batch=4, seed=7),
         dict(vocab_size=64, seq_len=16, global_batch=4, seed=7,
              source="random"),
         dict(vocab_size=32, seq_len=8, global_batch=2, embed_dim=16),
         dict(vocab_size=32, seq_len=8, global_batch=2, embed_dim=16,
              source="random"),
         dict(vocab_size=64, seq_len=8, global_batch=8, seed=1,
              num_hosts=2, host_id=1)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_batches_equal_the_reference(case):
    kw = CASES[case]
    port = SyntheticPipeline(DataConfig(**kw))
    ref = JPipeline(JDataConfig(**kw))
    for step in (0, 3, 13):
        a, b = port.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_iteration_is_batch_at():
    cfg = DataConfig(vocab_size=16, seq_len=4, global_batch=2, seed=3)
    it = iter(SyntheticPipeline(cfg))
    for step in range(3):
        np.testing.assert_array_equal(
            next(it)["tokens"], SyntheticPipeline(cfg).batch_at(step)["tokens"])


def test_determinism():
    cfg = DataConfig(vocab_size=64, seq_len=16, global_batch=4, seed=7)
    a = SyntheticPipeline(cfg).batch_at(13)
    b = SyntheticPipeline(cfg).batch_at(13)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticPipeline(cfg).batch_at(14)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_host_sharding_disjoint_and_deterministic():
    h0 = DataConfig(vocab_size=64, seq_len=8, global_batch=8, seed=1,
                    num_hosts=2, host_id=0)
    h1 = DataConfig(vocab_size=64, seq_len=8, global_batch=8, seed=1,
                    num_hosts=2, host_id=1)
    b0 = SyntheticPipeline(h0).batch_at(3)["tokens"]
    b1 = SyntheticPipeline(h1).batch_at(3)["tokens"]
    assert b0.shape == (4, 8) and b1.shape == (4, 8)
    assert not np.array_equal(b0, b1)


def test_markov_has_learnable_structure():
    cfg = DataConfig(vocab_size=8, seq_len=256, global_batch=8, seed=3)
    pipe = SyntheticPipeline(cfg)
    counts = np.zeros((8, 8))
    for step in range(4):
        for row in pipe.batch_at(step)["tokens"]:
            np.add.at(counts, (row[:-1], row[1:]), 1)
    emp = counts / np.maximum(counts.sum(-1, keepdims=True), 1)
    assert np.abs(emp - pipe._trans).max() < 0.15
    assert emp.max() > 2.0 / 8


def test_tokens_in_range():
    cfg = DataConfig(vocab_size=11, seq_len=64, global_batch=4,
                     source="markov")
    t = SyntheticPipeline(cfg).batch_at(0)["tokens"]
    assert t.min() >= 0 and t.max() < 11
