"""The port's checkpointer (repro_torch.checkpoint): the reference's six
tests (tests/test_checkpoint.py) on the port, and the two packages'
checkpoints restored by each other (the same layout, leaf order and bf16
records), bit for bit."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer

from repro_torch import tree as tr
from repro_torch.checkpoint import Checkpointer


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "b": torch.zeros((8,), dtype=torch.bfloat16)},
            "opt": {"count": torch.tensor(3, dtype=torch.int32)}}


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(10, tree, blocking=True)
    assert ck.latest_step() == 10
    out = ck.restore(10, tr.tree_map(torch.zeros_like, tree))
    for a, b in zip(tr.leaves(tree), tr.leaves(out)):
        assert torch.equal(a, b)
        assert a.dtype == b.dtype


def test_async_save_commits(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(), blocking=False)
    ck.wait()
    assert ck.latest_step() == 1
    assert os.path.exists(tmp_path / "step_1" / ".complete")


def test_async_save_snapshots_at_the_call(tmp_path):
    """The leaves are copied when ``save`` is called: the train step
    updates the live tensors in place right after."""
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    want = tree["params"]["w"].clone()
    ck.save(1, tree, blocking=False)
    tree["params"]["w"].add_(1.0)
    ck.wait()
    out = ck.restore(1, _tree(1))
    assert torch.equal(out["params"]["w"], want)


def test_incomplete_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(), blocking=True)
    os.makedirs(tmp_path / "step_2")
    assert ck.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        ck.restore(2, _tree())


def test_gc_keeps_newest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(), blocking=True)
    names = sorted(os.listdir(tmp_path))
    assert "step_3" in names and "step_4" in names
    assert "step_1" not in names and "step_2" not in names


def test_structure_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(), blocking=True)
    with pytest.raises(AssertionError):
        ck.restore(1, {"just": torch.zeros(3)})


def test_restore_respects_dtype(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    ck.save(5, tree, blocking=True)
    out = ck.restore(5, tree)
    assert out["w"].dtype == torch.bfloat16


def _mixed(seed):
    """A tree with fp32, bf16 and int32 leaves and a list, as numpy."""
    rng = np.random.default_rng(seed)
    return {"params": {"layers": [{"w": rng.standard_normal((3, 4)).astype(
                           np.float32)},
                                  {"w": rng.standard_normal((2, 2)).astype(
                                      np.float32)}],
                       "emb": rng.standard_normal((5, 3)).astype(np.float32)},
            "opt": {"count": np.int32(7)}}


def _jax_tree(t):
    out = jax.tree.map(jnp.asarray, t)
    out["params"]["emb"] = out["params"]["emb"].astype(jnp.bfloat16)
    return out


def _torch_tree(t):
    out = tr.tree_map(lambda a: torch.from_numpy(np.array(a)), t)
    out["params"]["emb"] = out["params"]["emb"].to(torch.bfloat16)
    return out


def test_port_restores_a_jax_checkpoint(tmp_path):
    jtree = _jax_tree(_mixed(0))
    JCheckpointer(str(tmp_path)).save(4, jtree, blocking=True)
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 4
    out = ck.restore(4, _torch_tree(_mixed(1)))
    assert out["params"]["emb"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(jtree), tr.leaves(out)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


def test_jax_restores_a_port_checkpoint(tmp_path):
    ttree = _torch_tree(_mixed(2))
    Checkpointer(str(tmp_path)).save(6, ttree, blocking=True)
    ck = JCheckpointer(str(tmp_path))
    assert ck.latest_step() == 6
    out = ck.restore(6, _jax_tree(_mixed(3)))
    assert out["params"]["emb"].dtype == jnp.bfloat16
    for a, b in zip(tr.leaves(ttree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(b, np.float32),
                                      a.float().numpy())
    # the bf16 file is the one np.save of the reference's leaf writes
    names = jax.tree_util.tree_flatten_with_path(out)[0]
    i = [n for n, _ in enumerate(names)
         if "emb" in str(names[n][0])][0]
    ref = tmp_path / "ref.npy"
    np.save(ref, np.asarray(out["params"]["emb"]))
    assert (tmp_path / "step_6" / f"arr_{i}.npy").read_bytes() == \
        ref.read_bytes()
