"""The port's sharding (``repro_torch.sharding``, the mesh helpers of
``models.layers.common``, ``launch.mesh``, ``core.unfolded``'s TP LSTM,
the elastic restore) against the reference's.

* Specs, exactly: ``param_specs`` for all ten archs at full width on five
  meshes (the port's params on the ``meta`` device, the reference's from
  ``jax.eval_shape``), ``cache_specs`` at decode_32k, ``batch_spec`` and
  ``logical_spec``; the reference reads a duck-typed mesh that carries its
  ``axis_names`` and ``devices.shape`` in-process.
* Sharded runs: the reference's own cases (``tests/test_sharding.py``),
  each on 8 gloo ranks of the CPU meeting at a ``FileStore`` under
  ``tmp_path`` (one thread a rank), held against the reference's
  single-device result at its tolerance and against the port's own run
  with no mesh.
"""
import functools
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from tests.conftest import REPO_ROOT, SRC
from repro_torch import tree as tr
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch.steps import batch_struct
from repro_torch.models import transformer as ptf
from repro_torch.models.layers import common as pcommon
from repro_torch.sharding import partition as pp

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro.models.layers import common as jcommon
from repro.sharding import partition as jpart

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")),
          ((2, 4), ("data", "model")),
          ((8, 1), ("data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
FLAGS = [dict(fsdp=True, multi_pod_fsdp=True),
         dict(fsdp=True, multi_pod_fsdp=False),
         dict(fsdp=False)]
FLAG_IDS = ["fsdp", "fsdp-one-pod", "tp-only"]
ARCHS = list_archs()


def _duck(shape, names):
    """The reference's view of a mesh: its axis names and device grid."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=np.int8))


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference params, port params on meta, reference cache, port cache
    on meta) at full width; the cache at decode_32k."""
    cfg = get_config(arch)
    jcfg = jget_config(arch)
    shape = SHAPES["decode_32k"]
    jparams = jax.eval_shape(lambda: jtf.init_params(
        jcfg, jax.random.PRNGKey(0)))
    pparams = ptf.init_params(cfg, torch.Generator().manual_seed(0),
                              device="meta")
    jcache = jax.eval_shape(lambda: jtf.init_cache(
        jcfg, shape.global_batch, shape.seq_len))
    pcache = ptf.init_cache(cfg, shape.global_batch, shape.seq_len,
                            device="meta")
    return jparams, pparams, jcache, pcache


def _ref_flat(specs):
    """[(path names, spec tuple)] of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return [(jpart._path_names(p), tuple(s)) for p, s in flat]


def _port_flat(specs):
    return [(tuple(str(k) for k in p), tuple(s))
            for p, s in tr.leaves_with_path(specs)]


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, flags):
    jparams, pparams, _, _ = _shapes(arch)
    shape, names = mesh
    ref = _ref_flat(jpart.param_specs(jparams, _duck(shape, names), **flags))
    got = _port_flat(pp.param_specs(pparams, pp.MeshShape(shape, names),
                                    **flags))
    assert got == ref


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh):
    _, _, jcache, pcache = _shapes(arch)
    shape, names = mesh
    ref = _ref_flat(jpart.cache_specs(jcache, _duck(shape, names)))
    got = _port_flat(pp.cache_specs(pcache, pp.MeshShape(shape, names)))
    assert got == ref


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_spec_equals_the_reference(arch, mesh):
    cfg = get_config(arch)
    shape, names = mesh
    for sh in SHAPES.values():
        batch = batch_struct(cfg, sh.global_batch, sh.seq_len)
        jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.int32)
                  for k, v in batch.items()}
        ref = _ref_flat(jpart.batch_spec(_duck(shape, names), jbatch))
        got = _port_flat(pp.batch_spec(pp.MeshShape(shape, names), batch))
        assert got == ref, sh.name


#: (logical names, a shape) the model annotates activations with
LOGICAL = [(("batch", "seq", "embed"), (256, 4096, 3072)),
           (("batch", "seq", "ff"), (8, 16, 128)),
           (("batch", "seq", "qdim"), (6, 16, 24 * 128)),
           (("experts", None, "ff_fsdp"), (64, 8, 1024)),
           (("batch", "cache_seq", None), (128, 32768, 256)),
           (("batch", None, "state"), (1, 4, 2560)),
           (("batch", "seq", "vocab"), (4, 1, 49152)),
           ((None, "heads", "kv_heads"), (3, 5, 7))]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_logical_spec_equals_the_reference(mesh):
    shape, names = mesh
    for logical, dims in LOGICAL:
        for sized in (None, dims):
            with jcommon.sharding_ctx(_duck(shape, names)):
                ref = tuple(jcommon.logical_spec(logical, sized))
            with pcommon.sharding_ctx(pp.MeshShape(shape, names)):
                got = tuple(pcommon.logical_spec(logical, sized))
            assert got == ref, (logical, sized)
    assert pcommon.logical_spec(("batch",)) is None  # no context: no spec
    assert pcommon.DEFAULT_RULES == jcommon.DEFAULT_RULES


def test_placements_follow_the_spec_major_axis_first():
    from torch.distributed.tensor import Replicate, Shard

    mesh = pp.MeshShape((2, 2, 4), ("pod", "data", "model"))
    assert pp.placements(pp.P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert pp.placements(pp.P(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        pp.placements(pp.P(("data", "pod")), mesh)
    assert pp.P("a", None) == ("a", None) and len(pp.P()) == 0


def test_the_shardings_name_their_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = pp.MeshShape((4, 2), ("data", "model"))
    params = {"w_q": torch.empty((4096, 4096), device="meta"),
              "norm": torch.empty((4096,), device="meta")}
    sh = pp.param_shardings(params, mesh)
    assert sh["w_q"].placements == (Shard(0), Shard(1))
    assert sh["norm"].placements == (Replicate(), Replicate())


def test_shard_act_and_on_mesh_are_no_ops_without_a_device_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert pcommon.shard_act(x, "batch", "ff") is x
    assert pcommon.on_mesh(x) is x
    with pcommon.sharding_ctx(pp.MeshShape((2, 4), ("data", "model"))):
        assert pcommon.current_mesh() is not None
        assert pcommon.shard_act(x, "batch", "ff") is x
        assert pcommon.on_mesh(x) is x
    assert pcommon.current_mesh() is None


def test_hardware_config_is_the_h100s():
    from repro_torch.configs import H100, supports_shape
    from repro.configs import SHAPES as JSHAPES, supports_shape as jsupp

    assert H100.peak_flops_bf16 == 989e12 and H100.hbm_bw == 3.35e12
    assert H100.hbm_bytes == 80 * 10**9 and H100.smem_bytes == 227 * 1024
    from repro_torch.kernels.common import SEQ_MAX_SMEM
    assert SEQ_MAX_SMEM == H100.smem_bytes
    assert {k: (v.seq_len, v.global_batch, v.mode)
            for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.mode) for k, v in JSHAPES.items()}
    for arch in ARCHS:
        for name in SHAPES:
            assert supports_shape(get_config(arch), SHAPES[name]) == jsupp(
                jget_config(arch), JSHAPES[name])


def test_mesh_helpers_need_a_process_group():
    from repro_torch.launch import mesh

    if torch.distributed.is_initialized():
        pytest.skip("a process group is already formed in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_mesh((1, 1), ("data", "model"), "cpu")


# ---------------------------------------------------------------------------
# sharded runs on gloo ranks of the CPU
# ---------------------------------------------------------------------------

_RANK_PRELUDE = """
import os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"],
                        WORLD), rank=RANK, world_size=WORLD)
DATA = os.environ["DATA"]
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers.common import sharding_ctx
from repro_torch.sharding.partition import (NamedSharding, P, distribute,
    param_shardings, cache_shardings, batch_spec)
from repro_torch import tree as tr
def whole(t):
    return tr.tree_map(lambda x: x.full_tensor()
                       if hasattr(x, "full_tensor") else x, t)
def save(obj):
    if RANK == 0:
        torch.save(obj, os.path.join(DATA, "out.pt"))
"""


def _ranks(tmp_path, n, body, inputs):
    """Run ``body`` on ``n`` gloo ranks (after ``_RANK_PRELUDE``) with
    ``inputs`` at ``DATA/in.pt``; returns what rank 0 saved."""
    data = tmp_path / "data"
    data.mkdir()
    torch.save(inputs, data / "in.pt")
    script = tmp_path / "rank.py"
    script.write_text(_RANK_PRELUDE + textwrap.dedent(body))
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(r), WORLD=str(n),
                   STORE=str(tmp_path / "store"), DATA=str(data),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return torch.load(data / "out.pt")


def _to_torch(tree):
    from repro_torch.convert import from_jax

    return from_jax(tree)


def test_sharded_train_step_matches_single_device(tmp_path):
    """The reference's case: the reduced starcoder2-3b train step on a
    4 data x 2 model mesh, loss within rtol 2e-4 and params within atol
    5e-4 of the reference's single device; and of the port's own step with
    no mesh.

    Those two checks cannot see the gradient: the first step's lr is
    lr_at(0) = 3e-6, so a step moves a param by ~3e-6, far inside 5e-4.
    So the gradient is held through AdamW's moments (after one step
    m = 0.1 g' and v = 0.05 g'², g' the gradient clipped to global norm
    1): each leaf of m and v within 2e-5 of its largest |value|
    (``test_torch_train_step``'s bound) of the reference's and of the
    port's no-mesh step; and the unclipped grad norm within rtol 2e-5,
    which a gradient scaled as a whole (summed over data twice) moves
    where clipping hides it from m.  A gradient never all-reduced over
    data differs leaf by leaf in m.  And the step did move the params: the largest
    change of a leaf is lr-sized (0.5-2 x lr, the no-mesh step's too)."""
    from repro.configs import get_reduced as jred
    from repro.launch.steps import (TrainSettings as JTS,
                                    init_opt_state as jinit,
                                    make_train_step as jmake)
    from repro_torch.configs import get_reduced
    from repro_torch.launch.steps import init_opt_state, make_train_step

    jcfg = jred("starcoder2-3b")
    key = jax.random.PRNGKey(0)
    tokens = jax.random.randint(key, (8, 16), 0, jcfg.vocab_size)
    jparams = jtf.init_params(jcfg, key)
    p_ref, o_ref, m_ref = jax.jit(jmake(jcfg, JTS()))(
        jparams, jinit(jcfg, jparams, JTS()), {"tokens": tokens})
    cfg = get_reduced("starcoder2-3b")
    params = _to_torch(jparams)
    batch = {"tokens": torch.from_numpy(np.asarray(tokens))}
    clone = lambda t: tr.tree_map(lambda x: x.clone(), t)  # noqa: E731
    p_own, o_own, m_own = make_train_step(cfg)(
        clone(params), init_opt_state(cfg, params), batch)
    out = _ranks(tmp_path, 8, """
        from repro_torch.configs import get_reduced
        from repro_torch.launch.steps import init_opt_state, make_train_step
        params, batch = torch.load(os.path.join(DATA, "in.pt"))
        cfg = get_reduced("starcoder2-3b")
        mesh = make_mesh((4, 2), ("data", "model"), "cpu")
        with sharding_ctx(mesh):
            opt = init_opt_state(cfg, params)
            p2 = distribute(params, param_shardings(params, mesh))
            o2 = distribute(opt, param_shardings(opt, mesh))
            b2 = distribute(batch, tr.tree_map(
                lambda s: NamedSharding(mesh, s), batch_spec(mesh, batch)))
            p3, o3, m3 = make_train_step(cfg)(p2, o2, b2)
            save({"params": whole(p3), "loss": m3["loss"],
                  "grad_norm": m3["grad_norm"], "lr": m3["lr"],
                  "m": whole(o3["adam"]["m"]), "v": whole(o3["adam"]["v"]),
                  "placements": str(b2["tokens"].placements)})
        """, (params, batch))
    assert out["placements"] == "(Shard(dim=0), Replicate())"
    np.testing.assert_allclose(float(out["loss"]), float(m_ref["loss"]),
                               rtol=2e-4)
    np.testing.assert_allclose(float(out["loss"]), float(m_own["loss"]),
                               rtol=2e-4)
    for a, b, c in zip(jax.tree.leaves(p_ref), tr.leaves(out["params"]),
                       tr.leaves(p_own)):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=5e-4)
        np.testing.assert_allclose(b.float().numpy(), c.float().numpy(),
                                   atol=5e-4)
    # the gradient, through AdamW's moments
    np.testing.assert_allclose(float(out["grad_norm"]),
                               float(m_ref["grad_norm"]), rtol=2e-5)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               float(m_own["grad_norm"]), rtol=2e-5)
    for key in ("m", "v"):
        refs = jax.tree.leaves(o_ref["adam"][key])
        gots, owns = tr.leaves(out[key]), tr.leaves(o_own["adam"][key])
        assert len(refs) == len(gots) == len(owns)
        for want, got, own in zip(refs, gots, owns):
            want = np.asarray(want, np.float32)
            got, own = got.float().numpy(), own.float().numpy()
            assert np.abs(want).max() > 0
            assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
            assert np.abs(got - own).max() <= 2e-5 * np.abs(own).max()
    # the update itself: lr-sized on every leaf, on and off the mesh
    lr = float(out["lr"])
    p0 = [x.float().numpy() for x in tr.leaves(params)]
    for moved in (tr.leaves(out["params"]), tr.leaves(p_own)):
        step = max(float(np.abs(x.float().numpy() - x0).max())
                   for x, x0 in zip(moved, p0))
        assert 0.5 * lr <= step <= 2 * lr, (step, lr)


def test_moe_expert_parallel_matches(tmp_path):
    """The reference's case: the reduced olmoe-1b-7b forward (capacity
    factor 64) with params laid out by param_specs on a 2 x 4 mesh within
    atol 2e-3 of the reference's single device; and again with the
    experts sharded over model by hand (8 experts, 2 a rank)."""
    import dataclasses

    from repro.configs import get_reduced as jred
    from repro_torch.configs import get_reduced

    jcfg = dataclasses.replace(jred("olmoe-1b-7b"), capacity_factor=64.0)
    key = jax.random.PRNGKey(0)
    tokens = jax.random.randint(key, (4, 8), 0, jcfg.vocab_size)
    jparams = jtf.init_params(jcfg, key)
    ref, _, _ = jtf.forward(jcfg, jparams, tokens=tokens, mode="train")
    cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"),
                              capacity_factor=64.0)
    params = _to_torch(jparams)
    tok = torch.from_numpy(np.asarray(tokens))
    own, _, _ = ptf.forward(cfg, params, tokens=tok, mode="train")
    out = _ranks(tmp_path, 8, """
        import dataclasses
        from repro_torch.configs import get_reduced
        from repro_torch.models import transformer as tf
        params, tok = torch.load(os.path.join(DATA, "in.pt"))
        cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"),
                                  capacity_factor=64.0)
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        with sharding_ctx(mesh):
            sh = param_shardings(params, mesh)
            a, _, _ = tf.forward(cfg, distribute(params, sh), tokens=tok,
                                 mode="train")
            # EP by hand: the (L, E, ...) expert leaves over model
            ep = {k: NamedSharding(mesh, P(None, "model", None, None))
                  for k in ("w_gate", "w_up", "w_down")}
            sh["layers"]["moe"].update(ep)
            p2 = distribute(params, sh)
            placed = str(p2["layers"]["moe"]["w_up"].placements)
            b, _, _ = tf.forward(cfg, p2, tokens=tok, mode="train")
            save({"a": a.full_tensor(), "b": b.full_tensor(),
                  "placed": placed})
        """, (params, tok))
    assert out["placed"] == "(Replicate(), Shard(dim=1))"
    for got in (out["a"], out["b"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-3)
        np.testing.assert_allclose(got.numpy(), own.numpy(), atol=2e-3)


def test_unfolded_tp_lstm_matches(tmp_path):
    """The reference's case: the distributed Unfolded schedule (gate axis
    over model = 8) within atol 1e-5 of the reference's single-device
    run_layer_unfolded; and of the port's own; its mvm launches one a
    step."""
    from repro.core.schedules import run_layer_unfolded as jrun
    from repro.models.layers.lstm import init_lstm_layer
    from repro_torch.core.schedules import run_layer_unfolded

    key = jax.random.PRNGKey(0)
    H, B, T = 64, 2, 6
    jparams = init_lstm_layer(key, H, H, jax.numpy.float32)
    xs = jax.random.normal(key, (B, T, H)) * 0.5
    ref = jrun(jparams, xs)
    params = _to_torch(jparams)
    txs = torch.from_numpy(np.asarray(xs))
    own = run_layer_unfolded(params, txs)
    out = _ranks(tmp_path, 8, """
        from repro_torch.core.unfolded import (lstm_param_specs,
                                               run_layer_unfolded_tp)
        from repro_torch.kernels import mvm
        params, xs = torch.load(os.path.join(DATA, "in.pt"))
        mesh = make_mesh((8,), ("model",), "cpu")
        specs = lstm_param_specs()
        p2 = distribute(params, {k: NamedSharding(mesh, specs[k])
                                 for k in params})
        n0 = mvm.calls
        hs = run_layer_unfolded_tp(p2, xs, mesh)
        save({"hs": hs.full_tensor(), "mvm": mvm.calls - n0,
              "local": tuple(p2["U"].to_local().shape)})
        """, (params, txs))
    assert out["local"] == (H, 4 * H // 8) and out["mvm"] == T
    np.testing.assert_allclose(out["hs"].numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(out["hs"].numpy(), own.numpy(), atol=1e-5)


def test_seq_sharded_decode_matches_single_device(tmp_path):
    """The reference's case: decode with the KV ring sharded over its T on
    model = 4 (B over data = 2) within atol 2e-4 of the reference's
    single-device decode, from the same prefill state; and of the port's
    own; a step launches decode_attention once a layer and mvm 6 a layer,
    as with no mesh.  Then the prefill itself under the mesh writes the
    sharded rings the plain prefill writes."""
    from repro.configs import get_reduced as jred

    jcfg = jred("starcoder2-3b")
    key = jax.random.PRNGKey(0)
    jparams = jtf.init_params(jcfg, key)
    tokens = jax.random.randint(key, (4, 24), 0, jcfg.vocab_size)
    _, jcache = jtf.prefill(jcfg, jparams, {"tokens": tokens}, seq_len=32)
    refs, c = [], jcache
    for t in range(3):
        tok = jax.numpy.full((4, 1), t + 5, jax.numpy.int32)
        lg, c = jtf.decode_step(jcfg, jparams, c, {"tokens": tok})
        refs.append(np.asarray(lg))
    params = _to_torch(jparams)
    cache = _to_torch(jcache)
    ttok = torch.from_numpy(np.asarray(tokens))
    from repro_torch.configs import get_reduced

    cfg = get_reduced("starcoder2-3b")
    own, c = [], tr.tree_map(lambda x: x.clone(), cache)
    for t in range(3):
        lg, c = ptf.decode_step(cfg, params, c, {
            "tokens": torch.full((4, 1), t + 5, dtype=torch.int32)})
        own.append(lg.numpy())
    pre_logits, pre_cache = ptf.prefill(cfg, params, {"tokens": ttok},
                                        seq_len=32)
    out = _ranks(tmp_path, 8, """
        from repro_torch.configs import get_reduced
        from repro_torch.kernels import decode_attention, mvm
        from repro_torch.models import transformer as tf
        params, cache, tokens = torch.load(os.path.join(DATA, "in.pt"))
        cfg = get_reduced("starcoder2-3b")
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        with sharding_ctx(mesh):
            p2 = distribute(params, param_shardings(params, mesh,
                                                    fsdp=False))
            c2 = distribute(cache, cache_shardings(cache, mesh))
            placed = str(c2["layers"]["k"].placements)
            outs = []
            n0 = decode_attention.calls, mvm.calls
            for t in range(3):
                tok = torch.full((4, 1), t + 5, dtype=torch.int32)
                lg, c2 = tf.decode_step(cfg, p2, c2, {"tokens": tok})
                outs.append(lg.full_tensor())
            calls = (decode_attention.calls - n0[0], mvm.calls - n0[1])
            lg, c3 = tf.prefill(cfg, p2, {"tokens": tokens}, seq_len=32)
            save({"outs": outs, "calls": calls, "placed": placed,
                  "prefill": lg.full_tensor(), "rings": whole(c3)})
        """, (params, cache, ttok))
    assert out["placed"] == "(Shard(dim=1), Shard(dim=2))"
    L = cfg.n_layers
    assert out["calls"] == (3 * L, 3 * 6 * L)
    for got, ref, mine in zip(out["outs"], refs, own):
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
        np.testing.assert_allclose(got.numpy(), mine, atol=2e-4)
    np.testing.assert_allclose(out["prefill"].numpy(), pre_logits.numpy(),
                               atol=2e-4)
    for a, b in zip(tr.leaves(out["rings"]), tr.leaves(pre_cache)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


def test_elastic_restore_across_meshes(tmp_path):
    """The reference's case: a checkpoint saved on an (8, 1) mesh restores
    onto a (2, 4) mesh bit for bit, with the placements asked for; and
    TrainLoop passes its (params, opt) shardings to the restore."""
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4)}
    out = _ranks(tmp_path, 8, """
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.runtime import FTConfig, TrainLoop
        (tree,) = torch.load(os.path.join(DATA, "in.pt"))
        m1 = make_mesh((8, 1), ("data", "model"), "cpu")
        t1 = distribute(tree, {"w": NamedSharding(m1, P("data", None))})
        ck = Checkpointer(os.path.join(DATA, "ck"))
        ck.save(3, t1, blocking=True)
        m2 = make_mesh((2, 4), ("data", "model"), "cpu")
        sh2 = {"w": NamedSharding(m2, P(None, "model"))}
        got = ck.restore(3, tree, sh2)
        w = got["w"]
        # TrainLoop's restore lays the state out by its shardings
        loop = TrainLoop(None, None, FTConfig(
            ckpt_dir=os.path.join(DATA, "ft")), shardings=(sh2, {}))
        loop.ckpt.save(5, {"params": t1, "opt": {}}, blocking=True)
        st, step = loop._restore({"params": tree, "opt": {}})
        save({"w": w.full_tensor(), "placements": str(w.placements),
              "mesh": w.device_mesh.mesh_dim_names,
              "local": tuple(w.to_local().shape), "ft": step,
              "ft_w": st["params"]["w"].full_tensor(),
              "ft_placements": str(st["params"]["w"].placements)})
        """, (tree,))
    assert torch.equal(out["w"], tree["w"])
    assert out["placements"] == "(Replicate(), Shard(dim=1))"
    assert out["mesh"] == ("data", "model") and out["local"] == (8, 1)
    assert out["ft"] == 5 and torch.equal(out["ft_w"], tree["w"])
    assert out["ft_placements"] == "(Replicate(), Shard(dim=1))"


def test_kernels_run_on_local_shards(tmp_path):
    """``sharding.local`` runs each kernel entry point on its local shards:
    mvm with W sharded on its columns and on its rows, decode_attention
    over a ring sharded on B and on T (one slice with no live slot), and
    rglru_scan (forward and backward) with its channels sharded, on a
    2 x 2 mesh: each equal to the call with no mesh within fp32 rounding,
    and each called once per call as with no mesh."""
    g = torch.Generator().manual_seed(7)
    inputs = dict(
        x=torch.randn((4, 16), generator=g), W=torch.randn((16, 24),
                                                           generator=g),
        q=torch.randn((4, 1, 4, 8), generator=g),
        k=torch.randn((4, 32, 2, 8), generator=g),
        v=torch.randn((4, 32, 2, 8), generator=g),
        valid=torch.tensor([3, 16, 17, 32], dtype=torch.int32),
        log_a=-torch.rand((4, 6, 8), generator=g),
        gx=torch.randn((4, 6, 8), generator=g),
        h0=torch.randn((4, 8), generator=g))
    out = _ranks(tmp_path, 4, """
        from torch.distributed.tensor import Shard, Replicate
        from repro_torch.kernels import decode_attention, mvm, rglru_scan
        from repro_torch.sharding import local
        a = torch.load(os.path.join(DATA, "in.pt"))
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        def put(t, spec):
            return distribute(t, NamedSharding(mesh, spec))
        res = {}
        n0 = mvm.calls
        res["col"] = local.matmul(mvm, put(a["x"], P("data", None)),
                                  put(a["W"], P(None, "model"))).full_tensor()
        res["row"] = local.matmul(mvm, put(a["x"], P("data", None)),
                                  put(a["W"], P("model", None))).full_tensor()
        res["mvm_calls"] = mvm.calls - n0
        n0 = decode_attention.calls
        for name, spec in (("attn_b", P(("data", "model"), None)),
                           ("attn_t", P("data", "model"))):
            res[name] = local.decode_attention(
                decode_attention, a["q"], put(a["k"], spec),
                put(a["v"], spec), a["valid"]).full_tensor()
        res["attn_calls"] = decode_attention.calls - n0
        la = put(a["log_a"], P("data", None, "model")).requires_grad_()
        hs, hT = local.rglru_scan(rglru_scan, la,
                                  put(a["gx"], P("data", None, "model")),
                                  put(a["h0"], P("data", "model")))
        (hs.sum() + hT.sum()).backward()
        res["hs"], res["hT"] = hs.full_tensor(), hT.full_tensor()
        res["dla"] = la.grad.full_tensor()
        save(res)
        """, inputs)
    from repro_torch.kernels import decode_attention, mvm, rglru_scan

    x, W = inputs["x"], inputs["W"]
    torch.testing.assert_close(out["col"], mvm(x, W), rtol=0, atol=1e-5)
    torch.testing.assert_close(out["row"], mvm(x, W), rtol=0, atol=1e-5)
    ref = decode_attention(inputs["q"], inputs["k"], inputs["v"],
                           inputs["valid"])
    torch.testing.assert_close(out["attn_b"], ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(out["attn_t"], ref, rtol=0, atol=1e-5)
    la = inputs["log_a"].clone().requires_grad_()
    hs, hT = rglru_scan(la, inputs["gx"], inputs["h0"])
    (hs.sum() + hT.sum()).backward()
    torch.testing.assert_close(out["hs"], hs.detach(), rtol=0, atol=0)
    torch.testing.assert_close(out["hT"], hT.detach(), rtol=0, atol=0)
    torch.testing.assert_close(out["dla"], la.grad, rtol=0, atol=0)
    assert out["mvm_calls"] == 2 and out["attn_calls"] == 2


# ---------------------------------------------------------------------------
# decode_attention's (m, l) form
# ---------------------------------------------------------------------------


def _softmax64(q, k, v, valid):
    """o, m, l of each (row, query head) in fp64 over the live slots."""
    B, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    qg = q.double().reshape(B, Hk, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qg, k.double()) / np.sqrt(D)
    live = torch.arange(k.shape[1])[None] < valid[:, None]
    s = torch.where(live[:, None, None], s, -torch.inf)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhgt,bthd->bhgd", p, v.double()) / l[..., None]
    return o.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


@pytest.mark.parametrize("valid", [[1, 7, 64, 64], [0, 33, 2, 0]])
def test_plain_decode_attention_gives_softmax_statistics(valid):
    """The plain version's (m, l) form against a softmax in fp64; a row
    with no live slot gives the combine's identity (0, -inf, 0)."""
    from repro_torch.kernels.decode_attention import ops

    g = torch.Generator().manual_seed(3)
    q = torch.randn((4, 6, 16), generator=g)
    k = torch.randn((4, 64, 2, 16), generator=g)
    v = torch.randn((4, 64, 2, 16), generator=g)
    vl = torch.tensor(valid, dtype=torch.int32)
    o, m, l = ops.decode_attention(q, k, v, vl, return_stats=True)
    assert o.dtype == torch.float32 and m.shape == l.shape == (4, 6)
    ro, rm, rl = _softmax64(q, k, v, vl)
    live = vl >= 1
    torch.testing.assert_close(o[live].double(), ro[live], rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(m[live].double(), rm[live], rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(l[live].double(), rl[live], rtol=1e-6,
                               atol=0)
    assert (o[~live] == 0).all() and (l[~live] == 0).all()
    assert (m[~live] == -torch.inf).all()
    # the output alone is the plain form's, rounded as before
    torch.testing.assert_close(ops.decode_attention(q, k, v, vl)[live],
                               o[live], rtol=0, atol=1e-6)


def test_decode_attention_halves_combine_to_the_whole():
    """A ring's two halves' (o, m, l), combined as the sharded decode
    combines them, equal the whole ring's output."""
    from repro_torch.kernels.decode_attention import ops

    g = torch.Generator().manual_seed(4)
    q = torch.randn((3, 4, 8), generator=g)
    k = torch.randn((3, 64, 1, 8), generator=g)
    v = torch.randn((3, 64, 1, 8), generator=g)
    vl = torch.tensor([5, 40, 64], dtype=torch.int32)
    whole = ops.decode_attention(q, k, v, vl)
    parts = [ops.decode_attention(q, k[:, lo:lo + 32], v[:, lo:lo + 32],
                                  torch.clamp(vl - lo, 0, 32).int(),
                                  return_stats=True) for lo in (0, 32)]
    M = torch.maximum(parts[0][1], parts[1][1])
    w = [l * torch.exp(m - M) for _, m, l in parts]
    o = (parts[0][0] * w[0][..., None] + parts[1][0] * w[1][..., None]) / (
        w[0] + w[1])[..., None]
    torch.testing.assert_close(o, whole, rtol=0, atol=1e-6)
