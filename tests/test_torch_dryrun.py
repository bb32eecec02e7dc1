"""The port's dry run (``repro_torch.launch.dryrun``) on the small meshes
(``REPRO_DRYRUN_SMALL``: 4x4 and 2x2x4), in a subprocess as the
reference's own test runs its CLI: every cell ok with the reference's
names (memory with temporaries, cost_analysis, collectives), the skip
rule kept, each cell's argument bytes per device equal to those reckoned
from the reference's specs of the same step, its FLOPs per device at
least the unsharded step's share, and beside the reference's walker on
its own saved HLO; a ``"cpu"`` mesh's stand-in for an all-to-all counted
as the all-to-all."""
import json
import math
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from tests.conftest import REPO_ROOT, SRC, subprocess_env

from repro.configs import SHAPES, get_config
from repro.launch.steps import TrainSettings, input_specs
from repro.sharding.partition import batch_spec, cache_specs, param_specs

#: the small meshes, by the reference's cell names
SMALL = {"16x16": ((4, 4), ("data", "model")),
         "2x16x16": ((2, 2, 4), ("pod", "data", "model"))}


def _dryrun(args, tmp_path, timeout=300, hlo=False):
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN_SMALL="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(tmp_path)] + ([] if hlo else ["--no-hlo"]),
        capture_output=True, text=True, env=env, cwd=REPO_ROOT,
        timeout=timeout)


def _unsharded_flops(arch, shape_name):
    """FLOPs of the cell's whole step, traced with no mesh on fake
    tensors (the card's path, as the dry run's)."""
    import torch

    from repro_torch.calib import hlo
    from repro_torch.configs import SHAPES as TSHAPES
    from repro_torch.configs import get_config as tget
    from repro_torch.launch import steps

    cfg, shape = tget(arch), TSHAPES[shape_name]
    sp = steps.input_specs(cfg, shape)
    assert shape.mode == "decode"
    with torch.no_grad():
        t, _ = hlo.run(steps.make_serve_step(cfg), sp["params"], sp["cache"],
                       sp["batch"], card=True)
    return hlo.analyze(t.text())["flops"]


#: the reference's walker on its own saved HLO of the same cells (its dry
#: run in a subprocess), per device, and why the port's differs
REFERENCE_FLOPS_DIFFERENCES = {
    "starcoder2-3b": "none: the same FLOPs per device",
    "recurrentgemma-2b": "on the ring sharded over T (4 slices of 512 "
                         "slots) the port's decode_attention does q·K and "
                         "p·V for all 10 heads on every rank of the data "
                         "axis, which B = 1 leaves idle; XLA's partitioner "
                         "splits p·V's heads over it too (5 a device): 8 "
                         "layers x 2·5·512·256 = 10,485,760 FLOPs",
}


def _reference_flops(arch, shape, tmp_path):
    out = tmp_path / "reference"
    env = subprocess_env(16)
    env["REPRO_DRYRUN_SMALL"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "pod", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    cell = json.load(open(out / f"{arch}__{shape}__16x16.json"))
    from repro.calib.hlo import analyze_file
    return analyze_file(cell["hlo"])["flops"]


def _ref_argument_bytes(arch, shape_name, mesh_name):
    """Per-device bytes of the step's arguments under the reference's own
    specs (its ``shardings_for`` rules on a duck mesh)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    dims, names = SMALL[mesh_name]
    mesh = types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(dims, dtype=np.int8))
    sizes = dict(zip(names, dims))
    specs = input_specs(cfg, shape, TrainSettings())
    tp_only = shape.mode == "decode" and cfg.num_params() <= 70e9
    trees = [(specs["params"], param_specs(specs["params"], mesh,
                                           multi_pod_fsdp=True,
                                           fsdp=not tp_only))]
    if shape.mode == "train":
        trees.append((specs["opt_state"], param_specs(specs["opt_state"],
                                                      mesh)))
    if shape.mode == "decode":
        trees.append((specs["cache"], cache_specs(specs["cache"], mesh)))
    trees.append((specs["batch"], batch_spec(mesh, specs["batch"])))
    total = 0
    for tree, spec_tree in trees:
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(
            spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                    PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            n = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
            for entry in spec:
                for a in (() if entry is None else
                          (entry,) if isinstance(entry, str) else entry):
                    n //= sizes[a]
            total += n
    return total


@pytest.mark.parametrize("arch,shape", [
    ("starcoder2-3b", "decode_32k"),
    ("recurrentgemma-2b", "long_500k"),
])
def test_dryrun_cell_small_mesh(arch, shape, tmp_path):
    r = _dryrun(["--arch", arch, "--shape", shape, "--mesh", "both"],
                tmp_path, hlo=arch == "starcoder2-3b")
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n" \
                              f"{r.stderr[-2000:]}"
    assert "[FAILED" not in r.stdout
    cells = [json.load(open(tmp_path / f)) for f in os.listdir(tmp_path)
             if f.endswith(".json")]
    assert len(cells) == 2  # both meshes
    whole = _unsharded_flops(arch, shape)
    for c in cells:
        assert c["status"] == "ok"
        assert c["cell"] == f"{arch}__{shape}__{c['mesh']}"
        mem = c["memory"]
        assert mem["argument_bytes_per_device"] == _ref_argument_bytes(
            arch, shape, c["mesh"])
        lower_bound = (mem["argument_bytes_per_device"]
                       + mem["output_bytes_per_device"]
                       - mem["alias_bytes_per_device"])
        assert mem["temp_bytes_per_device"] > 0
        assert mem["peak_bytes_per_device"] == (
            lower_bound + mem["temp_bytes_per_device"]) > lower_bound > 0
        assert mem["hbm_bytes_per_device"] == 80 * 10**9
        assert mem["peak_exceeds_hbm"] == (
            mem["peak_bytes_per_device"] > 80 * 10**9)
        cost = c["cost_analysis"]
        assert set(cost) == {"flops", "bytes accessed", "transcendentals"}
        assert min(cost.values()) > 0
        # the sharded step does at least its share of the whole step's work
        assert cost["flops"] * c["n_devices"] >= whole
        # decode is TP (weights stationary): the mesh moves activations
        assert c["collectives"] and c["collective_bytes"] == sum(
            c["collectives"].values())
        assert c["kernel_ops"]["mvm"] > 0
        assert c["n_devices"] == 16
        if "hlo" in c:  # the saved trace reads back to the same counts
            from repro_torch.calib import hlo
            again = hlo.analyze_file(c["hlo"])
            assert again["flops"] == cost["flops"]
            assert again["collectives"] == c["collectives"]
        else:
            assert arch != "starcoder2-3b"
    mine = next(c for c in cells
                if c["mesh"] == "16x16")["cost_analysis"]["flops"]
    ref = _reference_flops(arch, shape, tmp_path)
    print(f"{arch} {shape} 4x4: FLOPs per device {mine:.0f}, the "
          f"reference's walker on its own HLO {ref:.0f}: "
          f"{REFERENCE_FLOPS_DIFFERENCES[arch]}")
    assert mine - ref == {"starcoder2-3b": 0,
                          "recurrentgemma-2b": 8 * 2 * 5 * 512 * 256}[arch]


def test_dryrun_skip_rule(tmp_path):
    """Pure full-attention arch must SKIP long_500k (documented), not
    fail."""
    r = _dryrun(["--arch", "deepseek-67b", "--shape", "long_500k", "--mesh",
                 "pod"], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "skipped" in r.stdout
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".json")]


def test_cpu_mesh_alltoall_is_counted_as_the_all_to_all():
    """On a "cpu" mesh DTensor moves a shard from one dim to another by an
    all-gather and a chunk (gloo has no all-to-all); the trace records it
    as the one all-to-all a "cuda" mesh issues, of its result's bytes."""
    code = (
        "import json, torch, torch.distributed as dist\n"
        "from torch._subclasses.fake_tensor import FakeTensorMode\n"
        "from torch.distributed.tensor import Shard, distribute_tensor\n"
        "from repro_torch.calib import hlo\n"
        "from repro_torch.launch.dryrun import fake_mesh\n"
        "from repro_torch.sharding.partition import MeshShape\n"
        "mesh = fake_mesh(MeshShape((4,), ('model',)))\n"
        "mode = FakeTensorMode(allow_non_fake_inputs=True)\n"
        "with mode:\n"
        "    x = distribute_tensor(torch.empty(16, 32), mesh, [Shard(0)],\n"
        "                          src_data_rank=None)\n"
        "t, _ = hlo.run(lambda x: x.redistribute(mesh, [Shard(1)]), x)\n"
        "print(json.dumps(hlo.analyze(t.text())['collectives']))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO_ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"all-to-all": 4.0 * 16 * 32 // 4}
