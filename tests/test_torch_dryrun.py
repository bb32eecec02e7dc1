"""The port's dry run (``repro_torch.launch.dryrun``) on the small meshes
(``REPRO_DRYRUN_SMALL``: 4x4 and 2x2x4), in a subprocess as the
reference's own test runs its CLI: every cell ok with the reference's
names, the skip rule kept, and each cell's argument bytes per device
equal to those reckoned from the reference's specs of the same step."""
import json
import math
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from tests.conftest import REPO_ROOT, SRC

from repro.configs import SHAPES, get_config
from repro.launch.steps import TrainSettings, input_specs
from repro.sharding.partition import batch_spec, cache_specs, param_specs

#: the small meshes, by the reference's cell names
SMALL = {"16x16": ((4, 4), ("data", "model")),
         "2x16x16": ((2, 2, 4), ("pod", "data", "model"))}


def _dryrun(args, tmp_path, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN_SMALL="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(tmp_path), "--no-hlo"],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT,
        timeout=timeout)


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
                tmp_path)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n" \
                              f"{r.stderr[-2000:]}"
    assert "[FAILED" not in r.stdout
    cells = [json.load(open(tmp_path / f)) for f in os.listdir(tmp_path)
             if f.endswith(".json")]
    assert len(cells) == 2  # both meshes
    for c in cells:
        assert c["status"] == "ok"
        assert c["cell"] == f"{arch}__{shape}__{c['mesh']}"
        mem = c["memory"]
        assert mem["argument_bytes_per_device"] == _ref_argument_bytes(
            arch, shape, c["mesh"])
        assert mem["peak_bytes_per_device_lower_bound"] == (
            mem["argument_bytes_per_device"]
            + mem["output_bytes_per_device"]
            - mem["alias_bytes_per_device"]) > 0
        assert mem["hbm_bytes_per_device"] == 80 * 10**9
        assert mem["lower_bound_exceeds_hbm"] == (
            mem["peak_bytes_per_device_lower_bound"] > 80 * 10**9)
        flops = c["cost_analysis"]
        assert flops["flops_global"] > 0
        assert flops["flops_per_device_even_split"] == math.ceil(
            flops["flops_global"] / c["n_devices"])
        assert c["n_devices"] == 16


def test_dryrun_skip_rule(tmp_path):
    """Pure full-attention arch must SKIP long_500k (documented), not
    fail."""
    r = _dryrun(["--arch", "deepseek-67b", "--shape", "long_500k", "--mesh",
                 "pod"], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "skipped" in r.stdout
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".json")]
