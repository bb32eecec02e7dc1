"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package (``repro``)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.conftest import REPO_ROOT, SRC

PORT = Path(SRC) / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO_ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(
        Path(REPO_ROOT) / path) if mod in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_calib_imports_neither_jax_nor_repro():
    """The measured cost model's package and its CLI stand alone too."""
    code = (
        "import sys\n"
        "import repro_torch.calib, repro_torch.calib.__main__\n"
        "from repro_torch.calib import MeasuredCostTable, calibrate\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_refuses_without_the_package(tmp_path):
    """Alone in a directory (no src/repro_torch beside it) the script
    exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((Path(REPO_ROOT) / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_device_models_import_neither_jax_nor_repro():
    """core.tiling's device models (the reference's and a card's, built
    from faked properties) stand alone too."""
    code = (
        "import sys, types\n"
        "from repro_torch.core import tiling\n"
        "assert tiling.device_model('cpu') is tiling.REFERENCE\n"
        "tiling.card_model(types.SimpleNamespace(name='x', "
        "multi_processor_count=132, shared_memory_per_block_optin=232448))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


#: the MoE FFN (P7) and the xLSTM blocks (P8), with their configs
MOE_XLSTM = ("models/layers/moe.py", "models/layers/xlstm.py",
             "configs/olmoe_1b_7b.py", "configs/arctic_480b.py",
             "configs/xlstm_125m.py")


@pytest.mark.parametrize("rel", MOE_XLSTM)
def test_moe_and_xlstm_modules_import_no_jax_repro_or_triton(rel):
    """The new layers and configs name neither JAX, the JAX package nor
    triton in any import statement (the expert and recurrent products
    are plain PyTorch; the decode projections reach the mvm kernel
    through models.layers.common)."""
    bad = [(mod, line) for mod, line in _imported_roots(PORT / rel)
           if mod in FORBIDDEN + ("triton",)]
    assert not bad, f"{rel} imports {bad}"


def test_moe_and_xlstm_models_load_neither_jax_nor_repro():
    """Importing the new layers and building the three archs' reduced
    models (init_params, one forward) loads neither JAX, the JAX package
    nor triton."""
    code = (
        "import sys, torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.models import transformer as tf\n"
        "from repro_torch.models.layers import moe, xlstm\n"
        "for a in ('olmoe-1b-7b', 'arctic-480b', 'xlstm-125m'):\n"
        "    cfg = configs.get_reduced(a)\n"
        "    p = tf.init_params(cfg, torch.Generator().manual_seed(0))\n"
        "    tf.forward(cfg, p, tokens=torch.zeros((1, 3), "
        "dtype=torch.long))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


#: training (P11): the optimizer, compression, data, checkpoints, the FT
#: loop, the step functions and the driver, with the rglru backward
TRAINING = ("optim/__init__.py", "optim/optimizer.py",
            "optim/compression.py", "data/__init__.py", "data/pipeline.py",
            "checkpoint/__init__.py", "checkpoint/checkpointer.py",
            "runtime/ft.py", "launch/steps.py", "launch/train.py", "tree.py",
            "kernels/rglru/ops.py", "kernels/rglru/ref.py",
            "models/layers/common.py")


@pytest.mark.parametrize("rel", TRAINING)
def test_training_modules_import_no_jax_repro_or_triton(rel):
    """The training modules name neither JAX, the JAX package nor triton
    in any import statement (data/pipeline.py and checkpoint/ keep their
    own numpy copies of the reference's)."""
    bad = [(mod, line) for mod, line in _imported_roots(PORT / rel)
           if mod in FORBIDDEN + ("triton",)]
    assert not bad, f"{rel} imports {bad}"


def test_a_train_step_loads_neither_jax_nor_repro(tmp_path):
    """A reduced RecurrentGemma train step through TrainLoop (a fault, a
    checkpoint, a restore) loads neither JAX, the JAX package nor
    triton."""
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import train\n"
        "loop = train.main(['--arch', 'recurrentgemma-2b', '--reduced', "
        "'--steps', '4', '--batch', '2', '--seq', '8', '--ckpt-every', '2', "
        f"'--fail-at', '3', '--device', 'cpu', '--ckpt-dir', '{tmp_path}'])\n"
        "assert loop.restarts == 1\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr


#: sharding (Queue 1 item 11): the partition rules, the kernels on local
#: shards, the meshes, the dry run, and the modules that take a mesh
SHARDING = ("sharding/__init__.py", "sharding/partition.py",
            "sharding/local.py", "launch/mesh.py", "launch/dryrun.py",
            "core/unfolded.py", "configs/base.py",
            "kernels/decode_attention/ops.py", "kernels/mvm_tile/ops.py",
            "models/transformer.py", "models/layers/embedding.py",
            "models/layers/moe.py", "models/layers/mlp.py")


@pytest.mark.parametrize("rel", SHARDING)
def test_sharding_modules_import_no_jax_repro_or_triton(rel):
    """The sharding modules name neither JAX, the JAX package nor triton
    in any import statement: meshes are torch.distributed's, specs the
    port's own ``P``."""
    bad = [(mod, line) for mod, line in _imported_roots(PORT / rel)
           if mod in FORBIDDEN + ("triton",)]
    assert not bad, f"{rel} imports {bad}"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


@pytest.mark.parametrize("rel", sorted(
    p.relative_to(PORT).as_posix() for p in (PORT / "kernels").rglob("*.py")))
def test_kernels_know_no_mesh(rel):
    """The kernel layer sits below the mesh: no kernel module imports
    ``repro_torch.sharding`` or ``torch.distributed`` (the model's call
    sites run a kernel on its local shards, ``sharding.local``)."""
    bad = [(mod, line) for mod, line in _imported_modules(PORT / rel)
           if mod.startswith(("repro_torch.sharding", "torch.distributed"))]
    assert not bad, f"{rel} imports {bad}"


def test_sharding_and_the_dry_run_load_neither_jax_nor_repro():
    """The rules on a mesh description, the kernels' local-shard module,
    the mesh helpers and one small dry-run cell load neither JAX, the JAX
    package nor triton."""
    code = (
        "import os, sys, tempfile\n"
        "os.environ['REPRO_DRYRUN_SMALL'] = '1'\n"
        "from repro_torch.sharding import MeshShape, param_specs\n"
        "from repro_torch.sharding import local\n"
        "from repro_torch.launch import mesh, dryrun\n"
        "from repro_torch.core.unfolded import run_layer_unfolded_tp\n"
        "r = dryrun.run_cell('xlstm-125m', 'decode_32k', False, "
        "tempfile.mkdtemp())\n"
        "assert r['status'] == 'ok', r\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr


def test_cost_walker_imports_neither_jax_nor_repro():
    """The static cost walker (``calib.hlo``) stands alone, tracing a
    step included."""
    code = (
        "import sys, torch\n"
        "from repro_torch.calib import hlo\n"
        "text = hlo.trace(torch.mm, torch.empty(4, 8), torch.empty(8, 2))\n"
        "assert hlo.analyze(text)['flops'] == 2 * 4 * 8 * 2\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
