"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc``).

Each kernel is one ``.cu`` file with a plain C entry point, compiled by
``nvcc`` for ``sm_90a`` into a shared library and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  Every kernel family's
``kernel.py`` registers its kernels here (``register``); ``build()`` with
no names builds every family's.  Builds happen at first use, never at
import, into ``build/repro_torch_kernels/`` at the root of the checkout;
a library's file name carries a hash of its source, the shared headers and
the flags, so an edited source rebuilds and a checkout builds from its own
sources only.  A failed build raises ``KernelBuildError`` with nvcc's
stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels.common import KernelBuildError

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int

#: kernel -> (C entry point, its argtypes): every pointer and the stream
#: are c_void_p, every size or flag c_int (see the .cu files' signatures)
KERNELS: Dict[str, Tuple[str, List]] = {}
_HEADERS = ("rnn_common.cuh", "cluster.cuh", "decode_cluster.cuh",
            "seq_cluster.cuh")
#: the modules whose import registers their family's kernels
FAMILIES = ("repro_torch.kernels.lstm_cell.kernel",
            "repro_torch.kernels.gru_cell.kernel",
            "repro_torch.kernels.rglru.kernel",
            "repro_torch.kernels.mvm_tile.kernel",
            "repro_torch.kernels.decode_attention.kernel")

_loaded: dict = {}  # kernel name -> bound C entry point


def register(name: str, symbol: str, argtypes) -> None:
    """Register kernel ``name`` (source ``csrc/{name}.cu``) with its C
    entry point and that function's ctypes argtypes."""
    KERNELS[name] = (symbol, list(argtypes))


def all_kernels() -> Tuple[str, ...]:
    """Every registered kernel, after importing every family."""
    for mod in FAMILIES:
        importlib.import_module(mod)
    return tuple(KERNELS)


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise KernelBuildError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """Where ``name``'s shared library lives: keyed on a hash of its
    source, the shared headers and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu",) + _HEADERS:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, float]:
    """Compile the named kernels (every family's by default) that are not
    built yet, one nvcc process per source, all started together.  Returns
    each kernel's build seconds (0.0 when it was already built)."""
    known = all_kernels()
    names = names or known
    for name in names:
        if name not in KERNELS:
            raise ValueError(f"unknown kernel {name!r}; "
                             f"allowed: {', '.join(known)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    secs = {name: 0.0 for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise KernelBuildError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """nvcc's output for ``name``'s last build (``-Xptxas -v``: registers,
    shared memory and spills per kernel instance)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def entry(name: str):
    """The bound C entry point of kernel ``name``, building it first if
    needed.  Loaded once per process."""
    fn = _loaded.get(name)
    if fn is None:
        symbol, argtypes = KERNELS[name]
        fn = _loaded[name] = bind(name, symbol, argtypes)
    return fn


def bind(name: str, symbol: str, argtypes):
    """C function ``symbol`` of kernel ``name``'s library (its launch entry
    point, or a query beside it), bound with ``argtypes`` and an int
    result, building the library first if needed."""
    build(name)
    fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
