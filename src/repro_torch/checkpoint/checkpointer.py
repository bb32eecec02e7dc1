"""Async checkpointing to numpy files (the port of
``repro.checkpoint.checkpointer``, with the same on-disk layout, so each
package restores the other's checkpoints).

Layout per step:
    <dir>/step_<N>/manifest.json       leaf names + count + step
    <dir>/step_<N>/arr_<i>.npy         one file per leaf
    <dir>/step_<N>/.complete           commit marker (atomic rename)

Leaves are numbered in ``jax.tree.flatten``'s order (``repro_torch.tree``:
dict keys sorted, lists in order), and a bfloat16 leaf is written as the
2-byte records ``np.save`` writes for an ``ml_dtypes.bfloat16`` array
(descr ``<V2``), which is how the reference stores its bf16 leaves.

  * async: ``save`` snapshots the leaves to host memory (a copy, made
    now, of every tensor: the train step updates the live ones in place)
    and writes them on a worker thread; training continues at once
    (double-buffered — a new save waits for the previous one).
  * atomic: readers only trust directories with the commit marker, so a
    worker dying mid-write can never corrupt a restore.
  * restore: into the structure, dtypes and devices of ``like``; with
    ``shardings`` (a tree of ``sharding.NamedSharding``) each leaf is laid
    out on its mesh — the elastic restore: a checkpoint saved on one mesh
    restores onto any other.
  * under a process group: ``save`` gathers each DTensor leaf whole (a
    collective: every rank calls it) and rank 0 writes; ``restore`` waits
    at a barrier for rank 0's write, then every rank reads the files and
    keeps its own shards (``wait``, which both call, is a barrier).
  * GC: keep the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.sharding.partition import is_dtensor

#: the ``.npy`` descr of a bfloat16 leaf (``np.save`` of ml_dtypes')
BF16_DESCR = "<V2"


def _host(leaf) -> np.ndarray:
    """A host numpy copy of a tensor leaf (bf16 as its raw 16-bit words);
    a DTensor leaf is gathered whole first."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _save_leaf(path: str, arr: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_leaf(path: str, like: torch.Tensor) -> torch.Tensor:
    arr = np.load(path)
    if arr.dtype.kind == "V":  # 2-byte bf16 records
        if like.dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
            raise TypeError(f"{path}: {arr.dtype} records restore only into "
                            f"a bfloat16 leaf, not {like.dtype}")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(like.device)


def _group_rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else 0


def _name(path) -> str:
    return "/".join(str(k) for k in path)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False):
        self.wait()  # double-buffer: at most one in-flight save
        pairs = tr.leaves_with_path(tree)
        names = [_name(p) for p, _ in pairs]
        bf16 = [torch.as_tensor(x).dtype == torch.bfloat16 for _, x in pairs]
        host_leaves = [_host(x) for _, x in pairs]  # snapshot now

        def _write():
            tmp = os.path.join(self.directory, f".tmp_step_{step}")
            final = os.path.join(self.directory, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            for i, (arr, is_bf16) in enumerate(zip(host_leaves, bf16)):
                _save_leaf(os.path.join(tmp, f"arr_{i}.npy"), arr, is_bf16)
            manifest = {
                "step": step,
                "names": names,
                "num_leaves": len(host_leaves),
                "treedef": "repro_torch.tree: " + ", ".join(names),
                "time": time.time(),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, ".complete"), "w") as f:
                f.write("ok")
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if _group_rank() != 0:  # rank 0 writes what every rank gathered
            return
        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        """Until the last save is on disk; under a process group on every
        rank (a barrier after rank 0's writer is done)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if torch.distributed.is_initialized():
            torch.distributed.barrier()

    # -- restore ---------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, ".complete")):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Restore into the structure of ``like``: each leaf with the dtype
        and on the device of ``like``'s (local) leaf; with ``shardings``
        (a tree of ``NamedSharding`` of ``like``'s structure) laid out on
        their meshes, every rank cutting its own shards from the file."""
        self.wait()
        d = os.path.join(self.directory, f"step_{step}")
        if not os.path.exists(os.path.join(d, ".complete")):
            raise FileNotFoundError(f"no complete checkpoint at {d}")
        leaves = [x.to_local() if is_dtensor(x) else torch.as_tensor(x)
                  for x in tr.leaves(like)]
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["num_leaves"] != len(leaves):
            raise AssertionError("structure mismatch")
        out = [_load_leaf(os.path.join(d, f"arr_{i}.npy"), like_leaf)
               for i, like_leaf in enumerate(leaves)]
        if shardings is not None:
            from repro_torch.sharding.partition import shard_tensor
            shard_leaves = tr.leaves(shardings)
            if len(shard_leaves) != len(out):
                raise AssertionError("shardings: structure mismatch")
            out = [shard_tensor(t, s) for t, s in zip(out, shard_leaves)]
        return tr.unflatten(like, out)

    # -- gc ----------------------------------------------------------------
    def _gc(self):
        steps = sorted(s for s in (
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_")))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)


__all__ = ["Checkpointer", "BF16_DESCR"]
