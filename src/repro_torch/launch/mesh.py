"""Device meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
over the ranks of the default process group, which the caller has formed
(``torch.distributed.init_process_group``: under ``torchrun`` from its
environment, or with an explicit store, rank and world size).  The device
type is the caller's: ``"cuda"`` by default (the kernels), ``"cpu"`` when
asked (their plain versions, as in the CPU tests).  Functions, not
module-level constants, so importing this module touches no process
group.
"""
from __future__ import annotations

from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """Elastic helper: whatever topology the (restarted) job got — the
    default group's ranks, row-major, as a ``shape`` mesh named
    ``axes``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call torch.distributed."
            "init_process_group first (torchrun, or an explicit store, rank "
            "and world size)")
    shape, axes = tuple(shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"make_mesh: a {shape} mesh needs {n} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks; multi_pod adds the 2-pod 'pod' axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def host_mesh(n: int = 0, model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the group's ``n`` ranks (all of them by
    default), ``model`` of them a model-parallel group."""
    n = n or dist.get_world_size()
    if n % model:
        raise ValueError(f"host_mesh: model={model} does not divide the "
                         f"{n} ranks")
    return make_mesh((n // model, model), ("data", "model"), device_type)


__all__ = ["make_mesh", "make_production_mesh", "host_mesh"]
