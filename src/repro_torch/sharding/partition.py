"""Parameter / activation / cache partitioning rules (DP + FSDP + TP + EP)
— the port of ``repro.sharding.partition``.

Rules are path+shape based and divisibility-checked against the mesh, so
a single rule set serves every architecture on any mesh shape (bigger
meshes only change the shape tuple).  The rules read only the mesh's axis
names and sizes (``axis_sizes``), so they take a ``DeviceMesh``, a
``MeshShape`` (a plain description that needs no process group) or any
object with ``axis_names`` and ``devices.shape``.

Scheme (logical -> physical):
  batch         ('pod', 'data')     data parallel across pods and hosts
  fsdp          ('pod', 'data')     param/optimizer-state sharding (ZeRO-3
                                    style: gathered per-layer at use)
  tensor        'model'             TP: heads / ffn / experts / vocab / gate-4H

Per-tensor policy (matching dims checked for divisibility, else replicated):
  embedding table (V, d)        -> (model, fsdp)
  unembed (d, V)                -> (fsdp, model)
  in-projections  (.., d, out)  -> (.., fsdp, model)   w_q, w_kv, w_gate, w_up,
                                                        W, w_in, w_a, w_x, w_up_*
  out-projections (.., in, d)   -> (.., model, fsdp)   w_o, w_down, w_out
  MoE experts (E, d, f) / (E, f, d) -> (model=EP, -, fsdp) both
  router (d, E)                 -> (-, model)
  everything 1-D (norms, biases, Lambda) -> replicated
Scan-stacked params carry a leading L dim, always unsharded.

PyTorch's terms for JAX's: a ``PartitionSpec`` is the port's ``P`` (per
tensor dim ``None``, one axis name or a tuple of names, the first named
the major one), which ``placements`` turns into one ``Shard(d)`` or
``Replicate()`` per mesh dim; a ``NamedSharding`` is ``NamedSharding``
here, and ``jax.device_put(tree, shardings)`` is ``distribute``
(``distribute_tensor`` leaf by leaf).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from repro_torch import tree as tr

OUT_PROJ_NAMES = {"w_o", "w_down", "w_out"}
IN_PROJ_NAMES = {"w_q", "w_kv", "w_gate", "w_up", "W", "w_in", "w_a", "w_x",
                 "w_up_v", "w_up_g", "w_q2", "w_k", "w_v", "U", "R"}


class P:
    """A partition spec: per tensor dim ``None`` (replicated), one mesh
    axis name, or a tuple of names (sharded over their product, the first
    the major one).  It iterates and compares as the tuple of its entries,
    and is a leaf of a ``repro_torch.tree`` (not a container)."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __eq__(self, other):
        if isinstance(other, P):
            other = other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return "P(" + ", ".join(repr(p) for p in self.parts) + ")"


@dataclass(frozen=True)
class MeshShape:
    """A mesh by its axis sizes and names alone: what the rules, the dry
    run and the spec tests need, with no process group behind it."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"MeshShape: shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a ``MeshShape`` or an object
    with ``axis_names`` and ``devices.shape`` (as a JAX mesh has)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # torch.distributed DeviceMesh
        return dict(zip(names, tuple(mesh.mesh.shape)))
    shape = getattr(mesh, "shape", None)
    if not isinstance(shape, tuple):
        shape = tuple(mesh.devices.shape)
    return dict(zip(tuple(mesh.axis_names), shape))


def _axes_in(mesh, axes) -> Optional[Tuple[str, ...]]:
    present = set(axis_sizes(mesh))
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in present)
    return axes or None


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    n = 1
    for a in (axes,) if isinstance(axes, str) else axes:
        n *= sizes[a]
    return n


def _fit(mesh, dim: int, axes):
    """axes if present-in-mesh and dim divides evenly, else None."""
    axes = _axes_in(mesh, axes) if axes is not None else None
    if axes is None:
        return None
    if dim % _size(mesh, axes) != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def _param_spec(path_names, leaf, mesh, fsdp_axes) -> P:
    name = path_names[-1] if path_names else ""
    shape = tuple(leaf.shape)
    nd = len(shape)
    in_moe = "moe" in path_names
    spec: list = [None] * nd
    if nd <= 1:
        return P(*spec)
    # small tensors replicate: sharding them buys no memory and costs
    # per-use collectives.  Exception: the sLSTM recurrent matrix R — its
    # per-step dR accumulation must stay sharded with the gate axis or the
    # backward pass all-reduces it every timestep.
    size = 1
    for s in shape:
        size *= s
    if size < 2**22 and name != "R":
        return P(*spec)
    if name == "R":  # (H, dh, 4dh): gate axis over 'model'
        spec[-1] = _fit(mesh, shape[-1], "model")
        return P(*spec)

    if name in ("router",):
        spec[-1] = _fit(mesh, shape[-1], "model")
        return P(*spec)

    if in_moe and name in ("w_gate", "w_up", "w_down") and nd >= 3:
        # (..., E, d, f) or (..., E, f, d): EP on E; FSDP on the last dim,
        # never on the dispatch buffer's contraction dim d of w_gate/w_up
        e_dim = nd - 3
        spec[e_dim] = _fit(mesh, shape[e_dim], "model")
        spec[-1] = _fit(mesh, shape[-1], fsdp_axes)
        return P(*spec)

    if name == "table":  # (V, d)
        spec[-2] = _fit(mesh, shape[-2], "model")
        spec[-1] = _fit(mesh, shape[-1], fsdp_axes)
        return P(*spec)
    if name == "unembed":  # (d, V)
        spec[-2] = _fit(mesh, shape[-2], fsdp_axes)
        spec[-1] = _fit(mesh, shape[-1], "model")
        return P(*spec)

    if name in OUT_PROJ_NAMES:
        spec[-2] = _fit(mesh, shape[-2], "model")
        spec[-1] = _fit(mesh, shape[-1], fsdp_axes)
        return P(*spec)

    # default / in-projection: (.., d_in, d_out) -> (fsdp, model)
    spec[-2] = _fit(mesh, shape[-2], fsdp_axes)
    spec[-1] = _fit(mesh, shape[-1], "model")
    # avoid double-booking an axis if both dims resolved to overlapping axes
    if spec[-2] is not None and spec[-1] is not None:
        a = {spec[-2]} if isinstance(spec[-2], str) else set(spec[-2])
        b = {spec[-1]} if isinstance(spec[-1], str) else set(spec[-1])
        if a & b:
            spec[-2] = None
    return P(*spec)


def _path_names(path) -> Tuple[str, ...]:
    return tuple(str(k) for k in path)


def _map_with_path(fn, tree):
    pairs = tr.leaves_with_path(tree)
    return tr.unflatten(tree, [fn(path, leaf) for path, leaf in pairs])


def param_specs(params_shape, mesh, multi_pod_fsdp: bool = True,
                fsdp: bool = True):
    """Tree of ``P`` matching ``params_shape`` (tensors, ``meta`` tensors
    or anything with a ``shape``).

    ``fsdp=False``: weight-stationary (TP-only) layout — no per-use
    gathers; the serving/decode configuration."""
    if not fsdp:
        fsdp_axes = ()
    else:
        fsdp_axes = ("pod", "data") if multi_pod_fsdp else ("data",)

    def one(path, leaf):
        return _param_spec(_path_names(path), leaf, mesh, fsdp_axes)

    return _map_with_path(one, params_shape)


# ---------------------------------------------------------------------------
# specs -> placements on a DeviceMesh
# ---------------------------------------------------------------------------


def placements(spec: P, mesh) -> tuple:
    """One placement per dim of ``mesh``: ``Shard(d)`` where the spec
    names that mesh axis on tensor dim d, else ``Replicate()``.  A tensor
    dim over several axes takes them in the mesh's order, major first, as
    the spec names them (a spec naming them in another order raises)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"placements: {spec} names {axes} on dim {d} "
                             f"against the mesh's order {tuple(names)}")
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (JAX's ``NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(params_shape, mesh, **kw):
    return tr.tree_map(lambda s: NamedSharding(mesh, s),
                       param_specs(params_shape, mesh, **kw))


def cache_shardings(cache_shape, mesh):
    return tr.tree_map(lambda s: NamedSharding(mesh, s),
                       cache_specs(cache_shape, mesh))


def is_dtensor(*ts) -> bool:
    """True if any of ``ts`` is a ``torch.distributed`` DTensor (a run
    under a device mesh).  Without a mesh DTensor's module is never
    imported, and nothing is looked up."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(t, mod.DTensor) for t in ts)


def shard_tensor(t, sharding: NamedSharding):
    """``t`` as a DTensor laid out by ``sharding``: a plain tensor that
    every rank holds whole is cut locally (no collective), a DTensor is
    redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def distribute(tree, shardings):
    """``jax.device_put(tree, shardings)``: ``shard_tensor`` leaf by leaf
    (``shardings`` a tree of ``NamedSharding`` of ``tree``'s structure)."""
    return tr.tree_map(shard_tensor, tree, shardings)


# ---------------------------------------------------------------------------
# batch / cache
# ---------------------------------------------------------------------------


def batch_spec(mesh, batch_shape_tree):
    """tokens/embeds/labels: batch dim over (pod, data) when divisible."""

    def one(leaf):
        shape = tuple(leaf.shape)
        dp = _fit(mesh, shape[0], ("pod", "data"))
        spec = [dp] + [None] * (len(shape) - 1)
        if len(shape) >= 3:  # embeds (B, S, d)
            spec[-1] = _fit(mesh, shape[-1], "model")
        return P(*spec)

    return tr.tree_map(one, batch_shape_tree)


def cache_specs(cache_shape, mesh):
    """KV caches (L?, B, T, KV): batch over dp, the ring's T over model
    (decode attention then combines softmax statistics across the shards
    instead of gathering the rows); recurrent states (B, W): width over
    model."""

    def one(path, leaf):
        names = _path_names(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        name = names[-1]
        if name == "idx":
            return P(_fit(mesh, shape[0], ("pod", "data")))
        # stacked (scan) caches carry a leading L dim; list caches have a
        # numeric layer index in their path instead
        has_idx = any(n.isdigit() for n in names)
        scan_l = 0 if has_idx else (1 if nd >= 3 else 0)
        spec = [None] * nd
        b_dim = scan_l
        if b_dim < nd:
            spec[b_dim] = _fit(mesh, shape[b_dim], ("pod", "data"))
        if name in ("k", "v") and nd >= b_dim + 3:
            spec[b_dim + 1] = _fit(mesh, shape[b_dim + 1], "model")
        elif name in ("state", "h", "c", "n", "m") and nd == b_dim + 2:
            spec[-1] = _fit(mesh, shape[-1], "model")
        elif name == "conv" and nd == b_dim + 3:
            spec[-1] = _fit(mesh, shape[-1], "model")
        return P(*spec)

    return _map_with_path(one, cache_shape)


__all__ = ["P", "MeshShape", "NamedSharding", "axis_sizes", "param_specs",
           "param_shardings", "cache_shardings", "placements",
           "is_dtensor", "shard_tensor", "distribute",
           "batch_spec", "cache_specs", "OUT_PROJ_NAMES", "IN_PROJ_NAMES"]
