"""Nested containers of tensors (the port's pytrees): dicts, lists and
tuples of leaves, walked in ``jax.tree.flatten``'s order — a dict's keys
sorted, a list's or tuple's entries in order, ``None`` an empty subtree —
so that the n-th leaf of a port tree is the n-th leaf of its JAX twin
(``checkpoint.Checkpointer`` writes them as ``arr_<n>.npy`` in that
order)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of a container in flatten order; [] for None."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return []


def is_leaf(tree) -> bool:
    return tree is not None and not isinstance(tree, (dict, list, tuple))


def leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)], a path being the keys and indices from the root."""
    if is_leaf(tree):
        return [(path, tree)]
    out = []
    for k, child in _children(tree):
        out.extend(leaves_with_path(child, path + (k,)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in flatten
    order."""
    it = iter(new_leaves)

    def build(t):
        if is_leaf(t):
            return next(it)
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}  # keep the dict's own order
        return type(t)(build(c) for c in t)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and, beside them, the leaves of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("tree_map: the trees differ in structure")
    return unflatten(tree, [fn(*args) for args in zip(*flat)])


__all__ = ["is_leaf", "leaves", "leaves_with_path", "unflatten",
           "tree_map"]
