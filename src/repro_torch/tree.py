"""Minimal pytree helpers over dicts, tuples/lists and NamedTuples.

The JAX package's trees are flattened by ``jax.tree``, which walks dict
keys in SORTED order. That order decides the wire-plane layout, the
per-leaf noise keys ``fold_in(key, i)`` and hence which coordinates each
draw hits, so every flatten in the port goes through ``leaves`` here
and follows the same rule. ``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["leaves", "flatten", "unflatten", "tree_map", "flatten_with_paths",
           "from_flat", "to_numpy"]

PyTree = Any


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _walk(t, out: List[Any]):
    if t is None:
        return None
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys, tuple(_walk(t[k], out) for k in keys))
    if _is_namedtuple(t):
        return ("nt", type(t), tuple(_walk(v, out) for v in t))
    if isinstance(t, (tuple, list)):
        return (type(t).__name__, len(t), tuple(_walk(v, out) for v in t))
    out.append(t)
    return "*"


def flatten(tree: PyTree) -> Tuple[List[Any], Any]:
    """(leaves in JAX order, a hashable structure for ``unflatten``).

    The walkers here are module-level functions, not closures that call
    themselves: such a closure is a reference cycle that would keep every
    leaf (a whole gradient or noise tree on the card) alive until Python's
    cycle collector happens to run."""
    out: List[Any] = []
    return out, _walk(tree, out)


def leaves(tree: PyTree) -> List[Any]:
    return flatten(tree)[0]


def _build(s, it):
    if s is None:
        return None
    if s == "*":
        return next(it)
    kind, meta, kids = s
    vals = [_build(k, it) for k in kids]
    if kind == "dict":
        return dict(zip(meta, vals))
    if kind == "nt":
        return meta(*vals)
    return tuple(vals) if kind == "tuple" else list(vals)


def unflatten(structure, values) -> PyTree:
    it = iter(values)
    out = _build(structure, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``jax.tree.map``: ``fn`` over corresponding leaves."""
    vals, struct = flatten(tree)
    others = [flatten(r) for r in rest]
    for o_vals, o_struct in others:
        if o_struct != struct:
            raise ValueError("tree_map over trees of different structure")
    return unflatten(struct, [fn(*xs) for xs in
                              zip(vals, *(o[0] for o in others))])


def _walk_paths(t, path: str, out: Dict[str, Any]) -> None:
    if t is None:
        return
    if isinstance(t, dict):
        items = [(str(k), t[k]) for k in sorted(t)]
    elif _is_namedtuple(t):
        items = list(zip(t._fields, t))
    elif isinstance(t, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(t)]
    else:
        out[path] = t
        return
    for k, v in items:
        _walk_paths(v, f"{path}/{k}" if path else k, out)


def flatten_with_paths(tree: PyTree, prefix: str = "") -> Dict[str, Any]:
    """{'/'-joined path: leaf}, the key convention of the JAX package's
    checkpoints (dict keys, NamedTuple field names, sequence indices)."""
    out: Dict[str, Any] = {}
    _walk_paths(tree, prefix, out)
    return out


def from_flat(flat: Dict[str, Any], convert: Callable = lambda v: v
              ) -> Dict[str, Any]:
    """Nested dict from '/'-joined keys (the inverse of
    ``flatten_with_paths`` for dict trees), ``convert`` on each leaf."""
    out: Dict[str, Any] = {}
    for key in sorted(flat):
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"key {key!r} nests under a leaf")
        node[parts[-1]] = convert(flat[key])
    return out


def to_numpy(v) -> np.ndarray:
    """A leaf as numpy (tensors are detached and moved to the host)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
