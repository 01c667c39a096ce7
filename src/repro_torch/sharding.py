"""Logical-axis sharding rules: which mesh axis splits each dimension.

Port of ``repro.sharding``. Parameters carry logical axis tuples
(``models/layers.ParamSpec.axes``); a ``MeshRules`` maps logical names
to mesh axes and gives each leaf its partition spec, the rules JAX's
``NamedSharding`` applies:

* a name mapped to None (or unmapped) is replicated;
* a mesh axis the mesh does not have is ignored (replicated);
* each mesh axis is used at most once in one spec;
* a dimension the mapped axes' size does not divide is replicated (the
  divisibility fallback: e.g. 4 KV heads over a 16-wide model axis);
* trailing replicated dimensions are dropped.

The port has no GSPMD: the specs decide how ``convert.shard_params``
splits a leaf over the ``model`` axis (``core/model_axis``) and which
leaves get wire-plane buckets of their own (``core/plane``).
``logical`` keeps the model's annotation sites and checks their rank;
there is no constraint to apply.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping, Optional, Sequence

__all__ = ["PartitionSpec", "MeshRules", "use_rules", "current_rules",
           "logical"]

_STATE = threading.local()


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per leading dimension, a
    mesh axis name, a tuple of names, or None (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"



class MeshRules:
    """mesh + {logical axis name -> mesh axis (str | tuple | None)}.
    ``mesh`` is a ``launch.mesh.MeshSpec`` or a {mesh axis: size}
    mapping."""

    def __init__(self, mesh, mapping: Mapping[str, Any]):
        self.mesh = mesh
        self.sizes = dict(mesh.shape if hasattr(mesh, "shape") else mesh)
        self.mapping = dict(mapping)

    def _axis_size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, (tuple, list)):
            out = 1
            for a in axis:
                out *= self.sizes[a]
            return out
        return self.sizes[axis]

    def spec(self, axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        """The partition spec of logical ``axes``, with the divisibility
        fallback when ``shape`` is given."""
        used: set = set()
        parts = []
        for i, name in enumerate(axes):
            mesh_axis = self.mapping.get(name) if name is not None else None
            if mesh_axis is None:
                parts.append(None)
                continue
            flat = tuple(mesh_axis) if isinstance(mesh_axis, (tuple, list)) \
                else (mesh_axis,)
            if any(a not in self.sizes for a in flat):
                parts.append(None)      # a mesh without this axis
                continue
            if any(a in used for a in flat):
                parts.append(None)      # each mesh axis once per spec
                continue
            if shape is not None and shape[i] % self._axis_size(mesh_axis):
                parts.append(None)      # replicate non-divisible dims
                continue
            used.update(flat)
            parts.append(tuple(flat) if len(flat) > 1 else flat[0])
        while parts and parts[-1] is None:
            parts.pop()
        return PartitionSpec(*parts)

    def split_dim(self, axes: Sequence[Optional[str]], shape: Sequence[int],
                  mesh_axis: str = "model") -> Optional[int]:
        """The dimension ``mesh_axis`` alone splits, or None."""
        spec = tuple(self.spec(axes, shape))
        return spec.index(mesh_axis) if mesh_axis in spec else None


def current_rules() -> Optional[MeshRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def logical(x, *axes: Optional[str]):
    """A logical-axes annotation of an activation: ``x`` itself (with
    rules installed, its rank is checked against the names)."""
    if current_rules() is not None and len(axes) != x.dim():
        raise ValueError(f"{len(axes)} logical axes {axes} for a tensor of "
                         f"shape {tuple(x.shape)}")
    return x
