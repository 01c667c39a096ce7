"""Wire plane: the whole differential as one contiguous padded buffer.

Port of ``repro.core.plane`` for the default flat bucket. The leaves of
a parameter tree (in JAX's sorted-key flatten order, see
``repro_torch.tree``) are concatenated row-major, cast to f32 and
zero-padded into one ``(rows, LANE)`` plane, so the compressor draws,
top-k and wire accounting run once per plane instead of once per leaf:

    ParamPlane.for_tree(tree)   ->  static layout spec (hashable)
    spec.pack(tree)             ->  tuple of (rows, LANE) f32 planes
    spec.unpack(planes)         ->  tree (original shapes/dtypes)

Pad coordinates are zero on entry and stay zero through every
compressor roundtrip, but they ride the wire, so the accounting charges
the plane-padded shape (``shape_dtype``).

``for_tree(tree, lane=, row_multiple=)`` lays the flat bucket out at
another width and pads its rows to a multiple (the fused-update kernel's
(rows, 1024) layout with rows % block_rows == 0). The JAX package's
``use_buckets`` context, which gives tensor-parallel leaves planes of
their own, belongs to the LM train path and is not ported yet: every
tree here packs into the single flat bucket (``buckets=None``).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Tuple

import torch

from repro_torch import tree as tree_mod

__all__ = ["LANE", "PlaneBucket", "ParamPlane", "ShapeDtype"]

PyTree = Any

# Wire-plane lane width (one TPU vector lane in the JAX package; kept so
# both packages lay out and draw over identical planes).
LANE = 128


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of a leaf, without data (``jax.ShapeDtypeStruct``);
    a leaf of ``repro_torch.tree``, not a container."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class PlaneBucket:
    """One plane of the layout: the leaves it packs, in order."""

    lane: int
    leaves: Tuple[int, ...]        # member leaf indices (flatten order)
    sizes: Tuple[int, ...]         # flat element count per member
    rows: int                      # padded row count

    @property
    def size(self) -> int:
        return sum(self.sizes)

    @property
    def padded_size(self) -> int:
        return self.rows * self.lane

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.lane)


_SPECS: dict = {}
_SPECS_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class ParamPlane:
    """Static flatten/unflatten layout of a parameter tree."""

    structure: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    buckets: Tuple[PlaneBucket, ...]

    @classmethod
    def for_tree(cls, tree: PyTree, *, lane: int = LANE,
                 row_multiple: int = 1, buckets=None) -> "ParamPlane":
        """The (cached) layout of ``tree``; leaves may be tensors or
        ``ShapeDtype``s (only shape and dtype are read). The flat bucket
        is ``lane`` wide with its rows padded to a multiple of
        ``row_multiple`` (at least ``row_multiple`` rows)."""
        if buckets is not None:
            raise NotImplementedError(
                "bucket key trees (tensor-parallel planes) are not ported")
        if lane < 1 or row_multiple < 1:
            raise ValueError(f"lane {lane} and row_multiple {row_multiple} "
                             "must be positive")
        leaves, struct = tree_mod.flatten(tree)
        shapes = tuple(tuple(int(d) for d in l.shape) for l in leaves)
        dtypes = tuple(l.dtype for l in leaves)
        key = (struct, shapes, dtypes, lane, row_multiple)
        with _SPECS_LOCK:
            spec = _SPECS.get(key)
            if spec is None:
                sizes = tuple(math.prod(s) for s in shapes)
                step = lane * row_multiple
                rows = max(-(-sum(sizes) // step) * row_multiple,
                           row_multiple)
                bucket = PlaneBucket(lane=lane,
                                     leaves=tuple(range(len(shapes))),
                                     sizes=sizes, rows=rows)
                spec = cls(structure=struct, shapes=shapes, dtypes=dtypes,
                           buckets=(bucket,))
                _SPECS[key] = spec
        return spec

    @classmethod
    def for_stacked(cls, stack: PyTree, **kw) -> "ParamPlane":
        """Layout of a node-stacked tree: leaves lose their leading axis."""
        per_node = tree_mod.tree_map(
            lambda v: ShapeDtype(tuple(v.shape[1:]), v.dtype), stack)
        return cls.for_tree(per_node, **kw)

    # -- geometry ----------------------------------------------------------
    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_size(self) -> int:
        """Unpadded element count over the whole tree."""
        return sum(b.size for b in self.buckets)

    @property
    def padded_size(self) -> int:
        return sum(b.padded_size for b in self.buckets)

    def plane_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(b.shape for b in self.buckets)

    def shape_dtype(self, dtype=torch.float32) -> Tuple[ShapeDtype, ...]:
        """Plane templates -- also the tree wire accounting runs over."""
        return tuple(ShapeDtype(b.shape, dtype) for b in self.buckets)

    # -- pack / unpack (a leading batch of ``lead`` dims rides along) ------
    def _pack(self, tree: PyTree, lead: int) -> Tuple[torch.Tensor, ...]:
        leaves = tree_mod.leaves(tree)
        if len(leaves) != len(self.shapes):
            raise ValueError(f"tree has {len(leaves)} leaves, spec expects "
                             f"{len(self.shapes)}")
        out = []
        for b in self.buckets:
            first = leaves[b.leaves[0]]
            batch = tuple(first.shape[:lead])
            # each leaf is converted straight into its slice of the zero
            # plane: no f32 copy of the leaves beside the plane
            flat = torch.zeros(batch + (b.padded_size,), dtype=torch.float32,
                               device=first.device)
            off = 0
            for i, size in zip(b.leaves, b.sizes):
                flat[..., off:off + size] = leaves[i].reshape(batch + (-1,))
                off += size
            out.append(flat.reshape(batch + b.shape))
        return tuple(out)

    def _unpack(self, planes, lead: int) -> PyTree:
        if len(planes) != len(self.buckets):
            raise ValueError(f"{len(planes)} planes for "
                             f"{len(self.buckets)} buckets")
        leaves: list = [None] * len(self.shapes)
        for b, plane in zip(self.buckets, planes):
            batch = tuple(plane.shape[:lead])
            flat = plane.reshape(batch + (-1,))
            off = 0
            for i, size in zip(b.leaves, b.sizes):
                leaves[i] = flat[..., off:off + size].reshape(
                    batch + self.shapes[i]).to(self.dtypes[i])
                off += size
        return tree_mod.unflatten(self.structure, leaves)

    def pack(self, tree: PyTree) -> Tuple[torch.Tensor, ...]:
        """The tree as its plane tuple (f32, zero-padded)."""
        return self._pack(tree, 0)

    def unpack(self, planes) -> PyTree:
        """The planes sliced back into the tree (shapes + dtypes)."""
        return self._unpack(planes, 0)

    def pack_stacked(self, stack: PyTree) -> Tuple[torch.Tensor, ...]:
        """Per-node pack of a node-stacked tree -> (n, rows, lane) planes."""
        return self._pack(stack, 1)

    def unpack_stacked(self, planes) -> PyTree:
        return self._unpack(planes, 1)
