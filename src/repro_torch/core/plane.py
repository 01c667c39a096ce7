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
(rows, 1024) layout with rows % block_rows == 0).

Buckets: leaves may carry a bucket key (``use_buckets``). A leaf whose
key is ``None`` joins the default flat bucket; leaves keyed ``(mesh
axis, cols)`` -- their trailing dimension splits over the model axis --
group into one plane per distinct (key, trailing dim) whose lane IS that
trailing dim, packed as stacked rows ``(size // cols, cols)``, so the
plane's lane dimension keeps the leaf's model-axis split. Buckets come
in order of first appearance in flatten order, as JAX's ``_build`` lays
them out; the compressor draws fold the bucket index in, so the layout
must be JAX's exactly. The train-step factory (``train/steps``) owns the
policy and installs the key tree around the step (``use_buckets``);
with no context every tree packs into the single flat bucket.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tree_mod

__all__ = ["LANE", "PlaneBucket", "ParamPlane", "ShapeDtype", "use_buckets",
           "current_bucket_keys", "bucket_keys_from_axes"]

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


# --------------------------------------------------------------------------
# Bucket-key context: the train-step factory owns the sharding policy.
# --------------------------------------------------------------------------

_STATE = threading.local()


def _key_walk(t, out):
    """A key tree's structure as ``tree.flatten`` gives a parameter
    tree's (dicts in sorted order; a key leaf -- None or a tuple -- is
    one leaf)."""
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys, tuple(_key_walk(t[k], out) for k in keys))
    out.append(t)
    return "*"


@contextlib.contextmanager
def use_buckets(keys_tree):
    """Install a per-leaf bucket-key tree for ``ParamPlane.for_tree``:
    a nested dict congruent with the parameter tree, each leaf a tuple
    key (e.g. ``('model', cols)``) or ``None`` (the flat bucket); a
    ``keys_tree`` of None installs nothing."""
    prev = getattr(_STATE, "buckets", None)
    if keys_tree is None:
        _STATE.buckets = None
    else:
        leaves: list = []
        struct = _key_walk(keys_tree, leaves)
        _STATE.buckets = (struct, tuple(leaves))
    try:
        yield
    finally:
        _STATE.buckets = prev


def current_bucket_keys(structure) -> Optional[Tuple]:
    """The installed keys (None when none are installed). Raises when the
    installed key tree does not have ``structure``: a plane built for
    another tree inside the context would silently take the flat layout
    (JAX's ``current_bucket_keys`` returns None there)."""
    ctx = getattr(_STATE, "buckets", None)
    if ctx is None:
        return None
    if ctx[0] != structure:
        raise ValueError("the installed bucket keys (use_buckets) are not "
                         "of this tree's structure")
    return ctx[1]


def bucket_keys_from_axes(axes_tree, shapes_tree, mapping):
    """Bucket keys from logical-axis tuples (the train step's policy): a
    leaf whose LAST logical axis maps to a mesh axis gets ``(mesh_axis,
    trailing dim)``; every other leaf None. Both trees are nested dicts
    of the parameters' structure."""
    if isinstance(axes_tree, dict):
        return {k: bucket_keys_from_axes(axes_tree[k], shapes_tree[k],
                                         mapping) for k in axes_tree}
    axes, shape = axes_tree, shapes_tree
    if not axes or not shape:
        return None
    mesh_axis = mapping.get(axes[-1]) if axes[-1] is not None else None
    if mesh_axis is None:
        return None
    if isinstance(mesh_axis, (tuple, list)):
        mesh_axis = tuple(mesh_axis)
    return (mesh_axis, int(shape[-1]))


@dataclasses.dataclass(frozen=True)
class PlaneBucket:
    """One plane of the layout: the leaves it packs, in order."""

    key: Any                       # None = the default flat bucket
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


def _build(shapes, keys, lane: int, row_multiple: int
           ) -> Tuple[PlaneBucket, ...]:
    """JAX's ``ParamPlane._build``: buckets in order of first appearance
    in flatten order; the flat bucket ``lane`` wide, a keyed bucket as
    wide as its leaves' trailing dim, rows padded to ``row_multiple``."""
    groups: dict = {}
    for i, (shape, key) in enumerate(zip(shapes, keys)):
        size = math.prod(shape)
        if key is not None:
            cols = shape[-1] if shape else 1
            if cols < 1 or size % cols:
                raise ValueError(f"bucket {key!r}: leaf {i} shape {shape} "
                                 "has no whole trailing-dim rows")
            gkey = ("k", key, cols)
        else:
            gkey = ("flat",)
        groups.setdefault(gkey, []).append((i, size))
    out = []
    for gkey, members in groups.items():     # dicts keep first appearance
        idxs = tuple(i for i, _ in members)
        sizes = tuple(n for _, n in members)
        total = sum(sizes)
        if gkey[0] == "flat":
            key, b_lane = None, lane
            rows = max(-(-total // (lane * row_multiple)) * row_multiple,
                       row_multiple)
        else:
            _, key, b_lane = gkey
            rows = max(-(-(total // b_lane) // row_multiple) * row_multiple,
                       row_multiple)
        out.append(PlaneBucket(key=key, lane=b_lane, leaves=idxs,
                               sizes=sizes, rows=rows))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ParamPlane:
    """Static flatten/unflatten layout of a parameter tree."""

    structure: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    buckets: Tuple[PlaneBucket, ...]

    @classmethod
    def for_tree(cls, tree: PyTree, *, lane: int = LANE,
                 row_multiple: int = 1, buckets="auto") -> "ParamPlane":
        """The (cached) layout of ``tree``; leaves may be tensors or
        ``ShapeDtype``s (only shape and dtype are read). The flat bucket
        is ``lane`` wide, a keyed bucket as wide as its leaves' trailing
        dim; each bucket's rows are padded to a multiple of
        ``row_multiple`` (at least ``row_multiple`` rows).
        ``buckets="auto"`` consults the ``use_buckets`` context (none:
        one flat bucket); ``None`` forces the flat bucket."""
        if lane < 1 or row_multiple < 1:
            raise ValueError(f"lane {lane} and row_multiple {row_multiple} "
                             "must be positive")
        leaves, struct = tree_mod.flatten(tree)
        shapes = tuple(tuple(int(d) for d in l.shape) for l in leaves)
        dtypes = tuple(l.dtype for l in leaves)
        if buckets not in ("auto", None):
            raise ValueError(f"buckets={buckets!r}: 'auto' or None")
        keys = current_bucket_keys(struct) if buckets == "auto" else None
        keys = keys or (None,) * len(leaves)
        cache_key = (struct, shapes, dtypes, keys, lane, row_multiple)
        with _SPECS_LOCK:
            spec = _SPECS.get(cache_key)
            if spec is None:
                spec = cls(structure=struct, shapes=shapes, dtypes=dtypes,
                           buckets=_build(shapes, keys, lane, row_multiple))
                _SPECS[cache_key] = spec
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
