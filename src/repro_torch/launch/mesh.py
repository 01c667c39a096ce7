"""Mesh specs of the launcher: ``--mesh N`` or ``--mesh NxM``.

The counterpart of ``repro.launch.mesh`` (``make_mesh_by_name`` /
``node_axis_names``). The port has no device mesh: a mesh spec only
names how many edge nodes the run simulates, and the per-node executor
holds them as node blocks (``core/transport.py``). ``N`` is N nodes;
``NxM`` is N nodes with a ``model`` axis of M, and ``PxNxM`` adds a
``pod`` axis whose nodes multiply in, as in the JAX package. A model
axis above 1 (tensor parallelism inside a node) and the production pod
meshes raise: they need more than one GPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

__all__ = ["MeshSpec", "parse_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis sizes by name; ``n_nodes`` multiplies the node axes."""

    axes: Tuple[Tuple[str, int], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def node_axes(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes if a != "model")

    @property
    def n_nodes(self) -> int:
        return math.prod(size for a, size in self.axes if a != "model")


def parse_mesh(name: str) -> MeshSpec:
    """``N`` / ``NxM`` / ``PxNxM`` -> MeshSpec; TP meshes raise."""
    if name in ("single_pod", "16x16", "multi_pod", "2x16x16"):
        raise ValueError(
            f"mesh {name!r} is a TPU pod mesh with a model axis of 16: "
            "tensor parallelism needs more than one GPU and is not ported")
    try:
        dims = tuple(int(d) for d in name.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {name!r}: expected N, NxM or PxNxM") from None
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError(f"mesh {name!r}: expected N, NxM or PxNxM")
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(dims)]
    spec = MeshSpec(tuple(zip(axes, dims)))
    if spec.shape.get("model", 1) > 1:
        raise ValueError(
            f"mesh {name!r} has a model axis of {spec.shape['model']}: "
            "tensor parallelism needs more than one GPU and is not ported")
    return spec
