"""Mesh specs of the launcher: ``--mesh N``, ``NxM`` or ``PxNxM``.

The counterpart of ``repro.launch.mesh`` (``make_mesh_by_name`` /
``node_axis_names``). The port has no device mesh: a mesh spec names
how many edge nodes the run simulates and how wide each node's
``model`` axis is. The per-node executor holds the nodes as a node block
(``core/transport.py``); a model axis M > 1 splits each node's model
into M shards, held as a stack on the same device
(``core/model_axis.py``), with the ``model``-axis collectives between
them. ``PxNxM`` adds a ``pod`` axis whose nodes multiply in, as in the
JAX package. The production pod meshes (``16x16``, ``2x16x16`` and
their names) raise: a model axis across cards needs a model-axis
process group (ROADMAP Queue 1, item 4). The dry-run alone parses them
(``parse_mesh(name, pods=True)``): it traces one device on ``meta``
and needs no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

__all__ = ["MeshSpec", "parse_mesh", "make_mesh_by_name", "node_axis_names",
           "POD_MESHES"]

POD_MESHES = ("single_pod", "16x16", "multi_pod", "2x16x16")


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
    def model(self) -> int:
        """The model axis's size (1 without one)."""
        return self.shape.get("model", 1)

    @property
    def n_nodes(self) -> int:
        return math.prod(size for a, size in self.axes if a != "model")


def parse_mesh(name: str, pods: bool = False) -> MeshSpec:
    """``N`` / ``NxM`` / ``PxNxM`` -> MeshSpec; the pod meshes raise
    unless ``pods`` (the dry-run: ``single_pod`` is ``16x16``,
    ``multi_pod`` ``2x16x16``, as JAX's ``make_mesh_by_name``)."""
    if pods and name in POD_MESHES:
        name = {"single_pod": "16x16", "multi_pod": "2x16x16"}.get(name,
                                                                  name)
    elif name in POD_MESHES:
        raise ValueError(
            f"mesh {name!r} is a TPU pod mesh: its model axis of 16 spans "
            "16 chips, and a model axis across cards needs a model-axis "
            "process group, not ported (ROADMAP Queue 1, item 4)")
    try:
        dims = tuple(int(d) for d in name.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {name!r}: expected N, NxM or PxNxM") from None
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError(f"mesh {name!r}: expected N, NxM or PxNxM")
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(dims)]
    return MeshSpec(tuple(zip(axes, dims)))


def make_mesh_by_name(name: str) -> MeshSpec:
    """``repro.launch.mesh.make_mesh_by_name``: the mesh spec of a name."""
    return parse_mesh(name)


def node_axis_names(mesh: MeshSpec) -> Tuple[str, ...]:
    """The mesh's node axes (every axis but ``model``)."""
    return mesh.node_axes
