"""Coordinate-wise gradient clipping (paper §5, "Procedure for Privacy").

Port of ``repro.core.clipping``: ``clip(g)_i = sign(g_i) min(|g_i|, C)``,
an element-wise clamp to [-C, C] (the paper's ``max`` is a typo for
``min``). With C = G/sqrt(d) this enforces the l2-sensitivity bound
||g|| <= G of Theorem 1. The JAX version also emits a ``clip_bound``
tag, an identity that only its static analyzer reads; the port has no
analyzer and carries no tags.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as tree_mod

__all__ = ["clip_coordinates", "clip_tree"]


def clip_coordinates(g: torch.Tensor, c: float) -> torch.Tensor:
    """Element-wise clamp of each coordinate to [-c, c]."""
    return torch.clamp(g, -c, c)


def clip_tree(grads: Any, c: float) -> Any:
    """Clamp every leaf to [-c, c]."""
    return tree_mod.tree_map(lambda g: clip_coordinates(g, c), grads)
