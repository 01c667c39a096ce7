"""Coordinate-wise gradient clipping (paper §5, "Procedure for Privacy").

Port of ``repro.core.clipping``: ``clip(g)_i = sign(g_i) min(|g_i|, C)``,
an element-wise clamp to [-C, C] (the paper's ``max`` is a typo for
``min``). With C = G/sqrt(d) this enforces the l2-sensitivity bound
||g|| <= G of Theorem 1. ``clip_tree`` also emits the ``clip_bound``
tag (``core/tagging``), which carries C into the static auditor's trace
and is an identity outside it.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import tree as tree_mod
from repro_torch.core import tagging

__all__ = ["clip_coordinates", "clip_tree", "sensitivity_G"]


def clip_coordinates(g: torch.Tensor, c: float) -> torch.Tensor:
    """Element-wise clamp of each coordinate to [-c, c]."""
    return torch.clamp(g, -c, c)


def clip_tree(grads: Any, c: float) -> Any:
    """Clamp every leaf to [-c, c] and declare the bound c."""
    clipped = tree_mod.tree_map(lambda g: clip_coordinates(g, c), grads)
    return tagging.clip_bound(clipped, bound=c)


def sensitivity_G(c: float, d: int) -> float:
    """The l2-sensitivity bound of coordinate clip c over d coordinates:
    |g_i| <= c gives ||g||_2 <= c sqrt(d) (= G for c = G / sqrt(d))."""
    return c * math.sqrt(d)
