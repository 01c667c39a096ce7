"""Carry a JAX parameter tree over to the port.

The port keeps the JAX package's parameter layout, so conversion is a
renaming: the flat '/'-keyed numpy dict that ``checkpoint.load_flat``
returns for a raw params checkpoint (or that a test builds from
``jax.tree_util.tree_flatten_with_path(params)``) becomes the port's
nested dict of tensors. ``params_from_jax`` checks the keys and shapes
of a transformer config; ``tree_from_jax`` carries any tree (the vision
models' parameters, a node stack, an optimizer or method state) leaf for
leaf, layouts unchanged (HWIO conv weights stay HWIO).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch._device import resolve_device
from repro_torch.checkpoint.npz import as_float_array
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Params, flat_specs, unflatten

__all__ = ["params_from_jax", "tree_from_jax"]


def params_from_jax(flat: Dict[str, np.ndarray], cfg: ModelConfig, *,
                    device="cuda", dtype: torch.dtype = torch.float32
                    ) -> Params:
    """The port's parameters from a flat '/'-keyed numpy dict of the JAX
    parameter tree. Raises ``KeyError`` on a missing key and
    ``ValueError`` on a misshapen one. bfloat16 leaves (raw 2-byte void
    data in an npz) are read without ``ml_dtypes``."""
    dev = resolve_device(device)
    out = {}
    for key, spec in flat_specs(cfg):
        if key not in flat:
            raise KeyError(f"parameter {key!r} missing from the JAX tree "
                           f"(has {sorted(flat)[:4]}...)")
        arr = as_float_array(np.asarray(flat[key]))
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"parameter {key!r}: shape {arr.shape} != "
                             f"{spec.shape} -- wrong config?")
        out[key] = torch.tensor(arr, dtype=dtype, device=dev)
    return unflatten(out)


def tree_from_jax(flat: Dict[str, np.ndarray], *, device="cuda") -> Dict:
    """The port's nested dict of tensors from a flat '/'-keyed numpy dict
    of a JAX tree (``{"w": .., "b": ..}``, ``{"x/w": .., "s/w": ..}``).
    Every leaf keeps its shape and dtype (bfloat16 void leaves are read
    as float32); nothing is transposed."""
    dev = resolve_device(device)
    return tree_mod.from_flat(
        flat, lambda a: torch.tensor(as_float_array(np.asarray(a)),
                                     device=dev))
