"""Carry a JAX parameter tree over to the port.

The port keeps the JAX package's parameter layout, so conversion is a
renaming: the flat '/'-keyed numpy dict that ``checkpoint.load_flat``
returns for a raw params checkpoint (or that a test builds from
``jax.tree_util.tree_flatten_with_path(params)``) becomes the port's
nested dict of tensors. ``params_from_jax`` checks the keys and shapes
of a transformer config; ``tree_from_jax`` carries any tree (the vision
models' parameters, a node stack, an optimizer or method state) leaf for
leaf, layouts unchanged (HWIO conv weights stay HWIO).

``shard_params`` / ``unshard_params`` move a parameter tree's whole
leaves into the model-axis layout of a model axis of M shards and back:
a leaf that ``INNER_RULES`` splits over ``model`` (dimension k, by
``train.steps.param_shard_dims``) becomes a stack of M shards, shard i
the i-th contiguous block of dimension k (the block JAX's
``NamedSharding`` gives device i), the shard dimension first -- after
the ``layers`` dimension for the stacked block leaves, so that a
period's view is (M,) + its shard; the divisibility fallback's leaves
stay whole.
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

__all__ = ["params_from_jax", "tree_from_jax", "shard_params",
           "unshard_params"]


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


def _lead(key: str) -> int:
    """Where a leaf's shard dimension goes: after the layers dimension of
    a stacked block leaf, first otherwise."""
    return 1 if key.startswith(("blocks/", "encoder/layers/")) else 0


def _by_key(params: Params, cfg: ModelConfig, m: int, fn) -> Params:
    from repro_torch.train.steps import param_shard_dims

    dims = param_shard_dims(cfg, m)
    flat = tree_mod.flatten_with_paths(params)
    if sorted(flat) != sorted(dims):
        raise KeyError(f"the tree's keys are not {cfg.name}'s parameters")
    return unflatten({k: v if dims[k] is None else fn(v, dims[k], _lead(k))
                      for k, v in flat.items()})


def shard_params(params: Params, cfg: ModelConfig, m: int) -> Params:
    """Whole leaves -> the model-axis layout of ``m`` shards (copies)."""
    return _by_key(params, cfg, m, lambda v, k, lead: torch.stack(
        v.chunk(m, dim=k), dim=lead))


def unshard_params(params: Params, cfg: ModelConfig, m: int) -> Params:
    """The model-axis layout of ``m`` shards -> whole leaves (copies)."""
    return _by_key(params, cfg, m, lambda v, k, lead: torch.cat(
        v.unbind(lead), dim=k))
