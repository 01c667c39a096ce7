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
stay whole. With ``index`` they give or take one shard alone, (1,) +
its block (``core/model_axis.ShardModelAxis``, the dry-run's one
device).

``shard_cache`` / ``unshard_cache`` do the same for a dense KV cache
(``transformer.init_cache``), by ``transformer.cache_logical_axes``
under a serving step's rules (``train/steps.serving_rules``): prefill
splits ``kv_heads`` (shard i holds KV heads [i kvh/M, (i+1) kvh/M) of
every position), decode splits ``cache_seq`` (shard i holds positions
[i L/M, (i+1) L/M) of every KV head: the flash-decoding layout), and
``shard_cache_seq`` splits ``cache_seq`` over ("data", "model") into
N M blocks, block d M + i on device (d, i) as JAX lays it out; shard i
then holds its N blocks in node order, (layers, M, b, N L/(N M), kvh,
hd). A dimension the rules leave whole (the divisibility fallback)
keeps the cache whole. The batch stays whole: the port holds every
node's rows on one device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch._device import resolve_device
from repro_torch.checkpoint.npz import as_float_array
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Cache, Params,
                                            check_tensor_parallel,
                                            flat_specs, unflatten)

__all__ = ["params_from_jax", "tree_from_jax", "shard_params",
           "unshard_params", "shard_cache", "unshard_cache", "cache_split",
           "node_blocks"]


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


def shard_params(params: Params, cfg: ModelConfig, m: int,
                 index: Optional[int] = None) -> Params:
    """Whole leaves -> the model-axis layout of ``m`` shards (copies);
    with ``index``, that shard alone, (1,) + its block."""
    if index is None:
        return _by_key(params, cfg, m, lambda v, k, lead: torch.stack(
            v.chunk(m, dim=k), dim=lead))
    return _by_key(params, cfg, m, lambda v, k, lead: v.chunk(
        m, dim=k)[index].unsqueeze(lead).clone())


def unshard_params(params: Params, cfg: ModelConfig, m: int,
                   index: Optional[int] = None) -> Params:
    """The model-axis layout of ``m`` shards -> whole leaves (copies).
    With ``index`` (one shard, (1,) + its block) the whole shapes come
    back with that block in every position: what a trace on ``meta``
    needs of them, and wrong values on data, so it takes ``meta``
    leaves only."""
    if index is None:
        return _by_key(params, cfg, m, lambda v, k, lead: torch.cat(
            v.unbind(lead), dim=k))
    if any(v.device.type != "meta" for v in tree_mod.leaves(params)):
        raise ValueError("unshard_params(index=) repeats one shard's block "
                         "into the whole shape; it takes meta tensors only")
    return _by_key(params, cfg, m, lambda v, k, lead: torch.cat(
        [v.select(lead, 0)] * m, dim=k))


def cache_split(cfg: ModelConfig, rules, batch: int,
                max_len: int) -> Tuple[Optional[int], int]:
    """(the dimension of an attention cache leaf (layers, b, L, kvh, hd)
    that ``rules`` split over ``model``, 2 or 3, or None; the node
    blocks of that split: N where ``cache_seq`` goes over ("data",
    "model"), else 1)."""
    axes = ("layers", "batch", "cache_seq", "kv_heads", None)
    shape = (cfg.n_periods, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    for dim, part in enumerate(rules.spec(axes, shape)):
        if "model" in (part if isinstance(part, tuple) else (part,)):
            if dim not in (2, 3):
                raise ValueError(
                    f"rules split cache dimension {axes[dim]!r} over "
                    "'model': the port's attention splits a cache by "
                    "positions or by KV heads only")
            return dim, node_blocks(rules, part)
    return None, 1


def node_blocks(rules, part) -> int:
    """The node blocks of a dimension mapped to ``part`` (a mesh axis or
    a tuple of them): the product of its axes other than ``model``."""
    nodes = 1
    for a in (part if isinstance(part, tuple) else (part,)):
        if a not in (None, "model"):
            nodes *= rules.sizes.get(a, 1)
    return nodes


def shard_cache(cache: Cache, cfg: ModelConfig, rules,
                index: Optional[int] = None) -> Cache:
    """A whole dense cache -> its model-axis layout under ``rules``
    (copies; a whole leaf is kept as it is). With ``index``, shard
    ``index`` alone, (layers, 1, ...) (node 0's block under
    ``shard_cache_seq``): one device's cache."""
    check_tensor_parallel(cfg)          # attention slots only
    m = rules.sizes.get("model", 1)
    slots = {}
    for slot, kv in cache.slots.items():
        dim, nodes = cache_split(cfg, rules, kv.k.shape[1], kv.k.shape[2])

        def split(t):
            if dim is None or m == 1:
                return t
            if dim == 3:
                parts = t.chunk(m, dim=3)
                if index is not None:
                    return parts[index].unsqueeze(1).clone()
                return torch.stack(parts, dim=1)
            n, b, length = t.shape[:3]
            blocks = t.reshape((n, b, nodes, m, length // (nodes * m))
                               + tuple(t.shape[3:]))
            if index is not None:
                return blocks[:, :, 0, index].unsqueeze(1).clone()
            return blocks.movedim(3, 1).reshape(
                (n, m, b, length // m) + tuple(t.shape[3:]))

        slots[slot] = type(kv)(*(split(t) for t in kv))
    return Cache(slots=slots, offset=cache.offset)


def unshard_cache(cache: Cache, cfg: ModelConfig, rules) -> Cache:
    """The model-axis layout of a dense cache under ``rules`` -> whole
    leaves (copies)."""
    check_tensor_parallel(cfg)
    m = rules.sizes.get("model", 1)
    slots = {}
    for slot, kv in cache.slots.items():
        whole = kv.k.dim() == 5
        b = kv.k.shape[1] if whole else kv.k.shape[2]
        length = kv.k.shape[2] if whole else (
            kv.k.shape[3] * (m if kv.k.shape[4] == cfg.n_kv_heads else 1))
        dim, nodes = cache_split(cfg, rules, b, length)

        def join(t):
            if whole:
                return t
            if dim == 3:
                return torch.cat(t.unbind(1), dim=3)
            n = t.shape[0]
            blocks = t.reshape((n, m, b, nodes, length // (nodes * m))
                               + tuple(t.shape[4:]))
            return blocks.movedim(1, 3).reshape(
                (n, b, length) + tuple(t.shape[4:]))

        slots[slot] = type(kv)(*(join(t) for t in kv))
    return Cache(slots=slots, offset=cache.offset)
