"""The ``model`` mesh axis: a node's model split into M shards.

The counterpart of the collectives GSPMD inserts on the JAX package's
``model`` axis (``launch --mesh NxM``: ``train/steps.INNER_RULES``
through ``sharding.MeshRules``). A shard holds its block of each split
leaf (``convert.shard_params``: the contiguous block JAX's
``NamedSharding`` gives that device) and computes with it alone; the
shards meet only through the collectives below, which count their calls
and bytes as the node transports count theirs (``core/transport.py``).

``StackModelAxis(m, device)`` holds the M shards of one node as a
stacked leading dimension on one device, as ``StackTransport`` holds the
nodes: a SHARDED tensor is (M, ...), shard i's block at ``[i]``; a
REPLICATED tensor (every shard holds the same value: the residual
stream, a norm's output) is held once, without the M dimension. A
process-group version (one shard per rank, L = 1 local shard) would
implement the same ``ModelAxis`` protocol; it is not ported (ROADMAP
Queue 1, item 4).

Megatron's pair of operators, as ``torch.autograd.Function``s:

* ``copy_in`` (*f*): a replicated tensor into every shard; identity
  forward, all-reduce (sum over the shards) backward;
* ``all_reduce`` (*g*): the shards' partial sums into one replicated
  tensor; all-reduce forward, identity backward (in the stack the sum's
  own gradient reaches every shard unchanged).

``all_gather`` (backward: a reduce-scatter) and ``all_max`` (no
gradient) complete the set. Every collective counts once where it runs,
forward or backward: ``calls[op]`` and ``bytes[op]``, the operand's
bytes over all M shards.
"""
from __future__ import annotations

from typing import Dict, Protocol

import torch

from repro_torch._device import resolve_device

__all__ = ["ModelAxis", "StackModelAxis", "OPS", "tp_collectives"]

OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_max")


class ModelAxis(Protocol):
    """What the tensor-parallel model code needs of a model axis."""

    size: int
    calls: Dict[str, int]
    bytes: Dict[str, int]

    def copy_in(self, x: torch.Tensor) -> torch.Tensor: ...

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor: ...

    def all_gather(self, x: torch.Tensor, dim: int = -1
                   ) -> torch.Tensor: ...

    def all_max(self, x: torch.Tensor) -> torch.Tensor: ...


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.unsqueeze(0).expand((axis.size,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, grad):
        ctx.axis._count("all_reduce", grad)
        return grad.sum(0), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        axis._count("all_gather", x)
        full = torch.cat(x.unbind(0), dim=dim)
        return full.unsqueeze(0).expand((axis.size,) + tuple(full.shape))

    @staticmethod
    def backward(ctx, grad):
        ctx.axis._count("reduce_scatter", grad)
        parts = grad.sum(0).chunk(ctx.axis.size, dim=ctx.dim)
        return torch.stack(parts), None, None


class StackModelAxis:
    """A node's M model shards as a stacked leading dimension on one
    device (the card unless the caller passes ``device="cpu"``)."""

    def __init__(self, m: int, device="cuda"):
        if m < 1:
            raise ValueError(f"model axis of {m}")
        self.size = int(m)
        self.device = resolve_device(device)
        self.reset_counters()

    def reset_counters(self) -> None:
        self.calls: Dict[str, int] = {op: 0 for op in OPS}
        self.bytes: Dict[str, int] = {op: 0 for op in OPS}

    def _count(self, op: str, x: torch.Tensor) -> None:
        self.calls[op] += 1
        self.bytes[op] += _nbytes(x)

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.size:
            raise ValueError(f"a model axis of {self.size} shards got a "
                             f"stack of {x.shape[0]}")

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's *f*: replicated (...) -> sharded (M, ...), every
        shard the same value; its gradient is all-reduced."""
        return _CopyIn.apply(x, self)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's *g*: the shards' partial sums (M, ...) -> their sum
        (...), replicated; identity backward."""
        self._check(x)
        self._count("all_reduce", x)
        return x.sum(0)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every shard's block concatenated along ``dim`` (a dimension
        of one shard's block), held by every shard: (M, ..., c, ...) ->
        (M, ..., M c, ...); backward a reduce-scatter."""
        self._check(x)
        return _AllGather.apply(x, self, dim if dim >= 0 else x.dim() - 1
                                + dim)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the shards, replicated, without a gradient."""
        self._check(x)
        self._count("all_max", x)
        return x.detach().amax(0)


def tp_collectives(cfg, m: int, batch: int, seq: int,
                   dtype: torch.dtype) -> Dict[str, Dict[str, int]]:
    """The model-axis collectives of one node's train-step gradient (the
    forward, ``lm_loss`` and the backward) of the dense decoder on an
    M-shard axis, from its layer list: {op: {"calls", "bytes"}}. Per
    attention layer with sharded query heads: the input's *f* (backward)
    and the output's *g* (forward); K and V all-gathered (forward) and
    reduce-scattered (backward) where a shard's query heads need KV
    heads outside its own block, or copied in from a replicated K / V;
    per MLP layer with a sharded ``w_up``: *f* and *g*; a vocab-split
    embedding's *g*, the logits' *f* and the loss's max, sum of
    exponentials and label logit (f32). ``cfg.remat`` recomputes each
    period's forward collectives in the backward."""
    from repro_torch.train.steps import param_shard_dims

    out = {op: {"calls": 0, "bytes": 0} for op in OPS}
    if m <= 1:
        return out
    dims = param_shard_dims(cfg, m)
    split = {k.rsplit("/", 1)[-1]: dims[k] is not None for k in dims
             if k.startswith("blocks/0/") or "/" not in k}
    elt = torch.tensor([], dtype=dtype).element_size()
    act = m * batch * seq * cfg.d_model * elt        # an (M, b, s, d) stack
    row = m * batch * seq * 4                        # an (M, b, s) f32 stack

    def add(op, nbytes, calls=1):
        out[op]["calls"] += calls
        out[op]["bytes"] += calls * nbytes

    fwd = 2 if cfg.remat else 1
    n_attn = sum(s.mixer in ("attn", "attn_local") for s in cfg.period) \
        * cfg.n_periods
    n_mlp = sum(s.ffn == "mlp" for s in cfg.period) * cfg.n_periods
    if split.get("wq"):
        add("all_reduce", act, n_attn)               # f backward
        add("all_reduce", act, n_attn * fwd)         # g forward
        kvc = cfg.n_kv_heads * cfg.resolved_head_dim * elt * batch * seq
        if split["wk"] and cfg.n_kv_heads % m:
            add("all_gather", kvc, 2 * n_attn * fwd)
            add("reduce_scatter", m * kvc, 2 * n_attn)
        elif not split["wk"]:
            add("all_reduce", m * kvc, 2 * n_attn)   # f backward, K and V
    if split.get("w_up"):
        add("all_reduce", act, 2 * n_mlp)            # f backward, g forward
        if cfg.remat:
            add("all_reduce", act, n_mlp)
    if split["embed"]:
        add("all_reduce", act)                       # the embedding's g
        add("all_reduce", act)                       # the logits' f
        add("all_max", row)
        add("all_reduce", row, 2)                    # sum of exp, label logit
    return out
