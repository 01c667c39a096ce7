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
nodes: a SHARDED tensor is (L, ...), local shard j's block at ``[j]``
(L = M here: every shard is local); a REPLICATED tensor (every shard
holds the same value: the residual stream, a norm's output) is held
once, without the L dimension. ``size`` is M, the axis's width;
``local`` is L, the length of a sharded stack; ``held`` (a tuple) and
``shard_ids`` (a tensor) the global index of each local shard.

``ShardModelAxis(m, index)`` holds ONE shard of M (L = 1) on ``meta``:
the dry-run's axis (``launch/dryrun``), whose collectives give the
shapes one device sees and count that device's bytes, so that a trace
over it is one device's work. On data it would be a process group's
axis (one shard per rank), which is not ported (ROADMAP Queue 1, item
4): it takes ``meta`` tensors only.

Megatron's pair of operators, as ``torch.autograd.Function``s:

* ``copy_in`` (*f*): a replicated tensor into every shard; identity
  forward, all-reduce (sum over the shards) backward;
* ``all_reduce`` (*g*): the shards' partial sums into one replicated
  tensor; all-reduce forward, identity backward (in the stack the sum's
  own gradient reaches every shard unchanged).

``all_gather`` (backward: a reduce-scatter) and ``all_max`` (no
gradient) complete the set. Every collective counts once where it runs,
forward or backward: ``calls[op]`` and ``bytes[op]``, the operand's
bytes over the local shards (all M in the stack, one device's on a
``ShardModelAxis``).

``tp_collectives`` and ``tp_serving_collectives`` are the closed-form
counts of the train step's gradient and of the serving steps
(``train/steps.make_prefill_fn`` / ``make_decode_fn``) on a stack.
"""
from __future__ import annotations

from typing import Dict, Protocol, Tuple

import torch

from repro_torch._device import resolve_device

__all__ = ["ModelAxis", "StackModelAxis", "ShardModelAxis", "OPS",
           "tp_collectives", "tp_serving_collectives"]

OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_max")


class ModelAxis(Protocol):
    """What the tensor-parallel model code needs of a model axis."""

    size: int
    local: int
    held: Tuple[int, ...]
    calls: Dict[str, int]
    bytes: Dict[str, int]

    def shard_ids(self, device) -> torch.Tensor: ...

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
        return x.unsqueeze(0).expand((axis.local,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, grad):
        ctx.axis._count("all_reduce", grad)
        return grad.sum(0), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        axis._count("all_gather", x)
        full = axis._gather_blocks(x, dim)
        return full.unsqueeze(0).expand((axis.local,) + tuple(full.shape))

    @staticmethod
    def backward(ctx, grad):
        ctx.axis._count("reduce_scatter", grad)
        return ctx.axis._scatter_blocks(grad.sum(0), ctx.dim), None, None


class _AxisBase:
    """Counters and the collectives over a stack of ``local`` shards."""

    size: int
    local: int

    def reset_counters(self) -> None:
        self.calls: Dict[str, int] = {op: 0 for op in OPS}
        self.bytes: Dict[str, int] = {op: 0 for op in OPS}

    def _count(self, op: str, x: torch.Tensor) -> None:
        self.calls[op] += 1
        self.bytes[op] += _nbytes(x)

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.local:
            raise ValueError(f"a model axis holding {self.local} shards "
                             f"got a stack of {x.shape[0]}")

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's *f*: replicated (...) -> sharded (L, ...), every
        shard the same value; its gradient is all-reduced."""
        return _CopyIn.apply(x, self)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's *g*: the shards' partial sums (L, ...) -> their sum
        (...), replicated; identity backward."""
        self._check(x)
        self._count("all_reduce", x)
        return x.sum(0)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every shard's block concatenated along ``dim`` (a dimension
        of one shard's block), held by every shard: (L, ..., c, ...) ->
        (L, ..., M c, ...); backward a reduce-scatter."""
        self._check(x)
        return _AllGather.apply(x, self, dim if dim >= 0 else x.dim() - 1
                                + dim)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the shards, replicated, without a gradient."""
        self._check(x)
        self._count("all_max", x)
        return x.detach().amax(0)


class StackModelAxis(_AxisBase):
    """A node's M model shards as a stacked leading dimension on one
    device (the card unless the caller passes ``device="cpu"``)."""

    def __init__(self, m: int, device="cuda"):
        if m < 1:
            raise ValueError(f"model axis of {m}")
        self.size = self.local = int(m)
        self.device = resolve_device(device)
        self.reset_counters()

    @property
    def held(self) -> Tuple[int, ...]:
        return tuple(range(self.size))

    def shard_ids(self, device) -> torch.Tensor:
        return torch.arange(self.size, device=device)

    def _gather_blocks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(x.unbind(0), dim=dim)

    def _scatter_blocks(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.stack(g.chunk(self.size, dim=dim))


class ShardModelAxis(_AxisBase):
    """Shard ``index`` of an M-shard model axis, alone (L = 1), on
    ``meta``: what one device of the axis holds and sends. The all-
    reduce and the max return the local operand's shape, the all-gather
    its local block in every position (values are not computed on
    ``meta``); each counts the one device's operand."""

    def __init__(self, m: int, index: int = 0, device="meta"):
        if m < 1 or not 0 <= index < m:
            raise ValueError(f"shard {index} of a model axis of {m}")
        dev = resolve_device(device, allow_meta=True)
        if dev.type != "meta":
            raise ValueError(
                "a one-shard model axis on data needs a model-axis process "
                "group, not ported (ROADMAP Queue 1, item 4); it takes "
                "meta tensors only")
        self.size, self.local, self.index = int(m), 1, int(index)
        self.device = dev
        self.reset_counters()

    @property
    def held(self) -> Tuple[int, ...]:
        return (self.index,)

    def shard_ids(self, device) -> torch.Tensor:
        return torch.full((1,), self.index, device=device)

    def _gather_blocks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat([x[0]] * self.size, dim=dim)

    def _scatter_blocks(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        return g.chunk(self.size, dim=dim)[self.index].unsqueeze(0)


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


def tp_serving_collectives(cfg, m: int, batch: int, seq: int, kind: str,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> Dict[str, Dict[str, int]]:
    """The model-axis collectives of one serving step of the dense
    decoder over an M-shard stack, ``batch`` rows of ``seq`` new tokens
    (``train/steps.make_prefill_fn`` / ``make_decode_fn``): {op:
    {"calls", "bytes"}}, from the layer list. ``kind`` names the cache's
    layout: "prefill" (split by KV heads where M divides them, else
    whole) or "decode" (split by positions: the flash-decoding layout,
    also under ``shard_cache_seq``, where the merge spans the node axis
    and still counts once; a cache length M does not divide falls back
    to the prefill layout). Per attention layer: the output's all-reduce;
    a whole cache all-gathers K and V where ``wk`` is split; split by
    positions, the query heads and (where ``wk`` is split) K and V are
    all-gathered, then the partials' max (f32) and one all-reduce of
    their sums and weighted sums (f32, head_dim + 1 a head). Per MLP
    layer with a sharded ``w_up``: the all-reduce; a vocab-split
    embedding's all-reduce. No gradient: *f* counts nothing."""
    from repro_torch.train.steps import param_shard_dims

    out = {op: {"calls": 0, "bytes": 0} for op in OPS}
    if m <= 1:
        return out
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind {kind!r}: expected 'prefill' or 'decode'")
    dims = param_shard_dims(cfg, m)
    split = {k.rsplit("/", 1)[-1]: dims[k] is not None for k in dims
             if k.startswith("blocks/0/") or "/" not in k}
    elt = torch.tensor([], dtype=dtype).element_size()
    hd, h, kvh = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    tokens = batch * seq
    act = m * tokens * cfg.d_model * elt            # an (M, b, s, d) stack

    def add(op, nbytes, calls=1):
        out[op]["calls"] += calls
        out[op]["bytes"] += calls * nbytes

    n_attn = sum(s.mixer in ("attn", "attn_local") for s in cfg.period) \
        * cfg.n_periods
    n_mlp = sum(s.ffn == "mlp" for s in cfg.period) * cfg.n_periods
    if split.get("wq"):
        add("all_reduce", act, n_attn)               # g of wo
        kv_gather = split["wk"] and (kind == "decode" or kvh % m)
        if kv_gather:
            add("all_gather", tokens * kvh * hd * elt, 2 * n_attn)
        if kind == "decode":
            add("all_gather", tokens * h * hd * elt, n_attn)
            add("all_max", m * tokens * h * 4, n_attn)
            add("all_reduce", m * tokens * h * (hd + 1) * 4, n_attn)
    if split.get("w_up"):
        add("all_reduce", act, n_mlp)
    if split["embed"]:
        add("all_reduce", act)
    return out
