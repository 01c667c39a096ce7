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


def _slot_splits(cfg, m: int):
    """Per layer slot of the period, {sublayer/leaf: split over the model
    axis}; whether the embedding is split; the same map of an encoder
    layer ({} without an encoder)."""
    from repro_torch.train.steps import param_shard_dims

    dims = param_shard_dims(cfg, m)

    def under(prefix):
        return {k[len(prefix):]: dims[k] is not None for k in dims
                if k.startswith(prefix)}

    return ([under(f"blocks/{si}/") for si in range(len(cfg.period))],
            dims["embed"] is not None, under("encoder/layers/"))



def _elt(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def tp_collectives(cfg, m: int, batch: int, seq: int,
                   dtype: torch.dtype) -> Dict[str, Dict[str, int]]:
    """The model-axis collectives of one node's train-step gradient (the
    forward, ``lm_loss`` and the backward) on an M-shard axis, from the
    layer list: {op: {"calls", "bytes"}}. Per attention layer with
    sharded query heads: the input's *f* (backward) and the output's *g*
    (forward); where M cuts the heads (the split inside a head) Q
    all-gathered (forward) and reduce-scattered (backward); K and V
    all-gathered and reduce-scattered where a shard's query heads need
    KV heads outside its own block, or copied in from a replicated K /
    V. Per MLP layer with a
    sharded ``w_up``: *f* and *g*. Per MoE layer with sharded experts
    (by experts, or by ``mlp`` in the fallback): the rows' *f*, the
    slot gates' *f* (an (M, e, capacity) f32 stack) and the combine's
    *g*. Per mamba layer with a split ``w_in``: the input's *f*, the
    blocks of its product all-gathered (reduce-scattered backward); with
    split channels also the ``w_x_dbc`` partials' all-reduce and its *f*
    (backward), the output's *g*. Per rwkv time mix with split heads: the
    normed input's *f* (backward) and ``w_out``'s *g*; where M cuts the
    heads also r, k and the decay's projection all-gathered (reduce-
    scattered backward). Per rwkv channel
    mix with a split weight: the input's *f* (backward); with a split
    ``w_k`` the ``w_v`` partials' *g*; with a split ``w_r`` its product
    all-gathered (reduce-scattered backward). Per cross-attention layer
    with split query heads (``transformer.context_len(cfg)`` context rows
    a sample): the queries' *f* (backward) and
    the output's *g*; with a split ``wk`` the context's *f* (backward,
    only where the context has a gradient: whisper's encoder output)
    and, where M does not divide the KV heads, K and V all-gathered
    (reduce-scattered backward); with ``wk`` whole, K's and V's *f*
    (backward). Per encoder
    layer, over the context's rows and not recomputed: its attention as
    a non-causal self-attention layer and its MLP. A vocab-split
    embedding's *g*, the logits' *f* and the loss's max, sum of
    exponentials and label logit (f32).
    ``cfg.remat`` recomputes each period's forward collectives in the
    backward, up to the last tensor the backward saved (a period's last
    *g* runs again only under a post-norm)."""
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import context_len

    out = {op: {"calls": 0, "bytes": 0} for op in OPS}
    if m <= 1:
        return out
    slots, embed, enc = _slot_splits(cfg, m)
    elt = _elt(dtype)
    tokens = batch * seq
    ctx_tokens = batch * context_len(cfg)
    act = m * tokens * cfg.d_model * elt             # an (M, b, s, d) stack
    row = m * tokens * 4                             # an (M, b, s) f32 stack
    kv_row = cfg.n_kv_heads * cfg.resolved_head_dim * elt
    q_row = cfg.n_heads * cfg.resolved_head_dim * elt

    def add(op, nbytes, calls=1, layers=cfg.n_periods):
        out[op]["calls"] += calls * layers
        out[op]["bytes"] += calls * layers * nbytes

    def attention(wk_split, act, qc, kvc, fwd, layers=cfg.n_periods):
        add("all_reduce", act, 1, layers)            # f backward
        add("all_reduce", act, fwd, layers)          # g forward
        if cfg.n_heads % m:                          # the split inside a head
            add("all_gather", qc, fwd, layers)
            add("reduce_scatter", m * qc, 1, layers)
        if wk_split and cfg.n_kv_heads % m:
            add("all_gather", kvc, 2 * fwd, layers)
            add("reduce_scatter", m * kvc, 2, layers)
        elif not wk_split:
            add("all_reduce", m * kvc, 2, layers)    # f backward, K and V

    if enc.get("attn/wq") and ctx_tokens:
        e_act = m * ctx_tokens * cfg.d_model * elt
        attention(enc["attn/wk"], e_act, ctx_tokens * q_row,
                  ctx_tokens * kv_row, 1, cfg.n_encoder_layers)
        if enc.get("mlp/w_up"):                      # f backward, g forward
            add("all_reduce", e_act, 2, cfg.n_encoder_layers)
    fwd = 2 if cfg.remat else 1
    for split in slots:
        if split.get("attn/wq"):
            attention(split["attn/wk"], act, tokens * q_row,
                      tokens * kv_row, fwd)
        if split.get("time_mix/w_r"):
            add("all_reduce", act)                   # f backward
            add("all_reduce", act, fwd)              # g forward
            if cfg.rwkv_n_heads % m:                 # r, k, w's projection
                rd = tokens * cfg.d_model * elt
                add("all_gather", rd, 3 * fwd)
                add("reduce_scatter", m * rd, 3)
        if split.get("cross/wq") and ctx_tokens:
            attention(split["cross/wk"], act, tokens * q_row,
                      ctx_tokens * kv_row, fwd)
            if split["cross/wk"] and cfg.has_encoder:  # the context's f
                add("all_reduce", m * ctx_tokens * cfg.d_model * elt)
        if split.get("mamba/w_in"):
            xz = tokens * 2 * cfg.mamba_d_inner * elt
            add("all_reduce", act)                   # f backward
            add("all_gather", xz, fwd)               # each shard's block
            add("reduce_scatter", m * xz)
        if split.get("mamba/conv_w"):
            dbc = m * tokens * (cfg.mamba_dt_rank + 2 * cfg.mamba_d_state) \
                * elt
            add("all_reduce", dbc, fwd)              # the partials
            add("all_reduce", dbc)                   # their f backward
            add("all_reduce", act, fwd)              # g forward
        if split.get("mlp/w_up"):
            add("all_reduce", act, 1 + fwd)          # f backward, g forward
        if split.get("channel_mix/w_k") or split.get("channel_mix/w_r"):
            add("all_reduce", act)                   # f backward
        if split.get("channel_mix/w_k"):
            add("all_reduce", act, fwd)              # g forward
        if split.get("channel_mix/w_r"):
            rd = tokens * cfg.d_model * elt
            add("all_gather", rd, fwd)               # each shard's block
            add("reduce_scatter", m * rd)
        if split.get("moe/w_up"):
            gates = m * cfg.n_experts * capacity(cfg, tokens) * 4
            add("all_reduce", act)                   # the rows' f backward
            add("all_reduce", gates)                 # the gates' f backward
            add("all_reduce", act, fwd)              # g forward
    last = slots[-1]
    if cfg.remat and not cfg.post_block_norm and (
            last.get("mlp/w_up") or last.get("moe/w_up")):
        # the recomputation stops at the last tensor the backward saved:
        # a period ending in its feed-forward's g (no post-norm after it)
        # does not run that g again
        add("all_reduce", act, -1)
    if embed:
        for op, nbytes, calls in (("all_reduce", act, 2), ("all_max", row, 1),
                                  ("all_reduce", row, 2)):
            out[op]["calls"] += calls     # the embedding's g, the logits'
            out[op]["bytes"] += calls * nbytes  # f; the loss's three
    return out


def tp_serving_collectives(cfg, m: int, batch: int, seq: int, kind: str,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> Dict[str, Dict[str, int]]:
    """The model-axis collectives of one serving step over an M-shard
    stack, ``batch`` rows of ``seq`` new tokens
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
    their sums and weighted sums (f32, head_dim + 1 a head); with a whole
    cache, where M cuts the heads, Q is all-gathered. Per MLP layer with
    a sharded ``w_up`` and per MoE layer with sharded experts: the
    all-reduce. Per mamba layer with a split ``w_in``: the all-gather of
    its product's blocks; with split channels (the state split by
    channel in either layout) also the ``w_x_dbc`` partials' and the
    output's all-reduces. Per rwkv time mix with split heads: ``w_out``'s
    all-reduce (and r, k and the decay's projection all-gathered where M
    cuts the heads); per channel mix the ``w_v`` partials' all-reduce
    (split ``w_k``) and ``w_r``'s product all-gathered (split ``w_r``).
    Per cross-attention layer (``transformer.context_len(cfg)`` context
    rows a sample; decode recomputes its K / V every step, as JAX does):
    the output's all-reduce, and K and V all-gathered where ``wk`` is
    split and M does not divide the KV heads; Q all-gathered where M
    cuts the heads. Prefill also runs the encoder over the context's
    rows: per layer its attention's and its MLP's all-reduce, with the
    same K / V all-gathers (decode takes the context encoded). A vocab-split
    embedding's all-reduce. No gradient: *f* counts nothing."""
    from repro_torch.models.transformer import context_len

    out = {op: {"calls": 0, "bytes": 0} for op in OPS}
    if m <= 1:
        return out
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind {kind!r}: expected 'prefill' or 'decode'")
    slots, embed, enc = _slot_splits(cfg, m)
    elt = _elt(dtype)
    hd, h, kvh = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    tokens = batch * seq
    ctx_tokens = batch * context_len(cfg)
    act = m * tokens * cfg.d_model * elt            # an (M, b, s, d) stack

    def add(op, nbytes, calls=1, layers=cfg.n_periods):
        out[op]["calls"] += calls * layers
        out[op]["bytes"] += calls * layers * nbytes

    def unmasked(wk_split, act, q_rows, rows, layers=cfg.n_periods):
        add("all_reduce", act, 1, layers)            # g of wo
        if h % m:                                    # the split inside a head
            add("all_gather", q_rows * h * hd * elt, 1, layers)
        if wk_split and kvh % m:
            add("all_gather", rows * kvh * hd * elt, 2, layers)

    if kind == "prefill" and enc.get("attn/wq") and ctx_tokens:
        e_act = m * ctx_tokens * cfg.d_model * elt
        unmasked(enc["attn/wk"], e_act, ctx_tokens, ctx_tokens,
                 cfg.n_encoder_layers)
        if enc.get("mlp/w_up"):
            add("all_reduce", e_act, 1, cfg.n_encoder_layers)
    for split in slots:
        if split.get("cross/wq") and ctx_tokens:
            unmasked(split["cross/wk"], act, tokens, ctx_tokens)
        if split.get("time_mix/w_r"):
            add("all_reduce", act)
            if cfg.rwkv_n_heads % m:                 # r, k, w's projection
                add("all_gather", tokens * cfg.d_model * elt, 3)
        if split.get("channel_mix/w_k"):
            add("all_reduce", act)
        if split.get("channel_mix/w_r"):
            add("all_gather", tokens * cfg.d_model * elt)
        if split.get("attn/wq"):
            add("all_reduce", act)                   # g of wo
            kv_gather = split["attn/wk"] and (kind == "decode" or kvh % m)
            if kv_gather:
                add("all_gather", tokens * kvh * hd * elt, 2)
            if kind == "decode" or h % m:            # Q gathered
                add("all_gather", tokens * h * hd * elt)
            if kind == "decode":
                add("all_max", m * tokens * h * 4)
                add("all_reduce", m * tokens * h * (hd + 1) * 4)
        if split.get("mamba/w_in"):
            add("all_gather", tokens * 2 * cfg.mamba_d_inner * elt)
        if split.get("mamba/conv_w"):
            add("all_reduce", m * tokens * (cfg.mamba_dt_rank
                                            + 2 * cfg.mamba_d_state) * elt)
            add("all_reduce", act)
        if split.get("mlp/w_up") or split.get("moe/w_up"):
            add("all_reduce", act)
    if embed:
        out["all_reduce"]["calls"] += 1
        out["all_reduce"]["bytes"] += act
    return out
