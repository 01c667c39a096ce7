"""The distributed LM train step: Algorithm 1 per edge node.

Port of ``repro.train.steps.make_distributed_train`` (and its
``DistributedTrainConfig`` / ``gossip_schedule`` /
``init_distributed_state``), with the tensor-parallel parts: the rules
(``INNER_RULES``, ``outer_rules``, ``serving_rules``), the wire-plane
bucket policy (``plane_bucket_tree``: on a model axis M > 1 a leaf whose
trailing logical axis maps to ``model`` gets a plane of its own, as in
JAX), the state templates and their split plan (``state_shape_dtype``,
``state_shardings``) and each node's gradient over its M model shards
(``node_grads(model_axis=)``: ``convert.shard_params``, the
tensor-parallel forward, the gradients back to whole leaves).

The serving steps (``make_prefill_fn`` / ``make_decode_fn``) run
``transformer.prefill`` / ``decode_step`` over a node's M model shards
under ``serving_rules``: the cache split by KV heads for prefill, by
positions for decode (flash decoding), by positions over ("data",
"model") under ``shard_cache_seq``.

Each edge node runs the registered method's per-node executor
(``core/method.py``): per-node gradient -> coordinate clip -> Gaussian
mask -> theta-mixing -> sparse differential exchange. The nodes a
process holds form a node block on one transport (``core/transport.py``:
all n nodes on one card, or one node per ``torch.distributed`` rank).
Each node's gradient is taken with ordinary autograd, one node at a time
(only one node's activations are alive at once); the executor's step
then runs batched over the block.
"""
from __future__ import annotations

import dataclasses
import functools
import types
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import prng, tree as tree_mod
from repro_torch.core import gossip, method as method_mod, tagging
from repro_torch.core import plane as plane_mod
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import MeshRules, PartitionSpec

__all__ = ["DistributedTrainConfig", "gossip_schedule",
           "init_distributed_state", "make_distributed_train",
           "node_batch", "node_grads", "INNER_RULES", "outer_rules",
           "serving_rules", "param_shard_dims", "plane_bucket_tree",
           "bucket_ctx", "state_shape_dtype", "state_shardings",
           "make_prefill_fn", "make_decode_fn"]

PyTree = Any

# Logical-axis -> mesh-axis mapping INSIDE a node (the node axes are the
# executor's; only 'model' appears) ...
INNER_RULES: Mapping[str, Any] = {
    "heads": "model", "kv_heads": "model", "mlp": "model",
    "heads_flat": "model", "kv_flat": "model",
    "vocab": "model", "experts": "model",
    "batch": None, "seq": None, "embed": None, "layers": None,
    "cache_seq": None,
}


def outer_rules(node_axes: Tuple[str, ...]) -> dict:
    """The rules with the batch over the node axes (serving, and the
    node-stacked state's leading dim)."""
    rules = dict(INNER_RULES)
    rules["batch"] = node_axes if len(node_axes) > 1 else node_axes[0]
    return rules


def serving_rules(node_axes: Tuple[str, ...], *, shard_cache_seq: bool,
                  decode: bool = False) -> dict:
    """The rules of ``make_prefill_fn`` / ``make_decode_fn``: JAX's
    ``outer_rules`` (the parameters split as ``INNER_RULES`` split them,
    the batch over the node axes) with the cache's ``cache_seq`` over
    ``model`` for decode (the flash-decoding layout: ``kv_heads``, first
    in line otherwise, then stays whole, each mesh axis once a leaf) and
    over ("data", "model") with the batch whole under
    ``shard_cache_seq`` (a long context's one row)."""
    rules = outer_rules(node_axes)
    if decode:
        rules["cache_seq"] = "model"
    if shard_cache_seq:
        rules["cache_seq"] = ("data", "model")
        rules["batch"] = None
    return rules


def _mesh_of(model: int) -> MeshSpec:
    return MeshSpec((("data", 1), ("model", int(model))))


@functools.lru_cache(maxsize=None)
def param_shard_dims(cfg: ModelConfig, model: int
                     ) -> Mapping[str, Optional[int]]:
    """{'/'-joined parameter key: the dimension the model axis splits,
    or None (replicated)} on a model axis of ``model``, by
    ``INNER_RULES`` and JAX's divisibility fallback."""
    rules = MeshRules(_mesh_of(model), INNER_RULES)
    return types.MappingProxyType({       # cached: shared, so read-only
        k: (rules.split_dim(s.axes, s.shape) if model > 1 else None)
        for k, s in transformer.flat_specs(cfg)})


def plane_bucket_tree(tc: "DistributedTrainConfig", model: int):
    """The wire-plane bucket policy of a run (this file owns it): on a
    model axis above 1, each leaf whose trailing logical axis maps to
    ``model`` gets the bucket ``('model', cols)``; otherwise None (one
    flat plane). JAX's rule reads only the mapping, not divisibility."""
    if model <= 1:
        return None
    shapes = transformer.unflatten(dict(transformer.param_shapes(tc.model)))
    return plane_mod.bucket_keys_from_axes(
        transformer.param_axes(tc.model), shapes, INNER_RULES)


def bucket_ctx(tc: "DistributedTrainConfig", model: int):
    """The ``plane.use_buckets`` context of a run on a model axis of
    ``model``: the executor, its state templates and the wire accounting
    all run under it."""
    return plane_mod.use_buckets(plane_bucket_tree(tc, model))


def _serving_fn(cfg: ModelConfig, mesh, *, decode: bool,
                shard_cache_seq: bool, rule_overrides, device, model_axis):
    from repro_torch._device import resolve_device
    from repro_torch.convert import node_blocks
    from repro_torch.core.model_axis import StackModelAxis
    from repro_torch.launch.mesh import parse_mesh

    if rule_overrides:
        raise ValueError(
            f"rule_overrides {rule_overrides}: the port's tensor-parallel "
            "serving steps split the parameters, the activations and the "
            "cache by serving_rules alone; overrides are not ported "
            "(ROADMAP Queue 1, item 5d)")
    if isinstance(mesh, str):
        mesh = parse_mesh(mesh)
    rules_map = serving_rules(mesh.node_axes,
                              shard_cache_seq=shard_cache_seq, decode=decode)
    rules = MeshRules(mesh, rules_map)
    dev = resolve_device(device, allow_meta=True)
    if model_axis is None and mesh.model > 1:
        model_axis = StackModelAxis(mesh.model, dev)
    nodes = node_blocks(rules, rules_map.get("cache_seq"))
    run = transformer.decode_step if decode else transformer.prefill

    def step(params, tokens, cache, context=None):
        with torch.no_grad():
            return run(params, cfg, tokens, cache, context=context,
                       model_axis=model_axis, cache_nodes=nodes)

    step.model_axis = model_axis
    return step, rules


def make_prefill_fn(cfg: ModelConfig, mesh, *, shard_cache_seq: bool = False,
                    rule_overrides=None, device="cuda", model_axis=None):
    """JAX's ``make_prefill_fn``: returns ``(prefill_step, rules)``.
    ``prefill_step(params, tokens, cache, context=None) -> (logits,
    cache)`` runs ``transformer.prefill`` over ``mesh``'s model axis
    (``mesh``: a ``MeshSpec`` or a name): ``params`` and ``cache`` in
    their model-axis layouts on ``device`` (``convert.shard_params``;
    ``convert.shard_cache(cache, cfg, rules)``: the cache split by KV
    heads where M divides them, else whole), the whole batch of every
    node (the rows JAX splits over the node axes), logits vocab-split
    (M, b, V/M). Its model axis is ``prefill_step.model_axis`` (a
    ``StackModelAxis`` on ``device`` unless one is given; None at M =
    1), whose counters ``core/model_axis.tp_serving_collectives``
    predicts. ``device`` defaults to the card and raises without one; a
    non-empty ``rule_overrides`` raises (item 5d of ROADMAP Queue 1).
    Moving a cache from this layout to the decode step's
    (``convert.unshard_cache`` then ``shard_cache``) lies outside both
    steps, as JAX's jit boundary does, and is counted by neither."""
    return _serving_fn(cfg, mesh, decode=False,
                       shard_cache_seq=shard_cache_seq,
                       rule_overrides=rule_overrides, device=device,
                       model_axis=model_axis)


def make_decode_fn(cfg: ModelConfig, mesh, *, shard_cache_seq: bool = False,
                   rule_overrides=None, device="cuda", model_axis=None):
    """JAX's ``make_decode_fn``: returns ``(decode_fn, rules)``.
    ``decode_fn(params, token, cache, context=None) -> (logits, cache)``
    is one ``transformer.decode_step`` over the model axis, as
    ``make_prefill_fn``'s, with the cache split by positions (the
    flash-decoding layout; by positions over ("data", "model"), N M
    blocks, under ``shard_cache_seq``, where the merge's two collectives
    span the node axis too: counted once each on the model axis,
    ``layers._attention_seq_split``). The scalar ``cache.offset`` only:
    JAX's ``make_decode_fn`` passes no ragged offsets."""
    return _serving_fn(cfg, mesh, decode=True,
                       shard_cache_seq=shard_cache_seq,
                       rule_overrides=rule_overrides, device=device,
                       model_axis=model_axis)


def _model_of(model_axis) -> int:
    return 1 if model_axis is None else int(model_axis.size)


@dataclasses.dataclass(frozen=True)
class DistributedTrainConfig:
    """The train step's configuration. ``method`` names a
    ``core.method`` registry entry; ``sdm`` is the hyper-parameter bag
    each method coerces to its own config."""

    model: ModelConfig
    sdm: Any
    topology: str = "ring"              # spec for gossip.sequence_by_name
    topology_seed: int = 0
    self_weight: float = 1.0 / 3.0      # ring W_ii
    method: str = "sdm-dsgd"
    param_dtype: torch.dtype = torch.bfloat16

    def resolved(self):
        """(Method, method-native config) of this run."""
        meth = method_mod.get(self.method)
        return meth, meth.coerce_config(self.sdm)


@functools.lru_cache(maxsize=None)
def _compiled_schedule(spec: str, seed: int, self_weight: float,
                       n_nodes: int) -> gossip.ScheduleSequence:
    return gossip.sequence_by_name(
        spec, n_nodes, self_weight=self_weight if spec == "ring" else None,
        seed=seed, placement=True)


def gossip_schedule(tc: DistributedTrainConfig, n_nodes: int
                    ) -> gossip.ScheduleSequence:
    """The configured gossip graph over ``n_nodes``, compiled once per
    (spec, seed, self-weight, n): the launcher banner, the init (s_0's
    self-weights) and the step share one schedule object.

    Placed, as the JAX package's launcher compiles it:
    ``topology.greedy_placement`` renumbers the nodes whenever that
    strictly lowers the ring-hop cost. The renumbering is not only a
    device layout: it relabels W and changes the shift rounds a step
    sends (a sampled ER graph on 8 nodes compiles to fewer rounds), so
    the trajectory follows JAX's only with it. The simulator, the
    trainer and the wire gate compile the graph as drawn, as in JAX."""
    return _compiled_schedule(tc.topology, tc.topology_seed, tc.self_weight,
                              n_nodes)


def _stacked_template(tc: DistributedTrainConfig, n: int):
    return transformer.unflatten({
        k: plane_mod.ShapeDtype((n,) + tuple(s), tc.param_dtype)
        for k, s in transformer.param_shapes(tc.model).items()})


def state_shape_dtype(tc: DistributedTrainConfig, mesh: MeshSpec):
    """The node-stacked state's shapes and dtypes on ``mesh``, its planes
    laid out under the run's buckets (``plane.ShapeDtype`` leaves)."""
    meth, mcfg = tc.resolved()
    with bucket_ctx(tc, mesh.model):
        return method_mod.state_shape_dtype(
            meth, _stacked_template(tc, mesh.n_nodes), mcfg,
            seq=gossip_schedule(tc, mesh.n_nodes))


def state_shardings(tc: DistributedTrainConfig, mesh: MeshSpec):
    """The split plan of the node-stacked state: a ``PartitionSpec`` per
    leaf and plane (JAX's ``NamedSharding`` specs under ``outer_rules``:
    the node axes on dim 0, ``model`` where a leaf or a bucket's lane
    splits)."""
    node_axes = mesh.node_axes
    meth, mcfg = tc.resolved()
    rules = MeshRules(mesh, outer_rules(node_axes))
    x = transformer.unflatten({
        k: rules.spec(("batch",) + s.axes, (0,) + s.shape)
        for k, s in transformer.flat_specs(tc.model)})
    node_vec = PartitionSpec(node_axes if len(node_axes) > 1
                             else node_axes[0])
    with bucket_ctx(tc, mesh.model):
        return method_mod.state_shardings(
            meth, x, node_vec, mcfg, seq=gossip_schedule(tc, mesh.n_nodes),
            template=_stacked_template(tc, mesh.n_nodes))


def init_distributed_state(tc: DistributedTrainConfig, transport, *,
                           seed: int = 0, params: PyTree = None,
                           model_axis=None):
    """The node block's state, every node at the same initial params
    (``params``, or ``transformer.init_params`` from ``seed``): e.g.
    SDM's s_0 = (1 - W_ii) x_0 with each node's own W_ii. The state
    holds whole leaves at any ``model_axis``; its planes take the run's
    buckets."""
    meth, cfg = tc.resolved()
    seq = gossip_schedule(tc, transport.n)
    if params is None:
        params = transformer.init_params(tc.model, seed=seed,
                                         dtype=tc.param_dtype,
                                         device=transport.device)
    size = transport.me.shape[0]
    # a broadcast view: the executor's init copies it into the state
    block = tree_mod.tree_map(
        lambda p: p[None].expand((size,) + tuple(p.shape)), params)
    with bucket_ctx(tc, _model_of(model_axis)):
        return meth.make_distributed(seq, cfg, transport).init(block)


def node_batch(x: torch.Tensor, transport) -> torch.Tensor:
    """The block's nodes' rows of a global batch (b, ...): node i takes
    rows [i b/n, (i+1) b/n), as the JAX package shards the batch over
    the node axis. Returns (L, b/n, ...)."""
    n = transport.n
    if x.shape[0] % n:
        raise ValueError(f"global batch {x.shape[0]} does not split over "
                         f"{n} nodes")
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[transport.me]


def node_grads(cfg: ModelConfig, x_block: PyTree, tokens: torch.Tensor,
               labels: torch.Tensor, context: Optional[torch.Tensor] = None,
               *, nodes: Optional[Sequence[int]] = None, model_axis=None):
    """Each node's LM gradient at its own params, one node at a time
    (only one node's activations are alive at once). ``x_block`` leaves
    are (L, ...), ``tokens`` / ``labels`` (L, b, s), ``context`` (the
    audio / vlm families' raw context) (L, b, s_ctx, d). Returns (grads
    block, (L,) f32 losses). ``nodes`` computes only those rows and
    leaves the others unwritten (the dry-run traces node 0 alone: every
    node's work has the same shapes).

    ``model_axis`` (M > 1): each node's params go into the model-axis
    layout (``convert.shard_params``: the axis's held shards), its
    gradient is taken through the tensor-parallel forward over the
    shards, and comes back as whole leaves (``convert.unshard_params``)."""
    m = _model_of(model_axis)
    if m > 1:
        from repro_torch.convert import shard_params, unshard_params
        # a one-shard axis (the dry-run's) holds shard ``index`` alone
        index = getattr(model_axis, "index", None)
    axis = model_axis if m > 1 else None
    leaves, struct = tree_mod.flatten(x_block)
    grads = [torch.empty_like(v) for v in leaves]
    losses = torch.empty(len(tokens), dtype=torch.float32,
                         device=tokens.device)
    for i in range(len(tokens)) if nodes is None else nodes:
        mine = [v[i].detach() for v in leaves]
        if m > 1:
            mine = tree_mod.leaves(shard_params(
                tree_mod.unflatten(struct, mine), cfg, m, index=index))
        for v in mine:
            v.requires_grad_(True)
        logits, aux = transformer.forward(
            tree_mod.unflatten(struct, mine), cfg, tokens[i],
            context=None if context is None else context[i],
            model_axis=axis)
        loss = transformer.lm_loss(logits, labels[i], cfg.vocab_size, aux,
                                   model_axis=axis)
        del logits
        g = torch.autograd.grad(loss, mine)
        del mine
        if m > 1:
            g = tree_mod.leaves(unshard_params(
                tree_mod.unflatten(struct, list(g)), cfg, m, index=index))
        for g_out, g_in in zip(grads, g):
            g_out[i].copy_(g_in)
        losses[i] = loss.detach()
    return tree_mod.unflatten(struct, grads), losses


def make_distributed_train(tc: DistributedTrainConfig, transport,
                           base_key: Optional[torch.Tensor] = None, *,
                           grad_fn: Optional[Callable] = None,
                           model_axis=None) -> Callable:
    """Returns ``train_step(state, tokens, labels, context=None) ->
    (state, loss)``. ``grad_fn`` (default ``node_grads``, same
    signature) takes the block's gradients (the dry-run counts them).

    ``tokens`` / ``labels`` are the global (b, s) batch on the block's
    device, ``context`` the audio / vlm families' global (b, s_ctx, d)
    context, split over the nodes as the batch is; ``loss`` is the mean
    of the nodes' losses over all n nodes (a 0-d tensor, the JAX
    package's ``pmean``).

    ``model_axis`` (``core/model_axis``, M > 1): each node's gradient
    runs tensor-parallel over its M shards, and the executor's wire
    planes take the run's buckets (``plane_bucket_tree``), as JAX's step
    on an ``NxM`` mesh.
    """
    cfg = tc.model
    model = _model_of(model_axis)
    meth, mcfg = tc.resolved()
    seq = gossip_schedule(tc, transport.n)
    if getattr(mcfg, "overlap", False) and gossip.needs_replicas(seq):
        raise ValueError(
            f"overlap=True needs a static topology; {tc.topology!r} "
            f"compiles to a replica (time-varying) schedule")
    executor = meth.make_distributed(seq, mcfg, transport)
    if grad_fn is None:
        grad_fn = functools.partial(
            node_grads, model_axis=model_axis if model > 1 else None)
    if base_key is None:
        base_key = prng.PRNGKey(0)
    base_key = prng.key_data(base_key).to(transport.device)

    def train_step(state, tokens, labels, context=None):
        tok = node_batch(tokens, transport)
        lab = node_batch(labels, transport)
        ctx = None if context is None else node_batch(context, transport)
        with bucket_ctx(tc, model):
            state, losses = executor.step(
                state, lambda x: grad_fn(cfg, x, tok, lab, ctx),
                base_key=base_key)
        losses = tagging.declared_release(losses, label="loss")
        return state, transport.pmean(losses)[0]

    return train_step
