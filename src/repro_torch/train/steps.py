"""The distributed LM train step: Algorithm 1 per edge node.

Port of ``repro.train.steps.make_distributed_train`` (and its
``DistributedTrainConfig`` / ``gossip_schedule`` /
``init_distributed_state``) without the tensor-parallel parts (the
``MeshRules`` sharding and ``plane.use_buckets``: one GPU per node holds
the whole model, so every tree packs into one flat wire plane).

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
from typing import Any, Callable, Optional

import torch

from repro_torch import prng, tree as tree_mod
from repro_torch.core import gossip, method as method_mod
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

__all__ = ["DistributedTrainConfig", "gossip_schedule",
           "init_distributed_state", "make_distributed_train",
           "node_batch", "node_grads"]

PyTree = Any


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
        seed=seed)


def gossip_schedule(tc: DistributedTrainConfig, n_nodes: int
                    ) -> gossip.ScheduleSequence:
    """The configured gossip graph over ``n_nodes``, compiled once per
    (spec, seed, self-weight, n): the launcher banner, the init and the
    step share one schedule object. The JAX package's placement
    renumbering (nodes onto neighbouring ICI devices) has no counterpart
    on one card."""
    return _compiled_schedule(tc.topology, tc.topology_seed, tc.self_weight,
                              n_nodes)


def init_distributed_state(tc: DistributedTrainConfig, transport, *,
                           seed: int = 0, params: PyTree = None):
    """The node block's state, every node at the same initial params
    (``params``, or ``transformer.init_params`` from ``seed``): e.g.
    SDM's s_0 = (1 - W_ii) x_0 with each node's own W_ii."""
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
               labels: torch.Tensor, context: Optional[torch.Tensor] = None):
    """Each node's LM gradient at its own params, one node at a time
    (only one node's activations are alive at once). ``x_block`` leaves
    are (L, ...), ``tokens`` / ``labels`` (L, b, s), ``context`` (the
    audio / vlm families' raw context) (L, b, s_ctx, d). Returns (grads
    block, (L,) f32 losses)."""
    leaves, struct = tree_mod.flatten(x_block)
    grads = [torch.empty_like(v) for v in leaves]
    losses = torch.empty(len(tokens), dtype=torch.float32,
                         device=tokens.device)
    for i in range(len(tokens)):
        mine = [v[i].detach().requires_grad_(True) for v in leaves]
        logits, aux = transformer.forward(
            tree_mod.unflatten(struct, mine), cfg, tokens[i],
            context=None if context is None else context[i])
        loss = transformer.lm_loss(logits, labels[i], cfg.vocab_size, aux)
        del logits
        for g_out, g in zip(grads, torch.autograd.grad(loss, mine)):
            g_out[i].copy_(g)
        losses[i] = loss.detach()
    return tree_mod.unflatten(struct, grads), losses


def make_distributed_train(tc: DistributedTrainConfig, transport,
                           base_key: Optional[torch.Tensor] = None
                           ) -> Callable:
    """Returns ``train_step(state, tokens, labels, context=None) ->
    (state, loss)``.

    ``tokens`` / ``labels`` are the global (b, s) batch on the block's
    device, ``context`` the audio / vlm families' global (b, s_ctx, d)
    context, split over the nodes as the batch is; ``loss`` is the mean
    of the nodes' losses over all n nodes (a 0-d tensor, the JAX
    package's ``pmean``).
    """
    cfg = tc.model
    meth, mcfg = tc.resolved()
    seq = gossip_schedule(tc, transport.n)
    if getattr(mcfg, "overlap", False) and gossip.needs_replicas(seq):
        raise ValueError(
            f"overlap=True needs a static topology; {tc.topology!r} "
            f"compiles to a replica (time-varying) schedule")
    executor = meth.make_distributed(seq, mcfg, transport)
    if base_key is None:
        base_key = prng.PRNGKey(0)
    base_key = prng.key_data(base_key).to(transport.device)

    def train_step(state, tokens, labels, context=None):
        tok = node_batch(tokens, transport)
        lab = node_batch(labels, transport)
        ctx = None if context is None else node_batch(context, transport)
        state, losses = executor.step(
            state, lambda x: node_grads(cfg, x, tok, lab, ctx),
            base_key=base_key)
        return state, transport.pmean(losses)[0]

    return train_step
