"""The method registry: one name per decentralized-learning algorithm.

Port of ``repro.core.method``:

    meth = method.get("sdm-dsgd")           # registry lookup (aliases ok)
    cfg  = meth.coerce_config(cfg_like)     # each method owns its config
    sim  = meth.make_reference(seq, cfg)    # stacked single-device executor
    ex   = meth.make_distributed(seq, cfg, transport)   # per-node executor

Both executors are built from the same schedule object, so their mixing
matrices cannot diverge. Reference executors expose ``init(params_stack)``,
``step(state, grad_fn, batch_stack, key)``, ``consensus(state)`` and
``eval_params(state)``. The per-node executor works on a node block
(``core/transport.py``: the nodes a process holds, on one transport) and
exposes

    init(params_block) -> state          # every node at the same x_0
    step(state, grads_at, *, base_key) -> (state, aux)

where ``grads_at(params_block) -> (grads_block, aux)`` evaluates the
gradient where the method wants it. ``init_stacked(stack, seq, cfg)``
builds the state of all n nodes as one block (what the JAX package
materializes before sharding it), ``state_fields_of`` and
``state_shape_dtype`` describe its layout.

Registered: ``sdm-dsgd``, ``sdm-dsgd-fused`` (commit+advance fused: two
state buffers), ``dc-dsgd`` (theta pinned to 1), ``dsgd``,
``gradient-push`` (push-sum over directed column-stochastic graphs, its
gradient taken at the de-biased z = x / w; ``push-sum`` and ``sgp`` are
aliases) and ``allreduce``, each with its per-node face. The JAX
package's sharding builders (``state_shardings``) and the simulator's
stale-gossip helpers are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.core import (baselines, compressor as compressor_mod, gossip,
                              gradient_push, plane as plane_mod, sdm_dsgd)

__all__ = ["Method", "DistributedExecutor", "register", "get", "names",
           "normalize", "PARAM", "SCALAR", "COUNTER", "PLANE", "REPLICA",
           "state_fields_of", "state_shape_dtype", "transmitted_elements",
           "transmitted_bits", "AllreduceReference"]

PyTree = Any

# State-field kinds (the layout ``state_shape_dtype`` describes).
PARAM = "param"      # shaped like the parameter tree
SCALAR = "scalar"    # one f32 per node
COUNTER = "counter"  # the iteration counter
PLANE = "plane"      # a tuple of f32 (rows, LANE) wire planes per node
REPLICA = "replica"  # wire planes with a leading (n_replicas,) axis


@dataclasses.dataclass(frozen=True)
class DistributedExecutor:
    """The per-node face of a method, bound to one transport."""

    init: Callable[[PyTree], Any]                # (params_block) -> state
    step: Callable[..., Tuple[Any, Any]]         # (state, grads_at, *, base_key)


@dataclasses.dataclass(frozen=True)
class Method:
    """A registered decentralized-learning method (see module docstring)."""

    name: str
    config_cls: type
    state_cls: type
    state_fields: Tuple[Tuple[str, str], ...]
    coerce_config: Callable[[Any], Any]
    make_reference: Callable[[Any, Any], Any]
    # (seq, cfg, transport) -> DistributedExecutor
    make_distributed: "Callable | None"
    init_stacked: "Callable | None"
    # (params, cfg, seq=None) -> int; ``seq`` makes the count per-link.
    transmitted_elements: Callable[..., int]
    description: str = ""
    # (cfg, seq) -> layout where it depends on them; None: state_fields
    state_fields_for: "Callable | None" = None
    transmitted_bits_fn: "Callable[..., int] | None" = None


_REGISTRY: Dict[str, Method] = {}

_ALIASES = {
    "dcdsgd": "dc-dsgd",
    "push-sum": "gradient-push",
    "sgp": "gradient-push",
    "all-reduce": "allreduce",
}


def normalize(name: str) -> str:
    """Canonical registry key: lower-case, '_' -> '-', aliases resolved."""
    key = name.strip().lower().replace("_", "-")
    return _ALIASES.get(key, key)


def register(meth: Method) -> Method:
    _REGISTRY[meth.name] = meth
    return meth


def get(name: str) -> Method:
    key = normalize(name)
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown method {name!r}; registered: {', '.join(names())}")
    return _REGISTRY[key]


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def state_fields_of(meth: Method, cfg=None,
                    seq=None) -> Tuple[Tuple[str, str], ...]:
    """The method's state layout; genuinely time-varying schedules add a
    REPLICA stack, ``overlap`` a pending PLANE buffer."""
    if meth.state_fields_for is not None and cfg is not None:
        return meth.state_fields_for(cfg, seq)
    return meth.state_fields


def _n_replicas(seq) -> int:
    return gossip.union_schedule(gossip.ensure_sequence(seq)).n_replicas


def state_shape_dtype(meth: Method, x_stack: PyTree, cfg=None, seq=None):
    """The stacked state's shapes and dtypes (``plane.ShapeDtype``
    leaves) from the stacked params (tensors or ShapeDtypes): PLANE
    fields are (n, rows, lane) f32 planes, REPLICA fields (n, n_replicas,
    rows, lane), the counter (n,) int32 as in the JAX package."""
    n = tree_mod.leaves(x_stack)[0].shape[0]
    spec = plane_mod.ParamPlane.for_stacked(x_stack)
    sd = plane_mod.ShapeDtype
    kw = {}
    for fname, kind in state_fields_of(meth, cfg, seq):
        if kind == PARAM:
            kw[fname] = tree_mod.tree_map(
                lambda v: sd(tuple(v.shape), v.dtype), x_stack)
        elif kind == PLANE:
            kw[fname] = tuple(sd((n,) + b.shape, torch.float32)
                              for b in spec.buckets)
        elif kind == REPLICA:
            r = _n_replicas(seq)
            kw[fname] = tuple(sd((n, r) + b.shape, torch.float32)
                              for b in spec.buckets)
        elif kind == SCALAR:
            kw[fname] = sd((n,), torch.float32)
        else:
            kw[fname] = sd((n,), torch.int32)
    return meth.state_cls(**kw)


def transmitted_elements(meth: Method, params: PyTree, cfg, seq=None) -> int:
    """Elements one node transmits per step, per-link when ``seq`` given."""
    return meth.transmitted_elements(params, cfg, seq=seq)


def transmitted_bits(meth: Method, params: PyTree, cfg,
                     value_bits: int = 32, seq=None) -> int:
    """Exact wire bits one node transmits per step; methods without a
    bits accountant ship full-precision payloads (elements x value_bits)."""
    if meth.transmitted_bits_fn is not None:
        return meth.transmitted_bits_fn(params, cfg, value_bits=value_bits,
                                        seq=seq)
    return meth.transmitted_elements(params, cfg, seq=seq) * value_bits


# --------------------------------------------------------------------------
# SDM-DSGD (and its derivations: fused layout, DC-DSGD).
# --------------------------------------------------------------------------

def _coerce_sdm(cfg) -> sdm_dsgd.SDMConfig:
    if isinstance(cfg, sdm_dsgd.SDMConfig):
        return cfg
    raise TypeError(f"sdm-dsgd needs an SDMConfig, got {type(cfg).__name__}")


_SDM_FIELDS = (("x", PARAM), ("s", PLANE), ("d", PLANE), ("step", COUNTER))
_FUSED_FIELDS = (("x", PARAM), ("s", PLANE), ("step", COUNTER))


def _with_buffers(base, cfg, seq):
    if seq is not None and gossip.needs_replicas(seq):
        return base + (("xhat", REPLICA),)
    if cfg is not None and getattr(cfg, "overlap", False):
        return base + (("nb", PLANE),)
    return base


def _sdm_fields(cfg, seq=None):
    return _with_buffers(_SDM_FIELDS, cfg, seq)


def _fused_fields(cfg, seq=None):
    return _with_buffers(_FUSED_FIELDS, cfg, seq)


def _replicas_for(seq):
    return _n_replicas(seq) if gossip.needs_replicas(seq) else None


def _sdm_init_stacked(stack: PyTree, seq, cfg) -> sdm_dsgd.SDMState:
    n = tree_mod.leaves(stack)[0].shape[0]
    me = torch.arange(n, device=tree_mod.leaves(stack)[0].device)
    return sdm_dsgd.init_distributed_state(
        stack, seq.self_weight_of(me, 0), n_replicas=_replicas_for(seq),
        overlap=getattr(cfg, "overlap", False))


def _fused_init_stacked(stack: PyTree, seq, cfg) -> sdm_dsgd.SDMFusedState:
    full = _sdm_init_stacked(stack, seq, cfg)
    return sdm_dsgd.SDMFusedState(x=full.x, s=full.s, step=full.step,
                                  xhat=full.xhat, nb=full.nb)


def _sdm_distributed(seq, cfg, transport) -> DistributedExecutor:
    def init(params):
        return sdm_dsgd.init_distributed_state(
            params, seq.self_weight_of(transport.me, 0),
            n_replicas=_replicas_for(seq),
            overlap=getattr(cfg, "overlap", False))

    def step(state, grads_at, *, base_key):
        state = sdm_dsgd.distributed_advance(
            state, base_key=base_key, transport=transport, cfg=cfg,
            schedule=seq)
        grads, aux = grads_at(state.x)
        state = sdm_dsgd.distributed_commit(
            state, grads, base_key=base_key, transport=transport, cfg=cfg,
            schedule=seq)
        return state, aux

    return DistributedExecutor(init=init, step=step)


def _fused_distributed(seq, cfg, transport) -> DistributedExecutor:
    def init(params):
        return sdm_dsgd.init_fused_state(
            params, seq.self_weight_of(transport.me, 0),
            n_replicas=_replicas_for(seq),
            overlap=getattr(cfg, "overlap", False))

    def step(state, grads_at, *, base_key):
        grads, aux = grads_at(state.x)
        state = sdm_dsgd.distributed_step_fused(
            state, grads, base_key=base_key, transport=transport, cfg=cfg,
            schedule=seq)
        return state, aux

    return DistributedExecutor(init=init, step=step)


# --------------------------------------------------------------------------
# DSGD (full-state baseline) and allreduce (non-gossip upper bound).
# --------------------------------------------------------------------------

def _coerce_dsgd(cfg) -> baselines.DSGDConfig:
    if isinstance(cfg, baselines.DSGDConfig):
        return cfg
    if isinstance(cfg, sdm_dsgd.SDMConfig):
        return baselines.DSGDConfig(gamma=cfg.gamma, sigma=cfg.sigma,
                                    clip_c=cfg.clip_c)
    raise TypeError(f"dsgd needs DSGDConfig/SDMConfig, got {type(cfg).__name__}")


def _dsgd_init_stacked(stack, seq, cfg) -> baselines.DSGDState:
    return baselines.DSGDState(x=stack, step=0)


def _dsgd_distributed(seq, cfg, transport) -> DistributedExecutor:
    def init(params):
        return baselines.DSGDState(x=params, step=0)

    def step(state, grads_at, *, base_key):
        grads, aux = grads_at(state.x)
        state = baselines.dsgd_distributed_step(
            state, grads, base_key=base_key, transport=transport, cfg=cfg,
            schedule=seq)
        return state, aux

    return DistributedExecutor(init=init, step=step)


class AllreduceReference:
    """Stacked conventional data parallelism: SGD on the mean gradient."""

    def __init__(self, topo, cfg: baselines.DSGDConfig):
        del topo
        self.cfg = cfg

    def init(self, params_stack: PyTree) -> baselines.DSGDState:
        return baselines.DSGDState(x=params_stack, step=0)

    def step(self, state, grad_fn, batch_stack, key):
        del key  # the non-private upper bound: no masking
        grads, aux = grad_fn(state.x, batch_stack)
        gbar = tree_mod.tree_map(
            lambda g: torch.mean(g, dim=0, keepdim=True).expand(g.shape),
            grads)
        x = tree_mod.tree_map(
            lambda x, g: x - self.cfg.gamma * g.to(x.dtype), state.x, gbar)
        return baselines.DSGDState(x=x, step=state.step + 1), aux

    def consensus_mean(self, state):
        return tree_mod.tree_map(lambda x: torch.mean(x, dim=0), state.x)

    consensus = consensus_mean

    def eval_params(self, state):
        return state.x


def _allreduce_distributed(seq, cfg, transport) -> DistributedExecutor:
    def init(params):
        return baselines.DSGDState(x=params, step=0)

    def step(state, grads_at, *, base_key):
        del base_key
        grads, aux = grads_at(state.x)
        grads = tree_mod.tree_map(transport.pmean, grads)
        x = tree_mod.tree_map(
            lambda p, g: p - cfg.gamma * g.to(p.dtype), state.x, grads)
        return baselines.DSGDState(x=x, step=state.step + 1), aux

    return DistributedExecutor(init=init, step=step)


# --------------------------------------------------------------------------
# Gradient-push (directed graphs, push-sum de-biasing).
# --------------------------------------------------------------------------

def _coerce_push(cfg) -> gradient_push.GradientPushConfig:
    if isinstance(cfg, gradient_push.GradientPushConfig):
        return cfg
    if isinstance(cfg, sdm_dsgd.SDMConfig):
        # an explicit compressor spec on the SDM bag carries over (the
        # --compressor CLI axis); the legacy mode= spelling does not
        return gradient_push.GradientPushConfig(
            gamma=cfg.gamma, sigma=cfg.sigma, clip_c=cfg.clip_c,
            compressor=cfg.compressor, p=cfg.p,
            overlap=cfg.overlap and cfg.compressor is not None)
    if isinstance(cfg, baselines.DSGDConfig):
        return gradient_push.GradientPushConfig(
            gamma=cfg.gamma, sigma=cfg.sigma, clip_c=cfg.clip_c)
    raise TypeError(
        f"gradient-push needs GradientPushConfig, got {type(cfg).__name__}")


_PUSH_FIELDS = (("x", PARAM), ("w", SCALAR), ("step", COUNTER))


def _push_fields(cfg, seq=None):
    if not getattr(cfg, "compressor", None):
        return _PUSH_FIELDS
    if seq is not None and gossip.needs_replicas(seq):
        # the replica stack replaces the persistent neighbour sum
        return _PUSH_FIELDS + (("xhat", PLANE), ("xhat_nb", REPLICA))
    fields = _PUSH_FIELDS + (("xhat", PLANE), ("s", PLANE))
    if getattr(cfg, "overlap", False):
        fields = fields + (("nb", PLANE),)
    return fields


def _push_init(params, seq, cfg, me) -> gradient_push.GradientPushState:
    if not getattr(cfg, "compressor", None):
        return gradient_push.init_push_state(params)
    rs = gossip._table(seq.schedules[0].neighbor_weight_sums(), me)
    return gradient_push.init_compressed_push_state(
        params, rs, n_replicas=_replicas_for(seq),
        overlap=getattr(cfg, "overlap", False))


def _push_init_stacked(stack, seq, cfg) -> gradient_push.GradientPushState:
    n = tree_mod.leaves(stack)[0].shape[0]
    return _push_init(stack, seq, cfg,
                      torch.arange(n, device=tree_mod.leaves(stack)[0].device))


def _push_distributed(seq, cfg, transport) -> DistributedExecutor:
    def init(params):
        return _push_init(params, seq, cfg, transport.me)

    def step(state, grads_at, *, base_key):
        grads, aux = grads_at(gradient_push._debias(state.x, state.w))
        state = gradient_push.gradient_push_distributed_step(
            state, grads, base_key=base_key, transport=transport, cfg=cfg,
            schedule=seq)
        return state, aux

    return DistributedExecutor(init=init, step=step)


def _push_degree_factors(seq, compressed: bool, node=None):
    """(payload, mass) per-link factors: the mass scalar rides the
    current round's graph, a compressed payload the union graph when the
    sequence genuinely varies (replica transport)."""
    if seq is None:
        return Fraction(1), Fraction(1)
    seq = gossip.sequence_of(seq)
    mass = gossip.mean_out_degree(seq, node=node)
    payload = gossip.mean_out_degree(
        seq, union=compressed and gossip.needs_replicas(seq), node=node)
    return payload, mass


def _push_payload(comp, params, per_node_fn, node):
    """A node's payload count (the mean over nodes for ``node=None``)."""
    wire = sdm_dsgd.wire_shape_tree(params)
    if node is not None:
        return per_node_fn(comp, wire, node)
    return compressor_mod.node_mean_exact(
        comp.p, lambda i: per_node_fn(comp, wire, i))


def _push_elements(params: PyTree, cfg, seq=None, node=None) -> int:
    comp = cfg.make_compressor() if hasattr(cfg, "make_compressor") else None
    payload_deg, mass_deg = _push_degree_factors(seq, comp is not None, node)
    if comp is None:   # + the push-sum mass w
        return int(round(_full_state_elements(params, cfg) * payload_deg
                         + mass_deg))
    payload = _push_payload(
        comp, params, lambda c, wire, i: compressor_mod.
        tree_wire_elements_exact(c, wire, node=i), node)
    return int(round(payload * payload_deg + mass_deg))


def _push_bits(params: PyTree, cfg, seq=None, value_bits: int = 32,
               node=None) -> int:
    comp = cfg.make_compressor() if hasattr(cfg, "make_compressor") else None
    payload_deg, mass_deg = _push_degree_factors(seq, comp is not None, node)
    if comp is None:
        return int(round((_full_state_elements(params, cfg) * payload_deg
                          + mass_deg) * value_bits))
    # exchange_payload ships explicit indices (no seed regeneration)
    payload = _push_payload(
        comp, params, lambda c, wire, i: compressor_mod.tree_wire_bits_exact(
            c, wire, value_bits=value_bits, index_sync=False, node=i), node)
    return int(round(payload * payload_deg + mass_deg * value_bits))


# --------------------------------------------------------------------------
# Default registrations.
# --------------------------------------------------------------------------

def _full_state_elements(params: PyTree, cfg, seq=None) -> int:
    # full-state methods gossip the packed wire plane: plane-PADDED size.
    d = plane_mod.ParamPlane.for_tree(params).padded_size
    if seq is None:
        return d
    return int(round(d * gossip.mean_out_degree(gossip.sequence_of(seq))))


def _allreduce_elements(params: PyTree, cfg, seq=None) -> int:
    del seq
    return sum(math.prod(tuple(x.shape)) for x in tree_mod.leaves(params))


_SDM = register(Method(
    name="sdm-dsgd",
    config_cls=sdm_dsgd.SDMConfig,
    state_cls=sdm_dsgd.SDMState,
    state_fields=_SDM_FIELDS,
    state_fields_for=_sdm_fields,
    coerce_config=_coerce_sdm,
    make_reference=sdm_dsgd.ReferenceSimulator,
    make_distributed=_sdm_distributed,
    init_stacked=_sdm_init_stacked,
    transmitted_elements=sdm_dsgd.transmitted_elements_per_step,
    transmitted_bits_fn=sdm_dsgd.transmitted_bits_per_step,
    description="Algorithm 1: sparse differential Gaussian-masking DSGD"))

register(dataclasses.replace(
    _SDM, name="sdm-dsgd-fused",
    state_cls=sdm_dsgd.SDMFusedState,
    state_fields=_FUSED_FIELDS,
    state_fields_for=_fused_fields,
    make_distributed=_fused_distributed,
    init_stacked=_fused_init_stacked,
    description="SDM-DSGD with commit+advance fused (2 state buffers)"))

register(dataclasses.replace(
    _SDM, name="dc-dsgd",
    coerce_config=lambda cfg: dataclasses.replace(_coerce_sdm(cfg),
                                                  theta=1.0),
    description="DC-DSGD = SDM-DSGD with theta = 1 (Tang et al. 2018)"))

register(Method(
    name="dsgd",
    config_cls=baselines.DSGDConfig,
    state_cls=baselines.DSGDState,
    state_fields=(("x", PARAM), ("step", COUNTER)),
    coerce_config=_coerce_dsgd,
    make_reference=baselines.DSGDReference,
    make_distributed=_dsgd_distributed,
    init_stacked=_dsgd_init_stacked,
    transmitted_elements=_full_state_elements,
    description="full-state gossip DSGD (Lian et al. 2017)"))

register(Method(
    name="gradient-push",
    config_cls=gradient_push.GradientPushConfig,
    state_cls=gradient_push.GradientPushState,
    state_fields=_PUSH_FIELDS,
    state_fields_for=_push_fields,
    coerce_config=_coerce_push,
    make_reference=gradient_push.GradientPushReference,
    make_distributed=_push_distributed,
    init_stacked=_push_init_stacked,
    transmitted_elements=_push_elements,
    transmitted_bits_fn=_push_bits,
    description="push-sum gradient-push over directed column-stochastic "
                "graphs (SGP / DP-CSGP-style); --compressor switches on "
                "CHOCO-style error-compensated compressed payloads"))

register(Method(
    name="allreduce",
    config_cls=baselines.DSGDConfig,
    state_cls=baselines.DSGDState,
    state_fields=(("x", PARAM), ("step", COUNTER)),
    coerce_config=_coerce_dsgd,
    make_reference=AllreduceReference,
    make_distributed=_allreduce_distributed,
    init_stacked=_dsgd_init_stacked,
    transmitted_elements=_allreduce_elements,
    description="conventional all-reduce data parallelism (upper bound)"))
