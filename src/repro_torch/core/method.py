"""The method registry: one name per decentralized-learning algorithm.

Port of the reference faces of ``repro.core.method``:

    meth = method.get("sdm-dsgd")           # registry lookup (aliases ok)
    cfg  = meth.coerce_config(cfg_like)     # each method owns its config
    sim  = meth.make_reference(seq, cfg)    # stacked single-device executor

with ``init(params_stack)``, ``step(state, grad_fn, batch_stack, key)``,
``consensus(state)`` and ``eval_params(state)`` on the executor, and the
exact per-step wire accounting (``transmitted_elements`` /
``transmitted_bits``).

Registered: ``sdm-dsgd``, ``sdm-dsgd-fused`` (the same reference; the
fused layout only changes the distributed state), ``dc-dsgd`` (theta
pinned to 1), ``dsgd`` and ``allreduce``. ``make_distributed`` stays
unset until the distributed executor is ported; ``gradient-push`` comes
with its own slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.core import baselines, gossip, plane as plane_mod, sdm_dsgd

__all__ = ["Method", "register", "get", "names", "normalize",
           "transmitted_elements", "transmitted_bits", "AllreduceReference"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Method:
    """A registered decentralized-learning method (see module docstring)."""

    name: str
    coerce_config: Callable[[Any], Any]
    make_reference: Callable[[Any, Any], Any]
    # (params, cfg, seq=None) -> int; ``seq`` makes the count per-link.
    transmitted_elements: Callable[..., int]
    transmitted_bits_fn: "Callable[..., int] | None" = None
    make_distributed: "Callable | None" = None
    description: str = ""


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


def _coerce_sdm(cfg) -> sdm_dsgd.SDMConfig:
    if isinstance(cfg, sdm_dsgd.SDMConfig):
        return cfg
    raise TypeError(f"sdm-dsgd needs an SDMConfig, got {type(cfg).__name__}")


def _coerce_dsgd(cfg) -> baselines.DSGDConfig:
    if isinstance(cfg, baselines.DSGDConfig):
        return cfg
    if isinstance(cfg, sdm_dsgd.SDMConfig):
        return baselines.DSGDConfig(gamma=cfg.gamma, sigma=cfg.sigma,
                                    clip_c=cfg.clip_c)
    raise TypeError(f"dsgd needs DSGDConfig/SDMConfig, got {type(cfg).__name__}")


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
    coerce_config=_coerce_sdm,
    make_reference=sdm_dsgd.ReferenceSimulator,
    transmitted_elements=sdm_dsgd.transmitted_elements_per_step,
    transmitted_bits_fn=sdm_dsgd.transmitted_bits_per_step,
    description="Algorithm 1: sparse differential Gaussian-masking DSGD"))

register(dataclasses.replace(
    _SDM, name="sdm-dsgd-fused",
    description="SDM-DSGD with commit+advance fused (2 state buffers)"))

register(dataclasses.replace(
    _SDM, name="dc-dsgd",
    coerce_config=lambda cfg: dataclasses.replace(_coerce_sdm(cfg),
                                                  theta=1.0),
    description="DC-DSGD = SDM-DSGD with theta = 1 (Tang et al. 2018)"))

register(Method(
    name="dsgd",
    coerce_config=_coerce_dsgd,
    make_reference=baselines.DSGDReference,
    transmitted_elements=_full_state_elements,
    description="full-state gossip DSGD (Lian et al. 2017)"))

register(Method(
    name="allreduce",
    coerce_config=_coerce_dsgd,
    make_reference=AllreduceReference,
    transmitted_elements=_allreduce_elements,
    description="conventional all-reduce data parallelism (upper bound)"))
