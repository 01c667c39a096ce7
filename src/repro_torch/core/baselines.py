"""Baselines the paper compares against (§5): DSGD and DC-DSGD.

Port of the reference half of ``repro.core.baselines``:

* DSGD (Lian et al. 2017): x_{i,t+1} = sum_j W_ij x_{j,t} - gamma g(x_{i,t}),
  the full state on the wire every iteration; exact on time-varying
  schedules (each step mixes with W(t)).
* DC-DSGD (Tang et al. 2018) is exactly ``SDMConfig(theta=1.0)``.

Both may use the same clipping and Gaussian masking as SDM-DSGD through
``sdm_dsgd.masked_grad``. ``dsgd_distributed_step`` is DSGD's per-node
step on a node block (``core/transport.py``): the full wire plane
crosses every round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import prng, tree as tree_mod
from repro_torch.core import gossip, plane as plane_mod
from repro_torch.core.sdm_dsgd import SDMConfig, masked_grad

__all__ = ["DSGDConfig", "DSGDState", "DSGDReference", "dcdsgd_config",
           "dsgd_distributed_step"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class DSGDConfig:
    gamma: float = 0.01
    sigma: float = 0.0
    clip_c: float | None = None


def dcdsgd_config(p: float, gamma: float, sigma: float = 0.0,
                  clip_c: float | None = None) -> SDMConfig:
    """DC-DSGD == SDM-DSGD with theta fixed to 1 (no state mixing)."""
    return SDMConfig(p=p, theta=1.0, gamma=gamma, sigma=sigma, clip_c=clip_c)


class DSGDState(NamedTuple):
    x: PyTree
    step: int


class DSGDReference:
    """Stacked single-device DSGD, mirroring ReferenceSimulator's API."""

    def __init__(self, topo, cfg: DSGDConfig):
        self.cfg = cfg
        self.seq = gossip.sequence_of(topo)
        self._wstack = torch.tensor(self.seq.weights_stack(),
                                    dtype=torch.float32)
        self.weights = self._wstack[0]

    def init(self, params_stack: PyTree) -> DSGDState:
        self._wstack = self._wstack.to(
            tree_mod.leaves(params_stack)[0].device)
        self.weights = self._wstack[0]
        return DSGDState(x=params_stack, step=0)

    def step(self, state: DSGDState, grad_fn, batch_stack: PyTree,
             key) -> Tuple[DSGDState, Any]:
        grads, aux = grad_fn(state.x, batch_stack)
        g = masked_grad(grads, key, sigma=self.cfg.sigma,
                        clip_c=self.cfg.clip_c)
        w_t = self._wstack[state.step % self.seq.length]
        x = tree_mod.tree_map(
            lambda xs, gs: gossip.mix_dense(w_t, xs)
            - self.cfg.gamma * gs.to(xs.dtype), state.x, g)
        return DSGDState(x=x, step=state.step + 1), aux

    def consensus_mean(self, state: DSGDState) -> PyTree:
        return tree_mod.tree_map(lambda x: torch.mean(x, dim=0), state.x)

    consensus = consensus_mean

    def eval_params(self, state: DSGDState) -> PyTree:
        return state.x


def dsgd_distributed_step(state: DSGDState, grads: PyTree, *, base_key,
                          transport, cfg: DSGDConfig, schedule=None,
                          self_weight: float | None = None) -> DSGDState:
    """Per-node DSGD step on a node block: x <- W_ii x + sum_j W_ij x_j
    - gamma g, the whole wire plane crossing every round of the step's
    schedule (``None``: the ring with scalar ``self_weight``)."""
    seq = gossip.resolve_sequence(schedule, transport, self_weight)
    me = transport.me
    base_key = prng.key_data(base_key).to(me.device)
    sw = seq.self_weight_of(me, state.step)
    noise_key = prng.fold_in(
        gossip.node_round_key(base_key, me, state.step), 0x5eed)
    g = masked_grad(grads, noise_key, sigma=cfg.sigma, clip_c=cfg.clip_c)
    spec = plane_mod.ParamPlane.for_stacked(state.x)
    mixed = spec.unpack_stacked(tuple(
        p * gossip.per_node(sw, p)
        + gossip.exchange(seq, p, transport, step=state.step)
        for p in spec.pack_stacked(state.x)))
    x = tree_mod.tree_map(lambda m, gr: m - cfg.gamma * gr.to(m.dtype),
                          mixed, g)
    return DSGDState(x=x, step=state.step + 1)
