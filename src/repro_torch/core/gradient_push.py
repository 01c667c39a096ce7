"""Gradient-push (stochastic gradient push, DP-CSGP-style) over directed
graphs.

Port of ``repro.core.gradient_push``. Push-sum mixes with a column-
stochastic P (every sender splits its mass over its out-edges) and a
scalar mass w that mixes the same way, so the de-biased z = x / w tracks
the average although P is not row-stochastic:

    z_i       = x_i / w_i                       # de-biased estimate
    x_i^half  = x_i - gamma * g_i(z_i)          # local (masked) step
    x_i      <- sum_j P_ij(t) x_j^half          # push values
    w_i      <- sum_j P_ij(t) w_j               # push mass

Column-stochasticity conserves sum x and sum w, so sum x / sum w is the
running average (``consensus``). Clipping and Gaussian masking are
``sdm_dsgd.masked_grad``'s.

The compressed variant (``GradientPushConfig.compressor``) is CHOCO /
DP-CSGP-style error-compensated push-sum: each node keeps a public copy
xhat_i that its neighbours replicate and sends only the compressed
differential

    delta_i  = C_contr(x_i^half - xhat_i)       # the only payload
    xhat_i  += delta_i
    x_i      = x_i^half + chi [(P - I) xhat]_i  # damped consensus
    w_i      = w_i      + chi [(P - I) w]_i

with ``C_contr`` the contractive form of the compressor (a sparsifier's
payload values times the sender's p; quantizers ship as they are) and
chi the CHOCO step. On static schedules receivers keep the neighbour
sum s_i = sum_{j != i} P_ij xhat_j incrementally (optionally one step
stale, ``overlap``); on genuinely time-varying schedules the increments
land in per-neighbour replicas (``xhat_nb``, one slot per union round)
and s_i is recomputed with the current round's weights.

``GradientPushReference`` is the stacked single-device executor;
``gradient_push_distributed_step`` the per-node one on a node block
(``core/transport.py``), riding the same payload transport as SDM's
qsgd path (``sdm_dsgd._plane_payload_exchange``, key
``node_round_key(fold_in(base, bucket), node, step)``). The step
counter is a host int. With ``overlap`` the state's ``nb`` holds the
exchange started at step t still in flight (``transport.Pending``), waited
on at step t+1 just before it is folded into s. The JAX package's
``tagging.pending_buffer`` marks are identities its analyzer reads; the
port does not carry them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.core import compressor as compressor_mod, gossip
from repro_torch.core import plane as plane_mod
from repro_torch.core.transport import settle
from repro_torch.core.sdm_dsgd import (_key_on, _node_noise_key,
                                       _plane_payload_exchange,
                                       _replica_planes, masked_grad,
                                       sparsify_planes_stacked)

__all__ = ["GradientPushConfig", "GradientPushState", "GradientPushReference",
           "init_push_state", "init_compressed_push_state",
           "gradient_push_distributed_step"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GradientPushConfig:
    """Push-sum hyper-parameters (see ``repro.core.gradient_push``).

    ``compressor`` (a ``core.compressor`` spec) switches on the error-
    compensated compressed variant with transmit budget ``p``; ``chi`` is
    the CHOCO consensus step on the public copies. ``overlap`` (compressed
    variant, static schedules only) folds the neighbour increments into s
    one step late; the mass w stays synchronous.
    """

    gamma: float = 0.01
    sigma: float = 0.0
    clip_c: float | None = None
    compressor: str | None = None
    p: "float | Tuple[float, ...]" = 0.2
    chi: float = 0.3
    overlap: bool = False

    def __post_init__(self) -> None:
        if isinstance(self.p, (list, tuple)):
            object.__setattr__(self, "p", tuple(float(v) for v in self.p))
        if not (0.0 < self.chi <= 1.0):
            raise ValueError("chi in (0, 1]")
        if self.overlap and self.compressor is None:
            raise ValueError(
                "overlap=True is a differential-transport feature: the "
                "uncompressed push mixes ABSOLUTE state, which has no "
                "S(0)=0 staleness invariant -- set a compressor")
        if self.compressor is not None:
            compressor_mod.make(self.compressor, p=self.p)  # fail fast

    def make_compressor(self) -> "compressor_mod.Compressor | None":
        if self.compressor is None:
            return None
        return compressor_mod.make(self.compressor, p=self.p)


class GradientPushState(NamedTuple):
    x: PyTree             # push numerator, stacked (n, ...) / block (L, ...)
    w: torch.Tensor       # push-sum mass, (n,) / (L,) f32
    step: int             # iteration counter
    xhat: PyTree = None   # public copy (compressed; the executor: planes)
    s: PyTree = None      # sum_{j != i} P_ij xhat_j (compressed, static)
    xhat_nb: PyTree = None  # replica planes (L, n_replicas, rows, lane)
    nb: PyTree = None     # overlap: last step's pending increments


def _debias(x_tree: PyTree, w: torch.Tensor) -> PyTree:
    """z = x / w with w broadcast over each leaf's trailing dims."""
    def one(x):
        wb = w.reshape(tuple(w.shape) + (1,) * (x.dim() - w.dim()))
        return torch.div(x, wb).to(x.dtype)
    return tree_mod.tree_map(one, x_tree)


def _contraction_scale(comp: compressor_mod.Compressor, node=None):
    """Per-sender factor turning the unbiased compressor contractive: the
    sender's p for a sparsifier (an f32 gather of a per-node tuple), 1
    for a quantizer."""
    if isinstance(comp, compressor_mod.QSGDCompressor):
        return 1.0
    if isinstance(comp.p, tuple):
        return comp.p_of(node, device=node.device
                         if isinstance(node, torch.Tensor) else "cpu")
    return comp.p


def _contract_payload(comp, pl, node=None):
    """The payload with its values times the sender's contraction
    factor (per node of a batched payload)."""
    scale = _contraction_scale(comp, node)
    if isinstance(scale, float) and scale == 1.0:
        return pl
    if isinstance(scale, torch.Tensor):
        scale = scale.reshape(tuple(scale.shape) + (1,) * (
            pl.values.dim() - scale.dim()))
    return dataclasses.replace(pl, values=(pl.values * scale).to(
        pl.values.dtype))


class GradientPushReference:
    """Stacked single-device gradient-push, mirroring ReferenceSimulator."""

    def __init__(self, topo, cfg: GradientPushConfig):
        self.cfg = cfg
        self.seq = gossip.sequence_of(topo)
        self._wstack = torch.tensor(self.seq.weights_stack(),
                                    dtype=torch.float32)   # (L, n, n)
        self.weights = self._wstack[0]
        self.comp = cfg.make_compressor()
        # genuinely time-varying P(t): recompute the neighbour sum fresh
        # from the public copies every round
        self.replica_exact = (self.comp is not None
                              and gossip.needs_replicas(self.seq))
        if cfg.overlap and gossip.needs_replicas(self.seq):
            raise ValueError(
                "overlap=True needs a static (non-replica) schedule")

    def init(self, params_stack: PyTree) -> GradientPushState:
        """The mixing weights move to the params' device."""
        first = tree_mod.leaves(params_stack)[0]
        n = first.shape[0]
        assert n == self.seq.n_nodes, (n, self.seq.n_nodes)
        self._wstack = self._wstack.to(first.device)
        self.weights = self._wstack[0]
        base = GradientPushState(
            x=params_stack,
            w=torch.ones(n, dtype=torch.float32, device=first.device),
            step=0)
        if self.comp is None:
            return base
        if self.replica_exact:
            return base._replace(xhat=params_stack)
        # exact replica bookkeeping: s_0[i] = sum_{j != i} P_ij x_{j,0}
        s0 = tree_mod.tree_map(
            lambda x: gossip.apply_weights_dense(
                self.weights, x, include_self=False).to(x.dtype),
            params_stack)
        nb = tree_mod.tree_map(torch.zeros_like, params_stack) \
            if self.cfg.overlap else None
        return base._replace(xhat=params_stack, s=s0, nb=nb)

    def step(self, state: GradientPushState, grad_fn, batch_stack: PyTree,
             key) -> Tuple[GradientPushState, Any]:
        cfg = self.cfg
        z = _debias(state.x, state.w)
        grads, aux = grad_fn(z, batch_stack)
        g = masked_grad(grads, key, sigma=cfg.sigma, clip_c=cfg.clip_c)
        x_half = tree_mod.tree_map(
            lambda x, gr: x - cfg.gamma * gr.to(x.dtype), state.x, g)
        p_t = self._wstack[int(state.step) % self.seq.length]
        if self.comp is None:
            x = tree_mod.tree_map(lambda v: gossip.mix_dense(p_t, v), x_half)
            return GradientPushState(x=x, w=p_t @ state.w,
                                     step=state.step + 1), aux

        # -- compressed: transmit C_contr(x_half - xhat) only --------------
        n = self.seq.n_nodes
        comp = self.comp
        delta = tree_mod.tree_map(torch.sub, x_half, state.xhat)
        delta_hat = sparsify_planes_stacked(
            comp, delta, key, state.step, n,
            transform=lambda pl, nodes: _contract_payload(comp, pl,
                                                          node=nodes))
        xhat = tree_mod.tree_map(torch.add, state.xhat, delta_hat)
        nb = None
        if self.replica_exact:
            s = tree_mod.tree_map(
                lambda xh: gossip.apply_weights_dense(
                    p_t, xh, include_self=False).to(xh.dtype), xhat)
        elif cfg.overlap:
            # one-step-stale: consume last step's pending increments
            s = tree_mod.tree_map(torch.add, state.s, state.nb)
            nb = tree_mod.tree_map(
                lambda dh, s_: gossip.apply_weights_dense(
                    p_t, dh, include_self=False).to(s_.dtype),
                delta_hat, s)
        else:
            s = tree_mod.tree_map(
                lambda s_, dh: s_ + gossip.apply_weights_dense(
                    p_t, dh, include_self=False).to(s_.dtype),
                state.s, delta_hat)
        diag = torch.diagonal(p_t)
        # x <- x_half + chi ((P - I) xhat); the mass mixes with the same
        # damped column-stochastic operator
        x = tree_mod.tree_map(
            lambda xh, xp, ss: xh + cfg.chi * (gossip.per_node(diag, xh) * xp
                                               + ss - xp),
            x_half, xhat, s)
        w = state.w + cfg.chi * (p_t @ state.w - state.w)
        return GradientPushState(x=x, w=w, step=state.step + 1, xhat=xhat,
                                 s=None if self.replica_exact else s,
                                 nb=nb), aux

    def consensus_mean(self, state: GradientPushState) -> PyTree:
        """sum_i x_i / sum_i w_i (exact by mass conservation)."""
        return tree_mod.tree_map(
            lambda x: torch.div(torch.sum(x, dim=0), torch.sum(state.w)),
            state.x)

    consensus = consensus_mean

    def eval_params(self, state: GradientPushState) -> PyTree:
        """Per-node de-biased estimates z_i (what training evaluates)."""
        return _debias(state.x, state.w)


# ==========================================================================
# Per-node executor on a node block (the JAX package's shard_map code).
# ==========================================================================

def _copy_params(params: PyTree) -> PyTree:
    return tree_mod.tree_map(
        lambda v: torch.clone(v, memory_format=torch.contiguous_format),
        params)


def _ones_like_block(params: PyTree) -> torch.Tensor:
    first = tree_mod.leaves(params)[0]
    return torch.ones(first.shape[0], dtype=torch.float32,
                      device=first.device)


def init_push_state(params: PyTree) -> GradientPushState:
    """A node block's state (``params`` leaves with the block's leading
    dim L, copied into the state); every mass starts at 1."""
    return GradientPushState(x=_copy_params(params),
                             w=_ones_like_block(params), step=0)


def init_compressed_push_state(params: PyTree, nb_row_sum: torch.Tensor,
                               n_replicas: int | None = None,
                               overlap: bool = False) -> GradientPushState:
    """Compressed-variant block state. ``nb_row_sum`` is the (L,) sum_{j
    != i} P_ij of the block's nodes (every node starts at the same x_0,
    so s_0 = nb_row_sum x_0). ``n_replicas`` (genuinely time-varying
    schedules) allocates the per-neighbour replica planes instead of s.
    ``xhat`` / ``s`` / ``xhat_nb`` are f32 wire planes."""
    x0 = _copy_params(params)
    xp = plane_mod.ParamPlane.for_stacked(x0).pack_stacked(x0)
    w0 = _ones_like_block(params)
    if n_replicas:
        if overlap:
            raise ValueError("overlap=True needs a static (non-replica) "
                             "schedule")
        return GradientPushState(x=x0, w=w0, step=0, xhat=xp, s=None,
                                 xhat_nb=_replica_planes(xp, n_replicas))
    s0 = tuple(gossip.per_node(nb_row_sum, p) * p for p in xp)
    nb0 = tuple(torch.zeros_like(p) for p in xp) if overlap else None
    return GradientPushState(x=x0, w=w0, step=0, xhat=xp, s=s0, nb=nb0)


def gradient_push_distributed_step(state: GradientPushState, grads: PyTree,
                                   *, base_key, transport,
                                   cfg: GradientPushConfig,
                                   schedule=None) -> GradientPushState:
    """Per-node push step on the node block (grads evaluated at z = x / w).

    The mass w rides the step's schedule rounds beside the payload (one
    4-byte row per round). With ``cfg.compressor`` only the compressed
    differential crosses the wire for the model (``exchange_payload``, or
    every union round on a genuinely time-varying schedule).
    """
    seq = gossip.resolve_sequence(schedule, transport)
    me = transport.me
    base_key = _key_on(base_key, me.device)
    step = state.step
    sw = seq.self_weight_of(me, step)
    comp = cfg.make_compressor()
    g = masked_grad(grads, _node_noise_key(base_key, me, step),
                    sigma=cfg.sigma, clip_c=cfg.clip_c)
    x_half = tree_mod.tree_map(
        lambda x, gr: x - cfg.gamma * gr.to(x.dtype), state.x, g)
    del g
    w_push = sw * state.w + gossip.exchange(seq, state.w, transport,
                                            step=step)
    spec = plane_mod.ParamPlane.for_stacked(state.x)
    if comp is None:
        # the full state rides the wire plane: R permutes per step
        hp = spec.pack_stacked(x_half)
        x = spec.unpack_stacked(tuple(
            gossip.per_node(sw, p) * p + gossip.exchange(seq, p, transport,
                                                   step=step)
            for p in hp))
        return GradientPushState(x=x, w=w_push, step=step + 1)

    delta = tuple(h - xh for h, xh in zip(spec.pack_stacked(x_half),
                                          state.xhat))

    def contract(pl):
        return _contract_payload(comp, pl, node=me)

    s_store = nb_store = None
    if gossip.needs_replicas(seq):
        if cfg.overlap:
            raise ValueError("overlap=True needs a static (non-replica) "
                             "schedule")
        # increments cross every union edge every round (exact replicas);
        # the neighbour sum is recomputed with P(t)'s weights, not stored
        useq = gossip.union_schedule(seq)
        delta_hat, incr = _plane_payload_exchange(
            delta, comp, transport, base_key=base_key, step=step, useq=useq,
            transform=contract)
        xhat = tuple(xh + dh for xh, dh in zip(state.xhat, delta_hat))
        xhat_nb = tuple(r + inc for r, inc in zip(state.xhat_nb, incr))
        wv = gossip.replica_recv_weights(useq, me, step)      # (L, R)
        s = []
        for r in xhat_nb:
            acc = torch.zeros_like(r[:, 0])
            for k in range(r.shape[1]):
                acc = acc + gossip.per_node(wv[:, k], acc) * r[:, k]
            s.append(acc)
    else:
        delta_hat, nb_sum = _plane_payload_exchange(
            delta, comp, transport, base_key=base_key, step=step,
            schedule=seq, transform=contract, defer=cfg.overlap)
        xhat = tuple(xh + dh for xh, dh in zip(state.xhat, delta_hat))
        xhat_nb = state.xhat_nb
        if cfg.overlap:
            # consume last step's pending deliveries (waited on here);
            # this step's stay in flight until the next step
            s = tuple(s_ + settle(p_) for s_, p_ in zip(state.s, state.nb))
            nb_store = nb_sum
        else:
            s = tuple(s_ + nb for s_, nb in zip(state.s, nb_sum))
        s_store = s
    # x <- x_half + chi ((P - I) xhat); the mass rides the same damped
    # operator M = I + chi (P - I)
    corr = tuple(cfg.chi * (gossip.per_node(sw, xh) * xh + ss - xh)
                 for xh, ss in zip(xhat, s))
    x = tree_mod.tree_map(torch.add, x_half, spec.unpack_stacked(corr))
    w = state.w + cfg.chi * (w_push - state.w)
    return GradientPushState(x=x, w=w, step=step + 1, xhat=xhat, s=s_store,
                             xhat_nb=xhat_nb, nb=nb_store)
