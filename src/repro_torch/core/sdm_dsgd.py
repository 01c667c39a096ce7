"""SDM-DSGD (Algorithm 1): the stacked reference and the per-node executor.

Port of ``repro.core.sdm_dsgd``. Per node i, per iteration t (paper
Eq. (3)):

    x_t = x_{t-1} + S(d_{t-1})                 # everyone advances public copies
    y_t = (1-theta) x_t
          + theta * (W~ x_t - gamma (grad f(x_t; batch) + eta)),  eta~N(0, sigma^2 I)
    d_t = y_t - x_t

``ReferenceSimulator`` holds all n nodes stacked on a leading axis of
one device and gossips by dense W (any topology; time-varying schedules
mix with the current round's W(t)). Each node's S(d) is a compressor
roundtrip over its zero-padded wire plane, drawn with the same keys as
the JAX package (``node_round_key(fold_in(key, bucket), node, step)``),
so the two packages sparsify the same coordinates.

The per-node executor (``init_distributed_state``, ``distributed_advance``,
``distributed_commit``, ``distributed_step_fused``) is the counterpart of
the JAX package's shard_map code. It works on a NODE BLOCK
(``core/transport.py``): every state tensor has a leading dim L of the
nodes the caller holds, ``transport.me`` their indices, and the gossip
rides ``transport.ppermute``. The state keeps the JAX layout: ``x`` the
parameter tree, ``s`` / ``d`` (and the replica stack ``xhat``) f32 wire
planes. With ``overlap`` the buffer ``nb`` holds the neighbour sums of
the exchange started at step t still in flight (``transport.Pending``,
one a bucket): step t+1 waits on them just before it folds them into
``s``, so the exchange rides under step t+1's gradient; at step 0 it
holds zero planes. ``transport.settle`` waits on what a run leaves
pending. Without ``overlap`` every exchange completes on the current
stream inside its step. The step counter is a host int
shared by the block. Where the JAX functions return a new state, the
port updates the state's buffers in place (x, s, the replicas, and d's
storage for the next differential): the same numbers, without a second
copy of every buffer at full width. ``init_*`` copy the params they are
given into the state. The JAX package's ``tagging`` marks (``sanitize``,
``pending_buffer``) are identities that only its static analyzer reads;
the port does not carry them.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import prng, tree as tree_mod
from repro_torch.core import clipping, compressor as compressor_mod, gossip
from repro_torch.core import plane as plane_mod
from repro_torch.core.topology import Topology
from repro_torch.core.transport import Pending

__all__ = ["SDMConfig", "SDMState", "SDMFusedState", "ReferenceSimulator",
           "masked_grad", "compressor_of", "wire_shape_tree",
           "sparsify_planes_stacked", "schedule_degree_factor",
           "transmitted_elements_per_step", "transmitted_bits_per_step",
           "check_per_node_p", "init_distributed_state", "init_fused_state",
           "distributed_advance", "distributed_commit",
           "distributed_step_fused"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class SDMConfig:
    """Hyper-parameters of Algorithm 1 (see ``repro.core.sdm_dsgd``).

    ``compressor`` selects the wire format by name ('bernoulli' |
    'fixedk[:block]' | 'block:<B>' | 'rows' | 'qsgd[:bits]' |
    'qsgdf[:bits]'); ``mode`` is derived from it (or given in the legacy
    spelling). ``p`` may be a per-node tuple (bernoulli / fixedk only).
    ``error_feedback`` carries the unsent residual into the next round;
    ``overlap`` mixes one-step-stale neighbour increments (static
    schedules only).
    """

    p: "float | Tuple[float, ...]" = 0.2
    theta: float = 0.6
    gamma: float = 0.01
    sigma: float = 0.0
    clip_c: float | None = None
    mode: str = "bernoulli"
    pack_block: int = 1
    compressor: str | None = None
    qsgd_bits: int = 8
    error_feedback: bool = False
    overlap: bool = False

    def __post_init__(self) -> None:
        if self.compressor is not None:
            comp = compressor_mod.make(self.compressor, p=self.p)
            # FusedQSGD before QSGD: it is a subclass, and mapping it to
            # mode="qsgd" would rebuild a plain QSGDCompressor.
            if isinstance(comp, compressor_mod.FusedQSGDCompressor):
                object.__setattr__(self, "mode", "payload")
                object.__setattr__(self, "qsgd_bits", comp.bits)
            elif isinstance(comp, compressor_mod.QSGDCompressor):
                object.__setattr__(self, "mode", "qsgd")
                object.__setattr__(self, "qsgd_bits", comp.bits)
            elif isinstance(comp, compressor_mod.RowsCompressor):
                object.__setattr__(self, "mode", "fixedk_rows")
            elif isinstance(comp, compressor_mod.FixedKCompressor):
                object.__setattr__(self, "mode", "fixedk_packed")
                object.__setattr__(self, "pack_block", comp.block)
            elif isinstance(comp, compressor_mod.BernoulliCompressor):
                object.__setattr__(self, "mode", "bernoulli")
            else:
                object.__setattr__(self, "mode", "payload")
        if self.error_feedback and self.mode in ("qsgd", "payload"):
            raise ValueError("error_feedback is a sparsifier-path "
                             f"extension; unsupported with mode={self.mode!r}")
        if isinstance(self.p, (list, tuple)):
            object.__setattr__(self, "p", tuple(float(v) for v in self.p))
            if not self.p:
                raise ValueError("per-node p must be non-empty")
            if any(not (0.0 < v <= 1.0) for v in self.p):
                raise ValueError("every per-node p must be in (0,1]")
            if self.mode not in ("bernoulli", "fixedk_packed"):
                raise ValueError(
                    "heterogeneous per-node p needs mode='bernoulli' or "
                    "'fixedk_packed' (pad-to-max-k payloads); "
                    f"got mode={self.mode!r}")
            if self.error_feedback:
                raise ValueError(
                    "error_feedback with per-node p is unsupported")
        elif not (0.0 < self.p <= 1.0):
            raise ValueError("p in (0,1]")
        if not (0.0 < self.theta <= 1.0):
            raise ValueError("theta in (0,1]")
        if self.mode not in ("bernoulli", "fixedk_packed", "fixedk_rows",
                             "qsgd", "payload"):
            raise ValueError(f"unknown mode {self.mode}")
        if self.mode == "payload" and not self.compressor:
            raise ValueError("mode='payload' needs a compressor spec")

    @property
    def p_min(self) -> float:
        return min(self.p) if isinstance(self.p, tuple) else self.p

    def validate_against(self, topo: Topology, L: float = 1.0) -> None:
        """Assert Lemma 1's theta < 2 p_min / (1 - lambda_n + gamma L)."""
        bound = 2.0 * self.p_min / (1.0 - topo.lambda_n + self.gamma * L)
        if self.theta >= bound:
            raise ValueError(
                f"theta={self.theta} >= Lemma-1 bound {bound:.4g} "
                f"(p={self.p}, lambda_n={topo.lambda_n:.4g})")


class SDMState(NamedTuple):
    x: PyTree         # public copies, stacked (n, ...) / node block (L, ...)
    s: PyTree         # neighbour sum (the executor: a tuple of f32 planes)
    d: PyTree         # differential pending transmission (planes likewise)
    step: int         # iteration counter
    e: PyTree = None  # error-feedback residual (reference only)
    xhat: PyTree = None   # executor replica planes (L, n_replicas, rows, lane)
    nb: PyTree = None     # overlap: the pending exchange (or zero planes)


def _zeros_like(t: PyTree) -> PyTree:
    return tree_mod.tree_map(torch.zeros_like, t)


def _add_noise(key, tree: PyTree, sigma: float) -> PyTree:
    """x + sigma * N(0, 1) per leaf, leaf i drawn with ``fold_in(key, i)``
    in JAX's flatten order, one leaf at a time (one leaf's noise alive at
    once). One key draws at the leaf's full (stacked) shape; a batch of
    L keys (the executor's node block) draws each node's row at the
    per-node shape."""
    key = prng.key_data(key)
    lead = key.dim() - 1
    leaves, struct = tree_mod.flatten(tree)
    out = []
    for i, x in enumerate(leaves):
        noise = prng.normal(prng.fold_in(key, i), tuple(x.shape[lead:]),
                            dtype=x.dtype).to(x.device)
        out.append(x + sigma * noise)
    return tree_mod.unflatten(struct, out)


def check_per_node_p(cfg, n_nodes: int) -> None:
    """Reject a per-node p tuple whose length mismatches the graph."""
    if isinstance(getattr(cfg, "p", None), tuple) and len(cfg.p) != n_nodes:
        raise ValueError(
            f"per-node p has {len(cfg.p)} entries for {n_nodes} nodes")


def compressor_of(cfg) -> compressor_mod.Compressor:
    """The Compressor object a config's wire format resolves to."""
    if cfg.mode == "bernoulli":
        return compressor_mod.BernoulliCompressor(p=cfg.p)
    if cfg.mode == "fixedk_packed":
        return compressor_mod.FixedKCompressor(p=cfg.p, block=cfg.pack_block)
    if cfg.mode == "fixedk_rows":
        return compressor_mod.RowsCompressor(p=cfg.p)
    if cfg.mode == "qsgd":
        return compressor_mod.QSGDCompressor(bits=cfg.qsgd_bits)
    if cfg.mode == "payload":
        return compressor_mod.make(cfg.compressor, p=cfg.p)
    raise ValueError(f"unknown mode {cfg.mode}")


def masked_grad(grads: PyTree, key, *, sigma: float,
                clip_c: float | None) -> PyTree:
    """clip (optional) then Gaussian-mask: g_hat = clip(g) + eta."""
    if clip_c is not None:
        grads = clipping.clip_tree(grads, clip_c)
    if sigma > 0.0:
        grads = _add_noise(key, grads, sigma)
    return grads


def _key_on(key, device) -> torch.Tensor:
    return prng.key_data(key).to(device)


def sparsify_planes_stacked(comp: compressor_mod.Compressor,
                            tree_stacked: PyTree, key, step,
                            n: int, transform=None) -> PyTree:
    """Plane-granular compressor roundtrip of a node-stacked tree.

    Each bucket's zero-padded plane is compressed whole, per node, with
    key ``node_round_key(fold_in(key, bucket), node, step)`` -- one
    batched call over the n nodes (the JAX package vmaps it).
    ``transform(payload, nodes)`` optionally rewrites the batched payload
    before the roundtrip (compressed push-sum's contraction).
    """
    spec = plane_mod.ParamPlane.for_stacked(tree_stacked)
    planes = spec.pack_stacked(tree_stacked)
    out = []
    for b, dpl in enumerate(planes):
        bkey = prng.fold_in(_key_on(key, dpl.device), b)
        nodes = torch.arange(n, device=dpl.device)
        node_keys = gossip.node_round_key(bkey, nodes, step)
        pl = comp.compress(node_keys, dpl, node=nodes)
        if transform is not None:
            pl = transform(pl, nodes)
        out.append(comp.decompress(pl))
    return spec.unpack_stacked(tuple(out))


def schedule_degree_factor(seq, node: "int | None" = None) -> Fraction:
    """Payload transmissions per node per step on ``seq`` (exact): the
    mean out-degree, union-graph degree on the replica transport, 1 for
    ``seq=None``."""
    if seq is None:
        return Fraction(1)
    seq = gossip.sequence_of(seq)
    return gossip.mean_out_degree(seq, union=gossip.needs_replicas(seq),
                                  node=node)


def wire_shape_tree(params: PyTree) -> Tuple[plane_mod.ShapeDtype, ...]:
    """The plane-shaped tree the wire accounting runs over."""
    return plane_mod.ParamPlane.for_tree(params).shape_dtype()


def transmitted_elements_per_step(params: PyTree, cfg: SDMConfig,
                                  node: int | None = None, *,
                                  seq=None) -> int:
    """Expected non-zero elements one node transmits per iteration (the
    paper's Fig-3 metric) at wire-plane granularity, per link if ``seq``."""
    comp = compressor_of(cfg)
    wire = wire_shape_tree(params)
    if isinstance(cfg.p, tuple) and cfg.mode != "qsgd" and node is None:
        exact = compressor_mod.node_mean_exact(
            cfg.p, lambda i: compressor_mod.tree_wire_elements_exact(
                comp, wire, node=i))
    else:
        exact = compressor_mod.tree_wire_elements_exact(comp, wire,
                                                        node=node)
    return int(round(exact * schedule_degree_factor(seq, node)))


def transmitted_bits_per_step(params: PyTree, cfg: SDMConfig,
                              node: int | None = None, *,
                              value_bits: int = 32,
                              index_sync: bool = True,
                              seq=None) -> int:
    """Exact wire bits one node transmits per iteration, per link if
    ``seq`` (the element count's honest companion)."""
    comp = compressor_of(cfg)
    wire = wire_shape_tree(params)
    kw = dict(value_bits=value_bits, index_sync=index_sync)
    if isinstance(cfg.p, tuple) and cfg.mode != "qsgd" and node is None:
        exact = compressor_mod.node_mean_exact(
            cfg.p, lambda i: compressor_mod.tree_wire_bits_exact(
                comp, wire, node=i, **kw))
    else:
        exact = compressor_mod.tree_wire_bits_exact(comp, wire, node=node,
                                                    **kw)
    return int(round(exact * schedule_degree_factor(seq, node)))


class ReferenceSimulator:
    """Single-device n-node stacked simulator (the paper's experiments).

    Accepts a ``Topology``, a ``PermuteSchedule`` or a time-varying
    ``ScheduleSequence``. Static graphs mix with the dense W; weight-
    invariant sequences and ``overlap`` keep an incremental neighbour sum
    ``s``; genuinely time-varying sequences mix with the current round's
    full W(t) (``replica_exact``).
    """

    def __init__(self, topo, cfg: SDMConfig):
        self.cfg = cfg
        self.seq = gossip.sequence_of(topo)
        check_per_node_p(cfg, self.seq.n_nodes)
        self.replica_exact = gossip.needs_replicas(self.seq)
        self.time_varying = self.seq.length > 1 and not self.replica_exact
        if cfg.overlap and self.replica_exact:
            raise ValueError(
                "overlap=True is a static-schedule (non-replica) transport: "
                "genuinely time-varying weights recompute s from replicas "
                "every round and cannot consume increments one step late")
        self._wstack = torch.tensor(self.seq.weights_stack(),
                                    dtype=torch.float32)   # (L, n, n)
        self.weights = self._wstack[0]

    def _weights_at(self, step: int) -> torch.Tensor:
        return self._wstack[int(step) % self.seq.length]

    def init(self, params_stack: PyTree) -> SDMState:
        """params_stack leaves have leading dim n (one slice per node);
        the mixing weights move to their device."""
        first = tree_mod.leaves(params_stack)[0]
        n = first.shape[0]
        assert n == self.seq.n_nodes, (n, self.seq.n_nodes)
        self._wstack = self._wstack.to(first.device)
        self.weights = self._wstack[0]
        e = _zeros_like(params_stack) if self.cfg.error_feedback else None
        if self.replica_exact:
            s = None
        elif self.time_varying or self.cfg.overlap:
            s = tree_mod.tree_map(
                lambda x: gossip.apply_weights_dense(
                    self._wstack[0], x, include_self=False).to(x.dtype),
                params_stack)
        else:
            s = _zeros_like(params_stack)
        nb = _zeros_like(params_stack) if self.cfg.overlap else None
        return SDMState(x=params_stack, s=s, d=_zeros_like(params_stack),
                        step=0, e=e, nb=nb)

    # -- phase 1: everyone transmits S(d) and advances public copies ------
    def advance(self, state: SDMState, key) -> Tuple[SDMState, PyTree]:
        """Returns (state with x <- x + S(d), the S(d) stack)."""
        cfg = self.cfg
        n = self.seq.n_nodes
        if cfg.error_feedback:
            d_in = tree_mod.tree_map(torch.add, state.d, state.e)
        else:
            d_in = state.d
        ef_scale = cfg.p if cfg.error_feedback else 1.0
        sd = sparsify_planes_stacked(compressor_of(cfg), d_in, key,
                                     state.step, n)
        if cfg.error_feedback and ef_scale != 1.0:
            sd = tree_mod.tree_map(lambda v: v * ef_scale, sd)
        x = tree_mod.tree_map(torch.add, state.x, sd)
        new_e = tree_mod.tree_map(torch.sub, d_in, sd) \
            if cfg.error_feedback else state.e
        if cfg.overlap:
            # one-step-stale: fold LAST step's increments into s; this
            # step's wait in the pending buffer until the next advance.
            w_t = self._weights_at(state.step)
            s = tree_mod.tree_map(torch.add, state.s, state.nb)
            nb = tree_mod.tree_map(
                lambda v, s_: gossip.apply_weights_dense(
                    w_t, v, include_self=False).to(s_.dtype), sd, s)
            return state._replace(x=x, s=s, e=new_e, nb=nb), sd
        if self.time_varying:
            w_t = self._weights_at(state.step)
            s = tree_mod.tree_map(
                lambda s_, v: s_ + gossip.apply_weights_dense(
                    w_t, v, include_self=False).to(s_.dtype), state.s, sd)
            return state._replace(x=x, s=s, e=new_e), sd
        return state._replace(x=x, e=new_e), sd

    # -- phase 2: local gradient + masking + generalized mixing -----------
    def commit(self, state: SDMState, grads_stack: PyTree, key) -> SDMState:
        cfg = self.cfg
        g = masked_grad(grads_stack, key, sigma=cfg.sigma, clip_c=cfg.clip_c)
        if self.replica_exact:
            w_t = self._weights_at(state.step)
            mixed = tree_mod.tree_map(lambda x: gossip.mix_dense(w_t, x),
                                      state.x)
        elif self.time_varying or cfg.overlap:
            diag_w = torch.diagonal(self._weights_at(state.step))
            mixed = tree_mod.tree_map(
                lambda x, s: diag_w.reshape(
                    (self.seq.n_nodes,) + (1,) * (x.dim() - 1)
                ).to(x.dtype) * x + s,
                state.x, state.s)
        else:
            mixed = tree_mod.tree_map(
                lambda x: gossip.mix_dense(self.weights, x), state.x)
        y = tree_mod.tree_map(
            lambda x, m, gr: (1.0 - cfg.theta) * x
            + cfg.theta * (m - cfg.gamma * gr), state.x, mixed, g)
        d = tree_mod.tree_map(torch.sub, y, state.x)
        return state._replace(d=d, step=state.step + 1)

    def step(self, state: SDMState, grad_fn, batch_stack: PyTree,
             key) -> Tuple[SDMState, Any]:
        """advance -> grads at the new x -> commit.
        ``grad_fn(params_stack, batch_stack) -> (grads_stack, aux)``."""
        k_sp, k_noise = prng.split(key)
        state = self.advance(state, k_sp)[0]    # S(d) is not kept alive
        grads, aux = grad_fn(state.x, batch_stack)
        state = self.commit(state, grads, k_noise)
        return state, aux

    def consensus_mean(self, state: SDMState) -> PyTree:
        """xbar_t = (1/n) sum_i x_{i,t}."""
        return tree_mod.tree_map(lambda x: torch.mean(x, dim=0), state.x)

    consensus = consensus_mean

    def eval_params(self, state: SDMState) -> PyTree:
        return state.x


# ==========================================================================
# Per-node executor on a node block (the JAX package's shard_map code).
# ==========================================================================

def _replica_planes(planes: Tuple[torch.Tensor, ...], n_replicas: int
                    ) -> Tuple[torch.Tensor, ...]:
    """(L, n_replicas, rows, lane) replica planes, every slot at x_0 (the
    identical-start assumption of the s_0 formula)."""
    return tuple(p[:, None].expand((p.shape[0], n_replicas)
                                   + tuple(p.shape[1:])).clone()
                 for p in planes)


def _start_planes(params: PyTree, self_weight, n_replicas, overlap):
    """(x_0, its planes, s_0, xhat_0, nb_0) of a node block's state; x_0
    a contiguous copy of ``params`` (the step updates it in place)."""
    if overlap and n_replicas:
        raise ValueError("overlap=True needs a static (non-replica) "
                         "schedule")
    params = tree_mod.tree_map(
        lambda v: torch.clone(v, memory_format=torch.contiguous_format),
        params)
    xp = plane_mod.ParamPlane.for_stacked(params).pack_stacked(params)
    s0 = tuple(p * (1.0 - gossip.per_node(self_weight, p)) for p in xp)
    xhat = _replica_planes(xp, n_replicas) if n_replicas else None
    nb0 = tuple(torch.zeros_like(p) for p in xp) if overlap else None
    return params, xp, s0, xhat, nb0


def init_distributed_state(params: PyTree, self_weight,
                           n_replicas: int | None = None,
                           overlap: bool = False) -> SDMState:
    """A node block's state. ``params`` leaves have the block's leading
    dim L, every node at the SAME x_0 (same-seed init); then s_0 =
    (1 - W_ii) x_0. ``self_weight`` is a float or the (L,) W_ii of the
    block's nodes. ``n_replicas`` (genuinely time-varying schedules)
    allocates the per-neighbour replica planes."""
    x0, xp, s0, xhat, nb0 = _start_planes(params, self_weight, n_replicas,
                                          overlap)
    d0 = tuple(torch.zeros_like(p) for p in xp)
    return SDMState(x=x0, s=s0, d=d0, step=0, xhat=xhat, nb=nb0)


class SDMFusedState(NamedTuple):
    """Two-buffer state of the fused step (``distributed_step_fused``)."""
    x: PyTree
    s: PyTree
    step: int
    xhat: PyTree = None
    nb: PyTree = None


def init_fused_state(params: PyTree, self_weight,
                     n_replicas: int | None = None,
                     overlap: bool = False) -> SDMFusedState:
    x0, _, s0, xhat, nb0 = _start_planes(params, self_weight, n_replicas,
                                         overlap)
    return SDMFusedState(x=x0, s=s0, step=0, xhat=xhat, nb=nb0)


def _plane_payload_exchange(planes, comp: compressor_mod.Compressor,
                            transport, *, base_key, step, schedule=None,
                            useq=None, transform=None, defer=False):
    """Compressor-payload transport over wire planes: one compress per
    bucket plane (key ``node_round_key(fold_in(base, bucket), me,
    step)``); the payload crosses the static schedule's rounds (weighted
    sum) or every union round (``useq``: per-slot increments).
    ``transform`` rewrites each payload before the wire (compressed
    push-sum's contraction). Shared by SDM's qsgd / payload modes and
    compressed gradient-push. Returns (own decompressed planes, received
    planes); ``defer`` leaves each static-schedule sum in flight (a
    ``Pending`` a plane)."""
    me = transport.me
    own, recv = [], []
    for b, dp in enumerate(planes):
        key = gossip.node_round_key(prng.fold_in(base_key, b), me, step)
        pl = comp.compress(key, dp, node=me)
        if transform is not None:
            pl = transform(pl)
        own.append(comp.decompress(pl))
        if useq is not None:
            recv.append(gossip.union_exchange_payload(
                useq, pl, comp.decompress, transport))
        else:
            pend = gossip.exchange_payload_start(
                schedule, pl, comp.decompress, transport, step=step,
                defer=defer)
            recv.append(pend if defer else pend.wait())
    return tuple(own), tuple(recv)


def _plane_exchange(d_planes, *, schedule, transport, base_key, step,
                    cfg: SDMConfig, defer: bool = False):
    """Static-schedule plane exchange: (own S(d) planes, weighted
    neighbour-sum planes); each bucket's plane compressed / drawn /
    top-k'd once with key ``fold_in(base, bucket)``. ``defer`` leaves
    each neighbour sum in flight (a ``Pending`` a bucket)."""
    comp = compressor_of(cfg)
    if cfg.mode in ("qsgd", "payload"):
        return _plane_payload_exchange(d_planes, comp, transport,
                                       base_key=base_key, step=step,
                                       schedule=schedule, defer=defer)
    me = transport.me
    own, nb = [], []
    for b, dp in enumerate(d_planes):
        bkey = prng.fold_in(base_key, b)
        if cfg.mode == "fixedk_rows":
            o, pend = gossip.exchange_packed_rows_start(
                schedule, dp, transport, base_key=bkey, step=step, p=cfg.p,
                defer=defer)
        elif cfg.mode == "fixedk_packed":
            o, pend = gossip.exchange_packed_start(
                schedule, dp, transport, base_key=bkey, step=step, p=cfg.p,
                block=cfg.pack_block, defer=defer)
        else:   # bernoulli: dense masked plane payload
            key = gossip.node_round_key(bkey, me, step)
            o = comp.decompress(comp.compress(key, dp, node=me))
            pend = gossip.exchange_start(schedule, o, transport, step=step,
                                         defer=defer)
        own.append(o)
        nb.append(pend if defer else pend.wait())
    return tuple(own), tuple(nb)


def _replica_plane_exchange(d_planes, *, useq, transport, base_key, step,
                            cfg: SDMConfig):
    """Replica (union) plane transport: (own planes, per-slot increment
    planes (L, n_replicas, rows, lane)), keys as ``_plane_exchange``."""
    comp = compressor_of(cfg)
    if cfg.mode in ("qsgd", "payload"):
        return _plane_payload_exchange(d_planes, comp, transport,
                                       base_key=base_key, step=step,
                                       useq=useq)
    me = transport.me
    own, incr = [], []
    for b, dp in enumerate(d_planes):
        bkey = prng.fold_in(base_key, b)
        if cfg.mode == "fixedk_rows":
            o, inc = gossip.union_exchange_packed_rows(
                useq, dp, transport, base_key=bkey, step=step, p=cfg.p)
        elif cfg.mode == "fixedk_packed":
            o, inc = gossip.union_exchange_packed(
                useq, dp, transport, base_key=bkey, step=step, p=cfg.p,
                block=cfg.pack_block)
        else:
            key = gossip.node_round_key(bkey, me, step)
            o = comp.decompress(comp.compress(key, dp, node=me))
            inc = gossip.union_exchange(useq, o, transport)
        own.append(o)
        incr.append(inc)
    return tuple(own), tuple(incr)


def _replica_advance_exchange(d_planes, xhat, *, seq, transport, base_key,
                              step, cfg: SDMConfig):
    """Replica-transport advance: (own planes, new xhat, fresh s). Every
    union in-neighbour's increment advances its replica slot, and s is
    recomputed with the CURRENT round's weights (exact W(t)-mixing)."""
    useq = gossip.union_schedule(seq)
    own, incr = _replica_plane_exchange(
        d_planes, useq=useq, transport=transport, base_key=base_key,
        step=step, cfg=cfg)
    for xh, inc in zip(xhat, incr):
        xh.add_(inc)
    del incr
    wv = gossip.replica_recv_weights(useq, transport.me, step)   # (L, R)
    s = []
    for xh in xhat:
        acc = torch.zeros_like(xh[:, 0])
        for k in range(xh.shape[1]):
            acc = acc + gossip.per_node(wv[:, k], acc) * xh[:, k]
        s.append(acc)
    return own, xhat, tuple(s)


def _add_planes_to_tree(x: PyTree, spec, planes) -> None:
    """x += the planes sliced back into x's leaves (each cast to its
    leaf's dtype, as ``unpack`` does), in place, one leaf at a time."""
    leaves = tree_mod.leaves(x)
    for b, plane in zip(spec.buckets, planes):
        flat = plane.reshape(plane.shape[0], -1)
        off = 0
        for i, size in zip(b.leaves, b.sizes):
            leaf = leaves[i]
            leaf.add_(flat[:, off:off + size].reshape(leaf.shape)
                      .to(leaf.dtype))
            off += size


def _add_planes(acc, planes) -> None:
    """acc += planes, in place; a pending plane is waited on first."""
    for a, p in zip(acc, planes):
        a.add_(p.wait() if isinstance(p, Pending) else p)


def distributed_advance(state: SDMState, *, base_key, transport,
                        cfg: SDMConfig, schedule=None,
                        self_weight: float | None = None) -> SDMState:
    """Phase 1 on the node block: sparsify d, exchange, update x and s.

    ``schedule`` is a PermuteSchedule or a time-varying ScheduleSequence
    (round picked by the state's step); ``None`` is the symmetric ring
    with scalar ``self_weight``.
    """
    seq = gossip.resolve_sequence(schedule, transport, self_weight)
    check_per_node_p(cfg, seq.n_nodes)
    base_key = _key_on(base_key, transport.me.device)
    spec = plane_mod.ParamPlane.for_stacked(state.x)
    if gossip.needs_replicas(seq):
        if cfg.overlap:
            raise ValueError("overlap=True needs a static (non-replica) "
                             "schedule")
        own, xhat, s = _replica_advance_exchange(
            state.d, state.xhat, seq=seq, transport=transport,
            base_key=base_key, step=state.step, cfg=cfg)
        _add_planes_to_tree(state.x, spec, own)
        return state._replace(s=s, xhat=xhat)
    own, nb = _plane_exchange(state.d, schedule=seq, transport=transport,
                              base_key=base_key, step=state.step, cfg=cfg,
                              defer=cfg.overlap)
    _add_planes_to_tree(state.x, spec, own)
    del own
    if cfg.overlap:
        # this step mixes the PENDING buffer (last step's exchange, waited
        # on here); the fresh exchange stays in flight until the next step
        _add_planes(state.s, state.nb)
        return state._replace(nb=nb)
    _add_planes(state.s, nb)
    return state


def _node_noise_key(base_key, me: torch.Tensor, step) -> torch.Tensor:
    """fold_in(node_round_key(base, me, step), 0x5eed): (L, 2) keys."""
    return prng.fold_in(gossip.node_round_key(base_key, me, step), 0x5eed)


def _mix(xp, sp, gp, sw, cfg: SDMConfig, out=None
         ) -> Tuple[torch.Tensor, ...]:
    """theta * (W_ii x + s - gamma g) per plane, in the JAX expression's
    rounding order, into fresh buffers or into ``out``'s."""
    res = []
    for i, (x_, s_, g_) in enumerate(zip(xp, sp, gp)):
        t = torch.mul(x_, gossip.per_node(sw, x_),
                      out=None if out is None else out[i])
        t.add_(s_)
        t.sub_(g_ * cfg.gamma)
        res.append(t.mul_(cfg.theta))
    return tuple(res)


def distributed_step_fused(state: SDMFusedState, grads: PyTree, *, base_key,
                           transport, cfg: SDMConfig, schedule=None,
                           self_weight: float | None = None
                           ) -> SDMFusedState:
    """Whole-iteration step, commit_t + advance_{t+1} fused: the
    differential only lives inside the step, so the persistent state is
    (x, s). The gradient is taken at ``state.x`` (already post-advance).
    The sparsifier keys, and a time-varying sequence's round, use
    counter step + 1, as the unfused flow's next advance does."""
    seq = gossip.resolve_sequence(schedule, transport, self_weight)
    check_per_node_p(cfg, seq.n_nodes)
    base_key = _key_on(base_key, transport.me.device)
    me = transport.me
    sw = seq.self_weight_of(me, state.step)
    g = masked_grad(grads, _node_noise_key(base_key, me, state.step),
                    sigma=cfg.sigma, clip_c=cfg.clip_c)
    spec = plane_mod.ParamPlane.for_stacked(state.x)
    xp = spec.pack_stacked(state.x)
    gp = spec.pack_stacked(g)
    del g
    # theta (W_ii x + s - gamma g) - theta x
    d = tuple(t.sub_(x_ * cfg.theta)
              for t, x_ in zip(_mix(xp, state.s, gp, sw, cfg), xp))
    del xp, gp
    sp_step = state.step + 1
    if gossip.needs_replicas(seq):
        if cfg.overlap:
            raise ValueError("overlap=True needs a static (non-replica) "
                             "schedule")
        own, xhat, s = _replica_advance_exchange(
            d, state.xhat, seq=seq, transport=transport, base_key=base_key,
            step=sp_step, cfg=cfg)
        _add_planes_to_tree(state.x, spec, own)
        return SDMFusedState(x=state.x, s=s, step=sp_step, xhat=xhat)
    own, nb = _plane_exchange(d, schedule=seq, transport=transport,
                              base_key=base_key, step=sp_step, cfg=cfg,
                              defer=cfg.overlap)
    del d
    _add_planes_to_tree(state.x, spec, own)
    del own
    if cfg.overlap:
        _add_planes(state.s, state.nb)
        return SDMFusedState(x=state.x, s=state.s, step=sp_step, nb=nb)
    _add_planes(state.s, nb)
    return SDMFusedState(x=state.x, s=state.s, step=sp_step)


def distributed_commit(state: SDMState, grads: PyTree, *, base_key,
                       transport, cfg: SDMConfig, schedule=None,
                       self_weight: float | None = None) -> SDMState:
    """Phase 2 on the node block: masked gradient + generalized mixing,
    the differential produced directly as wire planes:
    y = (1 - theta) x + theta (W_ii x + s - gamma g), d = y - x."""
    seq = gossip.resolve_sequence(schedule, transport, self_weight)
    base_key = _key_on(base_key, transport.me.device)
    me = transport.me
    sw = seq.self_weight_of(me, state.step)
    g = masked_grad(grads, _node_noise_key(base_key, me, state.step),
                    sigma=cfg.sigma, clip_c=cfg.clip_c)
    spec = plane_mod.ParamPlane.for_stacked(state.x)
    xp = spec.pack_stacked(state.x)
    gp = spec.pack_stacked(g)
    del g
    # d was sent by this step's advance: its storage takes the next one
    d = _mix(xp, state.s, gp, sw, cfg, out=state.d)
    del gp
    for d_, x_ in zip(d, xp):
        d_.add_(x_ * (1.0 - cfg.theta)).sub_(x_)
    return state._replace(d=d, step=state.step + 1)
