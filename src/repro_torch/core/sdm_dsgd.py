"""SDM-DSGD (Algorithm 1): the stacked-node reference simulator.

Port of the reference half of ``repro.core.sdm_dsgd``. Per node i, per
iteration t (paper Eq. (3)):

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

The ``distributed_*`` per-node functions come with the distributed
executor and are not ported yet. The JAX package's ``tagging`` marks
(``sanitize``, ``pending_buffer``) are identities that only its static
analyzer reads; the port does not carry them.
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

__all__ = ["SDMConfig", "SDMState", "ReferenceSimulator", "masked_grad",
           "compressor_of", "wire_shape_tree", "sparsify_planes_stacked",
           "schedule_degree_factor", "transmitted_elements_per_step",
           "transmitted_bits_per_step", "check_per_node_p"]

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
    x: PyTree         # public copies, stacked (n, ...)
    s: PyTree         # incremental neighbour sum (time-varying / overlap)
    d: PyTree         # differential pending transmission
    step: int         # iteration counter
    e: PyTree = None  # error-feedback residual
    xhat: PyTree = None   # distributed-executor replicas (unused here)
    nb: PyTree = None     # overlap double buffer


def _zeros_like(t: PyTree) -> PyTree:
    return tree_mod.tree_map(torch.zeros_like, t)


def _noise_like(key, tree: PyTree, sigma: float) -> PyTree:
    """sigma * N(0, 1) per leaf, leaf i drawn with ``fold_in(key, i)`` at
    the leaf's full (stacked) shape, in JAX's flatten order."""
    leaves, struct = tree_mod.flatten(tree)
    noise = [sigma * prng.normal(prng.fold_in(key, i), tuple(x.shape)
                                 ).to(x.device, x.dtype)
             for i, x in enumerate(leaves)]
    return tree_mod.unflatten(struct, noise)


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
        noise = _noise_like(key, grads, sigma)
        grads = tree_mod.tree_map(torch.add, grads, noise)
    return grads


def _key_on(key, device) -> torch.Tensor:
    return prng.key_data(key).to(device)


def sparsify_planes_stacked(comp: compressor_mod.Compressor,
                            tree_stacked: PyTree, key, step,
                            n: int) -> PyTree:
    """Plane-granular compressor roundtrip of a node-stacked tree.

    Each bucket's zero-padded plane is compressed whole, per node, with
    key ``node_round_key(fold_in(key, bucket), node, step)`` -- one
    batched call over the n nodes (the JAX package vmaps it).
    """
    spec = plane_mod.ParamPlane.for_stacked(tree_stacked)
    planes = spec.pack_stacked(tree_stacked)
    out = []
    for b, dpl in enumerate(planes):
        bkey = prng.fold_in(_key_on(key, dpl.device), b)
        nodes = torch.arange(n, device=dpl.device)
        node_keys = gossip.node_round_key(bkey, nodes, step)
        out.append(comp.decompress(comp.compress(node_keys, dpl, node=nodes)))
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
        state, _ = self.advance(state, k_sp)
        grads, aux = grad_fn(state.x, batch_stack)
        state = self.commit(state, grads, k_noise)
        return state, aux

    def consensus_mean(self, state: SDMState) -> PyTree:
        """xbar_t = (1/n) sum_i x_{i,t}."""
        return tree_mod.tree_map(lambda x: torch.mean(x, dim=0), state.x)

    consensus = consensus_mean

    def eval_params(self, state: SDMState) -> PyTree:
        return state.x
