"""Gossip schedules, dense-W mixing and the per-node exchanges.

Port of ``repro.core.gossip``:

* ``mix_dense`` / ``apply_weights_dense`` -- (W x)_i over a node-stacked
  leading axis, the single-host reference's gossip;
* the static schedule objects (``ScheduleRound``, ``PermuteSchedule``,
  ``ScheduleSequence``, ``UnionSchedule``) a ``Topology`` compiles into,
  and the per-link wire accounting read off them (``mean_out_degree``);
* ``node_round_key``, the per-(node, round) key both endpoints of a link
  regenerate;
* the per-node exchanges of the distributed executor: ``exchange``
  (dense payload), ``exchange_payload`` (any compressor payload),
  ``exchange_packed`` / ``exchange_packed_rows`` (seed-synchronized
  fixed-k: only the kept values cross, receivers regenerate the index
  sets) and their replica (union-graph) siblings ``union_exchange*``;
* the ring helpers ``ring_exchange``, ``ring_weighted_neighbor_sum``,
  ``ring_exchange_packed`` and ``ring_exchange_packed_rows`` (the
  symmetric ring over all n nodes; a ``transport`` argument in place of
  the JAX package's ``axis_name``).

Each static-schedule exchange has a split form, ``*_start``, that
starts the rounds' sends (``transport.ppermute_start``) and returns a
``transport.Pending`` neighbour sum: the sender-side pack (the fixed-k
gather-pack kernel, or the compressor) runs on the stream that starts
the exchange, the receive side (unpack, weigh, scatter into the sum)
when ``wait()`` is called. With ``defer`` (the default) the sends may
stay in flight (on the card, on the transport's side stream); the
plain functions are the split form with ``defer=False`` waited on at
once, every op on the current stream.

The exchanges work on a NODE BLOCK (``core/transport.py``): every tensor
has a leading dim L of the nodes the caller holds and ``transport.me``
is their (L,) index tensor. Every buffer put on the wire goes through
``transport.ppermute``, the port's counterpart of the JAX package's one
wire call site ``_wire_ppermute``. The step counter is a host int, so a
time-varying sequence picks its round's schedule in Python
(``lax.switch`` in the JAX package) with no device sync.

The schedules are plain Python/numpy, identical to the JAX package's, so
both packages mix with the same dense matrices and charge the same wire
cost. The JAX package's ``wire_payload`` tag (an identity its analyzer
reads) has no counterpart here, nor has its ``REPRO_FUSED_PACK=0``
switch: on a CUDA tensor it would route the packed exchange to the
plain gather, and on the CPU the plain gather is the route already.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import sparsifier
from repro_torch.core.transport import Pending

__all__ = ["mix_dense", "apply_weights_dense", "PermuteSchedule",
           "ScheduleRound", "ScheduleSequence", "UnionRound", "UnionSchedule",
           "union_schedule", "needs_replicas", "weight_invariant",
           "mean_out_degree", "replica_recv_weights", "schedule_from_topology",
           "sequence_from_topologies", "sequence_from_active_sets",
           "sequence_by_name", "ensure_sequence",
           "sequence_of", "ring_schedule", "resolve_schedule",
           "resolve_sequence", "exchange", "exchange_start",
           "exchange_payload", "exchange_payload_start", "exchange_packed",
           "exchange_packed_start", "exchange_packed_rows",
           "exchange_packed_rows_start", "union_exchange",
           "union_exchange_payload", "union_exchange_packed",
           "union_exchange_packed_rows", "ring_exchange",
           "ring_weighted_neighbor_sum", "ring_exchange_packed",
           "ring_exchange_packed_rows", "node_round_key"]


# --------------------------------------------------------------------------
# Reference (single-host, node-stacked) mixing.
# --------------------------------------------------------------------------

def mix_dense(weights: torch.Tensor, x_stack: torch.Tensor) -> torch.Tensor:
    """(W x)_i = sum_j W_ij x_j over the leading node axis."""
    n = x_stack.shape[0]
    out = weights.to(x_stack.dtype) @ x_stack.reshape(n, -1)
    return out.reshape(x_stack.shape)


def apply_weights_dense(weights: torch.Tensor, msgs_stack: torch.Tensor,
                        include_self: bool = False) -> torch.Tensor:
    """Weighted neighbour sum sum_{j != i} W_ij msg_j (optionally + W_ii msg_i)."""
    w = weights if include_self else \
        weights - torch.diag(torch.diagonal(weights))
    return mix_dense(w, msgs_stack)


# --------------------------------------------------------------------------
# Static permute schedules: any Topology -> rounds of cyclic shifts.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleRound:
    """One round: all edges with (receiver - sender) % n == shift."""

    shift: int
    perm: Tuple[Tuple[int, int], ...]       # (src, dst) pairs
    recv_weights: Tuple[float, ...]         # (n,) W[r, (r-shift) % n] or 0


@dataclasses.dataclass(frozen=True)
class PermuteSchedule:
    """A Topology compiled to static rounds (one per distinct shift);
    ``self_weights[i] = W_ii``."""

    name: str
    n_nodes: int
    self_weights: Tuple[float, ...]
    rounds: Tuple[ScheduleRound, ...]

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def self_weight_of(self, me: torch.Tensor) -> torch.Tensor:
        """W_ii of the nodes ``me`` (an index tensor), f32."""
        return _table(self.self_weights, me)

    def neighbor_weight_sums(self) -> Tuple[float, ...]:
        """sum_{j != i} W_ij per node (1 - W_ii for doubly stochastic W)."""
        n = self.n_nodes
        sums = [0.0] * n
        for rnd in self.rounds:
            for r in range(n):
                sums[r] += rnd.recv_weights[r]
        return tuple(sums)

    def dense_weights(self) -> np.ndarray:
        """The full (n, n) consensus matrix W the rounds encode."""
        n = self.n_nodes
        w = np.diag(np.asarray(self.self_weights, np.float64))
        for rnd in self.rounds:
            for r in range(n):
                if rnd.recv_weights[r]:
                    w[r, (r - rnd.shift) % n] = rnd.recv_weights[r]
        return w


@dataclasses.dataclass(frozen=True)
class ScheduleSequence:
    """A (possibly time-varying) schedule: one PermuteSchedule per round,
    cycled by the iteration counter. Static graphs have length 1."""

    name: str
    n_nodes: int
    schedules: Tuple[PermuteSchedule, ...]

    def __post_init__(self) -> None:
        if not self.schedules:
            raise ValueError("ScheduleSequence needs >= 1 schedule")
        if any(s.n_nodes != self.n_nodes for s in self.schedules):
            raise ValueError("all schedules must share n_nodes")

    @property
    def length(self) -> int:
        return len(self.schedules)

    @property
    def n_rounds(self) -> int:
        """Worst-case rounds per gossip step."""
        return max(s.n_rounds for s in self.schedules)

    def at(self, t: int) -> PermuteSchedule:
        """The schedule active at iteration t."""
        return self.schedules[int(t) % self.length]

    def self_weight_of(self, me: torch.Tensor, step=None) -> torch.Tensor:
        """W_ii(step) of the nodes ``me``, f32."""
        if self.length == 1 or step is None:
            return self.schedules[0].self_weight_of(me)
        return self.at(step).self_weight_of(me)

    def weights_stack(self) -> np.ndarray:
        """(L, n, n) stacked dense matrices (reference-executor mixing)."""
        return np.stack([s.dense_weights() for s in self.schedules])


def ensure_sequence(schedule) -> ScheduleSequence:
    if isinstance(schedule, ScheduleSequence):
        return schedule
    return ScheduleSequence(name=schedule.name, n_nodes=schedule.n_nodes,
                            schedules=(schedule,))


def sequence_of(topo) -> ScheduleSequence:
    """Any graph argument (Topology, PermuteSchedule, ScheduleSequence)
    as a ScheduleSequence."""
    if isinstance(topo, (PermuteSchedule, ScheduleSequence)):
        return ensure_sequence(topo)
    return ensure_sequence(schedule_from_topology(topo))


def schedule_from_topology(topo) -> PermuteSchedule:
    """Compile ``topo`` (a topology.Topology) into a PermuteSchedule."""
    from repro_torch.core import topology as topology_mod

    adj = np.asarray(topo.adjacency)
    n = topo.n_nodes
    rounds = []
    for shift, pairs in sorted(topology_mod.shift_decomposition(adj).items()):
        rw = topology_mod.shift_receive_weights(topo, shift)
        rounds.append(ScheduleRound(
            shift=shift,
            perm=tuple((int(a), int(b)) for a, b in pairs),
            recv_weights=tuple(float(v) for v in rw)))
    return PermuteSchedule(
        name=topo.name, n_nodes=n,
        self_weights=tuple(float(topo.weights[i, i]) for i in range(n)),
        rounds=tuple(rounds))


def sequence_from_topologies(topos, name: str | None = None
                             ) -> ScheduleSequence:
    schedules = tuple(schedule_from_topology(t) for t in topos)
    return ScheduleSequence(
        name=name or "+".join(s.name for s in schedules)[:64],
        n_nodes=schedules[0].n_nodes, schedules=schedules)


def sequence_by_name(spec: str, n_nodes: int, *,
                     self_weight: float | None = None,
                     seed: int = 0) -> ScheduleSequence:
    """Parse a CLI spec into a ScheduleSequence: static
    ``topology.by_name`` specs give length 1, ``matchings[:L]`` gives L
    random per-round matchings. (The JAX package's ``placement`` option
    serves its mesh launcher and is not ported.)"""
    from repro_torch.core import topology as topology_mod

    spec = spec.strip().lower()
    if spec.startswith("matchings") and n_nodes > 1:
        rounds = int(spec.split(":", 1)[1]) if ":" in spec else 4
        topos = topology_mod.random_matchings(
            n_nodes, rounds, seed=seed,
            self_weight=0.5 if self_weight is None else self_weight)
        return sequence_from_topologies(
            topos, name=f"matchings{n_nodes}x{rounds}_s{seed}")
    if spec.startswith("matchings"):
        spec = "complete"
    topo = topology_mod.by_name(spec, n_nodes, self_weight=self_weight,
                                seed=seed)
    return ensure_sequence(schedule_from_topology(topo))


def sequence_from_active_sets(topo, active_sets, name: str | None = None
                              ) -> ScheduleSequence:
    """Compile a partial-participation trace into a ScheduleSequence.

    ``active_sets`` is one iterable of participating node indices per
    round (the edge-fleet simulator's sampled subgraphs); each round
    compiles the induced ``topology.masked_subgraph`` (inactive nodes
    isolated, active-active edges reweighted on the induced graph). The
    result is an ordinary, usually genuinely time-varying (replica
    transported) sequence that every executor consumes like any other.
    """
    from repro_torch.core import topology as topology_mod

    active_sets = list(active_sets)
    if not active_sets:
        raise ValueError("need >= 1 active set")
    topos = [topology_mod.masked_subgraph(topo, a,
                                          name=f"{topo.name}_sub_r{t}")
             for t, a in enumerate(active_sets)]
    return sequence_from_topologies(
        topos, name=name or f"{topo.name}_part{len(active_sets)}")


# --------------------------------------------------------------------------
# Union schedules (the replica transport's graph) and accounting factors.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UnionRound:
    shift: int
    perm: Tuple[Tuple[int, int], ...]
    recv_weights: Tuple[Tuple[float, ...], ...]     # (L, n)


@dataclasses.dataclass(frozen=True)
class UnionSchedule:
    """The union graph of a ScheduleSequence: payloads cross every union
    edge every round on the replica transport."""

    name: str
    n_nodes: int
    length: int
    rounds: Tuple[UnionRound, ...]

    @property
    def n_replicas(self) -> int:
        """Replica slots per node: one per union shift round."""
        return len(self.rounds)


@functools.lru_cache(maxsize=None)
def union_schedule(seq: ScheduleSequence) -> UnionSchedule:
    """Compile the union graph of ``seq`` with per-position edge weights."""
    seq = ensure_sequence(seq)
    n = seq.n_nodes
    edges_by_shift: dict = {}
    for sched in seq.schedules:
        shifts = [rnd.shift for rnd in sched.rounds]
        if len(shifts) != len(set(shifts)):
            raise ValueError(
                f"union_schedule: schedule {sched.name!r} has duplicate "
                f"shifts {shifts}; merge same-shift rounds first")
        for rnd in sched.rounds:
            edges_by_shift.setdefault(rnd.shift, set()).update(rnd.perm)
    rounds = []
    for shift in sorted(edges_by_shift):
        rw = []
        for sched in seq.schedules:
            w_t = (0.0,) * n
            for rnd in sched.rounds:
                if rnd.shift == shift:
                    w_t = rnd.recv_weights
            rw.append(tuple(w_t))
        rounds.append(UnionRound(
            shift=shift, perm=tuple(sorted(edges_by_shift[shift])),
            recv_weights=tuple(rw)))
    return UnionSchedule(name=f"union({seq.name})", n_nodes=n,
                         length=seq.length, rounds=tuple(rounds))


@functools.lru_cache(maxsize=None)
def weight_invariant(seq: ScheduleSequence) -> bool:
    """True when every round of the sequence mixes with the same W."""
    ws = seq.weights_stack()
    return all(np.array_equal(ws[0], w) for w in ws[1:])


def needs_replicas(seq) -> bool:
    """Whether differential methods need per-neighbour replicas (exact
    W(t)-mixing) on ``seq``: genuinely time-varying weights only."""
    seq = ensure_sequence(seq)
    return seq.length > 1 and not weight_invariant(seq)


def mean_out_degree(seq, *, union: bool = False,
                    node: "int | None" = None) -> Fraction:
    """Mean-over-rounds directed out-degree of the transport (exact):
    payload copies a node puts on the wire per step."""
    seq = ensure_sequence(seq)

    def count(perm) -> int:
        if node is None:
            return len(perm)
        return sum(1 for src, _ in perm if src == node)

    denom = 1 if node is not None else seq.n_nodes
    if union:
        u = union_schedule(seq)
        return Fraction(sum(count(rnd.perm) for rnd in u.rounds), denom)
    total = sum(sum(count(rnd.perm) for rnd in s.rounds)
                for s in seq.schedules)
    return Fraction(total, denom * seq.length)


def node_round_key(base_key, node_index, step) -> torch.Tensor:
    """Sparsifier seed both endpoints can regenerate: f(base, node, round).
    ``node_index`` may be an index tensor: one key per node."""
    return prng.fold_in(prng.fold_in(base_key, node_index), step)


# --------------------------------------------------------------------------
# Per-node exchanges (the distributed executor's transport).
# --------------------------------------------------------------------------

def _table(values, me: torch.Tensor) -> torch.Tensor:
    """An f32 per-node table read at the nodes ``me``."""
    return torch.tensor(values, dtype=torch.float32, device=me.device)[me]


def per_node(v, like: torch.Tensor):
    """A (L,) per-node tensor shaped to broadcast over ``like``'s node
    block (a python float as it is)."""
    if not isinstance(v, torch.Tensor):
        return v
    return v.to(like.dtype).reshape((v.shape[0],) + (1,) * (like.dim() - 1))


def _active(seq: ScheduleSequence, step) -> PermuteSchedule:
    """The schedule of the step's round (``lax.switch`` in JAX)."""
    if seq.length == 1:
        return seq.schedules[0]
    if step is None:
        raise ValueError("time-varying ScheduleSequence needs step=")
    return seq.at(step)


@functools.lru_cache(maxsize=None)
def ring_schedule(n: int, self_weight: float | None = None) -> PermuteSchedule:
    """The symmetric ring as a schedule (shifts +1 and n-1)."""
    from repro_torch.core import topology as topology_mod

    return schedule_from_topology(topology_mod.ring(n, self_weight))


def resolve_schedule(schedule, transport,
                     self_weight: float | None = None) -> PermuteSchedule:
    """A single static schedule; ``None`` is the ring over all nodes."""
    if schedule is not None:
        if isinstance(schedule, ScheduleSequence):
            if schedule.length != 1:
                raise ValueError(
                    "time-varying sequence passed where a single static "
                    "schedule is required; use resolve_sequence")
            return schedule.schedules[0]
        return schedule
    return ring_schedule(transport.n, self_weight)


def resolve_sequence(schedule, transport,
                     self_weight: float | None = None) -> ScheduleSequence:
    """PermuteSchedule | ScheduleSequence | None as a sequence; ``None``
    is the symmetric ring over all nodes with scalar ``self_weight``."""
    if schedule is None:
        schedule = ring_schedule(transport.n, self_weight)
    return ensure_sequence(schedule)


def _round_weight(rnd: ScheduleRound, me: torch.Tensor) -> torch.Tensor:
    return _table(rnd.recv_weights, me)


def _ppermute_payload_start(transport, payload, perm, defer=True
                            ) -> Pending:
    """Every tensor field of a compressor payload across one round (one
    ppermute per field, as the JAX package permutes each pytree leaf),
    in flight; ``wait()`` gives the received payload. Explicit indices
    cross as int32, the width ``lax.top_k`` gives them in the JAX
    package, and come back to their own dtype on receipt."""
    def start(v):
        return None if v is None else transport.ppermute_start(
            v, perm, defer=defer)

    def got(p):
        return None if p is None else p.wait()

    idx = payload.indices
    sent = (start(payload.values),
            None if idx is None else start(idx.to(torch.int32)),
            start(payload.scale))

    def finish():
        values, indices, scale = (got(p) for p in sent)
        if indices is not None:
            indices = indices.to(idx.dtype)
        return dataclasses.replace(payload, values=values, indices=indices,
                                   scale=scale)

    return Pending(finish)


def _ppermute_payload(transport, payload, perm):
    """``_ppermute_payload_start(..., defer=False).wait()``."""
    return _ppermute_payload_start(transport, payload, perm,
                                   defer=False).wait()


def exchange_start(schedule, x: torch.Tensor, transport, step=None, *,
                   defer: bool = True) -> Pending:
    """sum_{j in N_i(t)} W_ij(t) x_j per held node i, dense payload: one
    ppermute per round of the step's schedule, in flight."""
    me = transport.me
    rounds = _active(ensure_sequence(schedule), step).rounds
    if not rounds:
        return Pending.done(torch.zeros_like(x))
    sent = [transport.ppermute_start(x, rnd.perm, defer=defer)
            for rnd in rounds]

    def finish():
        total = None
        for rnd, pend in zip(rounds, sent):
            recv = pend.wait()
            if total is None:
                total = torch.zeros_like(recv)
            total = total + per_node(_round_weight(rnd, me), recv) * recv
        return total

    return Pending(finish)


def exchange(schedule, x: torch.Tensor, transport, step=None
             ) -> torch.Tensor:
    """``exchange_start(..., defer=False).wait()``."""
    return exchange_start(schedule, x, transport, step, defer=False).wait()


def exchange_payload_start(schedule, payload, decompress, transport, *,
                           step=None, defer: bool = True) -> Pending:
    """Weighted neighbour sum of decompressed compressor payloads, in
    flight: every tensor of the payload crosses as it is, the receiver
    decompresses and weighs locally at ``wait()`` (non-destinations get
    zero payloads and weight)."""
    me = transport.me
    rounds = _active(ensure_sequence(schedule), step).rounds
    if not rounds:
        return Pending.done(torch.zeros_like(decompress(payload)))
    sent = [_ppermute_payload_start(transport, payload, rnd.perm, defer)
            for rnd in rounds]

    def finish():
        total = None
        for rnd, pend in zip(rounds, sent):
            dec = decompress(pend.wait())
            if total is None:
                total = torch.zeros_like(dec)
            total = total + per_node(_round_weight(rnd, me), dec) * dec
        return total

    return Pending(finish)


def exchange_payload(schedule, payload, decompress, transport, *,
                     step=None) -> torch.Tensor:
    """``exchange_payload_start(..., defer=False).wait()``."""
    return exchange_payload_start(schedule, payload, decompress, transport,
                                  step=step, defer=False).wait()


def _batched_sender_indices(schedule: PermuteSchedule, me: torch.Tensor, *,
                            base_key, step, nb: int, kb: int
                            ) -> torch.Tensor:
    """All this step's senders' index sets from one batched draw:
    (L, R, kb), row [l, i] for the shift-i sender ``(me_l - shift_i) % n``
    of node l. Bit-equal to one ``fixedk_indices`` call per sender."""
    shifts = torch.tensor([rnd.shift for rnd in schedule.rounds],
                          dtype=torch.long, device=me.device)
    senders = torch.remainder(me[:, None] - shifts[None, :],
                              schedule.n_nodes)
    keys = node_round_key(base_key, senders, step)          # (L, R, 2)
    return sparsifier.fixedk_indices(keys, nb, kb)


def _packed_selection(db: torch.Tensor, p, me: torch.Tensor, *, base_key,
                      step) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Sender-side packed payload of a (L, nb, block) block view:
    (kb, my_idx (L, kb), my_vals (L, kb, block)).

    Scalar p on an f32 view goes through the fixed-k gather-pack kernel
    (``kernels/wire_compress``; its plain version for CPU tensors). A
    per-node p pads to k_max = max_i ceil(p_i nb): node i zeroes rows
    beyond its own k_i and scales kept rows by nb / k_i, in torch ops (a
    per-node mask, not a scalar scale), as the JAX package does.
    """
    nb = db.shape[-2]
    if isinstance(p, tuple):
        k_table = tuple(sparsifier.num_kept(nb, pi) for pi in p)
        kb = max(k_table)
        kb_me = torch.tensor(k_table, dtype=torch.int32,
                             device=me.device)[me]
        keep = torch.arange(kb, device=me.device)[None, :] < kb_me[:, None]
        scale = torch.div(torch.tensor(float(nb), device=me.device),
                          kb_me.to(torch.float32))[:, None] * keep
        scale = scale[..., None]                                # (L, kb, 1)
    else:
        kb = sparsifier.num_kept(nb, p)
        scale = nb / kb
    my_idx = sparsifier.fixedk_indices(node_round_key(base_key, me, step),
                                       nb, kb)
    if not isinstance(p, tuple) and db.dtype == torch.float32:
        from repro_torch.kernels import wire_compress

        my_vals = wire_compress.fixedk_gather_pack(
            db, my_idx.to(torch.int32), scale=scale)
    else:
        my_vals = (_gather_rows(db, my_idx) * scale).to(db.dtype)
    return kb, my_idx, my_vals


def _gather_rows(db: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """db (L, nb, block), idx (L, k) -> (L, k, block)."""
    return torch.gather(db, 1, idx.unsqueeze(-1).expand(
        tuple(idx.shape) + (db.shape[-1],)))


def _unpack(db: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor
            ) -> torch.Tensor:
    """Zeros shaped like ``db`` with ``vals`` at rows ``idx`` (distinct)."""
    return torch.zeros_like(db).scatter_(
        1, idx.unsqueeze(-1).expand(vals.shape), vals)


def _scatter_weighted(acc: torch.Tensor, w: torch.Tensor, vals: torch.Tensor,
                      idx: torch.Tensor) -> None:
    """acc += w * unpack(vals, idx), in place: the kept rows only (the
    others gain w * 0)."""
    acc.scatter_add_(1, idx.unsqueeze(-1).expand(vals.shape),
                     per_node(w, vals) * vals)


def _packed_exchange_start(seq: ScheduleSequence, db: torch.Tensor,
                           transport, *, base_key, step, p, reshape, defer
                           ) -> Tuple[torch.Tensor, Pending]:
    """Packed gossip on a (L, nb, block) view: (own S(d), the weighted
    neighbour sum in flight), both shaped like ``db`` and passed through
    ``reshape``. Only the packed (kb, block) values cross the wire; the
    receivers' index draw and scatter run at ``wait()``."""
    me = transport.me
    nb = db.shape[-2]
    kb, my_idx, my_vals = _packed_selection(db, p, me, base_key=base_key,
                                            step=step)
    own = _unpack(db, my_vals, my_idx)
    sched = _active(seq, step)
    sent = [transport.ppermute_start(my_vals, rnd.perm, defer=defer)
            for rnd in sched.rounds]
    del my_vals
    shape, dtype = own.shape, own.dtype

    def finish():
        nb_sum = torch.zeros(shape, dtype=dtype, device=me.device)
        if sched.rounds:
            sender_idx = _batched_sender_indices(
                sched, me, base_key=base_key, step=step, nb=nb, kb=kb)
            for i, (rnd, pend) in enumerate(zip(sched.rounds, sent)):
                _scatter_weighted(nb_sum, _round_weight(rnd, me),
                                  pend.wait(), sender_idx[:, i])
        return reshape(nb_sum)

    return reshape(own), Pending(finish)


def _flat_block_view(d: torch.Tensor, block: int) -> torch.Tensor:
    return sparsifier.block_view(d.reshape(d.shape[0], -1), block)


def _from_block_view(v: torch.Tensor, shape) -> torch.Tensor:
    """(B, nb, block) back to (B, *shape[1:]), the block pad dropped."""
    per_node = tuple(shape[1:])
    dim = math.prod(per_node)
    return v.reshape(v.shape[0], -1)[:, :dim].reshape((v.shape[0],)
                                                      + per_node)


def exchange_packed_start(schedule, d: torch.Tensor, transport, *,
                          base_key, step, p, block: int = 1,
                          defer: bool = True
                          ) -> Tuple[torch.Tensor, Pending]:
    """One packed gossip round over flat ``block``-coordinate blocks of
    each node's row of ``d`` (L, ...): (own S(d), sum_j W_ij S(d_j) in
    flight)."""
    shape = d.shape
    return _packed_exchange_start(
        ensure_sequence(schedule), _flat_block_view(d, block), transport,
        base_key=base_key, step=step, p=p, defer=defer,
        reshape=lambda v: _from_block_view(v, shape))


def exchange_packed(schedule, d: torch.Tensor, transport, *, base_key,
                    step, p, block: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(own S(d), sum_j W_ij S(d_j)): ``exchange_packed_start`` not
    deferred, waited."""
    own, pend = exchange_packed_start(schedule, d, transport,
                                      base_key=base_key, step=step, p=p,
                                      block=block, defer=False)
    return own, pend.wait()


def _rows_view(d: torch.Tensor) -> torch.Tensor:
    cols = d.shape[-1] if d.dim() > 2 else 1
    return d.reshape(d.shape[0], -1, cols)


def exchange_packed_rows_start(schedule, d: torch.Tensor, transport, *,
                               base_key, step, p, defer: bool = True
                               ) -> Tuple[torch.Tensor, Pending]:
    """Packed gossip with blocks = trailing-dim rows of each node's
    tensor (the sharding-aligned selection), the sum in flight."""
    shape = d.shape
    return _packed_exchange_start(
        ensure_sequence(schedule), _rows_view(d), transport,
        base_key=base_key, step=step, p=p, defer=defer,
        reshape=lambda v: v.reshape(shape))


def exchange_packed_rows(schedule, d: torch.Tensor, transport, *, base_key,
                         step, p) -> Tuple[torch.Tensor, torch.Tensor]:
    """``exchange_packed_rows_start`` not deferred, waited."""
    own, pend = exchange_packed_rows_start(schedule, d, transport,
                                           base_key=base_key, step=step, p=p,
                                           defer=False)
    return own, pend.wait()


# --------------------------------------------------------------------------
# The ring helpers (the symmetric ring over all n nodes).
# --------------------------------------------------------------------------

def _perm(n: int, shift: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((i, (i + shift) % n) for i in range(n))


def ring_exchange(x: torch.Tensor, transport
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``x`` to both ring neighbours: (from_left, from_right) with
    ``from_left[i] = x[i-1]`` and ``from_right[i] = x[i+1]``."""
    n = transport.n
    return (transport.ppermute(x, _perm(n, +1)),
            transport.ppermute(x, _perm(n, -1)))


def ring_weighted_neighbor_sum(x: torch.Tensor, transport,
                               neighbor_weight: float) -> torch.Tensor:
    """sum_{j in N_i} W_ij x_j on the symmetric ring (both neighbours
    weigh ``neighbor_weight``)."""
    from_left, from_right = ring_exchange(x, transport)
    return neighbor_weight * (from_left + from_right)


def _ring_packed(db: torch.Tensor, transport, *, base_key, step, p,
                 neighbor_weight) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed ring round on a (L, nb, block) view: (own S(d),
    w (S(d_{i-1}) + S(d_{i+1}))), shaped like ``db``. The sender packs
    ``take(db, idx) * nb / kb`` (the fixed-k gather-pack kernel on an f32
    view); receivers regenerate both neighbours' index sets from
    ``node_round_key`` (no index crosses the wire)."""
    me, n = transport.me, transport.n
    nb = db.shape[-2]
    kb, my_idx, my_vals = _packed_selection(db, p, me, base_key=base_key,
                                            step=step)
    from_left = transport.ppermute(my_vals, _perm(n, +1))
    from_right = transport.ppermute(my_vals, _perm(n, -1))
    own = _unpack(db, my_vals, my_idx)
    del my_vals
    senders = torch.stack([torch.remainder(me - 1, n),
                           torch.remainder(me + 1, n)], dim=1)   # (L, 2)
    idx = sparsifier.fixedk_indices(node_round_key(base_key, senders, step),
                                    nb, kb)                      # (L, 2, kb)
    # unpack(left) + unpack(right), in place: the left values set into
    # zeros, the right values added where they land
    nb_sum = torch.zeros_like(db).scatter_(
        1, idx[:, 0].unsqueeze(-1).expand(from_left.shape), from_left)
    del from_left
    nb_sum.scatter_add_(1, idx[:, 1].unsqueeze(-1).expand(from_right.shape),
                        from_right)
    return own, nb_sum.mul_(neighbor_weight)


def ring_exchange_packed(d_flat: torch.Tensor, *, transport, base_key, step,
                         p: float, neighbor_weight: float, block: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SDM-DSGD ring round with packed payloads over each node's row
    of ``d_flat`` (L, dim), in ``block``-coordinate blocks: (own S(d),
    w (S(d_{i-1}) + S(d_{i+1}))), both (L, dim). The wire carries the
    packed (kb, block) values only, twice a round."""
    own, nb_sum = _ring_packed(
        sparsifier.block_view(d_flat, block), transport, base_key=base_key,
        step=step, p=p, neighbor_weight=neighbor_weight)
    dim = d_flat.shape[-1]
    return (own.reshape(own.shape[0], -1)[:, :dim],
            nb_sum.reshape(nb_sum.shape[0], -1)[:, :dim])


def ring_exchange_packed_rows(d: torch.Tensor, *, transport, base_key, step,
                              p: float, neighbor_weight: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed ring round with blocks = trailing-dim rows of each
    node's tensor of ``d`` (L, ...): (own S(d), w (S(d_{i-1}) +
    S(d_{i+1}))), both shaped like ``d``."""
    own, nb_sum = _ring_packed(
        _rows_view(d), transport, base_key=base_key, step=step, p=p,
        neighbor_weight=neighbor_weight)
    return own.reshape(d.shape), nb_sum.reshape(d.shape)


# --------------------------------------------------------------------------
# Replica (union-graph) transport for genuinely time-varying sequences.
# --------------------------------------------------------------------------

def replica_recv_weights(useq: UnionSchedule, me: torch.Tensor, step: int
                         ) -> torch.Tensor:
    """(L, n_replicas) weights W_{me, sender_k}(step) of the replica slots."""
    t = int(step) % useq.length
    table = torch.tensor([[rnd.recv_weights[t][r] for rnd in useq.rounds]
                          for r in range(useq.n_nodes)],
                         dtype=torch.float32, device=me.device)  # (n, R)
    return table[me]


def union_exchange(useq: UnionSchedule, x: torch.Tensor, transport
                   ) -> torch.Tensor:
    """``x`` over every union round: (L, n_replicas, ...), slot k the
    increment from the shift-s_k sender (zeros where there is none)."""
    return torch.stack([transport.ppermute(x, rnd.perm)
                        for rnd in useq.rounds], dim=1)


def union_exchange_payload(useq: UnionSchedule, payload, decompress,
                           transport) -> torch.Tensor:
    """Each union round's payload decompressed into its own slot:
    (L, n_replicas, ...)."""
    return torch.stack([
        decompress(_ppermute_payload(transport, payload, rnd.perm))
        for rnd in useq.rounds], dim=1)


def _union_packed_exchange(useq: UnionSchedule, db: torch.Tensor, transport,
                           *, base_key, step, p
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed replica transport on a (L, nb, block) view: (own S(d),
    per-slot increments (L, R, nb, block)); one batched sender draw."""
    me = transport.me
    nb = db.shape[-2]
    kb, my_idx, my_vals = _packed_selection(db, p, me, base_key=base_key,
                                            step=step)
    own = _unpack(db, my_vals, my_idx)
    sender_idx = _batched_sender_indices(useq, me, base_key=base_key,
                                         step=step, nb=nb, kb=kb)
    incr = torch.stack([
        _unpack(db, transport.ppermute(my_vals, rnd.perm), sender_idx[:, i])
        for i, rnd in enumerate(useq.rounds)], dim=1)
    return own, incr


def union_exchange_packed(useq: UnionSchedule, d: torch.Tensor, transport, *,
                          base_key, step, p, block: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replica-transport packed gossip; (own S(d), (L, R, ...) incr)."""
    own, incr = _union_packed_exchange(
        useq, _flat_block_view(d, block), transport, base_key=base_key,
        step=step, p=p)
    r = incr.shape[1]
    incr = _from_block_view(incr.reshape((-1,) + tuple(incr.shape[2:])),
                            d.shape)
    return _from_block_view(own, d.shape), incr.reshape(
        (d.shape[0], r) + tuple(d.shape[1:]))


def union_exchange_packed_rows(useq: UnionSchedule, d: torch.Tensor,
                               transport, *, base_key, step, p
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replica-transport packed gossip with blocks = trailing-dim rows."""
    own, incr = _union_packed_exchange(useq, _rows_view(d), transport,
                                       base_key=base_key, step=step, p=p)
    return own.reshape(d.shape), incr.reshape(
        (d.shape[0], incr.shape[1]) + d.shape[1:])
