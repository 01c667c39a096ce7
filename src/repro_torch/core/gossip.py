"""Gossip schedules and the dense-W mixing the reference executors use.

Port of the reference half of ``repro.core.gossip``:

* ``mix_dense`` / ``apply_weights_dense`` -- (W x)_i over a node-stacked
  leading axis, the single-host reference's gossip;
* the static schedule objects (``ScheduleRound``, ``PermuteSchedule``,
  ``ScheduleSequence``, ``UnionSchedule``) a ``Topology`` compiles into,
  and the per-link wire accounting read off them (``mean_out_degree``);
* ``node_round_key``, the per-(node, round) key both endpoints of a link
  regenerate.

The schedules are plain Python/numpy, identical to the JAX package's, so
both packages mix with the same dense matrices and charge the same wire
cost. The ppermute exchanges of the distributed executor (``exchange*``,
``union_exchange*``) are not ported yet; they come with the distributed
executor on ``torch.distributed``. The JAX package's ``wire_payload``
tag (an identity its analyzer reads) has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

from repro_torch import prng

__all__ = ["mix_dense", "apply_weights_dense", "PermuteSchedule",
           "ScheduleRound", "ScheduleSequence", "UnionRound", "UnionSchedule",
           "union_schedule", "needs_replicas", "weight_invariant",
           "mean_out_degree", "schedule_from_topology",
           "sequence_from_topologies", "sequence_by_name", "ensure_sequence",
           "sequence_of", "node_round_key"]


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
