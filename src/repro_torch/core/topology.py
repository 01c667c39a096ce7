"""Gossip-graph topologies and consensus matrices.

The paper (§4.2) requires a consensus matrix ``W`` that is (1) doubly
stochastic, (2) symmetric, and (3) has the network's sparsity pattern.
Its spectrum then lies in (-1, 1] with one eigenvalue equal to 1; the
convergence theory is driven by ``beta = max(|lambda_2|, |lambda_n|)``
and the smallest eigenvalue ``lambda_n``.

The experimental section builds ``W = I - 2/(3*lambda_max(L)) * L`` from
the graph Laplacian ``L`` (used for Erdős–Rényi graphs); we reproduce
that construction exactly and also provide closed-form ring / torus /
complete topologies that map directly onto TPU ICI neighbourhoods.

The port's own copy of ``repro/core/topology.py`` (numpy/math only): importing it
from the JAX package would run ``repro/core/__init__.py``, which
imports jax. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "Topology",
    "DirectedTopology",
    "ring",
    "torus_2d",
    "complete",
    "erdos_renyi",
    "star",
    "directed_ring",
    "directed_erdos_renyi",
    "random_matchings",
    "masked_subgraph",
    "by_name",
    "placement_cost",
    "greedy_placement",
    "apply_placement",
    "laplacian_consensus_matrix",
    "metropolis_hastings_weights",
    "column_stochastic_weights",
    "shift_decomposition",
    "shift_receive_weights",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A gossip graph plus its consensus matrix and spectral summary."""

    name: str
    n_nodes: int
    adjacency: np.ndarray  # (n, n) 0/1, zero diagonal
    weights: np.ndarray  # (n, n) consensus matrix W

    def __post_init__(self) -> None:
        w = self.weights
        if not np.allclose(w, w.T, atol=1e-10):
            raise ValueError(f"{self.name}: W must be symmetric")
        if not np.allclose(w.sum(axis=0), 1.0, atol=1e-8):
            raise ValueError(f"{self.name}: W must be doubly stochastic")
        off_diag = w - np.diag(np.diag(w))
        support = np.abs(off_diag) > 1e-12
        if np.any(support & ~self.adjacency.astype(bool)):
            raise ValueError(f"{self.name}: W uses non-edges")

    # -- spectral quantities used throughout the paper's theory -----------
    @property
    def eigenvalues(self) -> np.ndarray:
        """Sorted descending: lambda_1 = 1 >= ... >= lambda_n > -1."""
        return np.sort(np.linalg.eigvalsh(self.weights))[::-1]

    @property
    def beta(self) -> float:
        """Second-largest eigenvalue magnitude (mixing rate)."""
        ev = self.eigenvalues
        return float(max(abs(ev[1]), abs(ev[-1])))

    @property
    def lambda_n(self) -> float:
        """Smallest eigenvalue of W (enters the theta bound)."""
        return float(self.eigenvalues[-1])

    @property
    def degree(self) -> np.ndarray:
        return self.adjacency.sum(axis=1).astype(np.int64)

    def neighbors(self, i: int) -> Sequence[int]:
        return np.nonzero(self.adjacency[i])[0].tolist()

    def mixed_with_theta(self, theta: float) -> np.ndarray:
        """The effective mixing matrix W_theta = (1-theta) I + theta W (Eq. 26)."""
        n = self.n_nodes
        return (1.0 - theta) * np.eye(n) + theta * self.weights


@dataclasses.dataclass(frozen=True)
class DirectedTopology:
    """A directed gossip graph with a COLUMN-stochastic push matrix.

    ``adjacency[i, j] = 1`` means node j pushes to node i; ``weights``
    is the push-sum matrix P with ``P[i, j]`` the share of j's mass sent
    to i, so each COLUMN sums to 1 (what a sender distributes sums to
    one) but rows need not — the asymmetry push-sum de-biasing corrects.
    Duck-type compatible with ``Topology`` for schedule compilation
    (``shift_decomposition`` / ``schedule_from_topology``): both read
    only ``name / n_nodes / adjacency / weights``.
    """

    name: str
    n_nodes: int
    adjacency: np.ndarray  # (n, n) 0/1, zero diagonal; [i, j] = edge j -> i
    weights: np.ndarray  # (n, n) column-stochastic P

    def __post_init__(self) -> None:
        w = self.weights
        if np.any(w < -1e-12):
            raise ValueError(f"{self.name}: P must be non-negative")
        if not np.allclose(w.sum(axis=0), 1.0, atol=1e-8):
            raise ValueError(f"{self.name}: P columns must sum to 1")
        off_diag = w - np.diag(np.diag(w))
        support = np.abs(off_diag) > 1e-12
        if np.any(support & ~self.adjacency.astype(bool)):
            raise ValueError(f"{self.name}: P uses non-edges")

    @property
    def degree(self) -> np.ndarray:
        """Out-degree per node (edges the node pushes along)."""
        return self.adjacency.sum(axis=0).astype(np.int64)

    def neighbors(self, i: int) -> Sequence[int]:
        """Out-neighbours of node i (nodes that receive i's pushes)."""
        return np.nonzero(self.adjacency[:, i])[0].tolist()


def column_stochastic_weights(adjacency: np.ndarray) -> np.ndarray:
    """The standard push-sum matrix: sender j splits its mass uniformly
    over its out-neighbours and itself, P[i, j] = 1 / (outdeg_j + 1)."""
    adjacency = np.asarray(adjacency)
    n = adjacency.shape[0]
    out_deg = adjacency.sum(axis=0)
    w = np.zeros((n, n))
    for j in range(n):
        share = 1.0 / (out_deg[j] + 1.0)
        w[np.nonzero(adjacency[:, j])[0], j] = share
        w[j, j] = share
    return w


def directed_ring(n: int, self_weight: float | None = None) -> DirectedTopology:
    """One-directional ring: node i pushes only to i+1 (mod n).

    The canonical asymmetric graph — its P is NOT doubly stochastic, so
    plain mixing is biased and push-sum correction is required.
    """
    if n < 2:
        raise ValueError("directed ring needs n >= 2")
    adj = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        adj[(i + 1) % n, i] = 1
    if self_weight is None:
        w = column_stochastic_weights(adj)
    else:
        w = np.eye(n) * self_weight
        for i in range(n):
            w[(i + 1) % n, i] = 1.0 - self_weight
    return DirectedTopology(name=f"dring{n}", n_nodes=n, adjacency=adj,
                            weights=w)


def directed_erdos_renyi(n: int, p_connect: float = 0.35,
                         seed: int = 0) -> DirectedTopology:
    """Directed ER graph, strongly connected by construction.

    Each ordered pair (j -> i), i != j, is an edge w.p. ``p_connect``; a
    directed ring is overlaid so the graph is always strongly connected
    (push-sum needs B-strong-connectivity). Weights are the uniform
    column-stochastic split.
    """
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < p_connect).astype(np.int64)
    np.fill_diagonal(adj, 0)
    for i in range(n):          # strong-connectivity backbone
        adj[(i + 1) % n, i] = 1
    return DirectedTopology(name=f"der{n}_pc{p_connect}_s{seed}", n_nodes=n,
                            adjacency=adj,
                            weights=column_stochastic_weights(adj))


def random_matchings(n: int, rounds: int, seed: int = 0,
                     self_weight: float = 0.5,
                     ensure_connected: bool = True) -> list[Topology]:
    """A B-connected time-varying sequence: one random matching per round.

    Each round pairs up a random shuffle of the nodes; a matched pair
    (a, b) mixes with W_aa = W_bb = ``self_weight`` and
    W_ab = W_ba = 1 - self_weight; unmatched nodes (odd n) keep W_ii = 1.
    Every round is symmetric doubly stochastic. With
    ``ensure_connected`` (and >= 2 rounds) the sequence is resampled
    until the UNION graph over one cycle is connected — the
    B-connectivity assumption time-varying consensus needs.
    """
    if n < 2:
        raise ValueError("matchings need n >= 2")

    def sample(rng) -> Tuple[list[Topology], np.ndarray]:
        out, union = [], np.zeros((n, n), dtype=np.int64)
        for r in range(rounds):
            order = rng.permutation(n)
            adj = np.zeros((n, n), dtype=np.int64)
            w = np.eye(n)
            for k in range(0, n - 1, 2):
                a, b = int(order[k]), int(order[k + 1])
                adj[a, b] = adj[b, a] = 1
                w[a, a] = w[b, b] = self_weight
                w[a, b] = w[b, a] = 1.0 - self_weight
            union |= adj
            out.append(Topology(name=f"matching{n}_r{r}", n_nodes=n,
                                adjacency=adj, weights=w))
        return out, union

    check = ensure_connected and rounds >= 2 and n > 2
    for attempt in range(1000):
        out, union = sample(np.random.default_rng(seed + attempt))
        if not check or _is_connected(union):
            return out
    raise RuntimeError(
        f"no connected union of {rounds} matchings on {n} nodes "
        "within 1000 reseeds")


def masked_subgraph(topo, active, name: str | None = None):
    """The induced partial-participation round graph on ``active`` nodes.

    The edge-fleet simulator samples an active subset per round; this
    builds that round's mixing graph WITHOUT renumbering: inactive nodes
    stay in the index space but become isolated (their W row/column is
    the identity row — they neither send nor receive, their parameters
    are untouched by the round), and the surviving active-active edges
    get weights recomputed ON THE INDUCED SUBGRAPH so the matrix stays
    valid whatever subset was drawn.

    Undirected topologies get Metropolis-Hastings weights (symmetric
    doubly stochastic for ANY induced adjacency, disconnected included);
    directed ones get the uniform column-stochastic push split (isolated
    senders keep all mass: P_jj = 1). The induced graph need not be
    connected — a single faulty round only slows mixing, and the
    B-connectivity the convergence theory needs is a property of the
    round SEQUENCE, not of each round.
    """
    n = topo.n_nodes
    mask = np.zeros(n, dtype=bool)
    mask[np.asarray(sorted(int(i) for i in active), dtype=np.int64)] = True
    label = name or f"{topo.name}_sub{int(mask.sum())}"
    if mask.all():
        # full participation keeps the base graph's OWN weights (ring
        # self-weights, Laplacian ER matrices, ...) so a no-fault round
        # mixes byte-identically to the lock-step trainer.
        return dataclasses.replace(topo, name=label)
    adj = (np.asarray(topo.adjacency) * np.outer(mask, mask)).astype(np.int64)
    if isinstance(topo, DirectedTopology):
        return DirectedTopology(name=label, n_nodes=n, adjacency=adj,
                                weights=column_stochastic_weights(adj))
    return Topology(name=label, n_nodes=n, adjacency=adj,
                    weights=metropolis_hastings_weights(adj))


def laplacian_consensus_matrix(adjacency: np.ndarray) -> np.ndarray:
    """The paper's experimental construction: W = I - 2/(3 lambda_max(L)) L."""
    adjacency = np.asarray(adjacency, dtype=np.float64)
    deg = np.diag(adjacency.sum(axis=1))
    lap = deg - adjacency
    lam_max = float(np.max(np.linalg.eigvalsh(lap)))
    if lam_max <= 0:
        raise ValueError("graph has no edges")
    return np.eye(adjacency.shape[0]) - (2.0 / (3.0 * lam_max)) * lap


def metropolis_hastings_weights(adjacency: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings weights: always doubly stochastic & symmetric."""
    adjacency = np.asarray(adjacency)
    n = adjacency.shape[0]
    deg = adjacency.sum(axis=1)
    w = np.zeros((n, n))
    for i in range(n):
        for j in np.nonzero(adjacency[i])[0]:
            w[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def _topology(name: str, adjacency: np.ndarray, weights: np.ndarray | None) -> Topology:
    if weights is None:
        weights = laplacian_consensus_matrix(adjacency)
    return Topology(name=name, n_nodes=adjacency.shape[0],
                    adjacency=np.asarray(adjacency), weights=np.asarray(weights))


def ring(n: int, self_weight: float | None = None) -> Topology:
    """Symmetric ring; maps to two `collective-permute`s on a TPU torus.

    ``self_weight`` defaults to 1/3 (uniform over {self, left, right}).
    """
    if n < 2:
        raise ValueError("ring needs n >= 2")
    adj = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        adj[i, (i + 1) % n] = 1
        adj[i, (i - 1) % n] = 1
    if n == 2:
        adj = np.array([[0, 1], [1, 0]], dtype=np.int64)
    if self_weight is None:
        self_weight = 1.0 / 3.0
    nb_weight = (1.0 - self_weight) / 2.0
    w = np.eye(n) * self_weight
    for i in range(n):
        w[i, (i + 1) % n] += nb_weight
        w[i, (i - 1) % n] += nb_weight
    return _topology(f"ring{n}", adj, w)


def torus_2d(rows: int, cols: int) -> Topology:
    """2-D torus: 4 neighbours per node (wraps); the native ICI shape."""
    n = rows * cols
    adj = np.zeros((n, n), dtype=np.int64)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if j != i:
                    adj[i, j] = 1
    w = metropolis_hastings_weights(adj)
    return _topology(f"torus{rows}x{cols}", adj, w)


def complete(n: int) -> Topology:
    """Fully connected; W = (1/n) 11^T. beta = 0 (one-shot consensus)."""
    adj = np.ones((n, n), dtype=np.int64) - np.eye(n, dtype=np.int64)
    w = np.full((n, n), 1.0 / n)
    return _topology(f"complete{n}", adj, w)


def star(n: int) -> Topology:
    adj = np.zeros((n, n), dtype=np.int64)
    adj[0, 1:] = 1
    adj[1:, 0] = 1
    w = metropolis_hastings_weights(adj)
    return _topology(f"star{n}", adj, w)


def erdos_renyi(n: int, p_connect: float = 0.35, seed: int = 0,
                ensure_connected: bool = True) -> Topology:
    """The paper's experimental graph: ER(n, p_c=0.35), Laplacian weights."""
    rng = np.random.default_rng(seed)
    for attempt in range(1000):
        upper = rng.random((n, n)) < p_connect
        adj = np.triu(upper, k=1)
        adj = (adj | adj.T).astype(np.int64)
        if not ensure_connected or _is_connected(adj):
            return _topology(f"er{n}_pc{p_connect}_s{seed + attempt}", adj,
                             laplacian_consensus_matrix(adj))
        rng = np.random.default_rng(seed + attempt + 1)
    raise RuntimeError("could not sample a connected ER graph")


# --------------------------------------------------------------------------
# Schedule-aware placement: renumber nodes to hug the ICI ring.
# --------------------------------------------------------------------------
#
# A ppermute round moves each edge's payload across the PHYSICAL
# interconnect; on a 1-D ICI ring the payload between devices a and b
# traverses min(|a-b|, n-|a-b|) hops, and every hop beyond the first is
# a store-and-forward through an intermediate device (serialized
# latency + doubled link occupancy). The gossip graph is LOGICAL — the
# mapping of logical node i to physical device order[i] is ours to
# choose, so high-traffic shifts should land on nearest-neighbour
# permutations. ``greedy_placement`` hill-climbs over pairwise swaps of
# the assignment and by construction never returns a placement worse
# than the identity (ROADMAP's "schedule-aware placement" item).

def placement_cost(adjacency: np.ndarray,
                   order: np.ndarray | None = None) -> int:
    """Extra (non-nearest-neighbour) ICI ring hops per gossip step.

    ``order[i]`` is the physical device logical node i is placed on;
    identity when omitted. Each directed edge (j -> i) costs
    ``ring_distance(order[i], order[j]) - 1`` extra hops, so a graph
    whose every edge lands on physically adjacent devices costs 0.
    """
    adj = np.asarray(adjacency)
    n = adj.shape[0]
    pos = np.arange(n) if order is None else np.asarray(order)
    if sorted(pos.tolist()) != list(range(n)):
        raise ValueError("order must be a permutation of range(n)")
    rows, cols = np.nonzero(adj)
    dist = np.abs(pos[rows] - pos[cols])
    dist = np.minimum(dist, n - dist)
    return int(np.sum(dist - 1))


def greedy_placement(topo_or_adj, max_passes: int = 8) -> np.ndarray:
    """Greedy pairwise-swap renumbering minimizing ``placement_cost``.

    Accepts a Topology/DirectedTopology or a raw adjacency matrix.
    Hill-climbs: repeatedly applies the single swap with the best cost
    reduction until a pass finds none (or ``max_passes`` passes ran).
    Monotone by construction — the returned placement NEVER costs more
    than the identity, so already-optimal layouts (ring, torus rows on a
    matching ICI) are left at their optimum.
    """
    adj = np.asarray(getattr(topo_or_adj, "adjacency", topo_or_adj))
    n = adj.shape[0]
    order = np.arange(n)
    best = placement_cost(adj, order)
    for _ in range(max_passes):
        improved = False
        for a in range(n - 1):
            for b in range(a + 1, n):
                order[a], order[b] = order[b], order[a]
                cost = placement_cost(adj, order)
                if cost < best:
                    best = cost
                    improved = True
                else:
                    order[a], order[b] = order[b], order[a]
        if not improved or best == 0:
            break
    return order


def apply_placement(topo, order: np.ndarray):
    """Renumber a (Directed)Topology: logical node i -> index order[i].

    Returns the same topology type with adjacency and weights permuted
    consistently (A'[order[i], order[j]] = A[i, j]), so the spectrum —
    and therefore every convergence quantity — is untouched; only the
    cyclic-shift decomposition (and hence the ppermute hop pattern)
    changes.
    """
    order = np.asarray(order)
    n = topo.n_nodes
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)   # row/col gather: new index k holds old perm[k]
    adj = np.asarray(topo.adjacency)[np.ix_(perm, perm)]
    w = np.asarray(topo.weights)[np.ix_(perm, perm)]
    return dataclasses.replace(topo, name=f"{topo.name}_placed",
                               adjacency=adj, weights=w)


# --------------------------------------------------------------------------
# Cyclic-shift decomposition (feeds gossip.PermuteSchedule).
# --------------------------------------------------------------------------
#
# Any simple graph on nodes 0..n-1 splits its edge set by the cyclic
# difference s = (receiver - sender) mod n. For a fixed s the send pairs
# {(j, (j+s) % n)} have distinct sources and distinct destinations, so each
# class is a valid (partial) `jax.lax.ppermute` permutation: nodes missing
# from the destination list receive zeros. A graph therefore gossips in
# exactly |{distinct shifts}| collective-permute rounds — 2 for the
# symmetric ring, 4 for a 2-D torus with rows, cols > 2, up to n-1 for a
# dense Erdős–Rényi graph.

def shift_decomposition(adjacency: np.ndarray) -> dict[int, list[tuple[int, int]]]:
    """Group directed edges (sender j -> receiver (j+s) % n) by shift s.

    Returns {shift: [(src, dst), ...]} covering every ordered pair with
    ``adjacency[dst, src] != 0``; shifts with no edges are omitted.
    """
    adj = np.asarray(adjacency)
    n = adj.shape[0]
    rounds: dict[int, list[tuple[int, int]]] = {}
    for s in range(1, n):
        pairs = [(j, (j + s) % n) for j in range(n) if adj[(j + s) % n, j]]
        if pairs:
            rounds[s] = pairs
    return rounds


def shift_receive_weights(topo: "Topology", shift: int) -> np.ndarray:
    """Per-receiver weight vector for one shift round.

    ``out[r] = W[r, (r - shift) % n]`` when the edge exists, else 0 — the
    factor a receiver applies to the payload arriving from its shift-s
    sender (non-edges receive ppermute zeros and a zero weight).
    """
    n = topo.n_nodes
    out = np.zeros((n,), dtype=np.float64)
    for r in range(n):
        j = (r - shift) % n
        if topo.adjacency[r, j]:
            out[r] = topo.weights[r, j]
    return out


def by_name(spec: str, n_nodes: int, *, self_weight: float | None = None,
            seed: int = 0) -> "Topology | DirectedTopology":
    """Parse a CLI topology spec into a Topology on ``n_nodes`` nodes.

    Accepted forms: ``ring``, ``torus`` (auto-factored near-square),
    ``torusRxC``, ``er`` / ``er:<p_connect>``, ``star``, ``complete``,
    and the directed (column-stochastic, push-sum) graphs ``dring`` and
    ``der`` / ``der:<p_connect>``. On a single node every spec collapses
    to the degenerate ``complete(1)`` (W = [[1]], no gossip rounds) so
    1-device smoke meshes work for every method.
    """
    spec = spec.strip().lower()
    if n_nodes == 1:
        return complete(1)
    if spec == "dring":
        return directed_ring(n_nodes, self_weight)
    if spec.startswith("der"):
        p_connect = float(spec.split(":", 1)[1]) if ":" in spec else 0.35
        return directed_erdos_renyi(n_nodes, p_connect, seed=seed)
    if spec == "ring":
        return ring(n_nodes, self_weight)
    if spec.startswith("torus"):
        if spec == "torus":
            rows = next(r for r in range(int(np.sqrt(n_nodes)), 0, -1)
                        if n_nodes % r == 0)
            cols = n_nodes // rows
        else:
            rows, cols = (int(v) for v in spec[len("torus"):].split("x"))
            if rows * cols != n_nodes:
                raise ValueError(
                    f"torus {rows}x{cols} has {rows * cols} nodes, "
                    f"mesh has {n_nodes}")
        return torus_2d(rows, cols)
    if spec.startswith("er"):
        p_connect = float(spec.split(":", 1)[1]) if ":" in spec else 0.35
        return erdos_renyi(n_nodes, p_connect, seed=seed)
    if spec == "star":
        return star(n_nodes)
    if spec == "complete":
        return complete(n_nodes)
    raise ValueError(f"unknown topology spec {spec!r}")


def _is_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        i = frontier.pop()
        for j in np.nonzero(adj[i])[0]:
            if j not in seen:
                seen.add(int(j))
                frontier.append(int(j))
    return len(seen) == n
