"""Edge-fleet model: heterogeneous compute, bandwidth, faults, churn.

The port's own copy of ``repro.sim.fleet`` (numpy only): the same
scenarios and the same PRNG streams, so a (seed, scenario) pair gives
the same fleet in both packages.

A ``FleetSpec`` is parsed from a scenario spec string (the ``--sim`` CLI
axis and the benchmark scenarios use the same grammar):

    key=value[,key=value...]     e.g.
    "q=0.8,deadline=1.5,straggle=0.25x8,dropout=0.05,churn=0.02:5"

Keys (all optional; omitted keys mean "no such fault"):

    compute=<dist>      per-node seconds of local compute per round
                        (default lognormal:-2.5:0.4 ~ 80ms median)
    bw=<dist>           per-node uplink bandwidth, bits/second, drawn
                        once per node at fleet build
                        (default lognormal:16:0.5 ~ 9 Mbit/s median)
    q=<f>               participation fraction: each up node is sampled
                        into the round independently w.p. q (default 1)
    deadline=<f>        round deadline in seconds; participants whose
                        compute+transmit finishes later are STRAGGLERS —
                        their payload is withheld (one-step-stale gossip)
                        (default none: the round waits for everyone)
    straggle=<f>x<m>    fraction f of nodes are permanent stragglers with
                        compute time multiplied by m
    dropout=<f>         per-round probability a sampled participant dies
                        mid-round (contributes nothing; its compute and
                        any partial transmission are wasted time)
    churn=<f>[:<r>]     per-round per-node probability of a membership
                        flip; a leaving node stays down >= r rounds
                        (default 3) before it may rejoin. Membership
                        changes RECOMPILE the gossip schedule segment.

Distribution specs: ``const:v`` | ``uniform:lo:hi`` | ``exp:mean`` |
``lognormal:mu:sigma`` (mu/sigma of log). Every draw flows through PRNG
streams spawned from the fleet seed — same (seed, spec) gives the same
fleet, faults, and participation trace, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["Distribution", "FleetSpec", "Fleet", "SCENARIOS",
           "parse_scenario", "effective_participation_q"]


@dataclasses.dataclass(frozen=True)
class Distribution:
    """A tiny seedable sampler parsed from ``kind:arg[:arg]`` specs."""

    kind: str
    args: Tuple[float, ...]

    @classmethod
    def parse(cls, spec: "str | float | Distribution") -> "Distribution":
        if isinstance(spec, Distribution):
            return spec
        if isinstance(spec, (int, float)):
            return cls("const", (float(spec),))
        parts = str(spec).split(":")
        kind, args = parts[0], tuple(float(a) for a in parts[1:])
        arity = {"const": 1, "uniform": 2, "exp": 1, "lognormal": 2}
        if kind not in arity:
            raise ValueError(
                f"unknown distribution {spec!r}; use one of {sorted(arity)}")
        if len(args) != arity[kind]:
            raise ValueError(
                f"{kind} takes {arity[kind]} arg(s), got {spec!r}")
        return cls(kind, args)

    def sample(self, rng: np.random.Generator, size=None) -> np.ndarray:
        a = self.args
        if self.kind == "const":
            return np.full(size, a[0]) if size else a[0]
        if self.kind == "uniform":
            return rng.uniform(a[0], a[1], size=size)
        if self.kind == "exp":
            return rng.exponential(a[0], size=size)
        return rng.lognormal(a[0], a[1], size=size)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Parsed scenario knobs (see module docstring for the grammar)."""

    compute: Distribution = Distribution("lognormal", (-2.5, 0.4))
    bandwidth: Distribution = Distribution("lognormal", (16.0, 0.5))
    participation_q: float = 1.0
    deadline: Optional[float] = None
    straggler_frac: float = 0.0
    straggler_slowdown: float = 1.0
    dropout: float = 0.0
    churn: float = 0.0
    churn_min_down: int = 3

    def __post_init__(self) -> None:
        if not (0.0 < self.participation_q <= 1.0):
            raise ValueError(
                f"q must be in (0, 1], got {self.participation_q!r}")
        for fname in ("straggler_frac", "dropout", "churn"):
            v = getattr(self, fname)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{fname} must be in [0, 1], got {v!r}")
        if self.straggler_slowdown < 1.0:
            raise ValueError("straggler slowdown must be >= 1")
        if self.deadline is not None and self.deadline <= 0.0:
            raise ValueError("deadline must be > 0 seconds")
        if self.churn_min_down < 1:
            raise ValueError("churn min-down must be >= 1 round")

    @property
    def faulty(self) -> bool:
        return (self.participation_q < 1.0 or self.deadline is not None
                or self.dropout > 0.0 or self.churn > 0.0)


def parse_scenario(spec: "str | FleetSpec") -> FleetSpec:
    """Parse a scenario spec string (or named preset) into a FleetSpec."""
    if isinstance(spec, FleetSpec):
        return spec
    spec = spec.strip()
    if spec.lower() in SCENARIOS:
        return SCENARIOS[spec.lower()]
    kw = {}
    for item in filter(None, (s.strip() for s in spec.split(","))):
        if "=" not in item:
            raise ValueError(f"scenario items are key=value, got {item!r}")
        k, v = (s.strip() for s in item.split("=", 1))
        if k == "compute":
            kw["compute"] = Distribution.parse(v)
        elif k == "bw":
            kw["bandwidth"] = Distribution.parse(v)
        elif k == "q":
            kw["participation_q"] = float(v)
        elif k == "deadline":
            kw["deadline"] = float(v)
        elif k == "straggle":
            frac, _, slow = v.partition("x")
            kw["straggler_frac"] = float(frac)
            kw["straggler_slowdown"] = float(slow) if slow else 4.0
        elif k == "dropout":
            kw["dropout"] = float(v)
        elif k == "churn":
            rate, _, min_down = v.partition(":")
            kw["churn"] = float(rate)
            if min_down:
                kw["churn_min_down"] = int(min_down)
        else:
            raise ValueError(f"unknown scenario key {k!r} in {spec!r}")
    return FleetSpec(**kw)


# Named presets: the benchmark's scenario axis and handy --sim shorthands.
SCENARIOS = {
    "no-fault": FleetSpec(),
    "straggler": FleetSpec(straggler_frac=0.25, straggler_slowdown=6.0,
                           deadline=0.6),
    "dropout": FleetSpec(participation_q=0.8, dropout=0.1),
    "churn": FleetSpec(churn=0.05, churn_min_down=4),
}


class Fleet:
    """A concrete fleet: per-node rates plus the fault/membership processes.

    All stochastic decisions flow through independent PRNG streams spawned
    from one ``np.random.SeedSequence`` so adding draws to one process
    never perturbs another (the determinism contract).
    """

    def __init__(self, n_nodes: int, spec: "str | FleetSpec",
                 seed: int = 0) -> None:
        if n_nodes < 2:
            raise ValueError("a fleet needs >= 2 nodes")
        self.n_nodes = n_nodes
        self.spec = parse_scenario(spec)
        ss = np.random.SeedSequence(seed)
        (self._rng_build, self._rng_compute, self._rng_part,
         self._rng_drop, self._rng_churn) = (
            np.random.default_rng(s) for s in ss.spawn(5))

        self.bandwidth = np.maximum(
            self.spec.bandwidth.sample(self._rng_build, n_nodes), 1.0)
        n_strag = int(round(self.spec.straggler_frac * n_nodes))
        self.stragglers = np.zeros(n_nodes, dtype=bool)
        if n_strag:
            idx = self._rng_build.choice(n_nodes, size=n_strag,
                                         replace=False)
            self.stragglers[idx] = True
        self.up = np.ones(n_nodes, dtype=bool)       # current membership
        self._down_until = np.zeros(n_nodes, dtype=np.int64)

    # -- per-round processes ------------------------------------------------
    def compute_time(self, node: int) -> float:
        t = float(self.spec.compute.sample(self._rng_compute))
        if self.stragglers[node]:
            t *= self.spec.straggler_slowdown
        return max(t, 1e-6)

    def transmit_time(self, node: int, bits: int) -> float:
        return float(bits) / float(self.bandwidth[node])

    def sample_participants(self) -> np.ndarray:
        """(n,) bool: up nodes sampled into this round w.p. q (>= 2 kept).

        When the Bernoulli draw leaves fewer than two participants the
        smallest-index up nodes are forced in — a 1-node "round" has no
        gossip semantics at all.
        """
        q = self.spec.participation_q
        part = self.up & (self._rng_part.random(self.n_nodes) < q)
        deficit = 2 - int(part.sum())
        if deficit > 0:
            for i in np.nonzero(self.up & ~part)[0][:deficit]:
                part[i] = True
        return part

    def sample_dropouts(self, participants: np.ndarray) -> np.ndarray:
        """(n,) bool: participants that die mid-round (no contribution)."""
        if self.spec.dropout <= 0.0:
            return np.zeros(self.n_nodes, dtype=bool)
        dead = participants & (
            self._rng_drop.random(self.n_nodes) < self.spec.dropout)
        # never kill the whole round
        alive = participants & ~dead
        if int(alive.sum()) < 2:
            for i in np.nonzero(dead)[0][:2 - int(alive.sum())]:
                dead[i] = False
        return dead

    def churn_step(self, round_index: int) -> List[Tuple[int, str]]:
        """Advance membership one round; returns [(node, "join"|"leave")].

        Leaves keep >= churn_min_down rounds of downtime; at most
        n_nodes - 2 nodes may be down at once.
        """
        events: List[Tuple[int, str]] = []
        if self.spec.churn <= 0.0:
            return events
        flips = self._rng_churn.random(self.n_nodes) < self.spec.churn
        for i in range(self.n_nodes):
            if self.up[i] and flips[i]:
                if int(self.up.sum()) <= 2:
                    continue
                self.up[i] = False
                self._down_until[i] = round_index + self.spec.churn_min_down
                events.append((i, "leave"))
            elif not self.up[i] and flips[i] and \
                    round_index >= self._down_until[i]:
                self.up[i] = True
                events.append((i, "join"))
        return events

    def mean_bandwidth(self) -> float:
        return float(np.mean(self.bandwidth))

    def describe(self) -> str:
        s = self.spec
        bits = [f"n={self.n_nodes}", f"q={s.participation_q}"]
        if s.deadline is not None:
            bits.append(f"deadline={s.deadline}s")
        if s.straggler_frac:
            bits.append(f"straggle={s.straggler_frac}x{s.straggler_slowdown}")
        if s.dropout:
            bits.append(f"dropout={s.dropout}")
        if s.churn:
            bits.append(f"churn={s.churn}:{s.churn_min_down}")
        bits.append(f"bw~{self.mean_bandwidth() / 1e6:.1f}Mbit/s")
        return " ".join(bits)


def effective_participation_q(fleet: Fleet) -> float:
    """The q the privacy accountant should amplify with.

    Participation sampling, mid-round dropout, and churn downtime all
    REDUCE how often a node's data is released, but only the sampling is
    adversary-independent randomness the subsampled-RDP lemma can use;
    charging q alone (ignoring dropout/churn) is the conservative bound.
    """
    return fleet.spec.participation_q


