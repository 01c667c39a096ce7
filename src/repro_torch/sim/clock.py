"""Deterministic virtual clock + event queue for the edge-fleet simulator.

The port's own copy of ``repro.sim.clock`` (pure Python, no framework).

Time is simulated seconds (float); nothing here ever reads a wall clock.
Determinism contract: events at equal timestamps order by their insertion
sequence number, so a (seed, scenario) pair replays to a bit-identical
event trace on any host — the property ``tests/test_sim.py`` pins.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, List, Tuple

__all__ = ["Event", "EventQueue", "VirtualClock", "trace_signature"]


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    """One simulator event, totally ordered by (time, seq).

    ``kind`` is a short tag ("compute-done", "send-done", "round-close",
    "join", "leave", ...), ``node`` the subject node (or -1 for fleet-wide
    events), ``data`` a sorted tuple of (key, value) pairs — tuples, not
    dicts, so the trace is hashable and comparable across runs.
    """

    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    node: int = dataclasses.field(compare=False, default=-1)
    data: Tuple[Tuple[str, Any], ...] = dataclasses.field(
        compare=False, default=())


class EventQueue:
    """Min-heap of Events with a deterministic same-time tiebreak."""

    def __init__(self) -> None:
        self._heap: List[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, node: int = -1,
             **data: Any) -> Event:
        ev = Event(time=float(time), seq=self._seq, kind=kind, node=node,
                   data=tuple(sorted(data.items())))
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class VirtualClock:
    """Monotone simulated time; also records the popped-event trace."""

    def __init__(self) -> None:
        self.now = 0.0
        self.trace: List[Event] = []

    def advance_to(self, t: float) -> None:
        if t < self.now - 1e-12:
            raise ValueError(f"clock moved backwards: {t} < {self.now}")
        self.now = max(self.now, float(t))

    def record(self, ev: Event) -> Event:
        self.advance_to(ev.time)
        self.trace.append(ev)
        return ev

    def drain(self, queue: EventQueue, until: float) -> List[Event]:
        """Pop + record every event with time <= until (in order)."""
        out: List[Event] = []
        while queue and queue._heap[0].time <= until + 1e-12:
            out.append(self.record(queue.pop()))
        return out


def trace_signature(trace) -> Tuple:
    """A hashable, comparison-stable rendering of an event trace."""
    return tuple((round(ev.time, 9), ev.seq, ev.kind, ev.node, ev.data)
                 for ev in trace)
