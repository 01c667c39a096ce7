"""Node transports: how the per-node executor's payloads cross the wire.

The port's counterpart of the JAX package's node axis under
``shard_map``: ``lax.axis_index`` (which node am I), the one wire call
site ``gossip._wire_ppermute`` (``lax.ppermute``) and the loss ``pmean``
of ``train/steps.py``.

The per-node code works on a NODE BLOCK: every state tensor has a
leading dim L of the nodes this process holds, and ``transport.me`` is
an (L,) int64 tensor of their indices. Two transports give that block:

* ``StackTransport(n, device)`` holds all n nodes on one device (L = n):
  one card simulating n edge nodes, or the CPU tests;
* ``ProcessGroupTransport(group)`` holds one node per rank of a
  ``torch.distributed`` process group (L = 1); each ``ppermute`` is one
  ``dist.batch_isend_irecv`` of point-to-point sends and receives. NCCL
  takes CUDA tensors and gloo CPU tensors; any other pairing raises, and
  nothing is staged through the host.

``ppermute(x, perm)`` has ``lax.ppermute``'s semantics: for each
(src, dst) pair the receiver dst gets the sender src's block row, and a
node that is no destination receives zeros. It is
``ppermute_start(x, perm, defer=False)`` waited on at once (on the
stack transport, every op of it on the current stream).
``ppermute_start`` returns a ``Pending`` exchange whose ``wait()``
gives the result; with ``defer`` (its default) the exchange may stay in
flight under other work (the executor's ``overlap``: the exchange
started at step t is waited on at step t+1):

* ``ProcessGroupTransport`` keeps the ``batch_isend_irecv`` requests and
  waits on them in ``wait()``;
* ``StackTransport`` on the card makes a deferred copy on a side CUDA
  stream it holds and records an event there; ``wait()`` makes the
  current stream wait on that event. Every buffer that crosses the two
  streams is marked with ``Tensor.record_stream``, so the caching
  allocator never hands a buffer that the side stream still reads (or
  that the current stream will read) to other work. On the CPU, and
  when not deferred, the copy runs on the current stream before
  ``ppermute_start`` returns. ``outstanding`` counts the side-stream
  copies not yet waited on.

Both transports count every exchange once, when it starts
(``permutes``; a payload of several tensors is one call per tensor, as
each is one collective-permute in the JAX package), and the bytes each
node they hold puts on the wire (``bytes_sent``): the parity contract's
send and byte invariants (``core/wire_count.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch._device import resolve_device

__all__ = ["Pending", "settle", "StackTransport", "ProcessGroupTransport"]

Perm = Sequence[Tuple[int, int]]


class Pending:
    """Work in flight. ``wait()`` finishes it once and returns its
    result; later calls return the same object."""

    __slots__ = ("_finish", "_value")

    def __init__(self, finish: Callable[[], Any]):
        self._finish = finish
        self._value = None

    @classmethod
    def done(cls, value) -> "Pending":
        """A pending result that is already complete."""
        out = cls(None)
        out._value = value
        return out

    @property
    def in_flight(self) -> bool:
        return self._finish is not None

    def wait(self):
        if self._finish is not None:
            finish, self._finish = self._finish, None
            self._value = finish()
        return self._value


def settle(tree):
    """``tree`` with every ``Pending`` leaf waited on and replaced by its
    result (an executor state's in-flight overlap buffer)."""
    return tree_mod.tree_map(
        lambda v: v.wait() if isinstance(v, Pending) else v, tree)


class _Counters:
    """ppermute calls and per-node bytes sent, over the held nodes."""

    nodes: Tuple[int, ...] = ()

    def reset_counters(self) -> None:
        self.permutes = 0
        self.bytes_sent: Dict[int, int] = {i: 0 for i in self.nodes}

    def _count(self, x: torch.Tensor, perm: Perm) -> None:
        self.permutes += 1
        row = x[0].numel() * x.element_size()
        for src, _ in perm:
            if src in self.bytes_sent:
                self.bytes_sent[src] += row

    def ppermute(self, x: torch.Tensor, perm: Perm) -> torch.Tensor:
        """``ppermute_start(x, perm, defer=False).wait()``."""
        return self.ppermute_start(x, perm, defer=False).wait()


class StackTransport(_Counters):
    """All ``n`` nodes of the run as one block on one device: the card
    unless the caller passes ``device="cpu"`` (raises without one)."""

    def __init__(self, n: int, device="cuda"):
        self.n = int(n)
        self.device = resolve_device(device)
        self.me = torch.arange(self.n, device=self.device)
        self.nodes = tuple(range(self.n))
        self.outstanding = 0
        self._side = None
        self._index: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.reset_counters()

    @property
    def side_stream(self):
        """The CUDA stream the deferred exchanges ride (made at first
        use)."""
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def _pairs(self, perm: Perm):
        key = tuple(perm)
        got = self._index.get(key)
        if got is None:
            src = torch.tensor([s for s, _ in key], dtype=torch.long,
                               device=self.device)
            dst = torch.tensor([d for _, d in key], dtype=torch.long,
                               device=self.device)
            got = self._index[key] = (src, dst)
        return got

    def _permute(self, x: torch.Tensor, perm: Perm) -> torch.Tensor:
        out = torch.zeros_like(x)
        if perm:
            src, dst = self._pairs(perm)
            out[dst] = x[src]
        return out

    def ppermute_start(self, x: torch.Tensor, perm: Perm, *,
                       defer: bool = True) -> Pending:
        """out[dst] = x[src] for every (src, dst) in ``perm``, zeros for
        a node that is no destination; deferred on the card, in flight
        on the side stream."""
        if x.shape[0] != self.n:
            raise ValueError(f"StackTransport holds {self.n} nodes, got a "
                             f"block of {x.shape[0]}")
        self._count(x, perm)
        if not (defer and x.is_cuda):
            return Pending.done(self._permute(x, perm))
        self._pairs(perm)               # index tensors made on this stream
        side = self.side_stream
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            out = self._permute(x, perm)
            event = torch.cuda.Event()
            event.record(side)
        x.record_stream(side)           # read there; its owner may free it
        self.outstanding += 1

        def finish():
            current = torch.cuda.current_stream(out.device)
            current.wait_event(event)
            out.record_stream(current)  # made there, read here from now on
            self.outstanding -= 1
            return out

        return Pending(finish)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Every node's row replaced by the mean over all n nodes."""
        return torch.mean(x, dim=0, keepdim=True).expand_as(x)


class ProcessGroupTransport(_Counters):
    """One node per rank of a ``torch.distributed`` process group.

    The node index is the rank in ``group`` (default: the world group).
    Tensors must live where the backend works: CUDA for NCCL (one GPU
    per rank; NCCL refuses two ranks on one device), the CPU for gloo.
    """

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.n = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group)).lower()
        if self.backend == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.backend == "gloo":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"unsupported backend {self.backend!r} "
                             "(nccl or gloo)")
        self.me = torch.tensor([self.rank], dtype=torch.long,
                               device=self.device)
        self.nodes = (self.rank,)
        self.reset_counters()

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != 1:
            raise ValueError(f"ProcessGroupTransport holds one node per "
                             f"rank, got a block of {x.shape[0]}")
        if x.device.type != self.device.type:
            raise ValueError(f"{self.backend} takes {self.device.type} "
                             f"tensors, got one on {x.device}")

    def _peer(self, node: int) -> int:
        if self.group is None:
            return node
        return self._dist.get_global_rank(self.group, node)

    def ppermute_start(self, x: torch.Tensor, perm: Perm, *,
                       defer: bool = True) -> Pending:
        """The ppermute round as one batch of point-to-point ops, its
        requests waited on in ``wait()`` (``defer`` or not: the caller
        that does not defer waits at once)."""
        self._check(x)
        self._count(x, perm)
        dist = self._dist
        out = torch.zeros_like(x)
        row = x[0].contiguous()
        ops = []
        for src, dst in perm:
            if src == self.rank and dst == self.rank:
                out[0].copy_(row)
            elif src == self.rank:
                ops.append(dist.P2POp(dist.isend, row, self._peer(dst),
                                      self.group))
            elif dst == self.rank:
                ops.append(dist.P2POp(dist.irecv, out[0], self._peer(src),
                                      self.group))
        if not ops:
            return Pending.done(out)
        # the send buffer stays alive with the requests, until wait()
        held = (dist.batch_isend_irecv(ops), row)

        def finish():
            for req in held[0]:
                req.wait()
            return out

        return Pending(finish)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over all ranks (an all-reduce sum, then / n)."""
        self._check(x)
        total = x.contiguous().clone()
        self._dist.all_reduce(total, group=self.group)
        return total / self.n
