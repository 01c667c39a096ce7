"""What one call dispatches and launches: the port's stand-in for the JAX
package's ``launch.hlo_analysis`` counts.

The JAX package compiles a step and counts instructions, fusions and
collectives in its HLO. The port runs eagerly, so it counts at run time,
over one call made inside the counters' ``with`` blocks:

* ``OpCount``: the ATen ops the call dispatches (a ``TorchDispatchMode``,
  below autograd), by op. ``launches`` leaves out the view ops (they
  launch nothing on any device): on a device where each ATen op is one
  kernel it is the call's launch count. A wrapper that launches a
  hand-written kernel on CUDA runs its plain version's ops on the CPU,
  so the counts of such a call differ between the two devices;
  elsewhere they are the same on any device.
* ``KernelLaunches``: on CUDA, the device kernels the call launches,
  counted as the kernel-launch API calls (``cudaLaunchKernel``,
  ``cuLaunchKernel``, ...) in the block's ``torch.profiler`` trace. It
  includes the hand-written kernels (launched through ``ctypes``),
  which each wrapper's ``.launches`` also counts, and cuBLAS's. Memory
  copies and sets are not kernels. ``records`` is the device's own
  kernel records in the trace: a process that has traced much work
  before loses some of them (``chip_smoke.py`` phase 18 prints both),
  so only the launch calls read the same in any process. Warm the call
  up first: a first call also loads libraries and sets up cuBLAS. On
  the CPU there are no kernels and ``n`` and ``records`` stay None.

The two nest, with the op counter inside::

    with KernelLaunches(device) as kl, OpCount() as ops:
        step()
    ops.total, ops.launches, ops.by_name, kl.n, kl.by_name, kl.records

* ``ByteCount``: the dry-run's byte and memory counter (``launch/dryrun``,
  on the ``meta`` device, where shapes exist and data does not).
  ``nbytes`` is the bytes of every tensor input and output of every ATen
  op that is not a view and not an allocation (``empty``): what the
  eager port moves op by op, each op reading its inputs and writing its
  outputs in full (a broadcast input counts at its broadcast size).
  ``peak`` is the most bytes of storage made inside the block that were
  alive at once: each new output storage is added when an op makes it
  and taken off when its last reference dies (a ``weakref.finalize`` on
  the storage), so saved activations count until backward frees them.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpCount", "KernelLaunches", "ByteCount"]

_ALIASING = {"aten._unsafe_view", "aten._reshape_alias"}


class OpCount(TorchDispatchMode):
    """ATen ops dispatched inside the block: ``total``, ``launches``
    (those that are not views) and ``by_name`` (op -> count)."""

    def __init__(self):
        super().__init__()
        self.by_name: Counter = Counter()
        self.views = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.by_name[name] += 1
        if func.is_view or name in _ALIASING:
            self.views += 1
        return func(*args, **(kwargs or {}))

    @property
    def total(self) -> int:
        return sum(self.by_name.values())

    @property
    def launches(self) -> int:
        return self.total - self.views

    def count(self, *names: str) -> int:
        """Calls of the named ops (``"aten.sort"``, ...)."""
        return sum(self.by_name[n] for n in names)


# the host calls that launch one kernel each
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cuLaunchCooperativeKernel")


class KernelLaunches:
    """Kernels launched inside the block, on CUDA: ``n``, ``by_name``
    (launch call -> count) and ``records`` (device kernel records). The
    block is synchronised before the trace stops."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.n: Optional[int] = None
        self.by_name: Counter = Counter()
        self.records: Optional[int] = None
        self._prof = None

    def __enter__(self) -> "KernelLaunches":
        if self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize(self.device)
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._prof is None:
            return
        torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        events = self._prof.events()
        self.by_name = Counter(e.name for e in events
                               if e.name in _LAUNCH_CALLS)
        self.n = sum(self.by_name.values())
        cuda = torch.autograd.DeviceType.CUDA
        self.records = sum(e.device_type == cuda
                           and not e.name.startswith(("Memcpy", "Memset"))
                           for e in events)


_ALLOCATIONS = {"aten.empty", "aten.empty_strided", "aten.empty_like",
                "aten.new_empty", "aten.new_empty_strided"}


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ByteCount(TorchDispatchMode):
    """Bytes moved (``nbytes``) and the peak of live storage bytes made
    inside the block (``peak``; ``live`` now), over the ATen ops
    dispatched there. See the module docstring."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0
        self.live = 0
        self.peak = 0
        self._seen = set()

    def _free(self, key: int, size: int) -> None:
        self._seen.discard(key)
        self.live -= size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if func.is_view or name in _ALIASING:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if name not in _ALLOCATIONS:
            self.nbytes += sum(_tensor_bytes(t) for t in ins + outs)
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._seen:
                continue
            self._seen.add(key)
            size = st.nbytes()
            self.live += size
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, size)
        return out
