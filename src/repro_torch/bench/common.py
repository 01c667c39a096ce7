"""Shared benchmark scaffolding: the paper's 50-node MLR test bed.

Port of ``benchmarks/common.py``: ``make_mlr_testbed`` (ER(50, 0.35) or
any ``gossip.sequence_by_name`` graph, MLR on MNIST-shaped data),
``timeit_us`` and ``emit``. Times on a CUDA device come from CUDA events
around the calls (the device's time); on the CPU from ``perf_counter``.

The paper's experiment scripts return a ``PaperRun``: what the JAX
script's ``run()`` returns, its line's derived column, and the outcome
of each claim the JAX script asserts. ``settle`` asserts
them when the caller asks (``check=True``, the scripts' default and
their ``__main__``); otherwise the caller reads and reports them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict

import torch

from repro_torch import prng, tree as tree_mod
from repro_torch._device import resolve_device
from repro_torch.core import gossip, topology
from repro_torch.data import classification_dataset, node_partitioned_batches
from repro_torch.models import vision_small

__all__ = ["N_NODES", "N_FEATURES", "N_CLASSES", "N_TRAIN", "BATCH_PER_NODE",
           "make_mlr_testbed", "timeit_us", "emit", "store_baseline",
           "PaperRun", "settle"]

N_NODES = 50
N_FEATURES = 784          # MNIST-shaped
N_CLASSES = 10
N_TRAIN = 10_000
BATCH_PER_NODE = 16


def make_mlr_testbed(seed: int = 0, n_train: int = N_TRAIN,
                     topology_spec: str = "er:0.35", device="cuda"):
    """Paper section 5: ER(50, 0.35) graph + MLR on MNIST-shaped data.
    ``topology_spec`` swaps the graph (``gossip.sequence_by_name``
    syntax: the directed dring / der graphs for gradient-push, or a
    time-varying "matchings:<L>" sequence). Returns (topology, params
    stack, grad_fn, eval_fn, batches, m_local), the params and the test
    set on ``device`` (the card unless the caller passes "cpu"; raises
    without one)."""
    device = resolve_device(device)
    if topology_spec.startswith("matchings"):
        topo = gossip.sequence_by_name(topology_spec, N_NODES, seed=seed)
    else:
        topo = topology.by_name(topology_spec, N_NODES, seed=seed)
    (x_tr, y_tr), (x_te, y_te) = classification_dataset(
        N_FEATURES, N_CLASSES, n_train, 2000, seed=seed)
    params0 = vision_small.mlr_init(prng.PRNGKey(seed, device=device))
    params_stack = tree_mod.tree_map(
        lambda p: p[None].expand((N_NODES,) + tuple(p.shape)).clone(),
        params0)
    grad_fn = vision_small.make_stacked_grad_fn(vision_small.mlr_apply)
    eval_fn = vision_small.make_eval_fn(
        vision_small.mlr_apply, torch.as_tensor(x_te, device=device),
        torch.as_tensor(y_te, device=device))
    batches = node_partitioned_batches(x_tr, y_tr, N_NODES, BATCH_PER_NODE,
                                       seed=seed)
    m_local = n_train // N_NODES
    return topo, params_stack, grad_fn, eval_fn, batches, m_local


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda
               for a in tree_mod.leaves(list(args)))


def timeit_us(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """Microseconds per ``fn(*args)``: CUDA events when an argument lies
    on the card, else the host clock."""
    for _ in range(warmup):
        fn(*args)
    if not _on_cuda(args):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}")


def store_baseline(path: str, device: str, section: dict) -> None:
    """Set a gate's baseline file's ``device`` section, keeping the other
    devices' sections."""
    base = {}
    if os.path.exists(path):
        with open(path) as f:
            base = json.load(f)
    base[device] = section
    with open(path, "w") as f:
        json.dump(base, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"# updated {path} [{device}]")


@dataclasses.dataclass
class PaperRun:
    """One paper script's outcome: ``data`` is what the JAX script's
    ``run()`` returns, ``derived`` its emitted line's derived column,
    ``claims`` each asserted claim's outcome and ``details`` what the
    port adds for its callers (per-run steps, sigma, epsilons, ...)."""

    data: Any
    derived: str
    claims: Dict[str, bool]
    details: Dict[Any, Any] = dataclasses.field(default_factory=dict)


def settle(run: PaperRun, check: bool) -> PaperRun:
    """With ``check``, assert every claim (the JAX script's asserts);
    return ``run`` either way."""
    if check:
        failed = [k for k, held in run.claims.items() if not held]
        assert not failed, f"claims not held: {failed}; {run.derived}"
    return run
