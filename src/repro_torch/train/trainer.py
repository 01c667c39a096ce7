"""Single-device trainer for the paper's experiments (CPU-scale models).

Port of ``repro.train.trainer``: drives any registered method's stacked
reference executor (``repro_torch.core.method``) over node-partitioned
batches, and tracks the paper's two metrics -- communicated non-zero
elements and exact wire bits (Fig. 3) and the (eps, delta) privacy spend
(Table 1) -- with eval and checkpointing.

Steps run eagerly (no ``jit``, no ``torch.compile``). The loop reads
each step's loss on the host, as the JAX loop does, which also makes the
recorded per-step wall time (``TrainResult.step_s``) device-synchronised.
The key schedule is the JAX trainer's: ``PRNGKey(seed)``, then ``split``
once per step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import prng, tree as tree_mod
from repro_torch._device import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import gossip, method as method_mod
from repro_torch.core.privacy import PrivacyAccountant, PrivacyParams

__all__ = ["TrainResult", "run_decentralized"]

PyTree = Any


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    comm_elements: List[int]     # cumulative non-zero elements transmitted
    comm_bits: List[int]         # cumulative wire bits (compressor-exact)
    epsilons: List[float]
    eval_accuracy: List[float]
    wall_s: float
    # simulated seconds at the END of each round: filled by the edge-fleet
    # simulator (repro_torch.sim.runner), which charges compute time and
    # bandwidth-limited transmission per node; empty for the lock-step
    # trainer below, whose rounds have no time model.
    sim_time_s: List[float] = dataclasses.field(default_factory=list)
    # wall seconds of each step, ending when its loss reached the host
    step_s: List[float] = dataclasses.field(default_factory=list)
    # the executor's state after the last step (port only: lets a caller
    # inspect what the next step would put on the wire)
    state: Any = None


def _to_device(batch, dev: torch.device):
    """A batch ((x, y) numpy stacks or tensors, or one array) as tensors
    on dev."""
    if isinstance(batch, (tuple, list)):
        return tuple(_to_device(b, dev) for b in batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(dev)
    return torch.as_tensor(np.asarray(batch), device=dev)


def run_decentralized(
    *,
    topo,                            # Topology | ScheduleSequence | spec str
    algorithm: str,                  # method registry name ('sdm_dsgd', ...)
    sdm_cfg: Any,                    # hyper-params; coerced per method
    params_stack: PyTree,
    grad_fn: Callable,               # (params_stack, batch) -> (grads, loss)
    batches: Iterator,
    steps: int,
    seed: int = 0,
    privacy: Optional[PrivacyParams] = None,
    eps_target: float = 1.0,
    eval_fn: Optional[Callable] = None,   # params_stack -> accuracy
    eval_every: int = 50,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    log_every: int = 0,
    device="cuda",
) -> TrainResult:
    """Generic decentralized training loop over a stacked-node executor.

    ``params_stack`` (leaves (n, ...)) moves to ``device`` and each batch
    from ``batches`` (numpy (x, y) stacks, as ``node_partitioned_batches``
    yields) follows it. Without a CUDA device the default ``"cuda"``
    raises; pass ``device="cpu"`` to run on the CPU.
    """
    t0 = time.time()
    dev = resolve_device(device)
    params_stack = tree_mod.tree_map(lambda p: torch.as_tensor(p).to(dev),
                                     params_stack)
    n_nodes = tree_mod.leaves(params_stack)[0].shape[0]
    if isinstance(topo, str):
        seq = gossip.sequence_by_name(topo, n_nodes, seed=seed)
    else:
        seq = gossip.sequence_of(topo)

    meth = method_mod.get(algorithm)
    cfg = meth.coerce_config(sdm_cfg)
    sim = meth.make_reference(seq, cfg)
    per_node = tree_mod.tree_map(lambda x: x[0], params_stack)
    per_step_elems = method_mod.transmitted_elements(meth, per_node, cfg,
                                                     seq=seq)
    per_step_bits = method_mod.transmitted_bits(meth, per_node, cfg, seq=seq)

    state = sim.init(params_stack)
    key = prng.PRNGKey(seed, device=dev)
    accountant = PrivacyAccountant(privacy, eps_target) if privacy else None

    losses, comm, bits, epss, accs, step_s = [], [], [], [], [], []
    total_elems = 0
    total_bits = 0
    for t in range(steps):
        t_step = time.perf_counter()
        key, sub = prng.split(key)
        batch = _to_device(next(batches), dev)
        state, loss = sim.step(state, grad_fn, batch, sub)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t_step)
        total_elems += per_step_elems * n_nodes
        total_bits += per_step_bits * n_nodes
        comm.append(total_elems)
        bits.append(total_bits)
        if accountant is not None:
            accountant.step()
            epss.append(accountant.epsilon)
        if eval_fn is not None and (t + 1) % eval_every == 0:
            accs.append(float(eval_fn(sim.eval_params(state))))
        if checkpoint_dir and checkpoint_every and \
                (t + 1) % checkpoint_every == 0:
            flat = tree_mod.flatten_with_paths(state)
            save_checkpoint(checkpoint_dir, t + 1,
                            {k: tree_mod.to_numpy(v) for k, v in flat.items()})
        if log_every and (t + 1) % log_every == 0:
            msg = f"step {t + 1:5d} loss {losses[-1]:.4f}"
            if epss:
                msg += f" eps {epss[-1]:.3e}"
            if accs:
                msg += f" acc {accs[-1]:.4f}"
            print(msg, flush=True)
    return TrainResult(losses=losses, comm_elements=comm, comm_bits=bits,
                       epsilons=epss, eval_accuracy=accs,
                       wall_s=time.time() - t0, step_s=step_s, state=state)
