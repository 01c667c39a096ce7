"""Training launcher: SDM-DSGD (or another registered method) on an LM.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --smoke --mesh 4 --steps 5 --compressor fixedk:8

The counterpart of ``repro.launch.train``, with the same flags plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain
versions of the kernels). ``--mesh N`` simulates N edge nodes, all held
on the one device as one node block; ``--mesh NxM`` splits each node's
model over a ``model`` axis of M shards, held as a stack on the same
device (``core/model_axis``: every family, at any M that JAX's rules
split a weight by, heads M does not divide split inside a head; the
wire planes take JAX's tensor-parallel buckets):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --smoke --mesh 2x2 --steps 3 --compressor fixedk:8 --device cpu

``--init-method``, ``--rank`` and
``--world-size`` instead run one node per process on
``torch.distributed`` (NCCL on CUDA, one GPU per rank; gloo on the CPU).
Each step runs the method's per-node executor through
``train.steps.make_distributed_train``. ``--sim <scenario>`` instead runs
the event-driven edge-fleet simulator (``repro_torch.sim``) on the
method's stacked reference executor and prints the simulated seconds and
wire bits of each round:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --smoke --mesh 4 --steps 3 --sim straggler --device cpu

The audio and vlm families train on the JAX launcher's stub context
(every row 0.01, in the parameter dtype); ``--sim`` takes text models
only, as in the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Optional

__all__ = ["TrainRun", "train", "simulate_lm", "main"]

SIM_TEXT_ONLY = "--sim supports text models only"


@dataclasses.dataclass
class TrainRun:
    """What ``train`` returns: the final state, one loss per step and
    each step's wall time (on CUDA, synchronised with the compute
    stream: an exchange left in flight on the transport's side stream
    may run on across the step boundary)."""

    state: object
    losses: List[float]
    step_s: List[float]
    tokens_per_step: int


def train(tc, transport, *, steps: int, global_batch: int, seq_len: int,
          seed: int = 0, state=None, on_step: Optional[Callable] = None,
          model_axis=None) -> TrainRun:
    """The launcher's step loop: ``steps`` steps of
    ``make_distributed_train`` on the synthetic token stream, with the
    JAX launcher's stub context (``transformer.stub_context``) for the
    audio / vlm families, in the parameter dtype. ``state`` defaults to
    ``init_distributed_state`` from ``seed``; ``on_step(t, loss,
    seconds)`` is called after each step. Under ``overlap`` each step
    leaves its exchange in flight for the next; the last one is waited
    on before the state is returned. ``model_axis`` runs each node's
    model over its M shards (``core/model_axis.StackModelAxis``)."""
    import torch

    from repro_torch.core.transport import settle
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer
    from repro_torch.train import steps as steps_mod

    cfg = tc.model
    if state is None:
        state = steps_mod.init_distributed_state(tc, transport, seed=seed,
                                                 model_axis=model_axis)
    step_fn = steps_mod.make_distributed_train(tc, transport,
                                               model_axis=model_axis)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch=global_batch,
                         seq_len=seq_len, seed=seed)
    dev = transport.device
    context = transformer.stub_context(cfg, global_batch, tc.param_dtype,
                                       dev)
    losses, step_s = [], []
    for t in range(steps):
        tokens, labels = (torch.as_tensor(a, device=dev)
                          for a in stream.batch_at(t))
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens, labels, context)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if on_step is not None:
            on_step(t, losses[-1], step_s[-1])
    return TrainRun(state=settle(state), losses=losses, step_s=step_s,
                    tokens_per_step=global_batch * seq_len)


def simulate_lm(cfg, sdm_cfg, method: str, n_nodes: int, *, batch: int,
                seq_len: int, rounds: int, scenario, topology: str = "ring",
                seed: int = 0, device="cuda", params=None):
    """The ``--sim`` axis: an event-driven edge-fleet run of ``method`` on
    the stacked reference executor, all ``n_nodes`` nodes on ``device``,
    f32 parameters (``params``, or ``transformer.init_params`` from
    ``seed``), each node's gradient by autograd one node at a time.
    Returns the ``sim.SimResult``. Text models only."""
    import torch

    from repro_torch import tree as tree_mod
    from repro_torch._device import resolve_device
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer
    from repro_torch.sim import simulate
    from repro_torch.train.steps import node_grads

    if cfg.family in ("audio", "vlm"):
        raise ValueError(SIM_TEXT_ONLY)
    dev = resolve_device(device)
    per_node = max(batch // n_nodes, 1)
    stream = TokenStream(vocab_size=cfg.vocab_size, batch=n_nodes * per_node,
                         seq_len=seq_len, seed=seed)
    if params is None:
        params = transformer.init_params(cfg, seed=seed, dtype=torch.float32,
                                         device=dev)
    stack = tree_mod.tree_map(
        lambda p: p.to(dev)[None].expand((n_nodes,) + tuple(p.shape))
        .clone(), params)
    del params              # the stack is the run's only copy

    def grad_fn(params_stack, batch_stack):
        grads, losses = node_grads(cfg, params_stack, *batch_stack)
        return grads, torch.mean(losses)

    def batches():
        t = 0
        while True:
            yield tuple(torch.as_tensor(a, device=dev)
                        .reshape(n_nodes, per_node, -1)
                        for a in stream.batch_at(t))
            t += 1

    return simulate(topo=topology, algorithm=method, sdm_cfg=sdm_cfg,
                    params_stack=stack, grad_fn=grad_fn, batches=batches(),
                    rounds=rounds, scenario=scenario, seed=seed, device=dev)


def _run_simulated(args, cfg, sdm_cfg, meth_name, n_nodes, batch, seq,
                   dev) -> None:
    """The --sim axis of ``main``: ``simulate_lm`` and its report."""
    from repro_torch.sim import Fleet, parse_scenario

    spec = parse_scenario(args.sim)
    print("sim fleet: " + Fleet(n_nodes, spec, seed=args.seed).describe())
    res = simulate_lm(cfg, sdm_cfg, meth_name, n_nodes, batch=batch,
                      seq_len=seq, rounds=args.sim_rounds or args.steps,
                      scenario=spec, topology=args.topology, seed=args.seed,
                      device=dev)
    r = res.result
    for t in range(len(r.losses)):
        print(f"round {t:4d} t_sim {r.sim_time_s[t]:9.3f}s "
              f"loss {r.losses[t]:.4f} "
              f"wire_bits {r.comm_bits[t]}", flush=True)
    print(f"sim done: rounds={res.rounds} t_sim={res.sim_seconds:.3f}s "
          f"stragglers={res.straggler_rounds} dropouts={res.dropout_rounds} "
          f"recompiles={res.recompiles} events={len(res.trace)}")


def _save(directory: str, step: int, state, transport) -> str:
    """The node block's state as the JAX package's flat npz (bf16 leaves
    as 2-byte opaque data, as ``np.savez`` stores jax's bfloat16); one
    file per rank under ``node<rank>/`` on a process group."""
    import os

    from repro_torch.checkpoint import save_checkpoint

    if transport.me.shape[0] != transport.n:
        directory = os.path.join(directory, f"node{int(transport.me[0])}")
    return save_checkpoint(directory, step, state)


def _describe_buckets(tc, mesh) -> None:
    """The run's wire-plane buckets (key, lane, rows)."""
    from repro_torch.core import plane as plane_mod
    from repro_torch.models import transformer
    from repro_torch.train import steps as steps_mod

    template = transformer.unflatten({
        k: plane_mod.ShapeDtype(s, tc.param_dtype)
        for k, s in transformer.param_shapes(tc.model).items()})
    with steps_mod.bucket_ctx(tc, mesh.model):
        spec = plane_mod.ParamPlane.for_tree(template)
    print(f"model axis {mesh.model}: {spec.n_buckets} wire-plane buckets",
          flush=True)
    for i, b in enumerate(spec.buckets):
        print(f"  bucket {i}: key {b.key} lane {b.lane} rows {b.rows} "
              f"({len(b.leaves)} leaves)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--mesh", default="2",
                    help="N or NxM: N simulated edge nodes, each node's "
                         "model split over a model axis of M shards "
                         "(tensor parallelism: every family; heads M "
                         "does not divide split inside a head)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--method", default=None,
                    help="method registry name (repro_torch.core.method): "
                         "sdm-dsgd | sdm-dsgd-fused | dc-dsgd | dsgd | "
                         "allreduce")
    ap.add_argument("--algorithm", default=None,
                    help="deprecated alias of --method")
    ap.add_argument("--p", type=float, default=0.2)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--gamma", type=float, default=1e-2)
    ap.add_argument("--sigma", type=float, default=0.0)
    ap.add_argument("--clip-c", type=float, default=None)
    ap.add_argument("--gossip-mode", default="bernoulli",
                    choices=["bernoulli", "fixedk_packed", "fixedk_rows",
                             "qsgd"])
    ap.add_argument("--compressor", default=None,
                    help="wire compressor spec (repro_torch.core."
                         "compressor): bernoulli | fixedk[:block] | "
                         "block:<B> | rows | qsgd[:bits] | qsgdf[:bits]; "
                         "overrides --gossip-mode")
    ap.add_argument("--overlap", action="store_true",
                    help="one-step-stale neighbour mixing: the exchange "
                         "started at step t is waited on at step t+1, free "
                         "to run on under that step's gradient (static "
                         "topologies only)")
    ap.add_argument("--topology", default="ring",
                    help="ring | torus | torusRxC | er | er:<p_c> | star | "
                         "complete | matchings:<L> (time-varying)")
    ap.add_argument("--topology-seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sim", default=None,
                    help="run under the event-driven edge-fleet simulator "
                         "instead of the lock-step distributed step: a "
                         "preset (no-fault | straggler | dropout | churn) "
                         "or a scenario spec like 'q=0.8,deadline=1.5,"
                         "straggle=0.25x8,dropout=0.05,churn=0.02:5' (see "
                         "repro_torch.sim.fleet)")
    ap.add_argument("--sim-rounds", type=int, default=None,
                    help="global rounds to simulate (defaults to --steps)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init-method", default=None,
                    help="torch.distributed init method (e.g. "
                         "tcp://localhost:29500): one node per process")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=1)
    args = ap.parse_args(argv)

    if args.sim and args.init_method:
        ap.error("--sim simulates every node in one process: drop "
                 "--init-method")
    if args.overlap and args.topology.startswith("matchings"):
        ap.error("--overlap needs a static topology: the double-buffered "
                 "transport has no replica (time-varying) delivery path")

    import torch

    from repro_torch import configs
    from repro_torch._device import resolve_device
    from repro_torch.core import method as method_mod
    from repro_torch.core.sdm_dsgd import SDMConfig
    from repro_torch.core.transport import (ProcessGroupTransport,
                                            StackTransport)
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.train import steps as steps_mod

    meth_name = method_mod.normalize(
        args.method or args.algorithm or "sdm-dsgd")
    method_mod.get(meth_name)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    mesh = parse_mesh(args.mesh)
    n_nodes = mesh.n_nodes
    dev = resolve_device(args.device)
    if mesh.model > 1 and (args.init_method or args.sim):
        ap.error("a model axis above 1 runs with every node in one process "
                 "(its shards stacked on one device): drop --init-method "
                 "and --sim (a model-axis process group is ROADMAP Queue 1, "
                 "item 4)")
    if args.init_method:
        import torch.distributed as dist

        if args.world_size != n_nodes:
            ap.error(f"--world-size {args.world_size} != --mesh nodes "
                     f"{n_nodes}: one node per process")
        if dev.type == "cuda":
            torch.cuda.set_device(args.rank % torch.cuda.device_count())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=args.init_method,
                                rank=args.rank, world_size=args.world_size)
        transport = ProcessGroupTransport()
    else:
        transport = StackTransport(n_nodes, dev)

    batch = args.global_batch or 2 * n_nodes
    seq = args.seq_len or (64 if args.smoke else 4096)
    sdm_cfg = SDMConfig(p=args.p, theta=args.theta, gamma=args.gamma,
                        sigma=args.sigma, clip_c=args.clip_c,
                        mode=args.gossip_mode, compressor=args.compressor,
                        overlap=args.overlap)
    tc = steps_mod.DistributedTrainConfig(
        model=cfg, sdm=sdm_cfg, topology=args.topology,
        topology_seed=args.topology_seed, method=meth_name,
        param_dtype=torch.float32 if args.smoke else torch.bfloat16)
    sched = steps_mod.gossip_schedule(tc, n_nodes)
    model_axis = None
    if mesh.model > 1:
        from repro_torch.core.model_axis import StackModelAxis

        model_axis = StackModelAxis(mesh.model, dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} mesh={mesh.shape} nodes={n_nodes} "
          f"method={meth_name} p={args.p} theta={args.theta} "
          f"compressor={args.compressor or sdm_cfg.mode} "
          f"topology={sched.name} gossip_rounds={sched.n_rounds}"
          + (f" time_varying_L={sched.length}" if sched.length > 1 else "")
          + (" overlap=on" if args.overlap else "")
          + f" device={where}", flush=True)
    if model_axis is not None:
        _describe_buckets(tc, mesh)

    if args.sim:
        if cfg.family in ("audio", "vlm"):
            raise SystemExit(SIM_TEXT_ONLY)
        if n_nodes < 2:
            raise SystemExit("--sim needs a >= 2-node mesh (e.g. --mesh 4)")
        _run_simulated(args, cfg, sdm_cfg, meth_name, n_nodes, batch, seq,
                       dev)
        return

    def report(t, loss, seconds):
        extra = ""
        if model_axis is not None:
            extra = " model-axis " + " ".join(
                f"{op} {model_axis.calls[op]} ({model_axis.bytes[op]} B)"
                for op in model_axis.calls if model_axis.calls[op])
            model_axis.reset_counters()
        print(f"step {t:4d} loss {loss:.4f} ({seconds:.2f}s){extra}",
              flush=True)

    try:
        run = train(tc, transport, steps=args.steps, global_batch=batch,
                    seq_len=seq, seed=args.seed, on_step=report,
                    model_axis=model_axis)
        if args.checkpoint_dir:
            path = _save(args.checkpoint_dir, args.steps, run.state,
                         transport)
            print(f"checkpoint written to {path}")
        if args.init_method:
            torch.distributed.barrier()   # all ranks reach the teardown
    finally:
        if args.init_method:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
