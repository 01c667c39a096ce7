"""Event-driven edge-fleet runner: simulated wall-clock-to-accuracy.

Port of ``repro.sim.runner``. Drives any registered method's stacked
reference executor under a ``Fleet``'s time model. Each global round:

  1. the fleet samples participants (participation fraction q), mid-round
     dropouts, and membership churn;
  2. every participant is charged its compute time plus its exact wire
     payload (``method.transmitted_bits``) pushed through its sampled
     uplink bandwidth;
  3. a round deadline (when configured) turns late finishers into
     STRAGGLERS: differential methods withhold their payload (neighbours
     mix with one-step-stale public copies and the update merges into the
     next round's differential: ``method.withhold_differential`` /
     ``defer_differential``); methods that transmit absolute state treat
     them as non-participants;
  4. the round's mixing graph is the induced subgraph on contributors
     (``topology.masked_subgraph``), built per membership segment into an
     ordinary ``ScheduleSequence``; a segment whose membership varies is
     genuinely time-varying and runs the reference executor's replica
     path. Membership churn ends the segment and rebuilds the executor
     under the new fleet (``recompiles`` counts those segments).

Steps run eagerly on ``device`` (the JAX package jit-compiles one step
function per segment). Everything stochastic flows through the fleet's
numpy PRNG streams plus one ``prng.fold_in(base_key, t)`` key per round,
so a (seed, scenario) pair replays to the same event trace, and to the
JAX package's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, List, Optional

import numpy as np

from repro_torch import prng, tree as tree_mod
from repro_torch._device import resolve_device
from repro_torch.core import gossip, method as method_mod
from repro_torch.core import topology as topology_mod
from repro_torch.core.privacy import PrivacyAccountant
from repro_torch.sim.clock import EventQueue, VirtualClock, trace_signature
from repro_torch.sim.fleet import Fleet, parse_scenario
from repro_torch.train.trainer import TrainResult, _to_device

PyTree = Any

__all__ = ["SimResult", "simulate"]


@dataclasses.dataclass
class SimResult:
    """Outcome of one simulated run (``result`` reuses TrainResult)."""

    result: TrainResult          # losses/comm/epsilons + sim_time_s column
    trace: tuple                 # full ordered event trace (determinism)
    final_params: PyTree         # per-node parameter stack at the end
    rounds: int                  # global rounds executed
    recompiles: int              # executor rebuilds (membership segments)
    straggler_rounds: int        # (node, round) pairs past the deadline
    dropout_rounds: int          # (node, round) pairs dead mid-round
    sim_seconds: float           # final virtual-clock time
    time_to_target: Optional[float] = None   # seconds to target_loss
    rounds_to_target: Optional[int] = None

    @property
    def trace_signature(self):
        return trace_signature(self.trace)


def _out_degree(topo) -> np.ndarray:
    """Per-node payload count on a round graph (col sums when directed)."""
    adj = np.asarray(topo.adjacency)
    if isinstance(topo, topology_mod.DirectedTopology):
        return adj.sum(axis=0).astype(np.int64)
    return adj.sum(axis=1).astype(np.int64)


def _sample_segment(fleet: Fleet, topo, edge_bits: int, start: int,
                    count: int) -> List[dict]:
    """Up to ``count`` rounds of fleet draws from round ``start``, ending
    early after a round whose churn changed the membership."""
    draws = []
    while len(draws) < count:
        t = start + len(draws)
        participants = fleet.sample_participants()
        dead = fleet.sample_dropouts(participants)
        # out-degrees on the participant graph: what each node *plans*
        # to push this round (dead nodes still occupy airtime).
        plan_topo = topology_mod.masked_subgraph(
            topo, np.nonzero(participants)[0], name=f"{topo.name}_plan")
        outdeg = _out_degree(plan_topo)
        comp_tx = {
            int(i): (fleet.compute_time(int(i)),
                     fleet.transmit_time(int(i), edge_bits * int(outdeg[i])))
            for i in np.nonzero(participants)[0]}
        churn = fleet.churn_step(t)
        draws.append(dict(t=t, participants=participants, dead=dead,
                          outdeg=outdeg, comp_tx=comp_tx, churn=churn))
        if churn:
            break               # membership changed: rebuild next segment
    return draws


def _plan_segment(draws, spec, n: int, stale_ok: bool, use_overlap: bool):
    """Each round's plan (finish times, stragglers, the active set) from
    its draws, a pure function of the overlap flag, so a segment can be
    re-planned with the serialized wire without new draws."""
    plans, active_sets = [], []
    for dr in draws:
        participants, dead = dr["participants"], dr["dead"]
        contributors = participants & ~dead
        # overlapped transport: the wire rides under compute, so a node
        # is round-ready at max(compute, tx), not their sum.
        times = {i: (c, max(c, tx) if use_overlap else c + tx)
                 for i, (c, tx) in dr["comp_tx"].items()}
        finishes = {i: f for i, (_, f) in times.items() if contributors[i]}
        close = max(finishes.values()) if finishes else 0.0
        if spec.deadline is not None:
            close = min(close, spec.deadline)
        stragglers = np.zeros(n, dtype=bool)
        if spec.deadline is not None:
            for i, f in finishes.items():
                if f > spec.deadline + 1e-12:
                    stragglers[i] = True
        if stale_ok:
            # stragglers stay IN the round graph, their payload withheld
            round_active = contributors
            withhold = stragglers
        else:
            # absolute-state methods: no deferral buffer, so a straggler
            # degrades to non-participation
            round_active = contributors & ~stragglers
            withhold = np.zeros(n, dtype=bool)
            if int(round_active.sum()) < 2:
                round_active = contributors
                stragglers = np.zeros(n, dtype=bool)
        plans.append(dict(
            t=dr["t"], dead=dead, stragglers=stragglers, withhold=withhold,
            round_active=round_active, times=times, close=close,
            outdeg=dr["outdeg"], churn=dr["churn"]))
        active_sets.append(np.nonzero(round_active)[0])
    return plans, active_sets


def simulate(
    *,
    topo,                              # base Topology | spec string
    algorithm: str,
    sdm_cfg: Any,
    params_stack: PyTree,
    grad_fn: Callable,
    batches: Iterator,
    rounds: int,
    scenario: "str | Any" = "no-fault",
    seed: int = 0,
    privacy=None,                      # PrivacyParams; q is folded in here
    eps_target: float = 1.0,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 0,
    target_loss: Optional[float] = None,
    max_segment: int = 64,
    device="cuda",
) -> SimResult:
    """Run ``rounds`` simulated global rounds and return the SimResult.

    ``topo`` is the FULL-fleet base graph; per-round participation masks
    it. ``privacy`` (when given) is amplified with the scenario's
    participation fraction q before accounting. ``target_loss`` records
    simulated seconds-to-target without stopping the run early.
    ``params_stack`` moves to ``device`` and each batch follows it; the
    default ``"cuda"`` raises without a card (pass ``device="cpu"``).
    """
    dev = resolve_device(device)
    params_stack = tree_mod.tree_map(lambda p: p.to(dev), params_stack)
    n = tree_mod.leaves(params_stack)[0].shape[0]
    if isinstance(topo, str):
        topo = topology_mod.by_name(topo, n)
    if topo.n_nodes != n:
        raise ValueError(f"stack has {n} nodes, topology {topo.n_nodes}")
    spec = parse_scenario(scenario)
    fleet = Fleet(n, spec, seed=seed)

    meth = method_mod.get(algorithm)
    cfg = meth.coerce_config(sdm_cfg)
    stale_ok = method_mod.stale_capable(meth)
    # overlapped transport: a node's round-ready time is max(compute,
    # transmit) instead of their sum
    overlap = bool(getattr(cfg, "overlap", False))
    per_node = tree_mod.tree_map(lambda x: x[0], params_stack)
    # exact per-EDGE payload (seq=None: one payload); timing and comm
    # charges scale by each node's own out-degree per round graph.
    edge_elems = method_mod.transmitted_elements(meth, per_node, cfg)
    edge_bits = method_mod.transmitted_bits(meth, per_node, cfg)

    if privacy is not None and spec.participation_q < 1.0:
        privacy = dataclasses.replace(
            privacy, participation_q=spec.participation_q)
    accountant = PrivacyAccountant(privacy, eps_target) if privacy else None

    wall0 = time.time()
    clock = VirtualClock()
    queue = EventQueue()
    base_key = prng.PRNGKey(seed, device=dev)

    losses: List[float] = []
    comm: List[int] = []
    bits_l: List[int] = []
    epss: List[float] = []
    accs: List[float] = []
    sim_times: List[float] = []
    step_s: List[float] = []
    total_elems = 0
    total_bits = 0
    recompiles = 0
    straggler_rounds = 0
    dropout_rounds = 0
    time_to_target = None
    rounds_to_target = None

    state = None
    carried_x = params_stack
    carried_d = None
    carried_e = None
    t_global = 0

    while t_global < rounds:
        seg_start = t_global
        draws = _sample_segment(fleet, topo, edge_bits, seg_start,
                                min(max_segment, rounds - seg_start))
        seg_plans, seg_active_sets = _plan_segment(draws, spec, n, stale_ok,
                                                   overlap)
        seg_name = f"{topo.name}_seg{seg_start}x{len(seg_active_sets)}"
        seq = gossip.sequence_from_active_sets(topo, seg_active_sets,
                                               name=seg_name)
        seg_cfg = cfg
        if overlap and gossip.needs_replicas(seq):
            # varying membership inside the segment needs the replica
            # (time-varying) path, which the double-buffered transport
            # cannot ride: serialize THIS segment (executor and clock).
            seg_plans, seg_active_sets = _plan_segment(draws, spec, n,
                                                       stale_ok, False)
            seq = gossip.sequence_from_active_sets(topo, seg_active_sets,
                                                   name=seg_name)
            seg_cfg = dataclasses.replace(cfg, overlap=False)

        # ---- build the segment's executor ---------------------------------
        sim = meth.make_reference(seq, seg_cfg)
        state = sim.init(carried_x)
        if carried_d is not None and hasattr(state, "d"):
            state = state._replace(d=carried_d)
        if carried_e is not None and getattr(state, "e", None) is not None:
            state = state._replace(e=carried_e)
        if seg_start > 0:
            recompiles += 1
            queue.push(clock.now, "recompile",
                       n_up=int(fleet.up.sum()), rounds=len(seg_plans))

        # ---- execute the segment ------------------------------------------
        for plan in seg_plans:
            t = plan["t"]
            t0 = clock.now
            for i, (c, f) in sorted(plan["times"].items()):
                if plan["dead"][i]:
                    queue.push(t0 + min(f, plan["close"]), "drop", node=i)
                    dropout_rounds += 1
                elif plan["stragglers"][i]:
                    queue.push(t0 + plan["close"], "deadline-miss", node=i,
                               late_by=round(f - plan["close"], 9))
                    straggler_rounds += 1
                else:
                    queue.push(t0 + c, "compute-done", node=i)
                    queue.push(t0 + f, "send-done", node=i,
                               bits=edge_bits * int(plan["outdeg"][i]))
            round_close = t0 + plan["close"]
            clock.drain(queue, round_close)
            clock.advance_to(round_close)

            t_step = time.perf_counter()
            key = prng.fold_in(base_key, t)
            batch = _to_device(next(batches), dev)
            # frozen nodes (non-participants, dropouts, down members, and
            # excluded stragglers of absolute-state methods) do nothing:
            # their rows are reverted wholesale (keeps their pending d
            # too), so the pre-round state is held only when one exists.
            frozen = ~(plan["round_active"]
                       | (plan["stragglers"] & stale_ok))
            prev_state = state if frozen.any() else None
            withheld = None
            if plan["withhold"].any():
                state, withheld = method_mod.withhold_differential(
                    meth, state, send_mask=~plan["withhold"])
            # hand the state over: the step frees each old tree as soon as
            # its replacement exists (an LM-sized stack is 4 f32 trees)
            held = [state]
            del state
            state, loss = sim.step(held.pop(), grad_fn, batch, key)
            if withheld is not None:
                state = method_mod.defer_differential(meth, state, withheld)
            if prev_state is not None:
                state = method_mod.select_node_rows(~frozen, state,
                                                    prev_state)
            del prev_state, withheld

            losses.append(float(loss))
            step_s.append(time.perf_counter() - t_step)
            delivered = plan["round_active"] & ~plan["withhold"]
            edges = int(plan["outdeg"][delivered].sum()) if delivered.any() \
                else 0
            # charge only DELIVERED payloads (withheld/late bits never
            # complete; partial straggler airtime is wasted time, not comm)
            total_elems += edge_elems * edges
            total_bits += edge_bits * edges
            comm.append(total_elems)
            bits_l.append(total_bits)
            sim_times.append(clock.now)
            if accountant is not None:
                accountant.step()
                epss.append(accountant.epsilon)
            if eval_fn is not None and eval_every and \
                    (t + 1) % eval_every == 0:
                accs.append(float(eval_fn(sim.eval_params(state))))
            if target_loss is not None and time_to_target is None and \
                    losses[-1] <= target_loss:
                time_to_target = clock.now
                rounds_to_target = t + 1
            queue.push(round_close, "round-close", t=t,
                       active=int(plan["round_active"].sum()))
            clock.drain(queue, round_close)
            for node_i, kind in plan["churn"]:
                queue.push(clock.now, kind, node=node_i)
            clock.drain(queue, clock.now)
            t_global = t + 1

        carried_x = state.x
        carried_d = getattr(state, "d", None)
        carried_e = getattr(state, "e", None)

    result = TrainResult(losses=losses, comm_elements=comm,
                         comm_bits=bits_l, epsilons=epss,
                         eval_accuracy=accs, wall_s=time.time() - wall0,
                         sim_time_s=sim_times, step_s=step_s)
    return SimResult(result=result, trace=tuple(clock.trace),
                     final_params=state.x, rounds=t_global,
                     recompiles=recompiles,
                     straggler_rounds=straggler_rounds,
                     dropout_rounds=dropout_rounds,
                     sim_seconds=clock.now,
                     time_to_target=time_to_target,
                     rounds_to_target=rounds_to_target)
