"""Edge-fleet simulation benchmark -> BENCH_sim_torch.json.

Port of ``benchmarks/sim_edge.py``: runs every (method, scenario) case of
the event-driven fleet simulator (``repro_torch.sim``) on a small MLR
test bed on ``device`` and records the quantities the paper's
edge-deployment story turns on:

    sim_seconds          simulated wall-clock for the whole run (compute
                         + bandwidth-limited transmission per round)
    time_to_target       simulated seconds until the loss first reaches
                         the no-fault-derived target (None = never)
    wire_bits            cumulative delivered payload bits
    epsilon              final (eps, delta)-DP spend under participation
                         amplification (q < 1 folds into the accountant)
    loss_gap_vs_no_fault graceful-degradation check: how much worse the
                         faulty scenario's final loss is than the same
                         method's no-fault run

Scenarios are the named presets (no-fault | straggler | dropout | churn);
methods compare the paper's SDM-DSGD against the dense DSGD baseline on
the same fleet with the same faults. ``wall_s`` is the host's wall time
of the run (the card's when run there).

  PYTHONPATH=src python -m repro_torch.bench.sim_edge --device cpu
  PYTHONPATH=src python -m repro_torch.bench.run --only sim --device cpu
"""
from __future__ import annotations

import json

import torch

from repro_torch import prng, tree as tree_mod
from repro_torch._device import resolve_device
from repro_torch.bench.common import emit
from repro_torch.core import PrivacyParams, SDMConfig, topology
from repro_torch.data import classification_dataset, node_partitioned_batches
from repro_torch.models import vision_small
from repro_torch.sim import SCENARIOS, simulate

__all__ = ["OUT_PATH", "N_NODES", "ROUNDS", "METHODS", "run"]

OUT_PATH = "BENCH_sim_torch.json"

N_NODES = 8
ROUNDS = 60
BATCH_PER_NODE = 16
M_LOCAL = 2000 // N_NODES

_SDM_PRIVACY = PrivacyParams(G=5.0, m=M_LOCAL, tau=BATCH_PER_NODE / M_LOCAL,
                             p=0.4, sigma=1.0)

METHODS = {
    # label -> (algorithm, cfg, privacy): dsgd releases every coordinate
    # (p=1), SDM only p. sdm-dsgd+ov is the SAME wire format under the
    # overlapped transport: one-step-stale mixing, so each node's round
    # time is max(compute, transmit) instead of their sum.
    "sdm-dsgd": ("sdm-dsgd",
                 SDMConfig(p=0.4, theta=0.3, gamma=0.1, sigma=1.0,
                           clip_c=5.0),
                 _SDM_PRIVACY),
    "sdm-dsgd+ov": ("sdm-dsgd",
                    SDMConfig(p=0.4, theta=0.3, gamma=0.1, sigma=1.0,
                              clip_c=5.0, overlap=True),
                    _SDM_PRIVACY),
    "dsgd": ("dsgd",
             SDMConfig(p=1.0, theta=1.0, gamma=0.1, sigma=1.0, clip_c=5.0),
             PrivacyParams(G=5.0, m=M_LOCAL, tau=BATCH_PER_NODE / M_LOCAL,
                           p=1.0, sigma=1.0)),
}


def _testbed(dev: torch.device, seed=0):
    (x_tr, y_tr), _ = classification_dataset(64, 10, 2000, 200, seed=seed)
    params0 = vision_small.mlr_init(prng.PRNGKey(seed, device=dev), 64, 10)
    stack = tree_mod.tree_map(
        lambda p: p[None].expand((N_NODES,) + tuple(p.shape)).clone(),
        params0)
    grad_fn = vision_small.make_stacked_grad_fn(vision_small.mlr_apply)
    batches = node_partitioned_batches(x_tr, y_tr, N_NODES, BATCH_PER_NODE,
                                       seed=seed)
    return stack, grad_fn, batches


def _one(method: str, scenario: str, dev: torch.device, target_loss=None):
    algorithm, cfg, pp = METHODS[method]
    stack, grad_fn, batches = _testbed(dev)
    return simulate(topo=topology.ring(N_NODES), algorithm=algorithm,
                    sdm_cfg=cfg, params_stack=stack, grad_fn=grad_fn,
                    batches=batches, rounds=ROUNDS, scenario=scenario,
                    seed=0, privacy=pp, eps_target=1.0,
                    target_loss=target_loss, device=dev)


def run(out_path: str = OUT_PATH, device="cuda") -> dict:
    """Every (method, scenario) case; writes the report to ``out_path``
    and returns it."""
    dev = resolve_device(device)
    cases = []
    for method in METHODS:
        # the no-fault run defines the method's target loss: 80% of the
        # way from the initial to the final no-fault loss
        base = _one(method, "no-fault", dev)
        bl = base.result.losses
        target = bl[0] - 0.8 * (bl[0] - bl[-1])
        base = _one(method, "no-fault", dev, target_loss=target)
        by_scenario = {"no-fault": base}
        for scenario in sorted(SCENARIOS):
            if scenario != "no-fault":
                by_scenario[scenario] = _one(method, scenario, dev,
                                             target_loss=target)
        for scenario, res in by_scenario.items():
            r = res.result
            rec = {
                "method": method,
                "scenario": scenario,
                "rounds": res.rounds,
                "sim_seconds": round(res.sim_seconds, 6),
                "target_loss": round(target, 6),
                "time_to_target": (None if res.time_to_target is None
                                   else round(res.time_to_target, 6)),
                "rounds_to_target": res.rounds_to_target,
                "wire_bits": r.comm_bits[-1],
                "epsilon": (r.epsilons[-1] if r.epsilons else None),
                "final_loss": round(r.losses[-1], 6),
                "loss_gap_vs_no_fault": round(
                    r.losses[-1] - base.result.losses[-1], 6),
                "straggler_rounds": res.straggler_rounds,
                "dropout_rounds": res.dropout_rounds,
                "recompiles": res.recompiles,
                "wall_s": round(r.wall_s, 3),
            }
            cases.append(rec)
            tt = rec["time_to_target"]
            emit(f"sim_edge/{method}/{scenario}",
                 r.wall_s / max(res.rounds, 1) * 1e6,
                 f"t_sim={rec['sim_seconds']}s "
                 f"t_target={'never' if tt is None else f'{tt}s'} "
                 f"bits={rec['wire_bits']} eps={rec['epsilon']} "
                 f"gap={rec['loss_gap_vs_no_fault']}")

    report = {"n_nodes": N_NODES, "rounds": ROUNDS, "cases": cases}
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"# wrote {out_path} ({len(cases)} cases)")
    return report


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT_PATH)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    run(out_path=args.out, device=args.device)
