"""Figure 3: training loss / test accuracy vs COMMUNICATED NON-ZERO
ELEMENTS for DSGD (p=1), DC-DSGD (p=0.5, theta=1) and SDM-DSGD
(p=0.2, theta<bound) — the paper's communication-efficiency headline:
under equal communication budget SDM-DSGD reaches lower loss / higher
accuracy. ``--methods`` extends the sweep with any registry method
(e.g. gradient-push, evaluated on its directed graph).

Port of ``benchmarks/fig3_comm_efficiency.py`` on the port's
``run_decentralized``, the 50-node MLR test bed on ``device``.

  PYTHONPATH=src python -m repro_torch.bench.fig3_comm_efficiency --device cpu
"""
from __future__ import annotations

from repro_torch import tree as tree_mod
from repro_torch.bench import common
from repro_torch.core import baselines, method as method_mod, sdm_dsgd, theory
from repro_torch.train.trainer import run_decentralized

__all__ = ["PAPER_RUNS", "run"]

# the paper's three curves; extra registry methods attach via --methods
PAPER_RUNS = ("dsgd", "dc-dsgd", "sdm-dsgd")


def _cfg_for(meth_name: str, topo, gamma: float):
    if meth_name == "dsgd":
        return sdm_dsgd.SDMConfig(p=1.0, theta=1.0, gamma=gamma)
    if meth_name == "dc-dsgd":
        return baselines.dcdsgd_config(p=0.5, gamma=gamma)
    if meth_name == "sdm-dsgd":
        lambda_n = topo.lambda_n if hasattr(topo, "lambda_n") else 1.0 / 3.0
        return sdm_dsgd.SDMConfig(
            p=0.2, theta=min(0.55, 0.9 * theory.theta_upper_bound(
                0.2, lambda_n, gamma, 1.0)), gamma=gamma)
    return sdm_dsgd.SDMConfig(p=1.0, theta=1.0, gamma=gamma)


def run(comm_budget_elems: int = 60_000_000, gamma: float = 0.05,
        topology: str = "er:0.35", methods=PAPER_RUNS, device="cuda",
        check: bool = True) -> common.PaperRun:
    """``data`` maps each method to (comm_elements, comm_bits, losses,
    eval_accuracy), as the JAX script returns; ``details`` to its step
    count, wire bits per step (all nodes) and per-step wall times.
    Claims (when dsgd and sdm-dsgd both run): at the same element budget
    SDM-DSGD's final loss is within 2 % of DSGD's or lower, and its
    accuracy within 0.01 or higher."""
    topo, params, grad_fn, eval_fn, batches, m = common.make_mlr_testbed(
        topology_spec=topology, device=device)
    per_node = tree_mod.tree_map(lambda x: x[0], params)
    curves = {}
    finals = {}
    details = {}
    for name in methods:
        meth = method_mod.get(name)
        raw = _cfg_for(meth.name, topo, gamma)
        cfg = meth.coerce_config(raw)
        per_step = method_mod.transmitted_elements(
            meth, per_node, cfg, seq=topo) * topo.n_nodes
        per_step_bits = method_mod.transmitted_bits(
            meth, per_node, cfg, seq=topo) * topo.n_nodes
        steps = max(10, comm_budget_elems // per_step)
        res = run_decentralized(topo=topo, algorithm=meth.name, sdm_cfg=cfg,
                                params_stack=params, grad_fn=grad_fn,
                                batches=batches, steps=steps,
                                eval_fn=eval_fn, eval_every=max(steps // 4, 1),
                                device=device)
        key = meth.name.replace("-", "_")
        curves[key] = (res.comm_elements, res.comm_bits, res.losses,
                       res.eval_accuracy)
        finals[key] = (res.losses[-1], res.eval_accuracy[-1],
                       res.comm_bits[-1], per_step_bits)
        details[key] = dict(steps=steps, per_step_bits=per_step_bits,
                            step_s=res.step_s)

    # At the SAME communication budget, sparser methods take more steps and
    # end lower (the paper's Fig. 3 ordering). Wire BITS per step are the
    # honest axis (index side-channels, quantized widths) next to the
    # paper's non-zero-element count.
    derived = f"topo={topo.name};" + ";".join(
        f"{k}:loss={v[0]:.4f},acc={v[1]:.4f},"
        f"bits={v[2]:.3e},bits/step={v[3]:.3e}"
        for k, v in finals.items())
    common.emit("fig3_comm_efficiency", 0.0, derived)
    claims = {}
    if "sdm_dsgd" in finals and "dsgd" in finals:
        claims["sdm_loss_within_2pct_of_dsgd"] = \
            finals["sdm_dsgd"][0] <= finals["dsgd"][0] * 1.02
        claims["sdm_acc_within_0.01_of_dsgd"] = \
            finals["sdm_dsgd"][1] >= finals["dsgd"][1] - 0.01
    return common.settle(common.PaperRun(data=curves, derived=derived,
                                         claims=claims, details=details),
                         check)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--topology", default="er:0.35",
                    help="gossip graph spec (gossip.sequence_by_name syntax, "
                         "incl. dring/der/matchings:<L>)")
    ap.add_argument("--methods", default=",".join(PAPER_RUNS),
                    help="comma list of method registry names to sweep")
    ap.add_argument("--comm-budget", type=int, default=60_000_000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    run(comm_budget_elems=args.comm_budget, topology=args.topology,
        methods=tuple(args.methods.split(",")), device=args.device)
