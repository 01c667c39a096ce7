"""Benchmark aggregator: one function per paper table/figure.

Port of ``benchmarks/run.py``. Prints ``name,us_per_call,derived`` CSV
lines per the repo convention; each entry runs on ``--device`` (the card
by default) and asserts its script's claims, as the JAX aggregator does.
A failing entry is reported and the aggregator exits 1.

  PYTHONPATH=src python -m repro_torch.bench.run                 # everything
  PYTHONPATH=src python -m repro_torch.bench.run --only fig2,theory --device cpu

``perf`` and ``serve`` write their snapshots (``BENCH_perf_torch.json``,
``BENCH_serve_torch.json``, in the working directory); their gates run
apart, as in the JAX package (``bench.check_perf``, ``bench.check_serve``).
``roofline`` reads the dry-run's records (``experiments/dryrun_torch/``,
written by ``python -m repro_torch.launch.dryrun`` on the CPU) and prints
nothing but a note when there are none, as in JAX.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import traceback

__all__ = ["BENCHES", "NOT_PORTED", "main"]

BENCHES = {
    "theory": ("repro_torch.bench.theory_tradeoff",
               "Thm 4 m^4 scaling, Prop 5 1/p^2 gap, Lemma 1 terms"),
    "fig2": ("repro_torch.bench.fig2_divergence",
             "Fig 2: DC-DSGD divergence at p=0.2 vs SDM-DSGD"),
    "fig3": ("repro_torch.bench.fig3_comm_efficiency",
             "Fig 3: loss/accuracy vs communicated non-zero elements"),
    "table1": ("repro_torch.bench.table1_privacy_accuracy",
               "Table 1: accuracy under (eps, delta)-DP budgets"),
    "kernels": ("repro_torch.bench.kernel_bench",
                "CUDA kernel micro-benches against their plain versions"),
    "roofline": ("repro_torch.bench.roofline",
                 "three-term roofline from the dry-run records (H100 "
                 "datasheet peaks)"),
    "sim": ("repro_torch.bench.sim_edge",
            "edge-fleet simulation -> BENCH_sim_torch.json (simulated "
            "seconds-to-target, wire bits, epsilon per method x fault "
            "scenario)"),
    "perf": ("repro_torch.bench.perf_wire",
             "wire-plane perf snapshot -> BENCH_perf_torch.json "
             "(permutes/step, wire bits, sorts, ATen ops, kernel launches)"),
    "serve": ("repro_torch.bench.serve_bench",
              "serving snapshot -> BENCH_serve_torch.json (continuous vs "
              "static tok/s, decode steps, KV pages, decode-step launches)"),
}

# the JAX aggregator's entries that have no port yet, with what they need
NOT_PORTED: dict = {}


def main(argv=None) -> None:
    names_all = list(BENCHES) + list(NOT_PORTED)
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of: " + ",".join(names_all))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    names = names_all if args.only is None else args.only.split(",")
    unknown = [n for n in names if n not in names_all]
    if unknown:
        ap.error(f"unknown benchmark(s) {unknown}; choose from {names_all}")

    failures = []
    for name in names:
        if name in NOT_PORTED:
            print(f"# === {name}: not ported yet: {NOT_PORTED[name]}",
                  flush=True)
            failures.append(name)
            continue
        module_name, desc = BENCHES[name]
        print(f"# === {name}: {desc}", flush=True)
        try:
            importlib.import_module(module_name).run(device=args.device)
        except Exception:
            traceback.print_exc()
            failures.append(name)
    if failures:
        print(f"# FAILED: {failures}")
        sys.exit(1)
    print("# all benchmarks passed")


if __name__ == "__main__":
    main()
