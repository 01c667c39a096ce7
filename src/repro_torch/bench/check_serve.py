"""Serving gate: BENCH_serve_torch.json against the port's baseline.

Port of ``benchmarks/check_serve.py``, with its conditions. It fails
when the continuous-batching engine loses its reason to exist:

* ``continuous.tok_s`` must be >= ``static.tok_s`` on the ragged-arrival
  workload;
* ``continuous.decode_steps`` must stay STRICTLY below static's (the
  deterministic form of the same win);
* ``pages_peak`` must stay below the dense ``max_batch x max_seq``
  reservation;
* the launch counts of one paged decode step (``decode_aten_ops``, and
  on CUDA ``decode_kernel_launches``) may grow at most ``LAUNCH_TOL`` +
  ``LAUNCH_SLACK`` over the baseline of the bench's device.

The baseline is ``baselines/serve.json`` beside ``serve_bench``, one
section per device; the JAX package's ``benchmarks/baselines`` are its
own. Refresh: ``python -m repro_torch.bench.serve_bench --device <d>
--update-baseline``.

  PYTHONPATH=src python -m repro_torch.bench.check_serve [BENCH_serve_torch.json]
"""
from __future__ import annotations

import json
import sys

from repro_torch.bench.serve_bench import BASELINE, BASELINE_KEYS, OUT_PATH

__all__ = ["check", "main", "LAUNCH_TOL", "LAUNCH_SLACK"]

LAUNCH_TOL = 0.10          # +10%
LAUNCH_SLACK = 2           # plus two launches of absolute wobble


def check(bench, baseline_path: str = BASELINE) -> list:
    """Failure messages (empty: the gate passes). ``bench`` is the
    record ``serve_bench.run`` returns, or the path of its JSON file."""
    if isinstance(bench, str):
        with open(bench) as f:
            bench = json.load(f)
    with open(baseline_path) as f:
        base_all = json.load(f)
    dev = bench.get("device")
    if dev not in base_all:
        return [f"no baseline for device {dev!r} in {baseline_path}"]
    base = base_all[dev]
    cur = {r["case"]: r for r in bench["records"]}

    failures = []
    st, co = cur.get("static"), cur.get("continuous")
    if st is None or co is None:
        return ["missing static/continuous records"]

    if co["tok_s"] < st["tok_s"]:
        failures.append(
            f"continuous tok_s {co['tok_s']} < static {st['tok_s']} on "
            f"ragged arrivals: continuous batching must not lose")
    if co["decode_steps"] >= st["decode_steps"]:
        failures.append(
            f"continuous decode_steps {co['decode_steps']} not below "
            f"static {st['decode_steps']}: slot recycling regressed")
    if co.get("pages_peak", 0) >= co.get("pages_dense", 1):
        failures.append(
            f"pages_peak {co.get('pages_peak')} not below dense "
            f"reservation {co.get('pages_dense')}")

    for key in BASELINE_KEYS[dev]:
        cap = int(base[key] * (1 + LAUNCH_TOL)) + LAUNCH_SLACK
        got = bench.get(key)
        if got is None or got > cap:
            failures.append(f"{key} {got} > cap {cap} (baseline "
                            f"{base[key]}, {dev})")
    return failures


def main(argv: list) -> int:
    bench_path = argv[1] if len(argv) > 1 else OUT_PATH
    failures = check(bench_path)
    if failures:
        for msg in failures:
            print(f"SERVE-REGRESSION {msg}")
        return 1
    print(f"serve gate OK: {bench_path} within {BASELINE} thresholds")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
