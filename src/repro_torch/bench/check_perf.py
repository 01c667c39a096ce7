"""Wire-plane gate: BENCH_perf_torch.json against the port's baseline.

Port of ``benchmarks/check_perf.py``, with its gates, against the
baseline section of the bench's device (``baselines/perf_wire.json``
beside ``perf_wire``; the JAX package's ``benchmarks/baselines`` are its
own):

* ``permutes_per_step`` may NEVER grow: they are schedule-derived
  integers;
* ``launches``, ``aten_ops`` and on CUDA ``kernel_launches`` may grow at
  most ``LAUNCH_TOL`` (relative) + ``LAUNCH_SLACK``;
* ``wire_bits_sent`` may never grow at unchanged ``wire_bits_acc``;
* the fused quantizer ``qsgdf:4`` must stay STRICTLY below the baseline
  of its unfused counterpart ``qsgd:4`` on launches (and on CUDA on
  kernel launches) and on ``permutes_per_step``;
* every ``overlap=True`` record must report ``overlap_efficiency`` > 0.

Refresh: ``python -m repro_torch.bench.perf_wire --device <d>
--update-baseline``.

  PYTHONPATH=src python -m repro_torch.bench.check_perf [BENCH_perf_torch.json]
"""
from __future__ import annotations

import json
import sys

from repro_torch.bench.perf_wire import BASELINE, OUT_PATH

__all__ = ["check", "main", "LAUNCH_TOL", "LAUNCH_SLACK", "FUSED_BEATS"]

LAUNCH_TOL = 0.10          # +10%
LAUNCH_SLACK = 2           # plus two launches of absolute wobble

#: fused case -> unfused counterpart whose cost it must strictly beat
FUSED_BEATS = {
    "sdm-dsgd/ring/qsgdf:4": "sdm-dsgd/ring/qsgd:4",
}


def _launch_keys(dev: str):
    return ("launches", "aten_ops") + (("kernel_launches",)
                                       if dev == "cuda" else ())


def check(bench, baseline_path: str = BASELINE) -> list:
    """Failure messages (empty: the gate passes). ``bench`` is the
    record ``perf_wire.run`` returns, or the path of its JSON file."""
    if isinstance(bench, str):
        with open(bench) as f:
            bench = json.load(f)
    with open(baseline_path) as f:
        base_all = json.load(f)
    dev = bench.get("device")
    if dev not in base_all:
        return [f"no baseline for device {dev!r} in {baseline_path}"]
    base = {r["case"]: r for r in base_all[dev]["records"]}
    cur = {r["case"]: r for r in bench["records"]}

    failures = []
    for case, b in base.items():
        c = cur.get(case)
        if c is None:
            failures.append(f"{case}: present in baseline, missing from "
                            f"the bench")
            continue
        if c["permutes_per_step"] > b["permutes_per_step"]:
            failures.append(
                f"{case}: permutes_per_step {c['permutes_per_step']} > "
                f"baseline {b['permutes_per_step']}")
        for key in _launch_keys(dev):
            cap = int(b[key] * (1 + LAUNCH_TOL)) + LAUNCH_SLACK
            if c.get(key) is None or c[key] > cap:
                failures.append(f"{case}: {key} {c.get(key)} > cap {cap} "
                                f"(baseline {b[key]})")
        if c["wire_bits_sent"] > b["wire_bits_sent"] \
                and c["wire_bits_acc"] == b["wire_bits_acc"]:
            failures.append(
                f"{case}: wire_bits_sent {c['wire_bits_sent']} > baseline "
                f"{b['wire_bits_sent']} at unchanged accounting")

    for fused, unfused in FUSED_BEATS.items():
        f_rec, u_rec = cur.get(fused), base.get(unfused)
        if f_rec is None or u_rec is None:
            failures.append(f"fused-beats pair missing: {fused} / {unfused}")
            continue
        for key in ("permutes_per_step", "launches") + (
                ("kernel_launches",) if dev == "cuda" else ()):
            if f_rec[key] >= u_rec[key]:
                failures.append(f"{fused}: {key} {f_rec[key]} not below "
                                f"unfused {unfused} baseline {u_rec[key]}")

    for case, c in cur.items():
        if c.get("overlap") and not c.get("overlap_efficiency", 0) > 0:
            failures.append(f"{case}: overlap=True but overlap_efficiency="
                            f"{c.get('overlap_efficiency')}")
    return failures


def main(argv: list) -> int:
    bench_path = argv[1] if len(argv) > 1 else OUT_PATH
    failures = check(bench_path)
    if failures:
        for msg in failures:
            print(f"PERF-REGRESSION {msg}")
        return 1
    print(f"perf gate OK: {bench_path} within {BASELINE} thresholds")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
