"""``python -m repro_torch.analysis``: sweep the audit matrix, write
``LINT_report_torch.json``, exit nonzero on any NEW violation.

Port of ``python -m repro.analysis``, with the same flags except
``--devices`` (JAX's count of faked host devices), which becomes
``--device``: where the 4-node stack runs, the card unless ``cpu`` is
passed (without a card it raises, as the port's other entry points do).
Findings listed in the suppression baseline (``baseline.json`` next to
this module, or ``--baseline``) are reported but do not fail the run;
the baseline is kept empty.

  PYTHONPATH=src python -m repro_torch.analysis --device cpu
  PYTHONPATH=src python -m repro_torch.analysis --quick      # on the card
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

#: report keys holding per-pass finding lists, in PASSES order
FINDING_KEYS = ("taint", "prng", "wire", "sensitivity", "calibration",
                "range", "overlap")


def _fingerprint(config_id: str, finding: dict) -> str:
    kind = finding.get("kind", "?")
    detail = finding.get("key") or finding.get("primitive") \
        or finding.get("label") or finding.get("site") or ""
    return f"{config_id}|{kind}|{detail}"


def _row_findings(row: dict):
    for key in FINDING_KEYS:
        yield from row.get(key, [])


def _parse_shard(spec: str):
    i, _, n = spec.partition("/")
    i, n = int(i), int(n)
    if not (n >= 1 and 1 <= i <= n):
        raise SystemExit(f"--shard wants i/N with 1 <= i <= N, got {spec!r}")
    return i, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="graph taint / PRNG / wire auditor + privacy certifier")
    ap.add_argument("--out", default="LINT_report_torch.json",
                    help="report path ('' to skip writing)")
    ap.add_argument("--baseline", default=None,
                    help="suppression baseline json (default: bundled)")
    ap.add_argument("--filter", "--only", dest="filter", default="",
                    help="only configs whose id contains this substring")
    ap.add_argument("--pass", dest="passes", action="append", default=None,
                    metavar="NAME",
                    help="run only this audit pass (repeatable); default all")
    ap.add_argument("--shard", default=None, metavar="i/N",
                    help="run the i-th of N strided matrix shards (1-based)")
    ap.add_argument("--quick", action="store_true",
                    help="smoke subset of the matrix")
    ap.add_argument("--device", default="cuda",
                    help="where the 4-node stack runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.analysis import wire_audit

    device = resolve_device(args.device)
    base_path = pathlib.Path(args.baseline) if args.baseline else \
        pathlib.Path(__file__).parent / "baseline.json"
    suppressions = set()
    if base_path.exists():
        suppressions = set(json.loads(base_path.read_text())
                           .get("suppressions", []))

    passes = tuple(args.passes) if args.passes else wire_audit.PASSES
    unknown = set(passes) - set(wire_audit.PASSES)
    if unknown:
        raise SystemExit(f"unknown --pass {sorted(unknown)}; "
                         f"choose from {list(wire_audit.PASSES)}")

    configs = [ac for ac in wire_audit.MATRIX if args.filter in ac.id]
    if args.quick:
        configs = [ac for ac in configs if ac.id in wire_audit.QUICK_IDS]
    if args.shard:
        i, n = _parse_shard(args.shard)
        configs = configs[i - 1::n]

    rows, new_violations = [], []
    for ac in configs:
        t0 = time.perf_counter()
        try:
            row = wire_audit.audit_config(ac, passes=passes, device=device)
        except Exception as e:                          # audit must not crash
            row = {"id": ac.id, "status": "error", "error": repr(e),
                   **{k: [] for k in FINDING_KEYS}}
            new_violations.append(f"{ac.id}|audit-error|{e!r}")
        row["seconds"] = time.perf_counter() - t0
        for finding in _row_findings(row):
            fp = _fingerprint(row["id"], finding)
            if fp in suppressions:
                finding["suppressed"] = True
            else:
                new_violations.append(fp)
        rows.append(row)
        n_bad = sum(1 for f in _row_findings(row)
                    if not f.get("suppressed"))
        print(f"AUDIT {row['id']:55s} {row['status']:5s}"
              f" findings={n_bad}", flush=True)

    report = {
        "torch": torch.__version__,
        "device": device.type,
        "n_configs": len(rows),
        "passes": list(passes),
        "shard": args.shard,
        "suppression_baseline": sorted(suppressions),
        "new_violations": new_violations,
        "configs": rows,
        "summary": {
            "pass": sum(r["status"] == "pass" for r in rows),
            "fail": sum(r["status"] == "fail" for r in rows),
            "error": sum(r["status"] == "error" for r in rows),
        },
    }
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(report, indent=2))
        print(f"wrote {args.out}")
    print(f"SUMMARY pass={report['summary']['pass']} "
          f"fail={report['summary']['fail']} "
          f"error={report['summary']['error']} "
          f"new_violations={len(new_violations)}")
    return 1 if new_violations else 0


if __name__ == "__main__":
    sys.exit(main())
