"""Roofline analysis from the dry-run records.

Port of ``benchmarks/roofline.py``. Per (arch x shape x mesh) this
derives the three roofline terms from the records that
``repro_torch.launch.dryrun`` writes (``experiments/dryrun_torch/``):

    compute    = flops            / 989e12 FLOP/s  (dense bf16 per card)
    memory     = bytes_accessed   / 3.35e12 B/s    (HBM3 per card)
    collective = collective_bytes / 450e9 B/s      (NVLink 4, one
                                                    direction per GPU)

These are the H100 SXM's datasheet peaks, not measurements. The records'
values are per device (one card a node; see the dry-run's docstring), so
each term is one card's time. MODEL_FLOPS = 6*N*D (training) or 2*N*D
(serving) uses the active parameters for MoE. ``useful_flop_ratio`` is
MODEL_FLOPS over the traced flops of all cards (the JAX record's
``hlo_flops_total`` key, kept so that both packages' rows read alike).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

from repro_torch.kernels import cost

PEAK_FLOPS = cost.BF16_FLOPS    # 989e12: dense bf16 per card
HBM_BW = cost.HBM_BYTES_PER_S   # 3.35e12 B/s per card
LINK_BW = 450e9                 # B/s: NVLink 4, one direction per GPU

DEFAULT_ROOT = "experiments/dryrun_torch"

__all__ = ["analyze_record", "load_records", "summarize", "run",
           "PEAK_FLOPS", "HBM_BW", "LINK_BW"]


def _loop_corrected(rec: dict, key: str) -> float:
    """A JAX record's full-depth value from its unrolled probes,
    probe1 + (n_periods - 1) * (probe2 - probe1) (XLA counts a while-loop
    body once). The port's records unroll every period and carry no
    probes: their raw value is returned."""
    p1, p2 = rec.get("probe1"), rec.get("probe2")
    if not p1 or not p2:
        return _raw_from(rec, key)
    n = rec.get("n_periods", 1)
    v1, v2 = _raw_from(p1, key), _raw_from(p2, key)
    return v1 + (n - 1) * (v2 - v1)


def _raw_from(d: dict, key: str) -> float:
    if key == "collective":
        return float(d["collective_bytes"].get("total", 0))
    return float(d[key])


def analyze_record(rec: dict) -> Optional[dict]:
    if rec.get("status") != "ok":
        return None
    chips = rec["n_devices"]
    flops_dev = _loop_corrected(rec, "flops")
    bytes_dev = _loop_corrected(rec, "bytes_accessed")
    coll_dev = _loop_corrected(rec, "collective")

    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_dev / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    if rec.get("algorithm") != "serve":
        model_flops = 6 * rec["model_params_active"] * rec["tokens_per_step"]
    else:
        # serving: 2*N*D per generated/prefilled token (forward only)
        model_flops = 2 * rec["model_params_active"] * rec["tokens_per_step"]
    hlo_total = flops_dev * chips
    useful = model_flops / hlo_total if hlo_total > 0 else float("nan")

    bound_time = max(terms.values())
    return dict(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        algorithm=rec.get("algorithm"), chips=chips,
        **{k: round(v, 6) for k, v in terms.items()},
        dominant=dominant.replace("_s", ""),
        model_flops=model_flops, hlo_flops_total=hlo_total,
        useful_flop_ratio=round(useful, 4),
        roofline_step_s=round(bound_time, 6),
        peak_memory_per_dev=rec["memory"].get("peak_memory_in_bytes"),
    )


def load_records(root: str = DEFAULT_ROOT) -> List[dict]:
    out = []
    for mesh_name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        mdir = os.path.join(root, mesh_name)
        for arch in sorted(os.listdir(mdir)):
            adir = os.path.join(mdir, arch)
            for f in sorted(os.listdir(adir)):
                with open(os.path.join(adir, f)) as fh:
                    out.append(json.load(fh))
    return out


def summarize(root: str = DEFAULT_ROOT) -> List[dict]:
    rows = []
    for rec in load_records(root):
        row = analyze_record(rec)
        if row is not None:
            rows.append(row)
    return rows


def run(root: str = DEFAULT_ROOT, device=None):
    """Print the roofline table of the records under ``root``.
    ``device`` is the aggregator's flag: the analysis reads files and
    runs nowhere else."""
    rows = summarize(root)
    if not rows:
        print("roofline: no dry-run records found (run "
              "repro_torch.launch.dryrun)")
        return []
    hdr = ("arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
           "dominant", "useful_flop_ratio")
    print(",".join(hdr))
    for r in rows:
        print(",".join(str(r[h]) for h in hdr))
    # run.py CSV convention
    for r in rows:
        print(f"roofline/{r['arch']}/{r['shape']}/{r['mesh']},"
              f"{r['roofline_step_s'] * 1e6:.1f},"
              f"dominant={r['dominant']};useful={r['useful_flop_ratio']}")
    return rows


if __name__ == "__main__":
    run()
