"""Serving engine snapshot -> BENCH_serve_torch.json.

Port of ``benchmarks/serve_bench.py``, on the same workload: the
``phi3-medium-14b`` smoke config, ``MAX_BATCH`` 3, ``MAX_SEQ`` 64,
``PAGE_SIZE`` 8, 12 ragged requests (prompts of 2-16 tokens and the
high-variance ``BUDGETS``, drawn from ``default_rng(SEED)``), served by
both engines after a warm-up pass:

    tok_s               generated tokens / serve() wall-clock, the
                        median wall of ``RUNS`` timed serves (``runs``
                        holds each one's wall and tok/s)
    p50_ms / p95_ms     per-token decode latency percentiles
                        (step wall / tokens emitted that step)
    ttft_p50_ms / ttft_max_ms
                        submit -> first-token-available
    decode_steps        decode steps executed for the workload
                        (continuous retires and admits mid-flight, so it
                        needs fewer than the static drain-the-batch loop)
    pages_peak / pages_dense / page_frac
                        paged-KV footprint vs the dense
                        max_batch x max_seq reservation (continuous only)

The JAX script counts the launches of one compiled paged decode step
from its HLO, with the Pallas kernel (``decode_launches_flash``) and
with the XLA gather reference (``decode_launches_ref``). The port runs
eagerly and counts one warmed-up ``decode_step_paged`` call instead
(``bench.counting``):

    decode_aten_ops         ATen ops dispatched, on any device
    decode_kernel_launches  device kernels launched, CUDA only; the paged
                            kernel is one of them in every attention layer
                            (``paged_attention.launches`` rises by the
                            layer count, checked here)
    decode_kernel_records   the profiler's device kernel records of that
                            call, CUDA only, not gated (a process that has
                            traced much work before loses some)

On CUDA the record also counts the host's waits on the device:

    host_syncs          {engine: stream synchronizations of one serve},
                        counted by torch's sync debug mode (one warning
                        each: an item read, a copy to the host, a copy
                        from pageable host memory) in an untimed serve

The plain paged attention runs only on CPU tensors, so the reference
path has no kernel-launch counterpart; on the CPU the step's ATen ops
include the plain version's.

Wall-clock is the device's host: continuous against static. After one
warm-up serve each, the engines serve the workload ``RUNS`` (5) times,
interleaved static / continuous, and each record's tok/s comes from its
median wall (the latency percentiles and TTFTs from that median run):
the JAX script times a single serve each, and on the card one serve of
78 tokens read either way from run to run. The structural numbers
(decode steps, pages, launch counts) do not depend on the clock.
``baselines/serve.json`` holds, per device (``"cpu"``, ``"cuda"``), the
launch counts that ``check_serve`` gates against.

  PYTHONPATH=src python -m repro_torch.bench.serve_bench             # card
  PYTHONPATH=src python -m repro_torch.bench.serve_bench --device cpu
  PYTHONPATH=src python -m repro_torch.bench.check_serve

Baseline refresh (an intended change of structure): add
``--update-baseline`` to the first command, on each device, and commit
the diff.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.bench.counting import KernelLaunches, OpCount

__all__ = ["run", "ARCH", "MAX_BATCH", "MAX_SEQ", "PAGE_SIZE", "N_REQUESTS",
           "BUDGETS", "SEED", "RUNS", "OUT_PATH", "BASELINE",
           "BASELINE_KEYS"]

OUT_PATH = "BENCH_serve_torch.json"
BASELINE = os.path.join(os.path.dirname(__file__), "baselines", "serve.json")
# the launch counts the baseline pins, per device
BASELINE_KEYS = {"cpu": ("decode_aten_ops",),
                 "cuda": ("decode_aten_ops", "decode_kernel_launches")}

ARCH = "phi3-medium-14b"
MAX_BATCH = 3
MAX_SEQ = 64
PAGE_SIZE = 8
N_REQUESTS = 12
BUDGETS = [16, 1, 2, 12, 1, 3, 16, 2, 8, 1, 4, 12]   # high variance
SEED = 7
RUNS = 5           # timed serves per engine, interleaved; the median decides


def _requests(cfg):
    from repro_torch.serving import Request

    rng = np.random.default_rng(SEED)
    lens = rng.integers(2, 17, size=N_REQUESTS).tolist()
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=m)
            for n, m in zip(lens, BUDGETS)]


def _percentile(xs, q):
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(int(q * len(xs)), len(xs) - 1)
    return xs[i]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_serve(eng, cfg):
    """(wall seconds, outputs, stats) of one serve of the workload."""
    _sync(eng.device)
    t0 = time.monotonic()
    out = eng.serve(_requests(cfg))
    _sync(eng.device)
    return time.monotonic() - t0, out, eng.last_stats


def _host_syncs(eng, cfg) -> int:
    """Stream synchronizations of one serve on CUDA: torch's sync debug
    mode warns once at each."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.serve(_requests(cfg))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def _engine_records(engines, cfg):
    """One record per (case, engine): a warm-up serve each, then ``RUNS``
    timed serves, the engines interleaved within each round."""
    for _, eng in engines:
        eng.serve(_requests(cfg))               # warm-up
    timed = {case: [] for case, _ in engines}
    for _ in range(RUNS):
        for case, eng in engines:
            timed[case].append(_timed_serve(eng, cfg))
    return [_engine_record(case, timed[case]) for case, _ in engines]


def _engine_record(case, timed):
    """A record from the timed serves of one engine: tok/s from the
    median wall, the latencies of that median run."""
    order = sorted(range(len(timed)), key=lambda i: timed[i][0])
    wall, out, stats = timed[order[len(order) // 2]]
    per_tok = [w / max(t, 1) * 1e3
               for w, t in zip(stats.step_wall_s, stats.step_tokens)]
    tokens = sum(len(r.output) for r in out)
    rec = {
        "case": case,
        "tokens": tokens,
        "tok_s": round(tokens / wall, 1),
        "runs": [{"wall_s": round(w, 6), "tok_s": round(
            sum(len(r.output) for r in o) / w, 1)} for w, o, _ in timed],
        "p50_ms": round(_percentile(per_tok, 0.50), 3),
        "p95_ms": round(_percentile(per_tok, 0.95), 3),
        "ttft_p50_ms": round(_percentile(stats.ttft_s, 0.50) * 1e3, 3),
        "ttft_max_ms": round(max(stats.ttft_s) * 1e3, 3),
        "decode_steps": stats.decode_steps,
    }
    if stats.pages_dense_equiv:
        rec["pages_peak"] = stats.pages_peak
        rec["pages_dense"] = stats.pages_dense_equiv
        rec["page_frac"] = round(
            stats.pages_peak / stats.pages_dense_equiv, 3)
    if not all(len(r.output) > 0 for r in out):
        raise RuntimeError(f"{case}: a request returned no tokens")
    return rec


def _decode_counts(cfg, params, device) -> dict:
    """ATen ops (and on CUDA kernel launches) of ONE paged decode step
    over a fresh pool, after a warm-up call: the JAX script's step
    inputs (tokens 0, offsets 1, every row writing)."""
    from repro_torch.kernels.flash_attn.decode import paged_attention
    from repro_torch.models import transformer
    from repro_torch.serving import PagedKVCache

    kv = PagedKVCache(cfg, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                      page_size=PAGE_SIZE, device=device)
    tok = torch.zeros(MAX_BATCH, dtype=torch.int32, device=device)
    offsets = torch.ones(MAX_BATCH, dtype=torch.int32, device=device)
    emit = torch.ones(MAX_BATCH, dtype=torch.bool, device=device)

    def step():
        with torch.no_grad():
            return transformer.decode_step_paged(
                params, cfg, tok, kv.pages, kv.tables(), offsets, emit)

    step()
    n0 = paged_attention.launches
    with KernelLaunches(device) as kl, OpCount() as ops:
        step()
    out = {"decode_aten_ops": ops.total}
    if device.type == "cuda":
        n_attn = sum(s.mixer in ("attn", "attn_local")
                     for s in cfg.period) * cfg.n_periods
        paged = paged_attention.launches - n0
        if paged != n_attn:
            raise RuntimeError(f"the decode step launched the paged kernel "
                               f"{paged} times, expected {n_attn}")
        out["decode_kernel_launches"] = kl.n
        out["decode_kernel_records"] = kl.records
        out["decode_paged_kernel_launches"] = paged
    return out


def run(device="cuda", *, params=None, out_path: str = OUT_PATH,
        update_baseline: bool = False) -> dict:
    """Serve the workload with both engines on ``device`` (the card
    unless the caller passes "cpu"; raises without one), count one
    decode step, write ``out_path`` and print the CSV lines. ``params``
    defaults to the port's seeded ``init_params`` (seed 0, f32)."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serving import ServingEngine, StaticServingEngine

    device = resolve_device(device)
    cfg = configs.get_smoke_config(ARCH)
    if params is None:
        params = transformer.init_params(cfg, seed=0, device=device)

    engines = [
        ("static", StaticServingEngine(
            cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
            device=device)),
        ("continuous", ServingEngine(
            cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
            page_size=PAGE_SIZE, device=device)),
    ]
    records = _engine_records(engines, cfg)
    counts = _decode_counts(cfg, params, device)
    if device.type == "cuda":
        counts["host_syncs"] = {case: _host_syncs(eng, cfg)
                                for case, eng in engines}
    out = {
        "device": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "workload": {"arch": ARCH, "max_batch": MAX_BATCH,
                     "max_seq": MAX_SEQ, "page_size": PAGE_SIZE,
                     "n_requests": N_REQUESTS, "budgets": BUDGETS,
                     "seed": SEED},
        "records": records,
        **counts,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    for r in records:
        print(f"serve/{r['case']},{1e6 / max(r['tok_s'], 1e-9):.1f},"
              f"tok_s={r['tok_s']} p95_ms={r['p95_ms']} "
              f"steps={r['decode_steps']}")
    print("serve/launches,0," + " ".join(f"{k}={v}"
                                         for k, v in counts.items()))
    print(f"# wrote {out_path}")
    if update_baseline:
        from repro_torch.bench.common import store_baseline

        store_baseline(BASELINE, device.type,
                       {k: out[k] for k in BASELINE_KEYS[device.type]})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT_PATH)
    ap.add_argument("--update-baseline", action="store_true",
                    help=f"write this device's counts into {BASELINE}")
    args = ap.parse_args(argv)
    run(device=args.device, out_path=args.out,
        update_baseline=args.update_baseline)


if __name__ == "__main__":
    main()
