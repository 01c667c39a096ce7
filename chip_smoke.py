#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card and build: the card's name and power limit; nvcc builds every
     kernel of the path from ``src/repro_torch/kernels/csrc`` (sm_90a);
     TF32 is switched off for f32 matmuls and convolutions.
  2. each kernel against its plain PyTorch version, on the card, at
     gemma2-2b's decode shapes, in f32 and bf16; then its time, the
     plain version's time and its bound at the serving path's shapes.
  3. the main path: ``ServingEngine`` serves 16 ragged requests through
     gemma2-2b at full width and depth (bf16, seeded random weights).
     Every kernel must have launched in this run: the paged decode
     kernel exactly ``decode_steps x 26`` times.
  4. end to end against plain: one decode step's logits through the
     paged path (kernel) and through the dense ``decode_step`` path
     (plain attention), f32, full width and depth.

Prints a line per check and measurement, then a ``{"kernels": [...]}``
line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores

# f32: the JAX package's own flash-vs-oracle tolerance
# (tests/test_serving_engine.py:218). bf16: kernel and plain version both
# compute in f32 from the same bf16 inputs and round only the output, so
# they differ by at most one bf16 ulp of |out| < 4, i.e. 2^-6 = 1.6e-2.
KERNEL_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
# f32 logits (capped at +-30) of 26 layers: the paged kernel and the
# plain dense attention sum in different orders (~1e-6 relative per
# layer), amplified through the depth; 1e-2 is 3e-4 of the cap.
LOGIT_ATOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3):
    """(device ms, host ms) per fn(i) call, means over ``iters`` calls.

    Device time comes from CUDA events around the calls, with the card
    kept busy (``torch.cuda._sleep``, twice the measured enqueue time)
    while the host enqueues them: the calls then run back to back and
    the events time the device, not the Python that launches them. Host
    time is the enqueue time of the same calls, synchronised."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(host_s * 2 * 2e9) + 1_000_000)  # SM clock <= 2 GHz
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3 / iters


def paged_inputs(torch, gen, *, seq_lens, n_blocks, kvh, group, dh, page,
                 dtype, pools=1):
    """q, ``pools`` (k, v) page-pool pairs, a random-permutation block
    table and seq_lens, all on the card."""
    b = len(seq_lens)
    n_pages = b * n_blocks
    dev = "cuda"
    q = torch.randn(b, kvh * group, dh, generator=gen, device=dev).to(dtype)
    kv = [(torch.randn(n_pages + 1, page, kvh, dh, generator=gen,
                       device=dev).to(dtype),
           torch.randn(n_pages + 1, page, kvh, dh, generator=gen,
                       device=dev).to(dtype)) for _ in range(pools)]
    perm = torch.randperm(n_pages, generator=gen, device=dev) + 1
    tbl = perm.reshape(b, n_blocks).to(torch.int32)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return q, kv, tbl, lens


def decode_bound(seq_lens, *, window, kvh, group, dh, page, n_blocks,
                 elt_bytes):
    """Least time of one paged decode call: the bytes it must move (the
    visible pages of K and V, q, out, table, lengths) over HBM bandwidth,
    against its flops over the peak for the input type."""
    h = kvh * group
    nbytes = 0
    flops = 0
    for n in seq_lens:
        n = min(n, n_blocks * page)
        vis = min(n, window) if window else n
        first = (n - vis) // page
        pages = -(-n // page) - first if vis else 0
        nbytes += pages * page * kvh * dh * 2 * elt_bytes
        flops += 4 * vis * h * dh
    b = len(seq_lens)
    nbytes += 2 * b * h * dh * elt_bytes + b * n_blocks * 4 + b * 4
    peak = BF16_FLOPS if elt_bytes == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn.decode import (paged_attention,
                                                       paged_attention_ref)
    from repro_torch.models import transformer
    from repro_torch.serving import PagedKVCache, Request, ServingEngine

    # every kernel of the path: (record, wrapper with a .launches count)
    kernels = {
        "paged_decode": (dict(
            name="paged_decode", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_decode.cu",
            replaces="src/repro/kernels/flash_attn/decode.py:83"),
            paged_attention),
    }

    # ---- 1. card and build ----------------------------------------------
    card = smi()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.monotonic()
    libs = _build.build_all()
    build_s = time.monotonic() - t0
    log(f"built {sorted(libs)} in {build_s:.1f} s with {_build.nvcc_path()}")
    for lib in libs.values():
        ptxas = lib.with_suffix(".log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             ptxas)]
        log(f"  {lib.name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{sum(s > 0 for s in spills)} spill")

    # ---- 2. kernels against their plain versions -------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = dict(kvh=4, group=2, dh=256, page=16)        # gemma2-2b decode
    # ragged lengths: empty, one token, a page boundary and one past it,
    # the window (4096) and past it, a long row, a short row
    lens = [0, 1, 16, 17, 4096, 4097, 5000, 300]
    n_blocks = -(-max(lens) // shape["page"])
    errs = []
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        q, kv, tbl, sl = paged_inputs(torch, gen, seq_lens=lens,
                                      n_blocks=n_blocks, dtype=dtype, **shape)
        (kp, vp), = kv
        for window in (None, 4096):
            got = paged_attention(q, kp, vp, tbl, sl, window=window,
                                  softcap=50.0)
            torch.cuda.synchronize()
            want = paged_attention_ref(q, kp, vp, tbl, sl, window=window,
                                       softcap=50.0)
            err = (got.float() - want.float()).abs().max().item()
            zero = not got[sl == 0].any().item()
            errs.append(err)
            log(f"paged_decode {dt_name} window={window} softcap=50: "
                f"max|kernel-plain|={err:.3e} (atol {KERNEL_ATOL[dt_name]}) "
                f"empty-row zeros={zero}")
            if not (err <= KERNEL_ATOL[dt_name] and zero):
                raise AssertionError("paged_decode disagrees with its plain "
                                     "version")

    # time at the serving path's shapes: 8 rows, bf16, the engine's
    # dense-equivalent pool (max_seq 1056 / page 16 = 66 blocks), lengths
    # drawn like phase 3's prompts; 8 distinct layer pools (278 MB) in
    # turn so that, as in the real 26-layer step, K/V come from HBM
    rng = np.random.default_rng(0)
    serve_lens = (rng.integers(64, 1025, 8) + 16).tolist()
    sb = 66
    q, kv, tbl, sl = paged_inputs(torch, gen, seq_lens=serve_lens,
                                  n_blocks=sb, dtype=torch.bfloat16,
                                  pools=8, **shape)
    ker_ms, ker_host_ms = cuda_ms(torch, lambda i: paged_attention(
        q, *kv[i % 8], tbl, sl, window=None, softcap=50.0), iters=208)
    plain_ms, _ = cuda_ms(torch, lambda i: paged_attention_ref(
        q, *kv[i % 8], tbl, sl, window=None, softcap=50.0), iters=16)
    got = paged_attention(q, *kv[0], tbl, sl, window=None, softcap=50.0)
    want = paged_attention_ref(q, *kv[0], tbl, sl, window=None, softcap=50.0)
    serve_err = (got.float() - want.float()).abs().max().item()
    if serve_err > KERNEL_ATOL["bfloat16"]:
        raise AssertionError(f"paged_decode disagrees with its plain version "
                             f"at the serving shape: {serve_err}")
    # yardstick only (the port never calls it): SDPA over K/V already
    # gathered to contiguous, GQA-expanded, masked, WITHOUT softcap
    kp, vp = kv[0]
    kg = kp[tbl.long()].reshape(8, sb * 16, 4, 256).permute(0, 2, 1, 3)
    vg = vp[tbl.long()].reshape(8, sb * 16, 4, 256).permute(0, 2, 1, 3)
    kg = kg.repeat_interleave(2, dim=1).contiguous()
    vg = vg.repeat_interleave(2, dim=1).contiguous()
    mask = (torch.arange(sb * 16, device="cuda")[None] <
            sl[:, None])[:, None, None, :]
    sdpa_ms, _ = cuda_ms(torch, lambda i: torch.nn.functional
                      .scaled_dot_product_attention(q[:, :, None], kg, vg,
                                                    attn_mask=mask),
                      iters=50)
    bound_ms, bound_by, nbytes = decode_bound(
        serve_lens, window=None, n_blocks=sb, elt_bytes=2, **shape)
    log(f"paged_decode bf16 b=8 kvh=4 group=2 dh=256 page=16 "
        f"seq_lens={serve_lens}: kernel {ker_ms * 1e3:.2f} us on the device "
        f"({ker_host_ms * 1e3:.2f} us per call on the host), plain "
        f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
        f"({nbytes} bytes, {bound_by}); sdpa on pre-gathered K/V without "
        f"softcap (yardstick only) {sdpa_ms * 1e3:.2f} us")
    timing = {"paged_decode": dict(
        ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, sdpa_gathered_no_softcap_ms=sdpa_ms,
        host_ms_per_call=ker_host_ms,
        max_abs_err=max(errs + [serve_err]))}
    del q, kv, tbl, sl, kg, vg, got, want
    torch.cuda.empty_cache()

    # ---- 3. the main path: serve gemma2-2b --------------------------------
    cfg = configs.get_config("gemma2-2b")
    t0 = time.monotonic()
    params = transformer.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                     device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(s)) for s in transformer.param_shapes(cfg)
                   .values())
    log(f"gemma2-2b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params in bf16, init "
        f"{time.monotonic() - t0:.1f} s")
    max_new, max_seq = 32, 1024 + 32
    engine = ServingEngine(cfg, params, max_batch=8, max_seq=max_seq,
                           page_size=16, dtype=torch.bfloat16)
    engine.serve([Request(prompt=list(range(1, 65)), max_new_tokens=2)])
    torch.cuda.synchronize()            # warm-up (cuBLAS handles etc.)

    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(64, 1025, 16)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=max_new) for n in prompt_lens]
    torch.cuda.reset_peak_memory_stats()
    for _, wrapper in kernels.values():
        wrapper.launches = 0
    engine.serve(reqs)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, (_, w) in kernels.items()}
    stats = engine.last_stats
    n_attn = sum(s.mixer in ("attn", "attn_local") for s in cfg.period) \
        * cfg.n_periods
    steps_ms = np.asarray(stats.step_wall_s) * 1e3
    ttft_ms = np.asarray(stats.ttft_s) * 1e3
    log(f"serve gemma2-2b bf16 on {card}: {len(reqs)} requests (prompts "
        f"{prompt_lens.tolist()}), {stats.tokens} tokens in "
        f"{stats.wall_s:.3f} s = {stats.tokens / stats.wall_s:.1f} tok/s; "
        f"decode step ms mean {steps_ms.mean():.3f} p50 "
        f"{np.percentile(steps_ms, 50):.3f} p99 "
        f"{np.percentile(steps_ms, 99):.3f} over {stats.decode_steps} steps; "
        f"TTFT ms mean {ttft_ms.mean():.1f} p50 "
        f"{np.percentile(ttft_ms, 50):.1f} p99 "
        f"{np.percentile(ttft_ms, 99):.1f}; {stats.prefills} prefills; pages "
        f"peak {stats.pages_peak} / dense {stats.pages_dense_equiv}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"launches {launches}")
    bad = [i for i, r in enumerate(reqs)
           if r.output is None or len(r.output) != max_new
           or not all(0 <= t < cfg.padded_vocab for t in r.output)]
    if bad:
        raise AssertionError(f"requests {bad} did not return {max_new} "
                             f"valid tokens")
    if launches["paged_decode"] != stats.decode_steps * n_attn:
        raise AssertionError(
            f"paged_decode launched {launches['paged_decode']} times, "
            f"expected decode_steps x {n_attn} = "
            f"{stats.decode_steps * n_attn}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    del engine, params
    torch.cuda.empty_cache()

    # ---- 4. end to end against plain, f32 ---------------------------------
    params = transformer.init_params(cfg, seed=1, dtype=torch.float32,
                                     device="cuda")
    rng = np.random.default_rng(1)
    e2e_lens = rng.integers(16, 257, 4)
    b, max_len = len(e2e_lens), 264
    toks = np.zeros((b, max(e2e_lens)), np.int32)
    for i, n in enumerate(e2e_lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    lens = torch.as_tensor(e2e_lens.astype(np.int32), device="cuda")
    with torch.no_grad():
        cache = transformer.init_cache(cfg, b, max_len, torch.float32, "cuda")
        logits, cache = transformer.prefill(
            params, cfg, torch.as_tensor(toks, device="cuda"), cache,
            last_index=lens - 1)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        kv = PagedKVCache(cfg, max_batch=b, max_seq=max_len, page_size=16,
                          dtype=torch.float32)
        for r, n in enumerate(e2e_lens.tolist()):
            kv.alloc(r, max_len)
            kv.write_prompt(r, {si: (c.k[:, r:r + 1, :n], c.v[:, r:r + 1, :n])
                                for si, c in cache.slots.items()}, n)
        n0 = paged_attention.launches
        paged = transformer.decode_step_paged(
            params, cfg, nxt, kv.pages, kv.tables(), lens,
            torch.ones(b, dtype=torch.bool, device="cuda"))
        paged_launches = paged_attention.launches - n0
        dense, _ = transformer.decode_step(params, cfg, nxt, cache,
                                           offsets=lens)
        torch.cuda.synchronize()
    diff = (paged - dense).abs().max().item()
    finite = bool(torch.isfinite(paged).all() and torch.isfinite(dense).all())
    same_top = (paged.argmax(-1) == dense.argmax(-1)).float().mean().item()
    log(f"e2e f32 gemma2-2b, {cfg.n_layers} layers, prompts "
        f"{e2e_lens.tolist()}: max|paged(kernel) - dense(plain)| logits = "
        f"{diff:.3e} (atol {LOGIT_ATOL}); |logits| max "
        f"{dense.abs().max().item():.2f}; argmax agreement {same_top:.2f}; "
        f"kernel launches {paged_launches}; finite {finite}")
    if not (finite and diff <= LOGIT_ATOL and paged_launches == n_attn
            and tuple(paged.shape) == (b, cfg.padded_vocab)):
        raise AssertionError("paged-kernel logits disagree with the dense "
                             "plain path")
    # host work per decode step: ATen ops the eager step dispatches
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0
        by_name: dict = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            OpCount.n += 1
            key = str(func.overloadpacket)
            OpCount.by_name[key] = OpCount.by_name.get(key, 0) + 1
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), OpCount():
        transformer.decode_step_paged(
            params, cfg, nxt, kv.pages, kv.tables(), lens + 1,
            torch.ones(b, dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    log(f"decode_step_paged dispatches {OpCount.n} ATen ops per step "
        f"({OpCount.n / cfg.n_layers:.1f} per layer) plus {n_attn} kernel "
        f"launches through ctypes; most frequent: "
        f"{sorted(OpCount.by_name.items(), key=lambda kv: -kv[1])[:12]}")

    # ---- results -----------------------------------------------------------
    rows = []
    for key, (rec, _) in kernels.items():
        rows.append(dict(rec, launches=launches[key], **{
            k: timing[key][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "sdpa_gathered_no_softcap_ms",
                "host_ms_per_call")}))
    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
