#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

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
  5. the qsgd_pack kernel against its plain version (``torch.equal``):
     bits 2/4/8 on the ResNet-20 and MLR node stacks, odd flat lengths,
     all-zero planes, +-0.0 entries, uniforms equal to the carry
     threshold; then its time at (50, 2128, 128) against the byte bound.
  6. the training path: SDM-DSGD through ``run_decentralized`` on the
     card, qsgdf:4 wire, 50 nodes on ER(0.35): ResNet-20 (CIFAR-shaped)
     for 20 steps, and the paper's MLR 784->10 test bed for 100 steps.
     Losses finite, ``qsgd_pack`` launched once per step per bucket,
     communicated bits == steps x nodes x ``transmitted_bits_per_step``.
  7. after the ResNet-20 run: kernel == plain on the run's final
     differential with the next step's own draws; decoding the plain
     bytes == ``sparsify_planes_stacked``; payload bytes x 8 x the
     schedule's degree == ``transmitted_bits_per_step``.

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
# the card's MLR losses against the port's own CPU run of the same 20
# steps: matmul order differs (~1e-7 relative per step) and can flip a
# rare QSGD level, so the two drift apart slowly; the CPU tests hold the
# CPU run to JAX at 1e-4 on this test bed's first steps
CPU_LOSS_RTOL = 1e-3
# the kernels each main path must launch
SERVE_KERNELS = ("paged_decode",)
TRAIN_KERNELS = ("qsgd_pack",)
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


def qsgd_pack_phase(torch):
    """Phase 5: the qsgd_pack kernel against its plain version on the
    card (bit-exact, ``torch.equal``), then its time at the ResNet-20 x 50
    stack against the plain version and the byte bound."""
    from repro_torch.kernels.wire_compress import (qsgd_inv, qsgd_pack,
                                                   qsgd_quantize_pack_ref)
    from repro_torch.kernels.wire_compress.ops import _qsgd_pack_cuda

    gen = torch.Generator(device="cuda").manual_seed(5)

    def case(shape, n_batch, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        u = torch.rand(shape, generator=gen, device="cuda")
        return x, u, n_batch

    def norms(x, n_batch):
        batch = tuple(x.shape[:n_batch])
        return torch.sqrt(torch.sum(torch.square(x.reshape(batch + (-1,))),
                                    dim=-1))

    cases = {
        "resnet20 stack (50, 2128, 128)": case((50, 2128, 128), 1, 1e-3),
        "mlr stack (50, 62, 128)": case((50, 62, 128), 1),
        "one node, flat 1001": case((1001,), 0),
        "odd stack (3, 1001)": case((3, 1001), 1),
        "all-zero planes (4, 62, 128)": (
            torch.zeros(4, 62, 128, device="cuda"),
            torch.rand(4, 62, 128, generator=gen, device="cuda"), 1),
    }
    x, u, _ = case((5, 62, 128), 1)
    signed_zero = torch.rand(x.shape, generator=gen, device="cuda") < 0.3
    x = torch.where(signed_zero, torch.where(x < 0, -0.0, 0.0), x)
    cases["+-0.0 entries (5, 62, 128)"] = (x, u, 1)
    errs = []
    for bits in (2, 4, 8):
        for name, (x, u, nb) in cases.items():
            norm = norms(x, nb)
            inv = qsgd_inv(norm, bits)
            tail = (1,) * (x.dim() - nb)
            if name.startswith("mlr"):
                # uniforms exactly at frac on every other element: the
                # stochastic carry's strict '<' must hold on both sides
                ratio = torch.abs(x) * inv.reshape(inv.shape + tail)
                frac = ratio - torch.floor(ratio)
                u = torch.where(torch.arange(x.numel(), device="cuda")
                                .reshape(x.shape) % 2 == 0, frac, u)
            n0 = qsgd_pack.launches
            got = qsgd_pack(x, u, norm, bits=bits)
            torch.cuda.synchronize()
            want = qsgd_quantize_pack_ref(x, u, inv, bits=bits)
            same = torch.equal(got, want)
            errs.append((got.int() - want.int()).abs().max().item())
            log(f"qsgd_pack bits={bits} {name}: kernel == plain "
                f"(torch.equal) {same}; out {tuple(got.shape)}; launches "
                f"{qsgd_pack.launches - n0}")
            if not (same and qsgd_pack.launches == n0 + 1):
                raise AssertionError("qsgd_pack disagrees with its plain "
                                     "version")

    # time at the training path's shape: two input sets in turn so the
    # 109 MB of values and uniforms come from HBM, not the 50 MB L2
    sets = []
    for _ in range(2):
        x, u, _ = case((50, 2128, 128), 1, 1e-3)
        norm = norms(x, 1)
        sets.append((x, u, norm, qsgd_inv(norm, 4)))

    def kernel(i):
        x, u, _, inv = sets[i % 2]
        return _qsgd_pack_cuda(x, u, inv, bits=4)

    def wrapper(i):
        x, u, norm, _ = sets[i % 2]
        return qsgd_pack(x, u, norm, bits=4)

    def plain(i):
        x, u, _, inv = sets[i % 2]
        return qsgd_quantize_pack_ref(x, u, inv, bits=4)

    ker_ms, ker_host_ms = cuda_ms(torch, kernel, iters=200)
    wrap_ms, wrap_host_ms = cuda_ms(torch, wrapper, iters=200)
    plain_ms, _ = cuda_ms(torch, plain, iters=20)
    x = sets[0][0]
    nbytes = x.numel() * 8 + 50 * 4 + x.numel() // 2
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"qsgd_pack bits=4 (50, 2128, 128) f32: kernel {ker_ms * 1e3:.2f} us "
        f"on the device ({ker_host_ms * 1e3:.2f} us per call on the host), "
        f"wrapper incl. inv {wrap_ms * 1e3:.2f} us (host "
        f"{wrap_host_ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us, bound "
        f"{bound_ms * 1e3:.2f} us ({nbytes} bytes, bytes); "
        f"{nbytes / (ker_ms * 1e-3) / 1e12:.3f} TB/s achieved")
    return dict(ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                max_abs_err=float(max(errs)),   # over the packed bytes
                host_ms_per_call=ker_host_ms, wrapper_ms=wrap_ms,
                wrapper_host_ms_per_call=wrap_host_ms)


def training_phases(torch, np, kernels, card):
    """Phases 6 and 7: SDM-DSGD (Algorithm 1) through the port's
    ``run_decentralized`` on the card with the fused qsgdf:4 wire, at
    full width (ResNet-20, CIFAR-shaped, 50 nodes on ER(0.35)); the
    paper's MLR test bed; then the kernel against plain on the run's own
    final differential. Returns the training path's kernel launches."""
    from repro_torch import prng, tree as tree_mod
    from repro_torch.core import (PrivacyParams, SDMConfig, gossip,
                                  sdm_dsgd, topology)
    from repro_torch.core import compressor as comp_mod
    from repro_torch.core.plane import ParamPlane
    from repro_torch.data import (classification_dataset,
                                  node_partitioned_batches)
    from repro_torch.kernels.wire_compress import (qsgd_inv, qsgd_pack,
                                                   qsgd_quantize_pack_ref)
    from repro_torch.models import vision_small as vs
    from repro_torch.train.trainer import run_decentralized

    n, batch, seed, spec = 50, 16, 0, "er:0.35"
    cfg = SDMConfig(p=0.2, theta=0.25, gamma=0.05, sigma=1.0, clip_c=5.0,
                    compressor="qsgdf:4")
    cfg.validate_against(topology.by_name(spec, n, seed=seed))   # Lemma 1
    comp = sdm_dsgd.compressor_of(cfg)
    seq = gossip.sequence_by_name(spec, n, seed=seed)

    def inputs(apply_fn, init, n_features, dev):
        """run_decentralized's model and data arguments, built on ``dev``
        from the seed (the data with numpy, the weights with the port's
        threefry keys)."""
        n_train = 10_000
        (x_tr, y_tr), (x_te, y_te) = classification_dataset(
            n_features, 10, n_train, 1000, seed=seed)
        p0 = init(prng.PRNGKey(seed, device=dev))
        m = n_train // n
        return p0, dict(
            params_stack=tree_mod.tree_map(
                lambda p: p[None].expand((n,) + tuple(p.shape)).clone(), p0),
            grad_fn=vs.make_stacked_grad_fn(apply_fn),
            batches=node_partitioned_batches(x_tr, y_tr, n, batch, seed=seed),
            privacy=PrivacyParams.from_compressor(comp, G=5.0, m=m,
                                                  tau=batch / m,
                                                  sigma=cfg.sigma),
            eval_fn=vs.make_eval_fn(apply_fn,
                                    torch.as_tensor(x_te, device=dev),
                                    torch.as_tensor(y_te, device=dev)))

    def run(name, apply_fn, init, n_features, steps, eval_every):
        p0, ins = inputs(apply_fn, init, n_features, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _, wrapper in kernels.values():
            wrapper.launches = 0
        res = run_decentralized(
            topo=spec, algorithm="sdm-dsgd", sdm_cfg=cfg, steps=steps,
            seed=seed, eval_every=eval_every, device="cuda", **ins)
        torch.cuda.synchronize()
        launched = {k: w.launches for k, (_, w) in kernels.items()
                    if k in TRAIN_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        ms = np.asarray(res.step_s) * 1e3
        n_buckets = ParamPlane.for_tree(p0).n_buckets
        bits = sdm_dsgd.transmitted_bits_per_step(p0, cfg, seq=seq)
        finite = all(np.isfinite(res.losses))
        log(f"train {name}: sdm-dsgd {spec} n={n} batch {batch}/node, "
            f"qsgdf:4, f32, {steps} steps on {card}: step ms mean "
            f"{ms.mean():.3f} p50 {np.percentile(ms, 50):.3f} p99 "
            f"{np.percentile(ms, 99):.3f} (first step {ms[0]:.3f}; steps "
            f"2.. mean {ms[1:].mean():.3f}); "
            f"{n * batch / (ms[1:].mean() / 1e3):.1f} examples/s over steps "
            f"2..; peak memory {peak / 1e9:.3f} GB; eps "
            f"{res.epsilons[-1]:.6e}; eval acc {res.eval_accuracy}; losses "
            f"{[round(v, 5) for v in res.losses]}; comm_bits[-1] "
            f"{res.comm_bits[-1]} = {steps} x {n} x {bits}; launches "
            f"{launched} ({n_buckets} bucket)")
        if not finite:
            raise AssertionError(f"{name}: non-finite loss")
        if launched["qsgd_pack"] != steps * n_buckets:
            raise AssertionError(
                f"{name}: qsgd_pack launched {launched['qsgd_pack']} times, "
                f"expected steps x buckets = {steps * n_buckets}")
        if res.comm_bits[-1] != steps * n * bits:
            raise AssertionError(f"{name}: comm_bits {res.comm_bits[-1]} != "
                                 f"{steps} x {n} x {bits}")
        return p0, res, launched, bits

    # ---- 6. ResNet-20 at full width; the paper's MLR test bed -------------
    steps = 20
    p0, res, launched, bits = run("resnet20", vs.resnet20_apply,
                                  vs.resnet20_init, 3072, steps, steps)

    # ---- 7. kernel against plain on the run's own final differential -------
    state = res.state
    key = prng.PRNGKey(seed, device="cuda")
    for _ in range(steps + 1):          # the trainer's key chain, one past
        key, sub = prng.split(key)
    k_sp = prng.split(sub)[0]           # the next step's sparsifier key
    spec_d = ParamPlane.for_stacked(state.d)
    (planes,) = spec_d.pack_stacked(state.d)
    nodes = torch.arange(n, device="cuda")
    node_keys = gossip.node_round_key(prng.fold_in(k_sp, 0), nodes,
                                      state.step)
    u = prng.uniform(node_keys, tuple(planes.shape[1:]))
    norm = torch.sqrt(torch.sum(torch.square(planes.reshape(n, -1)), dim=-1))
    got = qsgd_pack(planes, u, norm, bits=4)
    plain = qsgd_quantize_pack_ref(planes, u, qsgd_inv(norm, 4), bits=4)
    payload = comp.compress(node_keys, planes, node=nodes)
    tail = norm.reshape(n, 1).contiguous().view(torch.uint8)
    decoded = spec_d.unpack_stacked((comp.decompress(comp_mod.Payload(
        values=torch.cat([plain, tail], dim=-1), shape=tuple(planes.shape[1:]),
        meta=("qsgdf", 4), batch=(n,))),))
    want = sdm_dsgd.sparsify_planes_stacked(comp, state.d, k_sp, state.step,
                                            n)
    same_kernel = torch.equal(got, plain)
    same_payload = torch.equal(payload.values[:, :-4], plain)
    same_decode = all(torch.equal(a, b) for a, b in zip(
        tree_mod.leaves(decoded), tree_mod.leaves(want)))
    payload_bytes = payload.values.shape[-1]
    factor = sdm_dsgd.schedule_degree_factor(seq)
    wire_bits = payload_bytes * 8 * factor
    log(f"kernel vs plain on the run's final d ({n}, {planes.shape[1]}, 128), "
        f"step {state.step}: torch.equal {same_kernel}; compressor payload "
        f"== plain bytes {same_payload}; decode(plain) == "
        f"sparsify_planes_stacked {same_decode}; payload {payload_bytes} B/"
        f"node x 8 x degree {factor} ({float(factor):.4f}) = "
        f"{float(wire_bits):.2f} bits vs transmitted_bits_per_step {bits}")
    if not (same_kernel and same_payload and same_decode):
        raise AssertionError("qsgd_pack disagrees with its plain version on "
                             "the training path's data")
    if int(round(wire_bits)) != bits:
        raise AssertionError(f"wire bytes {payload_bytes} x 8 x {factor} != "
                             f"transmitted_bits_per_step {bits}")
    del planes, u, got, plain, payload, decoded, want
    step_breakdown(torch, np, state, inputs(vs.resnet20_apply,
                                            vs.resnet20_init, 3072, "cuda")[1],
                   seq, cfg, n)
    del state, res
    torch.cuda.empty_cache()

    # the paper's own test bed (benchmarks/common.py): MLR 784 -> 10; its
    # first 20 steps again through the port on the host CPU (the path the
    # CPU tests hold to the JAX package): the card's losses must track it
    _, mlr, _, _ = run("mlr", vs.mlr_apply, vs.mlr_init, 784, 100, 50)
    _, ins = inputs(vs.mlr_apply, vs.mlr_init, 784, "cpu")
    host = run_decentralized(topo=spec, algorithm="sdm-dsgd", sdm_cfg=cfg,
                             steps=20, seed=seed, eval_every=100,
                             device="cpu", **ins)
    gap = np.abs(np.asarray(mlr.losses[:20]) - np.asarray(host.losses))
    rel = float((gap / np.abs(host.losses)).max())
    log(f"mlr card vs host CPU (port), first 20 steps: max relative loss "
        f"gap {rel:.3e} (limit {CPU_LOSS_RTOL}); comm_bits equal "
        f"{mlr.comm_bits[:20] == host.comm_bits}")
    if not (rel <= CPU_LOSS_RTOL and mlr.comm_bits[:20] == host.comm_bits):
        raise AssertionError("the card's MLR run departs from the CPU run")
    return launched


def step_breakdown(torch, np, state, ins, seq, cfg, n, reps=3):
    """Where a ResNet-20 x 50 step's time goes: its parts timed alone (host
    wall around synchronised calls), the device's busy share from a
    ``torch.profiler`` trace of whole steps, and the ATen ops one step
    dispatches."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import prng
    from repro_torch.core import method, sdm_dsgd

    sim = method.get("sdm-dsgd").make_reference(seq, cfg)
    sim.init(state.x)
    comp = sdm_dsgd.compressor_of(cfg)
    grad_fn = ins["grad_fn"]
    batch = tuple(torch.as_tensor(v, device="cuda")
                  for v in next(ins["batches"]))
    key = prng.PRNGKey(1, device="cuda")
    grads, _ = grad_fn(state.x, batch)
    parts = {
        "grad_fn (vmapped fwd+bwd)": lambda: grad_fn(state.x, batch),
        "masked_grad (clip + per-leaf normal)": lambda: sdm_dsgd.masked_grad(
            grads, key, sigma=cfg.sigma, clip_c=cfg.clip_c),
        "sparsify_planes_stacked (wire)": lambda:
            sdm_dsgd.sparsify_planes_stacked(comp, state.d, key, state.step,
                                             n),
        "whole step": lambda: sim.step(state, grad_fn, batch, key),
    }
    ms = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            sim.step(state, grad_fn, batch, key)
        torch.cuda.synchronize()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / reps / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            OpCount.n += 1
            return func(*args, **(kwargs or {}))

    with OpCount():
        sim.step(state, grad_fn, batch, key)
    torch.cuda.synchronize()
    step = ms["whole step"]
    log("resnet20 step breakdown (ms, each part alone, synchronised): "
        + "; ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    if busy_ms > 0:
        log(f"resnet20 step device time {busy_ms:.3f} ms of {step:.3f} ms "
            f"wall: device idle share {1 - busy_ms / step:.3f}; "
            f"{sum(e.count for e in kernels) / reps:.0f} kernel launches "
            f"per step; top kernels by device time (ms per step): "
            + "; ".join(f"{e.key[:60]} {dev_us(e) / reps / 1e3:.3f} "
                        f"(x{e.count // reps})" for e in top))
    else:
        log("resnet20 step device time: not measured (the profiler "
            "recorded no device time)")
    log(f"resnet20 step dispatches {OpCount.n} ATen ops")


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
    from repro_torch.kernels.wire_compress import qsgd_pack
    from repro_torch.models import transformer
    from repro_torch.serving import PagedKVCache, Request, ServingEngine

    # every kernel of the path: (record, wrapper with a .launches count)
    kernels = {
        "paged_decode": (dict(
            name="paged_decode", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_decode.cu",
            replaces="src/repro/kernels/flash_attn/decode.py:83"),
            paged_attention),
        "qsgd_pack": (dict(
            name="qsgd_pack", route="cuda",
            source="src/repro_torch/kernels/csrc/wire_compress.cu",
            replaces="src/repro/kernels/wire_compress/wire_compress.py:80"),
            qsgd_pack),
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
    # the serving path's kernels; the training path's are read in phase 6
    launches = {k: w.launches for k, (_, w) in kernels.items()
                if k in SERVE_KERNELS}
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

    del params, cache, kv
    torch.cuda.empty_cache()

    # ---- 5.-7. the training path (Algorithm 1, qsgdf wire) ----------------
    timing["qsgd_pack"] = qsgd_pack_phase(torch)
    launches.update(training_phases(torch, np, kernels, card))

    # ---- results -----------------------------------------------------------
    rows = [dict(rec, launches=launches[key], **timing[key])
            for key, (rec, _) in kernels.items()]
    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
