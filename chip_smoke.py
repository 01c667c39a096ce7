#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, kernel-bench and benchmark-gate
paths on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card and build: the card's name and power limit; nvcc builds every
     kernel of the path from ``src/repro_torch/kernels/csrc`` (sm_90a);
     registers, spill stores and resident blocks per SM of the attention
     kernels' instances (a bf16 flash instance that spills fails); TF32
     is switched off for f32 matmuls and convolutions.
  2. each kernel against its plain PyTorch version, on the card, at
     gemma2-2b's decode shapes, in f32 and bf16; then its time, the
     plain version's time and its bound at the serving path's shapes,
     and the same call under other split-K plans.
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

  8.-10. the per-node executor and the distributed LM slice:
     ``fixedk_gather_pack`` vs plain on ragged shapes; the executor vs the
     reference (MLR, 8 nodes); gemma2-2b at full width, depth cut to 4
     layers, 2 nodes, fixedk:128, through ``launch.train.train``.
  11. the fused SDM update kernel vs plain over the whole gemma2-2b x 4
     layers plane (880,167 x 1024 f32) and its time against the 40 B per
     element byte bound; the tree wrapper on ResNet-20's tree.
  12. the prefill flash kernel vs plain at gemma2-2b's attention widths
     (b 1, h 8, kvh 4, dh 256), s 4096 / 8192, bf16 / f32, global /
     local (window 4096) / plain causal; times against the bound and, for
     plain causal, ``scaled_dot_product_attention``.
  13. this slice's main path: ``repro_torch.bench.kernel_bench`` at its
     default shapes; the fused-update and flash kernels must launch.
  14. gradient-push on the MLR test bed, 50 nodes on der:0.35, fixedk,
     qsgdf:4 and qsgdf:8: 10 executor steps vs the reference with exact
     ppermute and byte counters; pure gossip keeps sum x / sum w; 100
     steps through ``run_decentralized`` (10 for qsgdf:4, which diverges
     on this test bed in the JAX package too).
  15. gradient-push, ResNet-20 x 50 nodes, qsgdf:4, 10 steps:
     ``qsgd_pack`` launched once per step.
  16. the paper's experiments on the card at its 50 nodes (MLR 784 -> 10,
     ER(0.35)): theory and the privacy sweep, fig2 (250 steps), fig3 (the
     default budget), table1 (eps 0.03 / 0.05 / 0.1 x 3 methods, capped at
     150 steps a run). Each claim is printed held or not
     (the JAX reference fails two); gated: finite losses, fig2's
     divergence / convergence flags, fig3's wire bits == steps x bits a
     step, table1's sigma and T == the port's f64 theory and epsilons ==
     the host accountant, step for step.
  17. the edge-fleet simulator: ``bench.sim_edge`` at its sizes (8 nodes,
     60 rounds, 3 methods x 4 scenarios); ``simulate`` on the MLR test
     bed x 4 scenarios, 30 rounds, twice (same trace) and dropout once
     on the CPU (losses within 1e-3); ResNet-20 x 50, qsgdf:4, straggler,
     10 rounds (``qsgd_pack`` once a round, added to its launches);
     gemma2-2b at full width, 4 layers, 2 nodes through
     ``launch.train.simulate_lm`` (the ``--sim`` path), 3 rounds. Each
     part prints its wall time and peak memory beside the card.
  18. the two gates on the card: ``bench.serve_bench`` (phi3-medium-14b
     smoke, 12 ragged requests, static vs continuous) and
     ``bench.perf_wire`` (9 wire cases x 8 nodes), then ``check_serve`` and
     ``check_perf`` against their ``"cuda"`` baselines; the paged decode,
     ``qsgd_pack`` and ``fixedk_gather_pack`` kernels must launch.
  19. the three dense configs: the paged kernel vs plain at their head
     layouts (phi3 kvh 10 x group 4, chatglm3 kvh 2 x group 16, qwen1.5
     kvh 40 x group 1; dh 128, no softcap) and its time at each serving
     shape; phi3-medium-14b at full width and depth serves phase 3's 16
     ragged requests (paged launches == decode_steps x 40) and its f32
     paged step is held to plain attention at 20 layers (relative bound);
     chatglm3-6b at full depth and qwen1.5-32b at 32 of its 64 layers each
     serve 4 requests.
  20. the MoE and recurrent families: the paged kernel vs plain at their
     head layouts (granite-moe kvh 8 x group 2 dh 64, qwen3-moe kvh 4 x
     group 8, jamba kvh 8 x group 4; dh 128) and its time at each serving
     shape; granite-moe-1b-a400m at full width and depth serves phase 3's
     16 requests (paged launches == decode_steps x 24), its f32 paged step
     against plain attention (relative bound) and its continuous engine's
     greedy outputs against one-at-a-time serving; rwkv6-3b (attention
     free) at full width and depth serves phase 3's requests, then f32
     continuous == static (length-grouped) == one-at-a-time; qwen3-moe-30b-
     a3b at 32 of 48 layers and jamba-v0.1-52b at 16 of 32 each serve 8
     requests of <= 256 prompt tokens; granite-moe at 4 layers trains 3
     steps on 2 nodes (fixedk:128, ``fixedk_gather_pack`` once a step).
  21. the encoder families: the paged kernel vs plain at whisper's head
     layout (kvh 20 x group 1, dh 64, at 18 and 66 blocks) and
     llama-3.2-vision's (kvh 8 x group 4, dh 128) and its time at each
     serving shape; whisper-large-v3 at full width and depth (32 encoder
     + 32 decoder layers) serves 16 requests of 4-224 prompt tokens and
     64 new on one 1500-frame embedding a context row (paged launches ==
     decode_steps x 32), its encoder timed alone; its f32 paged step
     against plain attention with the encoded context; llama-3.2-vision-
     11b at full width and depth (40 layers, 1024 image tokens) serves
     phase 3's 16 requests (paged launches == decode_steps x 40), then
     its f32 paged step against plain; for both in f32 on equal context
     rows, continuous == static == one-at-a-time; whisper at 4 + 4
     layers trains 3 steps on 2 nodes (fixedk:128, seq 448).
  22. the executor's and the library's leftovers: phase 10's LM cell
     with ``--overlap`` through ``launch.train.train``, the exchange on
     the transport's side stream in flight from each step to the next,
     against the same run with the exchange waited on inside each step
     (losses and parameters ``torch.equal``; one exchange pending after
     each step, none at the end; step ms on the compute stream; a
     profile of two more steps: busy share, the side stream's ms and
     the part of it under compute-stream work; the exchange alone); that
     state through ``save_checkpoint`` / ``restore_checkpoint`` (every
     leaf ``torch.equal``, bf16 kept); the ring helpers
     (``ring_exchange_packed_rows``, ``ring_exchange_packed``) over the
     LM's plane on 4 nodes, one gather-pack launch each, each output
     ``torch.equal`` to the helper with the gather routed to its plain
     version, timed against the byte bound; ``adamw`` and ``momentum``
     over the LM's f32 parameter tree for 3 steps against a CPU run.
  23. the dry-run against the card: ``launch.dryrun.build_case`` traces
     the three LM training cells of phases 10, 20g and 21f on the meta
     device with their own configs (not run again); for each, the
     dry-run's flops, bytes and peak, its roofline terms at the H100's
     datasheet peaks (``bench/roofline``), the model flops (6 N_active
     D), the phase's measured step and peak memory, measured over
     roofline, the model-flop share of the step and predicted over
     measured peak; then as many (arch x shape) cases of the full
     dry-run on mesh ``16`` as its 70 s budget allows, one line each,
     and the cases left out. Any failed case fails the phase.
  24. the static privacy and wire auditor on the card
     (``repro_torch.analysis``): the 26 configs of its matrix, each
     traced for 3 steps on ``StackTransport(4, "cuda")``, must pass every
     pass, the two negative controls flagged by the taint pass; the
     ``fixedk_packed`` rows' graphs hold ``fixedk_gather_pack`` nodes and
     the ``qsgdf:4`` rows' ``qsgd_pack`` nodes, each launched once a node
     during the trace (added to the kernels' launches); one traced
     config's graph, run again, gives a final state ``torch.equal`` to an
     untraced run of the same 3 steps. Budget 60 s.
  25. tensor parallelism over the ``model`` axis: first the tensor-
     parallel forward, loss and gradients over 2 and 4 shards against
     the unsharded ones on the card (gemma2-2b smoke widths, f32); then
     phase 10's LM cell on a ``2x2`` mesh (2 nodes, each model split
     over 2 shards stacked on the card, ``StackModelAxis``) through
     ``launch.train.train``, 6 steps: the wire-plane buckets and their
     lanes, ppermutes and wire bytes a step against the accounting
     under the buckets, the model-axis collectives a step against
     ``model_axis.tp_collectives``, step 1's loss against phase 10's
     unsharded step from the same weights, finite losses, step ms and
     peak memory beside phase 10's, the step's parts alone; then the
     gather-pack kernel against its plain version on the run's own
     differential at every bucket's shape, each timed against its byte
     bound and ``index_select``.
  26. the serving steps over the ``model`` axis
     (``train.steps.make_prefill_fn`` / ``make_decode_fn``, no kernel):
     gemma2-2b at full width in f32 at 2 layers, then at full width and
     depth in bf16, one node at M = 2 and 4 (4 KV heads: split whole);
     4 rows of 4352 prompt tokens (past the local layers' 4096 window)
     into an 8192-position cache, the cache moved from the prefill
     layout (split by KV heads) to the decode layout (split by
     positions: flash decoding, the partials merged by a max and a sum
     across the shards) by ``convert.shard_cache``, then 32 decode steps
     teacher-forced on the unsharded run's greedy tokens. Gates: each
     row's logits against the unsharded ``prefill`` / ``decode_step``
     (max |diff| / max |unsharded|: bf16 2^-5, f32 1e-4), finite, the
     model-axis counters equal ``tp_serving_collectives``, parameters,
     cache and axis on the card; a fault control (1x2, 4 decode steps
     with the last shard's partials dropped from the merge) must read
     above each gate; prints the greedy tokens that agree,
     the mean decode step for M = 1, 2 and 4, the phase's seconds and
     peak memory.

Prints a line per check and measurement, then a ``{"kernels": [...]}``
line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the kernels' byte and flop counts and the H100 SXM's datasheet peaks
from repro_torch.kernels import cost  # noqa: E402

HBM_BYTES_PER_S = cost.HBM_BYTES_PER_S

# f32: the JAX package's own flash-vs-oracle tolerance
# (tests/test_serving_engine.py:218). bf16: kernel and plain version both
# compute in f32 from the same bf16 inputs and round only the output, so
# they differ by at most one bf16 ulp of |out| < 4, i.e. 2^-6 = 1.6e-2.
KERNEL_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
# prefill flash, each query row's max|kernel - plain| over that row's own
# max|plain| (the absolute bound alone is the size of a typical output at
# s 8192, where |out| ~ sqrt(e / s)). bf16: p rounded to bf16 before p.v
# and the output's rounding each cost at most 2^-8 of the row's scale, so
# 2^-5 is twice their sum; a dropped 64-key tile costs a row that sees
# n keys ~ sqrt(64 / n) of its scale. f32: ~sqrt(s) 2^-24 from the
# summation order, far below 2^-10.
FLASH_ROW_RTOL = {"float32": 2 ** -10, "bfloat16": 2 ** -5}
# the card's MLR losses against the port's own CPU run of the same 20
# steps: matmul order differs (~1e-7 relative per step) and can flip a
# rare QSGD level, so the two drift apart slowly; the CPU tests hold the
# CPU run to JAX at 1e-4 on this test bed's first steps
CPU_LOSS_RTOL = 1e-3
# the kernels each main path must launch
SERVE_KERNELS = ("paged_decode",)
TRAIN_KERNELS = ("qsgd_pack",)
GATE_KERNELS = ("paged_decode", "qsgd_pack", "fixedk_gather_pack")
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
    """Least time of one paged decode call (``cost.paged_decode``: the
    visible pages of K and V, q, out, table, lengths over HBM bandwidth,
    against its flops over the peak for the input type): (ms, bound_by,
    bytes)."""
    c = cost.paged_decode(seq_lens, window=window, kvh=kvh, group=group,
                          dh=dh, page=page, n_blocks=n_blocks,
                          elt_bytes=elt_bytes)
    return cost.bound(c, elt_bytes) + (c.nbytes,)


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
    nbytes = cost.qsgd_pack(50, x.numel() // 50, 4).nbytes
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

    from repro_torch import prng
    from repro_torch.bench.counting import OpCount
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

    with OpCount() as ops:
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
    log(f"resnet20 step dispatches {ops.total} ATen ops")


# ---- the distributed LM training slice (phases 8-10) ----------------------

# the full-width slice: gemma2-2b at its published widths, depth cut to
# LM_LAYERS so that LM_NODES nodes' state and one node's activations fit
LM_NODES, LM_LAYERS, LM_STEPS, LM_SEQ, LM_BATCH = 2, 4, 6, 512, 2
# each LM cell's config and measurements (lm_phase), for phase 23
LM_CELLS = {}
# executor vs reference on the card, small width: the parity sweep's
# tolerance (tests/test_distributed.py)
EXEC_RTOL = 1e-4


def gather_pack_cases(torch, dev="cuda"):
    """Phase 8a: the fixedk_gather_pack kernel against its plain version
    (``torch.equal``) on ragged shapes: block 1 / 8 / 128, nb not a
    multiple of 8, kb = nb, a scale f32 cannot hold, 1 and 4 nodes."""
    from repro_torch.kernels.wire_compress import (fixedk_gather_pack,
                                                   fixedk_gather_pack_ref)

    gen = torch.Generator(device=dev).manual_seed(8)
    results = []
    for n, nb, kb, block in ((1, 1001, 333, 1), (4, 37, 11, 8),
                             (4, 37, 37, 128), (3, 130, 26, 128),
                             (2, 999, 100, 3)):
        db = torch.randn(n, nb, block, generator=gen, device=dev)
        idx = torch.stack([torch.randperm(nb, generator=gen, device=dev)[:kb]
                           for _ in range(n)]).to(torch.int32)
        n0 = fixedk_gather_pack.launches
        got = fixedk_gather_pack(db, idx, scale=nb / kb)
        if dev != "cpu":
            torch.cuda.synchronize()
        want = fixedk_gather_pack_ref(db, idx, scale=nb / kb)
        same = torch.equal(got, want)
        log(f"fixedk_gather_pack (L={n}, nb={nb}, kb={kb}, block={block}) "
            f"scale {nb}/{kb}: kernel == plain (torch.equal) {same}; "
            f"launches {fixedk_gather_pack.launches - n0}")
        results.append((same, fixedk_gather_pack.launches - n0))
    return results


def executor_phase(torch, np, dev="cuda"):
    """Phase 9: the per-node executor on a StackTransport against the
    port's own ReferenceSimulator, on the card, small width (MLR 784 ->
    10, 8 nodes): fixedk_packed on the ring, qsgdf:4 on the ring and
    fixedk_packed on matchings:4 (time-varying, replica transport), 5
    steps each. Counters: ppermute calls == wire_count, bytes sent per
    node == transmitted_bits_per_step / 8 each step."""
    from repro_torch import prng, tree as tree_mod
    from repro_torch.core import (SDMConfig, gossip, method, sdm_dsgd,
                                  transport as tr, wire_count)
    from repro_torch.data import (classification_dataset,
                                  node_partitioned_batches)
    from repro_torch.models import vision_small as vs

    n, steps, batch = 8, 5, 16
    (x_tr, y_tr), _ = classification_dataset(784, 10, 2000, 10, seed=1)
    grad_fn = vs.make_stacked_grad_fn(vs.mlr_apply)
    key = prng.PRNGKey(42, device=dev)
    p0 = vs.mlr_init(prng.PRNGKey(0, device=dev))
    failures = []
    for spec, comp in (("ring", "fixedk"), ("ring", "qsgdf:4"),
                       ("matchings:4", "fixedk")):
        seq = gossip.sequence_by_name(spec, n)
        meth = method.get("sdm-dsgd")
        cfg = SDMConfig(p=0.25, theta=0.15, gamma=0.2, sigma=0.0, clip_c=1.0,
                        compressor=comp)
        batches = node_partitioned_batches(x_tr, y_tr, n, batch, seed=1)
        data = [tuple(torch.as_tensor(v, device=dev) for v in next(batches))
                for _ in range(steps)]
        stack = tree_mod.tree_map(
            lambda v: v[None].expand((n,) + tuple(v.shape)).clone(), p0)
        transport = tr.StackTransport(n, dev)
        ex = meth.make_distributed(seq, cfg, transport)
        state = ex.init(stack)
        sim = meth.make_reference(seq, cfg)
        ref = sim.init(tree_mod.tree_map(torch.clone, stack))
        for t in range(steps):
            state, _ = ex.step(state, lambda x: grad_fn(x, data[t]),
                               base_key=key)
            ref, _ = sim.advance(ref, key)
            ref = sim.commit(ref, grad_fn(ref.x, data[t])[0], key)
        if dev != "cpu":
            torch.cuda.synchronize()
        got, want = tree_mod.leaves(state.x), tree_mod.leaves(ref.x)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        scale = max(b.abs().max().item() for b in want)
        mode = wire_count.mode_of(meth.name, cfg)
        calls = sum(wire_count.permutes_per_step(meth.name, mode, seq, t)
                    for t in range(steps))
        static = seq.length == 1 and calls == steps * \
            wire_count.expected_permutes(meth.name, mode, seq)
        counts_ok = static or seq.length > 1
        per_node = p0
        bits = sdm_dsgd.transmitted_bits_per_step(per_node, cfg, seq=seq)
        want_bytes = wire_count.expected_bytes_sent(meth, per_node, cfg, seq,
                                                    steps)
        ok = (err <= EXEC_RTOL * max(scale, 1.0) and scale > 0
              and transport.permutes == calls
              and transport.bytes_sent == want_bytes
              and counts_ok)
        log(f"executor vs reference on {dev}: sdm-dsgd MLR 784->10, n={n}, "
            f"{spec} ({seq.name}, replicas={gossip.needs_replicas(seq)}), "
            f"{comp}, {steps} steps: max|exec - ref| {err:.3e} (scale "
            f"{scale:.3e}, tol {EXEC_RTOL} x max(scale, 1)); ppermute calls "
            f"{transport.permutes} == wire_count {calls}"
            + (f" == {steps} x expected_permutes" if static else "")
            + f"; bytes sent per node {sorted(set(transport.bytes_sent.values()))}"
            f" == expected {sorted(set(want_bytes.values()))} "
            f"(transmitted_bits_per_step {bits} / 8 = {bits / 8} per step); "
            f"ok {ok}")
        if not ok:
            failures.append(f"{spec}/{comp}")
    return failures


def _profile_busy(torch, fn, reps):
    """(device busy ms per call, wall ms per call) of ``fn`` from a
    ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / reps / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return busy, wall, [(e.key[:60], dev_us(e) / reps / 1e3,
                         e.count // reps) for e in top]


def lm_phase(torch, np, card, dev="cuda", smoke=False, arch="gemma2-2b",
             layers=LM_LAYERS, steps=LM_STEPS, seq_len=LM_SEQ,
             enc_layers=None, profile=True):
    """Phases 10, 20g and 21f: the slice at full width through the
    launcher's step function: ``arch`` at its published widths (phase 10:
    gemma2-2b, d_model 2304, 8 / 4 heads, head_dim 256, d_ff 9216, vocab
    256000), depth cut to ``layers`` (and an encoder to ``enc_layers``),
    LM_NODES nodes as one node block on the card, sdm-dsgd with
    fixedk:128 on the ring, sigma > 0 with clipping, seq ``seq_len``,
    ``steps`` steps (the audio / vlm families on the launcher's stub
    context); an MoE config's load-balance term is logged beside node 0's
    cross entropy. Then the fixedk_gather_pack kernel against its plain
    version on the run's own final differential, its time, and (with
    ``profile``) the step's profile and breakdown."""
    import dataclasses
    import math

    from repro_torch import configs, prng, tree as tree_mod
    from repro_torch.core import (SDMConfig, method, sdm_dsgd,
                                  transport as tr, wire_count)
    from repro_torch.core.plane import ParamPlane, ShapeDtype
    from repro_torch.core import gossip, sparsifier
    from repro_torch.core.privacy import PrivacyAccountant, PrivacyParams
    from repro_torch.kernels.wire_compress import (fixedk_gather_pack,
                                                   fixedk_gather_pack_ref)
    from repro_torch.kernels.wire_compress.ops import \
        _fixedk_gather_pack_cuda
    from repro_torch.launch.train import train
    from repro_torch.models import transformer
    from repro_torch.train import steps as steps_mod

    base = (configs.get_smoke_config(arch) if smoke
            else configs.get_config(arch))
    cfg = dataclasses.replace(base, n_layers=layers)
    reduced = [f"n_layers {base.n_layers} -> {layers}"]
    if enc_layers is not None:
        cfg = dataclasses.replace(cfg, n_encoder_layers=enc_layers)
        reduced.append(f"n_encoder_layers {base.n_encoder_layers} -> "
                       f"{enc_layers}")
    # sigma^2 >= 1/1.25 is Theorem 1's precondition; G = clip_c sqrt(d)
    n, clip_c, sigma, m_local = LM_NODES, 1e-4, 1.0, 10_000
    sdm = SDMConfig(p=0.2, theta=0.5, gamma=1e-3, sigma=sigma, clip_c=clip_c,
                    compressor="fixedk:128")
    tc = steps_mod.DistributedTrainConfig(
        model=cfg, sdm=sdm, topology="ring", method="sdm-dsgd",
        param_dtype=torch.bfloat16)
    meth, mcfg = tc.resolved()
    seq = steps_mod.gossip_schedule(tc, n)
    template = transformer.unflatten({
        k: ShapeDtype(s, torch.bfloat16)
        for k, s in transformer.param_shapes(cfg).items()})
    d = sum(math.prod(v.shape) for v in tree_mod.leaves(template))
    plane = ParamPlane.for_tree(template)
    stacked = tree_mod.tree_map(
        lambda v: ShapeDtype((n,) + v.shape, v.dtype), template)
    layout = method.state_shape_dtype(meth, stacked, mcfg, seq)
    state_b = sum(math.prod(v.shape) * (2 if v.dtype == torch.bfloat16
                                        else 4)
                  for v in tree_mod.leaves(layout))
    plane_b = n * plane.padded_size * 4
    # the step's transients, unfreed at their peak (commit): the packed x
    # and g planes, the mixing temporary, the new d (4 planes), the
    # noised gradient block twice and the gradient block (bf16), plus
    # one node's activations and f32 logits
    act_b = 6 * LM_BATCH * seq_len * cfg.padded_vocab * 4
    predicted = state_b + 4 * plane_b + 3 * n * d * 2 + act_b
    log(f"lm slice: {arch} widths (d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k}" if cfg.n_experts
           else "") + f"), reduced: {', '.join(reduced)}; "
        f"{d / 1e9:.4f} B params "
        f"per node ({plane.buckets[0].rows} x 128 wire plane); {n} nodes; predicted "
        f"peak {predicted / 1e9:.2f} GB = state {state_b / 1e9:.2f} GB "
        f"(x bf16 + s, d f32 planes) + 4 f32 planes {4 * plane_b / 1e9:.2f}"
        f" + 3 bf16 blocks {3 * n * d * 2 / 1e9:.2f} + activations/logits "
        f"{act_b / 1e9:.2f}")

    transport = tr.StackTransport(n, dev)
    t0 = time.monotonic()
    state = steps_mod.init_distributed_state(tc, transport, seed=0)
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"lm slice init {time.monotonic() - t0:.1f} s")
    fixedk_gather_pack.launches = 0
    run = train(tc, transport, steps=steps, global_batch=n * LM_BATCH,
                seq_len=seq_len, seed=0, state=state,
                on_step=lambda t, loss, sec: log(
                    f"  {arch} lm step {t} loss {loss:.5f} ({sec * 1e3:.1f} ms)"))
    launches = fixedk_gather_pack.launches
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    ms = np.asarray(run.step_s) * 1e3
    LM_CELLS[arch] = dict(layers=layers, enc_layers=enc_layers,
                          seq_len=seq_len, nodes=n, batch=LM_BATCH,
                          sdm=sdm, step_ms=float(ms[1:].mean()),
                          peak_bytes=peak, losses=list(run.losses))
    bits = sdm_dsgd.transmitted_bits_per_step(template, mcfg, seq=seq)
    mode = wire_count.mode_of(meth.name, mcfg)
    calls = steps * wire_count.expected_permutes(meth.name, mode, seq)
    want_bytes = {i: steps * bits // 8 for i in range(n)}
    comp = sdm_dsgd.compressor_of(mcfg)
    acct = PrivacyAccountant(PrivacyParams.from_compressor(
        comp, G=clip_c * math.sqrt(d), m=m_local, tau=LM_BATCH / m_local,
        sigma=sigma), eps_target=1.0)
    acct.step(steps)
    tok_s = run.tokens_per_step / (ms[1:].mean() / 1e3)
    log(f"train {arch} x{cfg.n_layers} layers bf16, sdm-dsgd "
        f"{seq.name} n={n}, fixedk:128, sigma {sigma} clip_c {clip_c}, seq "
        f"{seq_len}, batch {LM_BATCH}/node, {steps} steps on {card}: "
        f"step ms mean {ms.mean():.3f} p50 {np.percentile(ms, 50):.3f} p99 "
        f"{np.percentile(ms, 99):.3f} (first {ms[0]:.3f}; steps 2.. mean "
        f"{ms[1:].mean():.3f}); {tok_s:.1f} tokens/s over steps 2..; peak "
        f"memory {peak / 1e9:.3f} GB (predicted {predicted / 1e9:.2f}); "
        f"losses {[round(v, 5) for v in run.losses]}; wire bits per node "
        f"per step {bits} (bytes sent per node "
        f"{sorted(set(transport.bytes_sent.values()))} == {steps} x "
        f"{bits // 8}: {transport.bytes_sent == want_bytes}); ppermute "
        f"calls {transport.permutes} == {steps} x expected_permutes "
        f"{calls // steps}; eps {acct.epsilon:.6e} (G = clip_c sqrt(d) "
        f"{clip_c * math.sqrt(d):.3f}, m {m_local}, tau {LM_BATCH}/"
        f"{m_local}, delta 1e-5); fixedk_gather_pack launches {launches} "
        f"({plane.n_buckets} bucket)")
    failures = []
    if not all(math.isfinite(v) for v in run.losses):
        failures.append("non-finite loss")
    if cfg.n_experts:
        # the aux term: node 0's final parameters on node 0's step-0 batch
        from repro_torch.data import TokenStream
        tokens, labels = (torch.as_tensor(a[:LM_BATCH], device=dev) for a in
                          TokenStream(vocab_size=cfg.vocab_size,
                                      batch=n * LM_BATCH, seq_len=seq_len,
                                      seed=0).batch_at(0))
        with torch.no_grad():
            logits, aux = transformer.forward(
                tree_mod.tree_map(lambda v: v[0], run.state.x), cfg, tokens)
            ce = float(transformer.lm_loss(logits, labels, cfg.vocab_size))
            del logits
        log(f"{arch} node 0 after the run: cross entropy {ce:.5f} + 0.01 x "
            f"aux {float(aux):.5f} (the MoE load-balance term, summed over "
            f"{cfg.n_layers} layers)")
        if not math.isfinite(ce + float(aux)):
            failures.append("non-finite cross entropy or aux")
    if transport.permutes != calls or transport.bytes_sent != want_bytes:
        failures.append("wire counters disagree with the accounting")
    if launches != steps * plane.n_buckets:
        failures.append(f"fixedk_gather_pack launched {launches} times, "
                        f"expected steps x buckets "
                        f"{steps * plane.n_buckets}")

    out = dict(launches=launches, failures=failures)
    if dev == "cpu":
        return out
    holder = {"state": run.state}
    del run, state
    if profile:
        # device busy share over one more step (the profiler's window;
        # its trace takes minutes to read back at two steps)
        step_fn = steps_mod.make_distributed_train(tc, transport)
        from repro_torch.data import TokenStream
        stream = TokenStream(vocab_size=cfg.vocab_size, batch=n * LM_BATCH,
                             seq_len=seq_len, seed=0)
        tokens, labels = (torch.as_tensor(a, device=dev)
                          for a in stream.batch_at(steps))
        context = transformer.stub_context(cfg, n * LM_BATCH,
                                           tc.param_dtype, dev)  # train()'s

        def one_step():
            holder["state"], _ = step_fn(holder["state"], tokens, labels,
                                         context)

        busy, wall, top = _profile_busy(torch, one_step, 1)
        log(f"lm step device time {busy:.3f} ms of {wall:.3f} ms wall: "
            f"device busy share {busy / wall:.3f}; top kernels by device "
            f"time (ms per step): "
            + "; ".join(f"{k} {v:.3f} (x{c})" for k, v, c in top))

    # ---- 8b. the kernel on the run's own differential -------------------
    st = holder["state"]
    (dplane,) = st.d
    db = dplane.reshape(n, -1, 128)
    nb = db.shape[1]
    kb = math.ceil(0.2 * nb)
    key = prng.fold_in(prng.PRNGKey(0, device=dev), 0)   # bucket 0
    idx = sparsifier.fixedk_indices(
        gossip.node_round_key(key, transport.me, st.step), nb, kb
    ).to(torch.int32)
    scale = nb / kb
    got = fixedk_gather_pack(db, idx, scale=scale)
    want = fixedk_gather_pack_ref(db, idx, scale=scale)
    same = torch.equal(got, want)
    err = (got - want).abs().max().item()
    del got, want
    flat = db.reshape(n * nb, 128)
    gidx = (idx.long() + (torch.arange(n, device=dev) * nb)[:, None]
            ).reshape(-1)
    ker_ms, ker_host = cuda_ms(torch, lambda i: _fixedk_gather_pack_cuda(
        db, idx, scale=scale), iters=20)
    plain_ms, _ = cuda_ms(torch, lambda i: fixedk_gather_pack_ref(
        db, idx, scale=scale), iters=10)
    lib_ms, _ = cuda_ms(torch, lambda i: torch.index_select(flat, 0, gidx),
                        iters=20)
    nbytes = cost.fixedk_gather_pack(n, kb, 128).nbytes
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"fixedk_gather_pack on the run's final d, (L={n}, nb={nb}, kb={kb}, "
        f"block 128), step {st.step}: kernel == plain (torch.equal) {same}; "
        f"kernel {ker_ms * 1e3:.2f} us on the device ({ker_host * 1e3:.2f} us"
        f" per call on the host), plain {plain_ms * 1e3:.2f} us, "
        f"index_select (gather only, no scale; yardstick) "
        f"{lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({nbytes} "
        f"bytes, bytes); {nbytes / (ker_ms * 1e-3) / 1e12:.3f} TB/s achieved")
    if not same:
        failures.append("fixedk_gather_pack disagrees with its plain version "
                        "on the run's differential")
    out.update(ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes", library_ms=lib_ms,
               library="torch.index_select (gather only, no scale)",
               max_abs_err=float(err), host_ms_per_call=ker_host)
    if profile:
        lm_breakdown(torch, holder, mcfg, seq, transport,
                     float(ms[1:].mean()), one_step)
    return out


def lm_breakdown(torch, holder, mcfg, seq, transport, step_ms, whole,
                 reps=2):
    """Where an LM step's time goes: the executor's parts timed alone
    (host wall around synchronised calls) on the run's final state;
    gradients = the whole step less the two phases."""
    from repro_torch import prng, tree as tree_mod
    from repro_torch.core import sdm_dsgd

    st = holder["state"]
    grads = tree_mod.tree_map(torch.zeros_like, st.x)
    key = prng.PRNGKey(0, device=transport.device)
    kw = dict(base_key=key, transport=transport, cfg=mcfg, schedule=seq)
    noise_key = sdm_dsgd._node_noise_key(key, transport.me, st.step)
    parts = {
        "masked_grad (clip + threefry/erfinv noise, both nodes)": lambda:
            sdm_dsgd.masked_grad(grads, noise_key, sigma=mcfg.sigma,
                                 clip_c=mcfg.clip_c),
        "distributed_commit (incl. masked_grad, pack, mix)": lambda:
            sdm_dsgd.distributed_commit(st, grads, **kw),
        "distributed_advance (selection, kernel, exchange, unpack)": lambda:
            sdm_dsgd.distributed_advance(st, **kw),
    }
    parts_mem_only = {"whole step": whole}
    ms, peak = {}, {}
    for name, fn in {**parts, **parts_mem_only}.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
        if name in parts_mem_only:
            continue
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / reps * 1e3
    log("lm step parts' memory above the state (GB, peak of one call): "
        + "; ".join(f"{k} {v / 1e9:.3f}" for k, v in peak.items())
        + f"; state and zero gradients {base / 1e9:.3f} allocated")
    rest = step_ms - ms["distributed_commit (incl. masked_grad, pack, mix)"] \
        - ms["distributed_advance (selection, kernel, exchange, unpack)"]
    masked = ms["masked_grad (clip + threefry/erfinv noise, both nodes)"]
    log("lm step breakdown (ms, each part alone, synchronised): "
        + "; ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; gradients (2 nodes' forward + backward) and the rest = step "
        f"{step_ms:.3f} less advance and commit = {rest:.3f}; masked_grad "
        f"share of the step {masked / step_ms:.3f}")


# ---- slice 4: the fused update, prefill flash attention, kernel_bench and
# gradient-push (phases 11-15) ---------------------------------------------

# the LM slice's plane (gemma2-2b widths x LM_LAYERS) under realistic
# hyper-parameters (phase 10's: ring W_ii 1/3)
SDM_LM_KW = dict(p=0.2, theta=0.5, gamma=1e-3, sigma=1.0, clip_c=1e-4,
                 self_w=1.0 / 3.0)
# the plain version of the fused update runs over the plane in row chunks
SDM_CHUNK_ROWS = 32768
# the JAX kernel tests' tolerance, where a transcendental differs in its
# last bit (tests/test_kernels.py:42)
SDM_ATOL = 1e-6
# gemma2-2b's attention widths (configs/gemma2_2b.py, arXiv:2408.00118)
FLASH_B, FLASH_H, FLASH_KVH, FLASH_DH = 1, 8, 4, 256
FLASH_VARIANTS = (("global", dict(causal=True, softcap=50.0)),
                  ("local", dict(causal=True, window=4096, softcap=50.0)),
                  ("causal", dict(causal=True)))
BENCH_KERNELS = ("sdm_update", "flash_attn")
PUSH_STEPS, PUSH_EXEC_STEPS, PUSH_RESNET_STEPS = 100, 10, 10


def _sync(torch, dev) -> None:
    if dev != "cpu":
        torch.cuda.synchronize()


def _peak_gb(torch, dev) -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if dev != "cpu" else 0.0


def sdm_update_phase(torch, card):
    """Phase 11: the fused-update kernel against its plain version over
    the whole gemma2-2b x LM_LAYERS plane (880,167 rows of 1024), then
    its time, the plain version's (in row chunks) and the byte bound;
    then the tree wrapper on ResNet-20's tree, card against the CPU."""
    import dataclasses

    from repro_torch import configs, prng, tree as tree_mod
    from repro_torch.core.plane import ParamPlane, ShapeDtype
    from repro_torch.kernels.sdm_update import (LANE, sdm_update,
                                                sdm_update_planes,
                                                sdm_update_ref)
    from repro_torch.kernels.sdm_update.ops import _sdm_update_cuda
    from repro_torch.models import transformer, vision_small as vs

    cfg = dataclasses.replace(configs.get_config("gemma2-2b"),
                              n_layers=LM_LAYERS)
    template = transformer.unflatten({
        k: ShapeDtype(s, torch.bfloat16)
        for k, s in transformer.param_shapes(cfg).items()})
    plane = ParamPlane.for_tree(template, lane=LANE, row_multiple=1)
    rows = plane.buckets[0].rows
    n = rows * LANE
    nbytes = cost.sdm_update(n).nbytes   # 7 streams read, 3 written
    predicted = 10 * n * 4 + 12 * SDM_CHUNK_ROWS * LANE * 4
    log(f"sdm_update plane: gemma2-2b x {LM_LAYERS} layers, "
        f"{plane.total_size} params -> ({rows}, {LANE}) f32; predicted peak "
        f"{predicted / 1e9:.2f} GB = 7 inputs + 3 outputs "
        f"{10 * n * 4 / 1e9:.2f} GB + the plain version's chunk temporaries "
        f"({SDM_CHUNK_ROWS} rows) {12 * SDM_CHUNK_ROWS * LANE * 4 / 1e9:.2f}")
    gen = torch.Generator(device="cuda").manual_seed(11)
    base = torch.cuda.memory_allocated()

    def floats(scale):
        return torch.randn(rows, LANE, generator=gen, device="cuda").mul_(
            scale)

    def words():
        return torch.randint(-2**31, 2**31, (rows, LANE), dtype=torch.int32,
                             generator=gen, device="cuda")

    ops = (floats(0.02), floats(0.01), floats(0.01), floats(1e-3), words(),
           words(), words())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = sdm_update_planes(*ops, block_rows=1, **SDM_LM_KW)
    torch.cuda.synchronize()
    equal, err = True, 0.0
    for r0 in range(0, rows, SDM_CHUNK_ROWS):
        sl = slice(r0, r0 + SDM_CHUNK_ROWS)
        want = sdm_update_ref(*(t[sl] for t in ops), **SDM_LM_KW)
        for a, b in zip(got, want):
            if not torch.equal(a[sl], b):
                equal = False
                err = max(err, (a[sl] - b).abs().max().item())
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    peak = torch.cuda.max_memory_allocated()
    del got, want
    ker_ms, ker_host = cuda_ms(torch, lambda i: _sdm_update_cuda(
        *ops, **SDM_LM_KW), iters=10)

    def plain_pass(i):
        for r0 in range(0, rows, SDM_CHUNK_ROWS):
            sdm_update_ref(*(t[r0:r0 + SDM_CHUNK_ROWS] for t in ops),
                           **SDM_LM_KW)

    plain_ms, _ = cuda_ms(torch, plain_pass, iters=2, warmup=1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"sdm_update ({rows}, {LANE}) f32 on {card}: kernel == plain over the "
        f"whole plane (torch.equal) {equal}; max|kernel - plain| {err:.3e} "
        f"(atol {SDM_ATOL}); finite {finite}; peak memory {peak / 1e9:.3f} "
        f"GB (predicted {predicted / 1e9:.2f}; {base / 1e9:.3f} GB allocated "
        f"before the inputs); kernel {ker_ms:.3f} ms on "
        f"the device ({ker_host:.3f} ms per call on the host), plain (row "
        f"chunks) {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({nbytes} bytes, "
        f"bytes); {nbytes / (ker_ms * 1e-3) / 1e12:.3f} TB/s achieved; no "
        f"single PyTorch call computes this function (library: none)")
    del ops
    torch.cuda.empty_cache()
    if not (finite and (equal or err <= SDM_ATOL)):
        raise AssertionError("sdm_update disagrees with its plain version "
                             "over the LM plane")

    # the tree wrapper on ResNet-20's tree: the card against the CPU's
    # plain path, same key (the draws are the port's threefry on each)
    p0 = vs.resnet20_init(prng.PRNGKey(0))
    rng = torch.Generator().manual_seed(12)
    trees = [tree_mod.tree_map(lambda v: torch.randn(
        v.shape, generator=rng) * 0.05, p0) for _ in range(4)]
    n0 = sdm_update_planes.launches
    got = sdm_update(*(tree_mod.tree_map(lambda v: v.cuda(), t)
                       for t in trees), prng.PRNGKey(5), **SDM_LM_KW)
    launched = sdm_update_planes.launches - n0
    want = sdm_update(*trees, prng.PRNGKey(5), **SDM_LM_KW)
    leaves = [(a.cpu(), b) for gt, wt in zip(got, want)
              for a, b in zip(tree_mod.leaves(gt), tree_mod.leaves(wt))]
    tree_equal = all(torch.equal(a, b) for a, b in leaves)
    tree_err = max((a - b).abs().max().item() for a, b in leaves)
    n_params = sum(v.numel() for v in tree_mod.leaves(p0))
    log(f"sdm_update tree wrapper, ResNet-20 tree ({n_params} params, "
        f"{len(tree_mod.leaves(p0))} leaves): card (kernel) vs CPU (plain) "
        f"torch.equal {tree_equal}, max diff {tree_err:.3e}; launches "
        f"{launched}")
    if launched != 1 or not (tree_equal or tree_err <= SDM_ATOL):
        raise AssertionError("sdm_update's tree wrapper disagrees between "
                             "the card and the CPU")
    return dict(ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, max_abs_err=float(err),
                bit_equal=bool(equal), tree_card_vs_cpu_max_diff=tree_err,
                host_ms_per_call=ker_host, peak_gb=peak / 1e9)


def flash_bound(s, window, elt_bytes):
    """(ms, bound_by, flops, bytes) of one causal prefill call at
    gemma2-2b's widths (``cost.flash_attn``: 4 dh flops per visible pair
    against q, k, v and out moved once)."""
    c = cost.flash_attn(FLASH_B, s, s, FLASH_H, FLASH_KVH, FLASH_DH,
                        causal=True, window=window, elt_bytes=elt_bytes)
    return cost.bound(c, elt_bytes) + (c.flops, c.nbytes)


def flash_phase(torch, card):
    """Phase 12: the prefill flash kernel against its plain version at
    gemma2-2b's attention widths (b 1, h 8, kvh 4, dh 256), s 4096 and
    8192, bf16 and f32, global / local (window 4096) / plain causal; its
    time, the plain version's and the bound; for plain causal, SDPA's."""
    import math

    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn.ops import (_flash_cuda,
                                                    flash_attention)
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows, failures = [], []
    for s in (4096, 8192):
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)

            def t(heads):
                return torch.randn(FLASH_B, s, heads, FLASH_DH,
                                   generator=gen, device="cuda").to(dtype)

            q, k, v = t(FLASH_H), t(FLASH_KVH), t(FLASH_KVH)
            for name, kw in FLASH_VARIANTS:
                got = flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                want = flash_attention_ref(q, k, v, **kw).float()
                diff = (got.float() - want).abs()
                err = diff.max().item()
                row_rel = (diff.amax(-1) / want.abs().amax(-1).clamp_min(
                    1e-30)).max().item()
                del got, want, diff
                kw_all = dict(dict(window=None, softcap=None), **kw)
                ker_ms, _ = cuda_ms(torch, lambda i: _flash_cuda(
                    q, k, v, **kw_all), iters=5, warmup=1)
                plain_ms, _ = cuda_ms(torch, lambda i: flash_attention_ref(
                    q, k, v, **kw), iters=3, warmup=1)
                lib_ms = None
                if name == "causal":
                    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                    lib_ms, _ = cuda_ms(
                        torch, lambda i: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True,
                            scale=1.0 / math.sqrt(FLASH_DH)), iters=5,
                        warmup=1)
                bound_ms, bound_by, flops, nbytes = flash_bound(
                    s, kw.get("window"), 2 if dt == "bfloat16" else 4)
                ok = err <= KERNEL_ATOL[dt] and row_rel <= FLASH_ROW_RTOL[dt]
                log(f"flash_attn {name} s={s} {dt} (b {FLASH_B}, h {FLASH_H},"
                    f" kvh {FLASH_KVH}, dh {FLASH_DH}) on {card}: "
                    f"max|kernel - plain| {err:.3e} (atol {KERNEL_ATOL[dt]}),"
                    f" max over rows of max|kernel - plain| / max|plain| "
                    f"{row_rel:.3e} (rtol {FLASH_ROW_RTOL[dt]:.3e}) "
                    f"ok {ok}; kernel {ker_ms:.3f} ms, plain {plain_ms:.3f} "
                    f"ms, bound {bound_ms:.4f} ms ({flops:.4e} flops, "
                    f"{nbytes} bytes, {bound_by})"
                    + (f", sdpa (library, yardstick only) {lib_ms:.3f} ms"
                       if lib_ms is not None else "")
                    + f"; {flops / (ker_ms * 1e-3) / 1e12:.2f} TFLOP/s")
                rows.append(dict(variant=name, s=s, dtype=dt, ms=ker_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=lib_ms,
                                 max_abs_err=err, max_row_rel_err=row_rel,
                                 flops=flops))
                if not ok:
                    failures.append(f"{name}/s{s}/{dt}")
            del q, k, v
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"flash_attn disagrees with its plain version: "
                             f"{failures}")
    # the table's row: plain causal, s 8192, bf16 (SDPA computes the same)
    head = next(r for r in rows if (r["variant"], r["s"], r["dtype"])
                == ("causal", 8192, "bfloat16"))
    return dict(head, variants=rows, **{
        f"{key}_{dt}": max(r[key] for r in rows if r["dtype"] == dt)
        for key in ("max_abs_err", "max_row_rel_err")
        for dt in ("bfloat16", "float32")})


def kernel_bench_phase(torch, kernels):
    """Phase 13, this slice's main path: ``repro_torch.bench.kernel_bench``
    end to end at its JAX default shapes; every line must print, and the
    fused-update and flash kernels must launch in this run. Then each
    kernel against its plain version on the very tensors the bench timed
    (sdm_update (64, 1024) at block_rows 32; flash (1, 256, 4, 64) f32,
    causal): launches made to compare are not counted."""
    import contextlib
    import io

    from repro_torch.bench import kernel_bench
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.kernels.sdm_update import (sdm_update_planes,
                                                sdm_update_ref)

    for _, wrapper in kernels.values():
        wrapper.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        timed = kernel_bench.run(device="cuda")
    torch.cuda.synchronize()
    launched = {k: w.launches for k, (_, w) in kernels.items()
                if k in BENCH_KERNELS}

    ops, kw = timed["sdm_update"]
    got = sdm_update_planes(*ops, **kw)
    plain = sdm_update_ref(*ops, **{k: v for k, v in kw.items()
                                    if k != "block_rows"})
    sdm_equal = all(torch.equal(a, b) for a, b in zip(got, plain))
    sdm_err = max((a - b).abs().max().item() for a, b in zip(got, plain))
    q, k, v = timed["flash_attn"]
    fl_err = (flash_attention(q, k, v) - flash_attention_ref(q, k, v)
              ).abs().max().item()
    torch.cuda.synchronize()
    log(f"kernel_bench's own inputs: sdm_update {tuple(ops[0].shape)} "
        f"block_rows {kw['block_rows']} kernel == plain (torch.equal) "
        f"{sdm_equal}, max|kernel - plain| {sdm_err:.3e} (atol {SDM_ATOL}); "
        f"flash_attn {tuple(q.shape)} {q.dtype} causal max|kernel - plain| "
        f"{fl_err:.3e} (atol {KERNEL_ATOL['float32']})")
    if not (sdm_equal or sdm_err <= SDM_ATOL) \
            or not fl_err <= KERNEL_ATOL["float32"]:
        raise AssertionError("a kernel disagrees with its plain version on "
                             "kernel_bench's inputs")
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  kernel_bench: {line}")
    names = [line.split(",", 1)[0] for line in lines]
    want = len(kernel_bench.GOSSIP_TOPOLOGIES) + 4
    log(f"kernel_bench: {len(lines)} lines (expected {want}); launches "
        f"{launched}")
    if len(lines) != want or names[-4:] != [
            "sdm_update_plain", "sdm_update_cuda", "flash_attn_plain",
            "flash_attn_cuda"]:
        raise AssertionError("kernel_bench did not print every line")
    missing = [k for k, n in launched.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the kernel_bench "
                             f"path: {missing}")
    return launched, {"sdm_update": sdm_err, "flash_attn": fl_err}


def push_mlr_phase(torch, np, card, dev="cuda"):
    """Phase 14: gradient-push on the paper's MLR test bed, 50 nodes on
    der:0.35. For fixed-k (p 0.2), qsgdf:4 and qsgdf:8: PUSH_EXEC_STEPS
    steps of the per-node executor on a StackTransport against the
    reference (noise-free, as the parity sweep), with its ppermute and
    byte counters; pure gossip (the JAX sweep's conservation probe), whose
    sum x / sum w must stay the initial mean. For fixed-k and qsgdf:8:
    PUSH_STEPS steps through ``run_decentralized``. qsgdf:4 trains
    through it only PUSH_EXEC_STEPS steps: 4-bit QSGD is not contractive
    at this plane's d = 7,936 (variance factor sqrt(d)/7 = 12.7), so the
    compressed push-sum residual grows every step and the loss reaches
    NaN near step 90, in the JAX package as in the port."""
    from repro_torch import prng, tree as tree_mod
    from repro_torch.bench.common import make_mlr_testbed
    from repro_torch.core import (PrivacyParams, gossip, method,
                                  transport as tr, wire_count)
    from repro_torch.core.gradient_push import GradientPushConfig, _debias
    from repro_torch.kernels.wire_compress import qsgd_pack
    from repro_torch.train.trainer import run_decentralized

    meth = method.get("gradient-push")
    failures = []
    for comp in ("fixedk", "qsgdf:4", "qsgdf:8"):
        topo, stack, grad_fn, eval_fn, batches, m_local = make_mlr_testbed(
            topology_spec="der:0.35", device=dev)
        seq = gossip.sequence_of(topo)
        n = seq.n_nodes
        cfg = GradientPushConfig(gamma=0.01, sigma=1.0, clip_c=5.0,
                                 compressor=comp, p=0.2)
        per_node = tree_mod.tree_map(lambda v: v[0], stack)
        bits = method.transmitted_bits(meth, per_node, cfg, seq=seq)
        steps = PUSH_EXEC_STEPS if comp == "qsgdf:4" else PUSH_STEPS
        q0 = qsgd_pack.launches
        res = run_decentralized(
            topo=topo, algorithm="gradient-push", sdm_cfg=cfg,
            params_stack=stack, grad_fn=grad_fn, batches=batches,
            steps=steps, seed=0, eval_fn=eval_fn, eval_every=50,
            privacy=PrivacyParams.from_compressor(
                cfg.make_compressor(), G=5.0, m=m_local, tau=16 / m_local,
                sigma=cfg.sigma), device=dev)
        _sync(torch, dev)
        ms = np.asarray(res.step_s) * 1e3
        finite = bool(np.all(np.isfinite(res.losses)))
        log(f"gradient-push MLR 784->10 {seq.name} n={n}, {comp} p 0.2, "
            f"gamma 0.01 sigma 1, {steps} steps on {card}: step ms mean "
            f"{ms.mean():.3f} p50 {np.percentile(ms, 50):.3f} (steps 2.. "
            f"{ms[1:].mean():.3f}); losses "
            f"{[round(v, 4) for v in res.losses[::10]]} -> "
            f"{res.losses[-1]:.5f} finite {finite}; eval acc "
            f"{res.eval_accuracy}; eps {res.epsilons[-1]:.6e}; comm_bits[-1] "
            f"{res.comm_bits[-1]} = {steps} x {n} x {bits}; qsgd_pack "
            f"launches {qsgd_pack.launches - q0}")
        if not (finite and res.comm_bits[-1] == steps * n * bits):
            failures.append(f"trainer/{comp}")

        # the per-node executor against the reference, noise-free
        cfg0 = GradientPushConfig(gamma=0.05, sigma=0.0, clip_c=5.0,
                                  compressor=comp, p=0.2)
        _, stack, grad_fn, _, batches, _ = make_mlr_testbed(
            topology_spec="der:0.35", device=dev)
        data = [tuple(torch.as_tensor(v, device=dev)
                      for v in next(batches)) for _ in range(PUSH_EXEC_STEPS)]
        transport = tr.StackTransport(n, dev)
        ex = meth.make_distributed(seq, cfg0, transport)
        state = ex.init(stack)
        sim = meth.make_reference(seq, cfg0)
        ref = sim.init(tree_mod.tree_map(torch.clone, stack))
        key = prng.PRNGKey(42, device=dev)
        for t in range(PUSH_EXEC_STEPS):
            state, _ = ex.step(state, lambda z: grad_fn(z, data[t]),
                               base_key=key)
            ref, _ = sim.step(ref, grad_fn, data[t], key)
        _sync(torch, dev)
        got = tree_mod.leaves(_debias(state.x, state.w))
        want = tree_mod.leaves(sim.eval_params(ref))
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        scale = max(b.abs().max().item() for b in want)
        tol = 1e-3 if "qsgd" in comp else 1e-4
        mode = wire_count.mode_of(meth.name, cfg0)
        calls = PUSH_EXEC_STEPS * wire_count.expected_permutes(meth.name,
                                                               mode, seq)
        expected = wire_count.expected_bytes_sent(meth, per_node, cfg0, seq,
                                                  PUSH_EXEC_STEPS)
        acct = {i: PUSH_EXEC_STEPS * meth.transmitted_bits_fn(
            per_node, cfg0, seq=seq, node=i) // 8 for i in range(n)}
        mass = abs(state.w.sum().item() - n)
        ok = (err <= tol * max(scale, 1.0) and transport.permutes == calls
              and transport.bytes_sent == expected and mass <= 1e-3
              # with no explicit indices the wire is the accounting's
              and (comp == "fixedk" or transport.bytes_sent == acct))
        log(f"gradient-push executor vs reference on the card, {comp}, "
            f"{PUSH_EXEC_STEPS} steps: max|z_exec - z_ref| {err:.3e} (scale "
            f"{scale:.3e}, tol {tol} x max(scale, 1)); ppermute calls "
            f"{transport.permutes} == {PUSH_EXEC_STEPS} x expected_permutes "
            f"{calls // PUSH_EXEC_STEPS}; bytes sent per node (min, max) "
            f"{min(transport.bytes_sent.values())}, "
            f"{max(transport.bytes_sent.values())} == expected_bytes_sent "
            f"{transport.bytes_sent == expected}; {PUSH_EXEC_STEPS} x "
            f"transmitted_bits_per_step / 8 (min, max) {min(acct.values())},"
            f" {max(acct.values())} (explicit indices ship as int32, the "
            f"accounting charges ceil(log2 d) bits each); |sum w - n| "
            f"{mass:.2e}; ok {ok}")
        if not ok:
            failures.append(f"executor/{comp}")

        # pure gossip (method_parity_check.push_conservation_probe's
        # setup: (n, 6) values, p 0.4, 200 steps): sum x / sum w stays the
        # initial mean, the de-biased estimates reach it
        cfg_g = GradientPushConfig(gamma=0.0, sigma=0.0, compressor=comp,
                                   p=0.4)
        sim = meth.make_reference(seq, cfg_g)
        gen = torch.Generator(device=dev).manual_seed(14)
        st = sim.init({"w": torch.randn(n, 6, generator=gen, device=dev)})
        mean0 = st.x["w"].mean(dim=0)
        zero = lambda p, _b: (tree_mod.tree_map(torch.zeros_like, p), 0.0)
        key, mass_err = prng.PRNGKey(0, device=dev), 0.0
        for _ in range(200):
            key, sub = prng.split(key)
            st, _ = sim.step(st, zero, None, sub)
            mass_err = max(mass_err, (sim.consensus(st)["w"] - mean0)
                           .abs().max().item())
        z_err = (sim.eval_params(st)["w"] - mean0).abs().max().item()
        log(f"gradient-push pure gossip {comp} p 0.4, 200 steps: max|sum x / "
            f"sum w - mean_0| {mass_err:.3e} (limit 1e-4); max|z - mean_0| "
            f"{z_err:.3e} (limit 0.05)")
        if mass_err > 1e-4 or z_err > 0.05:
            failures.append(f"mass/{comp}")
    return failures


def push_resnet_phase(torch, np, card, dev="cuda"):
    """Phase 15: gradient-push, ResNet-20 (CIFAR-shaped) x 50 nodes on
    der:0.35 with the qsgdf:4 wire, PUSH_RESNET_STEPS steps: finite
    losses, step time, and qsgd_pack launched once per step per bucket."""
    from repro_torch import prng, tree as tree_mod
    from repro_torch.core import gossip
    from repro_torch.core.gradient_push import GradientPushConfig
    from repro_torch.core.plane import ParamPlane
    from repro_torch.data import (classification_dataset,
                                  node_partitioned_batches)
    from repro_torch.kernels.wire_compress import qsgd_pack
    from repro_torch.models import vision_small as vs
    from repro_torch.train.trainer import run_decentralized

    n, steps = 50, PUSH_RESNET_STEPS
    seq = gossip.sequence_by_name("der:0.35", n, seed=0)
    (x_tr, y_tr), _ = classification_dataset(3072, 10, 10_000, 10, seed=0)
    p0 = vs.resnet20_init(prng.PRNGKey(0, device=dev))
    stack = tree_mod.tree_map(
        lambda p: p[None].expand((n,) + tuple(p.shape)).clone(), p0)
    cfg = GradientPushConfig(gamma=0.05, sigma=1.0, clip_c=5.0,
                             compressor="qsgdf:4", p=0.2)
    buckets = ParamPlane.for_tree(p0).n_buckets
    _sync(torch, dev)
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    qsgd_pack.launches = 0
    res = run_decentralized(
        topo=seq, algorithm="gradient-push", sdm_cfg=cfg,
        params_stack=stack, grad_fn=vs.make_stacked_grad_fn(vs.resnet20_apply),
        batches=node_partitioned_batches(x_tr, y_tr, n, 16, seed=0),
        steps=steps, seed=0, device=dev)
    _sync(torch, dev)
    launched = qsgd_pack.launches
    ms = np.asarray(res.step_s) * 1e3
    finite = bool(np.all(np.isfinite(res.losses)))
    log(f"gradient-push ResNet-20 {seq.name} n={n}, qsgdf:4, sigma 1, "
        f"{steps} steps on {card}: step ms mean {ms.mean():.3f} p50 "
        f"{np.percentile(ms, 50):.3f} (steps 2.. {ms[1:].mean():.3f}); "
        f"{n * 16 / (ms[1:].mean() / 1e3):.1f} examples/s over steps 2..; "
        f"peak memory {_peak_gb(torch, dev):.3f} GB; "
        f"losses {[round(v, 5) for v in res.losses]} finite {finite}; "
        f"qsgd_pack launches {launched} (predicted steps x buckets = "
        f"{steps * buckets})")
    if not finite or launched != steps * buckets:
        raise AssertionError("gradient-push ResNet-20 run failed")


# ---- slice 6: the paper's experiments and the edge-fleet simulator
# (phases 16-17) -------------------------------------------------------------

# the simulator's MLR and ResNet-20 cells: rounds per scenario / run
SIM_MLR_ROUNDS, SIM_RESNET_ROUNDS, SIM_LM_ROUNDS = 30, 10, 3


@contextlib.contextmanager
def phase_clock(torch, label: str, card: str):
    """Log a part's wall seconds and peak device memory, with the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    yield
    torch.cuda.synchronize()
    log(f"{label}: {time.monotonic() - t0:.3f} s wall, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}")


def _quiet(fn, **kw):
    """(fn(**kw), its stdout lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(**kw)
    return out, buf.getvalue().strip().splitlines()


def _step_ms(np, step_s) -> str:
    ms = np.asarray(step_s) * 1e3
    rest = ms[1:] if len(ms) > 1 else ms
    return (f"{len(ms)} steps, step ms mean {ms.mean():.3f} (first "
            f"{ms[0]:.3f}; steps 2.. {rest.mean():.3f})")


def _claims(name: str, claims) -> None:
    log(f"  {name} claims: " + ", ".join(
        f"{k} {'held' if v else 'NOT held'}" for k, v in claims.items()))


# table1's step cap on the card (the script's default is 1500)
TABLE1_MAX_STEPS = 150


def paper_phase(torch, np, card):
    """Phase 16: the paper's experiments on the card at its 50 nodes
    (MLR 784 -> 10 on ER(0.35), batch 16 a node), each script with
    ``check=False``: its claims are printed, not gated on (the JAX
    reference fails two of them too). Gated: finite losses, fig2's two
    flags, fig3's exact wire bits, table1's sigma / T against the port's
    f64 theory and its epsilons against the host accountant."""
    import math

    from repro_torch.bench import (common, fig2_divergence,
                                   fig3_comm_efficiency,
                                   table1_privacy_accuracy, theory_tradeoff)
    from repro_torch.core import privacy
    from repro_torch.examples import privacy_sweep

    with phase_clock(torch, "phase 16 theory + privacy sweep", card):
        th, lines = _quiet(theory_tradeoff.run, device="cuda", check=False)
        _, sweep = _quiet(privacy_sweep.main)
    for line in lines + sweep:
        log(f"  {line}")
    _claims("theory", th.claims)

    with phase_clock(torch, "phase 16 fig2 (250 steps x 2 runs)", card):
        f2, lines = _quiet(fig2_divergence.run, device="cuda", check=False)
    log(f"  {lines[-1]}")
    for key, losses in f2.data.items():
        log(f"  fig2 {key}: {_step_ms(np, f2.details['step_s'][key])}; "
            f"losses[0] {losses[0]:.6f} losses[-1] {losses[-1]:.6e}")
    _claims("fig2", f2.claims)
    if not all(np.isfinite(v).all() for v in f2.data.values()):
        raise AssertionError("fig2: a loss is not finite")
    if not (f2.claims["dc_diverged"] and f2.claims["sdm_converged"]):
        raise AssertionError("fig2: DC-DSGD must diverge and SDM-DSGD "
                             "converge, as in the JAX run")

    with phase_clock(torch, "phase 16 fig3 (default budget)", card):
        f3, lines = _quiet(fig3_comm_efficiency.run, device="cuda",
                           check=False)
    log(f"  {lines[-1]}")
    for key, (elems, bits, losses, accs) in f3.data.items():
        d = f3.details[key]
        exact = bits == [(t + 1) * d["per_step_bits"]
                         for t in range(d["steps"])]
        log(f"  fig3 {key}: {_step_ms(np, d['step_s'])}; comm_bits[-1] "
            f"{bits[-1]} == {d['steps']} x {d['per_step_bits']}: {exact}; "
            f"acc {accs}")
        if not exact:
            raise AssertionError(f"fig3 {key}: comm_bits != steps x "
                                 f"transmitted bits")
        if not np.isfinite(losses).all():
            raise AssertionError(f"fig3 {key}: a loss is not finite")
    _claims("fig3", f3.claims)

    with phase_clock(torch, f"phase 16 table1 (3 eps x 3 methods, "
                     f"max_steps {TABLE1_MAX_STEPS})", card):
        t1, lines = _quiet(table1_privacy_accuracy.run, device="cuda",
                           check=False, max_steps=TABLE1_MAX_STEPS)
    log(f"  {lines[-1]}")
    log(f"  table1 max_steps: {TABLE1_MAX_STEPS}, cut from the script's "
        f"1500 (Theorem 4's T_max caps the runs at or below 868 steps); "
        f"sigma follows the cut T")
    m = 5000 // common.N_NODES
    for (eps, name), d in t1.details.items():
        _, p, _ = table1_privacy_accuracy.METHODS[name]
        t_want = min(privacy.max_iterations(
            G=table1_privacy_accuracy.G_CLIP, m=m, p=p, eps=eps,
            delta=table1_privacy_accuracy.DELTA), TABLE1_MAX_STEPS)
        s_want = privacy.sigma_for_budget(
            G=table1_privacy_accuracy.G_CLIP, m=m, p=p, T=t_want, eps=eps,
            delta=table1_privacy_accuracy.DELTA, clamp=True)
        acct = privacy.PrivacyAccountant(privacy.PrivacyParams(
            G=table1_privacy_accuracy.G_CLIP, m=m,
            tau=common.BATCH_PER_NODE / m, p=p, sigma=s_want,
            delta=table1_privacy_accuracy.DELTA), eps)
        want = []
        for _ in range(t_want):
            acct.step()
            want.append(acct.epsilon)
        eps_ok = d["epsilons"] == want and all(
            b >= a for a, b in zip(want, want[1:]))
        finite = math.isfinite(want[-1])
        log(f"  table1 eps {eps} {name}: sigma {d['sigma']!r} T {d['steps']} "
            f"(host f64 theory {s_want!r}, {t_want}); "
            f"{_step_ms(np, d['step_s'])}; acc {t1.data[(eps, name)]:.4f}; "
            f"accountant eps[-1] {d['epsilons'][-1]} (host accountant step "
            f"for step: {eps_ok}; finite {finite}: sigma^2 = "
            f"{s_want ** 2!r} vs 1/1.25)")
        if (d["sigma"], d["steps"]) != (s_want, t_want) or not eps_ok:
            raise AssertionError(f"table1 eps {eps} {name}: sigma / T / "
                                 f"epsilons differ from the host theory")
        if finite != (s_want ** 2 >= 1 / 1.25):
            raise AssertionError("table1: accountant finiteness does not "
                                 "follow sigma^2 >= 1/1.25")
        if not np.isfinite(d["losses"]).all():
            raise AssertionError(f"table1 eps {eps} {name}: a loss is not "
                                 f"finite")
    _claims("table1", t1.claims)


def _check_sim(np, res, label: str, deadline=None) -> None:
    """The simulator's own gates on one run."""
    r = res.result
    times = r.sim_time_s
    ok = (len(times) == res.rounds
          and all(b >= a for a, b in zip(times, times[1:]))
          and res.sim_seconds == times[-1]
          and not np.isnan(r.losses).any())
    if deadline is not None:
        ok = ok and res.sim_seconds <= res.rounds * deadline + 1e-9
    if not ok:
        raise AssertionError(f"{label}: simulated clock, deadline bound or "
                             f"losses out of order")


def sim_phase(torch, np, card):
    """Phase 17: the edge-fleet simulator on the card. ``bench.sim_edge``
    at its own sizes; ``simulate`` on the 50-node MLR test bed under the
    four scenarios (dropout and churn give time-varying sequences, the
    reference's replica path) twice each, and once on the CPU; ResNet-20
    x 50 with the qsgdf:4 wire under stragglers (qsgd_pack once a round);
    gemma2-2b at full width through ``launch.train.simulate_lm``.
    Returns qsgd_pack's launches in the ResNet-20 run."""
    import dataclasses
    import os
    import tempfile

    from repro_torch import configs, prng, tree as tree_mod
    from repro_torch.bench import common, sim_edge
    from repro_torch.core import SDMConfig, sdm_dsgd, theory, topology
    from repro_torch.core.plane import ParamPlane
    from repro_torch.data import (classification_dataset,
                                  node_partitioned_batches)
    from repro_torch.kernels.wire_compress import qsgd_pack
    from repro_torch.launch.train import simulate_lm
    from repro_torch.models import vision_small as vs
    from repro_torch.sim import SCENARIOS, simulate

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, sim_edge.OUT_PATH)
        with phase_clock(torch, f"phase 17 sim_edge ({len(sim_edge.METHODS)} "
                         f"methods x {len(SCENARIOS)} scenarios, "
                         f"{sim_edge.N_NODES} nodes, {sim_edge.ROUNDS} rounds)",
                         card):
            report, lines = _quiet(sim_edge.run, out_path=out,
                                   device="cuda")
        written = json.loads(Path(out).read_text())
    for line in lines:
        log(f"  {line}")
    bad = [c for c in report["cases"] if not np.isfinite(c["final_loss"])]
    if bad or written != report:
        raise AssertionError(f"sim_edge: non-finite losses {bad} or the "
                             f"report file differs")

    # the paper's test bed under each scenario: fig2's SDM-DSGD (converges
    # on this test bed; sigma 0, so no privacy accounting)
    lambda_n = topology.by_name("er:0.35", common.N_NODES, seed=0).lambda_n
    cfg = SDMConfig(p=0.2, theta=min(0.55, 0.9 * theory.theta_upper_bound(
        0.2, lambda_n, 0.05, 1.0)), gamma=0.05)

    def mlr(scenario, dev):
        topo, stack, grad_fn, _, batches, _ = common.make_mlr_testbed(
            device=dev)
        return simulate(topo=topo, algorithm="sdm-dsgd", sdm_cfg=cfg,
                        params_stack=stack, grad_fn=grad_fn, batches=batches,
                        rounds=SIM_MLR_ROUNDS, scenario=scenario, seed=0,
                        device=dev)

    for scenario in sorted(SCENARIOS):
        with phase_clock(torch, f"phase 17 simulate MLR x 50 {scenario} "
                         f"({SIM_MLR_ROUNDS} rounds, twice)", card):
            a, b = mlr(scenario, "cuda"), mlr(scenario, "cuda")
        r = a.result
        same = a.trace_signature == b.trace_signature
        log(f"  {scenario}: {_step_ms(np, r.step_s)}; t_sim "
            f"{a.sim_seconds:.6f} s; stragglers {a.straggler_rounds} "
            f"dropouts {a.dropout_rounds} recompiles {a.recompiles}; "
            f"wire_bits {r.comm_bits[-1]}; "
            f"losses[0] {r.losses[0]:.6f} [-1] {r.losses[-1]:.6f}; "
            f"{len(a.trace)} events; replay: same trace {same}, same "
            f"losses {r.losses == b.result.losses}")
        _check_sim(np, a, f"MLR {scenario}", SCENARIOS[scenario].deadline)
        if not same:
            raise AssertionError(f"MLR {scenario}: the same (seed, scenario) "
                                 f"did not replay")
        if scenario == "dropout":
            host = mlr(scenario, "cpu")
            gap = np.abs(np.asarray(r.losses) - host.result.losses) \
                / np.abs(host.result.losses)
            log(f"  dropout card vs host CPU (port): same trace "
                f"{host.trace_signature == a.trace_signature}; max relative "
                f"loss gap {gap.max():.3e} (limit {CPU_LOSS_RTOL})")
            if host.trace_signature != a.trace_signature \
                    or gap.max() > CPU_LOSS_RTOL:
                raise AssertionError("the card's simulated run departs from "
                                     "the CPU run")
        del a, b

    # ResNet-20 x 50, ER(0.35), qsgdf:4 with phase 6's config, stragglers
    n = 50
    rcfg = SDMConfig(p=0.2, theta=0.25, gamma=0.05, sigma=1.0, clip_c=5.0,
                     compressor="qsgdf:4")
    (x_tr, y_tr), _ = classification_dataset(3072, 10, 10_000, 10, seed=0)
    p0 = vs.resnet20_init(prng.PRNGKey(0, device="cuda"))
    stack = tree_mod.tree_map(
        lambda p: p[None].expand((n,) + tuple(p.shape)).clone(), p0)
    buckets = ParamPlane.for_tree(p0).n_buckets
    edge_bits = sdm_dsgd.transmitted_bits_per_step(p0, rcfg)
    qsgd_pack.launches = 0
    with phase_clock(torch, f"phase 17 simulate ResNet-20 x {n} straggler "
                     f"({SIM_RESNET_ROUNDS} rounds)", card):
        res = simulate(topo="er:0.35", algorithm="sdm-dsgd", sdm_cfg=rcfg,
                       params_stack=stack,
                       grad_fn=vs.make_stacked_grad_fn(vs.resnet20_apply),
                       batches=node_partitioned_batches(x_tr, y_tr, n, 16,
                                                        seed=0),
                       rounds=SIM_RESNET_ROUNDS, scenario="straggler",
                       seed=0, device="cuda")
    launched = qsgd_pack.launches
    r = res.result
    log(f"  resnet20 straggler: {_step_ms(np, r.step_s)}; t_sim "
        f"{res.sim_seconds:.6f} s (bound {SIM_RESNET_ROUNDS} x 0.6); "
        f"stragglers {res.straggler_rounds} of {n * SIM_RESNET_ROUNDS} "
        f"node-rounds (qsgdf:4 payload {edge_bits} bits an edge); "
        f"wire_bits {r.comm_bits[-1]}; losses "
        f"{[round(v, 5) for v in r.losses]}; qsgd_pack launches {launched} "
        f"(rounds x buckets = {SIM_RESNET_ROUNDS * buckets})")
    _check_sim(np, res, "ResNet-20 straggler", SCENARIOS["straggler"].deadline)
    if launched != SIM_RESNET_ROUNDS * buckets:
        raise AssertionError("qsgd_pack did not launch once per simulated "
                             "round")
    del stack, res, r
    gc.collect()
    torch.cuda.empty_cache()

    # gemma2-2b at full width, phase 10's cut, the launcher's --sim
    # defaults (sdm-dsgd, bernoulli p 0.2, theta 0.5, gamma 1e-2, sigma 0)
    base = configs.get_config("gemma2-2b")
    lcfg = dataclasses.replace(base, n_layers=LM_LAYERS)
    sdm = SDMConfig(p=0.2, theta=0.5, gamma=1e-2, sigma=0.0)
    with phase_clock(torch, f"phase 17 launch.train --sim straggler "
                     f"gemma2-2b x {LM_LAYERS} layers, {LM_NODES} nodes, seq "
                     f"{LM_SEQ}, batch {LM_BATCH}/node, {SIM_LM_ROUNDS} "
                     f"rounds, f32", card):
        res = simulate_lm(lcfg, sdm, "sdm-dsgd", LM_NODES,
                          batch=LM_NODES * LM_BATCH, seq_len=LM_SEQ,
                          rounds=SIM_LM_ROUNDS, scenario="straggler",
                          device="cuda")
    r = res.result
    for t in range(len(r.losses)):
        log(f"  round {t:4d} t_sim {r.sim_time_s[t]:9.3f}s loss "
            f"{r.losses[t]:.4f} wire_bits {r.comm_bits[t]} "
            f"({r.step_s[t] * 1e3:.1f} ms)")
    log(f"  sim done: rounds={res.rounds} t_sim={res.sim_seconds:.3f}s "
        f"stragglers={res.straggler_rounds} dropouts={res.dropout_rounds} "
        f"recompiles={res.recompiles} events={len(res.trace)}; depth "
        f"{base.n_layers} -> {lcfg.n_layers} layers")
    _check_sim(np, res, "LM straggler", SCENARIOS["straggler"].deadline)
    del res, r
    gc.collect()
    torch.cuda.empty_cache()
    return launched


# ---- the serving helpers of phases 3, 4 and 19 ------------------------------

def attn_layers(cfg) -> int:
    """Attention layers of ``cfg``: paged-decode launches per decode step."""
    return sum(s.mixer in ("attn", "attn_local") for s in cfg.period) \
        * cfg.n_periods


def init_model(torch, np, cfg, *, seed, dtype, reduced=None):
    """Seeded ``init_params`` on the card, logged with its size."""
    from repro_torch.models import transformer

    t0 = time.monotonic()
    params = transformer.init_params(cfg, seed=seed, dtype=dtype,
                                     device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(s)) for s in transformer.param_shapes(cfg)
                   .values())
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads, head_dim "
        f"{cfg.resolved_head_dim}, {n_params / 1e9:.3f} B params in "
        f"{str(dtype).split('.')[-1]}, init {time.monotonic() - t0:.1f} s"
        + (f"; reduced: {reduced}" if reduced else ""))
    return params


def serve_ragged(torch, np, cfg, params, card, kernels, *, n_requests=16,
                 max_new=32, max_batch=8, ker_ms=None, prompt_max=1024,
                 prompt_min=64, context=None):
    """Serve ``n_requests`` prompts of ``prompt_min``-``prompt_max``
    tokens (lengths and tokens from ``default_rng(0)``), ``max_new`` new
    tokens each, through ``ServingEngine`` (bf16, page 16; ``context``
    for the encoder families) after a warm-up serve. Every kernel count
    is set to 0 just before and read just after. Checks: each request
    returns ``max_new`` valid tokens, and the paged kernel launched
    ``decode_steps x`` attention layers (an attention-free model
    launches it 0 times). Returns the serving kernels' launches."""
    from repro_torch.serving import Request, ServingEngine

    max_seq = prompt_max + max_new
    engine = ServingEngine(cfg, params, max_batch=max_batch, max_seq=max_seq,
                           page_size=16, dtype=torch.bfloat16)
    engine.serve([Request(prompt=list(range(1, 65)), max_new_tokens=2)],
                 context=context)
    torch.cuda.synchronize()            # warm-up (cuBLAS handles etc.)

    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(prompt_min, prompt_max + 1, n_requests)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=max_new) for n in prompt_lens]
    torch.cuda.reset_peak_memory_stats()
    for _, wrapper in kernels.values():
        wrapper.launches = 0
    engine.serve(reqs, context=context)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, (_, w) in kernels.items()
                if k in SERVE_KERNELS}
    stats = engine.last_stats
    n_attn = attn_layers(cfg)
    steps_ms = np.asarray(stats.step_wall_s) * 1e3
    ttft_ms = np.asarray(stats.ttft_s) * 1e3
    share = "" if ker_ms is None else (
        f"; the {n_attn} paged-decode calls at {ker_ms * 1e3:.2f} us each "
        f"(timed alone at the serving shape) take {n_attn * ker_ms:.3f} ms "
        f"of the mean step ({n_attn * ker_ms / steps_ms.mean():.3f})")
    log(f"serve {cfg.name} bf16 on {card}: {len(reqs)} requests (prompts "
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
        f"launches {launches}{share}")
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
    if missing and n_attn:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return launches


def paged_vs_dense(torch, np, cfg, params, *, seed, context=None):
    """One decode step's logits through the paged path (the kernel) and
    through the dense ``decode_step`` path (plain attention), after a
    dense prefill of 4 prompts of 16-256 tokens (``default_rng(seed)``)
    scattered into a paged pool. ``context`` (4 rows, raw): prefill
    takes it raw, both decode steps encoded once."""
    from repro_torch.kernels.flash_attn.decode import paged_attention
    from repro_torch.models import transformer
    from repro_torch.serving import PagedKVCache

    dtype = params["embed"].dtype
    rng = np.random.default_rng(seed)
    e2e_lens = rng.integers(16, 257, 4)
    b, max_len = len(e2e_lens), 264
    toks = np.zeros((b, max(e2e_lens)), np.int32)
    for i, n in enumerate(e2e_lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    lens = torch.as_tensor(e2e_lens.astype(np.int32), device="cuda")
    with torch.no_grad():
        cache = transformer.init_cache(cfg, b, max_len, dtype, "cuda")
        logits, cache = transformer.prefill(
            params, cfg, torch.as_tensor(toks, device="cuda"), cache,
            context=context, last_index=lens - 1)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        enc = transformer.encode_context(params, cfg, context)
        kv = PagedKVCache(cfg, max_batch=b, max_seq=max_len, page_size=16,
                          dtype=dtype)
        for r, n in enumerate(e2e_lens.tolist()):
            kv.alloc(r, max_len)
            kv.write_prompt(r, {si: (c.k[:, r:r + 1, :n], c.v[:, r:r + 1, :n])
                                for si, c in cache.slots.items()}, n)
        n0 = paged_attention.launches
        paged = transformer.decode_step_paged(
            params, cfg, nxt, kv.pages, kv.tables(), lens,
            torch.ones(b, dtype=torch.bool, device="cuda"), context=enc)
        launches = paged_attention.launches - n0
        dense, _ = transformer.decode_step(params, cfg, nxt, cache,
                                           context=enc, offsets=lens)
        torch.cuda.synchronize()
    return dict(paged=paged, dense=dense, launches=launches, lens=e2e_lens,
                lens_dev=lens, next=nxt, kv=kv, context=enc)


# ---- slice 7: the gates and the three dense configs (phases 18-19) ---------

# phi3 sets no logit softcap, so phase 4's absolute bound on +-30 capped
# logits does not carry over: the two f32 paths sum attention in other
# orders (phase 4 measured ~5e-7 of logits a few units wide over 26
# layers); 1e-4 of the largest |logit| leaves two orders of room, while a
# wrong head layout, mask or page moves logits by their own size
DENSE_E2E_RTOL = 1e-4
# the three dense head layouts (configs/*.py) and their served tables
DENSE_LAYOUTS = {
    "phi3-medium-14b": (dict(kvh=10, group=4, dh=128), (66,)),
    "chatglm3-6b": (dict(kvh=2, group=16, dh=128), (66,)),
    "qwen1.5-32b": (dict(kvh=40, group=1, dh=128), (66,)),
}


def gates_phase(torch, card, kernels):
    """Phase 18: the ported serving and wire-plane snapshots on the card,
    gated against the ``"cuda"`` baselines. Every kernel count is set to
    0 just before and read just after; the serving kernel and both wire
    kernels must have launched. Returns those launches."""
    import os
    import tempfile

    from repro_torch.bench import (check_perf, check_serve, perf_wire,
                                   serve_bench)

    for _, wrapper in kernels.values():
        wrapper.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        with phase_clock(torch, "phase 18 serve_bench (phi3 smoke, 12 "
                         "requests, 2 engines)", card):
            serve, lines = _quiet(serve_bench.run, device="cuda",
                                  out_path=os.path.join(tmp, "serve.json"))
        for line in lines:
            log(f"  {line}")
        with phase_clock(torch, f"phase 18 perf_wire ({len(perf_wire.CASES)} "
                         f"cases x 2 steps, {perf_wire.N_NODES} nodes)", card):
            perf, lines = _quiet(perf_wire.run, device="cuda",
                                 out_path=os.path.join(tmp, "perf.json"))
        for line in lines:
            log(f"  {line}")
    launches = {k: w.launches for k, (_, w) in kernels.items()
                if k in GATE_KERNELS}
    log(f"phase 18 serve: decode step {serve['decode_aten_ops']} ATen ops, "
        f"{serve['decode_kernel_launches']} kernel launches (paged "
        f"{serve['decode_paged_kernel_launches']}; the profiler holds "
        f"{serve['decode_kernel_records']} kernel records); host syncs a "
        f"serve {json.dumps(serve['host_syncs'])}; records "
        f"{json.dumps(serve['records'])}")
    for rec in perf["records"]:
        log(f"phase 18 perf {rec['case']}: kernel_launches "
            f"{rec['kernel_launches']}, ported "
            f"{rec['ported_kernel_launches']}, aten_ops {rec['aten_ops']}, "
            f"launches {rec['launches']}, permutes {rec['permutes_per_step']}"
            f", wire bits {rec['wire_bits_sent']} (acc "
            f"{rec['wire_bits_acc']})")
    failures = check_serve.check(serve) + check_perf.check(perf)
    log(f"phase 18 gates on {card}: check_serve + check_perf "
        f"{'passed' if not failures else 'FAILED: ' + str(failures)}; "
        f"launches {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if failures or missing:
        raise AssertionError(f"gates failed {failures}; kernels not "
                             f"launched {missing}")
    return launches


# ragged lengths (incl. an empty row) for the kernel-vs-plain checks at a
# table of 66 blocks of 16 (max_seq 1056: phase 3's workload), of 17
# (max_seq 264: the 8-request workload of phases 20d-e) and of 18 (max_seq
# 288: whisper's transcription workload, phase 21b), where the split plan
# differs
TABLE_LENS = {66: [0, 1, 16, 17, 300, 1000, 1056, 64],
              17: [0, 64, 65, 100, 200, 256, 263, 264],
              18: [0, 1, 16, 17, 100, 224, 287, 288]}


def layout_kernels(torch, np, layouts, seed):
    """The paged kernel against its plain version at each of ``layouts``
    (``{arch: (head layout, served tables[, serving shape])}``: 8 rows at
    each served table's TABLE_LENS, f32 and bf16, no softcap, no window),
    then its time, the plain version's and the bound at each layout's
    serving shape (by default 8 rows of phase 3's lengths, 66 blocks of
    16; else the given (n_blocks, lengths)), bf16, 8 pools in turn.
    Returns {arch: timing}."""
    from repro_torch.kernels.flash_attn.decode import (paged_attention,
                                                       paged_attention_ref,
                                                       split_plan)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for arch, (lay, tables, *serve) in layouts.items():
        errs = []
        for n_blocks in tables:
            plan = split_plan(8, lay["kvh"], lay["group"], lay["dh"],
                              n_blocks)
            for dt_name in ("float32", "bfloat16"):
                q, kv, tbl, sl = paged_inputs(
                    torch, gen, seq_lens=TABLE_LENS[n_blocks],
                    n_blocks=n_blocks, page=16,
                    dtype=getattr(torch, dt_name), **lay)
                (kp, vp), = kv
                n0 = paged_attention.launches
                got = paged_attention(q, kp, vp, tbl, sl)
                torch.cuda.synchronize()
                want = paged_attention_ref(q, kp, vp, tbl, sl)
                err = (got.float() - want.float()).abs().max().item()
                zero = not got[sl == 0].any().item()
                errs.append(err)
                log(f"paged_decode {arch} layout (kvh {lay['kvh']}, group "
                    f"{lay['group']}, dh {lay['dh']}) {dt_name} softcap=None,"
                    f" 8 rows x {n_blocks} blocks (split plan P "
                    f"{plan.pages_per_split}, S {plan.n_splits}), lengths "
                    f"{TABLE_LENS[n_blocks]}: max|kernel-plain|={err:.3e} "
                    f"(atol {KERNEL_ATOL[dt_name]}) empty-row zeros={zero}")
                if not (err <= KERNEL_ATOL[dt_name] and zero
                        and paged_attention.launches == n0 + 1):
                    raise AssertionError(
                        f"paged_decode disagrees with its plain version at "
                        f"{arch}'s layout, {n_blocks} blocks")
        if serve:
            sb, serve_lens = serve[0]
        else:
            rng = np.random.default_rng(0)
            sb, serve_lens = 66, (rng.integers(64, 1025, 8) + 16).tolist()
        plan = split_plan(8, lay["kvh"], lay["group"], lay["dh"], sb)
        q, kv, tbl, sl = paged_inputs(torch, gen, seq_lens=serve_lens,
                                      n_blocks=sb, page=16,
                                      dtype=torch.bfloat16, pools=8, **lay)
        ker_ms, host_ms = cuda_ms(torch, lambda i: paged_attention(
            q, *kv[i % 8], tbl, sl), iters=208)
        plain_ms, _ = cuda_ms(torch, lambda i: paged_attention_ref(
            q, *kv[i % 8], tbl, sl), iters=16)
        bound_ms, bound_by, nbytes = decode_bound(
            serve_lens, window=None, n_blocks=sb, page=16, elt_bytes=2,
            **lay)
        log(f"paged_decode {arch} bf16 b=8 kvh={lay['kvh']} "
            f"group={lay['group']} dh={lay['dh']} page=16 "
            f"{sb} blocks (split plan P {plan.pages_per_split}, S "
            f"{plan.n_splits}) "
            f"seq_lens={serve_lens}: kernel {ker_ms * 1e3:.2f} us on the "
            f"device ({host_ms * 1e3:.2f} us per call on the host), plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({nbytes} bytes, {bound_by})")
        out[arch] = dict(ms=ker_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, max_abs_err=max(errs),
                         serve_blocks=sb,
                         split_plan=[plan.pages_per_split, plan.n_splits])
        del q, kv, tbl, sl
        torch.cuda.empty_cache()
    return out


def dense_configs_phase(torch, np, card, kernels):
    """Phase 19: the three dense configs served on the card at full width:
    phi3-medium-14b with phase 3's workload and its f32 paged step
    against plain attention; chatglm3-6b and qwen1.5-32b, 4 requests
    each; all at full depth (init_params draws one period at a time, so
    qwen1.5's 68.8 GB of bf16 and phi3's 56.6 GB of f32 fit). Returns
    (the paged kernel's launches in the three serves, the layouts'
    kernel timings)."""
    from repro_torch import configs

    timings = layout_kernels(torch, np, DENSE_LAYOUTS, seed=19)
    launches = 0
    cfg = configs.get_config("phi3-medium-14b")
    with phase_clock(torch, "phase 19 phi3-medium-14b serve (40 layers)",
                     card):
        params = init_model(torch, np, cfg, seed=0, dtype=torch.bfloat16)
        launches += serve_ragged(torch, np, cfg, params, card, kernels,
                                 ker_ms=timings[cfg.name]["ms"])[
            "paged_decode"]
        del params
    gc.collect()
    torch.cuda.empty_cache()

    with phase_clock(torch, f"phase 19 phi3 f32 paged vs dense "
                     f"({cfg.n_layers} layers)", card):
        params = init_model(torch, np, cfg, seed=1, dtype=torch.float32)
        e2e = paged_vs_dense(torch, np, cfg, params, seed=1)
        paged, dense = e2e["paged"], e2e["dense"]
        scale = dense.abs().max().item()
        diff = (paged - dense).abs().max().item()
        finite = bool(torch.isfinite(paged).all()
                      and torch.isfinite(dense).all())
        same_top = (paged.argmax(-1) == dense.argmax(-1)).float().mean().item()
        log(f"e2e f32 phi3-medium-14b, {cfg.n_layers} layers, prompts "
            f"{e2e['lens'].tolist()}: max|paged(kernel) - dense(plain)| "
            f"logits = {diff:.3e}, |logits| max {scale:.4f}, relative "
            f"{diff / scale:.3e} (rtol {DENSE_E2E_RTOL}); argmax agreement "
            f"{same_top:.2f}; kernel launches {e2e['launches']}; finite "
            f"{finite}")
        if not (finite and diff <= DENSE_E2E_RTOL * scale
                and e2e["launches"] == attn_layers(cfg)):
            raise AssertionError("phi3 paged-kernel logits disagree with the "
                                 "dense plain path")
        del params, e2e, paged, dense
    gc.collect()
    torch.cuda.empty_cache()

    for arch in ("chatglm3-6b", "qwen1.5-32b"):
        cfg = configs.get_config(arch)
        with phase_clock(torch, f"phase 19 {cfg.name} serve "
                         f"({cfg.n_layers} layers)", card):
            params = init_model(torch, np, cfg, seed=0, dtype=torch.bfloat16)
            launches += serve_ragged(
                torch, np, cfg, params, card, kernels, n_requests=4,
                max_new=4, max_batch=4,
                ker_ms=timings[cfg.name]["ms"])["paged_decode"]
            del params
        gc.collect()
        torch.cuda.empty_cache()
    return launches, timings


# ---- slice 8: the MoE and recurrent families (phase 20) --------------------

# the MoE and hybrid head layouts (configs/*.py) and their served tables:
# granite-moe serves phase 3's workload, qwen3-moe and jamba 8 requests
# of <= 256 + 8 tokens
MOE_LAYOUTS = {
    "granite-moe-1b-a400m": (dict(kvh=8, group=2, dh=64), (66,)),
    "qwen3-moe-30b-a3b": (dict(kvh=4, group=8, dh=128), (66, 17)),
    "jamba-v0.1-52b": (dict(kvh=8, group=4, dh=128), (66, 17)),
}
# jamba-v0.1-52b: 2 of its 4 periods (25.8 B parameters, 51.6 GB of
# bf16); 3 periods (77.1 GB) serve this workload at an 80.7 GB peak with
# 81.5 GB reserved of the H100's 85.0, too little room to run after the
# earlier phases
JAMBA_LAYERS = 16
# granite-moe's LM training part: phase 10's shape at 4 of its 24 layers
MOE_LM_LAYERS, MOE_LM_STEPS = 4, 3
# f32 greedy serving, engine against engine. granite: power-of-two
# prompt lengths, so that the continuous engine's bucketed prefill holds
# the very tokens of the one-at-a-time exact-length prefill (MoE capacity
# counts every token a call receives, padding included); rwkv6: the CPU
# test's ragged set (tests/test_torch_recurrent_serving.py)
GRANITE_F32 = ((8, 16, 32, 64), (8, 8, 8, 8))
RWKV_F32 = ((4, 7, 4, 9), (5, 3, 6, 4))


def engines_agree(torch, np, cfg, params, lens, budgets, *, batched_static,
                  context=None):
    """Greedy outputs of the paged ``ServingEngine`` (4 slots), of
    one-at-a-time serving (``StaticServingEngine``, max_batch 1) and, if
    ``batched_static``, of the static engine at max_batch 4 (which groups
    a recurrent model's prompts by length); every serve gets
    ``context``. Returns {engine: outputs}."""
    from repro_torch.serving import (Request, ServingEngine,
                                     StaticServingEngine)

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]

    def requests():
        return [Request(prompt=list(p), max_new_tokens=m)
                for p, m in zip(prompts, budgets)]

    max_seq = max(lens) + max(budgets) + 16
    outs = {}
    reqs = requests()
    ServingEngine(cfg, params, max_batch=4, max_seq=max_seq,
                  page_size=16).serve(reqs, context=context)
    outs["continuous"] = [r.output for r in reqs]
    if batched_static:
        reqs = requests()
        StaticServingEngine(cfg, params, max_batch=4,
                            max_seq=max_seq).serve(reqs, context=context)
        outs["static"] = [r.output for r in reqs]
    outs["one_at_a_time"] = []
    for r in requests():
        StaticServingEngine(cfg, params, max_batch=1,
                            max_seq=max_seq).serve([r], context=context)
        outs["one_at_a_time"].append(r.output)
    return outs


def moe_recurrent_phase(torch, np, card, kernels):
    """Phase 20: the MoE and recurrent families on the card. (f) the paged
    kernel vs plain at their three head layouts; (a) granite-moe-1b-a400m
    at full width and depth serving phase 3's workload; (b) its f32 paged
    step against plain attention and its engines' greedy outputs; (c)
    rwkv6-3b at full width and depth, phase 3's workload, then f32
    continuous / static / one-at-a-time outputs; (d) qwen3-moe-30b-a3b at
    full width and depth and (e) jamba-v0.1-52b at full width, depth cut,
    8 requests of <= 256 prompt tokens; (g) granite-moe LM training
    (``lm_phase``). Returns (launches of the
    paged kernel and of fixedk_gather_pack, the layouts' timings)."""
    import dataclasses

    from repro_torch import configs

    timings = layout_kernels(torch, np, MOE_LAYOUTS, seed=20)
    paged = 0

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    granite = configs.get_config("granite-moe-1b-a400m")
    with phase_clock(torch, "phase 20a granite-moe-1b-a400m serve (24 "
                     "layers)", card):
        params = init_model(torch, np, granite, seed=0, dtype=torch.bfloat16)
        paged += serve_ragged(torch, np, granite, params, card, kernels,
                              ker_ms=timings[granite.name]["ms"])[
            "paged_decode"]
        del params
    free()

    with phase_clock(torch, "phase 20b granite-moe f32 paged vs dense, "
                     "engines", card):
        params = init_model(torch, np, granite, seed=1, dtype=torch.float32)
        e2e = paged_vs_dense(torch, np, granite, params, seed=1)
        diff = (e2e["paged"] - e2e["dense"]).abs().max().item()
        scale = e2e["dense"].abs().max().item()
        finite = bool(torch.isfinite(e2e["paged"]).all()
                      and torch.isfinite(e2e["dense"]).all())
        log(f"e2e f32 granite-moe-1b-a400m, {granite.n_layers} layers, "
            f"prompts {e2e['lens'].tolist()}: max|paged(kernel) - "
            f"dense(plain)| logits = {diff:.3e}, |logits| max {scale:.4f}, "
            f"relative {diff / scale:.3e} (rtol {DENSE_E2E_RTOL}); kernel "
            f"launches {e2e['launches']}; finite {finite}")
        if not (finite and diff <= DENSE_E2E_RTOL * scale
                and e2e["launches"] == attn_layers(granite)):
            raise AssertionError("granite-moe paged-kernel logits disagree "
                                 "with the dense plain path")
        # host work of an MoE decode step: the ATen ops it dispatches
        from repro_torch.bench.counting import OpCount
        from repro_torch.models import transformer

        b = len(e2e["lens"])
        with torch.no_grad(), OpCount() as ops:
            transformer.decode_step_paged(
                params, granite, e2e["next"], e2e["kv"].pages,
                e2e["kv"].tables(), e2e["lens_dev"] + 1,
                torch.ones(b, dtype=torch.bool, device="cuda"))
        torch.cuda.synchronize()
        log(f"granite-moe decode_step_paged dispatches {ops.total} ATen ops "
            f"per step ({ops.total / granite.n_layers:.1f} per layer) plus "
            f"{attn_layers(granite)} kernel launches through ctypes; most "
            f"frequent: {ops.by_name.most_common(12)}")
        del e2e
        outs = engines_agree(torch, np, granite, params, *GRANITE_F32,
                             batched_static=False)
        log(f"granite-moe f32 greedy, prompts {GRANITE_F32[0]}: continuous "
            f"(paged kernel) == one-at-a-time (plain) "
            f"{outs['continuous'] == outs['one_at_a_time']}; "
            f"{outs['continuous']}")
        if outs["continuous"] != outs["one_at_a_time"]:
            raise AssertionError(f"granite-moe engines disagree: {outs}")
        del params
    free()

    rwkv = configs.get_config("rwkv6-3b")
    with phase_clock(torch, "phase 20c rwkv6-3b serve (32 layers)", card):
        params = init_model(torch, np, rwkv, seed=0, dtype=torch.bfloat16)
        paged += serve_ragged(torch, np, rwkv, params, card, kernels)[
            "paged_decode"]
        del params
    free()
    with phase_clock(torch, "phase 20c rwkv6-3b f32 engines", card):
        params = init_model(torch, np, rwkv, seed=1, dtype=torch.float32)
        outs = engines_agree(torch, np, rwkv, params, *RWKV_F32,
                             batched_static=True)
        same = outs["continuous"] == outs["static"] == outs["one_at_a_time"]
        log(f"rwkv6-3b f32 greedy, prompts {RWKV_F32[0]}: continuous == "
            f"static (length-grouped) == one-at-a-time {same}; "
            f"{outs['continuous']}")
        if not same:
            raise AssertionError(f"rwkv6-3b engines disagree: {outs}")
        del params
    free()

    qwen3 = configs.get_config("qwen3-moe-30b-a3b")
    jamba = configs.get_config("jamba-v0.1-52b")
    for cfg, layers in ((qwen3, qwen3.n_layers), (jamba, JAMBA_LAYERS)):
        cut = dataclasses.replace(cfg, n_layers=layers)
        with phase_clock(torch, f"phase 20 {cfg.name} serve ({layers} of "
                         f"{cfg.n_layers} layers)", card):
            params = init_model(
                torch, np, cut, seed=0, dtype=torch.bfloat16,
                reduced=(f"n_layers {cfg.n_layers} -> {layers}"
                         if layers != cfg.n_layers else None))
            paged += serve_ragged(
                torch, np, cut, params, card, kernels, n_requests=8,
                max_new=8, prompt_max=256,
                ker_ms=timings[cfg.name]["ms"])["paged_decode"]
            del params
        free()

    with phase_clock(torch, f"phase 20g granite-moe LM training "
                     f"({MOE_LM_LAYERS} layers, {LM_NODES} nodes)", card):
        lm = lm_phase(torch, np, card, arch=granite.name,
                      layers=MOE_LM_LAYERS, steps=MOE_LM_STEPS,
                      profile=False)
        if lm["failures"]:
            raise AssertionError(f"granite-moe training failed: "
                                 f"{lm['failures']}")
        gather = lm["launches"]
        del lm
    free()
    return {"paged_decode": paged, "fixedk_gather_pack": gather}, timings


# ---- slice 9: the encoder families (phase 21) --------------------------------

# the encoder families' head layouts (configs/*.py), their served tables
# and, for whisper, its serving shape: 8 rows of 21b-like prompts
# (default_rng(0).integers(4, 225, 8)) 32 tokens into their answers, 18
# blocks of 16 (max_seq 288)
ENCODER_LAYOUTS = {
    "whisper-large-v3": (dict(kvh=20, group=1, dh=64), (18, 66),
                         (18, [223, 176, 148, 95, 104, 45, 52, 39])),
    "llama-3.2-vision-11b": (dict(kvh=8, group=4, dh=128), (66,)),
}
# whisper's transcription-shaped workload: the real decoder holds 448
# positions, a prompt of at most 224 and the rest for its output
WHISPER_SERVE = dict(n_requests=16, max_new=64, prompt_min=4,
                     prompt_max=224)
# whisper's training part: full width, 4 of its 32 decoder and 4 of its
# 32 encoder layers, the decoder's 448 positions
WHISPER_LM_LAYERS, WHISPER_LM_ENC_LAYERS, WHISPER_LM_SEQ = 4, 4, 448
WHISPER_LM_STEPS = 3
# f32 greedy serving, engine against engine, all context rows equal (as
# the launchers give them; with distinct rows the continuous engine, row
# 0 for every slot, and the static engine, rows 0..b-1, differ by design)
ENCODER_F32 = ((5, 9, 17, 30), (6, 4, 8, 5))


def encoder_families_phase(torch, np, card, kernels):
    """Phase 21: the encoder families on the card. (a) the paged kernel
    vs plain at whisper's layout (kvh 20 x group 1, dh 64, at 18 and 66
    blocks) and llama-3.2-vision's (kvh 8 x group 4, dh 128, 66 blocks);
    (b) whisper-large-v3 at full width and depth (32 + 32 layers, bf16)
    serving 16 requests of 4-224 prompt tokens and 64 new, one 1500-frame
    embedding a context row, and its encoder timed alone; (c) its f32
    paged step against plain attention with the encoded context; (d)
    llama-3.2-vision-11b at full width and depth serving phase 3's
    workload on 1024 image tokens a row, then its f32 paged step against
    plain; (e) for both in f32, continuous == static == one-at-a-time on
    equal context rows; (f) whisper LM training (``lm_phase``). Returns
    (launches of the paged kernel and of fixedk_gather_pack, the
    layouts' timings)."""
    from repro_torch import configs
    from repro_torch.bench.counting import OpCount
    from repro_torch.models import transformer

    timings = layout_kernels(torch, np, ENCODER_LAYOUTS, seed=21)
    gen = torch.Generator(device="cuda").manual_seed(21)
    paged = 0

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def contexts(cfg, b, dtype, equal=False):
        """(b, encoder_seq or n_image_tokens, d_model) seeded normal
        rows on the card: distinct, or one row repeated."""
        n = cfg.encoder_seq if cfg.family == "audio" else cfg.n_image_tokens
        c = torch.randn(1 if equal else b, n, cfg.d_model, generator=gen,
                        device="cuda").to(dtype)
        return c.expand(b, n, cfg.d_model).contiguous() if equal else c

    def paged_vs_plain(cfg, params, ctx):
        e2e = paged_vs_dense(torch, np, cfg, params, seed=1, context=ctx)
        diff = (e2e["paged"] - e2e["dense"]).abs().max().item()
        scale = e2e["dense"].abs().max().item()
        finite = bool(torch.isfinite(e2e["paged"]).all()
                      and torch.isfinite(e2e["dense"]).all())
        log(f"e2e f32 {cfg.name}, {cfg.n_layers} layers, prompts "
            f"{e2e['lens'].tolist()}, encoded context "
            f"{tuple(e2e['context'].shape)}: max|paged(kernel) - "
            f"dense(plain)| logits = {diff:.3e}, |logits| max {scale:.4f}, "
            f"relative {diff / scale:.3e} (rtol {DENSE_E2E_RTOL}); kernel "
            f"launches {e2e['launches']}; finite {finite}")
        if not (finite and diff <= DENSE_E2E_RTOL * scale
                and e2e["launches"] == attn_layers(cfg)):
            raise AssertionError(f"{cfg.name} paged-kernel logits disagree "
                                 f"with the dense plain path")
        b = len(e2e["lens"])
        with torch.no_grad(), OpCount() as ops:
            transformer.decode_step_paged(
                params, cfg, e2e["next"], e2e["kv"].pages,
                e2e["kv"].tables(), e2e["lens_dev"] + 1,
                torch.ones(b, dtype=torch.bool, device="cuda"),
                context=e2e["context"])
        torch.cuda.synchronize()
        log(f"{cfg.name} decode_step_paged dispatches {ops.total} ATen ops "
            f"per step ({ops.total / cfg.n_layers:.1f} per layer) plus "
            f"{attn_layers(cfg)} kernel launches through ctypes; most "
            f"frequent: {ops.by_name.most_common(8)}")

    def engines(cfg, params):
        outs = engines_agree(torch, np, cfg, params, *ENCODER_F32,
                             batched_static=True,
                             context=contexts(cfg, 4, torch.float32,
                                              equal=True))
        same = outs["continuous"] == outs["static"] == outs["one_at_a_time"]
        log(f"{cfg.name} f32 greedy, prompts {ENCODER_F32[0]}, equal "
            f"context rows: continuous (paged kernel) == static == "
            f"one-at-a-time {same}; {outs['continuous']}")
        if not same:
            raise AssertionError(f"{cfg.name} engines disagree: {outs}")

    whisper = configs.get_config("whisper-large-v3")
    with phase_clock(torch, "phase 21b whisper-large-v3 serve (32 + 32 "
                     "layers)", card):
        params = init_model(torch, np, whisper, seed=0, dtype=torch.bfloat16)
        ctx = contexts(whisper, 8, torch.bfloat16)
        enc = {}
        with torch.no_grad():
            for rows in (1, 8):
                enc[rows], _ = cuda_ms(torch, lambda i: transformer
                                       .encode_context(params, whisper,
                                                       ctx[:rows]), iters=3)
        log(f"whisper-large-v3 encoder alone (32 layers, 1500 frames, "
            f"bf16): {enc[1]:.3f} ms for 1 row (the continuous engine's "
            f"once a serve; each prefill encodes that row again), "
            f"{enc[8]:.3f} ms for 8 rows (the static engine's batch) on "
            f"{card}")
        paged += serve_ragged(torch, np, whisper, params, card, kernels,
                              ker_ms=timings[whisper.name]["ms"],
                              context=ctx, **WHISPER_SERVE)["paged_decode"]
        timings[whisper.name]["encoder_ms"] = {str(k): v
                                               for k, v in enc.items()}
        del params, ctx
    free()

    with phase_clock(torch, "phase 21c/e whisper-large-v3 f32 paged vs "
                     "dense, engines", card):
        params = init_model(torch, np, whisper, seed=1, dtype=torch.float32)
        paged_vs_plain(whisper, params, contexts(whisper, 4, torch.float32))
        engines(whisper, params)
        del params
    free()

    vision = configs.get_config("llama-3.2-vision-11b")
    with phase_clock(torch, "phase 21d llama-3.2-vision-11b serve (40 "
                     "layers)", card):
        params = init_model(torch, np, vision, seed=0, dtype=torch.bfloat16)
        paged += serve_ragged(torch, np, vision, params, card, kernels,
                              ker_ms=timings[vision.name]["ms"],
                              context=contexts(vision, 8, torch.bfloat16))[
            "paged_decode"]
        del params
    free()

    with phase_clock(torch, "phase 21d/e llama-3.2-vision-11b f32 paged "
                     "vs dense (40 layers), engines", card):
        params = init_model(torch, np, vision, seed=1, dtype=torch.float32)
        paged_vs_plain(vision, params, contexts(vision, 4, torch.float32))
        engines(vision, params)
        del params
    free()

    with phase_clock(torch, f"phase 21f whisper-large-v3 LM training "
                     f"({WHISPER_LM_LAYERS} + {WHISPER_LM_ENC_LAYERS} "
                     f"layers, {LM_NODES} nodes)", card):
        lm = lm_phase(torch, np, card, arch=whisper.name,
                      layers=WHISPER_LM_LAYERS, steps=WHISPER_LM_STEPS,
                      seq_len=WHISPER_LM_SEQ,
                      enc_layers=WHISPER_LM_ENC_LAYERS, profile=False)
        if lm["failures"]:
            raise AssertionError(f"whisper training failed: "
                                 f"{lm['failures']}")
        gather = lm["launches"]
        del lm
    free()
    return {"paged_decode": paged, "fixedk_gather_pack": gather}, timings


# ---- slice 10: the exchange left in flight, the ring helpers, the
# optimizers and checkpoint restore (phase 22) --------------------------------

# the ring helpers over the LM slice's plane, this many nodes and p
RING_NODES, RING_P, RING_W = 4, 0.2, 1.0 / 3.0
OPT_STEPS = 3
# phase 22a's two --overlap runs, steps each: step 1 already folds step
# 0's exchange, left in flight, into the state
OVERLAP_STEPS = 3
# the optimizers' card run against their plain CPU run (relative)
OPT_RTOL = 1e-6
# both optimizers are elementwise, so the CPU run takes this many leading
# elements of each leaf and is held to the same slice of the card's run
OPT_CPU_ELEMS = 1 << 20


@contextlib.contextmanager
def plain_gather_pack():
    """The gossip helpers' gather-pack routed to its plain version, on
    any device: what the kernel is held against."""
    from repro_torch.kernels import wire_compress

    kernel = wire_compress.fixedk_gather_pack
    wire_compress.fixedk_gather_pack = wire_compress.fixedk_gather_pack_ref
    try:
        yield
    finally:
        wire_compress.fixedk_gather_pack = kernel


def memo_token_batches():
    """Memoize ``TokenStream.batch_at`` for this process: a pure function
    of the stream's fields and the step that costs ~7 s of host time a
    batch at vocab 256000 (512 sequential Gumbel draws over the vocab).
    Phases 10, 17 and 22 train on the same (vocab, 4, 512, seed 0)
    stream; each batch is made once."""
    from repro_torch.data.synthetic import TokenStream

    made = {}
    batch_at = TokenStream.batch_at

    def cached(self, step):
        key = (self.vocab_size, self.batch, self.seq_len, self.seed, step)
        if key not in made:
            made[key] = batch_at(self, step)
        return tuple(a.copy() for a in made[key])

    TokenStream.batch_at = cached


@contextlib.contextmanager
def exchange_waited_each_step():
    """``make_distributed_train``'s step with the exchange it leaves in
    flight waited on before the step returns (``transport.settle``): the
    in-order run that the in-flight one is held to."""
    from repro_torch.core.transport import settle
    from repro_torch.train import steps as steps_mod

    make = steps_mod.make_distributed_train

    def make_waited(tc, transport, **kw):
        fn = make(tc, transport, **kw)

        def step(state, *args):
            state, loss = fn(state, *args)
            return settle(state), loss
        return step

    steps_mod.make_distributed_train = make_waited
    try:
        yield
    finally:
        steps_mod.make_distributed_train = make


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(spans) -> int:
    return sum(b - a for a, b in spans)


def _overlap(xs, ys) -> int:
    """The length both merged span lists cover."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        total += max(0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def profile_streams(torch, fn):
    """One ``fn()`` call under ``torch.profiler``, the card synchronised
    after it: {wall, busy (any stream), compute (the stream busiest on
    the device), side (every other stream), hidden (side work that ran
    while the compute stream was busy too)}, all in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    streams = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
            streams.setdefault(e.device_resource_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    if not streams:
        raise AssertionError("the profiler saw no device work")
    main = max(streams, key=lambda k: _covered(_merged(streams[k])))
    compute = _merged(streams[main])
    side = _merged([sp for k, v in streams.items() if k != main
                    for sp in v])
    every = _merged([sp for v in streams.values() for sp in v])
    return dict(wall=wall, busy=_covered(every) / 1e6,
                compute=_covered(compute) / 1e6, side=_covered(side) / 1e6,
                hidden=_overlap(side, compute) / 1e6,
                streams=len(streams))


def overlap_run(torch, np, card, tc, waited: bool, dev="cuda"):
    """Phase 22a, one run: the LM cell through ``launch.train.train`` with
    ``--overlap``, each step's exchange left in flight on the transport's
    side stream until the next step folds it in, or waited on inside its
    own step (``waited``). Returns the run, its transport, its gather-
    pack launches, the exchanges pending after each step and whether the
    side stream still had work queued then."""
    from repro_torch.core.transport import StackTransport
    from repro_torch.kernels.wire_compress import fixedk_gather_pack
    from repro_torch.launch.train import train
    from repro_torch.train import steps as steps_mod

    label = "waited inside each step" if waited else "in flight"
    transport = StackTransport(LM_NODES, dev)
    flights, side_busy = [], []

    def on_step(t, loss, sec):
        flights.append(transport.outstanding)
        side_busy.append(not transport.side_stream.query())

    n0 = fixedk_gather_pack.launches
    with phase_clock(torch, f"phase 22a {tc.model.name} --overlap, exchange "
                     f"{label} (state made, {OVERLAP_STEPS} steps)", card), \
            (exchange_waited_each_step() if waited
             else contextlib.nullcontext()):
        state = steps_mod.init_distributed_state(tc, transport, seed=0)
        run = train(tc, transport, steps=OVERLAP_STEPS,
                    global_batch=LM_NODES * LM_BATCH, seq_len=LM_SEQ, seed=0,
                    state=state, on_step=on_step)
    return (run, transport, fixedk_gather_pack.launches - n0, flights,
            side_busy)


def overlap_library_phase(torch, np, card, dev="cuda"):
    """Phase 22. (a) The LM cell (gemma2-2b at full width, 4 layers, 2
    nodes, ring, fixedk:128, seq 512) with ``--overlap`` through the
    launcher: the exchange left in flight from each step to the next, then
    waited on inside each step; losses and final parameters
    ``torch.equal``; step ms, busy share, the exchange alone. (b) The ring
    helpers over the LM's plane on a ring of RING_NODES nodes: the gather-
    pack kernel launches, each output ``torch.equal`` to the plain version
    on the card, the helper's ms against its byte bound. (c) adamw and
    momentum over the LM's parameter tree for OPT_STEPS steps against the
    plain CPU run. (d) (a)'s state through ``save_checkpoint`` and
    ``restore_checkpoint``. Returns (gather-pack launches on the phase's
    paths, timing extras for the kernels line)."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from repro_torch import configs, prng, tree as tree_mod
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core import SDMConfig, gossip, sparsifier
    from repro_torch.core.transport import StackTransport, settle
    from repro_torch.data import TokenStream
    from repro_torch.kernels.wire_compress import fixedk_gather_pack
    from repro_torch.models import transformer
    from repro_torch.optim import adamw, cosine_schedule, momentum
    from repro_torch.train import steps as steps_mod

    dev = torch.device(dev)
    failures, launches, extra = [], 0, {}
    cfg = dataclasses.replace(configs.get_config("gemma2-2b"),
                              n_layers=LM_LAYERS)
    tc = steps_mod.DistributedTrainConfig(
        model=cfg, sdm=SDMConfig(p=0.2, theta=0.5, gamma=1e-3, sigma=1.0,
                                 clip_c=1e-4, compressor="fixedk:128",
                                 overlap=True),
        topology="ring", method="sdm-dsgd", param_dtype=torch.bfloat16)
    tokens, labels = (torch.as_tensor(a, device=dev) for a in TokenStream(
        vocab_size=cfg.vocab_size, batch=LM_NODES * LM_BATCH,
        seq_len=LM_SEQ, seed=0).batch_at(0))

    def two_steps(run, transport, waited):
        fn = steps_mod.make_distributed_train(tc, transport)

        def go():
            for _ in range(2):
                run.state = fn(run.state, tokens, labels)[0]
                if waited:
                    run.state = settle(run.state)
        return go

    # ---- 22a. the exchange in flight against waited inside each step -------
    res = {}
    for waited in (True, False):
        run, transport, n, flights, side_busy = overlap_run(
            torch, np, card, tc, waited, dev)
        launches += n
        r = res[waited] = dict(
            losses=run.losses, ms=np.asarray(run.step_s) * 1e3,
            flights=flights, side_busy=side_busy, launches=n,
            transport=transport,
            x=tree_mod.tree_map(torch.clone, run.state.x))
        with phase_clock(torch, "phase 22a profile of two more steps", card):
            r["prof"] = profile_streams(
                torch, two_steps(run, transport, waited))
            run.state = settle(run.state)
        if transport.outstanding != 0:
            failures.append(f"{transport.outstanding} side-stream copies "
                            f"never waited on")
        if n != OVERLAP_STEPS:
            failures.append(f"fixedk_gather_pack launched {n} times in "
                            f"{OVERLAP_STEPS} overlapped steps")
        if waited:
            del run                 # only its losses and parameters stay
            gc.collect()
            torch.cuda.empty_cache()
    fly, order = res[False], res[True]
    same_loss = fly["losses"] == order["losses"]
    same_x = all(torch.equal(a, b) for a, b in zip(
        tree_mod.leaves(fly.pop("x")), tree_mod.leaves(order.pop("x"))))
    # the exchange alone: the copy each step starts, one ring round of the
    # packed values, made on the compute stream
    rows = run.state.s[0].shape[1]
    kb = sparsifier.num_kept(rows, 0.2)
    vals = torch.randn(LM_NODES, kb, 128, device=dev)
    (rnd,) = steps_mod.gossip_schedule(tc, LM_NODES).schedules[0].rounds
    exch_ms, _ = cuda_ms(torch, lambda i: fly["transport"].ppermute(
        vals, rnd.perm), iters=10)
    del vals
    f_mean, o_mean = fly["ms"][1:].mean(), order["ms"][1:].mean()
    saved = o_mean - f_mean
    spread = max(fly["ms"][1:].std(), order["ms"][1:].std())

    def said(r):
        p = r["prof"]
        return (f"step ms {[round(float(v), 3) for v in r['ms']]} (steps 2.. "
                f"mean {r['ms'][1:].mean():.3f}); exchanges pending after "
                f"each step {r['flights']}, side stream still busy then "
                f"{r['side_busy']}; two more steps profiled: "
                f"{p['wall']:.3f} ms wall, device busy {p['busy']:.3f} ms "
                f"(busy share {p['busy'] / p['wall']:.3f}) on {p['streams']} "
                f"streams, the side stream {p['side']:.3f} ms of which "
                f"{p['hidden']:.3f} ms under compute-stream work")
    log(f"phase 22a on {card}: gemma2-2b x {LM_LAYERS} layers, {LM_NODES} "
        f"nodes, ring, fixedk:128, --overlap, {OVERLAP_STEPS} steps, each "
        f"step timed on the compute stream: losses torch.equal {same_loss}, "
        f"final parameters torch.equal {same_x}; IN FLIGHT: {said(fly)}; "
        f"WAITED INSIDE EACH STEP: {said(order)}; the exchange alone (a "
        f"ring round of ({LM_NODES}, {kb}, 128) f32 on the compute stream) "
        f"{exch_ms:.3f} ms; waited less in flight {saved:.3f} ms a step "
        f"(step spread {spread:.3f} ms: "
        + ("within the noise" if abs(saved) <= spread else "above the noise")
        + f"); losses {fly['losses']}")
    if not (same_loss and same_x):
        failures.append("--overlap in flight differs from waited")
    if set(fly["flights"]) != {1} or set(order["flights"]) != {0}:
        failures.append(f"exchanges pending {fly['flights']} / "
                        f"{order['flights']}")
    extra["overlap_lm"] = dict(
        step_ms_in_flight=float(f_mean), step_ms_waited=float(o_mean),
        busy_share_in_flight=fly["prof"]["busy"] / fly["prof"]["wall"],
        busy_share_waited=order["prof"]["busy"] / order["prof"]["wall"],
        side_ms_in_flight=fly["prof"]["side"] / 2,
        hidden_ms_in_flight=fly["prof"]["hidden"] / 2,
        side_ms_waited=order["prof"]["side"] / 2,
        hidden_ms_waited=order["prof"]["hidden"] / 2,
        exchange_ms=exch_ms, launches=fly["launches"] + order["launches"])
    del fly, order, res

    # ---- 22d. (a)'s state through a checkpoint -----------------------------
    state = run.state
    del run
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with phase_clock(torch, "phase 22d save + restore (a)'s state", card):
            t0 = time.monotonic()
            path = save_checkpoint(ckdir, state.step, state)
            save_s = time.monotonic() - t0
            size = os.path.getsize(path)
            t0 = time.monotonic()
            back = restore_checkpoint(ckdir, state)
            torch.cuda.synchronize()
            restore_s = time.monotonic() - t0
        pairs = list(zip(tree_mod.leaves(back), tree_mod.leaves(state)))
        same = all(torch.equal(a, b) if isinstance(b, torch.Tensor)
                   else a == b for a, b in pairs)
        dtypes = all(a.dtype == b.dtype and a.device == b.device
                     for a, b in pairs if isinstance(b, torch.Tensor))
        n_bf16 = sum(isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
                     for _, b in pairs)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"phase 22d on {card}: state of (a) at step {state.step}, "
        f"{len(pairs)} leaves ({n_bf16} bf16), file {size / 1e9:.3f} GB: "
        f"save_checkpoint {save_s:.3f} s, restore_checkpoint onto the card "
        f"{restore_s:.3f} s; every leaf torch.equal {same}, dtypes and "
        f"device kept {dtypes}")
    if not (same and dtypes and n_bf16 > 0):
        failures.append("checkpoint restore differs from the state")
    extra["checkpoint"] = dict(save_s=save_s, restore_s=restore_s,
                               bytes=size)
    del back, state, pairs
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 22b. the ring helpers at full width -------------------------------
    gen = torch.Generator(device=dev).manual_seed(22)
    d = torch.randn(RING_NODES, rows, 128, device=dev, generator=gen)
    key = prng.PRNGKey(3, device=dev)
    kb = sparsifier.num_kept(rows, RING_P)
    # gather (read + write the kept rows), two ring copies (read + write),
    # the three packed arrays read by the scatters, two dense outputs
    nbytes = cost.ring_exchange_packed(RING_NODES, kb, rows, 128).nbytes
    dense = RING_NODES * rows * 128 * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    helpers = {
        "ring_exchange_packed_rows": lambda t: gossip.ring_exchange_packed_rows(
            d, transport=t, base_key=key, step=5, p=RING_P,
            neighbor_weight=RING_W),
        "ring_exchange_packed": lambda t: gossip.ring_exchange_packed(
            d.reshape(RING_NODES, -1), transport=t, base_key=key, step=5,
            p=RING_P, neighbor_weight=RING_W, block=128),
    }
    extra["ring_helpers"] = {}
    # the neighbour sum waits in pinned host memory while the plain
    # version runs (both runs' dense outputs would not fit the card)
    with phase_clock(torch, "phase 22b pinned host staging buffer", card):
        staged = torch.empty(d.shape, dtype=d.dtype,
                             pin_memory=dev.type == "cuda")
    for name, helper in helpers.items():
        t = StackTransport(RING_NODES, dev)
        with phase_clock(torch, f"phase 22b {name}", card):
            n0 = fixedk_gather_pack.launches
            own, nb = helper(t)
            torch.cuda.synchronize()
            n = fixedk_gather_pack.launches - n0
            launches += n
            peak = torch.cuda.max_memory_allocated()
            staged.copy_(nb.reshape(staged.shape))
            del nb
            with plain_gather_pack():
                own_p, nb_p = helper(StackTransport(RING_NODES, dev))
            nb_p = nb_p.reshape(staged.shape)
            same = torch.equal(own, own_p) and all(
                torch.equal(staged[i].to(dev), nb_p[i])
                for i in range(RING_NODES))
            del own, own_p, nb_p
            ms, host = cuda_ms(torch, lambda i: helper(StackTransport(
                RING_NODES, dev)), iters=2, warmup=1)
        log(f"phase 22b {name} on {card}: ({RING_NODES}, {rows}, 128) f32 "
            f"({dense / 1e9:.2f} GB a block), p {RING_P}, kb {kb}: "
            f"fixedk_gather_pack launches {n}; own and neighbour sum "
            f"torch.equal to the plain version on the card {same}; "
            f"{ms:.3f} ms on the device ({host:.3f} ms on the host), byte "
            f"bound {bound_ms:.3f} ms ({nbytes} bytes at 3.35 TB/s: packed "
            f"rows gathered, copied twice, scattered; two dense outputs; "
            f"the index draws are not counted): bound / time "
            f"{bound_ms / ms:.3f}; "
            f"the helper's own peak {peak / 1e9:.3f} GB; sends {t.permutes}")
        if not (same and n == 1 and t.permutes == 2):
            failures.append(f"{name} disagrees with its plain version or "
                            f"launched {n} kernels")
        extra["ring_helpers"][name] = dict(ms=ms, bound_ms=bound_ms,
                                           peak_gb=peak / 1e9)
    del d, staged
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 22c. the optimizers over the LM's parameter tree -------------------
    torch.cuda.synchronize()
    t22c = time.monotonic()
    params = transformer.init_params(cfg, seed=0, dtype=torch.float32,
                                     device=dev)
    grads = [tree_mod.tree_map(lambda v: torch.randn(
        v.shape, device=dev, generator=gen), params)
        for _ in range(OPT_STEPS)]
    n_params = sum(v.numel() for v in tree_mod.leaves(params))
    extra["optimizers"] = {}
    for name, opt in (("adamw", adamw(cosine_schedule(1e-3, 1, 10),
                                      weight_decay=0.01)),
                      ("momentum", momentum(1e-3))):
        def head(t):
            return tree_mod.tree_map(
                lambda v: v.reshape(-1)[:OPT_CPU_ELEMS].cpu().clone(), t)

        cpu_p, cpu_g = head(params), [head(g) for g in grads]
        cpu_s = opt.init(cpu_p)
        p, s = params, opt.init(params)
        step_ms = []
        for t_ in range(OPT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, s = opt.update(grads[t_], s, p)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            cpu_p, cpu_s = opt.update(cpu_g[t_], cpu_s, cpu_p)
        err = max(float((a.reshape(-1)[:OPT_CPU_ELEMS].cpu() - b).abs().max()
                        / b.abs().max())
                  for a, b in zip(tree_mod.leaves(p), tree_mod.leaves(cpu_p)))
        log(f"phase 22c {name} on {card}: {n_params} f32 parameters "
            f"(gemma2-2b x {LM_LAYERS} layers), {OPT_STEPS} steps: ms a step "
            f"{[round(v, 3) for v in step_ms]}; against the plain CPU run "
            f"(first {OPT_CPU_ELEMS} elements of each leaf): max relative "
            f"error {err:.3e} (bound {OPT_RTOL})")
        if not err <= OPT_RTOL:
            failures.append(f"{name} on the card differs from the CPU run")
        extra["optimizers"][name] = dict(step_ms=step_ms, max_rel_err=err)
        del p, s, cpu_p, cpu_s, cpu_g
    del params, grads
    log(f"phase 22c in all: {time.monotonic() - t22c:.3f} s wall on {card}")
    if failures:
        raise AssertionError(f"phase 22 failed: {failures}")
    return launches, extra


# ---- slice 11: the dry-run against the card (phase 23) ---------------------

DRYRUN_BUDGET_S = 60.0    # the phase stays within 70 s
# the full dry-run's cases on mesh 16, cheapest first (decode steps, then
# prefills, then train steps by model size)
DRYRUN_GROUPS = (("decode_32k,long_500k", "all"), ("prefill_32k", "all"),
                 ("train_4k", "granite-moe-1b-a400m,gemma2-2b,rwkv6-3b,"
                  "chatglm3-6b,whisper-large-v3,llama-3.2-vision-11b,"
                  "phi3-medium-14b,qwen3-moe-30b-a3b,qwen1.5-32b,"
                  "jamba-v0.1-52b"))


def dryrun_phase(torch, card):
    """Phase 23: ``launch.dryrun.build_case`` on the meta device for the
    LM cells phases 10, 20g and 21f ran (``LM_CELLS``: their own configs,
    depth cut, 2 nodes, seq, batch and SDM settings), each beside what
    that phase measured; then the full dry-run on mesh 16, one child
    process a group of cases, as far as the phase's budget allows. A
    case that fails fails the phase; a case the budget cuts is listed."""
    import dataclasses
    import tempfile

    from repro_torch import configs
    from repro_torch.bench import roofline
    from repro_torch.launch import dryrun, shapes

    t0 = time.monotonic()
    log(f"phase 23 on {card}; roofline peaks (H100 SXM datasheet, not "
        f"measured): {roofline.PEAK_FLOPS:.3e} FLOP/s bf16, "
        f"{roofline.HBM_BW:.3e} B/s HBM, {roofline.LINK_BW:.3e} B/s NVLink")
    failures = []
    with tempfile.TemporaryDirectory() as out:
        for arch, cell in LM_CELLS.items():
            over = {"n_layers": cell["layers"], "remat": False}
            if cell["enc_layers"] is not None:
                over["n_encoder_layers"] = cell["enc_layers"]
            n = cell["nodes"]
            rec = dryrun.build_case(
                arch, "train_4k", str(n), "sdm-dsgd", "fixedk_packed", out,
                verbose=False, cfg_overrides=over,
                sdm_overrides=dataclasses.asdict(cell["sdm"]),
                shape_overrides=dict(seq_len=cell["seq_len"],
                                     global_batch=n * cell["batch"]))
            row = roofline.analyze_record(rec)
            flops, nbytes = rec["flops"] * n, rec["bytes_accessed"] * n
            # one card holds the whole block: its terms are n devices' work
            t_flops = flops / roofline.PEAK_FLOPS
            t_bytes = nbytes / roofline.HBM_BW
            block_ms = max(t_flops, t_bytes) * 1e3
            model = 6 * rec["model_params_active"] * rec["tokens_per_step"]
            step_s = cell["step_ms"] / 1e3
            pred = rec["memory"]["block_peak_memory_in_bytes"]
            log(f"dryrun cell {arch} x{cell['layers']}"
                + (f"+{cell['enc_layers']}" if cell["enc_layers"] else "")
                + f" layers, {n} nodes, seq {cell['seq_len']}, batch "
                f"{cell['batch']}/node, fixedk:128 (traced {rec['trace_s']} "
                f"s on meta): block flops {flops:.4e}, bytes {nbytes:.4e}, "
                f"wire {rec['collective_bytes']['total'] * n:.4e} B "
                f"({rec['collective_ops']}); per device terms (ms) compute "
                f"{row['compute_s'] * 1e3:.3f} memory "
                f"{row['memory_s'] * 1e3:.3f} collective "
                f"{row['collective_s'] * 1e3:.6f}, roofline_step_ms "
                f"{row['roofline_step_s'] * 1e3:.3f} ({row['dominant']}); "
                f"one card, the block: compute {t_flops * 1e3:.3f} ms, "
                f"memory {t_bytes * 1e3:.3f} ms, roofline {block_ms:.3f} ms; "
                f"model flops 6 N_active D = 6 x {rec['model_params_active']}"
                f" x {rec['tokens_per_step']} = {model:.4e}; measured step "
                f"{cell['step_ms']:.3f} ms (phase steps 2..), measured / "
                f"roofline {cell['step_ms'] / block_ms:.2f}; model-flop "
                f"share of the step {model / (step_s * roofline.PEAK_FLOPS):.5f}"
                f"; peak predicted {pred / 1e9:.3f} GB vs measured "
                f"max_memory_allocated {cell['peak_bytes'] / 1e9:.3f} GB "
                f"(ratio {pred / max(cell['peak_bytes'], 1):.3f}) on {card}")
            if not (math.isfinite(flops) and flops > 0 and nbytes > 0):
                failures.append(f"{arch}: empty dry-run counts")
        if len(LM_CELLS) != 3:
            failures.append(f"LM cells {sorted(LM_CELLS)}: expected 3")
        log(f"phase 23 LM cells: {time.monotonic() - t0:.1f} s")

        done, left = [], []
        for shapes_arg, arches_arg in DRYRUN_GROUPS:
            remaining = DRYRUN_BUDGET_S - (time.monotonic() - t0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--mesh", "16", "--shape", shapes_arg, "--arch",
                   arches_arg, "--keep-going", "--out", out]
            text = ""
            if remaining > 5:
                try:
                    proc = subprocess.run(
                        cmd, capture_output=True, text=True,
                        timeout=remaining, cwd=ROOT,
                        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
                    text = proc.stdout
                    if proc.returncode:
                        failures.append(f"dry-run {shapes_arg}: rc "
                                        f"{proc.returncode}: "
                                        f"{proc.stderr[-2000:]}")
                except subprocess.TimeoutExpired as exc:
                    text = exc.stdout or ""
                    if isinstance(text, bytes):
                        text = text.decode()
            got = re.findall(r"^\[(\S+) \| (\S+) \| 16\]", text, re.MULTILINE)
            done += got
            for line in text.splitlines():
                if line.startswith("["):
                    log(f"dryrun mesh 16 {line}")
            arches = (sorted(configs.ALIASES) if arches_arg == "all"
                      else arches_arg.split(","))
            left += [(a, sh) for sh in shapes_arg.split(",") for a in arches
                     if (a, sh) not in got]
        recs = {(r["arch"], r["shape"]) for r in roofline.load_records(out)
                if r.get("mesh") == "16"}
        skipped = [(a, sh) for a, sh in left if shapes.skip_reason(
            configs.get_config(a), shapes.SHAPES[sh])]
        cut = [c for c in left if c not in skipped]
        log(f"phase 23 full dry-run on mesh 16: {len(done)} cases traced "
            f"({len(recs)} records), {len(skipped)} skipped as in JAX "
            f"(long_500k on full-attention archs), left out for the "
            f"{DRYRUN_BUDGET_S:.0f} s budget: {cut}")
    log(f"phase 23 in all: {time.monotonic() - t0:.1f} s on {card}")
    if failures:
        raise AssertionError(f"phase 23 failed: {failures}")


# ---- slice 14: the serving steps over the model axis (phase 26) -----------

# phase 26's serving shape: 4 equal rows whose prompts pass the local
# layers' 4096-token window, into an 8192-position cache, 32 decode steps
TPS_ROWS, TPS_PROMPT, TPS_MAX_LEN, TPS_STEPS = 4, 4352, 8192, 32
TPS_MODELS = (2, 4)
# bf16, each row's max |TP - unsharded| / max |unsharded| over a step's
# logits: the split softmax rounds its partials to bf16 where the plain
# attention rounds its normalised probabilities, and the shards' partial
# sums of each projection add in another order (each rounded to bf16,
# 2^-8): 2^-5, the bf16 bound of phase 12's rows
TPS_BF16_ROW_RTOL = 2 ** -5
# f32 at full width, 2 layers: the CPU tests hold the smoke config to
# JAX at 1e-5 of the logits' scale; full width sums 18x longer (d_model
# 2304, d_ff 9216), so 1e-4 relative
TPS_F32_RTOL = 1e-4
TPS_F32_LAYERS, TPS_F32_STEPS = 2, 4


def _tps_serve(torch, cfg, params, tokens, feed, m, dev, *, steps):
    """Prefill ``tokens`` then ``steps`` decode steps fed ``feed`` (the
    unsharded run's greedy tokens; None: greedy itself), through
    ``make_prefill_fn`` / ``make_decode_fn`` on a ``1xM`` mesh (``1``: no
    model axis). Returns (per-step whole logits in f32, the greedy
    tokens, decode step ms, prefill ms, the model axes' counters per
    step, the cache's and parameters' devices)."""
    from repro_torch import tree as tree_mod
    from repro_torch.convert import shard_cache, shard_params, unshard_cache
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models import transformer
    from repro_torch.train import steps as steps_mod

    mesh = parse_mesh(f"1x{m}" if m > 1 else "1")
    pf, prules = steps_mod.make_prefill_fn(cfg, mesh, device=dev)
    df, drules = steps_mod.make_decode_fn(cfg, mesh, device=dev)
    p = shard_params(params, cfg, m) if m > 1 else params
    cache = transformer.init_cache(cfg, TPS_ROWS, TPS_MAX_LEN,
                                   params["embed"].dtype, dev)
    if m > 1:
        cache = shard_cache(cache, cfg, prules)
    devices = {t.device.type for t in tree_mod.leaves(p)}
    devices |= {t.device.type for kv in cache.slots.values() for t in kv}
    whole = lambda lg: torch.cat(list(lg), -1) if m > 1 else lg
    counts = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pf(p, tokens, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if m > 1:
        counts.append(("prefill", dict(pf.model_axis.calls),
                       dict(pf.model_axis.bytes)))
        cache = shard_cache(unshard_cache(cache, cfg, prules), cfg, drules)
        devices |= {t.device.type for kv in cache.slots.values() for t in kv}
        devices.add(df.model_axis.device.type)
    outs = [whole(logits).float()]
    greedy = [outs[0].argmax(-1)]
    step_ms = []
    for t in range(steps):
        nxt = greedy[-1] if feed is None else feed[t]
        if m > 1:
            df.model_axis.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = df(p, nxt, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if m > 1:
            counts.append(("decode", dict(df.model_axis.calls),
                           dict(df.model_axis.bytes)))
        outs.append(whole(logits).float())
        greedy.append(outs[-1].argmax(-1))
    del p, cache
    return outs, greedy, step_ms, prefill_ms, counts, devices


def _tps_fault_reading(torch, cfg, params, tokens, ref, feed, dev):
    """The gate's reading of a broken merge: the 1x2 serve of 26a / 26b
    for TPS_F32_STEPS decode steps with the last shard's partials (its
    sums and weighted sums: the newest positions, the token each step
    writes among them) dropped from the decode merge's packed all-reduce
    (told apart from the step's other all-reduces by its last dimension,
    head_dim + 1). Returns the worst row's relative error against the
    unsharded ``ref``."""
    from repro_torch.core import model_axis as ma

    real = ma.StackModelAxis.all_reduce
    width = cfg.resolved_head_dim + 1

    def dropped(self, x):
        if x.dtype == torch.float32 and x.shape[-1] == width:
            x = x.clone()
            x[-1] = 0
        return real(self, x)

    ma.StackModelAxis.all_reduce = dropped
    try:
        got = _tps_serve(torch, cfg, params, tokens, feed, 2, dev,
                         steps=TPS_F32_STEPS)[0]
    finally:
        ma.StackModelAxis.all_reduce = real
    return _tps_compare(torch, ref, got)


def _tps_compare(torch, ref, got):
    """Each row's max |got - ref| / max |ref|, the worst over the steps."""
    worst = 0.0
    for a, b in zip(got, ref):
        err = (a - b).abs().amax(-1) / b.abs().amax(-1)
        worst = max(worst, float(err.max()))
    return worst


def _tps_counts_ok(cfg, m, counts, dtype):
    from repro_torch.core.model_axis import tp_serving_collectives

    for kind, calls, nbytes in counts:
        seq = TPS_PROMPT if kind == "prefill" else 1
        want = tp_serving_collectives(cfg, m, TPS_ROWS, seq, kind, dtype)
        if calls != {op: v["calls"] for op, v in want.items()} or \
                nbytes != {op: v["bytes"] for op, v in want.items()}:
            return False
    return bool(counts)


def tp_serving_phase(torch, np, card, dev="cuda"):
    """Phase 26 (see the module docstring). Returns the failures."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer

    t_phase = time.monotonic()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    failures = []
    cfg = configs.get_config("gemma2-2b")
    gen = torch.Generator(device=dev).manual_seed(26)
    tokens = torch.randint(0, cfg.vocab_size, (TPS_ROWS, TPS_PROMPT),
                           generator=gen, device=dev)

    # 26a: f32, full width, 2 layers
    small = dataclasses.replace(cfg, n_layers=TPS_F32_LAYERS)
    params = transformer.init_params(small, seed=26, dtype=torch.float32,
                                     device=dev)
    ref, greedy, _, _, _, _ = _tps_serve(torch, small, params, tokens, None,
                                         1, dev, steps=TPS_F32_STEPS)
    for m in TPS_MODELS:
        got, _, _, _, counts, devs = _tps_serve(
            torch, small, params, tokens, greedy[:-1], m, dev,
            steps=TPS_F32_STEPS)
        err = _tps_compare(torch, ref, got)
        ok = _tps_counts_ok(small, m, counts, torch.float32)
        log(f"phase 26a {small.name} x{TPS_F32_LAYERS} layers f32 at full "
            f"width, 1x{m}: prefill ({TPS_ROWS} x {TPS_PROMPT}) + "
            f"{TPS_F32_STEPS} decode steps, logits max row |TP - "
            f"unsharded| / max |unsharded| {err:.3e} (rtol {TPS_F32_RTOL});"
            f" model-axis counters == tp_serving_collectives: {ok}; "
            f"devices {sorted(devs)}")
        if not (err <= TPS_F32_RTOL and ok and devs == {"cuda"}):
            failures.append(f"f32 tp serving at 1x{m}")
        del got
    fault = _tps_fault_reading(torch, small, params, tokens, ref,
                               greedy[:-1], dev)
    log(f"phase 26a fault control, 1x2 with the last shard's partials "
        f"dropped from the decode merge: {fault:.3e} (must exceed the rtol "
        f"{TPS_F32_RTOL})")
    if not fault > TPS_F32_RTOL:
        failures.append("the f32 gate does not see a dropped shard")
    del params, ref
    torch.cuda.empty_cache()

    # 26b: bf16, full width and depth
    t0 = time.monotonic()
    params = transformer.init_params(cfg, seed=26, dtype=torch.bfloat16,
                                     device=dev)
    torch.cuda.synchronize()
    log(f"phase 26 init {cfg.name} x{cfg.n_layers} bf16: "
        f"{time.monotonic() - t0:.1f} s")
    ref, greedy, ms1, pre1, _, _ = _tps_serve(
        torch, cfg, params, tokens, None, 1, dev, steps=TPS_STEPS)
    step_ms = {1: float(np.mean(ms1))}
    prefill_ms = {1: pre1}
    feed = greedy[:-1]
    for m in TPS_MODELS:
        got, tg, ms, pre, counts, devs = _tps_serve(
            torch, cfg, params, tokens, feed, m, dev, steps=TPS_STEPS)
        err = _tps_compare(torch, ref, got)
        agree = sum(int((a == b).sum()) for a, b in zip(tg, greedy))
        total = sum(int(b.numel()) for b in greedy)
        ok = _tps_counts_ok(cfg, m, counts, torch.bfloat16)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        step_ms[m], prefill_ms[m] = float(np.mean(ms)), pre
        per = counts[1] if len(counts) > 1 else ("", {}, {})
        log(f"phase 26b {cfg.name} x{cfg.n_layers} bf16, 1x{m} (cache split "
            f"by KV heads for prefill, by positions for decode): prefill "
            f"{TPS_ROWS} x {TPS_PROMPT} tokens into {TPS_MAX_LEN} positions"
            f", {TPS_STEPS} decode steps teacher-forced on the unsharded "
            f"run's greedy tokens: logits max row |TP - unsharded| / max "
            f"|unsharded| {err:.3e} (rtol {TPS_BF16_ROW_RTOL:.5f}); greedy "
            f"tokens agree {agree} of {total}; finite {finite}; model-axis "
            f"counters == tp_serving_collectives: {ok} (a decode step: "
            f"{per[1]} calls, {per[2]} bytes); devices {sorted(devs)}")
        if not (err <= TPS_BF16_ROW_RTOL and ok and finite
                and devs == {"cuda"}):
            failures.append(f"bf16 tp serving at 1x{m}")
        del got
    fault = _tps_fault_reading(torch, cfg, params, tokens, ref, feed, dev)
    log(f"phase 26b fault control, 1x2 with the last shard's partials "
        f"dropped from the decode merge: {fault:.3e} (must exceed the rtol "
        f"{TPS_BF16_ROW_RTOL:.5f})")
    if not fault > TPS_BF16_ROW_RTOL:
        failures.append("the bf16 gate does not see a dropped shard")
    del params, ref
    torch.cuda.empty_cache()
    secs = time.monotonic() - t_phase
    log(f"phase 26 on {card}: mean decode step ms ({TPS_ROWS} rows, "
        f"{TPS_MAX_LEN}-position cache, steps 1..{TPS_STEPS}, host wall, "
        f"synchronised) "
        + ", ".join(f"M {m} {v:.3f}" for m, v in step_ms.items())
        + "; prefill ms "
        + ", ".join(f"M {m} {v:.1f}" for m, v in prefill_ms.items())
        + f"; phase {secs:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if failures:
        raise AssertionError(f"phase 26 failed: {failures}")
    return dict(step_ms=step_ms, prefill_ms=prefill_ms, seconds=secs)


# ---- slice 13: tensor parallelism over the model axis (phase 25) ----------

# phase 25's mesh: phase 10's nodes, each model split over TP_MODEL shards
TP_MODEL = 2
# the card's tensor-parallel forward against its unsharded forward in f32
# (smoke widths): the shards' partial sums add in another order, as the
# CPU tests hold them to JAX (loss 2e-6, gradients 1e-5 of each scale)
TP_F32_LOSS_RTOL, TP_F32_GRAD_ATOL = 2e-6, 1e-5
# the full-width f32 forward of node 0's first batch, 2 shards against
# unsharded: sums up to 9216 long (36x smoke's 256), so sqrt(36) x the
# smoke's 2e-6, rounded up; logits capped at +-30, 1e-3 absolute
TP_FULL_F32_RTOL, TP_FULL_F32_LOGIT_ATOL = 2e-5, 1e-3
# step 1's loss (before any exchange) on 2x2 against phase 10's unsharded
# step from the same bf16 weights. At this initialisation (embedding std
# 1/sqrt(256000)) the logits are about 0.1 and every loss sits near log V
# = 12.45294: all-zero logits would move it by ~1.4e-4 and swapped
# vocab, head or MLP shards by a few 1e-3, so this gate catches only a
# gross fault (a wrong label owner, a lost shard of the vocab sum); it
# was 1.8e-05 on the H100. The forward is held by 25b (f32 logits at
# 1e-3) and the bf16 train gradients by TP_GRAD_BF16_TOL
TP_LOSS_ATOL = 1e-3
# each node's bf16 gradient at the trained state, 2 shards against
# unsharded, leaf by leaf as max |diff| / max |unsharded|: the partial
# sums add in another order and each is rounded to bf16 (2^-8 relative)
# before the all-reduce. The H100 read 1.3e-2 at worst (blocks/1/attn/wq)
# at full width; the gate is about 3x that, while a swapped or lost shard
# moves the leaves it feeds by O(1) of their scale
TP_GRAD_BF16_TOL = 4e-2


def tp_forward_check(torch, dev="cuda"):
    """Phase 25a: the tensor-parallel forward, loss and gradients over 2
    and 4 shards against the unsharded ones, on the card, f32, gemma2-2b's
    smoke widths (M = 4 gathers K / V: its 2 KV heads split in quarters).
    Returns the failures."""
    from repro_torch import configs, tree as tree_mod
    from repro_torch.convert import shard_params, unshard_params
    from repro_torch.core.model_axis import StackModelAxis, tp_collectives
    from repro_torch.models import transformer

    cfg = configs.get_smoke_config("gemma2-2b")
    params = transformer.init_params(cfg, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device=dev)
    leaves, struct = tree_mod.flatten(params)
    mine = [v.clone().requires_grad_(True) for v in leaves]
    logits, aux = transformer.forward(tree_mod.unflatten(struct, mine), cfg,
                                      tokens)
    loss = transformer.lm_loss(logits, tokens, cfg.vocab_size, aux)
    grads = torch.autograd.grad(loss, mine)
    failures = []
    for m in (2, 4):
        axis = StackModelAxis(m, dev)
        sl, ss = tree_mod.flatten(shard_params(params, cfg, m))
        sm = [v.requires_grad_(True) for v in sl]
        tl, taux = transformer.forward(tree_mod.unflatten(ss, sm), cfg,
                                       tokens, model_axis=axis)
        tloss = transformer.lm_loss(tl, tokens, cfg.vocab_size, taux,
                                    model_axis=axis)
        tg = tree_mod.leaves(unshard_params(tree_mod.unflatten(
            ss, list(torch.autograd.grad(tloss, sm))), cfg, m))
        rel = abs(float(tloss) - float(loss)) / abs(float(loss))
        gerr = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-3))
                   for a, b in zip(tg, grads))
        want = tp_collectives(cfg, m, 2, 64, torch.float32)
        counts = all(axis.calls[op] == v["calls"] and
                     axis.bytes[op] == v["bytes"] for op, v in want.items())
        log(f"tp forward on the card, gemma2-2b smoke f32, {m} shards: loss "
            f"{float(tloss):.7f} vs unsharded {float(loss):.7f} (relative "
            f"{rel:.2e}, rtol {TP_F32_LOSS_RTOL}); gradients max |diff| / "
            f"scale {gerr:.2e} (atol {TP_F32_GRAD_ATOL}); model-axis calls "
            f"{axis.calls} == tp_collectives: {counts}")
        if not (rel <= TP_F32_LOSS_RTOL and gerr <= TP_F32_GRAD_ATOL
                and counts):
            failures.append(f"tp forward at {m} shards")
    return failures


def tp_full_width_f32(torch, cfg, m, dev="cuda"):
    """Phase 25b: node 0's first batch through ``cfg`` at full width in
    f32 (the run's initial weights, drawn in f32), over ``m`` shards and
    unsharded: loss and logits. Returns the failures."""
    from repro_torch.convert import shard_params
    from repro_torch.core.model_axis import StackModelAxis
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer

    params = transformer.init_params(cfg, seed=0, dtype=torch.float32,
                                     device=dev)
    tokens, labels = (torch.as_tensor(a[:LM_BATCH], device=dev) for a in
                      TokenStream(vocab_size=cfg.vocab_size,
                                  batch=LM_NODES * LM_BATCH, seq_len=LM_SEQ,
                                  seed=0).batch_at(0))
    axis = StackModelAxis(m, dev)
    with torch.no_grad():
        logits, aux = transformer.forward(params, cfg, tokens)
        loss = float(transformer.lm_loss(logits, labels, cfg.vocab_size,
                                         aux))
        shards = shard_params(params, cfg, m)
        del params
        tlogits, taux = transformer.forward(shards, cfg, tokens,
                                            model_axis=axis)
        tloss = float(transformer.lm_loss(tlogits, labels, cfg.vocab_size,
                                          taux, model_axis=axis))
        err = (torch.cat(list(tlogits), dim=-1) - logits).abs().max().item()
    del shards, logits, tlogits
    torch.cuda.empty_cache()
    rel = abs(tloss - loss) / abs(loss)
    log(f"tp forward at full width, {cfg.name} x{cfg.n_layers} layers f32, "
        f"node 0's first batch ({LM_BATCH} x {LM_SEQ}), {m} shards: loss "
        f"{tloss:.7f} vs unsharded {loss:.7f} (relative {rel:.2e}, rtol "
        f"{TP_FULL_F32_RTOL}); logits max |diff| {err:.3e} (atol "
        f"{TP_FULL_F32_LOGIT_ATOL}); model-axis calls {axis.calls}")
    if not (rel <= TP_FULL_F32_RTOL and err <= TP_FULL_F32_LOGIT_ATOL):
        return ["tp forward at full width in f32"]
    return []


def tp_phase(torch, np, card, dev="cuda"):
    """Phase 25 (see the module docstring). Returns (the gather-pack
    launches of the run, timing extras for the kernels line)."""
    import dataclasses

    from repro_torch import configs, prng, tree as tree_mod
    from repro_torch.core import (SDMConfig, gossip, sdm_dsgd, sparsifier,
                                  transport as tr, wire_count)
    from repro_torch.core.model_axis import StackModelAxis, tp_collectives
    from repro_torch.core.plane import ParamPlane, ShapeDtype
    from repro_torch.data import TokenStream
    from repro_torch.kernels.wire_compress import (fixedk_gather_pack,
                                                   fixedk_gather_pack_ref)
    from repro_torch.kernels.wire_compress.ops import \
        _fixedk_gather_pack_cuda
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import transformer
    from repro_torch.train import steps as steps_mod

    t_phase = time.monotonic()
    failures = tp_forward_check(torch, dev)
    base = configs.get_config("gemma2-2b")
    cfg = dataclasses.replace(base, n_layers=LM_LAYERS)
    n, m = LM_NODES, TP_MODEL
    failures += tp_full_width_f32(torch, cfg, m, dev)
    mesh = parse_mesh(f"{n}x{m}")
    sdm = SDMConfig(p=0.2, theta=0.5, gamma=1e-3, sigma=1.0, clip_c=1e-4,
                    compressor="fixedk:128")        # phase 10's
    tc = steps_mod.DistributedTrainConfig(
        model=cfg, sdm=sdm, topology="ring", method="sdm-dsgd",
        param_dtype=torch.bfloat16)
    meth, mcfg = tc.resolved()
    seq = steps_mod.gossip_schedule(tc, n)
    template = transformer.unflatten({
        k: ShapeDtype(s, torch.bfloat16)
        for k, s in transformer.param_shapes(cfg).items()})
    with steps_mod.bucket_ctx(tc, m):
        spec = ParamPlane.for_tree(template)
        bits = sdm_dsgd.transmitted_bits_per_step(template, mcfg, seq=seq)
    flat = ParamPlane.for_tree(template)
    dims = steps_mod.param_shard_dims(cfg, m)
    log(f"phase 25: {cfg.name} widths (d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), n_layers {base.n_layers}"
        f" -> {LM_LAYERS}; mesh {mesh.shape}: {n} nodes x {m} model shards "
        f"stacked on the card; {sum(d is not None for d in dims.values())} "
        f"of {len(dims)} leaves split over the model axis; "
        f"{spec.n_buckets} wire-plane buckets: "
        + "; ".join(f"{i}: key {b.key} lane {b.lane} rows {b.rows} "
                    f"({len(b.leaves)} leaves)"
                    for i, b in enumerate(spec.buckets))
        + f" (phase 10: one flat plane {flat.buckets[0].shape}; padded "
        f"{spec.padded_size} vs {flat.padded_size} elements)")

    transport = tr.StackTransport(n, dev)
    axis = StackModelAxis(m, dev)
    t0 = time.monotonic()
    state = steps_mod.init_distributed_state(tc, transport, seed=0,
                                             model_axis=axis)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 25 init {time.monotonic() - t0:.1f} s")
    per_step = []

    def on_step(t, loss, sec):
        per_step.append((dict(axis.calls), dict(axis.bytes)))
        axis.reset_counters()
        log(f"  {cfg.name} 2x2 step {t} loss {loss:.5f} ({sec * 1e3:.1f} ms)")

    fixedk_gather_pack.launches = 0
    run = train(tc, transport, steps=LM_STEPS, global_batch=n * LM_BATCH,
                seq_len=LM_SEQ, seed=0, state=state, on_step=on_step,
                model_axis=axis)
    launches = fixedk_gather_pack.launches
    peak = torch.cuda.max_memory_allocated()
    ms = np.asarray(run.step_s) * 1e3
    mode = wire_count.mode_of(meth.name, mcfg)
    calls = LM_STEPS * wire_count.permutes_per_step(
        meth.name, mode, seq, 0, n_buckets=spec.n_buckets)
    with steps_mod.bucket_ctx(tc, m):
        want_bytes = wire_count.expected_bytes_sent(meth, template, mcfg,
                                                    seq, LM_STEPS)
    formula = tp_collectives(cfg, m, LM_BATCH, LM_SEQ, tc.param_dtype)
    want_calls = {op: n * v["calls"] for op, v in formula.items()}
    want_b = {op: n * v["bytes"] for op, v in formula.items()}
    axis_ok = all(c == want_calls and b == want_b for c, b in per_step)
    ref = LM_CELLS.get("gemma2-2b", {})
    ref_loss = (ref.get("losses") or [float("nan")])[0]
    dloss = abs(run.losses[0] - ref_loss)
    tok_s = run.tokens_per_step / (ms[1:].mean() / 1e3)
    log(f"phase 25 train {cfg.name} x{LM_LAYERS} layers bf16 on 2x2, "
        f"sdm-dsgd {seq.name} fixedk:128 sigma 1.0 clip_c 1e-4, seq "
        f"{LM_SEQ}, batch {LM_BATCH}/node, {LM_STEPS} steps on {card}: step "
        f"ms mean {ms.mean():.3f} p50 {np.percentile(ms, 50):.3f} (first "
        f"{ms[0]:.3f}; steps 2.. mean {ms[1:].mean():.3f}; phase 10 "
        f"unsharded {ref.get('step_ms', float('nan')):.3f}); {tok_s:.1f} "
        f"tokens/s; peak memory {peak / 1e9:.3f} GB (phase 10 "
        f"{ref.get('peak_bytes', 0) / 1e9:.3f}); losses "
        f"{[round(v, 5) for v in run.losses]}; step 1 loss "
        f"{run.losses[0]:.6f} vs phase 10's {ref_loss:.6f}: |diff| "
        f"{dloss:.3e} (atol {TP_LOSS_ATOL}); ppermutes {transport.permutes} "
        f"== {LM_STEPS} x {calls // LM_STEPS} ({spec.n_buckets} buckets x "
        f"{wire_count.expected_permutes(meth.name, mode, seq)} rounds x "
        f"payload tensors); wire bits per node per step {bits} (bytes sent "
        f"{sorted(set(transport.bytes_sent.values()))} == accounting: "
        f"{transport.bytes_sent == want_bytes}); model-axis collectives a "
        f"step ({n} nodes' gradients) {per_step[0][0]} calls, "
        f"{per_step[0][1]} bytes == tp_collectives x {n} in every step: "
        f"{axis_ok}; fixedk_gather_pack launches {launches} == steps x "
        f"buckets {LM_STEPS * spec.n_buckets}")
    if not all(math.isfinite(v) for v in run.losses):
        failures.append("non-finite loss")
    if not dloss <= TP_LOSS_ATOL:
        failures.append(f"step 1 loss {run.losses[0]} vs phase 10's "
                        f"{ref_loss}")
    if transport.permutes != calls or transport.bytes_sent != want_bytes:
        failures.append("wire counters disagree with the accounting")
    if not axis_ok or want_calls["all_reduce"] == 0:
        failures.append("model-axis collectives disagree with the formula")
    if launches != LM_STEPS * spec.n_buckets:
        failures.append(f"fixedk_gather_pack launched {launches} times")

    # ---- what the model axis and the buckets cost ----------------------
    # each node's gradient with and without the model axis (P C C P), and
    # the exchange (selection, kernel, permutes, unpack) over the buckets
    st = run.state
    tok = steps_mod.node_batch(torch.as_tensor(
        TokenStream(vocab_size=cfg.vocab_size, batch=n * LM_BATCH,
                    seq_len=LM_SEQ, seed=0).batch_at(0)[0], device=dev),
        transport)
    grad_ms = {"unsharded": [], "2 shards": []}
    kept = {}
    with phase_clock(torch, "phase 25 gradients timed (P C C P)", card):
        for label in ("unsharded", "2 shards", "2 shards", "unsharded"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, _ = steps_mod.node_grads(
                cfg, st.x, tok, tok,
                model_axis=axis if label == "2 shards" else None)
            torch.cuda.synchronize()
            grad_ms[label].append((time.perf_counter() - t0) * 1e3)
            kept.setdefault(label, g)
            del g
        kw = dict(base_key=prng.PRNGKey(0, device=dev), transport=transport,
                  cfg=mcfg, schedule=seq)
        adv = []
        with steps_mod.bucket_ctx(tc, m):
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sdm_dsgd.distributed_advance(st, **kw)
                torch.cuda.synchronize()
                adv.append((time.perf_counter() - t0) * 1e3)
    gerr = {}
    for key, want in tree_mod.flatten_with_paths(kept["unsharded"]).items():
        got = tree_mod.flatten_with_paths(kept["2 shards"])[key]
        gerr[key] = float((got.float() - want.float()).abs().max()
                          / want.float().abs().max().clamp_min(1e-30))
    del kept
    worst = max(gerr, key=gerr.get)
    log(f"phase 25 bf16 gradients at the trained state, both nodes, 2 "
        f"shards vs unsharded, max |diff| / scale per leaf: worst {worst} "
        f"{gerr[worst]:.3e} (tol {TP_GRAD_BF16_TOL}); "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(gerr.items())))
    if not gerr[worst] <= TP_GRAD_BF16_TOL:
        failures.append(f"bf16 tp gradient {worst} off by {gerr[worst]}")
    log(f"phase 25 parts on {card}: both nodes' gradients (forward + "
        f"backward, host wall, synchronised) unsharded "
        f"{[round(v, 3) for v in grad_ms['unsharded']]} ms, over 2 shards "
        f"{[round(v, 3) for v in grad_ms['2 shards']]} ms; "
        f"distributed_advance over the {spec.n_buckets} buckets "
        f"{[round(v, 3) for v in adv]} ms (phase 10, one flat plane: see "
        f"its breakdown)")
    extra = dict(grad_ms=grad_ms, advance_ms=adv)

    # ---- the kernel at every bucket's shape ----------------------------
    key = prng.PRNGKey(0, device=dev)
    rows = []
    for b, dplane in enumerate(st.d):
        db = dplane.reshape(n, -1, 128)
        nb = db.shape[1]
        kb = math.ceil(0.2 * nb)
        idx = sparsifier.fixedk_indices(gossip.node_round_key(
            prng.fold_in(key, b), transport.me, st.step), nb, kb
        ).to(torch.int32)
        scale = nb / kb
        got = fixedk_gather_pack(db, idx, scale=scale)
        want = fixedk_gather_pack_ref(db, idx, scale=scale)
        same = torch.equal(got, want)
        err = (got - want).abs().max().item()
        del got, want
        gidx = (idx.long() + (torch.arange(n, device=dev) * nb)[:, None]
                ).reshape(-1)
        flat_rows = db.reshape(n * nb, 128)
        ker_ms, _ = cuda_ms(torch, lambda i: _fixedk_gather_pack_cuda(
            db, idx, scale=scale), iters=20)
        plain_ms, _ = cuda_ms(torch, lambda i: fixedk_gather_pack_ref(
            db, idx, scale=scale), iters=10)
        lib_ms, _ = cuda_ms(torch, lambda i: torch.index_select(
            flat_rows, 0, gidx), iters=20)
        bound_ms = cost.fixedk_gather_pack(n, kb, 128).nbytes \
            / HBM_BYTES_PER_S * 1e3
        bk = spec.buckets[b]
        rows.append(dict(bucket=b, key=str(bk.key), lane=bk.lane,
                         plane=list(dplane.shape), nb=nb, kb=kb, ms=ker_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, max_abs_err=err, equal=same))
        log(f"fixedk_gather_pack at bucket {b} (key {bk.key}, lane "
            f"{bk.lane}, plane {tuple(dplane.shape)} -> (L={n}, nb={nb}, "
            f"kb={kb}, block 128)): kernel == plain (torch.equal) {same}; "
            f"kernel {ker_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"index_select {lib_ms * 1e3:.2f} us, bound "
            f"{bound_ms * 1e3:.2f} us (bytes) on {card}")
        if not same:
            failures.append(f"fixedk_gather_pack disagrees at bucket {b}")
    log(f"phase 25 in all: {time.monotonic() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"phase 25 failed: {failures}")
    return launches, dict(buckets=rows, step_ms=float(ms[1:].mean()),
                          peak_bytes=peak, **extra)


LINT_BUDGET_S = 60.0


def lint_phase(torch, card, dev="cuda"):
    """Phase 24: the static auditor's matrix traced on the card (see the
    module docstring). Returns the wire kernels' launches during the
    traces. CPU rehearsal: ``dev="cpu"`` with ``torch.cuda.synchronize``
    stubbed (no kernel nodes there: the plain versions run)."""
    from repro_torch.analysis import graph_taint, wire_audit

    t0 = time.monotonic()
    log(f"phase 24 on {card}: {len(wire_audit.MATRIX)} configs, "
        f"{wire_audit.STEPS} steps each on StackTransport"
        f"({wire_audit.N_NODES}, {dev})")
    launches = {"fixedk_gather_pack": 0, "qsgd_pack": 0}
    failures = []
    for ac in wire_audit.MATRIX:
        t1 = time.monotonic()
        row = wire_audit.audit_config(ac, device=dev)
        torch.cuda.synchronize()
        g = row["graph"]
        bad = {k: row[k] for k in ("taint", "prng", "wire", "sensitivity",
                                   "calibration", "range", "overlap")
               if row[k]}
        for key in launches:
            launches[key] += g["kernel_launches"][key]
        want = []
        if "fixedk_packed" in ac.mode:
            want.append("fixedk_gather_pack")
        if ac.mode == "qsgdf:4":
            want.append("qsgd_pack")
        kernels_ok = dev == "cpu" or all(
            g["kernel_nodes"][k] > 0
            and g["kernel_launches"][k] == g["kernel_nodes"][k]
            for k in want)
        log(f"  {row['id']:48s} {row['status']} n_draws={row['n_draws']} "
            f"sanitize={row['n_sanitize_sites']} nodes={g['nodes']} "
            f"kernel nodes={g['kernel_nodes']} launches="
            f"{g['kernel_launches']} {time.monotonic() - t1:.2f} s"
            + (f" findings={bad}" if bad else ""))
        if row["status"] != "pass" or not kernels_ok:
            failures.append(row["id"])
    for cid in ("allreduce/ring4/-/dirty",
                "sdm-dsgd/ring4/fixedk_packed/dirty"):
        ac = next(a for a in wire_audit.MATRIX if a.id == cid)
        b = wire_audit.build(ac, dev)
        kinds = [f["kind"] for f in graph_taint.analyze_taint(
            b.gm, {1: "data", 2: "data"})["findings"]]
        log(f"  negative control {cid}: taint findings {kinds}")
        for key in launches:
            launches[key] += b.launches[key]
        if kinds != ["tainted-collective"]:
            failures.append(cid)
    ac = next(a for a in wire_audit.MATRIX
              if a.id == "sdm-dsgd/ring4/fixedk_packed+ov/sigma1")
    b = wire_audit.build(ac, dev)
    x_graph, loss_graph = b.gm(*b.args)
    x_eager, loss_eager = wire_audit.run_eager(ac, dev)
    torch.cuda.synchronize()
    same = bool(torch.equal(x_graph, x_eager)
                and torch.equal(loss_graph, loss_eager))
    log(f"  {ac.id}: the traced graph run again == an untraced run of the "
        f"same {wire_audit.STEPS} steps (final x and loss, torch.equal): "
        f"{same}")
    if not same:
        failures.append("traced != untraced")
    secs = time.monotonic() - t0
    log(f"phase 24: {secs:.1f} s (budget {LINT_BUDGET_S:.0f} s) on {card}; "
        f"wire kernel launches during the traces {launches}")
    if failures or secs > LINT_BUDGET_S:
        raise AssertionError(f"phase 24 failed: {failures}, {secs:.1f} s")
    return launches


def ptxas_entries(text: str):
    """{mangled kernel name: (registers, spill store bytes)} from an
    ``nvcc -Xptxas -v`` log."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?(\d+) bytes "
                         r"spill stores.*?Used (\d+) registers", text,
                         re.S):
        out[m.group(1)] = (int(m.group(3)), int(m.group(2)))
    return out


def kernel_resources(libs):
    """Registers, spills and resident blocks per SM of the two attention
    kernels' instances on the main paths: flash at every head_dim in
    both types (blocks per SM from ``flash_attn_blocks_per_sm``), and the
    serving shape's paged-decode and merge instances (bf16, dh 256,
    group 2)."""
    import ctypes

    from repro_torch.kernels._build import load_library

    occ = load_library("flash_attn").flash_attn_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    occ.restype = ctypes.c_int
    res = {"flash_attn": [], "paged_decode": []}
    for name, (regs, spill) in ptxas_entries(
            libs["flash_attn"].with_suffix(".log").read_text()).items():
        m = re.search(r"flash_(bf16|fwd)_kernelI(?:f)?Li(\d+)E", name)
        dtype, dh = ("bf16" if m.group(1) == "bf16" else "f32"), int(
            m.group(2))
        blocks = ctypes.c_int(0)
        rc = occ(dh, 1 if dtype == "bf16" else 0, ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"flash_attn_blocks_per_sm: CUDA error {rc}")
        res["flash_attn"].append(dict(
            instance=f"{dtype} dh{dh}", registers=regs, spill_stores=spill,
            blocks_per_sm=blocks.value))
    for name, (regs, spill) in ptxas_entries(
            libs["paged_decode"].with_suffix(".log").read_text()).items():
        if "paged_merge_kernelI13__nv_bfloat16" in name:
            inst = "merge bf16"
        elif "paged_decode_kernelI13__nv_bfloat16Li8ELi2ELi4E" in name:
            inst = "split bf16 dh256 G2 U4"
        else:
            continue
        res["paged_decode"].append(dict(
            instance=inst, registers=regs, spill_stores=spill,
            blocks_per_sm=None))
    bad = [r["instance"] for r in res["flash_attn"]
           if r["instance"].startswith("bf16") and r["spill_stores"]]
    if bad:
        raise AssertionError(f"flash bf16 instances spill: {bad}")
    return res


def path_kernels():
    """Every kernel of the path: {name: (record, wrapper with a
    ``.launches`` count)}."""
    from repro_torch.kernels.flash_attn.decode import paged_attention
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.kernels.sdm_update import sdm_update_planes
    from repro_torch.kernels.wire_compress import (fixedk_gather_pack,
                                                   qsgd_pack)

    return {
        "paged_decode": (dict(
            name="paged_decode", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_decode.cu",
            replaces="src/repro/kernels/flash_attn/decode.py:123"),
            paged_attention),
        "qsgd_pack": (dict(
            name="qsgd_pack", route="cuda",
            source="src/repro_torch/kernels/csrc/wire_compress.cu",
            replaces="src/repro/kernels/wire_compress/wire_compress.py:95"),
            qsgd_pack),
        "fixedk_gather_pack": (dict(
            name="fixedk_gather_pack", route="cuda",
            source="src/repro_torch/kernels/csrc/wire_compress.cu",
            replaces="src/repro/kernels/wire_compress/wire_compress.py:125"),
            fixedk_gather_pack),
        "sdm_update": (dict(
            name="sdm_update", route="cuda",
            source="src/repro_torch/kernels/csrc/sdm_update.cu",
            replaces="src/repro/kernels/sdm_update/sdm_update.py:96"),
            sdm_update_planes),
        "flash_attn": (dict(
            name="flash_attn", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attn.cu",
            replaces="src/repro/kernels/flash_attn/flash_attn.py:100"),
            flash_attention),
    }


# the script's start, for the phase marks
T_MAIN = 0.0


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
    from repro_torch.kernels.flash_attn.decode import (SplitPlan,
                                                       _paged_decode_cuda,
                                                       paged_attention,
                                                       paged_attention_ref,
                                                       split_plan)
    from repro_torch.models import transformer

    global T_MAIN
    T_MAIN = time.monotonic()
    kernels = path_kernels()
    memo_token_batches()

    # ---- 1. card and build ----------------------------------------------
    log(f"-- phase 1 at {time.monotonic() - T_MAIN:.1f} s")
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
    resources = kernel_resources(libs)
    for key, rows in resources.items():
        for r in rows:
            log(f"  {key} {r['instance']}: {r['registers']} registers, "
                f"{r['spill_stores']} bytes spill stores, "
                f"{r['blocks_per_sm']} blocks per SM")

    # ---- 2. kernels against their plain versions -------------------------
    log(f"-- phase 2 at {time.monotonic() - T_MAIN:.1f} s")
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
    # the same call under other split plans, P pages per split (the
    # shipped plan is split_plan's; P = sb is one split, no merge)
    plan = split_plan(8, shape["kvh"], shape["group"], shape["dh"], sb)
    sweep = {}
    for pages in sorted({1, 2, 4, plan.pages_per_split, 8, 16, sb}):
        n_sp = -(-sb // pages)
        alt = SplitPlan(pages, n_sp, (8, 8, n_sp, 258) if n_sp > 1 else None)
        sweep[pages], _ = cuda_ms(torch, lambda i: _paged_decode_cuda(
            q, *kv[i % 8], tbl, sl, window=None, softcap=50.0, plan=alt),
            iters=208)
    log(f"paged_decode split plans at the serving shape (P pages per "
        f"split: device us): "
        + ", ".join(f"P {p} (S {-(-sb // p)}) {t * 1e3:.2f}"
                    for p, t in sweep.items())
        + f"; shipped split_plan: P {plan.pages_per_split}, S "
        f"{plan.n_splits}")
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
        split_plan=dict(pages_per_split=plan.pages_per_split,
                        n_splits=plan.n_splits),
        split_sweep_ms={str(p): t for p, t in sweep.items()},
        max_abs_err=max(errs + [serve_err]))}
    del q, kv, tbl, sl, kg, vg, got, want
    torch.cuda.empty_cache()

    # ---- 3. the main path: serve gemma2-2b --------------------------------
    log(f"-- phase 3 at {time.monotonic() - T_MAIN:.1f} s")
    cfg = configs.get_config("gemma2-2b")
    params = init_model(torch, np, cfg, seed=0, dtype=torch.bfloat16)
    # the serving path's kernels; the training path's are read in phase 6
    launches = serve_ragged(torch, np, cfg, params, card, kernels,
                            ker_ms=ker_ms)
    n_attn = attn_layers(cfg)
    del params
    torch.cuda.empty_cache()

    # ---- 4. end to end against plain, f32 ---------------------------------
    log(f"-- phase 4 at {time.monotonic() - T_MAIN:.1f} s")
    params = transformer.init_params(cfg, seed=1, dtype=torch.float32,
                                     device="cuda")
    e2e = paged_vs_dense(torch, np, cfg, params, seed=1)
    paged, dense = e2e["paged"], e2e["dense"]
    diff = (paged - dense).abs().max().item()
    finite = bool(torch.isfinite(paged).all() and torch.isfinite(dense).all())
    same_top = (paged.argmax(-1) == dense.argmax(-1)).float().mean().item()
    log(f"e2e f32 gemma2-2b, {cfg.n_layers} layers, prompts "
        f"{e2e['lens'].tolist()}: max|paged(kernel) - dense(plain)| logits = "
        f"{diff:.3e} (atol {LOGIT_ATOL}); |logits| max "
        f"{dense.abs().max().item():.2f}; argmax agreement {same_top:.2f}; "
        f"kernel launches {e2e['launches']}; finite {finite}")
    if not (finite and diff <= LOGIT_ATOL and e2e["launches"] == n_attn
            and tuple(paged.shape) == (len(e2e["lens"]), cfg.padded_vocab)):
        raise AssertionError("paged-kernel logits disagree with the dense "
                             "plain path")
    nxt, kv, lens = e2e["next"], e2e["kv"], e2e["lens_dev"]
    b = len(e2e["lens"])
    # host work per decode step: ATen ops the eager step dispatches
    from repro_torch.bench.counting import OpCount

    with torch.no_grad(), OpCount() as ops:
        transformer.decode_step_paged(
            params, cfg, nxt, kv.pages, kv.tables(), lens + 1,
            torch.ones(b, dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    log(f"decode_step_paged dispatches {ops.total} ATen ops per step "
        f"({ops.total / cfg.n_layers:.1f} per layer) plus {n_attn} kernel "
        f"launches through ctypes; most frequent: "
        f"{ops.by_name.most_common(12)}")

    del params, e2e, kv
    torch.cuda.empty_cache()

    # ---- 5.-7. the training path (Algorithm 1, qsgdf wire) ----------------
    log(f"-- phase 5.-7 at {time.monotonic() - T_MAIN:.1f} s")
    timing["qsgd_pack"] = qsgd_pack_phase(torch)
    launches.update(training_phases(torch, np, kernels, card))
    torch.cuda.empty_cache()

    # ---- 8.-10. the distributed LM slice (fixedk_packed wire) --------------
    log(f"-- phase 8.-10 at {time.monotonic() - T_MAIN:.1f} s")
    # earlier phases' objects can sit in reference cycles: collect them so
    # the full-width slice starts from an empty card
    gc.collect()
    torch.cuda.empty_cache()
    log(f"before the LM slice: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated")
    bad = [r for r in gather_pack_cases(torch) if r != (True, 1)]
    if bad:
        raise AssertionError("fixedk_gather_pack disagrees with its plain "
                             "version")
    failures = executor_phase(torch, np)
    if failures:
        raise AssertionError(f"executor vs reference failed: {failures}")
    torch.cuda.empty_cache()
    lm = lm_phase(torch, np, card)
    if lm.pop("failures"):
        raise AssertionError(f"lm slice failed: {lm}")
    launches["fixedk_gather_pack"] = lm.pop("launches")
    timing["fixedk_gather_pack"] = lm
    del lm
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11.-15. the fused update, prefill flash, kernel_bench, push -------
    log(f"-- phase 11.-15 at {time.monotonic() - T_MAIN:.1f} s")
    timing["sdm_update"] = sdm_update_phase(torch, card)
    timing["flash_attn"] = flash_phase(torch, card)
    bench_launches, bench_err = kernel_bench_phase(torch, kernels)
    launches.update(bench_launches)
    for key, err in bench_err.items():
        timing[key]["max_abs_err_bench_shape"] = err
    failures = push_mlr_phase(torch, np, card)
    if failures:
        raise AssertionError(f"gradient-push checks failed: {failures}")
    push_resnet_phase(torch, np, card)

    # ---- 16.-17. the paper's experiments and the edge-fleet simulator -----
    log(f"-- phase 16.-17 at {time.monotonic() - T_MAIN:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    paper_phase(torch, np, card)
    launches["qsgd_pack"] += sim_phase(torch, np, card)

    # ---- 18.-19. the gates on the card, the three dense configs ------------
    log(f"-- phase 18.-19 at {time.monotonic() - T_MAIN:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in gates_phase(torch, card, kernels).items():
        launches[key] += n
    gc.collect()
    torch.cuda.empty_cache()
    dense_launches, timing["paged_decode"]["dense_layouts"] = \
        dense_configs_phase(torch, np, card, kernels)
    launches["paged_decode"] += dense_launches

    # ---- 20. the MoE and recurrent families ---------------------------------
    log(f"-- phase 20 at {time.monotonic() - T_MAIN:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches, timing["paged_decode"]["moe_recurrent_layouts"] = \
        moe_recurrent_phase(torch, np, card, kernels)
    for key, n in moe_launches.items():
        launches[key] += n

    # ---- 21. the encoder families ----------------------------------------
    log(f"-- phase 21 at {time.monotonic() - T_MAIN:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    enc_launches, timing["paged_decode"]["encoder_layouts"] = \
        encoder_families_phase(torch, np, card, kernels)
    for key, n in enc_launches.items():
        launches[key] += n

    # ---- 22. the exchange in flight, ring helpers, optimizers, checkpoint
    log(f"-- phase 22 at {time.monotonic() - T_MAIN:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    with phase_clock(torch, "phase 22 in all", card):
        n, timing["fixedk_gather_pack"]["phase22"] = overlap_library_phase(
            torch, np, card)
    launches["fixedk_gather_pack"] += n

    # ---- 23. the dry-run and roofline against the LM cells -----------------
    log(f"-- phase 23 at {time.monotonic() - T_MAIN:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase(torch, card)

    # ---- 24. the static auditor on the card --------------------------------
    log(f"-- phase 24 at {time.monotonic() - T_MAIN:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    for key, n in lint_phase(torch, card).items():
        launches[key] += n

    # ---- 25. tensor parallelism over the model axis ------------------------
    log(f"-- phase 25 at {time.monotonic() - T_MAIN:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    n, timing["fixedk_gather_pack"]["phase25"] = tp_phase(torch, np, card)
    launches["fixedk_gather_pack"] += n

    # ---- 26. the serving steps over the model axis -------------------------
    log(f"-- phase 26 at {time.monotonic() - T_MAIN:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    tp_serving_phase(torch, np, card)

    # ---- results -----------------------------------------------------------
    log(f"-- phase results at {time.monotonic() - T_MAIN:.1f} s")
    for key, rows in resources.items():
        timing[key]["ptxas"] = rows
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
