"""Kernel micro-benchmarks: each CUDA kernel against its plain version.

Port of ``benchmarks/kernel_bench.py``. Prints ``name,us,derived``
lines: the gossip schedules' structural cost per topology (rounds,
degrees, dense / packed wire bytes and bits: the same derived columns as
the JAX script), then the fused SDM update and prefill flash attention,
each as its plain PyTorch version (``*_plain``) and through the kernel's
wrapper (``*_cuda`` on the card; on the CPU the wrapper runs the plain
version and the line is ``*_cpu_plain``). Times are CUDA-event device
times on the card, host times on the CPU.

  PYTHONPATH=src python -m repro_torch.bench.kernel_bench                # the card
  PYTHONPATH=src python -m repro_torch.bench.kernel_bench --device cpu
  PYTHONPATH=src python -m repro_torch.bench.kernel_bench --topology er:0.35 --nodes 8
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.bench import common
from repro_torch.core import compressor as compressor_mod, gossip, sparsifier
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.flash_attn.ref import flash_attention_ref
from repro_torch.kernels.sdm_update import (LANE, sdm_update_planes,
                                            sdm_update_ref)

__all__ = ["GOSSIP_TOPOLOGIES", "run_gossip_schedules", "run_sdm_update",
           "run_flash", "run"]

GOSSIP_TOPOLOGIES = ("ring", "torus", "er:0.35", "star", "complete",
                     "dring", "der:0.35", "matchings:4")

# the CUDA flash kernel's on-chip score tile: 64 queries x 64 keys, f32
_FLASH_TILE_BYTES = 64 * 64 * 4


def _route(dev: torch.device) -> str:
    return "cuda" if dev.type == "cuda" else "cpu_plain"


def run_gossip_schedules(topologies=GOSSIP_TOPOLOGIES, n_nodes: int = 16,
                         d: int = 1 << 20, p: float = 0.1, device="cuda"):
    """Structural cost of (Schedule-Sequence) gossip per topology:
    permute ROUNDS per step and wire BYTES / BITS per node per step, dense
    against packed fixed-k (exactly the p-fraction); the time is one
    ``mix_dense`` of (n, 256) on ``device``. Directed graphs and
    time-varying sequences report the per-step mean degree over a cycle.
    """
    dev = resolve_device(device)
    kb = sparsifier.num_kept(d, p)
    comp = compressor_mod.make("fixedk", p=p)
    packed_bits_idx = comp.wire_bits((d,))
    packed_bits_sync = comp.wire_bits((d,), index_sync=True)
    for spec in topologies:
        seq = gossip.sequence_by_name(spec, n_nodes)
        wstack = seq.weights_stack()
        off = wstack - np.einsum("lij,ij->lij", wstack,
                                 np.eye(seq.n_nodes))
        mean_deg = float(np.mean((np.abs(off) > 1e-12).sum(axis=2)))
        dense = mean_deg * d * 4
        packed = mean_deg * kb * 4
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=(n_nodes, 256)), dtype=torch.float32, device=dev)
        w = torch.as_tensor(wstack[0], dtype=torch.float32, device=dev)
        us = common.timeit_us(gossip.mix_dense, w, x, iters=50)
        common.emit(
            f"gossip_schedule_{seq.name}", us,
            f"rounds={seq.n_rounds};seq_len={seq.length};"
            f"mean_degree={mean_deg:.2f};"
            f"dense_bytes/node/step={dense:.0f};"
            f"packed_bytes/node/step={packed:.0f};"
            f"packed_fraction={packed / dense:.4f};"
            f"packed_bits/node/step={mean_deg * packed_bits_sync:.0f};"
            f"packed_bits_explicit_idx={mean_deg * packed_bits_idx:.0f};"
            "index_overhead_frac="
            f"{packed_bits_idx / packed_bits_sync - 1.0:.4f}")


def run_sdm_update(rows: int = 64, device="cuda", rng=None):
    """The fused update over (rows, 1024) planes: 7 input and 3 output
    tensors, one pass each (10 tensor touches; the unfused chain touches
    ~22: clip, noise add, the mixing axpys, mask, scale, 3 state
    updates). Returns what it timed, ``(ops, kwargs)`` of
    ``sdm_update_planes(*ops, **kwargs)``, so that a caller can hold the
    kernel against the plain version on the same tensors."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    shape = (rows, LANE)

    def f():
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev)

    def bits():
        words = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
        return torch.from_numpy(words.view(np.int32)).to(dev)

    ops = (f(), f(), f(), f(), bits(), bits(), bits())
    kw = dict(p=0.25, theta=0.4, gamma=0.05, sigma=0.7, clip_c=1.5,
              self_w=1.0 / 3.0)
    us_ref = common.timeit_us(lambda *a: sdm_update_ref(*a, **kw), *ops,
                              iters=50)
    bytes_moved = 10 * rows * LANE * 4
    common.emit("sdm_update_plain", us_ref,
                f"bytes/call={bytes_moved};fused_tensor_touches=10_vs_22")
    kw_k = dict(kw, block_rows=32)
    us_k = common.timeit_us(lambda *a: sdm_update_planes(*a, **kw_k), *ops,
                            iters=50)
    common.emit(f"sdm_update_{_route(dev)}", us_k, f"bytes/call={bytes_moved}")
    return ops, kw_k


def run_flash(b: int = 1, s: int = 256, h: int = 4, kvh: int = 4,
              dh: int = 64, device="cuda", rng=None):
    """Causal prefill attention: streaming (64 x 64) tiles against dense
    scores. Returns the ``(q, k, v)`` it timed."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng

    def t(heads):
        return torch.as_tensor(rng.normal(size=(b, s, heads, dh)),
                               dtype=torch.float32, device=dev)

    q, k, v = t(h), t(kvh), t(kvh)
    us_ref = common.timeit_us(flash_attention_ref, q, k, v, iters=50)
    common.emit("flash_attn_plain", us_ref,
                f"dense_scores_bytes={b * h * s * s * 4};"
                f"flash_tile_bytes={_FLASH_TILE_BYTES}")
    us_k = common.timeit_us(flash_attention, q, k, v, iters=50)
    common.emit(f"flash_attn_{_route(dev)}", us_k,
                f"flops={4 * dh * h * b * s * (s + 1) // 2}")
    return q, k, v


def run(device="cuda"):
    """The whole sweep at JAX's default shapes; returns the inputs each
    kernel was timed on: ``{"sdm_update": (ops, kwargs), "flash_attn":
    (q, k, v)}``."""
    run_gossip_schedules(device=device)
    rng = np.random.default_rng(0)
    return {"sdm_update": run_sdm_update(device=device, rng=rng),
            "flash_attn": run_flash(device=device, rng=rng)}


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--topology", default=None,
                    help="bench only this gossip topology "
                         "(default: the full sweep)")
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.topology is not None:
        run_gossip_schedules((args.topology,), n_nodes=args.nodes,
                             device=args.device)
    else:
        run(device=args.device)
