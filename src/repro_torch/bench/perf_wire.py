"""Wire-plane perf snapshot -> BENCH_perf_torch.json.

Port of ``benchmarks/perf_wire.py``, on its cases: 9 (method, topology,
mode, overlap) cases, 8 nodes, the multi-leaf ``PARAM_SHAPES`` tree,
each method's config, key 0 and the ``pp * 0.01`` gradient. Each case
runs 2 steps of ``method.get(name).make_distributed(seq, cfg,
StackTransport(8, device))`` and records, over the SECOND step (the
first ships the constant d_0, which the JAX script's two-step scan exists
to get past):

    permutes_per_step   the transport's ppermute calls (one per payload
                        tensor a round, as each is one collective-permute
                        in the JAX package)
    wire_bits_sent      bits node 0 puts on the wire, from the transport's
                        byte counter: what the JAX script reads from the
                        compiled permutes' payloads (``wire_bits_hlo``)
    wire_bits_acc       the static accounting's per-step prediction
    schedule_rounds / n_leaves / plane_shapes
    sort_count          ``aten.sort`` + ``aten.topk`` calls: one per
                        fixed-k index draw. The JAX script counts the
                        HLO's ``sort`` ops only, and XLA's CPU backend
                        lowers some ``lax.top_k`` draws to a ``TopK``
                        custom call instead, so there it can read lower
    aten_ops / launches ATen ops dispatched / those that are not views
                        (``bench.counting``)
    kernel_launches     on CUDA, the device kernels the step launches;
                        ``ported_kernel_launches`` the hand-written ones
                        among them (``qsgdf:4`` runs ``qsgd_pack``, the
                        scalar-p f32 ``fixedk_packed`` view
                        ``fixedk_gather_pack``)
    overlap_efficiency  fraction of wire time hidden under compute for
                        the overlapped transport, under the JAX script's
                        nominal machine model (1e12 flop/s, 1.25e9 wire
                        bytes/s); 0.0 for overlap off. The flops are
                        ``torch.utils.flop_counter.FlopCounterMode``'s
                        count of the step, floored at its ATen op count
                        as the JAX script floors at its HLO instruction
                        count: not the number the JAX script reports,
                        whose flops come from XLA's cost analysis

Wall-clock is not recorded: these are the structural numbers.
``baselines/perf_wire.json`` holds, per device (``"cpu"``, ``"cuda"``),
the records that ``check_perf`` gates against.

  PYTHONPATH=src python -m repro_torch.bench.perf_wire             # card
  PYTHONPATH=src python -m repro_torch.bench.perf_wire --device cpu
  PYTHONPATH=src python -m repro_torch.bench.check_perf

Baseline refresh (an intended change of structure): add
``--update-baseline`` to the first command, on each device, and commit
the diff.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.bench.counting import KernelLaunches, OpCount

__all__ = ["run", "CASES", "PARAM_SHAPES", "N_NODES", "OUT_PATH", "BASELINE",
           "BASELINE_KEYS", "case_id"]

OUT_PATH = "BENCH_perf_torch.json"
BASELINE = os.path.join(os.path.dirname(__file__), "baselines",
                        "perf_wire.json")

CASES = [
    # (method, topology, mode, overlap)
    ("sdm-dsgd", "ring", "fixedk_packed", False),
    ("sdm-dsgd", "ring", "bernoulli", False),
    ("sdm-dsgd", "ring", "qsgd:4", False),
    ("sdm-dsgd-fused", "ring", "fixedk_rows", False),
    ("dsgd", "ring", "-", False),
    ("gradient-push", "dring", "fixedk", False),
    # fused single-buffer quantizer: 1 payload tensor, 1 pack kernel
    # launch; must beat qsgd:4 on launches AND permutes_per_step
    ("sdm-dsgd", "ring", "qsgdf:4", False),
    # overlapped one-step-stale transport: same wire, hidden latency
    ("sdm-dsgd", "ring", "fixedk_packed", True),
    ("sdm-dsgd", "ring", "qsgdf:4", True),
]
N_NODES = 8

# nominal edge-fleet machine model for the overlap_efficiency estimate
NOMINAL_FLOPS_PER_S = 1.0e12
NOMINAL_WIRE_BYTES_PER_S = 1.25e9          # 10 Gb/s edge uplink

# multi-leaf tree (the leaf-count-independence witness)
PARAM_SHAPES = {"emb": (9, 33), "w1": (64, 7), "b1": (71,),
                "w2": (3, 5, 11), "b2": (13,)}

# the record fields the baseline pins, per device
BASELINE_KEYS = {
    "cpu": ("permutes_per_step", "launches", "aten_ops", "wire_bits_sent",
            "wire_bits_acc"),
    "cuda": ("permutes_per_step", "launches", "aten_ops", "kernel_launches",
             "wire_bits_sent", "wire_bits_acc"),
}


def case_id(meth_name: str, topo_spec: str, mode: str,
            overlap: bool) -> str:
    return f"{meth_name}/{topo_spec}/{mode}" + ("+ov" if overlap else "")


def _config(meth, mode: str, overlap: bool):
    from repro_torch.core import baselines, gradient_push, sdm_dsgd

    if meth.config_cls is sdm_dsgd.SDMConfig:
        kw = dict(p=0.25, theta=0.15, gamma=0.1, overlap=overlap)
        return meth.coerce_config(sdm_dsgd.SDMConfig(
            **(dict(kw, compressor=mode)
               if mode.split(":")[0] in ("qsgd", "qsgdf")
               else dict(kw, mode=mode))))
    if meth.config_cls is gradient_push.GradientPushConfig:
        return gradient_push.GradientPushConfig(
            gamma=0.1, compressor=None if mode == "-" else mode, p=0.25,
            overlap=overlap)
    return baselines.DSGDConfig(gamma=0.1)


def _record(meth_name, topo_spec, mode, overlap, device) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import prng, tree as tree_mod
    from repro_torch.core import (gossip, method as method_mod,
                                  plane as plane_mod, sdm_dsgd, topology,
                                  transport as transport_mod)
    from repro_torch.kernels.wire_compress import (fixedk_gather_pack,
                                                   qsgd_pack)

    n = N_NODES
    meth = method_mod.get(meth_name)
    topo = topology.directed_ring(n) if topo_spec == "dring" \
        else topology.by_name(topo_spec, n)
    seq = gossip.ensure_sequence(gossip.schedule_from_topology(topo))
    cfg = _config(meth, mode, overlap)

    rng = np.random.default_rng(0)
    p0 = {k: torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
          for k, s in PARAM_SHAPES.items()}
    stack = {k: v[None].expand((n,) + tuple(v.shape)).clone().to(device)
             for k, v in p0.items()}
    transport = transport_mod.StackTransport(n, device)
    ex = meth.make_distributed(seq, cfg, transport)
    key = prng.PRNGKey(0, device=device)

    def grads(pp):
        return tree_mod.tree_map(lambda v: v * 0.01, pp), 0.0

    state = ex.init(stack)
    state, _ = ex.step(state, grads, base_key=key)
    transport.reset_counters()
    ported0 = (qsgd_pack.launches, fixedk_gather_pack.launches)
    flops = FlopCounterMode(display=False)
    with KernelLaunches(device) as kl, flops, OpCount() as ops:
        state, _ = ex.step(state, grads, base_key=key)
    ported = {"qsgd_pack": qsgd_pack.launches - ported0[0],
              "fixedk_gather_pack": fixedk_gather_pack.launches - ported0[1]}

    if meth.config_cls is sdm_dsgd.SDMConfig:
        acc_bits = sdm_dsgd.transmitted_bits_per_step(p0, cfg, seq=seq)
    else:
        acc_bits = method_mod.transmitted_bits(meth, p0, cfg, seq=seq)
    wire_bits = transport.bytes_sent[0] * 8
    n_flops = max(float(flops.get_total_flops()), float(ops.total))
    t_compute = n_flops / NOMINAL_FLOPS_PER_S
    t_wire = max(wire_bits // 8, 1) / NOMINAL_WIRE_BYTES_PER_S
    rec = {
        "case": case_id(meth_name, topo_spec, mode, overlap),
        "overlap": overlap,
        "n_leaves": len(tree_mod.leaves(stack)),
        "plane_shapes": [list(s) for s in
                         plane_mod.ParamPlane.for_tree(p0).plane_shapes()],
        "schedule_rounds": seq.schedules[0].n_rounds,
        "permutes_per_step": transport.permutes,
        "sort_count": ops.count("aten.sort", "aten.topk"),
        "wire_bits_sent": wire_bits,
        "wire_bits_acc": acc_bits,
        "aten_ops": ops.total,
        "launches": ops.launches,
        "flops": n_flops,
        "overlap_efficiency": (round(min(1.0, t_compute / t_wire), 4)
                               if overlap else 0.0),
    }
    if device.type == "cuda":
        rec["kernel_launches"] = kl.n
        rec["ported_kernel_launches"] = ported
    return rec


def run(device="cuda", *, out_path: str = OUT_PATH,
        update_baseline: bool = False) -> dict:
    """Every case on ``device`` (the card unless the caller passes
    "cpu"; raises without one); writes ``out_path`` and prints the CSV
    lines."""
    from repro_torch.bench import common

    device = resolve_device(device)
    records = [_record(*case, device) for case in CASES]
    data = {"device": device.type,
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "n_nodes": N_NODES, "records": records}
    with open(out_path, "w") as f:
        json.dump(data, f, indent=2)
    for rec in records:
        kernels = (f";kernel_launches={rec['kernel_launches']}"
                   if "kernel_launches" in rec else "")
        common.emit(
            "perf_wire_" + rec["case"].replace("/", "_"), 0.0,
            f"permutes/step={rec['permutes_per_step']};"
            f"rounds={rec['schedule_rounds']};"
            f"n_leaves={rec['n_leaves']};sorts={rec['sort_count']};"
            f"wire_bits_sent={rec['wire_bits_sent']};"
            f"wire_bits_acc={rec['wire_bits_acc']};"
            f"aten_ops={rec['aten_ops']};launches={rec['launches']}"
            f"{kernels};overlap_eff={rec['overlap_efficiency']}")
    print(f"# wrote {out_path}")
    if update_baseline:
        keys = ("case",) + BASELINE_KEYS[device.type]
        common.store_baseline(BASELINE, device.type, {
            "n_nodes": N_NODES,
            "records": [{k: r[k] for k in keys} for r in records]})
    return data


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT_PATH)
    ap.add_argument("--update-baseline", action="store_true",
                    help=f"write this device's records into {BASELINE}")
    args = ap.parse_args(argv)
    run(device=args.device, out_path=args.out,
        update_baseline=args.update_baseline)


if __name__ == "__main__":
    main()
