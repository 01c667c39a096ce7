"""Dry-run: trace every (arch x input-shape x mesh) on the ``meta`` device.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
case for a faked TPU mesh and reads XLA's cost and memory analyses. The
port runs eagerly, so it runs one step of each case on ``meta`` tensors
(shapes and dtypes, no data, nothing allocated and nothing launched) and
counts what the step does:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (2 per
  multiply-add of the matmul-class ops, attention's two products
  included), plus the kernels' own counts (``kernels/cost.py``, charged
  by each wrapper's meta branch);
* ``bytes_accessed``: ``bench/counting.ByteCount``, the input and output
  bytes of every ATen op that is not a view or an allocation (what the
  eager port moves op by op; XLA counts its fused HLO), plus the kernels'
  bytes;
* ``collective_bytes`` / ``collective_ops``: the transport's own counters
  (``StackTransport.bytes_sent`` and ``permutes``, as
  ``collective-permute``: the node wire, one permute per bucket plane
  and round, not the loss's mean) and, on an ``NxM`` mesh, the model
  axis's (``core/model_axis``) under JAX's HLO names: ``all_reduce``
  and ``all_max`` as ``all-reduce``, ``all_gather`` as ``all-gather``,
  ``reduce_scatter`` as ``reduce-scatter``;
* ``memory``: ``argument_size_in_bytes`` (state and inputs),
  ``output_size_in_bytes`` (what the step returns that is not an
  argument), ``peak_memory_in_bytes`` (arguments plus the most storage
  made by the step alive at once, ``ByteCount.peak``, tracked through
  storage finalizers) and ``temp_size_in_bytes`` (the peak less
  arguments and outputs);
* ``trace_s``: the trace's wall seconds (in place of JAX's ``lower_s`` /
  ``compile_s``).

Meshes (``launch/mesh.parse_mesh``, which here also takes JAX's pod
meshes ``16x16`` / ``single_pod`` and ``2x16x16`` / ``multi_pod``: a
count on ``meta`` needs no process group): N nodes, or N x M devices on
an ``NxM`` mesh, each node's model split over M shards. The defaults
``16`` and ``2x16x1`` are the node counts of JAX's ``single_pod`` and
``multi_pod`` without their model axis of 16. A record's ``n_devices``
is N M, and its values are per device, one shard of one node: on
``NxM`` the model runs over a ``ShardModelAxis`` (one shard of M, L = 1,
on ``meta``), so its flops, bytes and collectives are exactly one
device's, replicated work included.

* train: the step runs on a ``StackTransport`` that holds all n nodes as
  one block (``train.steps.make_distributed_train``); each value is the
  block's total divided by N M. The gradient of one device (node 0,
  over the one-shard axis on ``NxM``) is traced and charged for every
  device (``_grads_by_symmetry``), so its share is exact; the executor
  runs on the nodes' whole leaves, so its share is the block's over
  N M (on ``NxM`` a leaf the rules replicate is counted once a node, not
  M times). The block's temporaries hold one device's activations:
  divided by N M they understate what a device needs, so
  ``memory["grad_peak_memory_in_bytes"]`` gives the one device's
  gradient's own peak above the arguments (its activations, its shard's
  gradient and the node's whole-leaf copy the executor takes; not the
  block's gradient buffers), and ``memory["block_peak_memory_in_bytes"]`` the block's
  peak, what one card holding all n nodes needs.
* serve: JAX's ``make_prefill_fn`` / ``make_decode_fn``
  (``train/steps``), traced for one device: its rows of the batch,
  ceil(global_batch / N) (all of it where the rules leave the batch
  whole: long_500k's ``shard_cache_seq``), its shard of the bf16 weights
  and of the cache (``convert.shard_params`` / ``shard_cache`` with
  ``index``: split by KV heads for prefill, by positions for decode,
  by positions over N M blocks for long_500k), its values already per
  device. A decode case's traced arguments carry a () int32 meta tensor
  for the cache's offset, an argument of JAX's decode step and a Python
  int in the port's cache, so that its ``argument_size_in_bytes``
  counts it.

The port unrolls the period loop in Python, so every layer is traced and
JAX's probe1 / probe2 layer correction has no counterpart. rwkv6's
time-mix runs an in-order loop over the sequence (``models/rwkv.py``);
with ``probes`` its train and prefill cases are traced at 1, 2 and 3 x
``SEQ_PROBE`` tokens and every count is extrapolated to the case's
length by the quadratic through the three (the JAX record's probe idea
applied to the port's loop; exact for counts of degree <= 2 in the
length: flops and the wire are affine, the backward's bytes quadratic);
the memory peak is not a polynomial of the length and goes by the line
through the last two probes (rwkv6's smoke config on 4 nodes, 16 / 32 /
48 -> 4096 tokens: 8.067 GB against 8.080 GB traced in full, a CPU /
meta count). Such a record also carries ``seq_probes``. jamba's mamba scan is log-depth and
needs no probe. Also with ``probes``, a train case traces node 0's
gradient and charges the other nodes' (the same work on the same
shapes) as its multiple (``_grads_by_symmetry``).

Records go to ``<out>/<mesh>/<arch>/<shape>.json`` (``bench/roofline``
reads them). Everything runs on the CPU; no card is needed::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke --mesh 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k --mesh 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

__all__ = ["build_case", "trace_step", "main", "SEQ_PROBE", "DEFAULT_OUT"]

DEFAULT_OUT = "experiments/dryrun_torch"
SEQ_PROBE = 16          # tokens of the first rwkv6 probe


def _storages(tree) -> Dict[int, int]:
    """{storage id: bytes} of the tensors in ``tree`` (each storage
    once)."""
    import torch
    from torch.utils._pytree import tree_leaves

    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def trace_step(fn, args) -> dict:
    """Run ``fn(*args)`` once on meta tensors under the counters; the
    block's own totals (not per device): flops, bytes_accessed, memory
    and trace_s. ``args`` stay referenced throughout, as a step's
    arguments are."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.bench.counting import ByteCount
    from repro_torch.kernels.cost import KernelTally

    arg_st = _storages(args)
    t0 = time.time()
    with FlopCounterMode(display=False) as fc, ByteCount() as bc, \
            KernelTally() as kt:
        out = fn(*args)
    trace_s = time.time() - t0
    out_st = {k: v for k, v in _storages(out).items() if k not in arg_st}
    arg_b, out_b = sum(arg_st.values()), sum(out_st.values())
    peak = arg_b + bc.peak
    del out
    return {"flops": float(fc.get_total_flops() + kt.flops),
            "bytes_accessed": float(bc.nbytes + kt.nbytes),
            "kernel_calls": dict(kt.calls),
            "memory": {"argument_size_in_bytes": arg_b,
                       "output_size_in_bytes": out_b,
                       "temp_size_in_bytes": max(peak - arg_b - out_b, 0),
                       "peak_memory_in_bytes": peak},
            "trace_s": trace_s}


# the model axis's collectives under JAX's HLO op names
HLO_NAMES = {"all_reduce": "all-reduce", "all_max": "all-reduce",
             "all_gather": "all-gather", "reduce_scatter": "reduce-scatter"}


def _per_device(block: dict, n: int, collective: int, permutes: int,
                axis=None) -> dict:
    """A block's totals over its ``n`` devices; the node wire per node
    (``collective`` bytes, ``permutes`` calls) and the model axis's
    counters (one device's, on a ``ShardModelAxis``) as JAX names
    collectives."""
    mem = {k: v / n for k, v in block["memory"].items()}
    mem["block_peak_memory_in_bytes"] = block["memory"][
        "peak_memory_in_bytes"]
    cbytes, ops = {}, {}
    if permutes:
        # a node's payloads, as each of its devices sends them
        nodes = n if axis is None else n // axis.size
        cbytes["collective-permute"] = collective / nodes
        ops["collective-permute"] = permutes
    for op, calls in (axis.calls.items() if axis is not None else ()):
        if calls:
            name = HLO_NAMES[op]
            ops[name] = ops.get(name, 0) + calls
            cbytes[name] = cbytes.get(name, 0) + axis.bytes[op]
    cbytes["total"] = sum(cbytes.values())
    return {"flops": block["flops"] / n,
            "bytes_accessed": block["bytes_accessed"] / n,
            "collective_bytes": cbytes, "collective_ops": ops,
            "memory": mem, "trace_s": block["trace_s"],
            "kernel_calls": block["kernel_calls"]}


def _grads_by_symmetry(cfg, x_block, tokens, labels, context=None, *,
                       model_axis=None, peak=None):
    """``steps.node_grads`` for the dry-run: node 0 traced (over
    ``model_axis``: one device's shard), the other devices (the same
    work on the same shapes: the other L - 1 nodes, times M on a model
    axis) charged as its multiple. The block's gradient buffers are
    allocated as in the full loop, so the memory peak is the loop's too.
    ``peak`` (a dict) takes the traced gradient's own memory peak."""
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.bench.counting import ByteCount
    from repro_torch.kernels import cost
    from repro_torch.train import steps as steps_mod

    with FlopCounterMode(display=False) as fc, ByteCount() as bc, \
            cost.KernelTally() as kt:
        out = steps_mod.node_grads(cfg, x_block, tokens, labels, context,
                                   nodes=[0], model_axis=model_axis)
    if peak is not None:
        # less the block's whole-leaf gradient buffers (all L nodes')
        peak["grad"] = bc.peak - sum(
            v.numel() * v.element_size() for v in tree_leaves(out[0]))
    devices = 1 if model_axis is None else model_axis.size
    more = len(tokens) * devices - 1
    cost.charge("node_grads", cost.Cost(
        more * (fc.get_total_flops() + kt.flops),
        more * (bc.nbytes + kt.nbytes)), calls=0)
    for name, k in kt.calls.items():
        cost.charge(name, cost.Cost(0, 0), calls=more * k)
    return out


def _measure_train(cfg, case, mesh, method: str, gossip_mode: str,
                   sdm_overrides, topology: str, compressor,
                   symmetry: bool) -> dict:
    import functools

    from repro_torch.core.model_axis import ShardModelAxis
    from repro_torch.core.sdm_dsgd import SDMConfig
    from repro_torch.core.transport import StackTransport
    from repro_torch.launch import shapes as shapes_mod
    from repro_torch.models import transformer
    from repro_torch.train import steps as steps_mod

    sdm_kw = dict(p=0.1, theta=0.25, gamma=1e-3, sigma=1.0, clip_c=5.0,
                  mode=gossip_mode, pack_block=1024, compressor=compressor)
    sdm_kw.update(sdm_overrides or {})
    tc = steps_mod.DistributedTrainConfig(
        model=cfg, sdm=SDMConfig(**sdm_kw), method=method, topology=topology)
    n_nodes, m = mesh.n_nodes, mesh.model
    axis = ShardModelAxis(m) if m > 1 else None
    transport = StackTransport(n_nodes, "meta")
    params = transformer.init_params(cfg, dtype=tc.param_dtype,
                                     device="meta")
    state = steps_mod.init_distributed_state(tc, transport, params=params,
                                             model_axis=axis)
    del params
    specs = shapes_mod.input_specs(cfg, case)
    args = [state, specs["tokens"], specs["labels"]]
    if "context" in specs:
        args.append(specs["context"])
    peak = {}
    grad_fn = None
    if symmetry or axis is not None:
        grad_fn = functools.partial(_grads_by_symmetry, model_axis=axis,
                                    peak=peak)
    step = steps_mod.make_distributed_train(tc, transport, grad_fn=grad_fn,
                                            model_axis=axis)
    transport.reset_counters()
    block = trace_step(step, args)
    sent = sum(transport.bytes_sent.values())
    got = _per_device(block, n_nodes * m, sent, transport.permutes, axis)
    if axis is not None:
        got["memory"]["grad_peak_memory_in_bytes"] = peak["grad"]
    return got


def _measure_serve(cfg, case, mesh) -> dict:
    import torch

    from repro_torch.convert import shard_cache, shard_params
    from repro_torch.core.model_axis import ShardModelAxis
    from repro_torch.launch import shapes as shapes_mod
    from repro_torch.models import transformer
    from repro_torch.train import steps as steps_mod

    m = mesh.model
    axis = ShardModelAxis(m) if m > 1 else None
    make = steps_mod.make_prefill_fn if case.kind == "prefill" \
        else steps_mod.make_decode_fn
    fn, rules = make(cfg, mesh, shard_cache_seq=case.name == "long_500k",
                     device="meta", model_axis=axis)
    whole = rules.spec(("batch",), (case.global_batch,)) == ()
    rows = case.global_batch if whole \
        else -(-case.global_batch // mesh.n_nodes)
    specs = shapes_mod.input_specs(cfg, case, batch=rows)
    params = transformer.init_params(cfg, dtype=torch.bfloat16,
                                     device="meta")
    cache = specs["cache"]
    if axis is not None:
        params = shard_params(params, cfg, m, index=axis.index)
        cache = shard_cache(cache, cfg, rules, index=axis.index)
    # the context stands for the encoded one in a decode step, as in
    # JAX's decode_fn
    args = [params, specs["tokens" if case.kind == "prefill" else "token"],
            cache]
    step = fn
    if case.kind == "decode":
        # JAX's decode step takes the cache's offset as a () int32 array
        # (its prefill does not read it, and XLA drops the argument); the
        # port's is a Python int in the cache, so a () int32 stands for
        # it among the traced arguments
        args.append(torch.zeros((), dtype=torch.int32, device="meta"))

        def step(params, token, cache, offset, *context):
            return fn(params, token, cache, *context)
    if "context" in specs:
        args.append(specs["context"])
    return _per_device(trace_step(step, args), 1, 0, 0, axis)


def _has_seq_loop(cfg) -> bool:
    return any(s.mixer == "rwkv" for s in cfg.period)


def _measure(cfg, case, mesh, method: str, gossip_mode: str,
             sdm_overrides, topology: str, compressor, probes: bool) -> dict:
    """One case's per-device record values. ``mesh``: a ``MeshSpec`` or
    a node count (no model axis)."""
    from repro_torch.launch.mesh import parse_mesh

    if isinstance(mesh, int):
        mesh = parse_mesh(str(mesh))
    if case.kind == "train":
        return _measure_train(cfg, case, mesh, method, gossip_mode,
                              sdm_overrides, topology, compressor, probes)
    return _measure_serve(cfg, case, mesh)


def _combine(vals, weights):
    """sum(w * v) over matching numbers and dicts of numbers."""
    if isinstance(vals[0], dict):
        return {k: _combine([v.get(k, 0) for v in vals], weights)
                for k in set().union(*vals)}
    return sum(w * v for w, v in zip(weights, vals))


def _measure_probed(cfg, case, *a) -> dict:
    """rwkv6's train / prefill: traced at 1, 2 and 3 x SEQ_PROBE tokens.
    The counts go to the case's length by the quadratic through the three
    (exact for counts of degree <= 2 in the length: autograd's
    ``select_backward`` writes a whole (b, s, h, N, N) gradient for each
    of the loop's s steps, so the backward's bytes grow as s^2); the
    memory peak, not a polynomial of the length, by the line through the
    last two probes."""
    c = SEQ_PROBE
    ps = [_measure(cfg, dataclasses.replace(case, seq_len=k * c), *a)
          for k in (1, 2, 3)]
    x = case.seq_len / c
    # Lagrange weights of the quadratic through x = 1, 2, 3; of the line
    # through x = 2, 3
    quad = ((x - 2) * (x - 3) / 2, -(x - 1) * (x - 3), (x - 1) * (x - 2) / 2)
    out = {k: _combine([p[k] for p in ps], quad)
           for k in ("flops", "bytes_accessed", "collective_bytes")}
    out["memory"] = _combine([p["memory"] for p in ps], (0, 3 - x, x - 2))
    out["collective_ops"] = ps[0]["collective_ops"]
    out["kernel_calls"] = ps[0]["kernel_calls"]
    out["trace_s"] = sum(p["trace_s"] for p in ps)
    out["seq_probes"] = {"seq_len": [k * c for k in (1, 2, 3)],
                         "flops": [p["flops"] for p in ps],
                         "bytes_accessed": [p["bytes_accessed"] for p in ps]}
    return out


def build_case(arch: str, shape_name: str, mesh_name: str, method: str,
               gossip_mode: str, out_root: str, verbose: bool = True,
               probes: bool = True, sdm_overrides: Optional[dict] = None,
               cfg_overrides: Optional[dict] = None,
               rule_overrides: Optional[dict] = None, smoke: bool = False,
               topology: str = "ring",
               compressor: Optional[str] = None,
               shape_overrides: Optional[dict] = None) -> Dict[str, Any]:
    """Trace one case and write its record (``out_root`` "" writes
    nothing); returns the record. ``rule_overrides`` are JAX's overrides
    of the tensor-parallel sharding rules: the port's model code splits by
    ``INNER_RULES`` / ``serving_rules`` alone, and a non-empty one raises
    (ROADMAP Queue 1, item 5d). ``shape_overrides`` replaces fields of the shape case
    (``seq_len``, ``global_batch``: a cell of another size). A train
    case runs with ``remat=True``, as in JAX, unless ``cfg_overrides``
    sets it."""
    from repro_torch import configs
    from repro_torch.core import method as method_mod
    from repro_torch.launch import shapes as shapes_mod
    from repro_torch.launch.mesh import parse_mesh

    method = method_mod.normalize(method)
    method_mod.get(method)      # unknown registrations fail before tracing
    case = shapes_mod.SHAPES[shape_name]
    if shape_overrides:
        case = dataclasses.replace(case, **shape_overrides)
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    if case.kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if smoke and cfg.pos_embedding == "learned" \
            and case.seq_len > cfg.max_position_embeddings:
        # whisper's smoke table (2048 rows) cannot embed train_4k's or
        # prefill_32k's tokens (JAX's smoke dry-run fails these two
        # cases): the registration smoke widens it to the case
        cfg = dataclasses.replace(cfg, max_position_embeddings=case.seq_len)
    skip = shapes_mod.skip_reason(cfg, case)
    if skip is not None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": skip}

    if rule_overrides:
        raise ValueError(
            f"rule_overrides {rule_overrides}: the port's tensor-parallel "
            "steps split by INNER_RULES / serving_rules alone; overrides "
            "are not ported (ROADMAP Queue 1, item 5d)")
    mesh = parse_mesh(mesh_name, pods=True)
    n_nodes = mesh.n_nodes
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "algorithm": method if case.kind == "train" else "serve",
              "n_devices": n_nodes * mesh.model, "status": "ok",
              "n_periods": cfg.n_periods}
    a = (mesh, method, gossip_mode, sdm_overrides, topology, compressor,
         probes)
    if probes and _has_seq_loop(cfg) and case.kind in ("train", "prefill") \
            and case.seq_len > 3 * SEQ_PROBE:
        got = _measure_probed(cfg, case, *a)
    else:
        got = _measure(cfg, case, *a)
    record["trace_s"] = round(got.pop("trace_s"), 2)
    record.update(got)
    record["model_params"] = cfg.param_count()
    record["model_params_active"] = cfg.active_param_count()
    record["n_nodes"] = n_nodes
    record["per_node_batch"] = case.global_batch // max(n_nodes, 1) \
        if case.kind == "train" else None
    record["tokens_per_step"] = case.global_batch * case.seq_len \
        if case.kind == "train" else case.global_batch

    if verbose:
        mem = record["memory"]
        print(f"[{arch} | {shape_name} | {mesh_name}] "
              f"trace={record['trace_s']}s flops={record['flops']:.3e} "
              f"bytes={record['bytes_accessed']:.3e} "
              f"coll={record['collective_bytes'].get('total', 0):.3e}B "
              f"peak/dev={mem['peak_memory_in_bytes'] / 1e9:.3f}GB",
              flush=True)

    if out_root:
        d = os.path.join(out_root, mesh_name, arch)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{shape_name}.json"), "w") as f:
            json.dump(record, f, indent=2)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="16,2x16x1",
                    help="comma-separated meshes: N, NxM, PxNxM, or "
                         "JAX's pod meshes 16x16 / 2x16x16")
    ap.add_argument("--method", default=None,
                    help="method registry name (repro_torch.core.method); "
                         "legacy --algorithm spellings accepted")
    ap.add_argument("--algorithm", default=None,
                    help="deprecated alias of --method")
    ap.add_argument("--gossip-mode", default="fixedk_packed",
                    choices=["bernoulli", "fixedk_packed", "fixedk_rows",
                             "qsgd"])
    ap.add_argument("--compressor", default=None,
                    help="wire compressor spec (repro_torch.core."
                         "compressor); overrides --gossip-mode")
    ap.add_argument("--topology", default="ring",
                    help="gossip graph spec (gossip.sequence_by_name)")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke configs (seconds a case)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--keep-going", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="trace rwkv6's train / prefill at full length")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.launch import shapes as shapes_mod

    method = args.method or args.algorithm or "sdm-dsgd"
    arches = sorted(configs.ALIASES) if args.arch == "all" \
        else args.arch.split(",")
    shape_names = list(shapes_mod.SHAPES) if args.shape == "all" \
        else args.shape.split(",")

    failures = []
    t0 = time.time()
    for mesh_name in args.mesh.split(","):
        for arch in arches:
            for shape_name in shape_names:
                try:
                    build_case(arch, shape_name, mesh_name, method,
                               args.gossip_mode, args.out,
                               probes=not args.no_probes, smoke=args.smoke,
                               topology=args.topology,
                               compressor=args.compressor)
                except Exception:
                    failures.append((arch, shape_name, mesh_name))
                    traceback.print_exc()
                    if not args.keep_going:
                        return 1
    if failures:
        print("FAILURES:", failures)
        return 1
    print(f"dry-run complete: every case traced or skipped "
          f"({time.time() - t0:.1f} s).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
