"""Expected sends and bytes of the per-node transport.

The port's copy of ``repro.analysis.wire_audit.expected_permutes`` (the
JAX package counts collective-permutes in the compiled step) and the
runtime contract it becomes here: the transport's counters
(``core/transport.py``) must equal

* ``permutes_per_step`` summed over the steps run: R rounds x the wire
  tensors of one payload (1 for dense and packed payloads and for the
  fused ``qsgdf`` buffer, 2 for ``qsgd``: values + norm), with R the
  step's schedule rounds on a static transport and the union rounds on
  the replica transport (genuinely time-varying schedules);
* ``expected_bytes_sent`` per node, i.e. ``transmitted_bits_per_step``
  / 8 for the deterministic wire formats (not Bernoulli, whose count is
  an expectation).

On a static schedule with one wire plane ``permutes_per_step`` equals
``expected_permutes``. Under tensor-parallel buckets (``plane.
use_buckets``: a run on a model axis M > 1) every bucket's plane crosses
the wire in exchanges of its own, so the payload permutes multiply by
the bucket count (``n_buckets``), as in the JAX package's compiled step;
JAX's ``expected_permutes`` counts one plane whatever the buckets.
``expected_bytes_sent`` reads the plane layout, so it is computed under
the run's bucket context.
Gradient-push adds its 4-byte mass w on each of the step's own rounds.
The accounting charges gradient-push's explicit fixed-k indices at
ceil(log2 d) bits; the transport ships them as int32, as the JAX package
does, and ``expected_bytes_sent`` counts that width.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import compressor as compressor_mod, gossip
from repro_torch.core import plane as plane_mod, sparsifier

__all__ = ["mode_of", "expected_permutes", "permutes_per_step",
           "expected_bytes_sent"]


def mode_of(meth_name: str, cfg) -> str:
    """The wire-audit mode string of a config: the compressor spec (or
    the legacy mode) of an SDM config, gradient-push's compressor spec,
    "-" for full-state methods."""
    if meth_name == "gradient-push":
        return cfg.compressor or "-"
    if getattr(cfg, "theta", None) is None:
        return "-"
    return cfg.compressor or cfg.mode


def _payload_tensors(meth_name: str, mode: str) -> int:
    base_mode = mode.split(":")[0]
    if mode == "-":
        return 0 if meth_name == "allreduce" else 1
    if base_mode in ("qsgd", "fixedk", "block"):
        return 2 if (meth_name == "gradient-push"
                     or base_mode == "qsgd") else 1
    return 1      # dense, packed, and the fused single-buffer "qsgdf"


def expected_permutes(meth_name: str, mode: str, seq) -> int:
    """Collective-permutes per compiled step on the plane transport
    (``repro.analysis.wire_audit.expected_permutes``): R schedule rounds
    x wire tensors per payload, + R for the push-sum mass scalar."""
    r = seq.schedules[0].n_rounds
    extra = r if meth_name == "gradient-push" else 0
    return r * _payload_tensors(meth_name, mode) + extra


def _uses_replicas(meth_name: str, seq, mode: str = "-") -> bool:
    """Whether the payload rides the replica (union) transport: SDM
    methods, and compressed gradient-push, on genuinely time-varying
    schedules."""
    sdm_like = meth_name.startswith(("sdm-dsgd", "dc-dsgd"))
    push = meth_name == "gradient-push" and mode != "-"
    return (sdm_like or push) and gossip.needs_replicas(seq)


def _exchange_step(meth_name: str, step: int) -> int:
    """The counter the step's exchange runs at (the fused step exchanges
    the next round's differential)."""
    return step + 1 if meth_name == "sdm-dsgd-fused" else step


def permutes_per_step(meth_name: str, mode: str, seq, step: int,
                      n_buckets: int = 1) -> int:
    """ppermute calls the per-node transport makes in step ``step``, on
    ``n_buckets`` wire planes."""
    seq = gossip.ensure_sequence(seq)
    rounds = seq.at(_exchange_step(meth_name, step)).n_rounds
    if _uses_replicas(meth_name, seq, mode):
        r = gossip.union_schedule(seq).n_replicas
    else:
        r = rounds
    # the push-sum mass rides the step's own rounds
    extra = rounds if meth_name == "gradient-push" else 0
    return r * _payload_tensors(meth_name, mode) * n_buckets + extra


# the width explicit indices cross the transport at (gossip._ppermute_payload)
INDEX_WIRE_BITS = 32


def _index_gap_bits(meth_name: str, params, cfg) -> int:
    """Bits per payload by which the shipped explicit indices exceed the
    accounting's: gradient-push's fixed-k payload carries its k indices
    as int32, the accounting charges ceil(log2 d) bits each (0 for every
    other wire format)."""
    comp = cfg.make_compressor() if meth_name == "gradient-push" else None
    if not isinstance(comp, compressor_mod.FixedKCompressor) or \
            isinstance(comp.p, tuple):
        return 0
    d = plane_mod.ParamPlane.for_tree(params).padded_size
    nb = -(-d // comp.block)
    return sparsifier.num_kept(nb, comp.p) * (
        INDEX_WIRE_BITS - compressor_mod.index_bits(nb))


def expected_bytes_sent(meth, params, cfg, seq, steps: int
                        ) -> Dict[int, int]:
    """Bytes each node sends in steps 0 .. steps-1 by the exact
    accounting, for deterministic wire formats: per step and node,
    ``transmitted_bits_per_step`` on the graph that step's payload
    crosses (the union graph on the replica transport, else the step's
    own round), / 8, with explicit indices at the INDEX_WIRE_BITS the
    transport ships them. Full-state methods send the padded wire plane
    in f32 to each out-neighbour; allreduce sends nothing point to point.
    ``params`` is one node's parameter tree."""
    seq = gossip.ensure_sequence(seq)
    out = {node: 0 for node in range(seq.n_nodes)}
    if meth.name == "allreduce":
        return out
    plane = plane_mod.ParamPlane.for_tree(params).padded_size
    mode = mode_of(meth.name, cfg)
    for t in range(steps):
        graph = gossip.ensure_sequence(seq.at(_exchange_step(meth.name, t)))
        if meth.name == "gradient-push":
            # the payload crosses the union graph (replicas) or the step's
            # own round, the 32-bit mass the step's own round; with no
            # schedule the accountant charges one of each
            union = _uses_replicas(meth.name, seq, mode)
            gap = _index_gap_bits(meth.name, params, cfg)
            for node in out:
                payload = meth.transmitted_bits_fn(params, cfg,
                                                   node=node) - 32 + gap
                deg = gossip.mean_out_degree(seq if union else graph,
                                             union=union, node=node)
                mass = gossip.mean_out_degree(graph, node=node)
                out[node] += int(payload * deg + 32 * mass) // 8
            continue
        if _uses_replicas(meth.name, seq):
            graph = seq
        for node in out:
            if meth.transmitted_bits_fn is not None:
                bits = meth.transmitted_bits_fn(params, cfg, node=node,
                                                seq=graph)
            else:
                bits = plane * 32 * gossip.mean_out_degree(graph, node=node)
            out[node] += int(bits) // 8
    return out
