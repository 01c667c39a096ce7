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

On a static schedule ``permutes_per_step`` equals ``expected_permutes``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import gossip, plane as plane_mod

__all__ = ["mode_of", "expected_permutes", "permutes_per_step",
           "expected_bytes_sent"]


def mode_of(meth_name: str, cfg) -> str:
    """The wire-audit mode string of a config: the compressor spec (or
    the legacy mode) of an SDM config, "-" for full-state methods."""
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


def _uses_replicas(meth_name: str, seq) -> bool:
    return meth_name.startswith(("sdm-dsgd", "dc-dsgd")) and \
        gossip.needs_replicas(seq)


def _exchange_step(meth_name: str, step: int) -> int:
    """The counter the step's exchange runs at (the fused step exchanges
    the next round's differential)."""
    return step + 1 if meth_name == "sdm-dsgd-fused" else step


def permutes_per_step(meth_name: str, mode: str, seq, step: int) -> int:
    """ppermute calls the per-node transport makes in step ``step``."""
    seq = gossip.ensure_sequence(seq)
    if _uses_replicas(meth_name, seq):
        r = gossip.union_schedule(seq).n_replicas
    else:
        r = seq.at(_exchange_step(meth_name, step)).n_rounds
    return r * _payload_tensors(meth_name, mode)


def expected_bytes_sent(meth, params, cfg, seq, steps: int
                        ) -> Dict[int, int]:
    """Bytes each node sends in steps 0 .. steps-1 by the exact
    accounting, for deterministic wire formats: per step and node,
    ``transmitted_bits_per_step`` on the graph that step's payload
    crosses (the union graph on the replica transport, else the step's
    own round), / 8. Full-state methods send the padded wire plane in
    f32 to each out-neighbour; allreduce sends nothing point to point.
    ``params`` is one node's parameter tree."""
    seq = gossip.ensure_sequence(seq)
    out = {node: 0 for node in range(seq.n_nodes)}
    if meth.name == "allreduce":
        return out
    plane = plane_mod.ParamPlane.for_tree(params).padded_size
    for t in range(steps):
        if _uses_replicas(meth.name, seq):
            graph = seq
        else:
            graph = gossip.ensure_sequence(
                seq.at(_exchange_step(meth.name, t)))
        for node in out:
            if meth.transmitted_bits_fn is not None:
                bits = meth.transmitted_bits_fn(params, cfg, node=node,
                                                seq=graph)
            else:
                bits = plane * 32 * gossip.mean_out_degree(graph, node=node)
            out[node] += int(bits) // 8
    return out
