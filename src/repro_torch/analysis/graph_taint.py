"""Privacy taint over the port's traced step.

Port of ``repro.analysis.jaxpr_taint``. Threat model (paper §4 /
Theorem 1): the adversary sees everything that crosses the wire, and
the private object is the local sample. Taint SOURCES are the data
inputs (the batch); everything computed from them carries the taint;
the one SANITIZER is the ``sanitize`` tag ``masked_grad`` applies after
clip -> + sigma * normal (only when sigma > 0); SINKS are the
collectives the transport marks (``collective`` of kind ``ppermute``,
``ppermute_start`` or ``pmean``). A sanitizer-free source -> sink path is
a ``tainted-collective`` finding.

Two more invariants ride along:

* every ppermute operand must be the direct output of a ``wire_payload``
  tag, i.e. the buffer went through ``gossip._send``, the one vetted
  wire call site (``untagged-wire`` otherwise);
* ``declared_release`` clears taint but is recorded, so the report lists
  every deliberate data-derived release (the loss metric).

Abstract value: ``(labels, wire_tagged)``: a frozenset of source labels,
and whether the value is the direct output of a wire tag (adjacency is
the property checked, so no other op keeps it). An op without a rule
unions its inputs' labels: the wire kernels (``fixedk_gather_pack``,
``qsgd_pack``) and the PRNG events declare exactly that.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Tuple

from repro_torch.analysis import graph_walk
from repro_torch.core import tagging

__all__ = ["analyze_taint", "TaintFinding", "SINK_KINDS"]

Val = Tuple[FrozenSet[str], bool]

#: collective kinds whose operands leave the node
SINK_KINDS = frozenset({"ppermute", "ppermute_start", "pmean"})
_PERMUTES = frozenset({"ppermute", "ppermute_start"})

_SANITIZE = "repro_torch." + tagging.SANITIZE
_RELEASE = "repro_torch." + tagging.RELEASE
_WIRE = "repro_torch." + tagging.WIRE
_COLLECTIVE = "repro_torch." + tagging.COLLECTIVE


class TaintFinding(dict):
    """dict with stable keys: kind, primitive, labels, site."""


class _TaintInterp(graph_walk.GraphInterpreter):
    def __init__(self):
        self.findings: List[TaintFinding] = []
        self.releases: List[Dict] = []
        self.sanitized_sites = set()
        self._seen = set()

    def bottom(self) -> Val:
        return (frozenset(), False)

    def join(self, a: Val, b: Val) -> Val:
        return (a[0] | b[0], a[1] and b[1])

    def default(self, node, name, ins):
        labels = frozenset().union(*(v[0] for v in ins)) if ins \
            else frozenset()
        return (labels, False)

    def _emit(self, **kw):
        fp = tuple(sorted((k, str(v)) for k, v in kw.items()))
        if fp not in self._seen:
            self._seen.add(fp)
            self.findings.append(TaintFinding(kw))

    def transfer(self, node, name, ins):
        if name == _SANITIZE:
            a = graph_walk.tag_args(node)
            self.sanitized_sites.add((a["site"], a["leaf"]))
            return (frozenset(), False)
        if name == _RELEASE:
            a = graph_walk.tag_args(node)
            if ins[0][0] and (a["label"], a["site"]) not in {
                    (r["label"], r["site"]) for r in self.releases}:
                self.releases.append({"label": a["label"],
                                      "labels": sorted(ins[0][0]),
                                      "site": a["site"]})
            return (frozenset(), False)
        if name == _WIRE:
            return (ins[0][0], True)
        if name == _COLLECTIVE:
            a = graph_walk.tag_args(node)
            kind = a["kind"]
            if kind in SINK_KINDS:
                if ins[0][0]:
                    self._emit(kind="tainted-collective", primitive=kind,
                               labels=sorted(ins[0][0]), site=a["site"])
                if kind in _PERMUTES and not ins[0][1]:
                    self._emit(kind="untagged-wire", primitive=kind,
                               site=a["site"])
            # received values carry the peers' (identically labelled) taint
            return (ins[0][0], False)
        return None


def analyze_taint(gm, source_labels: Dict[int, str]) -> dict:
    """Run the taint pass over a traced graph.

    ``source_labels`` maps placeholder positions to a label (e.g.
    ``{1: "data", 2: "data"}``). Returns ``findings``, ``releases`` (the
    declared data releases, one a label and site) and
    ``n_sanitize_sites`` (distinct tag sites: file:line and leaf, however
    many unrolled steps reach them).
    """
    interp = _TaintInterp()
    n = sum(1 for nd in gm.graph.nodes if nd.op == "placeholder")
    in_vals = [(frozenset([source_labels[i]]) if i in source_labels
                else frozenset(), False) for i in range(n)]
    interp.run(gm, in_vals)
    return {"findings": interp.findings,
            "releases": interp.releases,
            "n_sanitize_sites": len(interp.sanitized_sites)}
