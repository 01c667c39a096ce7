"""Collective traffic read off the port's traced step.

Port of ``repro.launch.hlo_analysis``. The JAX package parses its
compiled HLO for collective-permutes and their payloads; the port has no
HLO, and its traced graph (``analysis.graph_walk.trace``) carries a
``collective`` node for each exchange the transport makes
(``core/transport.py``): ``ppermute`` (waited at once),
``ppermute_start`` and ``ppermute_done`` (a deferred exchange and its
wait, paired by uid) and ``pmean``. Each node's operand is the node
block (L nodes on the leading axis), so a payload is one row of it:
what one node puts on the wire.

* ``permute_payloads``: per send (``ppermute`` / ``ppermute_start``), in
  graph order, ``{"bits", "bytes", "elems": {dtype: count}, "step"}``
  for one node's row; dtypes in HLO's names (f32, u8, s8, s32, ...);
* ``collective_permute_count``: the sends;
* ``collective_bytes``: one node's bytes per collective kind;
* ``async_collective_pairs``: per kind the sync count and the start /
  done counts; a ``ppermute_start`` whose ``Pending`` is never waited on
  (nor settled) is the port's unbalanced start/done pair.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import torch

from repro_torch.analysis import graph_walk
from repro_torch.core import tagging

__all__ = ["collective_nodes", "permute_payloads",
           "collective_permute_count", "collective_bytes",
           "async_collective_pairs", "DTYPE_NAMES"]

DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred"}

_SENDS = ("ppermute", "ppermute_start")


def collective_nodes(gm) -> List[dict]:
    """Every ``collective`` node in graph order: kind, (src, dst) pairs,
    uid, site, the step of the unrolled loop (-1 outside), one node's
    row shape and its dtype."""
    out, step = [], -1
    for node in gm.graph.nodes:
        name = graph_walk.op_of(node)
        if name == "repro_torch." + tagging.ITERATION:
            step = int(node.args[0])
            continue
        if name != "repro_torch." + tagging.COLLECTIVE:
            continue
        a = graph_walk.tag_args(node)
        shape = graph_walk.node_shape(node.args[0]) or ()
        flat = list(a["perm"])
        out.append({
            "kind": a["kind"], "uid": int(a["uid"]), "site": a["site"],
            "perm": list(zip(flat[0::2], flat[1::2])), "step": step,
            "row_shape": tuple(shape[1:]),
            "dtype": DTYPE_NAMES.get(graph_walk.node_dtype(node.args[0]),
                                     "?"),
            "elt_bytes": graph_walk.node_dtype(node.args[0]).itemsize})
    return out


def _row_elems(c: dict) -> int:
    n = 1
    for s in c["row_shape"]:
        n *= int(s)
    return n


def permute_payloads(gm) -> List[Dict]:
    """One node's payload of each send, in graph order."""
    out = []
    for c in collective_nodes(gm):
        if c["kind"] not in _SENDS:
            continue
        elems = _row_elems(c)
        out.append({"bits": elems * c["elt_bytes"] * 8,
                    "bytes": elems * c["elt_bytes"],
                    "elems": {c["dtype"]: elems}, "step": c["step"]})
    return out


def collective_permute_count(gm) -> int:
    """The sends (``ppermute`` and ``ppermute_start``) in the graph."""
    return sum(1 for c in collective_nodes(gm) if c["kind"] in _SENDS)


def collective_bytes(gm) -> Dict[str, int]:
    """One node's bytes per collective kind (its operand row), plus
    ``total``; a start and its done count once, at the start."""
    out: Dict[str, int] = defaultdict(int)
    for c in collective_nodes(gm):
        if c["kind"] == "ppermute_done":
            continue
        kind = "all-reduce" if c["kind"] == "pmean" \
            else "collective-permute"
        out[kind] += _row_elems(c) * c["elt_bytes"]
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return dict(out)


def async_collective_pairs(gm) -> Dict[str, Dict[str, int]]:
    """Per collective kind the sync count and the async start / done
    counts, reported distinctly; ``unmatched`` lists the uids of starts
    never waited on (or dones without a start)."""
    sync = start = done = 0
    starts, dones = set(), set()
    for c in collective_nodes(gm):
        if c["kind"] == "ppermute":
            sync += 1
        elif c["kind"] == "ppermute_start":
            start += 1
            starts.add(c["uid"])
        elif c["kind"] == "ppermute_done":
            done += 1
            dones.add(c["uid"])
    if not (sync or start or done):
        return {}
    return {"collective-permute": {
        "sync": sync, "start": start, "done": done,
        "unmatched": sorted(starts ^ dones)}}
