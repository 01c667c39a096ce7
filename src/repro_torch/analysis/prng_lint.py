"""PRNG hygiene over the port's traced step.

Port of ``repro.analysis.prng_lint``. Keys are tracked by VALUE
NUMBERING: every key gets an interned identity built from how it was
derived,

    root (a lifted constant: its two words | an input | an unknown key)
        --prng_fold_in(data)-->  ('fold', parent, data)
        --prng_split-->          ('split', parent, j)

where ``data`` is the value when it is a Python int or a constant of
the graph (each element of a constant tensor, such as the node block's
indices ``transport.me``, by its value), and otherwise the symbolic
element (node, index) of the data tensor. Two keys with the same
identity hold the same bits, however independently the code rebuilt
them. A batched key is one key per row: the abstract value of a key
tensor is the array of its rows' identities. Structural ops on keys
(select, slice, unbind, stack, cat, reshape, expand, moves) are replayed
on that array.

Each event also has a HOLDER: the index along the key batch's leading
axis, the node block's (``node_round_key(base, me, step)`` gives node
l's key in row l, and a receiver's redraw of its senders' index sets,
``(L, R)`` keys, sits in the receiver's row). An unbatched key is held
by every node. Two events conflict when their holders can be the same
node: the seed-synced transport has every receiver regenerate its
senders' keys on purpose, as JAX's per-node program does with a
different node operand.

Consumption events are ``prng_draw`` and ``prng_split`` (the port's
PRNG records one node per derivation and per draw while the auditor
traces, ``core/tagging``). ``prng_fold_in`` does not consume its parent.
Findings, over conflicting events:

* ``key-reuse`` -- one key consumed twice in the same step of the
  unrolled loop, or outside it (draw+draw, draw+split, split+split);
* ``scan-invariant-key`` -- one key drawn in two steps of the unrolled
  loop: the same bits every iteration, which voids the DP accounting
  (JAX's scan-body rule, read off the unrolled trace);
* ``padded-draw-shape`` -- a (rows, lane) draw at a kernel-padded plane
  shape instead of the canonical plane-spec shape.

One finding covers every row of a batched key that the same two event
nodes share. ``n_draws`` counts the draw nodes.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.analysis import graph_walk
from repro_torch.core import tagging

__all__ = ["analyze_prng"]

_LANES = (128, 1024)
_FOLD = "repro_torch." + tagging.FOLD_IN
_SPLIT = "repro_torch." + tagging.SPLIT
_DRAW = "repro_torch." + tagging.DRAW

# ops a key tensor passes through unchanged in its rows' identities
# (replayed on the array of identities)
_KEY_STRUCTURAL = frozenset({
    "aten._to_copy", "aten.clone", "aten.alias", "aten.detach",
    "aten.lift_fresh", "aten.select", "aten.slice", "aten.unbind",
    "aten.view", "aten.reshape", "aten._unsafe_view", "aten.expand",
    "aten.unsqueeze", "aten.squeeze", "aten.stack", "aten.cat",
    "aten.index", "aten.index_select", "aten.permute", "aten.copy",
    "aten.contiguous", "aten.split", "aten.split_with_sizes"})


class _Interner:
    def __init__(self):
        self._tab: Dict[tuple, int] = {}
        self._names: List[tuple] = []

    def __call__(self, key: tuple) -> int:
        if key not in self._tab:
            self._tab[key] = len(self._names)
            self._names.append(key)
        return self._tab[key]

    def name(self, i: int) -> str:
        return f"{self._names[i][0]}#{i}"


class _PrngInterp(graph_walk.GraphInterpreter):
    def __init__(self, allowed_shapes):
        self.intern = _Interner()
        self.events: List[dict] = []
        self.findings: List[dict] = []
        self.allowed_shapes = allowed_shapes
        self.n_draws = 0

    # lattice: None (not a key) or an int64 array of row identities
    def bottom(self):
        return None

    def join(self, a, b):
        return a if (a is not None and b is not None
                     and a.shape == b.shape and np.array_equal(a, b)) \
            else None

    def default(self, node, name, ins):
        return None

    # key identities ------------------------------------------------------
    def _rows(self, node) -> np.ndarray:
        """The row identities of a key node, rooting an unknown key."""
        v = self.value(node)
        if v is not None:
            return v
        shape = graph_walk.node_shape(node) or (2,)
        batch = shape[:-1]
        c = self.consts.get(node)
        out = np.empty(batch, dtype=np.int64)
        flat = out.reshape(-1)
        if isinstance(c, torch.Tensor) and tuple(c.shape) == tuple(shape):
            words = c.reshape(-1, 2).tolist()
            for i, w in enumerate(words):
                flat[i] = self.intern(("const", int(w[0]), int(w[1])))
        else:
            for i in range(flat.size):
                flat[i] = self.intern(("root", node.name, i))
        return out

    def _data(self, node, a) -> np.ndarray:
        if a["data"] is None:
            return _scalar_obj(("lit", int(a["data_int"])))
        data = a["data"]
        shape = graph_walk.node_shape(data) or ()
        out = np.empty(shape, dtype=object)
        flat = out.reshape(-1)
        c = self.consts.get(data)
        if isinstance(c, torch.Tensor) and tuple(c.shape) == tuple(shape):
            for i, v in enumerate(c.reshape(-1).tolist()):
                flat[i] = ("lit", int(v))
            return out
        for i in range(flat.size):
            flat[i] = ("sym", data.name, i)
        return out

    def _record(self, kind, rows: np.ndarray, node, shape=None):
        a = graph_walk.tag_args(node)
        for idx in np.ndindex(rows.shape):
            self.events.append({
                "key_id": int(rows[idx]), "kind": kind, "shape": shape,
                "node": node.name, "holder": idx[0] if idx else None,
                "site": a["site"], "iteration": self.iteration[node]})

    def transfer(self, node, name, ins):
        if name == _FOLD:
            a = graph_walk.tag_args(node)
            parent = self._rows(a["key"])
            data = self._data(node, a)
            p, d = np.broadcast_arrays(parent.astype(object), data)
            out = np.empty(p.shape, dtype=np.int64)
            for idx in np.ndindex(p.shape):
                out[idx] = self.intern(("fold", int(p[idx]), d[idx]))
            return out
        if name == _SPLIT:
            a = graph_walk.tag_args(node)
            parent = self._rows(a["key"])
            self._record("split", parent, node)
            num = int(a["num"])
            out = np.empty(parent.shape + (num,), dtype=np.int64)
            for idx in np.ndindex(parent.shape):
                for j in range(num):
                    out[idx + (j,)] = self.intern(
                        ("split", int(parent[idx]), j))
            return out
        if name == _DRAW:
            a = graph_walk.tag_args(node)
            shape = tuple(int(s) for s in a["shape"])
            self._record("draw", self._rows(a["key"]), node, shape=shape)
            self.n_draws += 1
            self._check_shape(shape, a["site"])
            return None
        if name == "aten.copy":
            return ins[0]
        if name in _KEY_STRUCTURAL and any(v is not None for v in ins):
            return self._replay(node)
        return None

    def _replay(self, node):
        """The node's op applied to its key inputs' identity arrays (as
        (*rows, 2) int64 tensors with the identity in both words); None
        if an operand is neither a key nor a constant, or the result is
        not key-shaped."""
        def sub(a):
            if isinstance(a, torch.fx.Node):
                v = self.value(a)
                if v is not None:
                    t = torch.from_numpy(v.astype(np.int64))
                    return torch.stack([t, t], dim=-1)
                c = self.consts.get(a)
                if isinstance(c, torch.Tensor):
                    return c.cpu()
                raise LookupError(a.name)
            if isinstance(a, (list, tuple)):
                return type(a)(sub(x) for x in a)
            if isinstance(a, torch.device):
                return torch.device("cpu")
            return a

        try:
            with tagging.record(False):
                kwargs = {k: sub(v) for k, v in node.kwargs.items()}
                kwargs.pop("device", None)
                out = node.target(*[sub(a) for a in node.args], **kwargs)
        except Exception:
            return None

        def rows(t):
            if not isinstance(t, torch.Tensor) or t.dim() == 0 \
                    or t.shape[-1] != 2 or not torch.equal(t[..., 0],
                                                           t[..., 1]):
                return None
            return t[..., 0].numpy().astype(np.int64)

        if isinstance(out, (list, tuple)):
            return [rows(t) for t in out]
        return rows(out)

    def _check_shape(self, shape, site):
        if (shape and len(shape) == 2 and shape[1] in _LANES
                and shape not in self.allowed_shapes):
            canon = {s for s in self.allowed_shapes
                     if len(s) == 2 and s[1] == shape[1]}
            if any(shape[0] > s[0] for s in canon):
                self.findings.append({
                    "kind": "padded-draw-shape", "shape": list(shape),
                    "allowed": sorted(map(list, canon)), "site": site})


def _scalar_obj(v) -> np.ndarray:
    out = np.empty((), dtype=object)
    out[()] = v
    return out


def analyze_prng(gm, allowed_shapes=()) -> dict:
    """Run the PRNG pass over a traced graph. Keys are rooted at first
    use (a constant by its words, anything else by its node).
    ``allowed_shapes`` are the canonical (rows, lane) plane shapes draws
    may use; a 2-D draw taller than one of them on a known lane is the
    padded-shape bug class.
    """
    interp = _PrngInterp(frozenset(tuple(s) for s in allowed_shapes))
    interp.run(gm, [])

    findings = list(interp.findings)
    by_key: Dict[int, List[dict]] = {}
    for ev in interp.events:
        by_key.setdefault(ev["key_id"], []).append(ev)
    reuse: Dict[tuple, dict] = {}
    invariant: Dict[str, dict] = {}       # one finding a draw site
    for key_id, evs in by_key.items():
        for i in range(len(evs)):
            for j in range(i + 1, len(evs)):
                a, b = evs[i], evs[j]
                if None not in (a["holder"], b["holder"]) \
                        and a["holder"] != b["holder"]:
                    continue            # two nodes: a seed-synced redraw
                if (a["iteration"] != b["iteration"] and a["iteration"] >= 0
                        and b["iteration"] >= 0
                        and a["kind"] == b["kind"] == "draw"):
                    invariant.setdefault(a["site"], {
                        "kind": "scan-invariant-key",
                        "key": interp.intern.name(key_id),
                        "site": a["site"]})
                    continue
                pair = (a["node"], b["node"])
                f = reuse.setdefault(pair, {
                    "kind": "key-reuse",
                    "key": interp.intern.name(key_id),
                    "events": [f"{a['kind']}@{a['site']}",
                               f"{b['kind']}@{b['site']}"],
                    "holders": 0})
                f["holders"] += 1
    findings += list(reuse.values()) + list(invariant.values())
    return {"findings": findings, "n_draws": interp.n_draws}
