"""Quantitative sensitivity certifier: norm-bound propagation over the
port's traced step, and the integer-range certificate.

Port of ``repro.analysis.sensitivity``. The taint pass proves the
QUALITATIVE shape of the privacy argument (data reaches a collective
only through ``sanitize``); this pass proves the QUANTITATIVE half
Theorem 1 needs: the value the Gaussian mask is added to is coordinate-
bounded by the clip constant C (l2-sensitivity <= C sqrt(d) = G), and
the integer wire encodings stay in their representable range.

Norm-bound domain
-----------------
Abstract value: a float ``beta`` per node, meaning the value decomposes
as ``u + w`` with ``u`` data-INdependent and every coordinate of the
data-dependent part bounded, ``|w_i| <= beta``. ``0`` is "provably
data-independent" (constants, PRNG draws, sanitized values), ``inf``
"no bound known". Rules over ATen ops:

* ``clip_bound`` tag: min(in, C);
* add / sub: beta_a + beta_b (``alpha`` scales the second);
* mul / div by a literal c (a Python number or a one-element constant):
  beta * |c| (beta / |c|); any other factor of a data-dependent operand
  gives inf;
* 1-Lipschitz ops (maximum, minimum, clamp, abs, neg, tanh, ...): max;
* structural ops (views, cat, stack, copies, casts, gathers and index
  reads with data-independent indices, scatters that replace): max;
* sum over k elements: k beta; mean, amax, amin: beta; floor / round /
  ceil: beta + 1; comparisons and sign: 1;
* anything else: 0 if ALL inputs are 0, else inf.

The wire kernels have declared rules: ``fixedk_gather_pack`` moves its
bound as a gather scaled by the literal nb/kb, ``qsgd_pack`` as a
data-dependent integer code (0 for data-independent inputs, else inf):
exactly what the walk through each kernel's plain version computes
(the tests hold them equal).

``sanitize`` clears the bound to 0 (the accountant charges that
release) after RECORDING the pre-noise bound; the main check is
``bound(sanitize operand) <= C``. ``wire_payload`` operands must carry 0
in privacy-claiming configs. A finding means "cannot prove".

Integer-range certificate
-------------------------
``qsgd_range_certificate`` re-derives the qsgd / qsgdf wire encoding
with ``Interval`` arithmetic (the JAX package's, copied): levels in
[-s, s], offset encode in [0, 2s] within [0, 2^b - 1], OR-packed bytes
<= 255, plus the 4 norm tail bytes of the fused format.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.analysis import graph_walk
from repro_torch.core import tagging

__all__ = ["Interval", "analyze_sensitivity", "qsgd_range_certificate",
           "clip_transfer", "add_transfer", "scale_transfer",
           "concat_transfer", "pad_transfer", "reduce_sum_transfer",
           "KERNEL_RULES"]

INF = math.inf

# relative slack on bound <= C comparisons (f32 literal round-off)
_TOL = 1e-5


# ==========================================================================
# Transfer functions (module level, as in the JAX package).
# ==========================================================================

def clip_transfer(beta: float, c: float) -> float:
    """Bound after clamping to [-c, c]: min(beta, c)."""
    return min(beta, c)


def add_transfer(beta_a: float, beta_b: float) -> float:
    return beta_a + beta_b


def scale_transfer(beta: float, c: float) -> float:
    """Bound after multiplying by a known constant c."""
    return beta * abs(c)


def concat_transfer(*betas: float) -> float:
    """Every output coordinate is some input coordinate."""
    return max(betas) if betas else 0.0


def pad_transfer(beta: float, pad_bound: float = 0.0) -> float:
    return max(beta, pad_bound)


def reduce_sum_transfer(beta: float, reduced: int) -> float:
    return beta * float(reduced)


def _a(name: str) -> str:
    return "aten." + name


_STRUCTURAL = frozenset(map(_a, (
    "view", "reshape", "_unsafe_view", "slice", "select", "expand",
    "permute", "transpose", "t", "unsqueeze", "squeeze", "alias", "detach",
    "lift_fresh", "unbind", "split", "split_with_sizes", "narrow", "clone",
    "contiguous", "_to_copy", "to", "copy", "cat", "stack", "flip", "roll",
    "repeat", "slice_scatter", "select_scatter", "as_strided_scatter",
    "diagonal_scatter", "fill", "unfold", "diagonal", "as_strided",
    "chunk", "_reshape_alias", "view_as", "expand_as", "alias_copy",
    "positive", "resolve_conj", "resolve_neg")))

_LIPSCHITZ1 = frozenset(map(_a, (
    "maximum", "minimum", "max", "min", "abs", "neg", "tanh", "sin", "cos",
    "sigmoid", "clamp", "clamp_min", "clamp_max", "erf", "relu",
    "hardtanh")))

_RANGE_BOUNDED = frozenset(map(_a, (
    "sign", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_xor", "logical_not", "isfinite", "isnan",
    "isinf", "bitwise_not")))

_GATHERS = frozenset(map(_a, (
    "gather", "index_select", "index", "take", "take_along_dim")))

_SANITIZE = "repro_torch." + tagging.SANITIZE
_CLIP = "repro_torch." + tagging.CLIP
_WIRE = "repro_torch." + tagging.WIRE
_RELEASE = "repro_torch." + tagging.RELEASE


def _numel(shape) -> int:
    return int(math.prod(shape)) if shape is not None else 1


def _fixedk_gather_pack_rule(interp, node, ins):
    """Rows gathered by data-independent indices, times f32(nb/kb)."""
    from repro_torch.kernels.wire_compress.ref import f32_scale

    db, idx = ins[0], ins[1]
    if idx != 0.0:
        return INF
    return scale_transfer(db, float(f32_scale(float(node.args[2]))))


def _qsgd_pack_rule(interp, node, ins):
    """A data-dependent integer code: bounded only if every input is
    data-independent."""
    return 0.0 if all(v == 0.0 for v in ins) else INF


#: declared bound rules of the hand-written kernels' graph ops
KERNEL_RULES = {
    "repro_torch.fixedk_gather_pack": _fixedk_gather_pack_rule,
    "repro_torch.qsgd_pack": _qsgd_pack_rule,
}


class _SensInterp(graph_walk.GraphInterpreter):
    """The norm-bound abstract interpreter (see module docstring)."""

    def __init__(self):
        self.sanitize_sites: Dict[tuple, dict] = {}
        self.wire_sites: Dict[str, dict] = {}
        self.clip_sites: Dict[tuple, dict] = {}

    def bottom(self) -> float:
        return 0.0

    def join(self, a: float, b: float) -> float:
        return max(a, b)

    def default(self, node, name, ins):
        if not ins or all(v == 0.0 for v in ins):
            return 0.0
        return INF

    def transfer(self, node, name, ins):
        if name.startswith("repro_torch."):
            return self._tag(node, name, ins)
        if not ins or all(v == 0.0 for v in ins):
            # a function of data-independent values is data-independent
            return 0.0
        return self._aten(node, name, ins)

    def _tag(self, node, name, ins):
        if name in KERNEL_RULES:
            return KERNEL_RULES[name](self, node, ins)
        if name == _CLIP:
            a = graph_walk.tag_args(node)
            c = float(a["bound"])
            self.clip_sites.setdefault((a["site"], a["leaf"]),
                                       {"site": a["site"], "bound": c})
            return clip_transfer(ins[0], c)
        if name == _SANITIZE:
            a = graph_walk.tag_args(node)
            shape = graph_walk.node_shape(node.args[0])
            numel = _numel(shape[int(a["node_dims"]):] if shape else None)
            rec = self.sanitize_sites.setdefault(
                (a["site"], a["leaf"]),
                {"site": a["site"], "bound": 0.0, "numel": numel})
            rec["bound"] = max(rec["bound"], ins[0])
            return 0.0
        if name == _RELEASE:
            return 0.0
        if name == _WIRE:
            a = graph_walk.tag_args(node)
            rec = self.wire_sites.setdefault(
                a["site"], {"site": a["site"], "bound": 0.0,
                            "label": a["label"]})
            rec["bound"] = max(rec["bound"], ins[0])
            return ins[0]
        if name == "repro_torch." + tagging.COLLECTIVE:
            kind = graph_walk.tag_args(node)["kind"]
            if kind == "pmean":        # JAX's psum: not structural
                return self.default(node, name, ins)
            return ins[0]
        if name == "repro_torch." + tagging.PENDING:
            return ins[0]
        return self.default(node, name, ins)

    def _scalar_factor(self, node) -> "tuple | None":
        """(the data-dependent operand's bound, |literal factor|) of a
        two-operand mul, or None if neither operand is a literal."""
        x, y = node.args[0], node.args[1]
        ly, lx = self.literal(y), self.literal(x)
        if ly is not None:
            return self.value(x), ly
        if lx is not None:
            return self.value(y), lx
        return None

    def _aten(self, node, name, ins):
        args = node.args
        if name in (_a("add"), _a("sub")):
            b0 = self.value(args[0])
            b1 = self.value(args[1]) if len(args) > 1 else 0.0
            alpha = node.kwargs.get("alpha", 1)
            return add_transfer(b0, scale_transfer(b1, alpha))
        if name == _a("mul"):
            got = self._scalar_factor(node)
            return INF if got is None else scale_transfer(*got)
        if name == _a("div"):
            c = self.literal(args[1])
            if c is not None and c != 0.0 and not node.kwargs.get(
                    "rounding_mode"):
                return scale_transfer(self.value(args[0]), 1.0 / c)
            return INF
        if name in (_a("clamp"), _a("hardtanh")):
            lo = self.literal(args[1]) if len(args) > 1 else None
            hi = self.literal(args[2]) if len(args) > 2 else None
            out = concat_transfer(*ins)
            if lo is not None and hi is not None:
                out = min(out, hi - lo)
            return out
        if name in _LIPSCHITZ1 or name in _STRUCTURAL:
            return concat_transfer(*ins)
        if name == _a("constant_pad_nd"):
            return pad_transfer(ins[0])
        if name == _a("where"):
            cond = self.value(args[0])
            if cond == 0.0:
                return concat_transfer(*[self.value(a) for a in args[1:]])
            return INF
        if name in _GATHERS:
            src = self.value(args[0])
            idx = [v for a in graph_walk.tensor_args(node)[1:]
                   for v in [self.value(a)]]
            return src if all(v == 0.0 for v in idx) else INF
        if name in (_a("scatter"), _a("index_put")):
            # replaces coordinates: max of base and source, if the
            # positions are data-independent and nothing accumulates
            if name == _a("index_put") and (
                    len(args) > 3 and args[3]
                    or node.kwargs.get("accumulate")):
                return INF
            idx_nodes = (args[2:3] if name == _a("scatter")
                         else graph_walk.tensor_args(node)[1:-1])
            if any(self.value(a) != 0.0 for a in idx_nodes):
                return INF
            return concat_transfer(*ins)
        if name in (_a("sum"), _a("mean")):
            if name == _a("mean"):
                return ins[0]
            out_n = _numel(graph_walk.node_shape(node))
            in_n = _numel(graph_walk.node_shape(args[0]))
            return reduce_sum_transfer(ins[0], max(1, in_n // max(1, out_n)))
        if name in (_a("amax"), _a("amin")):
            return ins[0]
        if name in (_a("floor"), _a("round"), _a("ceil"), _a("trunc")):
            return ins[0] + 1.0
        if name in _RANGE_BOUNDED:
            return 1.0
        return INF


def _fmt_bound(b: float):
    return None if math.isinf(b) else b


def analyze_sensitivity(gm, source_labels: Dict[int, str], *,
                        clip_c: Optional[float], check: bool = True) -> dict:
    """Run the norm-bound pass over a traced graph.

    ``source_labels`` marks the placeholders holding raw data (seeded at
    inf); every other input seeds at 0. ``clip_c`` is the clip constant
    the config (and the accountant) declares; ``check`` emits findings
    (off for negative controls, which still get a certificate).

    Findings: ``unclipped-sanitize`` (noise added to an unbounded
    value), ``sensitivity-exceeds-clip``, ``clip-bound-mismatch`` (the
    tag's C differs from the config's) and ``wire-sensitivity`` (a wire
    buffer with a nonzero bound).
    """
    interp = _SensInterp()
    n = sum(1 for nd in gm.graph.nodes if nd.op == "placeholder")
    interp.run(gm, [INF if i in source_labels else 0.0 for i in range(n)])

    findings: List[dict] = []
    sanitize_rows = []
    for rec in interp.sanitize_sites.values():
        b = rec["bound"]
        l2 = None if math.isinf(b) else b * math.sqrt(rec["numel"])
        sanitize_rows.append({"site": rec["site"],
                              "coord_bound": _fmt_bound(b), "l2_bound": l2,
                              "numel": rec["numel"]})
        if not check or clip_c is None:
            continue
        if math.isinf(b):
            findings.append({
                "kind": "unclipped-sanitize", "site": rec["site"],
                "detail": "noise added to a value with no provable "
                          "coordinate bound (unclipped data path)"})
        elif b > clip_c * (1.0 + _TOL):
            findings.append({
                "kind": "sensitivity-exceeds-clip", "site": rec["site"],
                "bound": b, "clip_c": clip_c})
    clip_rows = []
    for rec in interp.clip_sites.values():
        clip_rows.append({"site": rec["site"], "bound": rec["bound"]})
        if check and clip_c is not None and not math.isclose(
                rec["bound"], clip_c, rel_tol=1e-6):
            findings.append({
                "kind": "clip-bound-mismatch", "site": rec["site"],
                "declared": rec["bound"], "config": clip_c})
    wire_bound = 0.0
    for rec in interp.wire_sites.values():
        wire_bound = max(wire_bound, rec["bound"])
        if check and rec["bound"] > 0.0:
            findings.append({
                "kind": "wire-sensitivity", "site": rec["site"],
                "bound": _fmt_bound(rec["bound"]),
                "detail": "wire payload carries un-sanitized "
                          "data-dependent content"})
    return {
        "findings": findings,
        "sanitize_sites": sorted(sanitize_rows, key=lambda r: r["site"]),
        "clip_sites": sorted(clip_rows, key=lambda r: r["site"]),
        "wire_coord_bound": _fmt_bound(wire_bound),
    }


# ==========================================================================
# Interval arithmetic + the qsgd/qsgdf integer-range certificate.
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed interval [lo, hi] over the reals (ints are exact floats
    well below 2^53 here)."""

    lo: float
    hi: float

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    def add(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def scale(self, c: float) -> "Interval":
        a, b = self.lo * c, self.hi * c
        return Interval(min(a, b), max(a, b))

    def clamp(self, lo: float, hi: float) -> "Interval":
        return Interval(min(max(self.lo, lo), hi),
                        min(max(self.hi, lo), hi))

    def join(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def shift_left(self, bits: int) -> "Interval":
        return self.scale(float(1 << bits))

    def or_disjoint(self, other: "Interval") -> "Interval":
        """OR of non-negative fields with disjoint set-bit ranges (the
        sub-byte pack): for disjoint fields OR == ADD."""
        if self.lo < 0 or other.lo < 0:
            raise ValueError("or_disjoint needs non-negative fields")
        return self.add(other)

    def within(self, lo: float, hi: float) -> bool:
        return self.lo >= lo and self.hi <= hi

    def as_list(self) -> List[float]:
        return [self.lo, self.hi]


def qsgd_range_certificate(bits: int, *, fused: bool, plane_elems: int,
                           levels: Optional[int] = None) -> dict:
    """Re-derive the qsgd / qsgdf wire encoding symbolically and prove
    every intermediate stays in its representable range (the stochastic
    level in [0, s], q in [-s, s], q + s in [0, 2s], k = 8/bits fields
    OR-packed per u8 byte, the 4 norm tail bytes of the fused format).
    ``levels`` overrides s = 2^(bits-1) - 1 to see the certificate fail.
    """
    s = levels if levels is not None else 2 ** (bits - 1) - 1
    findings: List[dict] = []
    level = Interval(0.0, INF).clamp(0.0, float(s))
    q = level.join(level.scale(-1.0))
    off = q.add(Interval(float(s), float(s)))
    if not off.within(0.0, float(2 ** bits - 1)):
        findings.append({
            "kind": "int-range-overflow", "stage": "offset",
            "range": off.as_list(), "repr": [0, 2 ** bits - 1]})
    pack = 8 // bits if bits in (2, 4) else 1
    if pack > 1:
        byte = Interval(0.0, 0.0)
        for j in range(pack):
            byte = byte.or_disjoint(off.shift_left(j * bits))
        wire_dtype = "u8"
    elif fused:
        byte = off
        wire_dtype = "u8"
    else:
        byte = q
        wire_dtype = "s8"
    repr_lo, repr_hi = (-128.0, 127.0) if wire_dtype == "s8" \
        else (0.0, 255.0)
    if not byte.within(repr_lo, repr_hi):
        findings.append({
            "kind": "int-range-overflow", "stage": "wire-byte",
            "range": byte.as_list(), "repr": [repr_lo, repr_hi]})
    payload_bytes = -(-plane_elems // pack) + (4 if fused else 0)
    return {
        "bits": bits, "levels": s, "fused": fused,
        "q_range": q.as_list(), "offset_range": off.as_list(),
        "byte_range": byte.as_list(), "wire_dtype": wire_dtype,
        "norm_tail_bytes": 4 if fused else 0,
        "payload_bytes": payload_bytes,
        "findings": findings,
    }
