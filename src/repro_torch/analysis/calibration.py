"""Noise-calibration cross-check and the overlap double-buffer pass, over
the port's traced step.

Port of ``repro.analysis.calibration``.

Calibration
-----------
The accountant (``core.privacy``) charges epsilon for a Gaussian mask of
std sigma; ``masked_grad`` is supposed to add exactly that sigma. This
pass extracts the concrete noise std at each ``sanitize`` site and
cross-checks it against the sigma the config's accountant charges.

The abstract value is the SET of Gaussian stds a value carries. A
``prng_draw`` node of the normal distribution carries {1} (the port's
PRNG draws it as one node while the auditor traces); a multiply or
divide by a literal scales every std (the port writes ``x + sigma *
noise``, so sigma is a literal factor); adds and structural ops union;
any other op clears (a squared Gaussian is not a Gaussian). The
gather-pack kernel scales by its literal nb/kb like its plain version
(a gather and a multiply); the QSGD pack clears.

Overlap hazards
---------------
``overlap`` leaves each exchange in flight for one step: the fresh
neighbour sums (tagged ``pending_buffer`` with the step that started
the exchange, ``core/tagging``) must be consumed exactly one step later.
JAX proves that over its scan body; the port's trace is the loop
unrolled, every node labelled with its step (``loop_iteration``), and a
token walk from each tag shows where the buffer goes:

* ``pending-same-round-read`` -- a node of the tag's own step reads it
  (staleness 0, not 1);
* ``pending-not-carried`` -- no later step reads it (the result is
  dropped or consumed in the same step);
* ``pending-dropped`` -- it reaches later steps but not the next one;
* ``pending-self-dependence`` -- the buffer depends on the previous
  step's buffer (staleness would exceed one step), unless that buffer
  was read in its own step (the finding above already says so);
* ``overlap-untagged`` / ``pending-without-overlap`` /
  ``overlap-replica-schedule`` as in the JAX package.

The last step's buffer is left for the step after the trace and is not
held to the next-step rules. ``n_pending`` counts the tags of one step.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, FrozenSet, List, Optional

from repro_torch.analysis import graph_walk
from repro_torch.core import tagging

__all__ = ["analyze_calibration", "analyze_overlap", "KERNEL_RULES"]

Stds = FrozenSet[float]

_UNION = frozenset("aten." + n for n in (
    "add", "sub", "neg", "view", "reshape", "_unsafe_view", "slice",
    "select", "expand", "permute", "transpose", "t", "unsqueeze",
    "squeeze", "alias", "detach", "lift_fresh", "unbind", "split",
    "split_with_sizes", "narrow", "clone", "contiguous", "_to_copy",
    "copy", "cat", "stack", "flip", "roll", "constant_pad_nd", "gather",
    "index_select", "index", "slice_scatter", "select_scatter", "where",
    "index_put", "scatter", "positive"))

_DRAW = "repro_torch." + tagging.DRAW
_SANITIZE = "repro_torch." + tagging.SANITIZE
_CLIP = "repro_torch." + tagging.CLIP
_PENDING = "repro_torch." + tagging.PENDING
_PASS_TAGS = frozenset("repro_torch." + t for t in
                       (tagging.WIRE, tagging.RELEASE, tagging.PENDING))


def _round_std(v: float) -> float:
    return float(f"{v:.12g}")


def _fixedk_gather_pack_rule(interp, node, ins) -> Stds:
    from repro_torch.kernels.wire_compress.ref import f32_scale

    c = abs(float(f32_scale(float(node.args[2]))))
    return frozenset(_round_std(s * c) for s in ins[0])


#: declared std rules of the hand-written kernels' graph ops
KERNEL_RULES = {
    "repro_torch.fixedk_gather_pack": _fixedk_gather_pack_rule,
    "repro_torch.qsgd_pack": lambda interp, node, ins: frozenset(),
}


class _NoiseInterp(graph_walk.GraphInterpreter):
    def __init__(self):
        self.sanitize_sites: Dict[tuple, dict] = {}
        self.clip_sites: Dict[tuple, dict] = {}

    def bottom(self) -> Stds:
        return frozenset()

    def join(self, a: Stds, b: Stds) -> Stds:
        return a | b

    def default(self, node, name, ins) -> Stds:
        # any other op destroys Gaussian-ness (squares, norms, compares)
        return frozenset()

    def transfer(self, node, name, ins):
        if name in KERNEL_RULES:
            return KERNEL_RULES[name](self, node, ins)
        if name == _DRAW:
            dist = graph_walk.tag_args(node)["dist"]
            return frozenset({1.0}) if dist == "normal" else frozenset()
        if name == _SANITIZE:
            a = graph_walk.tag_args(node)
            rec = self.sanitize_sites.setdefault(
                (a["site"], a["leaf"]), {"site": a["site"],
                                         "stds": frozenset()})
            rec["stds"] = rec["stds"] | ins[0]
            return frozenset()
        if name == _CLIP:
            a = graph_walk.tag_args(node)
            self.clip_sites.setdefault(
                (a["site"], a["leaf"]), {"site": a["site"],
                                         "bound": float(a["bound"])})
            return ins[0]
        if name in _PASS_TAGS:
            return ins[0]
        if name in ("aten.mul", "aten.div"):
            x, y = node.args[0], node.args[1]
            lx, ly = self.literal(x), self.literal(y)
            if name == "aten.mul" and lx is not None:
                return frozenset(_round_std(s * abs(lx))
                                 for s in self.value(y))
            if ly is not None and ly != 0.0 and not node.kwargs.get(
                    "rounding_mode"):
                c = abs(ly) if name == "aten.mul" else 1.0 / abs(ly)
                return frozenset(_round_std(s * c) for s in self.value(x))
            return frozenset()
        if name in _UNION:
            out = frozenset()
            for v in ins:
                out = out | v
            return out
        return frozenset()


def analyze_calibration(gm, *, expected_sigma: float,
                        expected_clip: Optional[float], check: bool = True,
                        rel_tol: float = 1e-4) -> dict:
    """Extract the noise stds at each ``sanitize`` site of a traced graph
    and cross-check them against the accountant's sigma. ``check=False``
    still returns the extracted constants for the certificate."""
    interp = _NoiseInterp()
    interp.run(gm, [])

    findings: List[dict] = []
    sites = []
    for rec in interp.sanitize_sites.values():
        stds = sorted(rec["stds"])
        matched = [s for s in stds
                   if math.isclose(s, expected_sigma, rel_tol=rel_tol)]
        sites.append({"site": rec["site"], "stds": stds,
                      "extracted_sigma": matched[0] if matched
                      else (stds[-1] if stds else None)})
        if not check:
            continue
        if not stds:
            findings.append({
                "kind": "noise-scale-unextracted", "site": rec["site"],
                "detail": "sanitize operand carries no recognizable "
                          "Gaussian noise term"})
        elif not matched:
            findings.append({
                "kind": "noise-scale-mismatch", "site": rec["site"],
                "graph_sigma": stds, "accountant_sigma": expected_sigma})
    if check and expected_sigma > 0.0 and not interp.sanitize_sites:
        findings.append({
            "kind": "missing-noise",
            "detail": f"config charges sigma={expected_sigma} but the "
                      "graph has no sanitize site"})
    del expected_clip       # the sensitivity pass checks the clip bound
    clip_rows = [{"site": rec["site"], "bound": rec["bound"]}
                 for rec in interp.clip_sites.values()]
    return {"findings": findings, "sanitize_sites": sites,
            "clip_sites": clip_rows}


# ==========================================================================
# Overlap double-buffer hazards (token walk over the unrolled steps).
# ==========================================================================

class _TokenInterp(graph_walk.GraphInterpreter):
    """Frozensets of pending tokens; each ``pending_buffer`` node mints
    its own token besides passing its input's."""

    def __init__(self):
        self.pending: List[dict] = []
        self.readers: Dict[str, set] = defaultdict(set)

    def bottom(self) -> frozenset:
        return frozenset()

    def join(self, a, b):
        return a | b

    def transfer(self, node, name, ins):
        if name == _PENDING:
            self.pending.append({
                "token": node.name,
                "step": graph_walk.tag_args(node)["step"],
                "site": graph_walk.tag_args(node)["site"],
                "inputs": ins[0]})
            return ins[0] | {node.name}
        return None

    def _eval(self, node, name):
        out = super()._eval(node, name)
        if name != _PENDING:
            for tok in (out if isinstance(out, frozenset) else
                        frozenset().union(*out)):
                self.readers[tok].add(self.iteration[node])
        return out


def analyze_overlap(gm, *, overlap: bool,
                    needs_replicas: bool = False) -> dict:
    """Verify the overlap double-buffer discipline of a traced graph (see
    the module docstring). Non-overlap configs verify vacuously (verdict
    ``n/a``) but still reject stray pending tags."""
    findings: List[dict] = []
    if overlap and needs_replicas:
        findings.append({
            "kind": "overlap-replica-schedule",
            "detail": "overlap=True requires a static (non-replica) "
                      "schedule; replica delivery would consume the "
                      "pending buffer at unbounded staleness"})
    interp = _TokenInterp()
    interp.run(gm, [])
    by_step: Dict[int, List[dict]] = defaultdict(list)
    for p in interp.pending:
        by_step[p["step"]].append(p)
    last = max(interp.iteration.values(), default=-1)
    step_of = {p["token"]: p["step"] for p in interp.pending}
    # read in the step that minted it; a later buffer that depends on such
    # a read one is explained by that read, not a self-dependence
    early = {p["token"] for p in interp.pending
             if p["step"] in interp.readers.get(p["token"], set())}
    buffers = []
    for p in interp.pending:
        t, site = p["step"], p["site"]
        seen = interp.readers.get(p["token"], set())
        if p["token"] in early:
            findings.append({
                "kind": "pending-same-round-read", "site": site,
                "detail": "fresh exchange result read in the step that "
                          "produced it (staleness 0, not 1)"})
        if any(step_of[tok] == t - 1 and tok not in early
               for tok in p["inputs"]):
            findings.append({
                "kind": "pending-self-dependence", "site": site,
                "detail": "new pending buffer depends on the previous "
                          "one: staleness exceeds one step"})
        if t < last:
            later = {s for s in seen if s > t}
            if not later:
                findings.append({"kind": "pending-not-carried",
                                 "site": site})
            elif t + 1 not in later:
                findings.append({
                    "kind": "pending-dropped", "site": site,
                    "detail": "the pending buffer is not consumed by the "
                              "next step's update"})
        buffers.append({"site": site, "step": t,
                        "read_in_steps": sorted(seen)})
    n_pending = max((len(v) for v in by_step.values()), default=0)
    if overlap and n_pending == 0:
        findings.append({
            "kind": "overlap-untagged",
            "detail": "overlap config but no pending_buffer tag in any "
                      "training step (double buffer bypassed?)"})
    if not overlap and n_pending > 0:
        findings.append({
            "kind": "pending-without-overlap",
            "detail": "pending_buffer tag in a non-overlap config"})
    verdict = "n/a" if not overlap else (
        "ok" if not findings else "hazard")
    return {"findings": findings, "verdict": verdict,
            "n_pending": n_pending, "buffers": buffers}
