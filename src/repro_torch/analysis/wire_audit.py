"""Registry-wide wire and privacy audit of the port's traced step.

Port of ``repro.analysis.wire_audit``. For each ``AuditConfig`` in
``MATRIX`` (method x compressor x topology on 4 nodes; the same ids as
the JAX package's) the auditor builds the tiny least-squares
distributed train step of the JAX audit on ``StackTransport(4,
device)``, runs 3 steps of it once under ``graph_walk.trace`` (the loop
unrolled, where JAX has a ``scan``) and checks the graph:

* **taint** (``graph_taint``): privacy-claiming configs (sigma > 0 on a
  method that applies ``masked_grad``) have NO un-sanitized
  data -> collective path; the known-non-private controls
  (``expect_taint``: allreduce's raw-gradient pmean, sigma 0) must be
  FLAGGED -- an empty report there means the analyzer lost its teeth;
* **prng** (``prng_lint``): no key reuse, no step-invariant key, no
  kernel-padded draw shape;
* **wire** (here): per step, the sends in the graph equal
  ``core/wire_count`` (the schedule's rounds x payload tensors), and the
  transport's counters (sends, node 0's bytes) equal the graph's; on
  static schedules the summed payload bits of a step equal the static
  accounting (``transmitted_bits_per_step``) exactly for deterministic
  wire formats; Bernoulli ships one dense plane a round; on
  time-varying schedules the payload-sized sends of a step equal the
  union rounds (the replica transport; full-state DSGD sends the live
  round only, where JAX's compiled ``lax.switch`` holds every round);
  every start is waited on (``launch/graph_analysis``);
* **sensitivity**, **calibration**, **range** and **overlap**
  (``sensitivity``, ``calibration``).

Each row carries the JAX row's keys and certificate, and ``graph``: the
graph's node count and its hand-written kernel nodes (on the card
``fixedk_gather_pack`` and ``qsgd_pack`` are graph ops; on the CPU their
plain versions run as ATen ops).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch.analysis import (calibration, graph_taint, graph_walk,
                                  prng_lint, sensitivity)
from repro_torch.core import (baselines, clipping, gossip, gradient_push,
                              method as method_mod, plane as plane_mod,
                              privacy, sdm_dsgd, tagging, topology,
                              wire_count)
from repro_torch.core import compressor as compressor_mod
from repro_torch.core.transport import StackTransport, settle
from repro_torch.kernels.sdm_update.ref import LANE as KERNEL_LANE
from repro_torch.launch import graph_analysis

__all__ = ["AuditConfig", "MATRIX", "QUICK_IDS", "PASSES", "audit_config",
           "expected_permutes", "allowed_draw_shapes", "build",
           "run_eager", "KERNEL_OPS"]

#: every audit pass, in report order; ``--pass`` selects a subset.
PASSES = ("taint", "prng", "wire", "sensitivity", "calibration", "range",
          "overlap")

N_NODES = 4
DIM = 2 * plane_mod.LANE          # one (2, 128) wire plane
STEPS = 3                         # unrolled steps
BATCH = 8

#: the hand-written kernels' graph ops
KERNEL_OPS = ("repro_torch.fixedk_gather_pack", "repro_torch.qsgd_pack")

expected_permutes = wire_count.expected_permutes


@dataclasses.dataclass(frozen=True)
class AuditConfig:
    method: str                   # registry name ("sdm-dsgd", ...)
    topo: str                     # "ring4" | "dring4" | "matchings4x2" ...
    mode: str                     # gossip mode / compressor spec, "-" dense
    sigma: float = 1.0
    expect_taint: bool = False    # True: the config is KNOWN non-private
    overlap: bool = False         # one-step-stale overlapped transport

    @property
    def id(self) -> str:
        tag = "dirty" if self.expect_taint else f"sigma{self.sigma:g}"
        mode = self.mode + "+ov" if self.overlap else self.mode
        return f"{self.method}/{self.topo}/{mode}/{tag}"


#: the audited registry sweep (the JAX package's, id for id)
MATRIX: Tuple[AuditConfig, ...] = (
    AuditConfig("sdm-dsgd", "ring4", "bernoulli"),
    AuditConfig("sdm-dsgd", "ring4", "fixedk_packed"),
    AuditConfig("sdm-dsgd", "ring4", "fixedk_rows"),
    AuditConfig("sdm-dsgd", "ring4", "qsgd:8"),
    AuditConfig("sdm-dsgd", "ring4", "qsgd:4"),
    AuditConfig("sdm-dsgd", "ring4", "qsgdf:4"),
    AuditConfig("sdm-dsgd", "ring4", "fixedk_packed", overlap=True),
    AuditConfig("sdm-dsgd", "ring4", "qsgdf:4", overlap=True),
    AuditConfig("gradient-push", "dring4", "fixedk", overlap=True),
    AuditConfig("sdm-dsgd", "matchings4x2", "bernoulli"),
    AuditConfig("sdm-dsgd", "matchings4x2", "fixedk_packed"),
    AuditConfig("sdm-dsgd-fused", "ring4", "fixedk_packed"),
    AuditConfig("sdm-dsgd-fused", "matchings4x2", "fixedk_packed"),
    AuditConfig("dc-dsgd", "ring4", "bernoulli"),
    AuditConfig("dsgd", "ring4", "-"),
    AuditConfig("dsgd", "matchings4x2", "-"),
    AuditConfig("gradient-push", "dring4", "-"),
    AuditConfig("gradient-push", "dring4", "fixedk"),
    AuditConfig("gradient-push", "dring4", "qsgd"),
    AuditConfig("gradient-push", "matchings4x2", "fixedk"),
    AuditConfig("sdm-dsgd", "subring4x3", "fixedk_packed"),
    AuditConfig("sdm-dsgd", "subring4x3", "bernoulli"),
    AuditConfig("dsgd", "subring4x3", "-"),
    AuditConfig("gradient-push", "subdring4x3", "fixedk"),
    # negative controls: the analyzer MUST flag these
    AuditConfig("allreduce", "ring4", "-", expect_taint=True),
    AuditConfig("sdm-dsgd", "ring4", "fixedk_packed", sigma=0.0,
                expect_taint=True),
)

#: the quick subset for smoke runs (--quick)
QUICK_IDS = frozenset({
    "sdm-dsgd/ring4/fixedk_packed/sigma1",
    "sdm-dsgd/ring4/qsgd:4/sigma1",
    "sdm-dsgd/matchings4x2/fixedk_packed/sigma1",
    "dsgd/ring4/-/sigma1",
    "gradient-push/dring4/fixedk/sigma1",
    "sdm-dsgd/subring4x3/fixedk_packed/sigma1",
    "sdm-dsgd/ring4/fixedk_packed+ov/sigma1",
    "allreduce/ring4/-/dirty",
})


def parse_topo(spec: str) -> gossip.ScheduleSequence:
    if spec == "ring4":
        return gossip.ensure_sequence(
            gossip.schedule_from_topology(topology.ring(N_NODES)))
    if spec == "dring4":
        return gossip.ensure_sequence(gossip.schedule_from_topology(
            topology.directed_ring(N_NODES)))
    if spec == "matchings4x2":
        return gossip.sequence_from_topologies(
            topology.random_matchings(N_NODES, 2, seed=0), name=spec)
    if spec in ("subring4x3", "subdring4x3"):
        # the edge-fleet simulator's partial-participation schedule: a
        # q=0.75 participation trace from the sim's own fleet PRNG
        from repro_torch.sim.fleet import Fleet

        base = (topology.directed_ring(N_NODES) if spec == "subdring4x3"
                else topology.ring(N_NODES))
        fleet = Fleet(N_NODES, "q=0.75", seed=0)
        sets = [np.nonzero(fleet.sample_participants())[0]
                for _ in range(3)]
        return gossip.sequence_from_active_sets(base, sets, name=spec)
    raise ValueError(f"unknown audit topology {spec!r}")


def make_cfg(ac: AuditConfig, meth):
    if meth.config_cls is sdm_dsgd.SDMConfig:
        kw = dict(p=0.25, theta=0.15, gamma=0.2, sigma=ac.sigma,
                  clip_c=1.0, overlap=ac.overlap)
        if ac.mode.split(":")[0] in ("qsgd", "qsgdf"):
            return meth.coerce_config(
                sdm_dsgd.SDMConfig(compressor=ac.mode, **kw))
        return meth.coerce_config(sdm_dsgd.SDMConfig(mode=ac.mode, **kw))
    if meth.config_cls is gradient_push.GradientPushConfig:
        return gradient_push.GradientPushConfig(
            gamma=0.2, sigma=ac.sigma, clip_c=1.0,
            compressor=None if ac.mode == "-" else ac.mode, p=0.25,
            overlap=ac.overlap)
    return baselines.DSGDConfig(gamma=0.2, sigma=ac.sigma, clip_c=1.0)


def allowed_draw_shapes(per_node) -> frozenset:
    """Canonical (rows, lane) shapes mask / noise draws may use: the wire
    plane spec per bucket, plus the fused update's LANE-padded plane."""
    spec = plane_mod.ParamPlane.for_tree(per_node)
    shapes = set(spec.plane_shapes())
    shapes.add((-(-spec.total_size // KERNEL_LANE), KERNEL_LANE))
    return frozenset(shapes)


class Built(NamedTuple):
    meth: object
    seq: object
    cfg: object
    gm: Optional[torch.fx.GraphModule]
    args: tuple
    per_node: dict
    transport: StackTransport
    launches: dict


def _problem(ac: AuditConfig, device):
    """(method, schedule, config, step function, its inputs, transport):
    the audit's least-squares problem, drawn from seed 0 as the JAX
    audit draws it."""
    meth = method_mod.get(ac.method)
    seq = parse_topo(ac.topo)
    n = seq.n_nodes
    cfg = make_cfg(ac, meth)
    rng = np.random.default_rng(0)
    a_st = torch.from_numpy((rng.normal(size=(n, BATCH, DIM)) / 4.0)
                            .astype(np.float32)).to(device)
    b_st = torch.from_numpy(rng.normal(size=(n, BATCH))
                            .astype(np.float32)).to(device)
    p0 = torch.from_numpy((rng.normal(size=(DIM,)) * 0.1)
                          .astype(np.float32)).to(device)
    params_stack = {"w": p0[None].expand(n, DIM).clone()}
    transport = StackTransport(n, device)
    ex = meth.make_distributed(seq, cfg, transport)
    base_key = prng.PRNGKey(42, device=device)

    def dist_train(params_stack, a_st, b_st):
        state = ex.init(params_stack)

        def grads_at(tree):
            r = torch.bmm(a_st, tree["w"][..., None])[..., 0] - b_st
            g = torch.bmm(a_st.transpose(1, 2), r[..., None])[..., 0]
            return {"w": g / a_st.shape[1]}, torch.mean(r * r, dim=1)

        for t in range(STEPS):
            with tagging.iteration(t):
                state, losses = ex.step(state, grads_at, base_key=base_key)
        state = settle(state)
        # the metric release every real train step performs
        loss = transport.pmean(tagging.declared_release(losses,
                                                        label="loss"))
        return state.x["w"], loss

    return meth, seq, cfg, dist_train, (params_stack, a_st, b_st), transport


def _kernel_launches() -> dict:
    from repro_torch.kernels.wire_compress import (fixedk_gather_pack,
                                                   qsgd_pack)

    return {"fixedk_gather_pack": fixedk_gather_pack.launches,
            "qsgd_pack": qsgd_pack.launches}


def build(ac: AuditConfig, device="cuda") -> Built:
    """Trace ``ac``'s 3-step distributed train step (run once, for real,
    on ``device``). ``launches`` is each wire kernel's launches during
    the trace."""
    device = resolve_device(device)
    meth, seq, cfg, fn, args, transport = _problem(ac, device)
    before = _kernel_launches()
    gm = graph_walk.trace(fn, *args)
    after = _kernel_launches()
    per_node = {"w": args[0]["w"][0]}
    return Built(meth, seq, cfg, gm, args, per_node, transport,
                 {k: after[k] - before[k] for k in after})


def run_eager(ac: AuditConfig, device="cuda"):
    """The same 3 steps run untraced (tags off): (final x, loss)."""
    device = resolve_device(device)
    _, _, _, fn, args, _ = _problem(ac, device)
    return fn(*args)


def _exact_bits(meth, meth_name: str, mode: str, cfg, per_node, seq
                ) -> Optional[int]:
    """The static accounting where it equals the wire bits EXACTLY
    (deterministic wire formats; Bernoulli's is an expectation)."""
    base = mode.split(":")[0]
    if meth_name.startswith("sdm-dsgd") or meth_name == "dc-dsgd":
        if base in ("fixedk_packed", "fixedk_rows", "qsgd", "qsgdf"):
            return int(sdm_dsgd.transmitted_bits_per_step(
                per_node, cfg, seq=seq))
        return None
    if meth_name == "dsgd":
        return int(method_mod.transmitted_bits(meth, per_node, cfg, seq=seq))
    return None


def _wire_findings(ac: AuditConfig, b: Built) -> List[dict]:
    meth, seq, cfg, gm, per_node = b.meth, b.seq, b.cfg, b.gm, b.per_node
    findings: List[dict] = []
    payloads = graph_analysis.permute_payloads(gm)
    for kind, pair in graph_analysis.async_collective_pairs(gm).items():
        if pair["start"] != pair["done"] or pair["unmatched"]:
            findings.append({"kind": "async-pair-imbalance", "op": kind,
                             "got": pair})
    by_step = [[pl for pl in payloads if pl["step"] == t]
               for t in range(STEPS)]
    # the transport's counters against the graph and core/wire_count
    want = [wire_count.permutes_per_step(ac.method, ac.mode, seq, t)
            for t in range(STEPS)]
    got = [len(s) for s in by_step]
    if got != want or b.transport.permutes != len(payloads):
        findings.append({"kind": "transport-count", "graph": got,
                         "expected": want,
                         "transport": b.transport.permutes})
    sent0 = sum(c["elt_bytes"] * int(np.prod(c["row_shape"] or (1,)))
                for c in graph_analysis.collective_nodes(gm)
                if c["kind"] in ("ppermute", "ppermute_start")
                and any(src == 0 for src, _ in c["perm"]))
    if b.transport.bytes_sent[0] != sent0:
        findings.append({"kind": "transport-bytes", "graph": sent0,
                         "transport": b.transport.bytes_sent[0]})
    spec = plane_mod.ParamPlane.for_tree(per_node)
    (p_rows, p_lane), = spec.plane_shapes()
    plane_elems = p_rows * p_lane

    if seq.length == 1:
        exp = expected_permutes(ac.method, ac.mode, seq)
        if any(g != exp for g in got):
            findings.append({"kind": "permute-count", "got": got,
                             "expected": exp})
        exact = _exact_bits(meth, ac.method, ac.mode, cfg, per_node, seq)
        if exact is not None:
            bits = [sum(pl["bits"] for pl in s) for s in by_step]
            if any(x != exact for x in bits):
                findings.append({"kind": "payload-bits", "got": bits,
                                 "expected": exact})
        if ac.mode == "bernoulli":
            r = seq.schedules[0].n_rounds
            dense = [sum(1 for pl in s
                         if pl["elems"].get("f32", 0) == plane_elems)
                     for s in by_step]
            if any(x != r for x in dense):
                findings.append({"kind": "dense-payload-rounds",
                                 "got": dense, "expected": r})
        return findings
    # replica transport: branch-free payload over every union round
    useq = gossip.union_schedule(seq)
    base = ac.mode.split(":")[0]
    if base == "qsgd":
        def is_payload(pl):
            return pl["bits"] >= plane_elems * 8
    elif ac.mode in ("bernoulli", "-"):
        def is_payload(pl):
            return pl["elems"].get("f32", 0) == plane_elems
    else:
        from repro_torch.core import sparsifier

        k = sparsifier.num_kept(plane_elems, 0.25)

        def is_payload(pl):
            return pl["elems"].get("f32", 0) == k
    pperms = [sum(1 for pl in s if is_payload(pl)) for s in by_step]
    if ac.method == "dsgd":
        # the full state crosses the live round only (Python picks it;
        # JAX's compiled lax.switch holds every round's permutes)
        expected = [seq.at(t).n_rounds for t in range(STEPS)]
    else:
        expected = [useq.n_replicas] * STEPS
    if pperms != expected:
        findings.append({"kind": "union-payload-rounds", "got": pperms,
                         "expected": expected})
    return findings


def _compressor_for(meth, cfg) -> Optional[compressor_mod.Compressor]:
    if meth.config_cls is sdm_dsgd.SDMConfig:
        return sdm_dsgd.compressor_of(cfg)
    if meth.config_cls is gradient_push.GradientPushConfig:
        return cfg.make_compressor()
    return None


def accountant_view(ac: AuditConfig, meth, cfg, per_node) -> dict:
    """The privacy constants the RDP accountant charges for this config:
    the certificate column the graph-extracted constants are checked
    against."""
    d_total = sum(int(v.numel()) for v in per_node.values())
    clip_c = float(getattr(cfg, "clip_c", 0.0) or 0.0) or None
    G = clipping.sensitivity_G(clip_c, d_total) if clip_c else None
    comp = _compressor_for(meth, cfg)
    p_rel = comp.release_probability if comp is not None else 1.0
    view = {
        "sigma": ac.sigma,
        "clip_c": clip_c,
        "d": d_total,
        "G": G,
        "release_p": list(p_rel) if isinstance(p_rel, tuple) else p_rel,
        "sigma_times_c": (ac.sigma * clip_c) if clip_c else None,
        "compressor": comp.name if comp is not None else None,
        "coord_inflation_at_c":
            comp.coord_sensitivity_transfer(clip_c, (DIM,))
            if (comp is not None and clip_c) else None,
    }
    if ac.sigma > 0.0 and clip_c:
        try:
            params = privacy.PrivacyParams(
                G=G, m=BATCH, tau=1.0 / BATCH, p=p_rel, sigma=ac.sigma)
            view["epsilon_at_T"] = privacy.epsilon_sdm(
                params, STEPS, eps_target=0.5)
        except ValueError:
            view["epsilon_at_T"] = None
    return view


def _range_certificate(b: Built) -> Tuple[List[dict], Optional[dict]]:
    """Integer-range pass: only quantized wire formats have integer
    planes to certify."""
    comp = _compressor_for(b.meth, b.cfg)
    if not isinstance(comp, compressor_mod.QSGDCompressor):
        return [], None
    spec = plane_mod.ParamPlane.for_tree(b.per_node)
    (p_rows, p_lane), = spec.plane_shapes()
    fused = isinstance(comp, compressor_mod.FusedQSGDCompressor)
    cert = sensitivity.qsgd_range_certificate(
        comp.bits, fused=fused, plane_elems=p_rows * p_lane)
    findings = list(cert.pop("findings"))
    # the proved wire dtype must cross the wire: a silent widening would
    # void the range proof
    payloads = graph_analysis.permute_payloads(b.gm)
    if not any(pl["elems"].get(cert["wire_dtype"]) for pl in payloads):
        findings.append({
            "kind": "wire-dtype-missing", "dtype": cert["wire_dtype"],
            "detail": "no send ships the certified integer dtype"})
    return findings, cert


def _graph_summary(b: Built) -> dict:
    ops = Counter(graph_walk.op_of(nd) for nd in b.gm.graph.nodes)
    return {"nodes": len(b.gm.graph.nodes),
            "kernel_nodes": {k.split(".", 1)[1]: ops.get(k, 0)
                             for k in KERNEL_OPS},
            "kernel_launches": dict(b.launches),
            "collectives": ops.get("repro_torch." + tagging.COLLECTIVE, 0)}


def audit_config(ac: AuditConfig, passes=PASSES, device="cuda") -> dict:
    """Run the selected audit passes on one configuration, traced on
    ``device``. The row always carries every key, with unselected passes
    empty and their certificate fields ``None``."""
    passes = frozenset(passes)
    b = build(ac, device)
    gm = b.gm
    source_labels = {1: "data", 2: "data"}

    taint = graph_taint.analyze_taint(gm, source_labels) \
        if "taint" in passes else None
    prng_rep = prng_lint.analyze_prng(
        gm, allowed_shapes=allowed_draw_shapes(b.per_node)) \
        if "prng" in passes else None
    wire = _wire_findings(ac, b) if "wire" in passes else []

    # negative controls get certificates but no certifier gates: their
    # point is that the QUALITATIVE pass flags them
    claims = (not ac.expect_taint) and ac.sigma > 0.0
    clip_c = float(getattr(b.cfg, "clip_c", 0.0) or 0.0) or None
    sens = sensitivity.analyze_sensitivity(
        gm, source_labels, clip_c=clip_c, check=claims) \
        if "sensitivity" in passes else None
    calib = calibration.analyze_calibration(
        gm, expected_sigma=ac.sigma, expected_clip=clip_c,
        check=claims) if "calibration" in passes else None
    rng_findings, rng_cert = _range_certificate(b) \
        if "range" in passes else ([], None)
    ovl = calibration.analyze_overlap(
        gm, overlap=ac.overlap, needs_replicas=gossip.needs_replicas(b.seq)) \
        if "overlap" in passes else None

    taint_findings = list(taint["findings"]) if taint else []
    if taint and ac.expect_taint:
        if taint_findings:
            taint_findings = []     # expected dirt: the analyzer has teeth
        else:
            taint_findings = [{"kind": "expected-taint-missing",
                               "detail": "known-non-private config produced "
                                         "no taint finding"}]
    sens_findings = sens["findings"] if sens else []
    calib_findings = calib["findings"] if calib else []
    ovl_findings = ovl["findings"] if ovl else []
    prng_findings = prng_rep["findings"] if prng_rep else []
    violations = (taint_findings + prng_findings + wire + sens_findings
                  + calib_findings + rng_findings + ovl_findings)
    certificate = {
        "accountant": accountant_view(ac, b.meth, b.cfg, b.per_node),
        "sanitize_bounds": sens["sanitize_sites"] if sens else None,
        "wire_coord_bound": sens["wire_coord_bound"] if sens else None,
        "clip_sites": sens["clip_sites"] if sens else None,
        "extracted_noise": calib["sanitize_sites"] if calib else None,
        "integer_ranges": rng_cert,
        "overlap": ({"verdict": ovl["verdict"],
                     "n_pending": ovl["n_pending"]} if ovl else None),
    }
    return {
        "id": ac.id,
        "expect_taint": ac.expect_taint,
        "passes": sorted(passes & set(PASSES)),
        "taint": taint_findings,
        "prng": prng_findings,
        "wire": wire,
        "sensitivity": sens_findings,
        "calibration": calib_findings,
        "range": rng_findings,
        "overlap": ovl_findings,
        "certificate": certificate,
        "releases": taint["releases"] if taint else [],
        "n_draws": prng_rep["n_draws"] if prng_rep else 0,
        "n_sanitize_sites": taint["n_sanitize_sites"] if taint else 0,
        "status": "fail" if violations else "pass",
        "graph": _graph_summary(b),
    }
