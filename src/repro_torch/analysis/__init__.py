"""Static analysis of the port's traced train step.

Port of ``repro.analysis``. The JAX package walks a jaxpr and the
compiled HLO; the port traces its distributed step on a
``StackTransport`` with ``make_fx`` (``graph_walk.trace``: real
tensors, functionalized, the loop unrolled) and walks the fx graph. The
tags and markers the passes key on are ``core/tagging``'s.

Seven passes, one CLI (``python -m repro_torch.analysis``; select with
``--pass``):

* ``taint`` (``graph_taint``) -- no un-sanitized data-derived tensor
  reaches a collective; every send is wire-tagged;
* ``prng`` (``prng_lint``) -- no key consumed twice, no key drawn in two
  steps, no draw at a kernel-padded plane shape;
* ``wire`` (``wire_audit``) -- sends per step == the schedule's rounds x
  payload tensors (``core/wire_count``) == the transport's counters;
  payload bits == the static accounting; starts waited on;
* ``sensitivity`` -- the sanitize operand's coordinate bound <= C, wire
  buffers post-noise;
* ``calibration`` -- the Gaussian std at each sanitize site == the
  accountant's sigma;
* ``range`` -- the qsgd / qsgdf integer wire encodings stay in range;
* ``overlap`` -- the overlap's pending buffer is consumed one step later.

They run over the method x compressor x topology matrix on 4 nodes
(``wire_audit.MATRIX``, the JAX package's ids); each report row carries
a machine-readable privacy certificate.
"""
__all__ = ["analyze_taint", "analyze_prng", "analyze_sensitivity",
           "analyze_calibration", "analyze_overlap",
           "qsgd_range_certificate", "audit_config", "MATRIX", "PASSES",
           "expected_permutes"]

_EXPORTS = {
    "analyze_taint": "repro_torch.analysis.graph_taint",
    "analyze_prng": "repro_torch.analysis.prng_lint",
    "analyze_sensitivity": "repro_torch.analysis.sensitivity",
    "qsgd_range_certificate": "repro_torch.analysis.sensitivity",
    "analyze_calibration": "repro_torch.analysis.calibration",
    "analyze_overlap": "repro_torch.analysis.calibration",
    "audit_config": "repro_torch.analysis.wire_audit",
    "MATRIX": "repro_torch.analysis.wire_audit",
    "PASSES": "repro_torch.analysis.wire_audit",
    "expected_permutes": "repro_torch.analysis.wire_audit",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(name)
