"""PyTorch port: the static privacy and wire auditor
(``repro_torch.analysis``).

Four layers, on the CPU:

* **against JAX**: the JAX package's full matrix (``python -m
  repro.analysis``, 4 faked devices, a subprocess this file starts) and
  the port's (``wire_audit.audit_config`` on ``StackTransport(4,
  "cpu")``) agree row for row on the 26 ids: status, each pass's finding
  kinds (PRNG aside: under jax 0.9 JAX's PRNG pass sees no draw, so the
  port's ``n_draws`` is held to the draws its trace made instead), the
  sanitize sites and their bounds, the releases, the clip bounds
  exactly, the extracted sigma (rel 1e-6; JAX reads 0.999999982886
  through its f32 sqrt(2) rounding), the accountant view (epsilon rel
  1e-9, the rest exact), the wire bound, the integer ranges and the
  overlap verdict;
* **the fixtures**, torch copies of ``tests/fixtures/broken_method.py``
  and ``miscalibrated_method.py`` kept here, each reporting exactly its
  seeded bugs;
* **the scenarios** of ``tests/test_analysis.py`` on small traced
  functions (loops unrolled with ``tagging.iteration``), the declared
  kernel rules against the walk through each kernel's plain version,
  and the main path: with recording off, a ``perf_wire`` step
  dispatches the same ATen ops as an untagged one;
* **the CLI** (``python -m repro_torch.analysis`` and
  ``repro_torch.launch.lint``): selectors, ``--quick``, shards, the
  suppression baseline and the exit code.
"""
import inspect
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.analysis import (calibration, graph_taint,  # noqa: E402
                                  graph_walk, prng_lint, sensitivity,
                                  wire_audit)
from repro_torch.core import (clipping, gossip, tagging,  # noqa: E402
                              topology)
from repro_torch.core.transport import StackTransport  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
IDS = [ac.id for ac in wire_audit.MATRIX]
FINDING_KEYS = ("taint", "wire", "sensitivity", "calibration", "range",
                "overlap")


# ------------------------------------------------------------- the reports

@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """(JAX's report rows, the port's rows, draws each port trace made),
    by id. JAX runs in a subprocess while the port audits here."""
    out = tmp_path_factory.mktemp("lint") / "LINT_report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro.analysis", "--devices", "4",
         "--out", str(out)], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    draws, rows = {}, {}
    real_draw = tagging.prng_draw
    count = [0]

    def spy(*a, **k):
        count[0] += 1
        return real_draw(*a, **k)

    tagging.prng_draw = spy
    try:
        for ac in wire_audit.MATRIX:
            count[0] = 0
            rows[ac.id] = wire_audit.audit_config(ac, device="cpu")
            draws[ac.id] = count[0]
    finally:
        tagging.prng_draw = real_draw
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-3000:]
    jax_rows = {r["id"]: r for r in json.loads(out.read_text())["configs"]}
    return jax_rows, rows, draws


def test_matrix_ids_are_jax_s(reports):
    jax_rows, rows, _ = reports
    assert list(jax_rows) == IDS == list(rows)
    assert len(IDS) == 26 and wire_audit.QUICK_IDS <= set(IDS)


def _kinds(row, key):
    return sorted(f["kind"] for f in row[key])


@pytest.mark.parametrize("cid", IDS)
def test_row_agrees_with_jax(reports, cid):
    jax_rows, rows, _ = reports
    j, t = jax_rows[cid], rows[cid]
    assert t["status"] == j["status"] == "pass", (t, j)
    for key in FINDING_KEYS:
        assert _kinds(t, key) == _kinds(j, key), key
    assert t["n_sanitize_sites"] == j["n_sanitize_sites"]
    assert [r["label"] for r in t["releases"]] == \
        [r["label"] for r in j["releases"]]
    jc, tc = j["certificate"], t["certificate"]
    assert [s["bound"] for s in tc["clip_sites"]] == \
        [s["bound"] for s in jc["clip_sites"]]
    assert [(s["coord_bound"], s["l2_bound"], s["numel"])
            for s in tc["sanitize_bounds"]] == \
        [(s["coord_bound"], s["l2_bound"], s["numel"])
         for s in jc["sanitize_bounds"]]
    js = [s["extracted_sigma"] for s in jc["extracted_noise"]]
    ts = [s["extracted_sigma"] for s in tc["extracted_noise"]]
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        assert a == pytest.approx(b, rel=1e-6)
    ja, ta = jc["accountant"], tc["accountant"]
    assert set(ta) == set(ja)
    for k in ja:
        if k == "epsilon_at_T" and ja[k] is not None:
            assert ta[k] == pytest.approx(ja[k], rel=1e-9)
        else:
            assert ta[k] == ja[k], k
    assert tc["wire_coord_bound"] == jc["wire_coord_bound"]
    assert tc["integer_ranges"] == jc["integer_ranges"]
    assert tc["overlap"] == jc["overlap"]


@pytest.mark.parametrize("cid", IDS)
def test_prng_pass_counts_the_trace_s_draws(reports, cid):
    _, rows, draws = reports
    row = rows[cid]
    assert row["prng"] == []
    assert row["n_draws"] == draws[cid]
    if not cid.startswith("allreduce"):
        assert row["n_draws"] > 0
    else:
        assert row["n_draws"] == 0


def test_negative_controls_are_flagged_by_the_taint_pass():
    for cid in ("allreduce/ring4/-/dirty",
                "sdm-dsgd/ring4/fixedk_packed/dirty"):
        ac = next(a for a in wire_audit.MATRIX if a.id == cid)
        b = wire_audit.build(ac, "cpu")
        rep = graph_taint.analyze_taint(b.gm, {1: "data", 2: "data"})
        assert [f["kind"] for f in rep["findings"]] == \
            ["tainted-collective"], cid
        assert rep["n_sanitize_sites"] == 0


def test_traced_state_equals_an_untraced_run():
    ac = next(a for a in wire_audit.MATRIX
              if a.id == "sdm-dsgd/ring4/fixedk_packed+ov/sigma1")
    b = wire_audit.build(ac, "cpu")
    x_graph, loss_graph = b.gm(*b.args)
    x_eager, loss_eager = wire_audit.run_eager(ac, "cpu")
    assert torch.equal(x_graph, x_eager)
    assert torch.equal(loss_graph, loss_eager)
    assert b.transport.permutes == 3 * 2 and b.transport.outstanding == 0


@pytest.mark.parametrize("entry", ["build", "run_eager", "audit_config"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without ``device`` the auditor runs on the card, and raises where
    there is none rather than audit on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(wire_audit, entry)(wire_audit.MATRIX[0])


def _no_sanitize(monkeypatch):
    from repro_torch.core import sdm_dsgd

    monkeypatch.setattr(sdm_dsgd.tagging, "sanitize", lambda t, **kw: t)


def _noise_drift(monkeypatch):
    from repro_torch.core import sdm_dsgd

    add = sdm_dsgd._add_noise
    monkeypatch.setattr(sdm_dsgd, "_add_noise",
                        lambda key, tree, sigma: add(key, tree, 1.3 * sigma))


def _no_wire_tag(monkeypatch):
    monkeypatch.setattr(gossip.tagging, "wire_payload", lambda x, **kw: x)


def _edit(monkeypatch, module, name, old, new):
    """``module.name`` replaced by its source with ``old`` made ``new``."""
    src = textwrap.dedent(inspect.getsource(getattr(module, name)))
    assert src.count(old) == 1, (name, old)
    ns = dict(vars(module))
    exec(compile(src.replace(old, new), module.__file__, "exec"), ns)
    monkeypatch.setattr(module, name, ns[name])


def _sparsifier_draws_noise_key(monkeypatch):
    from repro_torch.core import sdm_dsgd

    _edit(monkeypatch, sdm_dsgd, "_plane_exchange",
          "key = gossip.node_round_key(bkey, me, step)",
          "key = prng.fold_in(_node_noise_key(base_key, me, step), b)")


def _noise_key_without_step(monkeypatch):
    from repro_torch.core import sdm_dsgd

    key = sdm_dsgd._node_noise_key
    monkeypatch.setattr(sdm_dsgd, "_node_noise_key",
                        lambda base, me, step: key(base, me, 0))


def _no_clip(monkeypatch):
    from repro_torch.core import sdm_dsgd

    _edit(monkeypatch, sdm_dsgd, "masked_grad",
          "grads = clipping.clip_tree(grads, clip_c)", "pass")


def _pending_read_same_step(monkeypatch):
    from repro_torch.core import sdm_dsgd

    _edit(monkeypatch, sdm_dsgd, "distributed_advance",
          "_add_planes(state.s, state.nb)\n"
          "        return state._replace(nb=tagging.pending_buffer(nb))",
          "nb = tagging.pending_buffer(nb)\n"
          "        _add_planes(state.s, nb)\n"
          "        return state._replace(nb=nb)")


def _pending_never_waited(monkeypatch):
    from repro_torch.core import sdm_dsgd

    _edit(monkeypatch, sdm_dsgd, "distributed_advance",
          "_add_planes(state.s, state.nb)\n        return", "return")


@pytest.mark.parametrize("mutate,cid,kinds", [
    (_no_sanitize, "sdm-dsgd/ring4/fixedk_packed/sigma1",
     {"taint": ["tainted-collective"], "sensitivity": ["wire-sensitivity"],
      "calibration": ["missing-noise"]}),
    (_noise_drift, "sdm-dsgd/ring4/bernoulli/sigma1",
     {"calibration": ["noise-scale-mismatch"]}),
    (_no_wire_tag, "dsgd/ring4/-/sigma1", {"taint": ["untagged-wire"]}),
    (_sparsifier_draws_noise_key, "sdm-dsgd/ring4/bernoulli/sigma1",
     {"prng": ["key-reuse"] * wire_audit.STEPS}),
    (_noise_key_without_step, "sdm-dsgd/ring4/bernoulli/sigma1",
     {"prng": ["scan-invariant-key"]}),
    (_no_clip, "sdm-dsgd/ring4/fixedk_packed/sigma1",
     {"sensitivity": ["unclipped-sanitize"]}),
    (_pending_read_same_step, "sdm-dsgd/ring4/fixedk_packed+ov/sigma1",
     {"overlap": ["pending-same-round-read"] * wire_audit.STEPS}),
    (_pending_never_waited, "sdm-dsgd/ring4/fixedk_packed+ov/sigma1",
     {"wire": ["async-pair-imbalance"]}),
], ids=["no_sanitize", "noise_drift", "no_wire_tag", "key_reuse",
        "step_invariant_key", "no_clip", "pending_same_round_read",
        "pending_never_waited"])
def test_matrix_row_flags_a_seeded_regression(monkeypatch, mutate, cid,
                                              kinds):
    """The executor itself broken eight ways: the row fails with exactly
    the findings each break implies. ``pending_never_waited`` tags each
    exchange but never waits on it in the next step: only the last
    one's start is settled, so the other starts have no done."""
    mutate(monkeypatch)
    ac = next(a for a in wire_audit.MATRIX if a.id == cid)
    row = wire_audit.audit_config(ac, device="cpu")
    got = {k: _kinds(row, k) for k in ("prng",) + FINDING_KEYS if row[k]}
    assert row["status"] == "fail" and got == kinds


# ------------------------------------------------------------ the fixtures

N, DIM, BATCH = 4, 64, 8


def broken_step(x, a, b, *, transport, schedule, base_key, step,
                gamma=0.2, sigma=1.0, p=0.25):
    """Torch copy of ``tests/fixtures/broken_method.py``: the node key is
    consumed by TWO draws (noise and mask), and the differential ships
    WITHOUT the Gaussian mask."""
    r = torch.bmm(a, x[..., None])[..., 0] - b
    g = torch.bmm(a.transpose(1, 2), r[..., None])[..., 0] / a.shape[1]
    key = gossip.node_round_key(base_key, transport.me, step)
    noise = sigma * prng.normal(key, g.shape[1:])             # draw 1
    mask = prng.bernoulli(key, p, g.shape[1:])                # draw 2: BUG
    d = torch.where(mask, g, 0.0)
    nbr = gossip.exchange(schedule, d, transport, step=step)  # BUG: no mask
    return x - gamma * (g + 1e-6 * noise) + 0.0 * nbr


def miscalibrated_step(x, a, b, *, transport, schedule, base_key, step,
                       gamma=0.2, sigma=1.0, clip_c=1.0):
    """Torch copy of ``tests/fixtures/miscalibrated_method.py``: an
    unclipped residual rides after the clip, and the mask's std is
    1.3 sigma while the accountant charges sigma."""
    r = torch.bmm(a, x[..., None])[..., 0] - b
    g = torch.bmm(a.transpose(1, 2), r[..., None])[..., 0] / a.shape[1]
    key = gossip.node_round_key(base_key, transport.me, step)
    clipped = clipping.clip_tree(g, clip_c)
    pre_noise = clipped + 0.05 * g                            # BUG 1
    noise = (1.3 * sigma) * prng.normal(key, g.shape[1:])     # BUG 2
    d = tagging.sanitize(pre_noise + noise, label="miscalibrated",
                         node_dims=1)
    nbr = gossip.exchange(schedule, d, transport, step=step)
    return x - gamma * (g + 0.0 * nbr)


def _fixture_graph(step_fn):
    seq = gossip.ensure_sequence(
        gossip.schedule_from_topology(topology.ring(N)))
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(N, DIM)), dtype=torch.float32)
    a = torch.tensor(rng.normal(size=(N, BATCH, DIM)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(N, BATCH)), dtype=torch.float32)
    transport = StackTransport(N, "cpu")
    key = prng.PRNGKey(7)

    def fn(x, a, b):
        return step_fn(x, a, b, transport=transport, schedule=seq,
                       base_key=key, step=0)

    return graph_walk.trace(fn, x, a, b)


def test_broken_fixture_flags_exactly_the_seeded_bugs():
    gm = _fixture_graph(broken_step)
    taint = graph_taint.analyze_taint(gm, {1: "data", 2: "data"})
    rep = prng_lint.analyze_prng(gm)
    assert [f["kind"] for f in taint["findings"]] == ["tainted-collective"]
    assert [f["kind"] for f in rep["findings"]] == ["key-reuse"]
    events = rep["findings"][0]["events"]
    assert len(events) == 2
    assert all("test_torch_analysis.py" in e for e in events), events
    assert taint["n_sanitize_sites"] == 0
    assert rep["n_draws"] == 2


def test_miscalibrated_fixture_flags_exactly_the_seeded_bugs():
    gm = _fixture_graph(miscalibrated_step)
    src = {1: "data", 2: "data"}
    assert graph_taint.analyze_taint(gm, src)["findings"] == []
    assert prng_lint.analyze_prng(gm)["findings"] == []
    assert calibration.analyze_overlap(gm, overlap=False)["findings"] == []
    sens = sensitivity.analyze_sensitivity(gm, src, clip_c=1.0)
    calib = calibration.analyze_calibration(gm, expected_sigma=1.0,
                                            expected_clip=1.0)
    assert [f["kind"] for f in sens["findings"]] == ["unclipped-sanitize"]
    assert [f["kind"] for f in calib["findings"]] == \
        ["noise-scale-mismatch"]
    (mismatch,) = calib["findings"]
    assert mismatch["accountant_sigma"] == 1.0
    assert mismatch["graph_sigma"] == [pytest.approx(1.3, rel=1e-6)]
    (noise,) = calib["sanitize_sites"]
    assert noise["extracted_sigma"] == pytest.approx(1.3, rel=1e-6)
    (clip,) = sens["clip_sites"]
    assert clip["bound"] == 1.0
    (bound,) = sens["sanitize_sites"]
    assert bound["coord_bound"] is None and bound["numel"] == DIM


# ----------------------------------------------------------- the scenarios

def _graph(fn, *args):
    return graph_walk.trace(fn, *args)


K0 = prng.PRNGKey(0)


def _prng_clean_split(key):
    k = prng.split(key)
    return prng.normal(k[0], (4,)) + prng.normal(k[1], (4,))


def _prng_double_draw(key):
    return prng.normal(key, (4,)) + prng.uniform(key, (4,))


def _prng_draw_then_split(key):
    x = prng.normal(key, (4,))
    k1 = prng.split(key)[0]
    return x + prng.normal(k1, (4,))


def _prng_fold_children(key):
    return (prng.normal(prng.fold_in(key, 0), (4,))
            + prng.normal(prng.fold_in(key, 1), (4,)))


def _prng_reconstructed_fold(key):
    return (prng.normal(prng.fold_in(key, 3), (4,))
            + prng.normal(prng.fold_in(key, 3), (4,)))


def _prng_loop_invariant(key):
    c = torch.zeros(())
    for i in range(3):
        with tagging.iteration(i):
            c = c + prng.normal(key, ())
    return c


def _prng_loop_folded(key):
    c = torch.zeros(())
    for i in range(3):
        with tagging.iteration(i):
            c = c + prng.normal(prng.fold_in(key, i), ())
    return c


def _prng_batched_rows(key):
    keys = prng.fold_in(key, torch.arange(4))      # 4 keys, one per row
    return prng.normal(keys, (4,)) + prng.normal(keys[2], (4,))


@pytest.mark.parametrize("fn,kinds,n_draws", [
    (_prng_clean_split, [], 2),
    (_prng_double_draw, ["key-reuse"], 2),
    (_prng_draw_then_split, ["key-reuse"], 2),
    (_prng_fold_children, [], 2),
    (_prng_reconstructed_fold, ["key-reuse"], 2),
    (_prng_loop_invariant, ["scan-invariant-key"], 3),
    (_prng_loop_folded, [], 3),
    (_prng_batched_rows, ["key-reuse"], 2),
], ids=lambda v: v.__name__.lstrip("_") if callable(v) else None)
def test_prng_scenarios(fn, kinds, n_draws):
    rep = prng_lint.analyze_prng(_graph(fn, K0))
    assert [f["kind"] for f in rep["findings"]] == kinds, rep["findings"]
    assert rep["n_draws"] == n_draws


def test_prng_batched_key_rows_are_distinct_keys():
    def good(key):
        keys = prng.fold_in(key, torch.arange(4))
        return prng.normal(keys[:2], (4,)) + prng.normal(keys[2:], (4,))

    assert prng_lint.analyze_prng(_graph(good, K0))["findings"] == []


def test_prng_padded_draw_shape():
    def bad(key):
        return prng.normal(key, (4, 128))

    rep = prng_lint.analyze_prng(_graph(bad, K0), allowed_shapes=[(2, 128)])
    assert "padded-draw-shape" in [f["kind"] for f in rep["findings"]]

    def good(key):
        return prng.normal(key, (2, 128))

    assert prng_lint.analyze_prng(_graph(good, K0),
                                  allowed_shapes=[(2, 128)])["findings"] \
        == []


def test_taint_sanitize_clears_and_release_is_recorded():
    def step(x, data):
        g = tagging.sanitize(data * x)
        loss = tagging.declared_release((data ** 2).sum(), label="loss")
        return g.sum() + loss

    gm = _graph(step, torch.ones(4), torch.ones(4))
    rep = graph_taint.analyze_taint(gm, {1: "data"})
    assert rep["findings"] == []
    assert rep["n_sanitize_sites"] == 1
    assert [r["label"] for r in rep["releases"]] == ["loss"]


def test_taint_flags_a_send_that_bypasses_the_wire_tag():
    transport = StackTransport(4, "cpu")

    def step(x, data):
        clean = tagging.sanitize(data * x)
        return transport.ppermute(clean, [(0, 1), (1, 0)])

    gm = _graph(step, torch.ones(4, 3), torch.ones(4, 3))
    rep = graph_taint.analyze_taint(gm, {1: "data"})
    assert [f["kind"] for f in rep["findings"]] == ["untagged-wire"]


def test_graph_analysis_reads_sends_and_unwaited_starts():
    from repro_torch.launch import graph_analysis

    transport = StackTransport(4, "cpu")
    perm = [(0, 1), (1, 2), (2, 3), (3, 0)]

    def step(x):
        waited = transport.ppermute_start(tagging.wire_payload(x), perm)
        transport.ppermute_start(tagging.wire_payload(x.to(torch.uint8)),
                                 perm)                # never waited on
        y = transport.ppermute(tagging.wire_payload(x[:, :3]), perm)
        return waited.wait().sum() + y.sum() + transport.pmean(x).sum()

    gm = _graph(step, torch.ones(4, 8))
    assert graph_analysis.collective_permute_count(gm) == 3
    assert [p["bits"] for p in graph_analysis.permute_payloads(gm)] == \
        [8 * 32, 8 * 8, 3 * 32]
    assert graph_analysis.permute_payloads(gm)[1]["elems"] == {"u8": 8}
    pairs = graph_analysis.async_collective_pairs(gm)["collective-permute"]
    assert (pairs["sync"], pairs["start"], pairs["done"]) == (1, 2, 1)
    assert len(pairs["unmatched"]) == 1
    assert graph_analysis.collective_bytes(gm) == {
        "collective-permute": 32 + 8 + 12, "all-reduce": 32,
        "total": 32 + 8 + 12 + 32}


def test_expected_permutes_contract():
    ring = gossip.ensure_sequence(
        gossip.schedule_from_topology(topology.ring(4)))
    r = ring.schedules[0].n_rounds
    assert wire_audit.expected_permutes("sdm-dsgd", "bernoulli", ring) == r
    assert wire_audit.expected_permutes("sdm-dsgd", "qsgd:4", ring) == 2 * r
    assert wire_audit.expected_permutes("allreduce", "-", ring) == 0
    assert wire_audit.expected_permutes("gradient-push", "fixedk", ring) \
        == 3 * r


def test_sensitivity_clean_clip_noise_sanitize():
    def step(x, data, key):
        g = clipping.clip_tree(data * x, 0.5)
        g = g + 0.5 * prng.normal(key, g.shape)
        return tagging.wire_payload(tagging.sanitize(g))

    gm = _graph(step, torch.ones(4), torch.ones(4), K0)
    rep = sensitivity.analyze_sensitivity(gm, {1: "data"}, clip_c=0.5)
    assert rep["findings"] == []
    (site,) = rep["sanitize_sites"]
    assert site["coord_bound"] == pytest.approx(0.5)
    assert site["l2_bound"] == pytest.approx(0.5 * 2.0)
    assert rep["wire_coord_bound"] == 0.0


def test_sensitivity_flags_unclipped_and_exceeding():
    def unclipped(x, data, key):
        g = data * x
        return tagging.sanitize(g + prng.normal(key, g.shape))

    gm = _graph(unclipped, torch.ones(4), torch.ones(4), K0)
    rep = sensitivity.analyze_sensitivity(gm, {1: "data"}, clip_c=0.5)
    assert [f["kind"] for f in rep["findings"]] == ["unclipped-sanitize"]

    def exceeding(x, data, key):
        a = clipping.clip_tree(data * x, 0.5)
        b = clipping.clip_tree(data + x, 0.5)
        return tagging.sanitize(a + b + prng.normal(key, a.shape))

    gm = _graph(exceeding, torch.ones(4), torch.ones(4), K0)
    rep = sensitivity.analyze_sensitivity(gm, {1: "data"}, clip_c=0.5)
    assert [f["kind"] for f in rep["findings"]] == \
        ["sensitivity-exceeds-clip"]
    assert rep["findings"][0]["bound"] == pytest.approx(1.0)


def test_sensitivity_flags_clip_mismatch_and_wire():
    def step(x, data):
        g = clipping.clip_tree(data * x, 0.3)     # config says 0.5
        return tagging.wire_payload(g)            # pre-noise on the wire

    gm = _graph(step, torch.ones(4), torch.ones(4))
    rep = sensitivity.analyze_sensitivity(gm, {1: "data"}, clip_c=0.5)
    assert sorted(f["kind"] for f in rep["findings"]) == \
        ["clip-bound-mismatch", "wire-sensitivity"]
    assert rep["wire_coord_bound"] == pytest.approx(0.3)


def test_calibration_extracts_and_cross_checks_sigma():
    def noisy(x, key):
        return tagging.sanitize(x + 2.0 * prng.normal(key, x.shape))

    gm = _graph(noisy, torch.ones(4), K0)
    rep = calibration.analyze_calibration(gm, expected_sigma=2.0,
                                          expected_clip=None)
    assert rep["findings"] == []
    (site,) = rep["sanitize_sites"]
    assert site["extracted_sigma"] == pytest.approx(2.0, rel=1e-6)
    rep = calibration.analyze_calibration(gm, expected_sigma=1.0,
                                          expected_clip=None)
    assert [f["kind"] for f in rep["findings"]] == ["noise-scale-mismatch"]
    assert rep["findings"][0]["accountant_sigma"] == 1.0


def test_calibration_flags_missing_noise():
    gm = _graph(lambda x: tagging.sanitize(x * 3.0), torch.ones(4))
    rep = calibration.analyze_calibration(gm, expected_sigma=1.0,
                                          expected_clip=None)
    assert [f["kind"] for f in rep["findings"]] == ["noise-scale-unextracted"]
    gm = _graph(lambda x: x * 3.0, torch.ones(4))
    rep = calibration.analyze_calibration(gm, expected_sigma=1.0,
                                          expected_clip=None)
    assert [f["kind"] for f in rep["findings"]] == ["missing-noise"]


def _stale(x, nb):
    fresh = tagging.pending_buffer(x * 0.5)   # this step's exchange
    return x + nb, fresh                      # consumes LAST step's


def _same_round(x, nb):
    fresh = tagging.pending_buffer(x * 0.5)
    return x + fresh, fresh                   # staleness 0, not 1


def _dropped(x, nb):
    tagging.pending_buffer(x * 0.5)           # minted, never carried
    return x + nb, nb


def _self_dependent(x, nb):
    fresh = tagging.pending_buffer(nb * 0.5)  # depends on the OLD one
    return x + nb, fresh


def _untagged(x, nb):
    return x + nb, x * 0.5


def _overlap_report(body, overlap=True):
    def train(x, nb):
        for i in range(3):
            with tagging.iteration(i):
                x, nb = body(x, nb)
        return x, nb

    return calibration.analyze_overlap(
        _graph(train, torch.ones(4), torch.zeros(4)), overlap=overlap)


@pytest.mark.parametrize("body,overlap,kinds,verdict", [
    (_stale, True, [], "ok"),
    (_same_round, True, ["pending-same-round-read"], "hazard"),
    (_dropped, True, ["pending-not-carried"], "hazard"),
    (_self_dependent, True, ["pending-self-dependence"], "hazard"),
    (_untagged, True, ["overlap-untagged"], "hazard"),
    (_stale, False, ["pending-without-overlap"], "n/a"),
], ids=["stale", "same_round", "dropped", "self_dependent", "untagged",
        "without_overlap"])
def test_overlap_scenarios(body, overlap, kinds, verdict):
    rep = _overlap_report(body, overlap)
    assert sorted({f["kind"] for f in rep["findings"]}) == kinds, \
        rep["findings"]
    assert rep["verdict"] == verdict
    if body is _stale:
        assert rep["n_pending"] == 1


def test_qsgd_range_certificate():
    for bits, fused in ((2, True), (4, True), (4, False), (8, True)):
        cert = sensitivity.qsgd_range_certificate(
            bits, fused=fused, plane_elems=256)
        assert cert["findings"] == [], (bits, fused)
        assert cert["wire_dtype"] == "u8"
    cert = sensitivity.qsgd_range_certificate(8, fused=False,
                                              plane_elems=256)
    assert cert["findings"] == [] and cert["wire_dtype"] == "s8"
    assert cert["q_range"] == [-127.0, 127.0]
    cert = sensitivity.qsgd_range_certificate(4, fused=True,
                                              plane_elems=256)
    assert cert["payload_bytes"] == 256 // 2 + 4
    cert = sensitivity.qsgd_range_certificate(8, fused=False,
                                              plane_elems=256, levels=200)
    assert [f["kind"] for f in cert["findings"]] == [
        "int-range-overflow", "int-range-overflow"]


@settings(deadline=None, max_examples=25)
@given(st.integers(0, 10_000), st.sampled_from(
    ["bernoulli", "fixedk", "fixedk:4", "rows", "qsgd:4", "qsgd:8"]),
    st.floats(0.05, 2.0))
def test_coord_sensitivity_transfer_dominates_roundtrip(seed, spec, beta):
    from repro_torch.core import compressor

    comp = compressor.make(spec, p=0.25)
    shape = (8, 16)
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-beta, beta, size=shape),
                     dtype=torch.float32)
    out = comp.decompress(comp.compress(prng.PRNGKey(seed), x))
    bound = comp.coord_sensitivity_transfer(beta, shape)
    assert float(out.abs().max()) <= bound * (1 + 1e-5) + 1e-6


# ---------------------------------------------- the kernels' declared rules

def _fake_graph(fn, *args):
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(fn, tracing_mode="fake")(*args)


def _kernel_graphs(name):
    """(graph with the kernel's op node, graph of its plain version,
    example inputs)."""
    from repro_torch.kernels.wire_compress.ref import (
        fixedk_gather_pack_ref, qsgd_quantize_pack_ref)

    if name == "fixedk_gather_pack":
        db = torch.randn(4, 16, 2)
        idx = torch.randint(0, 16, (4, 4), dtype=torch.int32)
        scale = 16 / 4
        op = _fake_graph(lambda d, i: torch.ops.repro_torch.fixedk_gather_pack(
            d, i, scale), db, idx)
        plain = graph_walk.trace(
            lambda d, i: fixedk_gather_pack_ref(d, i, scale=scale), db, idx)
        return op, plain, 2
    xf, u = torch.randn(4, 32), torch.rand(4, 32)
    inv = torch.rand(4) + 0.5
    op = _fake_graph(lambda x, v, w: torch.ops.repro_torch.qsgd_pack(
        x, v, w, 4), xf, u, inv)
    plain = graph_walk.trace(
        lambda x, v, w: qsgd_quantize_pack_ref(x, v, w, bits=4), xf, u, inv)
    return op, plain, 3


@pytest.mark.parametrize("name", ["fixedk_gather_pack", "qsgd_pack"])
def test_kernel_rules_equal_the_walk_through_the_plain_version(name):
    op, plain, n_in = _kernel_graphs(name)
    assert any(graph_walk.op_of(nd) == f"repro_torch.{name}"
               for nd in op.graph.nodes)
    assert not any(graph_walk.op_of(nd).startswith("repro_torch.")
                   for nd in plain.graph.nodes)
    for seeds in ([0.5] + [0.0] * (n_in - 1), [0.0] * n_in,
                  [0.25] + [math.inf] * (n_in - 1)):
        got = [sensitivity._SensInterp().run(g, seeds) for g in (op, plain)]
        assert got[0] == got[1], (seeds, got)
    for seeds in ([(frozenset({"data"}), False)]
                  + [(frozenset(), False)] * (n_in - 1),
                  [(frozenset(), False)] * (n_in - 1)
                  + [(frozenset({"x"}), False)]):
        got = [graph_taint._TaintInterp().run(g, seeds) for g in (op, plain)]
        assert got[0] == got[1], (seeds, got)
    seeds = [frozenset({2.0})] + [frozenset()] * (n_in - 1)
    got = [calibration._NoiseInterp().run(g, seeds) for g in (op, plain)]
    assert got[0] == got[1], got


def test_main_path_runs_no_extra_op_outside_the_trace(monkeypatch):
    from repro_torch.bench import counting, perf_wire
    from repro_torch.core import method as method_mod

    def counts():
        meth = method_mod.get("sdm-dsgd")
        seq = gossip.ensure_sequence(
            gossip.schedule_from_topology(topology.ring(8)))
        cfg = perf_wire._config(meth, "fixedk_packed", True)
        transport = StackTransport(8, "cpu")
        ex = meth.make_distributed(seq, cfg, transport)
        rng = np.random.default_rng(0)
        stack = {k: torch.tensor(rng.normal(size=(8,) + s) * 0.1,
                                 dtype=torch.float32)
                 for k, s in perf_wire.PARAM_SHAPES.items()}
        key = prng.PRNGKey(0)
        grads = (lambda pp: ({k: v * 0.01 for k, v in pp.items()}, 0.0))
        state = ex.init(stack)
        state, _ = ex.step(state, grads, base_key=key)
        with counting.OpCount() as ops:
            ex.step(state, grads, base_key=key)
        return dict(ops.by_name)

    tagged = counts()
    for name in ("sanitize", "wire_payload", "declared_release",
                 "clip_bound", "pending_buffer"):
        monkeypatch.setattr(tagging, name, lambda t, **kw: t)
    monkeypatch.setattr(tagging, "collective", lambda x, *a, **kw: x)
    assert counts() == tagged
    assert not tagging.recording()


# ------------------------------------------------------------------ the CLI

def _cli(tmp_path, *argv):
    from repro_torch.analysis.__main__ import main

    out = tmp_path / "LINT_report_torch.json"
    rc = main(["--device", "cpu", "--out", str(out), *argv])
    return rc, json.loads(out.read_text())


def test_cli_quick_matrix_is_clean(tmp_path):
    rc, rep = _cli(tmp_path, "--quick")
    assert rc == 0 and rep["new_violations"] == []
    assert rep["summary"] == {"pass": 8, "fail": 0, "error": 0}
    assert {r["id"] for r in rep["configs"]} == set(wire_audit.QUICK_IDS)
    for row in rep["configs"]:
        if row["expect_taint"]:
            continue
        assert row["n_sanitize_sites"] == 1 and len(row["releases"]) == 1
        cert = row["certificate"]
        (site,) = cert["sanitize_bounds"]
        assert site["coord_bound"] == pytest.approx(
            cert["accountant"]["clip_c"])
        assert site["l2_bound"] == pytest.approx(cert["accountant"]["G"])
        assert cert["wire_coord_bound"] == 0.0
        assert cert["overlap"]["verdict"] == (
            "ok" if "+ov" in row["id"] else "n/a")


def test_cli_selectors_and_shards(tmp_path):
    rc, rep = _cli(tmp_path, "--only", "sdm-dsgd/ring4/fixedk_packed/sigma1",
                   "--pass", "sensitivity", "--pass", "calibration")
    assert rc == 0 and rep["passes"] == ["sensitivity", "calibration"]
    (row,) = rep["configs"]
    assert row["passes"] == ["calibration", "sensitivity"]
    assert row["certificate"]["sanitize_bounds"]
    assert row["certificate"]["extracted_noise"]
    assert row["taint"] == [] and row["n_sanitize_sites"] == 0
    assert row["certificate"]["overlap"] is None
    rc, rep = _cli(tmp_path, "--quick", "--shard", "1/2", "--pass", "wire")
    assert rc == 0 and rep["shard"] == "1/2"
    assert 0 < rep["n_configs"] < 8


def test_cli_baseline_suppresses_and_exit_code(tmp_path, monkeypatch):
    noisy = wire_audit.AuditConfig("sdm-dsgd", "ring4", "fixedk_packed",
                                   sigma=0.0)
    monkeypatch.setattr(wire_audit, "MATRIX", (noisy,))
    rc, rep = _cli(tmp_path, "--pass", "taint")
    fp = f"{noisy.id}|tainted-collective|ppermute"
    assert rc == 1 and rep["new_violations"] == [fp]
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"suppressions": [fp]}))
    rc, rep = _cli(tmp_path, "--pass", "taint", "--baseline", str(base))
    assert rc == 0 and rep["new_violations"] == []
    assert rep["configs"][0]["taint"][0]["suppressed"] is True
    bundled = pathlib.Path(wire_audit.__file__).with_name("baseline.json")
    assert json.loads(bundled.read_text())["suppressions"] == []


def test_cli_module_entry_points(tmp_path):
    from repro_torch.analysis.__main__ import main
    from repro_torch.launch import lint

    assert lint.main is main
    with pytest.raises((RuntimeError, SystemExit)):
        if torch.cuda.is_available():
            raise SystemExit("a card is present: cuda is the default")
        main(["--out", "", "--quick"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", "--device", "cpu",
         "--only", "dsgd/ring4/-/", "--out", str(tmp_path / "r.json")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SUMMARY pass=1 fail=0 error=0 new_violations=0" in out.stdout
