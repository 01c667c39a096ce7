"""PyTorch port: the wire-plane snapshot and its gate against the JAX
package.

The JAX package's ``benchmarks/perf_wire.py`` emits its records live in
a subprocess this test starts itself (its ``--emit`` body, 8 faked CPU
devices set before jax imports). The subprocess also reads, from each
case's compiled HLO, how many ``lax.top_k`` draws XLA's CPU backend
lowered to a ``TopK`` custom call rather than to a ``sort``. The port's
``bench.perf_wire`` runs the same 9 cases on a ``StackTransport`` on the
CPU; per case:

* ``permutes_per_step``, ``schedule_rounds``, ``n_leaves``,
  ``plane_shapes`` and ``wire_bits_acc`` equal JAX's;
* ``wire_bits_sent`` (the transport's byte counter) equals JAX's
  ``wire_bits_hlo`` (the compiled permutes' payloads) in every case;
* ``sort_count`` counts every fixed-k index draw (``aten.sort``), while
  JAX's counts the HLO ``sort`` ops only: the two differ by exactly the
  draws that XLA lowered to ``TopK`` (``fixedk_packed`` and
  ``fixedk_rows`` draw twice a step, JAX shows one sort; gradient-push's
  one draw shows none).

``bench.check_perf`` must pass on the run against the ``"cpu"`` baseline
and fail on records that break its gates.
"""
import copy
import json
import os
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
MARK = "TOPK_CUSTOM_CALLS "


def _jax_main() -> None:
    """Subprocess body: the JAX script's ``--emit`` with a spy on the
    HLO it reads."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from repro.launch import hlo_analysis

    topk = []
    payloads = hlo_analysis.permute_payloads

    def spy(hlo):
        topk.append(hlo.count('custom_call_target="TopK"'))
        return payloads(hlo)

    hlo_analysis.permute_payloads = spy
    from benchmarks import perf_wire

    perf_wire._emit()
    print(MARK + json.dumps(topk))


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    _jax_main()
    sys.exit(0)

torch = pytest.importorskip("torch")

from repro_torch.bench import check_perf, perf_wire  # noqa: E402

SAME = ("permutes_per_step", "schedule_rounds", "n_leaves", "plane_shapes",
        "wire_bits_acc", "overlap")


@pytest.fixture(scope="module")
def jax_bench():
    pytest.importorskip("jax")
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--jax"],
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=f"{ROOT / 'src'}:{ROOT}"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    data = json.loads(next(ln for ln in lines
                           if ln.startswith("BENCH_PERF_JSON "))[16:])
    topk = json.loads(next(ln for ln in lines if ln.startswith(MARK))[
        len(MARK):])
    assert len(topk) == len(data["records"]) == len(perf_wire.CASES)
    return {r["case"]: dict(r, topk_custom_calls=t)
            for r, t in zip(data["records"], topk)}


@pytest.fixture(scope="module")
def port_bench(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_perf") / "BENCH_perf_torch.json"
    bench = perf_wire.run(device="cpu", out_path=str(out))
    assert json.loads(out.read_text()) == bench
    return bench


CASE_IDS = [perf_wire.case_id(*c) for c in perf_wire.CASES]


@pytest.mark.parametrize("case", CASE_IDS)
def test_case_matches_jax(jax_bench, port_bench, case):
    want = jax_bench[case]
    got = {r["case"]: r for r in port_bench["records"]}[case]
    for key in SAME:
        assert got[key] == want[key], (case, key)
    # the transport's byte counter reads what the compiled permutes carry
    assert got["wire_bits_sent"] == want["wire_bits_hlo"]
    # one aten.sort per fixed-k draw; XLA:CPU shows some draws as TopK
    assert got["sort_count"] == want["sort_count"] + \
        want["topk_custom_calls"]
    assert got["aten_ops"] >= got["launches"] > 0
    assert (got["overlap_efficiency"] > 0) == got["overlap"]


def test_counts_differ_only_where_xla_lowers_to_topk(jax_bench, port_bench):
    got = {r["case"]: r for r in port_bench["records"]}
    differ = {c for c in CASE_IDS
              if got[c]["sort_count"] != jax_bench[c]["sort_count"]}
    assert differ == {c for c in CASE_IDS
                      if jax_bench[c]["topk_custom_calls"]} == {
        "sdm-dsgd/ring/fixedk_packed", "sdm-dsgd-fused/ring/fixedk_rows",
        "gradient-push/dring/fixedk", "sdm-dsgd/ring/fixedk_packed+ov"}


def test_check_perf_passes_on_the_cpu_run(port_bench):
    assert port_bench["device"] == "cpu"
    assert check_perf.check(port_bench) == []


def test_check_perf_fails_what_it_must(port_bench):
    def broken(case, **kw):
        bad = copy.deepcopy(port_bench)
        for r in bad["records"]:
            if r["case"] == case:
                r.update(kw)
        return check_perf.check(bad)

    ring = "sdm-dsgd/ring/fixedk_packed"
    rec = {r["case"]: r for r in port_bench["records"]}
    msgs = broken(ring, permutes_per_step=rec[ring]["permutes_per_step"] + 1)
    assert msgs and all("permutes_per_step" in m for m in msgs)
    assert any("launches" in m for m in broken(
        ring, launches=rec[ring]["launches"] * 2))
    assert any("wire_bits_sent" in m for m in broken(
        ring, wire_bits_sent=rec[ring]["wire_bits_sent"] + 8))
    with open(perf_wire.BASELINE) as f:
        base = {r["case"]: r for r in json.load(f)["cpu"]["records"]}
    fused = "sdm-dsgd/ring/qsgdf:4"
    assert any("not below unfused" in m for m in broken(
        fused, launches=base["sdm-dsgd/ring/qsgd:4"]["launches"]))
    assert any("overlap_efficiency" in m for m in broken(
        "sdm-dsgd/ring/qsgdf:4+ov", overlap_efficiency=0.0))


def test_perf_wire_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        perf_wire.run()
