"""PyTorch port: the serving snapshot and its gate against the JAX package.

``benchmarks/serve_bench.py`` runs live in a subprocess (its own
``__main__``, output to a temp file). The port's ``bench.serve_bench``
serves the same workload on the CPU with JAX's smoke parameters carried
across (``params_from_jax``); the deterministic fields (tokens, decode
steps, KV pages at peak and dense) must equal JAX's, and the port's gate
``bench.check_serve`` must pass on the run against the ``"cpu"``
baseline, and fail on records that break its conditions.

The gate's tok/s condition compares wall-clock serves: the median of
``serve_bench.RUNS`` timed serves per engine, interleaved (a stub engine
and clock here hold each record to its 5 runs and to the median). Under
a parallel test run on a shared host, the other processes' load can
still decide it. So the CPU run is held to every other condition of the
gate, and the tok/s condition to records that meet it and break it;
``chip_smoke.py`` phase 18 gates the whole of it on the card.
"""
import copy
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import check_serve, serve_bench  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("tokens", "decode_steps", "pages_peak", "pages_dense")


@pytest.fixture(scope="module")
def jax_bench(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("jax_serve") / "BENCH_serve.json"
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.serve_bench"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}",
                 JAX_PLATFORMS="cpu", BENCH_SERVE_OUT=str(out)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port_bench(tmp_path_factory):
    """The port's run on the CPU from JAX's smoke parameters (PRNGKey(0)),
    one intra-op thread: the smoke widths gain nothing from more."""
    import jax

    from repro import configs as jax_configs
    from repro.models import transformer as jax_tf
    from repro_torch import configs
    from repro_torch.convert import params_from_jax

    jcfg = jax_configs.get_smoke_config(serve_bench.ARCH)
    jparams = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    flat = {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in leaves}
    params = params_from_jax(flat, configs.get_smoke_config(serve_bench.ARCH),
                             device="cpu")
    out = tmp_path_factory.mktemp("port_serve") / "BENCH_serve_torch.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bench = serve_bench.run(device="cpu", params=params,
                                out_path=str(out))
    finally:
        torch.set_num_threads(threads)
    assert json.loads(out.read_text()) == bench
    return bench


def test_serve_bench_matches_jax(jax_bench, port_bench):
    assert port_bench["workload"] == jax_bench["workload"]
    want = {r["case"]: r for r in jax_bench["records"]}
    got = {r["case"]: r for r in port_bench["records"]}
    assert sorted(got) == sorted(want) == ["continuous", "static"]
    for case in got:
        for key in FIELDS:
            assert got[case].get(key) == want[case].get(key), (case, key)
        # the port's record adds its timed serves (``runs``)
        assert set(got[case]) == set(want[case]) | {"runs"}
        assert len(got[case]["runs"]) == serve_bench.RUNS
    # the workload's own shape: continuous retires and refills
    assert got["continuous"]["decode_steps"] < got["static"]["decode_steps"]
    assert got["continuous"]["pages_peak"] < got["continuous"]["pages_dense"]
    assert port_bench["device"] == "cpu"
    assert port_bench["decode_aten_ops"] > 0
    assert "decode_kernel_launches" not in port_bench


WALL_CLOCK = "continuous tok_s"     # the tok/s condition's message


def test_check_serve_passes_on_the_cpu_run(port_bench):
    rec = {r["case"]: r for r in port_bench["records"]}
    assert rec["static"]["tok_s"] > 0 and rec["continuous"]["tok_s"] > 0
    assert [m for m in check_serve.check(port_bench)
            if not m.startswith(WALL_CLOCK)] == []


def _with(bench, **continuous):
    """A copy of ``bench`` whose continuous record has ``continuous``'s
    fields, and tok/s equal to static's unless given."""
    out = copy.deepcopy(bench)
    rec = {r["case"]: r for r in out["records"]}
    rec["continuous"].update(dict(dict(tok_s=rec["static"]["tok_s"]),
                                  **continuous))
    return out


def test_check_serve_fails_what_it_must(port_bench):
    met = _with(port_bench)
    assert check_serve.check(met) == []
    static = {r["case"]: r for r in met["records"]}["static"]
    failed = check_serve.check(_with(port_bench,
                                     tok_s=static["tok_s"] - 0.1))
    assert len(failed) == 1 and failed[0].startswith(WALL_CLOCK)
    failed = check_serve.check(_with(port_bench,
                                     decode_steps=static["decode_steps"]))
    assert len(failed) == 1 and "decode_steps" in failed[0]
    dense = {r["case"]: r for r in met["records"]}["continuous"][
        "pages_dense"]
    failed = check_serve.check(_with(port_bench, pages_peak=dense))
    assert len(failed) == 1 and "pages_peak" in failed[0]

    with open(serve_bench.BASELINE) as f:
        base = json.load(f)["cpu"]["decode_aten_ops"]
    cap = int(base * (1 + check_serve.LAUNCH_TOL)) + check_serve.LAUNCH_SLACK
    assert check_serve.check(dict(met, decode_aten_ops=cap)) == []
    failed = check_serve.check(dict(met, decode_aten_ops=cap + 1))
    assert len(failed) == 1 and "decode_aten_ops" in failed[0]

    assert check_serve.check(dict(met, device="tpu")) == [
        f"no baseline for device 'tpu' in {serve_bench.BASELINE}"]


def test_engine_records_hold_five_runs_and_the_median_decides(monkeypatch):
    """Stub engines and a stub clock: static serves in 1 s every run,
    continuous in 0.5 s three runs of five and 10 s in the other two.
    The median (0.5 s) gives continuous the higher tok/s, where the mean
    (4.3 s) would not; the serves interleave static / continuous after
    one warm-up each."""
    from types import SimpleNamespace

    walls = {"static": [1.0] * 5, "continuous": [0.5, 10.0, 0.5, 10.0, 0.5]}
    calls, now = [], [0.0]

    class Engine:
        device = torch.device("cpu")

        def __init__(self, case):
            self.case, self.runs = case, 0

        def serve(self, requests):
            calls.append(self.case)
            if len(calls) > 2:          # after the warm-ups
                now[0] += walls[self.case][self.runs]
                self.runs += 1
            self.last_stats = SimpleNamespace(
                step_wall_s=[0.1, 0.2], step_tokens=[2, 1],
                ttft_s=[0.01 * self.runs], decode_steps=7,
                pages_dense_equiv=0, pages_peak=0)
            return [SimpleNamespace(output=[1] * 6) for _ in range(13)]

    monkeypatch.setattr(serve_bench.time, "monotonic", lambda: now[0])
    cfg = SimpleNamespace(vocab_size=32)
    recs = serve_bench._engine_records(
        [("static", Engine("static")), ("continuous", Engine("continuous"))],
        cfg)
    assert calls == ["static", "continuous"] * 6
    st, co = recs
    assert serve_bench.RUNS == 5
    assert [r["wall_s"] for r in st["runs"]] == walls["static"]
    assert [r["wall_s"] for r in co["runs"]] == walls["continuous"]
    assert st["tok_s"] == 78.0 and co["tok_s"] == 156.0
    assert co["ttft_p50_ms"] in (10.0, 30.0, 50.0)      # a 0.5 s run's
    bench = {"device": "cpu", "records": recs, "decode_aten_ops": 0}
    assert not [m for m in check_serve.check(bench)
                if m.startswith(WALL_CLOCK)]


def test_serve_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_bench.run()
