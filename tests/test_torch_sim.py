"""PyTorch port: the edge-fleet simulator against the JAX package's.

``repro_torch.sim.simulate`` and ``repro.sim.simulate`` run the same
(seed, scenario) on the same test bed as ``tests/test_sim.py`` (6-node
ring, MLR 16 -> 3, 8 examples a node): the same event trace, losses
within 1e-4 relative, final parameters within 1e-4, wire bits and
simulated seconds exactly, the participation-amplified epsilon within
1e-9 relative. The stale-gossip helpers and
``gossip.sequence_from_active_sets`` are held to JAX's on the same
inputs, the fleet's draws are the same, ``launch.train --sim`` prints
JAX's round lines, and the port's own copies of the simulator tests run
on the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import PrivacyParams as JPrivacy  # noqa: E402
from repro.core import SDMConfig as JSDMConfig  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.data import (classification_dataset,  # noqa: E402
                        node_partitioned_batches)
from repro.models import vision_small as jvs  # noqa: E402
from repro.sim import simulate as jsimulate  # noqa: E402
from repro_torch import prng, tree as tree_mod  # noqa: E402
from repro_torch.core import PrivacyParams, SDMConfig  # noqa: E402
from repro_torch.core import gossip, method as method_mod, topology  # noqa: E402
from repro_torch.models import vision_small as tvs  # noqa: E402
from repro_torch.sim import (SCENARIOS, EventQueue, Fleet,  # noqa: E402
                             VirtualClock, parse_scenario, simulate)

ROOT = Path(__file__).resolve().parent.parent
N = 6
CFG = dict(p=0.4, theta=0.3, gamma=0.1, sigma=0.0)


def _data(seed):
    (xtr, ytr), _ = classification_dataset(16, 3, 600, 100, seed=seed)
    return node_partitioned_batches(xtr, ytr, N, 8, seed=seed)


def _run_jax(scenario, rounds=24, algorithm="sdm-dsgd", seed=0, **kw):
    p0 = jvs.mlr_init(jax.random.PRNGKey(seed), 16, 3)
    stack = jax.tree.map(
        lambda p: jnp.broadcast_to(p[None], (N,) + p.shape), p0)
    return jsimulate(topo=jtopology.ring(N), algorithm=algorithm,
                     sdm_cfg=JSDMConfig(**CFG), params_stack=stack,
                     grad_fn=jvs.make_stacked_grad_fn(jvs.mlr_apply),
                     batches=_data(seed), rounds=rounds, scenario=scenario,
                     seed=seed, **kw)


def _run(scenario, rounds=24, algorithm="sdm-dsgd", seed=0, **kw):
    p0 = tvs.mlr_init(prng.PRNGKey(seed), 16, 3)
    stack = tree_mod.tree_map(
        lambda p: p[None].expand((N,) + tuple(p.shape)).clone(), p0)
    return simulate(topo=topology.ring(N), algorithm=algorithm,
                    sdm_cfg=SDMConfig(**CFG), params_stack=stack,
                    grad_fn=tvs.make_stacked_grad_fn(tvs.mlr_apply),
                    batches=_data(seed), rounds=rounds, scenario=scenario,
                    seed=seed, device="cpu", **kw)


def _assert_same_run(got, want):
    assert got.trace_signature == want.trace_signature
    for field in ("rounds", "recompiles", "straggler_rounds",
                  "dropout_rounds", "sim_seconds", "time_to_target",
                  "rounds_to_target"):
        assert getattr(got, field) == getattr(want, field), field
    g, w = got.result, want.result
    assert g.comm_bits == w.comm_bits
    assert g.comm_elements == w.comm_elements
    assert g.sim_time_s == w.sim_time_s
    np.testing.assert_allclose(g.losses, w.losses, rtol=1e-4)
    np.testing.assert_allclose(g.epsilons, w.epsilons, rtol=1e-9)
    assert sorted(got.final_params) == sorted(want.final_params)
    for k, v in want.final_params.items():
        np.testing.assert_allclose(got.final_params[k].numpy(),
                                   np.asarray(v), atol=1e-4)


# ---- the simulator against JAX's ------------------------------------------

@pytest.mark.parametrize("scenario,seed", [
    ("no-fault", 0), ("straggler", 0), ("dropout", 0), ("churn", 0),
    ("dropout", 1), ("churn=0.2:3", 0)])
def test_simulate_matches_jax(scenario, seed):
    want = _run_jax(scenario, seed=seed)
    got = _run(scenario, seed=seed)
    _assert_same_run(got, want)
    if scenario.startswith("churn"):
        assert got.recompiles >= 1


def test_absolute_state_stragglers_match_jax():
    """dsgd has no differential buffer: its stragglers leave the round
    (the masked-subgraph path), in both packages alike."""
    want = _run_jax("straggler", algorithm="dsgd")
    got = _run("straggler", algorithm="dsgd")
    assert got.straggler_rounds > 0
    _assert_same_run(got, want)


def test_partial_participation_epsilon_matches_jax():
    kw = dict(G=5.0, m=100, tau=8 / 100, p=0.4, sigma=2.0)
    want = _run_jax("q=0.5", rounds=10, privacy=JPrivacy(**kw),
                    target_loss=1.05)
    got = _run("q=0.5", rounds=10, privacy=PrivacyParams(**kw),
               target_loss=1.05)
    _assert_same_run(got, want)
    assert len(got.result.epsilons) == 10
    full = _run("no-fault", rounds=10, privacy=PrivacyParams(**kw))
    # exactly the q^2 subsampled-RDP factor on the eps-part
    assert (got.result.epsilons[-1] - 0.5) == pytest.approx(
        0.25 * (full.result.epsilons[-1] - 0.5), rel=1e-9)


def test_fleet_draws_equal_jax():
    from repro.sim import Fleet as JFleet

    for spec in ("dropout", "churn=0.3:2", "straggler", "q=0.3"):
        a, b = Fleet(8, spec, seed=3), JFleet(8, spec, seed=3)
        np.testing.assert_array_equal(a.bandwidth, b.bandwidth)
        np.testing.assert_array_equal(a.stragglers, b.stragglers)
        for t in range(12):
            pa = a.sample_participants()
            np.testing.assert_array_equal(pa, b.sample_participants())
            np.testing.assert_array_equal(a.sample_dropouts(pa),
                                          b.sample_dropouts(pa))
            assert a.compute_time(t % 8) == b.compute_time(t % 8)
            assert a.churn_step(t) == b.churn_step(t)
        assert a.describe() == b.describe()


def test_sequence_from_active_sets_matches_jax():
    from repro.core import gossip as jgossip

    rng = np.random.default_rng(0)
    for base, jbase in ((topology.ring(N), jtopology.ring(N)),
                        (topology.erdos_renyi(8, 0.5, seed=1),
                         jtopology.erdos_renyi(8, 0.5, seed=1)),
                        (topology.directed_ring(N),
                         jtopology.directed_ring(N))):
        n = base.n_nodes
        sets = [np.sort(rng.choice(n, size=int(rng.integers(2, n + 1)),
                                   replace=False)) for _ in range(5)]
        got = gossip.sequence_from_active_sets(base, sets)
        want = jgossip.sequence_from_active_sets(jbase, sets)
        assert got.name == want.name and got.length == want.length
        np.testing.assert_array_equal(got.weights_stack(),
                                      want.weights_stack())
        assert gossip.needs_replicas(got) == jgossip.needs_replicas(want)


def test_stale_gossip_helpers_match_jax():
    from repro.core import method as jmethod
    from repro.core.sdm_dsgd import SDMState as JState

    from repro_torch.core.sdm_dsgd import SDMState

    rng = np.random.default_rng(0)
    arrs = {f: {"w": rng.normal(size=(N, 4, 3)).astype(np.float32),
                "b": rng.normal(size=(N, 3)).astype(np.float32)}
            for f in ("x", "s", "d", "x2", "s2", "d2")}
    mask = np.array([True, False, True, True, False, True])
    tt = {k: {kk: torch.from_numpy(v) for kk, v in d.items()}
          for k, d in arrs.items()}
    jt = {k: {kk: jnp.asarray(v) for kk, v in d.items()}
          for k, d in arrs.items()}
    tstate = SDMState(x=tt["x"], s=tt["s"], d=tt["d"], step=3)
    jstate = JState(x=jt["x"], s=jt["s"], d=jt["d"], step=jnp.int32(3))
    meth, jmeth = method_mod.get("sdm-dsgd"), jmethod.get("sdm-dsgd")
    assert method_mod.stale_capable(meth) == jmethod.stale_capable(jmeth)
    assert not method_mod.stale_capable(method_mod.get("dsgd"))
    with pytest.raises(ValueError, match="absolute state"):
        method_mod.withhold_differential(method_mod.get("dsgd"), tstate, mask)

    def same(a, b):
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))

    ts, tw = method_mod.withhold_differential(meth, tstate, mask)
    js, jw = jmethod.withhold_differential(jmeth, jstate, mask)
    same(ts.d, js.d)
    same(tw, jw)
    same(method_mod.defer_differential(meth, ts, tw).d,
         jmethod.defer_differential(jmeth, js, jw).d)
    other = SDMState(x=tt["x2"], s=tt["s2"], d=tt["d2"], step=2)
    jother = JState(x=jt["x2"], s=jt["s2"], d=jt["d2"], step=jnp.int32(2))
    sel = method_mod.select_node_rows(mask, tstate, other)
    jsel = jmethod.select_node_rows(mask, jstate, jother)
    for f in ("x", "s", "d"):
        same(getattr(sel, f), getattr(jsel, f))
    assert sel.step == 3 == int(jsel.step)


# ---- the launcher's --sim axis --------------------------------------------

def _round_lines(text):
    return re.findall(r"^round +(\d+) t_sim +(\S+)s loss (\S+) "
                      r"wire_bits (\d+)$", text, re.MULTILINE)


def test_launcher_sim_prints_jax_round_lines():
    """The JAX CLI (4 faked devices) and the port's CLI print the same
    simulated seconds and wire bits per round; from JAX's initial
    parameters the port's ``simulate_lm`` prints JAX's losses too."""
    from repro import configs as jconfigs
    from repro.models import transformer as jtf

    from repro_torch import configs
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import train as train_mod

    args = ["--arch", "gemma2-2b", "--smoke", "--mesh", "4", "--steps", "4",
            "--seq-len", "16", "--sim", "straggler"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jout = subprocess.run([sys.executable, "-m", "repro.launch.train", *args],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert jout.returncode == 0, jout.stderr[-3000:]
    tout = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert tout.returncode == 0, tout.stderr[-3000:]
    want, got = _round_lines(jout.stdout), _round_lines(tout.stdout)
    assert len(want) == len(got) == 4
    assert [(r, t, b) for r, t, _, b in got] == \
        [(r, t, b) for r, t, _, b in want]
    tail = r"^sim done: .*$"
    assert re.search(tail, tout.stdout, re.MULTILINE).group(0) == \
        re.search(tail, jout.stdout, re.MULTILINE).group(0)
    assert "stragglers=0 " not in tout.stdout        # withholding ran

    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jtf.init_params(jax.random.PRNGKey(0),
                                jconfigs.get_smoke_config("gemma2-2b"),
                                jnp.float32))[0]}
    cfg = configs.get_smoke_config("gemma2-2b")
    res = train_mod.simulate_lm(
        cfg, SDMConfig(p=0.2, theta=0.5, gamma=1e-2), "sdm-dsgd", 4,
        batch=8, seq_len=16, rounds=4, scenario="straggler", device="cpu",
        params=params_from_jax(flat, cfg, device="cpu"))
    np.testing.assert_allclose(res.result.losses,
                               [float(v) for _, _, v, _ in want],
                               rtol=1e-4, atol=5e-5)   # printed to 4 places


def test_launcher_sim_refuses_a_process_group_and_one_node():
    from repro_torch.launch import train as train_mod

    base = ["--arch", "gemma2-2b", "--smoke", "--steps", "1", "--device",
            "cpu", "--sim", "straggler"]
    with pytest.raises(SystemExit):
        train_mod.main(base + ["--init-method", "tcp://localhost:1"])
    with pytest.raises(SystemExit, match="2-node"):
        train_mod.main(base + ["--mesh", "1"])


# ---- the port's own copies of the simulator tests -------------------------

def test_clock_and_queue_semantics():
    clock = VirtualClock()
    clock.advance_to(2.0)
    with pytest.raises(ValueError, match="backwards"):
        clock.advance_to(1.0)
    q = EventQueue()
    q.push(1.0, "b")
    q.push(1.0, "a")
    q.push(0.5, "c")
    q.push(3.0, "late")
    out = VirtualClock().drain(q, until=2.0)
    assert [e.kind for e in out] == ["c", "b", "a"] and len(q) == 1


@pytest.mark.parametrize("scenario", ["straggler", "dropout", "churn"])
def test_same_seed_replays_bit_identically(scenario):
    r1, r2 = _run(scenario, rounds=16), _run(scenario, rounds=16)
    assert r1.trace_signature == r2.trace_signature
    for k in r1.final_params:
        assert torch.equal(r1.final_params[k], r2.final_params[k])
    assert r1.result.losses == r2.result.losses
    assert _run("dropout", rounds=16, seed=1).trace_signature != \
        _run("dropout", rounds=16, seed=0).trace_signature


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_every_scenario_trains_and_the_clock_lines_up(scenario):
    res = _run(scenario)
    r = res.result
    assert res.rounds == 24 and r.losses[-1] < r.losses[0]
    assert len(r.sim_time_s) == len(r.step_s) == 24
    assert all(b >= a for a, b in zip(r.sim_time_s, r.sim_time_s[1:]))
    assert res.sim_seconds == r.sim_time_s[-1]
    assert all(b >= a for a, b in zip(r.comm_bits, r.comm_bits[1:]))
    closes = [ev for ev in res.trace if ev.kind == "round-close"]
    assert [dict(ev.data)["t"] for ev in closes] == list(range(24))


def test_straggler_deadline_bounds_the_run():
    res = _run("straggler")
    assert res.straggler_rounds > 0
    deadline = SCENARIOS["straggler"].deadline
    assert res.sim_seconds <= res.rounds * deadline + 1e-9
    free = _run("straggle=0.25x6")         # same stragglers, no deadline
    assert res.result.comm_bits[-1] < free.result.comm_bits[-1]
    assert res.sim_seconds < free.sim_seconds


def test_churn_rebuilds_segments_and_still_trains():
    res = _run("churn=0.2:3", rounds=20)
    kinds = [ev.kind for ev in res.trace]
    assert res.recompiles >= 1 and "recompile" in kinds
    assert ("leave" in kinds) or ("join" in kinds)
    assert res.result.losses[-1] < res.result.losses[0]


def test_segment_cap_bounds_the_sequence_length():
    res = _run("dropout", rounds=9, max_segment=4)
    assert res.rounds == 9 and res.recompiles >= 2


def test_topology_spec_string_node_mismatch_and_default_device():
    p0 = tvs.mlr_init(prng.PRNGKey(0), 16, 3)
    stack = tree_mod.tree_map(
        lambda p: p[None].expand((N,) + tuple(p.shape)).clone(), p0)
    kw = dict(algorithm="sdm-dsgd", sdm_cfg=SDMConfig(**CFG),
              params_stack=stack,
              grad_fn=tvs.make_stacked_grad_fn(tvs.mlr_apply))
    res = simulate(topo="ring", batches=_data(0), rounds=4, device="cpu",
                   **kw)
    assert res.rounds == 4
    with pytest.raises(ValueError, match="nodes"):
        simulate(topo=topology.ring(4), batches=_data(0), rounds=2,
                 device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            simulate(topo="ring", batches=_data(0), rounds=1, **kw)
    assert parse_scenario("STRAGGLER") is SCENARIOS["straggler"]


def test_sim_edge_report(tmp_path, monkeypatch):
    """The benchmark's report at a cut round count: every (method,
    scenario) case, the JAX script's fields, its own file name."""
    from repro_torch.bench import sim_edge

    monkeypatch.setattr(sim_edge, "ROUNDS", 6)
    out = tmp_path / "sim.json"
    report = sim_edge.run(out_path=str(out), device="cpu")
    assert out.exists() and sim_edge.OUT_PATH == "BENCH_sim_torch.json"
    assert report["n_nodes"] == 8 and report["rounds"] == 6
    assert len(report["cases"]) == len(sim_edge.METHODS) * len(SCENARIOS)
    assert set(report["cases"][0]) == {
        "method", "scenario", "rounds", "sim_seconds", "target_loss",
        "time_to_target", "rounds_to_target", "wire_bits", "epsilon",
        "final_loss", "loss_gap_vs_no_fault", "straggler_rounds",
        "dropout_rounds", "recompiles", "wall_s"}
    assert all(c["rounds"] == 6 and np.isfinite(c["final_loss"])
               for c in report["cases"])
