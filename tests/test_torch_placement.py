"""PyTorch port: the LM launcher's placed gossip schedule, against JAX.

- ``gossip.sequence_by_name(..., placement=True)`` compiles the same
  schedule as the JAX package's: W (self and receive weights), every
  round's shift and permutation, the round count and the name, for the
  static specs at 4, 8 and 16 nodes, a directed ER graph and a
  time-varying matching sequence (one renumbering for every round).
- ``train.steps.gossip_schedule`` is that placed schedule, shared by the
  banner, ``init_distributed_state`` (s_0 from the placed W) and the
  step; the callers JAX compiles without placement (the trainer, the
  simulator, the wire gate) still get the graph as drawn.
- The JAX CLI on 8 faked CPU devices (``er:0.5``; ``der:0.5`` with
  gradient-push) against the port's ``launch.train.train`` from JAX's
  initial parameters: the 8 losses equal to the 4 places printed, and
  ``transport.permutes`` = steps x the banner's ``gossip_rounds``.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import gossip as jax_gossip  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import gossip, sdm_dsgd, wire_count  # noqa: E402
from repro_torch.core import transport as tr  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

SPECS = [(spec, n) for spec in ("ring", "dring", "star", "torus", "er:0.5",
                                "er:0.35") for n in (4, 8, 16)]
SPECS += [("der:0.5", 8), ("der:0.5", 16), ("matchings:4", 8),
          ("matchings:4", 16)]


def _schedule_fields(seq):
    """Every field of a ScheduleSequence, as plain Python."""
    return (seq.name, seq.n_nodes, [
        (s.name, s.n_nodes, s.self_weights,
         [(r.shift, r.perm, r.recv_weights) for r in s.rounds])
        for s in seq.schedules])


@pytest.mark.parametrize("spec,n", SPECS, ids=[f"{s}x{n}" for s, n in SPECS])
def test_placed_schedule_equals_jax(spec, n):
    sw = 1.0 / 3.0 if spec == "ring" else None
    want = jax_gossip.sequence_by_name(spec, n, self_weight=sw, seed=0,
                                       placement=True)
    got = gossip.sequence_by_name(spec, n, self_weight=sw, seed=0,
                                  placement=True)
    assert _schedule_fields(got) == _schedule_fields(want)
    assert got.n_rounds == want.n_rounds
    np.testing.assert_array_equal(got.weights_stack(), want.weights_stack())
    # and without placement both compile the graph as drawn
    assert _schedule_fields(gossip.sequence_by_name(
        spec, n, self_weight=sw, seed=0)) == _schedule_fields(
            jax_gossip.sequence_by_name(spec, n, self_weight=sw, seed=0))


def test_placement_changes_er8_and_the_launcher_uses_it():
    """er:0.5 on 8 nodes: placed, 6 rounds a step where the drawn graph
    takes 7. The launcher's memoized schedule is the placed one, as
    JAX's ``_compiled_schedule``; the trainer keeps the drawn graph."""
    drawn = gossip.sequence_by_name("er:0.5", 8)
    placed = gossip.sequence_by_name("er:0.5", 8, placement=True)
    assert (drawn.n_rounds, placed.n_rounds) == (7, 6)
    assert placed.name.endswith("_placed") and not drawn.name.endswith(
        "_placed")
    # one spectrum: placement permutes W symmetrically
    np.testing.assert_allclose(
        np.linalg.eigvalsh(placed.at(0).dense_weights()),
        np.linalg.eigvalsh(drawn.at(0).dense_weights()), atol=1e-12)

    tc = steps.DistributedTrainConfig(
        model=configs.get_smoke_config("gemma2-2b"),
        sdm=sdm_dsgd.SDMConfig(), topology="er:0.5", method="sdm-dsgd")
    seq = steps.gossip_schedule(tc, 8)
    assert seq is steps.gossip_schedule(tc, 8)      # memoized: one object
    assert _schedule_fields(seq) == _schedule_fields(
        jax_steps._compiled_schedule("er:0.5", 0, 1.0 / 3.0, 8))

    # s_0 = (1 - W_ii) x_0 with the placed W's self-weights
    params = {"w": torch.ones(3)}
    transport = tr.StackTransport(8, "cpu")
    meth, cfg = tc.resolved()
    state = meth.make_distributed(seq, cfg, transport).init(
        {"w": params["w"][None].expand(8, 3)})
    (s_plane,) = state.s
    w_ii = np.asarray(seq.at(0).self_weights)
    flat = s_plane.reshape(8, -1)[:, 0].numpy()
    np.testing.assert_allclose(flat, 1.0 - w_ii, rtol=1e-6)
    assert not np.allclose(w_ii, np.asarray(drawn.at(0).self_weights))


def _losses(text):
    return [float(v) for v in re.findall(r"^step +\d+ loss (\S+)", text,
                                         re.MULTILINE)]


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in leaves}


CLI_RUNS = [("sdm-dsgd", "er:0.5"), ("gradient-push", "der:0.5")]


@pytest.mark.parametrize("method,topology", CLI_RUNS,
                         ids=[t for _, t in CLI_RUNS])
def test_launcher_matches_the_jax_cli_on_8_nodes(method, topology):
    n, n_steps = 8, 8
    args = ["--arch", "gemma2-2b", "--smoke", "--mesh", str(n), "--steps",
            str(n_steps), "--topology", topology, "--method", method]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    jout = subprocess.run([sys.executable, "-m", "repro.launch.train", *args],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert jout.returncode == 0, jout.stderr[-3000:]
    want = _losses(jout.stdout)
    rounds = int(re.search(r"gossip_rounds=(\d+)", jout.stdout).group(1))
    name = re.search(r"topology=(\S+)", jout.stdout).group(1)
    assert len(want) == n_steps and name.endswith("_placed")

    cfg = configs.get_smoke_config("gemma2-2b")
    jparams = jax_tf.init_params(jax.random.PRNGKey(0),
                                 jax_configs.get_smoke_config("gemma2-2b"),
                                 jnp.float32)
    tc = steps.DistributedTrainConfig(
        model=cfg, sdm=sdm_dsgd.SDMConfig(p=0.2, theta=0.5, gamma=1e-2,
                                          sigma=0.0),
        topology=topology, method=method, param_dtype=torch.float32)
    seq = steps.gossip_schedule(tc, n)
    assert (seq.name, seq.n_rounds) == (name, rounds)
    transport = tr.StackTransport(n, "cpu")
    state = steps.init_distributed_state(
        tc, transport, params=params_from_jax(_flat(jparams), cfg,
                                              device="cpu"))
    run = train_mod.train(tc, transport, steps=n_steps, global_batch=2 * n,
                          seq_len=64, seed=0, state=state)
    assert [f"{v:.4f}" for v in run.losses] == [f"{v:.4f}" for v in want]
    meth, mcfg = tc.resolved()
    per_step = wire_count.expected_permutes(
        meth.name, wire_count.mode_of(meth.name, mcfg), seq)
    assert transport.permutes == n_steps * per_step
    if method == "sdm-dsgd":
        assert transport.permutes == n_steps * rounds == 48
