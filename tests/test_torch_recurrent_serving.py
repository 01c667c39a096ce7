"""PyTorch port: serving and training the MoE and recurrent families
(granite-moe-1b-a400m, qwen3-moe-30b-a3b, jamba-v0.1-52b, rwkv6-3b)
against the JAX package, on the CPU.

- Greedy ``ServingEngine`` outputs equal the JAX engine's on a ragged
  request set (smoke configs, JAX's parameters carried over).
- ``tests/test_serving_engine.py::test_ragged_recurrent_matches_one_at_a_time``
  ported, for rwkv6 and jamba: the static engine groups equal prompt
  lengths, the continuous engine prefills at the exact length; both equal
  one-at-a-time serving.
- A reference behaviour shared with the JAX package: jamba's mamba conv
  state after a prompt of 1 or 2 tokens (fewer than d_conv - 1) keeps 1
  row; the continuous engines broadcast it into the slot's rows and give
  the same tokens, and both static engines raise ``ValueError``.
- ``launch.serve`` runs each arch; ``launch.train --arch
  granite-moe-1b-a400m`` against the JAX CLI (4 faked devices): from the
  JAX CLI's initial parameters the port's step loop prints its losses.
- ``repro_torch.examples.{serve_lm,train_lm}`` run on the CPU.
"""
import math
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import StaticServingEngine as JaxStatic  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import (Request, ServingEngine,  # noqa: E402
                                 StaticServingEngine)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
         "rwkv6-3b"]


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def _models(arch, seed=0):
    jcfg = jax_configs.get_smoke_config(arch)
    jparams = jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = configs.get_smoke_config(arch)
    return cfg, jcfg, jparams, params_from_jax(_flat(jparams), cfg,
                                               device="cpu")


def _requests(cls, cfg, lens, budgets, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                max_new_tokens=m) for n, m in zip(lens, budgets)]


LENS, BUDGETS = (3, 9, 5, 12, 7), (6, 3, 8, 5, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_matches_jax_engine(arch):
    cfg, jcfg, jparams, params = _models(arch)
    jreqs = _requests(JaxRequest, cfg, LENS, BUDGETS)
    JaxServingEngine(jcfg, jparams, max_batch=3, max_seq=64,
                     page_size=4).serve(jreqs)
    eng = ServingEngine(cfg, params, max_batch=3, max_seq=64, page_size=4,
                        device="cpu")
    reqs = eng.serve(_requests(Request, cfg, LENS, BUDGETS))
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    stats = eng.last_stats
    assert stats.tokens == sum(BUDGETS) and stats.prefills == len(LENS)
    # rwkv6 has no attention slot: no page pools, but pages are charged
    assert 0 < stats.pages_peak < stats.pages_dense_equiv


def _one_at_a_time(cfg, params, requests, max_seq):
    outs = []
    for r in requests:
        r1 = Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens)
        StaticServingEngine(cfg, params, max_batch=1, max_seq=max_seq,
                            device="cpu").serve([r1])
        outs.append(r1.output)
    return outs


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_ragged_recurrent_matches_one_at_a_time(arch):
    """Recurrent mixers can't mask away right-padding (state pollution):
    the static engine groups equal lengths, the continuous engine
    prefills at exact length. Both must match sequential serving."""
    cfg, _, _, params = _models(arch)
    lens, budgets = (4, 7, 4, 9), (5, 3, 6, 4)
    want = _one_at_a_time(cfg, params,
                          _requests(Request, cfg, lens, budgets), max_seq=48)
    static = StaticServingEngine(cfg, params, max_batch=4, max_seq=48,
                                 device="cpu")
    for eng in (static, ServingEngine(cfg, params, max_batch=2, max_seq=48,
                                      page_size=8, device="cpu")):
        reqs = _requests(Request, cfg, lens, budgets)
        eng.serve(reqs)
        assert [r.output for r in reqs] == want, type(eng).__name__
    assert static.last_stats.prefills == 3      # lengths 4 (x2), 7, 9


@pytest.mark.parametrize("prompt", [[7], [7, 9]])
def test_jamba_short_prompt_behaviour_is_jax_s(prompt):
    """A prompt shorter than d_conv - 1 = 3 leaves a 1-row conv state
    (``mamba.py``'s ``u_raw[:, s - (d_conv - 1):]``). The continuous
    engines broadcast it into the slot's 3 rows and agree token for
    token; both static engines' decode steps refuse the short state."""
    cfg, jcfg, jparams, params = _models("jamba-v0.1-52b")
    jr = JaxRequest(prompt=list(prompt), max_new_tokens=4)
    JaxServingEngine(jcfg, jparams, max_batch=2, max_seq=16,
                     page_size=4).serve([jr])
    r = Request(prompt=list(prompt), max_new_tokens=4)
    ServingEngine(cfg, params, max_batch=2, max_seq=16, page_size=4,
                  device="cpu").serve([r])
    assert r.output == jr.output and len(r.output) == 4
    with pytest.raises(ValueError):
        JaxStatic(jcfg, jparams, max_batch=2, max_seq=16).serve(
            [JaxRequest(prompt=list(prompt), max_new_tokens=4)])
    with pytest.raises(ValueError, match="d_conv - 1"):
        StaticServingEngine(cfg, params, max_batch=2, max_seq=16,
                            device="cpu").serve(
            [Request(prompt=list(prompt), max_new_tokens=4)])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_arch_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--ragged",
                "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


# ---------------------------------------------------------------------------
# launch.train on an MoE tree.
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "granite-moe-1b-a400m", "--smoke", "--mesh", "4",
              "--steps", "2"]


def _losses(text):
    return [float(v) for v in re.findall(r"^step +\d+ loss (\S+)", text,
                                         re.MULTILINE)]


def test_launch_train_granite_moe_matches_the_jax_cli():
    """The JAX CLI on 4 faked devices prints its losses; the port's step
    loop from the same initial parameters (JAX's ``init_params`` at the
    CLI's seed), batch, sequence length and method config prints the same
    to the 4 places printed, with the ppermute calls ``wire_count``
    expects over the expert-stacked plane. The port's own CLI runs the
    same flags on the CPU (its seeded init differs from JAX's)."""
    from repro_torch.core import sdm_dsgd, transport as tr, wire_count
    from repro_torch.launch import train as train_mod
    from repro_torch.train import steps

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jout = subprocess.run([sys.executable, "-m", "repro.launch.train",
                           *TRAIN_ARGS], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert jout.returncode == 0, jout.stderr[-3000:]
    want = _losses(jout.stdout)
    assert len(want) == 2

    cfg = configs.get_smoke_config("granite-moe-1b-a400m")
    jparams = jax_tf.init_params(jax.random.PRNGKey(0),
                                 jax_configs.get_smoke_config(
                                     "granite-moe-1b-a400m"), jnp.float32)
    tc = steps.DistributedTrainConfig(
        model=cfg, sdm=sdm_dsgd.SDMConfig(p=0.2, theta=0.5, gamma=1e-2,
                                          sigma=0.0),
        topology="ring", method="sdm-dsgd", param_dtype=torch.float32)
    transport = tr.StackTransport(4, "cpu")
    state = steps.init_distributed_state(
        tc, transport, params=params_from_jax(_flat(jparams), cfg,
                                              device="cpu"))
    run = train_mod.train(tc, transport, steps=2, global_batch=8,
                          seq_len=64, seed=0, state=state)
    np.testing.assert_allclose(run.losses, want, rtol=1e-4, atol=5e-5)
    meth, mcfg = tc.resolved()
    seq = steps.gossip_schedule(tc, 4)
    assert transport.permutes == 2 * wire_count.expected_permutes(
        meth.name, wire_count.mode_of(meth.name, mcfg), seq)

    tout = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert tout.returncode == 0, tout.stderr[-3000:]
    banner = r"nodes=4 method=sdm-dsgd p=0.2 theta=0.5 compressor=bernoulli"
    assert re.search(banner, jout.stdout) and re.search(banner, tout.stdout)
    got = _losses(tout.stdout)
    assert len(got) == 2 and all(math.isfinite(v) for v in got)


# ---------------------------------------------------------------------------
# The LM examples.
# ---------------------------------------------------------------------------

def test_serve_lm_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import serve_lm
    serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 8 requests / 64 new tokens" in out
    assert "all requests satisfied within their budgets" in out
    assert re.search(r"kv pages: peak \d+ vs dense-equivalent 48", out)


def test_train_lm_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import train_lm
    train_lm.main(["--device", "cpu", "--steps", "2", "--layers", "2",
                   "--d-model", "64", "--seq", "16", "--nodes", "2",
                   "--batch-per-node", "2"])
    out = capsys.readouterr().out
    assert "model: gemma2-100m" in out
    losses = _losses(out)
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert re.search(r"^loss \S+ -> \S+ in \d+s", out, re.MULTILINE)
