"""PyTorch port: serving and training the encoder families
(whisper-large-v3, llama-3.2-vision-11b) against the JAX package, on the
CPU.

- Both engines' greedy outputs and ``stats`` equal the JAX engines' on
  the same ragged requests and a context whose rows are all distinct,
  which pins the JAX engines' row semantics: the continuous engine gives
  every slot row 0 (encoded once a serve), the static engine gives a
  batch of b rows 0..b-1.
- A reference behaviour shared with the JAX package: both engines hand
  the ENCODED context to ``prefill``, which encodes it again, so
  whisper's first token comes from a doubly encoded context (its decode
  steps from a singly encoded one); the VLM's encode is the identity.
- A context in another dtype than the weights' raises ``ValueError``.
- ``launch.serve --smoke`` runs both archs; ``launch.train --smoke`` on
  2 nodes prints the JAX CLI's losses (2 faked devices; the port's step
  loop from the JAX CLI's initial parameters, same stub context), and
  the port's own CLI runs; ``--sim`` refuses both, with JAX's message.
"""
import inspect
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
from repro.launch import train as jax_launch_train  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import StaticServingEngine as JaxStatic  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import (Request, ServingEngine,  # noqa: E402
                                 StaticServingEngine)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ["whisper-large-v3", "llama-3.2-vision-11b"]
LENS, BUDGETS = (3, 9, 5, 12, 7), (6, 3, 8, 5, 4)


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


def _context(cfg, b, seed=7):
    """Seeded normal rows, all distinct, f32."""
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.n_image_tokens
    return np.random.default_rng(seed).normal(
        size=(b, n, cfg.d_model)).astype(np.float32)


def _requests(cls, cfg, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                max_new_tokens=m) for n, m in zip(LENS, BUDGETS)]


def _stats(s):
    return (s.tokens, s.prefills, s.decode_steps, s.pages_peak,
            s.pages_dense_equiv, list(s.step_tokens))


# ---------------------------------------------------------------------------
# The engines against JAX's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["continuous", "static"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_jax_engines_with_distinct_context_rows(arch, engine):
    """5 ragged requests over 3 slots and a 3-row context whose rows all
    differ: the continuous engine (row 0 for every slot) and the static
    engine (rows 0..b-1 for each batch: the second batch of 2 reuses rows
    0 and 1) give JAX's tokens and counts."""
    cfg, jcfg, jparams, params = _models(arch)
    ctx = _context(cfg, 3)
    if engine == "continuous":
        jeng = JaxServingEngine(jcfg, jparams, max_batch=3, max_seq=64,
                                page_size=4)
        eng = ServingEngine(cfg, params, max_batch=3, max_seq=64,
                            page_size=4, device="cpu")
    else:
        jeng = JaxStatic(jcfg, jparams, max_batch=3, max_seq=64)
        eng = StaticServingEngine(cfg, params, max_batch=3, max_seq=64,
                                  device="cpu")
    jreqs = jeng.serve(_requests(JaxRequest, cfg), context=jnp.asarray(ctx))
    reqs = eng.serve(_requests(Request, cfg), context=torch.tensor(ctx))
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert _stats(eng.last_stats) == _stats(jeng.last_stats)
    assert eng.last_stats.tokens == sum(BUDGETS)
    # the rows matter: serving with row 0 alone (continuous) or with the
    # rows in another order (static) changes what JAX returns too
    other = ctx[::-1].copy() if engine == "static" else ctx[[1, 0, 2]]
    jother = jeng.serve(_requests(JaxRequest, cfg),
                        context=jnp.asarray(other))
    got = eng.serve(_requests(Request, cfg), context=torch.tensor(other))
    assert [r.output for r in got] == [r.output for r in jother]
    assert [r.output for r in got] != [r.output for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_agree_on_equal_context_rows(arch):
    """With every context row equal (the launchers' case) the continuous
    engine, the static engine and one-at-a-time serving give the same
    tokens."""
    cfg, _, _, params = _models(arch)
    ctx = torch.tensor(np.repeat(_context(cfg, 1), 3, axis=0))
    cont = ServingEngine(cfg, params, max_batch=3, max_seq=64, page_size=4,
                         device="cpu").serve(_requests(Request, cfg),
                                             context=ctx)
    stat = StaticServingEngine(cfg, params, max_batch=3, max_seq=64,
                               device="cpu").serve(_requests(Request, cfg),
                                                   context=ctx)
    one = []
    for r in _requests(Request, cfg):
        StaticServingEngine(cfg, params, max_batch=1, max_seq=64,
                            device="cpu").serve([r], context=ctx)
        one.append(r.output)
    assert [r.output for r in cont] == [r.output for r in stat] == one


def test_prefill_double_encode_is_the_reference_behaviour():
    """whisper-smoke, PRNGKey(0), prompt [5, 6, 7, 8], a seeded normal
    context: ``prefill`` on the raw context gives token 26, on the encoded
    one 52 (JAX: the same two tokens), and both JAX engines and both port
    engines return 52 -- they pass the encoded context to prefill, which
    encodes it again. Shared with the JAX package, not a port fault."""
    cfg, jcfg, jparams, params = _models("whisper-large-v3")
    ctx = np.random.default_rng(0).normal(
        size=(1, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    prompt = [5, 6, 7, 8]
    toks = torch.tensor([prompt], dtype=torch.int32)
    firsts = []
    for c in (torch.tensor(ctx),
              transformer.encode_context(params, cfg, torch.tensor(ctx))):
        cache = transformer.init_cache(cfg, 1, 8, torch.float32, "cpu")
        logits, _ = transformer.prefill(params, cfg, toks, cache, context=c)
        firsts.append(int(torch.argmax(logits[0])))
    jfirsts = []
    for c in (jnp.asarray(ctx),
              jax_tf.encode_context(jparams, jcfg, jnp.asarray(ctx))):
        jcache = jax_tf.init_cache(jcfg, 1, 8, jnp.float32)
        jl, _ = jax_tf.prefill(jparams, jcfg, jnp.asarray([prompt]), jcache,
                               context=c)
        jfirsts.append(int(jnp.argmax(jl[0])))
    assert firsts == jfirsts == [26, 52]
    served = []
    for eng in (ServingEngine(cfg, params, max_batch=1, max_seq=16,
                              page_size=4, device="cpu"),
                StaticServingEngine(cfg, params, max_batch=1, max_seq=16,
                                    device="cpu")):
        r = Request(prompt=prompt, max_new_tokens=1)
        eng.serve([r], context=torch.tensor(ctx))
        served.append(r.output)
    for jeng in (JaxServingEngine(jcfg, jparams, max_batch=1, max_seq=16,
                                  page_size=4),
                 JaxStatic(jcfg, jparams, max_batch=1, max_seq=16)):
        r = JaxRequest(prompt=prompt, max_new_tokens=1)
        jeng.serve([r], context=jnp.asarray(ctx))
        served.append(r.output)
    assert served == [[52]] * 4


@pytest.mark.parametrize("engine", [ServingEngine, StaticServingEngine],
                         ids=["continuous", "static"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_refuse_a_context_of_another_dtype(arch, engine):
    cfg = configs.get_smoke_config(arch)
    params = transformer.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                     device="cpu")
    eng = engine(cfg, params, max_batch=2, max_seq=32,
                 dtype=torch.bfloat16, device="cpu")
    ctx = torch.tensor(_context(cfg, 2))
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        eng.serve([Request(prompt=[1, 2, 3], max_new_tokens=2)], context=ctx)
    reqs = eng.serve([Request(prompt=[1, 2, 3], max_new_tokens=2)],
                     context=ctx.to(torch.bfloat16))
    assert len(reqs[0].output) == 2


# ---------------------------------------------------------------------------
# The launchers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_arch_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--ragged",
                "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


def _losses(text):
    return [float(v) for v in re.findall(r"^step +\d+ loss (\S+)", text,
                                         re.MULTILINE)]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_matches_the_jax_cli(arch):
    """The JAX CLI on 2 faked devices trains the smoke config 2 steps on
    its stub context (0.01, f32) and prints its losses; the port's step
    loop from the same initial parameters (JAX's ``init_params`` at the
    CLI's seed), batch, sequence length, context and method config prints
    the same to the 4 places printed. The port's own CLI runs the same
    flags on the CPU (its seeded init differs from JAX's)."""
    from repro_torch.core import sdm_dsgd, transport as tr
    from repro_torch.launch import train as train_mod
    from repro_torch.train import steps

    args = ["--arch", arch, "--smoke", "--mesh", "2", "--steps", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    jout = subprocess.run([sys.executable, "-m", "repro.launch.train",
                           *args], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert jout.returncode == 0, jout.stderr[-3000:]
    want = _losses(jout.stdout)
    assert len(want) == 2

    cfg = configs.get_smoke_config(arch)
    jparams = jax_tf.init_params(jax.random.PRNGKey(0),
                                 jax_configs.get_smoke_config(arch),
                                 jnp.float32)
    tc = steps.DistributedTrainConfig(
        model=cfg, sdm=sdm_dsgd.SDMConfig(p=0.2, theta=0.5, gamma=1e-2,
                                          sigma=0.0),
        topology="ring", method="sdm-dsgd", param_dtype=torch.float32)
    transport = tr.StackTransport(2, "cpu")
    state = steps.init_distributed_state(
        tc, transport, params=params_from_jax(_flat(jparams), cfg,
                                              device="cpu"))
    run = train_mod.train(tc, transport, steps=2, global_batch=4,
                          seq_len=64, seed=0, state=state)
    np.testing.assert_allclose(run.losses, want, rtol=1e-4, atol=5e-5)

    tout = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert tout.returncode == 0, tout.stderr[-3000:]
    banner = rf"arch={cfg.name} .*nodes=2 method=sdm-dsgd"
    assert re.search(banner, jout.stdout) and re.search(banner, tout.stdout)
    got = _losses(tout.stdout)
    assert len(got) == 2 and all(math.isfinite(v) for v in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_splits_the_context_over_the_nodes(arch):
    """``train_step(state, tokens, labels, context)``: node i takes rows
    [i b/n, (i+1) b/n) of the context, as the JAX step's ``in_specs``
    shard it: each node's loss is its own slice's forward loss."""
    from repro_torch import tree as tree_mod
    from repro_torch.core import sdm_dsgd, transport as tr
    from repro_torch.train import steps

    cfg, _, _, params = _models(arch)
    tc = steps.DistributedTrainConfig(
        model=cfg, sdm=sdm_dsgd.SDMConfig(p=0.2, theta=0.5, gamma=1e-2,
                                          sigma=0.0),
        topology="ring", method="sdm-dsgd", param_dtype=torch.float32)
    transport = tr.StackTransport(2, "cpu")
    state = steps.init_distributed_state(tc, transport, params=params)
    rng = np.random.default_rng(4)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 12)),
                          dtype=torch.int32)
    labels = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 12)),
                          dtype=torch.int32)
    ctx = torch.tensor(_context(cfg, 4))
    _, loss = steps.make_distributed_train(tc, transport)(
        state, tokens, labels, ctx)
    block = tree_mod.tree_map(lambda v: v[None].expand(
        (2,) + tuple(v.shape)), params)
    _, losses = steps.node_grads(cfg, block, tokens.reshape(2, 2, 12),
                                 labels.reshape(2, 2, 12),
                                 ctx.reshape((2, 2) + tuple(ctx.shape[1:])))
    with torch.no_grad():
        want = []
        for i in range(2):
            logits, aux = transformer.forward(
                params, cfg, tokens[2 * i:2 * i + 2],
                context=ctx[2 * i:2 * i + 2])
            want.append(float(transformer.lm_loss(
                logits, labels[2 * i:2 * i + 2], cfg.vocab_size, aux)))
    np.testing.assert_allclose(losses.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(loss), np.mean(want), rtol=0,
                               atol=1e-6)
    assert abs(want[0] - want[1]) > 1e-4     # the slices differ


@pytest.mark.parametrize("arch", ARCHS)
def test_sim_still_refuses_the_encoder_families(arch, capsys):
    """``--sim`` runs text models only, with the JAX launcher's message;
    ``simulate_lm`` refuses them too."""
    from repro_torch.core import sdm_dsgd
    from repro_torch.launch import train as train_mod

    assert train_mod.SIM_TEXT_ONLY in inspect.getsource(jax_launch_train)
    with pytest.raises(SystemExit, match=re.escape(train_mod.SIM_TEXT_ONLY)):
        train_mod.main(["--arch", arch, "--smoke", "--mesh", "2", "--steps",
                        "2", "--sim", "straggler", "--device", "cpu"])
    with pytest.raises(ValueError, match="text models only"):
        train_mod.simulate_lm(configs.get_smoke_config(arch),
                              sdm_dsgd.SDMConfig(), "sdm-dsgd", 2, batch=4,
                              seq_len=8, rounds=1, scenario=None,
                              device="cpu")
