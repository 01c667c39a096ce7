"""PyTorch port: the three dense configs (phi3-medium-14b, chatglm3-6b,
qwen1.5-32b) against the JAX package, on CPU.

Each arch at its smoke config: the JAX ``init_params`` tree, with the
QKV biases (zeros at init) replaced by seeded normals so that qwen1.5's
``qkv_bias`` path does real work, goes through both packages
(``params_from_jax``). Forward logits, ``lm_loss``, prefill, dense and
paged decode logits and greedy serving are held to JAX at
``tests/test_torch_serving.py``'s JAX-derived tolerances. None of the
three sets a softcap, so the paged decode path runs with
``softcap=None``; chatglm3 rotates half of each head dim (``rope_fraction
0.5``) and qwen1.5 is MHA (one query head per KV head).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import (PagedKVCache, Request,  # noqa: E402
                                 ServingEngine)

torch.set_num_threads(2)

ARCHS = ["phi3-medium-14b", "chatglm3-6b", "qwen1.5-32b"]
# the MoE and recurrent arches (tests/test_torch_moe_recurrent.py)
MOE_RECURRENT = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b",
                 "jamba-v0.1-52b", "rwkv6-3b"]
# the encoder families (tests/test_torch_encoder_families.py)
ENCODER = ["whisper-large-v3", "llama-3.2-vision-11b"]
LOGIT_ATOL = 1e-4     # tests/test_torch_serving.py's JAX-derived bounds
ACT_ATOL = 2e-5


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def _models(arch, seed=0):
    """(port cfg, JAX cfg, JAX params, port params carried over); the
    QKV biases drawn from a seeded normal in both."""
    jcfg = jax_configs.get_smoke_config(arch)
    jparams = jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def bias(path, leaf):
        if str(path[-1].key) in ("bq", "bk", "bv"):
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1,
                               jnp.float32)
        return leaf

    jparams = jax.tree_util.tree_map_with_path(bias, jparams)
    cfg = configs.get_smoke_config(arch)
    return cfg, jcfg, jparams, params_from_jax(_flat(jparams), cfg,
                                               device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__
            if f != "period"}


# ---------------------------------------------------------------------------
# Configs and registry.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for get, jget in [(configs.get_config, jax_configs.get_config),
                      (configs.get_smoke_config,
                       jax_configs.get_smoke_config)]:
        a, b = get(arch), jget(arch)
        assert _fields(a) == _fields(b)
        assert [(s.mixer, s.ffn, s.cross_attn) for s in a.period] == \
            [(s.mixer, s.ffn, s.cross_attn) for s in b.period]
        assert a.param_count() == b.param_count()
    # the port's parameter tree has JAX's leaves and shapes at full width
    full = configs.get_config(arch)
    jfull = jax_configs.get_config(arch)
    shapes = jax.eval_shape(lambda: jax_tf.init_params(
        jax.random.PRNGKey(0), jfull))
    want = {k: tuple(v.shape) for k, v in _flat_shapes(shapes).items()}
    assert transformer.param_shapes(full) == want


def _flat_shapes(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in leaves}


def test_full_configs_match_assignment():
    """tests/test_arch_smoke.py::test_full_configs_match_assignment's
    assertions on the ported dense arches."""
    c = configs.get_config("qwen1.5-32b")
    assert (c.n_layers, c.d_model, c.n_heads, c.d_ff) == (64, 5120, 40, 27392)
    assert c.qkv_bias
    c = configs.get_config("phi3-medium-14b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads) == (40, 5120, 40,
                                                                10)
    c = configs.get_config("chatglm3-6b")
    assert (c.n_layers, c.d_model, c.n_kv_heads) == (28, 4096, 2)
    assert c.rope_fraction == 0.5
    c = configs.get_config("gemma2-2b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab_size) == (26, 2304, 8, 4, 9216, 256000)
    assert c.logit_softcap == 30.0 and c.sliding_window == 4096


def test_all_configs_covers_exactly_the_ported_arches():
    got = configs.all_configs()
    assert sorted(got) == sorted(ARCHS + MOE_RECURRENT + ENCODER
                                 + ["gemma2-2b"]) \
        == sorted(configs.ALIASES) == sorted(jax_configs.ALIASES)
    for arch, cfg in got.items():
        assert _fields(cfg) == _fields(jax_configs.get_config(arch))


@pytest.mark.parametrize("arch", ENCODER)
def test_other_arches_still_raise_not_yet_ported(arch):
    """Nothing raises any more: every architecture the JAX package
    registers resolves in the port, by public id and by module name, to
    the JAX config field for field."""
    assert sorted(configs.ALIASES) == sorted(jax_configs.ALIASES)
    assert sorted(configs.ARCH_IDS) == sorted(jax_configs.ARCH_IDS)
    for get, jget in [(configs.get_config, jax_configs.get_config),
                      (configs.get_smoke_config,
                       jax_configs.get_smoke_config)]:
        for name in (arch, configs.ALIASES[arch]):
            assert _fields(get(name)) == _fields(jget(name))


# ---------------------------------------------------------------------------
# The model against JAX.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    cfg, jcfg, jparams, params = _models(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    logits, aux = transformer.forward(params, cfg, _t(tokens))
    jlogits, jaux = jax_tf.forward(jparams, jcfg, jnp.asarray(tokens))
    assert logits.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL)
    loss = transformer.lm_loss(logits, _t(labels), cfg.vocab_size, aux)
    jloss = jax_tf.lm_loss(jlogits, jnp.asarray(labels), jcfg.vocab_size,
                           jaux)
    np.testing.assert_allclose(float(loss), float(jloss), atol=ACT_ATOL)


def _prompts(cfg, lens, seed=2):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks, np.asarray(lens, np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_dense_decode_match_jax(arch):
    cfg, jcfg, jparams, params = _models(arch)
    toks, lens = _prompts(cfg, (5, 19, 11))
    max_len = 32
    cache = transformer.init_cache(cfg, 3, max_len, torch.float32, "cpu")
    logits, cache = transformer.prefill(params, cfg, _t(toks), cache,
                                        last_index=_t(lens - 1))
    jcache = jax_tf.init_cache(jcfg, 3, max_len, jnp.float32)
    jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks),
                                     jcache, last_index=jnp.asarray(lens - 1))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL)
    for si, kv in cache.slots.items():      # the same cached keys/values
        np.testing.assert_allclose(kv.k.numpy(),
                                   np.asarray(jcache.slots[si].k),
                                   atol=ACT_ATOL)
    nxt = np.asarray(jnp.argmax(jlogits, -1), np.int32)
    for step in range(2):
        offs = lens + step
        logits, cache = transformer.decode_step(params, cfg, _t(nxt), cache,
                                                offsets=_t(offs))
        jlogits, jcache = jax_tf.decode_step(jparams, jcfg, jnp.asarray(nxt),
                                             jcache, offsets=jnp.asarray(offs))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(jlogits, -1), np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_jax(arch):
    """Prefill each prompt alone, scatter it into the paged pool, then
    two paged decode steps (softcap None) with an empty slot."""
    cfg, jcfg, jparams, params = _models(arch)
    assert cfg.attn_softcap is None and cfg.logit_softcap is None
    toks, lens = _prompts(cfg, (9, 21, 4), seed=3)
    B, max_seq, page = 4, 40, 4
    kv = PagedKVCache(cfg, max_batch=B, max_seq=max_seq, page_size=page,
                      device="cpu")
    jkv = JaxPagedKVCache(jcfg, max_batch=B, max_seq=max_seq, page_size=page)
    nxt = np.zeros(B, np.int32)
    for slot, (row, n) in enumerate(zip(toks, lens)):
        kv.alloc(slot, int(n) + 4)
        jkv.alloc(slot, int(n) + 4)
        p = row[None, :n]
        cache = transformer.init_cache(cfg, 1, int(n), torch.float32, "cpu")
        _, cache = transformer.prefill(params, cfg, _t(p), cache)
        kv.write_prompt(slot, {si: tuple(c) for si, c in cache.slots.items()},
                        int(n))
        jcache = jax_tf.init_cache(jcfg, 1, int(n), jnp.float32)
        jl, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(p), jcache)
        jkv.write_prompt(slot, {si: (c.k, c.v)
                                for si, c in jcache.slots.items()}, int(n))
        nxt[slot] = int(jnp.argmax(jl[0]))
    offs = np.zeros(B, np.int32)
    offs[:3] = lens
    enabled = np.array([True, True, True, False])
    jpages = jkv.pages
    for _ in range(2):
        logits = transformer.decode_step_paged(
            params, cfg, _t(nxt), kv.pages, kv.tables(), _t(offs),
            _t(enabled))
        jlogits, jpages, _ = jax_tf.decode_step_paged(
            jparams, jcfg, jnp.asarray(nxt), jpages, {}, jkv.tables(),
            jnp.asarray(offs), jnp.asarray(enabled))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(jlogits, -1), np.int32)
        offs = offs + enabled
    for si, (kp, vp) in kv.pages.items():   # same in-place page writes
        np.testing.assert_allclose(kp[:, 1:].numpy(),
                                   np.asarray(jpages[si][0])[:, 1:],
                                   atol=ACT_ATOL)
        np.testing.assert_allclose(vp[:, 1:].numpy(),
                                   np.asarray(jpages[si][1])[:, 1:],
                                   atol=ACT_ATOL)


LENS, BUDGETS = (3, 9, 5, 12, 7), (6, 3, 8, 5, 4)


def _requests(cls, cfg, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                max_new_tokens=m) for n, m in zip(LENS, BUDGETS)]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_matches_jax_engine(arch):
    cfg, jcfg, jparams, params = _models(arch)
    jreqs = _requests(JaxRequest, cfg)
    JaxServingEngine(jcfg, jparams, max_batch=3, max_seq=64,
                     page_size=4).serve(jreqs)
    eng = ServingEngine(cfg, params, max_batch=3, max_seq=64, page_size=4,
                        device="cpu")
    reqs = eng.serve(_requests(Request, cfg))
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    stats = eng.last_stats
    assert 0 < stats.pages_peak < stats.pages_dense_equiv
    assert stats.tokens == sum(BUDGETS)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_arch_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--ragged",
                "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
