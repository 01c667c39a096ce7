"""PyTorch port: the encoder families (whisper-large-v3, audio;
llama-3.2-vision-11b, vlm) against the JAX package, on the CPU.

Each arch at its smoke config: the JAX ``init_params`` tree goes through
both packages (``params_from_jax``). The context is a seeded *random*
normal (b, encoder_seq or n_image_tokens, d_model) with distinct rows,
not the launchers' constant 0.01, under which a transposed or
row-swapped context would go unseen. Whisper runs the encoder (non-causal
attention without positions, learned decoder positions, a cross
sub-block in every layer); the VLM passes the context through and
cross-attends in the first slot of each 5-layer period, with RoPE on its
self-attention only. Held to JAX: configs and ``param_count``, the flat
parameter keys and shapes (the cross block has no QKV bias, even under
``qkv_bias``), ``encode_context``, forward logits, ``lm_loss`` and
gradients (the encoder's and ``pos_embed``'s included), prefill with
right-padded ``last_index``, the dense decode step with per-row
``offsets`` and with the scalar ``cache.offset``, and the paged decode
step (JAX's ``use_flash=False`` path). Tolerances:
``tests/test_torch_dense_configs.py``'s logits 1e-4 and activations /
losses 2e-5; gradients 1e-5 of each leaf's scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import PagedKVCache  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["whisper-large-v3", "llama-3.2-vision-11b"]
LOGIT_ATOL = 1e-4     # tests/test_torch_dense_configs.py's bounds
ACT_ATOL = 2e-5
GRAD_RTOL = 1e-5      # of each leaf's scale (test_torch_lm_train.py)


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def _draw_biases(jparams, seed):
    """QKV biases (zeros at init) redrawn as seeded normals."""
    rng = np.random.default_rng(seed)

    def bias(path, leaf):
        if str(path[-1].key) in ("bq", "bk", "bv"):
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1,
                               jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(bias, jparams)


def _models(arch, seed=0, **replace):
    """(port cfg, JAX cfg, JAX params, port params carried over);
    ``replace`` edits both smoke configs alike."""
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(arch), **replace)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **replace)
    jparams = _draw_biases(jax_tf.init_params(jax.random.PRNGKey(seed), jcfg),
                           seed)
    return cfg, jcfg, jparams, params_from_jax(_flat(jparams), cfg,
                                               device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__
            if f != "period"}


def _context(cfg, b, seed=7):
    """A seeded normal context, distinct rows, f32."""
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.n_image_tokens
    return np.random.default_rng(seed).normal(
        size=(b, n, cfg.d_model)).astype(np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks, np.asarray(lens, np.int32)


# ---------------------------------------------------------------------------
# Configs and parameters.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_tree_match_jax(arch):
    for get, jget in [(configs.get_config, jax_configs.get_config),
                      (configs.get_smoke_config,
                       jax_configs.get_smoke_config)]:
        a, b = get(arch), jget(arch)
        assert _fields(a) == _fields(b)
        assert [(s.mixer, s.ffn, s.cross_attn) for s in a.period] == \
            [(s.mixer, s.ffn, s.cross_attn) for s in b.period]
        assert a.param_count() == b.param_count()
        assert a.has_encoder == b.has_encoder
    # the port's tree has JAX's leaves and shapes at full width (whisper's
    # 65,536-row pos_embed and 32-layer encoder stack included)
    full = configs.get_config(arch)
    shapes = jax.eval_shape(lambda: jax_tf.init_params(
        jax.random.PRNGKey(0), jax_configs.get_config(arch)))
    want = {k: tuple(v.shape) for k, v in _flat_shapes(shapes).items()}
    assert transformer.param_shapes(full) == want


def _flat_shapes(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in leaves}


def test_full_configs_match_assignment():
    """tests/test_arch_smoke.py's assertions on the two encoder arches."""
    c = configs.get_config("whisper-large-v3")
    assert (c.n_layers, c.n_encoder_layers, c.d_model, c.n_heads,
            c.d_ff) == (32, 32, 1280, 20, 5120)
    assert c.family == "audio" and c.pos_embedding == "learned"
    assert c.encoder_seq == 1500 and c.vocab_size == 51_866
    c = configs.get_config("llama-3.2-vision-11b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads) == (40, 4096, 32,
                                                                8)
    assert c.family == "vlm" and c.n_image_tokens == 1024
    assert sum(s.cross_attn for s in c.period) * c.n_periods == 8
    assert not c.has_encoder


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_block_carries_no_bias_under_qkv_bias(arch):
    """``attention_specs(cfg, cross=True)``: a qkv_bias variant of the
    smoke config gives the self-attention (and whisper's encoder) blocks
    bq / bk / bv and the cross block none, leaf for leaf as JAX; the
    forward with those biases drawn matches JAX."""
    cfg, jcfg, jparams, params = _models(arch, qkv_bias=True)
    keys = [k for k, _ in transformer.flat_specs(cfg)]
    assert keys == list(_flat(jparams))
    assert "blocks/0/attn/bq" in keys and "blocks/0/cross/wq" in keys
    assert not [k for k in keys if "/cross/b" in k]
    if cfg.has_encoder:
        assert "encoder/layers/attn/bv" in keys
    ctx = _context(cfg, 2)
    tokens = _tokens(cfg, (2, 10), 1)
    logits, _ = transformer.forward(params, cfg, _t(tokens),
                                    context=_t(ctx))
    jlogits, _ = jax_tf.forward(jparams, jcfg, jnp.asarray(tokens),
                                context=jnp.asarray(ctx))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_the_tree_over_exactly(arch):
    cfg, _, jparams, params = _models(arch)
    flat = _flat(jparams)
    got = tree_mod.flatten_with_paths(params)
    assert [k for k, _ in transformer.flat_specs(cfg)] == list(flat)
    assert sorted(got) == sorted(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert ("pos_embed" in got) == (cfg.pos_embedding == "learned")
    assert any(k.startswith("encoder/") for k in got) == cfg.has_encoder


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_constant_leaves_match_jax(arch):
    """``init_params`` fills the norms with ones as JAX does; the normal
    draws (``pos_embed`` at scale 0.02, the encoder's stacked layers,
    drawn one layer at a time) have JAX's std."""
    cfg = configs.get_smoke_config(arch)
    params = tree_mod.flatten_with_paths(
        transformer.init_params(cfg, seed=0, device="cpu"))
    want = _flat(jax_tf.init_params(jax.random.PRNGKey(0),
                                    jax_configs.get_smoke_config(arch)))
    assert sorted(params) == sorted(want)
    specs = dict(transformer.flat_specs(cfg))
    for k, v in want.items():
        assert tuple(params[k].shape) == v.shape, k
        if specs[k].init == "normal":
            assert abs(float(params[k].std()) / float(v.std()) - 1) < 0.2, k
        else:
            assert np.array_equal(params[k].numpy(), v), k
    if cfg.has_encoder:
        enc = params["encoder/layers/attn/wq"]
        assert not torch.equal(enc[0], enc[1])    # a draw per layer


# ---------------------------------------------------------------------------
# The model against JAX.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_encode_context_matches_jax(arch):
    cfg, jcfg, jparams, params = _models(arch)
    ctx = _context(cfg, 3)
    got = transformer.encode_context(params, cfg, _t(ctx))
    want = jax_tf.encode_context(jparams, jcfg, jnp.asarray(ctx))
    assert tuple(got.shape) == ctx.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ACT_ATOL)
    if cfg.has_encoder:
        assert not np.allclose(got.numpy(), ctx)
        # rows stay apart: the encoder mixes frames, never rows
        one = transformer.encode_context(params, cfg, _t(ctx[1:2]))
        np.testing.assert_allclose(one.numpy(), got[1:2].numpy(),
                                   atol=ACT_ATOL)
    else:
        assert np.array_equal(got.numpy(), ctx)
    assert transformer.encode_context(params, cfg, None) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    cfg, jcfg, jparams, params = _models(arch)
    tokens, labels = _tokens(cfg, (2, 24), 1), _tokens(cfg, (2, 24), 2)
    ctx = _context(cfg, 2)

    def jloss(p):
        logits, aux = jax_tf.forward(p, jcfg, jnp.asarray(tokens),
                                     context=jnp.asarray(ctx))
        return jax_tf.lm_loss(logits, jnp.asarray(labels), jcfg.vocab_size,
                              aux), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves, struct = tree_mod.flatten(params)
    mine = [v.requires_grad_(True) for v in leaves]
    logits, aux = transformer.forward(tree_mod.unflatten(struct, mine), cfg,
                                      _t(tokens), context=_t(ctx))
    loss = transformer.lm_loss(logits, _t(labels), cfg.vocab_size, aux)
    assert logits.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=ACT_ATOL)
    # the context changes the logits (cross-attention is really there)
    plain, _ = jax_tf.forward(jparams, jcfg, jnp.asarray(tokens))
    assert float(jnp.max(jnp.abs(plain - jlogits))) > 1e-3

    grads = torch.autograd.grad(loss, mine)
    want = _flat(jg)
    got = tree_mod.flatten_with_paths(tree_mod.unflatten(struct, grads))
    assert sorted(want) == sorted(got)
    for k in want:
        scale = max(float(np.max(np.abs(want[k]))), 1e-3)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)
    checked = [k for k in want if k.startswith("encoder/")
               or k == "pos_embed" or "/cross/" in k]
    assert checked and all(np.abs(want[k]).max() > 0 for k in checked
                           if k != "pos_embed")
    if cfg.pos_embedding == "learned":
        # rows past the sequence get no gradient, the first 24 do
        assert np.abs(want["pos_embed"][:24]).max() > 0
        assert not got["pos_embed"][24:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_remat_matches(arch):
    """``cfg.remat`` recomputes each period in the backward pass (the
    encoder is not rematted): the same loss and gradients."""
    cfg, _, _, params = _models(arch)
    tokens, labels = _tokens(cfg, (2, 12), 3), _tokens(cfg, (2, 12), 4)
    ctx = _t(_context(cfg, 2))
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        leaves, struct = tree_mod.flatten(params)
        mine = [v.detach().clone().requires_grad_(True) for v in leaves]
        logits, aux = transformer.forward(tree_mod.unflatten(struct, mine),
                                          c, _t(tokens), context=ctx)
        loss = transformer.lm_loss(logits, _t(labels), c.vocab_size, aux)
        out.append((loss.detach(), torch.autograd.grad(loss, mine)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_ragged_decode_match_jax(arch):
    """Right-padded prompts read at their own ``last_index``; then two
    dense decode steps with per-row ``offsets`` (learned positions at
    each row's own offset) and the context pre-encoded."""
    cfg, jcfg, jparams, params = _models(arch)
    toks, lens = _prompts(cfg, (5, 19, 11), seed=2)
    ctx = _context(cfg, 3)
    max_len = 32
    cache = transformer.init_cache(cfg, 3, max_len, torch.float32, "cpu")
    logits, cache = transformer.prefill(params, cfg, _t(toks), cache,
                                        context=_t(ctx),
                                        last_index=_t(lens - 1))
    jcache = jax_tf.init_cache(jcfg, 3, max_len, jnp.float32)
    jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks),
                                     jcache, context=jnp.asarray(ctx),
                                     last_index=jnp.asarray(lens - 1))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL)
    for si, kv in cache.slots.items():      # the same cached keys/values
        np.testing.assert_allclose(kv.k.numpy(),
                                   np.asarray(jcache.slots[si].k),
                                   atol=ACT_ATOL)
        np.testing.assert_allclose(kv.v.numpy(),
                                   np.asarray(jcache.slots[si].v),
                                   atol=ACT_ATOL)
    enc = transformer.encode_context(params, cfg, _t(ctx))
    jenc = jax_tf.encode_context(jparams, jcfg, jnp.asarray(ctx))
    nxt = np.asarray(jnp.argmax(jlogits, -1), np.int32)
    for step in range(2):
        offs = lens + step
        logits, cache = transformer.decode_step(params, cfg, _t(nxt), cache,
                                                context=enc,
                                                offsets=_t(offs))
        jlogits, jcache = jax_tf.decode_step(jparams, jcfg, jnp.asarray(nxt),
                                             jcache, context=jenc,
                                             offsets=jnp.asarray(offs))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(jlogits, -1), np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_scalar_offset_matches_jax(arch):
    """Equal-length prompts, then decode steps without ``offsets``:
    every row at the cache's scalar offset (its learned position row)."""
    cfg, jcfg, jparams, params = _models(arch)
    toks = _tokens(cfg, (2, 9), 5)
    ctx = _context(cfg, 2, seed=8)
    cache = transformer.init_cache(cfg, 2, 16, torch.float32, "cpu")
    logits, cache = transformer.prefill(params, cfg, _t(toks), cache,
                                        context=_t(ctx))
    jcache = jax_tf.init_cache(jcfg, 2, 16, jnp.float32)
    jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks), jcache,
                                     context=jnp.asarray(ctx))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL)
    assert cache.offset == int(jcache.offset) == 9
    enc = transformer.encode_context(params, cfg, _t(ctx))
    jenc = jax_tf.encode_context(jparams, jcfg, jnp.asarray(ctx))
    nxt = np.asarray(jnp.argmax(jlogits, -1), np.int32)
    for _ in range(3):
        logits, cache = transformer.decode_step(params, cfg, _t(nxt), cache,
                                                context=enc)
        jlogits, jcache = jax_tf.decode_step(jparams, jcfg, jnp.asarray(nxt),
                                             jcache, context=jenc)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(jlogits, -1), np.int32)
    assert cache.offset == int(jcache.offset) == 12


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_jax(arch):
    """Prefill each prompt alone (raw context row), scatter it into the
    paged pool, then two paged decode steps with an empty slot; the
    context pre-encoded, one distinct row per slot."""
    cfg, jcfg, jparams, params = _models(arch)
    toks, lens = _prompts(cfg, (9, 21, 4), seed=3)
    B, max_seq, page = 4, 40, 4
    ctx = _context(cfg, B, seed=9)
    kv = PagedKVCache(cfg, max_batch=B, max_seq=max_seq, page_size=page,
                      device="cpu")
    jkv = JaxPagedKVCache(jcfg, max_batch=B, max_seq=max_seq, page_size=page)
    nxt = np.zeros(B, np.int32)
    for slot, (row, n) in enumerate(zip(toks, lens)):
        kv.alloc(slot, int(n) + 4)
        jkv.alloc(slot, int(n) + 4)
        p = row[None, :n]
        c = ctx[slot:slot + 1]
        cache = transformer.init_cache(cfg, 1, int(n), torch.float32, "cpu")
        _, cache = transformer.prefill(params, cfg, _t(p), cache,
                                       context=_t(c))
        kv.write_prompt(slot, {si: tuple(cc) for si, cc in
                               cache.slots.items()}, int(n))
        jcache = jax_tf.init_cache(jcfg, 1, int(n), jnp.float32)
        jl, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(p), jcache,
                                    context=jnp.asarray(c))
        jkv.write_prompt(slot, {si: (cc.k, cc.v)
                                for si, cc in jcache.slots.items()}, int(n))
        nxt[slot] = int(jnp.argmax(jl[0]))
    enc = transformer.encode_context(params, cfg, _t(ctx))
    jenc = jax_tf.encode_context(jparams, jcfg, jnp.asarray(ctx))
    offs = np.zeros(B, np.int32)
    offs[:3] = lens
    enabled = np.array([True, True, True, False])
    jpages = jkv.pages
    for _ in range(2):
        logits = transformer.decode_step_paged(
            params, cfg, _t(nxt), kv.pages, kv.tables(), _t(offs),
            _t(enabled), context=enc)
        jlogits, jpages, _ = jax_tf.decode_step_paged(
            jparams, jcfg, jnp.asarray(nxt), jpages, {}, jkv.tables(),
            jnp.asarray(offs), jnp.asarray(enabled), context=jenc,
            use_flash=False)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_context_dtype_must_be_the_weights(arch):
    """JAX promotes an f32 context against bf16 weights; the port raises
    ``ValueError`` naming both dtypes instead of casting."""
    cfg = configs.get_smoke_config(arch)
    params = transformer.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                     device="cpu")
    ctx = torch.tensor(_context(cfg, 1))
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    for call in (lambda: transformer.encode_context(params, cfg, ctx),
                 lambda: transformer.forward(params, cfg, tokens,
                                             context=ctx)):
        with pytest.raises(ValueError, match="float32.*bfloat16"):
            call()
    logits, _ = transformer.forward(params, cfg, tokens,
                                    context=ctx.to(torch.bfloat16))
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits.float()).all()
