"""PyTorch port: the MoE and recurrent families (granite-moe-1b-a400m,
qwen3-moe-30b-a3b, jamba-v0.1-52b, rwkv6-3b) against the JAX package, on
the CPU.

Each arch at its smoke config: the JAX ``init_params`` tree goes through
both packages (``params_from_jax``), with the leaves that init fills with
constants redrawn from a seeded numpy generator so that their paths do
real work: mamba's ``conv_b`` / ``dt_bias`` and rwkv's ``decay_bias`` /
``bonus_u`` (zeros at init) as small normals, and rwkv's ``mix_*``
(0.5 at init, where swapping the lerp's ends would go unseen) as
uniforms. Forward logits, the MoE aux loss, ``lm_loss``, gradients,
prefill (KV caches and recurrent states), dense and paged decode are
held to JAX; ``moe_apply`` is held to JAX where capacity drops tokens.

Tolerances: ``tests/test_torch_dense_configs.py``'s logits 1e-4 and
activations / losses 2e-5, except where stated below.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.serving import PagedKVCache  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
         "rwkv6-3b"]
RECURRENT = ["jamba-v0.1-52b", "rwkv6-3b"]
LOGIT_ATOL = 1e-4     # tests/test_torch_dense_configs.py's bounds
ACT_ATOL = 2e-5
# jamba's recurrent states: the ssm state sums dt * B * u over the prompt
# (entries up to ~10 at the smoke config), and the conv / matmul inputs
# already differ by the two packages' matmul summation order (~4e-7
# relative), so the state is held at 2e-5 of its own scale
STATE_RTOL = 2e-5
# gradients: test_torch_lm_train.py's 1e-5 of each leaf's scale, but 1e-4
# for jamba: its f32 forward sits ~1.9e-5 from a float64 run of the same
# forward in BOTH packages (8 hybrid layers feed matmul-order rounding
# through softplus / exp into the scan), so the two f32 runs differ by up
# to ~2e-5 of a leaf's scale; a wrong term moves a gradient by its size
GRAD_RTOL = {"jamba-v0.1-52b": 1e-4}

_REDRAW_NORMAL = ("conv_b", "dt_bias", "decay_bias", "bonus_u")


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def _models(arch, seed=0):
    """(port cfg, JAX cfg, JAX params, port params carried over)."""
    jcfg = jax_configs.get_smoke_config(arch)
    jparams = jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = str(path[-1].key)
        if name in _REDRAW_NORMAL:
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1,
                               jnp.float32)
        if name.startswith("mix_"):
            return jnp.asarray(rng.uniform(size=leaf.shape), jnp.float32)
        return leaf

    jparams = jax.tree_util.tree_map_with_path(redraw, jparams)
    cfg = configs.get_smoke_config(arch)
    return cfg, jcfg, jparams, params_from_jax(_flat(jparams), cfg,
                                               device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__
            if f != "period"}


def _close(got, want, rtol, what):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * scale, err_msg=what)


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
    # the port's tree has JAX's leaves and shapes at full width (the
    # expert-stacked leaves (n_periods, e, d, f) included)
    full = configs.get_config(arch)
    shapes = jax.eval_shape(lambda: jax_tf.init_params(
        jax.random.PRNGKey(0), jax_configs.get_config(arch)))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want = {"/".join(str(p.key) for p in path): tuple(v.shape)
            for path, v in leaves}
    assert transformer.param_shapes(full) == want


def test_full_configs_match_assignment():
    """tests/test_arch_smoke.py's assertions on these four arches."""
    c = configs.get_config("qwen3-moe-30b-a3b")
    assert (c.n_layers, c.d_model, c.n_experts, c.top_k) == (48, 2048, 128, 8)
    c = configs.get_config("granite-moe-1b-a400m")
    assert (c.n_layers, c.d_model, c.n_experts, c.top_k) == (24, 1024, 32, 8)
    c = configs.get_config("jamba-v0.1-52b")
    assert (c.n_layers, c.n_periods, c.n_experts, c.top_k) == (32, 4, 16, 2)
    assert [s.mixer for s in c.period].count("attn") == 1
    assert c.capacity_factor == 1.25
    c = configs.get_config("rwkv6-3b")
    assert (c.n_layers, c.d_model, c.rwkv_n_heads) == (32, 2560, 40)
    assert not c.tie_embeddings


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_constant_leaves_match_jax(arch):
    """``init_params`` fills zeros / ones / halves as JAX's ``init_tree``
    does (rwkv's five ``mix_*`` vectors per block are 0.5); the normal
    draws have JAX's std."""
    cfg = configs.get_smoke_config(arch)
    params = tree_mod.flatten_with_paths(
        transformer.init_params(cfg, seed=0, device="cpu"))
    want = _flat(jax_tf.init_params(jax.random.PRNGKey(0),
                                    jax_configs.get_smoke_config(arch)))
    assert sorted(params) == sorted(want)
    specs = dict(transformer.flat_specs(cfg))
    for k, v in want.items():
        if specs[k].init == "normal":
            assert abs(float(params[k].std()) / float(v.std()) - 1) < 0.2, k
        else:
            assert np.array_equal(params[k].numpy(), v), k
    if arch == "rwkv6-3b":
        assert (params["blocks/0/time_mix/mix_g"] == 0.5).all()


# ---------------------------------------------------------------------------
# The model against JAX.
# ---------------------------------------------------------------------------

def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_loss_and_grads_match_jax(arch):
    cfg, jcfg, jparams, params = _models(arch)
    tokens, labels = _tokens(cfg, (2, 24), 1), _tokens(cfg, (2, 24), 2)

    def jloss(p):
        logits, aux = jax_tf.forward(p, jcfg, jnp.asarray(tokens))
        return jax_tf.lm_loss(logits, jnp.asarray(labels), jcfg.vocab_size,
                              aux), (logits, aux)

    (jl, (jlogits, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    leaves, struct = tree_mod.flatten(params)
    mine = [v.requires_grad_(True) for v in leaves]
    logits, aux = transformer.forward(tree_mod.unflatten(struct, mine), cfg,
                                      _t(tokens))
    loss = transformer.lm_loss(logits, _t(labels), cfg.vocab_size, aux)
    assert logits.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux),
                               atol=ACT_ATOL)
    if cfg.n_experts:
        assert float(jaux) > 0        # the aux term is really there
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=ACT_ATOL)

    grads = torch.autograd.grad(loss, mine)
    want = _flat(jg)
    got = tree_mod.flatten_with_paths(tree_mod.unflatten(struct, grads))
    assert sorted(want) == sorted(got)
    rtol = GRAD_RTOL.get(arch, 1e-5)
    for k in want:
        scale = max(float(np.max(np.abs(want[k]))), 1e-3)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=rtol * scale, err_msg=k)


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks, np.asarray(lens, np.int32)


def _check_slots(cfg, slots, jslots, what):
    """Attention slots' KV caches and recurrent slots' states."""
    for si, st in slots.items():
        jst = jslots[si]
        assert type(st).__name__ == type(jst).__name__
        for name, a, ja in zip(st._fields, st, jst):
            assert tuple(a.shape) == tuple(ja.shape), (si, name)
            _close(a.numpy(), ja, STATE_RTOL, f"{what} slot {si} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_dense_decode_match_jax(arch):
    """Prefill then two dense decode steps; recurrent models prefill
    equal lengths (their state would consume right-padding), the
    attention-only MoE models ragged ones."""
    cfg, jcfg, jparams, params = _models(arch)
    lens = (11, 11, 11) if arch in RECURRENT else (5, 19, 11)
    toks, lens = _prompts(cfg, lens, seed=2)
    max_len = 32
    cache = transformer.init_cache(cfg, 3, max_len, torch.float32, "cpu")
    logits, cache = transformer.prefill(params, cfg, _t(toks), cache,
                                        last_index=_t(lens - 1))
    jcache = jax_tf.init_cache(jcfg, 3, max_len, jnp.float32)
    jlogits, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(toks),
                                     jcache, last_index=jnp.asarray(lens - 1))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL)
    _check_slots(cfg, cache.slots, jcache.slots, "prefill")
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
    _check_slots(cfg, cache.slots, jcache.slots, "decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_matches_jax(arch):
    """Prefill each prompt alone at its exact length, scatter its KV into
    the paged pool and its recurrent state into its row, then two paged
    decode steps with an empty slot (its state advances too, and MoE
    capacity counts its row). rwkv6 has no attention slot: the pool has
    no pages, the tables are still charged."""
    cfg, jcfg, jparams, params = _models(arch)
    toks, lens = _prompts(cfg, (9, 21, 4), seed=3)
    B, max_seq, page = 4, 40, 4
    kv = PagedKVCache(cfg, max_batch=B, max_seq=max_seq, page_size=page,
                      device="cpu")
    jkv = JaxPagedKVCache(jcfg, max_batch=B, max_seq=max_seq, page_size=page)
    rec_slots = [str(i) for i, s in enumerate(cfg.period)
                 if s.mixer not in ("attn", "attn_local")]
    assert bool(kv.pages) == (arch != "rwkv6-3b")
    rec = {si: transformer.init_cache(cfg, B, 1, torch.float32, "cpu")
           .slots[si] for si in rec_slots}
    jrec = {si: jax_tf.init_cache(jcfg, B, 1, jnp.float32).slots[si]
            for si in rec_slots}
    nxt = np.zeros(B, np.int32)
    for slot, (row, n) in enumerate(zip(toks, lens)):
        kv.alloc(slot, int(n) + 4)
        jkv.alloc(slot, int(n) + 4)
        p = row[None, :n]
        cache = transformer.init_cache(cfg, 1, int(n), torch.float32, "cpu")
        _, cache = transformer.prefill(params, cfg, _t(p), cache)
        kv.write_prompt(slot, {si: tuple(cache.slots[si])
                               for si in kv.pages}, int(n))
        jcache = jax_tf.init_cache(jcfg, 1, int(n), jnp.float32)
        jl, jcache = jax_tf.prefill(jparams, jcfg, jnp.asarray(p), jcache)
        jkv.write_prompt(slot, {si: (jcache.slots[si].k, jcache.slots[si].v)
                                for si in jkv.pages}, int(n))
        for si in rec_slots:
            for dst, src in zip(rec[si], cache.slots[si]):
                dst[:, slot] = src[:, 0]
            jrec[si] = jax.tree.map(lambda a, u: a.at[:, slot].set(u[:, 0]),
                                    jrec[si], jcache.slots[si])
        nxt[slot] = int(jnp.argmax(jl[0]))
    assert kv.pages_in_use() == jkv.pages_in_use() > 0
    offs = np.zeros(B, np.int32)
    offs[:3] = lens
    enabled = np.array([True, True, True, False])
    jpages = jkv.pages
    for _ in range(2):
        logits = transformer.decode_step_paged(
            params, cfg, _t(nxt), kv.pages, kv.tables(), _t(offs),
            _t(enabled), rec=rec)
        jlogits, jpages, jrec = jax_tf.decode_step_paged(
            jparams, jcfg, jnp.asarray(nxt), jpages, jrec, jkv.tables(),
            jnp.asarray(offs), jnp.asarray(enabled))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGIT_ATOL)
        nxt = np.asarray(jnp.argmax(jlogits, -1), np.int32)
        offs = offs + enabled
    _check_slots(cfg, rec, jrec, "paged decode")
    for si, (kp, vp) in kv.pages.items():   # same in-place page writes
        np.testing.assert_allclose(kp[:, 1:].numpy(),
                                   np.asarray(jpages[si][0])[:, 1:],
                                   atol=ACT_ATOL)
        np.testing.assert_allclose(vp[:, 1:].numpy(),
                                   np.asarray(jpages[si][1])[:, 1:],
                                   atol=ACT_ATOL)


# ---------------------------------------------------------------------------
# MoE capacity and drops.
# ---------------------------------------------------------------------------

def _drops(cfg, probs: np.ndarray) -> int:
    """(token, k) assignments beyond their expert's capacity, from the
    router probabilities (lax.top_k's choice: ties to the lower index)."""
    t = probs.shape[0]
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.top_k]
    counts = np.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(counts - moe._capacity(cfg, t), 0).sum())


@pytest.mark.parametrize("router", ["seeded", "zeros"])
def test_moe_apply_drops_tokens_like_jax(router):
    """granite-moe's smoke widths at the published capacity_factor 1.25
    with more tokens than capacity. ``seeded``: the router skewed towards
    expert 0 so that it overflows; ``zeros``: every expert ties, so
    lax.top_k's lower-index rule sends every token to experts 0 and 1,
    which drop all but cap of them."""
    jcfg = dataclasses.replace(
        jax_configs.get_smoke_config("granite-moe-1b-a400m"),
        capacity_factor=1.25)
    cfg = dataclasses.replace(
        configs.get_smoke_config("granite-moe-1b-a400m"),
        capacity_factor=1.25)
    rng = np.random.default_rng(5)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"router": rng.normal(size=(d, e)) / np.sqrt(d),
         "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f),
         "norm": 1 + 0.1 * rng.normal(size=(d,))}
    x = rng.normal(size=(2, 40, d)).astype(np.float32)
    if router == "zeros":
        p["router"] = np.zeros((d, e))
    else:
        p["router"][:, 0] += 0.3 * x.reshape(-1, d).mean(0) / np.linalg.norm(
            x.reshape(-1, d).mean(0))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    out, aux = moe.moe_apply({k: _t(v) for k, v in p.items()}, cfg, _t(x))
    jout, jaux = jax_moe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ACT_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ACT_ATOL)

    from repro_torch.models.layers import rms_norm
    h = rms_norm(_t(x), _t(p["norm"]), cfg.norm_eps).reshape(-1, d)
    probs = torch.softmax(h @ _t(p["router"]), -1).numpy()
    t = x.shape[0] * x.shape[1]
    assert moe._capacity(cfg, t) == int(2 * t * 1.25 / e) < t
    assert _drops(cfg, probs) > 0
    if router == "zeros":
        assert _drops(cfg, probs) == 2 * (t - moe._capacity(cfg, t))


@pytest.mark.parametrize("n_tokens,want", [(1, 2), (8, 5), (80, 50),
                                           (1000, 625)])
def test_moe_capacity_is_jax_expression(n_tokens, want):
    """int(top_k * t * 1.25 / e), clamped to [top_k, t]; at 8 decode
    slots (jamba: top-2 of 16) an expert takes 2 tokens a step."""
    cfg = dataclasses.replace(configs.get_smoke_config("jamba-v0.1-52b"),
                              capacity_factor=1.25)
    assert moe._capacity(cfg, n_tokens) == \
        jax_moe._capacity(dataclasses.replace(
            jax_configs.get_smoke_config("jamba-v0.1-52b"),
            capacity_factor=1.25), n_tokens) == want
    full = configs.get_config("jamba-v0.1-52b")
    assert moe._capacity(full, 8) == 2


# ---------------------------------------------------------------------------
# Mamba's parallel scan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 3, 7, 8, 33])
def test_mamba_scan_equals_jax_associative_scan(s):
    """The port's odd/even recursion forms JAX's products in JAX's order:
    bit-equal to ``lax.associative_scan`` run op by op."""
    from repro_torch.models import mamba

    rng = np.random.default_rng(s)
    a = rng.uniform(0.3, 1.0, (2, s, 6, 4)).astype(np.float32)
    b = rng.normal(size=(2, s, 6, 4)).astype(np.float32)

    def combine(left, right):
        return right[0] * left[0], right[0] * left[1] + right[1]

    with jax.disable_jit():
        ja, jb = jax.lax.associative_scan(
            combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = mamba._associative_scan(_t(a), _t(b))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    # and it is the recurrence h_t = a_t h_{t-1} + b_t
    h = np.zeros_like(b[:, 0])
    for i in range(s):
        h = a[:, i] * h + b[:, i]
    np.testing.assert_allclose(tb[:, -1].numpy(), h, rtol=1e-5, atol=1e-6)


def test_mamba_short_prompt_state_keeps_jax_rows():
    """``u_raw[:, s - (d_conv - 1):]`` as written: 1 row after 1 or 2
    tokens, d_conv - 1 from 3 on, in both packages; the step refuses the
    short state."""
    from repro.models import mamba as jax_mamba
    from repro_torch.models import mamba

    cfg, jcfg, jparams, params = _models("jamba-v0.1-52b")
    sp = transformer.period_params(params, "0", 0)["mamba"]
    jsp = jax.tree.map(lambda v: v[0], jparams["blocks"]["0"]["mamba"])
    for s, rows in ((1, 1), (2, 1), (3, 3), (5, 3)):
        x = np.random.default_rng(s).normal(size=(1, s, cfg.d_model)) \
            .astype(np.float32)
        _, st = mamba.mamba_apply(sp, cfg, _t(x), return_state=True)
        _, jst = jax_mamba.mamba_apply(jsp, jcfg, jnp.asarray(x),
                                       return_state=True)
        assert st.conv.shape[1] == jst.conv.shape[1] == rows
        np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv),
                                   atol=ACT_ATOL)
    with pytest.raises(ValueError, match="d_conv - 1"):
        mamba.mamba_decode_step(sp, cfg, _t(x[:, :1]),
                                mamba.MambaState(conv=st.conv[:, :1],
                                                 ssm=st.ssm))
