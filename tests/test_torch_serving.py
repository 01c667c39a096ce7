"""PyTorch port: the serving slice against the JAX package, on CPU.

Same numpy-seeded inputs through both packages in one test:
  * ``params_from_jax`` carries the JAX ``init_params`` tree over exactly,
  * layers, prefill / dense decode / paged decode logits match JAX in f32
    (LOGIT_ATOL: two packages' f32 matmuls and transcendentals differ in
    summation order and last-ulp rounding, ~1e-6 relative per op),
  * greedy outputs of the port's ServingEngine equal the JAX engine's on
    ragged requests, and the port's continuous engine equals its static
    engine served one request at a time,
  * checkpoint files and ingest (f32 and bf16 leaves, push-sum de-bias)
    agree with the JAX package,
  * PagedKVCache allocator invariants and no cross-slot leakage.
"""
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jax_configs
from repro.checkpoint import load_flat as jax_load_flat
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.serving import PagedKVCache as JaxPagedKVCache
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.ingest import ingest_checkpoint as jax_ingest
from repro_torch import configs
from repro_torch.checkpoint import latest_step, load_flat, save_checkpoint
from repro_torch.convert import params_from_jax
from repro_torch.models import layers, transformer
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.serving import (PagedKVCache, Request, ServingEngine,
                                 StaticServingEngine)
from repro_torch.serving.ingest import ingest_checkpoint

torch.set_num_threads(2)

ARCH = "gemma2-2b"
LOGIT_ATOL = 1e-4
ACT_ATOL = 2e-5


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def _models(seed=0):
    """(port cfg, JAX cfg, JAX params, port params carried over)."""
    jcfg = jax_configs.get_smoke_config(ARCH)
    jparams = jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = configs.get_smoke_config(ARCH)
    return cfg, jcfg, jparams, params_from_jax(_flat(jparams), cfg,
                                               device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# Config, registry, parameters.
# ---------------------------------------------------------------------------

def test_configs_match_jax_and_registry_refuses_unported():
    for get, jget in [(configs.get_config, jax_configs.get_config),
                      (configs.get_smoke_config,
                       jax_configs.get_smoke_config)]:
        a, b = get(ARCH), jget(ARCH)
        assert [getattr(a, f) for f in a.__dataclass_fields__ if
                f != "period"] == [getattr(b, f) for f in a.__dataclass_fields__
                                   if f != "period"]
        assert [(s.mixer, s.ffn, s.cross_attn) for s in a.period] == \
            [(s.mixer, s.ffn, s.cross_attn) for s in b.period]
        assert a.param_count() == b.param_count()
    for arch in ("phi3-medium-14b", "rwkv6-3b", "llama-3.2-vision-11b"):
        with pytest.raises(KeyError, match="not yet ported"):
            configs.get_config(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-model")


@pytest.mark.parametrize("period", [
    (LayerSpec(mixer="mamba"),), (LayerSpec(ffn="moe"),),
    (LayerSpec(cross_attn=True),)])
def test_unported_layers_raise(period):
    cfg = ModelConfig(name="x", family="dense", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64,
                      period=period)
    with pytest.raises(NotImplementedError):
        transformer.init_params(cfg, device="cpu")


def test_params_from_jax_carries_the_tree_over_exactly():
    cfg, jcfg, jparams, params = _models()
    flat = _flat(jparams)
    assert [k for k, _ in transformer.flat_specs(cfg)] == list(flat)
    for key, arr in flat.items():
        node = params
        for part in key.split("/"):
            node = node[part]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), arr)
    # the port's own init follows the same shapes and zeros/ones rule
    own = transformer.init_params(cfg, seed=1, device="cpu")
    shapes = transformer.param_shapes(cfg)
    for key, want in shapes.items():
        node = own
        for part in key.split("/"):
            node = node[part]
        assert tuple(node.shape) == want == flat[key].shape
        if "norm" in key:
            np.testing.assert_array_equal(node.numpy(), flat[key])
    bad = dict(flat)
    del bad["final_norm"]
    with pytest.raises(KeyError):
        params_from_jax(bad, cfg, device="cpu")
    bad = dict(flat, final_norm=np.ones(7, np.float32))
    with pytest.raises(ValueError):
        params_from_jax(bad, cfg, device="cpu")


def test_params_from_jax_reads_bf16_leaves():
    cfg, _, jparams, _ = _models()
    flat = _flat(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams))
    assert flat["embed"].dtype.kind == "V"          # ml_dtypes bfloat16
    params = params_from_jax(flat, cfg, device="cpu", dtype=torch.bfloat16)
    want = np.asarray(jparams["embed"].astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(params["embed"].float().numpy(), want)


# ---------------------------------------------------------------------------
# Layers and the model against JAX.
# ---------------------------------------------------------------------------

def test_elementary_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(5), np.arange(7, 12)]).astype(np.int32)
    w = rng.normal(size=(32,)).astype(np.float32)
    for frac in (1.0, 0.5):
        np.testing.assert_allclose(
            layers.rope(_t(x), _t(pos), 10_000.0, frac).numpy(),
            np.asarray(jax_layers.rope(jnp.asarray(x), jnp.asarray(pos),
                                       10_000.0, frac)), atol=ACT_ATOL)
    for plus_one in (False, True):
        np.testing.assert_allclose(
            layers.rms_norm(_t(x), _t(w), 1e-6, plus_one).numpy(),
            np.asarray(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w),
                                           1e-6, plus_one)), atol=ACT_ATOL)
    np.testing.assert_allclose(
        layers.softcap(_t(x * 80), 50.0).numpy(),
        np.asarray(jax_layers.softcap(jnp.asarray(x * 80), 50.0)),
        atol=ACT_ATOL)


@pytest.mark.parametrize("slot", ["0", "1"])   # local (window) / global
def test_attention_and_mlp_blocks_match_jax(slot):
    cfg, jcfg, jparams, params = _models()
    rng = np.random.default_rng(1)
    s = 24                                     # > the smoke window of 16
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    kind = cfg.period[int(slot)].mixer
    sp = transformer.period_params(params, slot, 0)
    jsp = jax.tree.map(lambda a: a[0], jparams["blocks"][slot])
    got, _ = layers.attention_apply(sp["attn"], cfg, _t(x),
                                    positions=_t(pos), layer_kind=kind)
    want, _ = jax_layers.attention_apply(jsp["attn"], jcfg, jnp.asarray(x),
                                         positions=jnp.asarray(pos),
                                         layer_kind=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ACT_ATOL)
    np.testing.assert_allclose(
        layers.mlp_apply(sp["mlp"], cfg, _t(x)).numpy(),
        np.asarray(jax_layers.mlp_apply(jsp["mlp"], jcfg, jnp.asarray(x))),
        atol=ACT_ATOL)


def _prompts(cfg, lens, seed=2):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks, np.asarray(lens, np.int32)


def test_prefill_and_dense_decode_logits_match_jax():
    cfg, jcfg, jparams, params = _models()
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


def test_paged_decode_logits_match_jax():
    """Prefill each prompt alone, scatter it into the paged pool, then
    one paged decode step with an empty (write-disabled) slot."""
    cfg, jcfg, jparams, params = _models()
    toks, lens = _prompts(cfg, (9, 21, 4), seed=3)
    B, max_seq, page = 4, 40, 4
    kv = PagedKVCache(cfg, max_batch=B, max_seq=max_seq, page_size=page,
                      device="cpu")
    jkv = JaxPagedKVCache(jcfg, max_batch=B, max_seq=max_seq, page_size=page)
    first = np.zeros(B, np.int32)
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
        first[slot] = int(jnp.argmax(jl[0]))
    offs = np.zeros(B, np.int32)
    offs[:3] = lens
    enabled = np.array([True, True, True, False])
    logits = transformer.decode_step_paged(params, cfg, _t(first), kv.pages,
                                           kv.tables(), _t(offs), _t(enabled))
    jlogits, jpages, _ = jax_tf.decode_step_paged(
        jparams, jcfg, jnp.asarray(first), jkv.pages, {}, jkv.tables(),
        jnp.asarray(offs), jnp.asarray(enabled))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL)
    for si, (kp, vp) in kv.pages.items():   # same in-place page writes
        np.testing.assert_allclose(kp[:, 1:].numpy(),
                                   np.asarray(jpages[si][0])[:, 1:],
                                   atol=ACT_ATOL)


# ---------------------------------------------------------------------------
# Engines.
# ---------------------------------------------------------------------------

LENS, BUDGETS = (3, 9, 5, 12, 7), (6, 3, 8, 5, 4)


def _requests(cls, cfg, lens=LENS, budgets=BUDGETS, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                max_new_tokens=m) for n, m in zip(lens, budgets)]


def test_greedy_serving_matches_jax_engine():
    cfg, jcfg, jparams, params = _models()
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


def test_continuous_matches_static_one_at_a_time():
    """The ragged pin: batched continuous serving (more requests than
    slots, a sub-dense pool) == each request served alone."""
    cfg, _, _, params = _models()
    want = []
    for r in _requests(Request, cfg):
        StaticServingEngine(cfg, params, max_batch=1, max_seq=64,
                            device="cpu").serve([r])
        want.append(r.output)
    static = StaticServingEngine(cfg, params, max_batch=5, max_seq=64,
                                 device="cpu").serve(_requests(Request, cfg))
    assert [r.output for r in static] == want
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=32, page_size=4,
                        n_pages=2 * (32 // 4), device="cpu")
    reqs = eng.serve(_requests(Request, cfg))
    assert [r.output for r in reqs] == want
    assert eng.last_stats.pages_peak <= 2 * (32 // 4)


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--ragged",
                "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


# ---------------------------------------------------------------------------
# Checkpoints and ingest.
# ---------------------------------------------------------------------------

def test_checkpoint_files_are_shared_with_jax(tmp_path):
    rng = np.random.default_rng(4)
    flat = {"x/a": rng.normal(size=(3, 4)).astype(np.float32),
            "step": np.asarray(7, np.int32)}
    path = save_checkpoint(str(tmp_path), 7, flat)
    assert os.path.basename(path) == "step_00000007.npz"
    assert latest_step(str(tmp_path)) == 7
    back = jax_load_flat(path)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    jax_save_checkpoint(str(tmp_path), 9, {"x": {"a": jnp.asarray(flat["x/a"])}})
    assert latest_step(str(tmp_path)) == 9
    np.testing.assert_array_equal(
        load_flat(str(tmp_path / "step_00000009.npz"))["x/a"], flat["x/a"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pushsum", [False, True])
def test_ingest_matches_jax(tmp_path, dtype, pushsum):
    """A stacked 3-replica trainer state written by the JAX
    save_checkpoint: same consensus params and same report."""
    cfg, jcfg, jparams, _ = _models()
    n = 3
    rng = np.random.default_rng(5)
    w = np.array([0.5, 1.0, 2.0], np.float32)
    x = jax.tree.map(
        lambda p: jnp.asarray(
            (np.asarray(p)[None] + 0.01 * rng.normal(size=(n,) + p.shape))
            * (w.reshape((n,) + (1,) * p.ndim) if pushsum else 1.0),
            getattr(jnp, dtype)), jparams)
    state = {"x": x, "step": jnp.asarray(3)}
    if pushsum:
        state["w"] = jnp.asarray(w)
    jax_save_checkpoint(str(tmp_path), 3, state)
    want, jrep = jax_ingest(str(tmp_path), jcfg)
    got, rep = ingest_checkpoint(str(tmp_path), cfg, device="cpu")
    for f in ("prefix", "n_nodes", "debiased", "worst_leaf"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert rep.debiased == pushsum and rep.n_nodes == n
    np.testing.assert_allclose(rep.max_disagreement, jrep.max_disagreement,
                               rtol=1e-12)
    np.testing.assert_allclose(rep.rms_disagreement, jrep.rms_disagreement,
                               rtol=1e-9)
    for key, arr in _flat(want).items():
        node = got
        for part in key.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node.numpy(), arr)


# ---------------------------------------------------------------------------
# Paged-cache allocator properties.
# ---------------------------------------------------------------------------

@settings(max_examples=12, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_paged_cache_alloc_free_invariants(seed):
    cfg = configs.get_smoke_config(ARCH)
    rng = random.Random(seed)
    kv = PagedKVCache(cfg, max_batch=4, max_seq=32, page_size=4,
                      n_pages=rng.choice([10, 16, 32]), device="cpu")
    live = {}
    for _ in range(30):
        admit = rng.random() < 0.6 or not live
        if admit and len(live) < kv.max_batch:
            slot = rng.choice([s for s in range(kv.max_batch)
                               if s not in live])
            n_tok = rng.randint(1, kv.max_seq)
            if not kv.can_admit(n_tok):
                with pytest.raises(ValueError):
                    kv.alloc(slot, n_tok)
                continue
            kv.alloc(slot, n_tok)
            live[slot] = n_tok
            with pytest.raises(ValueError):    # slot already holds pages
                kv.alloc(slot, 1)
        elif live:
            slot = rng.choice(list(live))
            kv.release(slot)
            del live[slot]
            assert kv.owned(slot) == ()
            assert not kv._tables[slot].any()
        # accounting: in-use == sum of per-slot charges, free+used == pool
        assert kv.pages_in_use() == sum(
            kv.pages_needed(n) for n in live.values())
        assert kv.pages_in_use() + len(kv._free) == kv.n_pages
        # ownership: page 0 never handed out, no page owned twice
        owned = [p for s in live for p in kv.owned(s)]
        assert 0 not in owned
        assert len(owned) == len(set(owned))
        for s, n in live.items():
            row = kv._tables[s]
            need = kv.pages_needed(n)
            assert set(row[:need]) == set(kv.owned(s))
            assert not row[need:].any()
    # free a slot first if all are live, so the over-max_seq alloc below
    # always has a free slot to be refused on
    if len(live) == kv.max_batch:
        slot = next(iter(live))
        kv.release(slot)
        del live[slot]
    free_slot = next(s for s in range(kv.max_batch) if s not in live)
    with pytest.raises(ValueError):
        kv.alloc(free_slot, kv.max_seq + 1)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_paged_cache_no_cross_slot_leakage_after_recycle(seed):
    """Each live slot reads back exactly the data written at its
    admission, however many other slots were admitted / retired (and
    their pages recycled) in between."""
    cfg = configs.get_smoke_config(ARCH)
    kv_h, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    rng = random.Random(seed)
    kv = PagedKVCache(cfg, max_batch=3, max_seq=16, page_size=4, n_pages=8,
                      device="cpu")
    live = {}          # slot -> (fill_value, length)
    fill = 0
    for _ in range(14):
        if (rng.random() < 0.6 or not live) and len(live) < kv.max_batch \
                and kv.can_admit(12):
            slot = rng.choice([s for s in range(kv.max_batch)
                               if s not in live])
            length = rng.randint(1, 12)
            kv.alloc(slot, length)
            fill += 1
            # padded prefill: the tail beyond `length` is junk that must
            # be routed to the trash page, never into owned pages
            Lp = length + rng.choice([0, 3])
            k = torch.full((cfg.n_periods, 1, Lp, kv_h, hd), float(fill))
            k[:, :, length:] = -99.0
            kv.write_prompt(slot, {si: (k, -k) for si in kv.pages}, length)
            live[slot] = (fill, length)
        elif live:
            slot = rng.choice(list(live))
            kv.release(slot)
            del live[slot]
        for slot, (val, length) in live.items():
            for gk, gv in kv.gather_dense(slot, length).values():
                assert torch.all(gk == val), f"slot {slot} k leaked"
                assert torch.all(gv == -val)
