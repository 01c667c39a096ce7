"""PyTorch port: the serving steps over a ``model`` axis, against JAX.

- ``steps.make_prefill_fn`` / ``make_decode_fn`` on ``1x2``, ``1x4``,
  ``2x2`` and ``2x2`` with ``shard_cache_seq``, gemma2-2b's smoke
  config in f32, a 4-row prompt of 22 tokens into a 48-position cache
  and 4 teacher-forced decode steps, against the JAX package's functions
  jitted with its serving rules' shardings on the same mesh of 4 faked
  CPU devices (one subprocess this test starts for every case,
  XLA_FLAGS before jax imports; parameters carried over by
  ``convert.params_from_jax``). The prefill cache splits by KV heads at
  M = 2 and stays whole at M = 4 (2 KV heads); the decode cache splits by
  positions, so the offsets 22..25 cross a shard's boundary at 24 and the
  last shard lies beyond them at M = 4 (and under ``shard_cache_seq``,
  4 blocks of 12 over ("data", "model")). Logits within 1e-5 of their
  scale, the cache (unsharded) within 1e-5 of its scale: the
  tolerances of ``test_torch_lm_train.py``. The model-axis counters of
  each step equal ``model_axis.tp_serving_collectives``.
- A shard with no valid position (beyond the offset, or wholly outside
  the local layers' window) merges with weight 0, never a NaN: the
  flash-decoding attention against the plain one, f32 and bf16.
- ``convert.shard_cache`` / ``unshard_cache`` round trips and one
  shard's block; ``ShardModelAxis`` (the dry-run's one device) on
  ``meta`` only; the refusals: no CUDA, ragged offsets, other families,
  rule overrides the port's model code does not split.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

ARCH = "gemma2-2b"
BATCH, PROMPT, MAX_LEN, STEPS = 4, 22, 48, 4
CASES = {"1x2": ("1x2", False), "1x4": ("1x4", False),
         "2x2": ("2x2", False), "2x2_seq": ("2x2", True)}
SUBPROCESS_TIMEOUT = 300


def _flat(tree):
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "name",
                                                   getattr(p, "idx", p))))
                     for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def _inputs(vocab):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)
    dec = rng.integers(0, vocab, (STEPS, BATCH)).astype(np.int32)
    return tokens, dec


def _cache_arrays(cache, prefix):
    return {f"{prefix}/{slot}/{f}": np.asarray(t)
            for slot, kv in cache.slots.items()
            for f, t in zip(("k", "v"), kv)}


def _jax_main(out_path: str) -> None:
    """Every case's prefill and decode steps, JAX's serving functions
    jitted with the shardings of their rules on 4 faked CPU devices."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from repro import configs
    from repro.launch.mesh import make_mesh_by_name
    from repro.models import transformer
    from repro.sharding import tree_shardings
    from repro.train import steps

    cfg = configs.get_smoke_config(ARCH)
    params = transformer.init_params(jax.random.PRNGKey(1), cfg)
    out = {f"p/{k}": v for k, v in _flat(params).items()}
    tokens, dec = _inputs(cfg.vocab_size)
    cache_sds = jax.eval_shape(lambda: transformer.init_cache(
        cfg, BATCH, MAX_LEN, jnp.float32))
    cache_axes = transformer.cache_logical_axes(cfg)

    def is_axes(v):
        return v == () or (isinstance(v, tuple) and all(
            isinstance(e, (str, type(None))) for e in v))

    for name, (mesh_name, seq) in CASES.items():
        mesh = make_mesh_by_name(mesh_name)
        shard = {}
        for kind, make in (("prefill", steps.make_prefill_fn),
                           ("decode", steps.make_decode_fn)):
            fn, rules = make(cfg, mesh, shard_cache_seq=seq)
            psh = tree_shardings(rules, transformer.param_axes(cfg),
                                 transformer.param_shapes(cfg))
            csh = jax.tree.map(
                lambda ax, sds: rules.sharding(ax, sds.shape) if ax != ()
                else NamedSharding(mesh, PartitionSpec()),
                cache_axes, cache_sds, is_leaf=is_axes)
            tok = rules.sharding(("batch", None) if kind == "prefill"
                                 else ("batch",),
                                 (BATCH, PROMPT) if kind == "prefill"
                                 else (BATCH,))
            shard[kind] = (jax.jit(fn, in_shardings=(psh, tok, csh)), csh)
        jf, _ = shard["prefill"]
        cache = transformer.init_cache(cfg, BATCH, MAX_LEN, jnp.float32)
        logits, cache = jf(params, jnp.asarray(tokens), cache)
        out[f"{name}/logits/0"] = np.asarray(logits)
        out.update(_cache_arrays(cache, f"{name}/prefill"))
        jd, csh = shard["decode"]
        cache = jax.device_put(cache, csh)   # the move between layouts
        for t in range(STEPS):
            logits, cache = jd(params, jnp.asarray(dec[t]), cache)
            out[f"{name}/logits/{t + 1}"] = np.asarray(logits)
        out.update(_cache_arrays(cache, f"{name}/decode"))
        out[f"{name}/offset"] = np.asarray(cache.offset)
    np.savez(out_path, **out)


if __name__ == "__main__" and sys.argv[1:2] == ["--jax"]:
    _jax_main(sys.argv[2])
    sys.exit(0)

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.convert import (cache_split, params_from_jax,  # noqa: E402
                                 shard_cache, shard_params, unshard_cache,
                                 unshard_params)
from repro_torch.core.model_axis import (ShardModelAxis,  # noqa: E402
                                         StackModelAxis,
                                         tp_serving_collectives)
from repro_torch.launch.mesh import parse_mesh  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.sharding import MeshRules  # noqa: E402
from repro_torch.train import steps  # noqa: E402


@pytest.fixture(scope="module")
def jax_serving(tmp_path_factory):
    pytest.importorskip("jax")
    path = tmp_path_factory.mktemp("jax_tp_serving") / "serving.npz"
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--jax",
         str(path)],
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp"),
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _close(got, want, what):
    scale = max(float(np.max(np.abs(want))), 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


def _check_cache(cache, cfg, rules, want, prefix):
    whole = unshard_cache(cache, cfg, rules)
    for slot, kv in whole.slots.items():
        for f, t in zip(("k", "v"), kv):
            _close(t.numpy(), want[f"{prefix}/{slot}/{f}"],
                   f"{prefix} cache {slot}/{f}")


def _counts(axis):
    return {op: {"calls": axis.calls[op], "bytes": axis.bytes[op]}
            for op in axis.calls}


@pytest.mark.parametrize("name", list(CASES))
def test_tp_serving_steps_match_jax(jax_serving, name):
    mesh_name, seq = CASES[name]
    want = jax_serving
    cfg = configs.get_smoke_config(ARCH)
    mesh = parse_mesh(mesh_name)
    m = mesh.model
    params = params_from_jax({k[2:]: v for k, v in want.items()
                              if k.startswith("p/")}, cfg, device="cpu")
    tokens, dec = _inputs(cfg.vocab_size)
    pf, prules = steps.make_prefill_fn(cfg, mesh, shard_cache_seq=seq,
                                       device="cpu")
    df, drules = steps.make_decode_fn(cfg, mesh, shard_cache_seq=seq,
                                      device="cpu")
    sp = shard_params(params, cfg, m)
    cache = shard_cache(transformer.init_cache(cfg, BATCH, MAX_LEN,
                                               torch.float32, "cpu"),
                        cfg, prules)
    k0 = cache.slots["0"].k
    # prefill: KV heads split at M = 2, the cache whole at M = 4 (2 KV
    # heads); shard_cache_seq splits positions over data x model
    if seq:
        assert k0.shape == (1, m, BATCH, MAX_LEN // m, 2, 32)
    elif m == 2:
        assert k0.shape == (1, 2, BATCH, MAX_LEN, 1, 32)
    else:
        assert k0.shape == (1, BATCH, MAX_LEN, 2, 32)
    logits, cache = pf(sp, torch.from_numpy(tokens), cache)
    assert logits.shape == (m, BATCH, cfg.padded_vocab // m)
    _close(torch.cat(list(logits), -1).numpy(), want[f"{name}/logits/0"],
           "prefill logits")
    _check_cache(cache, cfg, prules, want, f"{name}/prefill")
    kind = "decode" if seq else "prefill"   # seq: the prefill splits
    formula = tp_serving_collectives(cfg, m, BATCH, PROMPT, kind,
                                     torch.float32)
    assert _counts(pf.model_axis) == formula
    assert formula["all_reduce"]["calls"] > 0

    # the move into the decode layout lies outside both steps
    cache = shard_cache(unshard_cache(cache, cfg, prules), cfg, drules)
    assert cache.slots["0"].k.shape == (1, m, BATCH, MAX_LEN // m, 2, 32)
    per_step = tp_serving_collectives(cfg, m, BATCH, 1, "decode",
                                      torch.float32)
    for t in range(STEPS):
        df.model_axis.reset_counters()
        logits, cache = df(sp, torch.from_numpy(dec[t]), cache)
        _close(torch.cat(list(logits), -1).numpy(),
               want[f"{name}/logits/{t + 1}"], f"decode step {t} logits")
        assert _counts(df.model_axis) == per_step
    assert cache.offset == int(want[f"{name}/offset"]) == PROMPT + STEPS
    _check_cache(cache, cfg, drules, want, f"{name}/decode")


# ---------------------------------------------------------------------------
# The merge of the partials
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,kind", [(torch.float32, "attn_local"),
                                        (torch.float32, "attn"),
                                        (torch.bfloat16, "attn_local")])
def test_empty_shards_merge_with_weight_zero(dtype, kind):
    """At M = 4 over 64 positions (blocks of 16), offset 40: block 3 lies
    beyond the offset and, on a local layer (window 16), block 0 wholly
    outside the window and block 1 partly: their partials' maxes are
    NEG_INF and weigh 0 in the merge."""
    cfg = configs.get_smoke_config(ARCH)
    m, b, length, offset = 4, 2, 64, 40
    gen = torch.Generator().manual_seed(5)
    params = transformer.init_params(cfg, seed=2, device="cpu", dtype=dtype)
    attn = transformer.period_params(params, "0", 0)["attn"]
    x = torch.randn(b, 1, cfg.d_model, generator=gen).to(dtype)
    shape = (b, length, cfg.n_kv_heads, cfg.resolved_head_dim)
    k = torch.randn(shape, generator=gen).to(dtype)
    v = torch.randn(shape, generator=gen).to(dtype)
    k[:, offset:], v[:, offset:] = 0, 0
    pos = torch.full((b, 1), offset)
    plain = layers.KVCache(k.clone(), v.clone())
    want, _ = layers.attention_apply(attn, cfg, x, positions=pos,
                                     layer_kind=kind, cache=plain,
                                     cache_offset=offset)
    axis = StackModelAxis(m, "cpu")
    dims = steps.param_shard_dims(cfg, m)
    split = {}
    for key, t in attn.items():
        d = dims[f"blocks/0/attn/{key}"]
        split[key] = t if d is None else torch.stack(t.chunk(m, d - 1))
    tp = layers.KVCache(*(torch.stack(t.chunk(m, 1)) for t in (k, v)))
    got, _ = layers.attention_apply(split, cfg, x, positions=pos,
                                    layer_kind=kind, cache=tp,
                                    cache_offset=offset, model_axis=axis)
    assert torch.isfinite(got).all()
    # the new token went into block 2 alone; the caches agree
    assert torch.equal(torch.cat(list(tp.k), 1), plain.k)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -5
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol * scale
    assert axis.calls["all_max"] == 1 and axis.calls["all_gather"] == 3


def test_seq_split_positions_and_writes():
    axis = StackModelAxis(2, "cpu")
    # 2 nodes x 2 shards over 16 positions: shard i holds blocks i, 2 + i
    got = layers.seq_split_positions(axis, 8, 2, "cpu")
    assert got.tolist() == [[0, 1, 2, 3, 8, 9, 10, 11],
                            [4, 5, 6, 7, 12, 13, 14, 15]]
    one = ShardModelAxis(2, index=1)
    assert layers.seq_split_positions(one, 4, 2, "meta").shape == (1, 4)
    c = torch.zeros(2, 1, 8, 1, 1)
    t = torch.arange(1.0, 7.0).reshape(1, 6, 1, 1)
    layers._write_seq_split(c, t, 6, axis, 2)       # positions 6..11
    flat = c[..., 0, 0][:, 0]
    assert flat[1, 2:4].tolist() == [1, 2] and flat[0, 4:8].tolist() == \
        [3, 4, 5, 6]
    assert float(flat.sum()) == 21


# ---------------------------------------------------------------------------
# Layouts, the one-shard axis and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name,seq,decode", [
    ("1x2", False, False), ("1x4", False, False), ("1x4", False, True),
    ("2x2", True, True)])
def test_shard_cache_round_trip_and_one_shard(mesh_name, seq, decode):
    cfg = configs.get_smoke_config(ARCH)
    mesh = parse_mesh(mesh_name)
    make = steps.make_decode_fn if decode else steps.make_prefill_fn
    _, rules = make(cfg, mesh, shard_cache_seq=seq, device="cpu")
    cache = transformer.init_cache(cfg, 2, MAX_LEN, torch.float32, "cpu")
    for kv in cache.slots.values():
        for t in kv:
            t.copy_(torch.randn(t.shape, generator=torch.Generator()
                                .manual_seed(t.numel())))
    sharded = shard_cache(cache, cfg, rules)
    back = unshard_cache(sharded, cfg, rules)
    for slot in cache.slots:
        for a, b in zip(cache.slots[slot], back.slots[slot]):
            assert torch.equal(a, b)
    m = mesh.model
    for i in range(m):
        one = shard_cache(cache, cfg, rules, index=i)
        for a, b in zip(sharded.slots["0"], one.slots["0"]):
            if a.dim() == 5:                     # whole: every shard's
                assert torch.equal(a, b)
            else:       # node 0's block of shard i (its first under seq)
                assert torch.equal(a[:, i:i + 1, :, :b.shape[3]], b)


def test_one_shard_axis_traces_one_device_on_meta():
    cfg = configs.get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="meta tensors only"):
        ShardModelAxis(2, device="cpu")
    axis = ShardModelAxis(4, index=3)
    mesh = parse_mesh("1x4")
    fn, rules = steps.make_decode_fn(cfg, mesh, device="meta",
                                     model_axis=axis)
    params = shard_params(transformer.init_params(cfg, device="meta"),
                          cfg, 4, index=3)
    assert params["blocks"]["0"]["attn"]["wq"].shape == (1, 1, 128, 32)
    cache = shard_cache(transformer.init_cache(cfg, 2, MAX_LEN,
                                               torch.float32, "meta"),
                        cfg, rules, index=3)
    cache = cache._replace(offset=PROMPT)
    logits, _ = fn(params, torch.zeros(2, dtype=torch.int32, device="meta"),
                   cache)
    assert logits.shape == (1, 2, cfg.padded_vocab // 4)
    # one device's operands: a quarter of the stack's bytes, same calls
    stack = tp_serving_collectives(cfg, 4, 2, 1, "decode", torch.float32)
    assert axis.calls == {op: v["calls"] for op, v in stack.items()}
    assert {op: 4 * axis.bytes[op] for op in axis.bytes} == \
        {op: v["bytes"] for op, v in stack.items()}


def test_serving_steps_refuse():
    cfg = configs.get_smoke_config(ARCH)
    if not torch.cuda.is_available():       # entry points target the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            steps.make_prefill_fn(cfg, parse_mesh("1x2"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            steps.make_decode_fn(cfg, parse_mesh("1"))
    with pytest.raises(ValueError, match="5d"):
        steps.make_prefill_fn(cfg, parse_mesh("1x2"), device="cpu",
                              rule_overrides={"seq": "model"})
    with pytest.raises(ValueError, match="5d"):
        steps.make_decode_fn(cfg, parse_mesh("1x2"), device="cpu",
                             rule_overrides={"batch": "model"})
    with pytest.raises(ValueError, match="pod mesh"):
        steps.make_decode_fn(cfg, "16x16", device="cpu")
    for arch in ("rwkv6-3b", "whisper-large-v3"):   # heads M does not split:
        fn, _ = steps.make_decode_fn(configs.get_smoke_config(arch),
                                     parse_mesh("1x8"), device="cpu")
        assert fn.model_axis.size == 8             # split inside a head
        with pytest.raises(ValueError, match="5d"):
            steps.make_decode_fn(configs.get_smoke_config(arch),
                                 parse_mesh("1x8"), device="cpu",
                                 rule_overrides={"kv_heads": None})
    params = shard_params(transformer.init_params(cfg, device="cpu"), cfg, 2)
    with pytest.raises(ValueError, match="meta tensors only"):
        unshard_params(shard_params(transformer.init_params(
            cfg, device="cpu"), cfg, 2, index=1), cfg, 2, index=1)
    _, rules = steps.make_decode_fn(cfg, parse_mesh("1x2"), device="cpu")
    by_batch = MeshRules(rules.mesh, dict(rules.mapping, batch="model",
                                          cache_seq=None))
    with pytest.raises(ValueError, match="positions or by KV heads"):
        cache_split(cfg, by_batch, 2, 8)
    cache = shard_cache(transformer.init_cache(cfg, 2, 8, torch.float32,
                                               "cpu"), cfg, rules)
    with pytest.raises(NotImplementedError, match="ragged"):
        transformer.decode_step(params, cfg, torch.zeros(2, dtype=torch.long),
                                cache, offsets=torch.zeros(2, dtype=torch.long),
                                model_axis=StackModelAxis(2, "cpu"))
